"""Bridge between the JAX package's parameters and the port's modules.

Input: the JAX param tree as nested dicts of numpy arrays, e.g.
``{"prop": {"params": {"layer_0": {"kernel", "bias"}, ...}},
"fine": {"params": {"xyz_encoding_1": {...}, ...}}}``. Each flax Dense
``kernel`` is (in, out); it loads transposed into ``Linear.weight``
(out, in). The layer names are those of
``tools/convert_reference_ckpt.py`` (``xyz_encoding_{i}``,
``xyz_encoding_final``, ``sigma``, ``dir_encoding``, ``rgb``; NeuTex's
``dir_encoding_1`` and ``dir_encoding_2``), which the port's
``VanillaMLP``, ``NeuTexMLP`` and ``ProposalMLP`` use as attribute names.
``export_params`` is the inverse of ``load_jax_params``; ``param_leaves``
names each parameter by its JAX tree path (``fine/params/rgb/kernel``),
which checkpoints and the ``--fix_layers``/``--init_weights_keys``
regexes read.

The CNNs (``models/networks.py``: the refine networks and the unused
Resnet/ConvBlock/Up2x) cross with their flax
variables, ``{"params", "batch_stats"}``: ``variable_leaves`` names each
tensor by its flax path, ``export_variables`` and ``load_variables`` map
the whole tree (convolutions HWIO <-> OIHW; transposed convolutions
(kh, kw, in, out) <-> (in, out, kh, kw) with both spatial axes flipped;
batch norm's ``scale``, ``bias``, ``mean`` and ``var`` as they are).

The GAN's discriminator crosses the same way with
``export_discriminator`` / ``load_discriminator``: ``params`` holds each
layer's kernel (HWIO <-> OIHW), ``batch_stats`` the spectral norm's
``u`` and ``sigma`` under flax's names (``SpectralNorm_{i}`` in layer
order, ``{layer}/kernel/u`` and ``{layer}/kernel/sigma``).
"""

from __future__ import annotations

from typing import Any, Iterator, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from nerfsr_torch.models.networks import BatchNorm


def param_leaves(params: nn.ModuleDict
                 ) -> Iterator[Tuple[str, nn.Parameter, bool]]:
    """(JAX path, parameter, is a kernel) for every Linear's weight and
    bias, in the modules' registration order (``params.parameters()``'s)."""
    for key, module in params.items():
        for name, lin in module.named_children():
            if isinstance(lin, nn.Linear):
                yield f"{key}/params/{name}/kernel", lin.weight, True
                yield f"{key}/params/{name}/bias", lin.bias, False


def to_jax_layout(t: torch.Tensor, is_kernel: bool) -> np.ndarray:
    """A Linear weight (out, in) as a flax kernel (in, out), or a bias, as
    a C-contiguous f32 host array."""
    arr = t.detach().float().cpu().numpy()
    return np.ascontiguousarray(arr.T if is_kernel else arr)


def from_jax_layout(arr, like: torch.Tensor, is_kernel: bool, what: str
                    ) -> torch.Tensor:
    """Inverse of ``to_jax_layout`` onto ``like``'s shape, dtype and
    device; the shape must match. The result owns its memory (a copy),
    so an in-place update of it (Adam's moments) leaves ``arr`` alone."""
    arr = np.asarray(arr, np.float32)
    if is_kernel:
        arr = arr.T
    if arr.shape != tuple(like.shape):
        raise ValueError(f"{what}: shape {arr.shape} (port layout), "
                         f"expected {tuple(like.shape)}")
    return torch.from_numpy(np.array(arr, order="C")).to(
        device=like.device, dtype=like.dtype)


@torch.no_grad()
def load_module(module: nn.Module, variables: Mapping[str, Any]):
    """Load one flax variables dict (``{"params": {name: {kernel, bias}}}``)
    into ``module``; every Linear must be covered and every entry used."""
    params = variables["params"]
    linears = {name: m for name, m in module.named_children()
               if isinstance(m, nn.Linear)}
    if set(linears) != set(params):
        raise KeyError(f"layer names differ: module {sorted(linears)}, "
                       f"params {sorted(params)}")
    for name, lin in linears.items():
        kernel = np.asarray(params[name]["kernel"], np.float32)
        bias = np.asarray(params[name]["bias"], np.float32)
        if kernel.shape != (lin.in_features, lin.out_features):
            raise ValueError(f"{name}: kernel {kernel.shape}, expected "
                             f"{(lin.in_features, lin.out_features)}")
        lin.weight.copy_(torch.from_numpy(kernel.T.copy()))
        lin.bias.copy_(torch.from_numpy(bias.reshape(-1).copy()))
    return module


def load_jax_params(params: nn.ModuleDict, tree: Mapping[str, Any]):
    """Load a whole JAX param tree (keys ``prop``/``coarse``/``fine``) into
    the matching modules of ``params`` (see ``NeRFSystem.init_params``)."""
    if set(params.keys()) != set(tree):
        raise KeyError(f"networks differ: port {sorted(params.keys())}, "
                       f"tree {sorted(tree)}")
    for key, variables in tree.items():
        load_module(params[key], variables)
    return params



@torch.no_grad()
def export_params(params: nn.ModuleDict):
    """The port's networks as a JAX-layout numpy tree: ``{net: {"params":
    {layer: {"kernel" (in, out), "bias" (out,)}}}}``."""
    return {key: {"params": {
        name: {"kernel": lin.weight.cpu().numpy().T.copy(),
               "bias": lin.bias.cpu().numpy().copy()}
        for name, lin in module.named_children()
        if isinstance(lin, nn.Linear)}}
        for key, module in params.items()}


# ---------------------------------------------------------------------------
# the refine networks: flax variables {"params", "batch_stats"}
# ---------------------------------------------------------------------------

def variable_leaves(net: nn.Module
                    ) -> Iterator[Tuple[str, str, torch.Tensor, str]]:
    """(collection, flax path, tensor, layout) for every variable of a
    refine network (``models/networks.py``), the path being the module's
    (``down_norm_1/BatchNorm_0/scale``). Layouts: ``conv`` (OIHW here,
    HWIO in flax), ``conv_transpose`` ((in, out, kh, kw) here, (kh, kw,
    in, out) in flax with both spatial axes flipped) and ``vector``."""
    for name, m in net.named_modules():
        path = name.replace(".", "/")
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            layout = "conv_transpose" if isinstance(
                m, nn.ConvTranspose2d) else "conv"
            yield "params", f"{path}/kernel", m.weight, layout
            if m.bias is not None:
                yield "params", f"{path}/bias", m.bias, "vector"
        elif isinstance(m, BatchNorm):
            yield "params", f"{path}/scale", m.scale, "vector"
            yield "params", f"{path}/bias", m.bias, "vector"
            yield "batch_stats", f"{path}/mean", m.mean, "vector"
            yield "batch_stats", f"{path}/var", m.var, "vector"


def to_flax_layout(t: torch.Tensor, layout: str) -> np.ndarray:
    """A refine network's tensor as its flax array (an f32, C-contiguous
    copy: it does not follow later updates of the tensor)."""
    t = t.detach().float().cpu()
    if layout == "conv":
        t = t.permute(2, 3, 1, 0)
    elif layout == "conv_transpose":
        t = t.flip(2, 3).permute(2, 3, 0, 1)
    return np.array(t.numpy(), order="C", copy=True)


def from_flax_layout(arr, like: torch.Tensor, layout: str, what: str
                     ) -> torch.Tensor:
    """Inverse of ``to_flax_layout`` onto ``like``'s shape, dtype and
    device; the shape must match."""
    t = torch.from_numpy(np.array(arr, np.float32))
    if layout == "conv":
        t = t.permute(3, 2, 0, 1)
    elif layout == "conv_transpose":
        t = t.permute(2, 3, 0, 1).flip(2, 3)
    if tuple(t.shape) != tuple(like.shape):
        raise ValueError(f"{what}: shape {tuple(t.shape)} (port layout), "
                         f"expected {tuple(like.shape)}")
    return t.contiguous().to(device=like.device, dtype=like.dtype)


def tree_set(tree: dict, path: str, value):
    """Set the leaf at ``a/b/c`` of nested dicts, making the dicts."""
    keys = path.split("/")
    for k in keys[:-1]:
        tree = tree.setdefault(k, {})
    tree[keys[-1]] = value


def tree_get(tree, path: str, what: str):
    """The leaf at ``a/b/c`` of nested dicts; ``KeyError`` naming
    ``what`` when it is missing."""
    for k in path.split("/"):
        if not isinstance(tree, Mapping) or k not in tree:
            raise KeyError(f"{what}: no entry {path!r}")
        tree = tree[k]
    return tree


def flatten_tree(tree, prefix=""):
    """{``a/b/c``: leaf} of nested dicts (an empty dict is a leaf)."""
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, Mapping) and v:
            out.update(flatten_tree(v, path))
        else:
            out[path] = v
    return out


@torch.no_grad()
def export_variables(net: nn.Module) -> dict:
    """A refine network's flax variables, ``{"params": ...,
    "batch_stats": ...}`` as nested dicts of numpy arrays
    (``batch_stats`` is ``{}`` without batch norm)."""
    out = {"params": {}, "batch_stats": {}}
    for coll, path, t, layout in variable_leaves(net):
        tree_set(out[coll], path, to_flax_layout(t, layout))
    return out


@torch.no_grad()
def load_variables(net: nn.Module, variables: Mapping[str, Any]):
    """Load flax variables (``params`` and, with batch norm,
    ``batch_stats``) into a refine network; every variable must be
    covered and every entry used."""
    for coll in ("params", "batch_stats"):
        port = {path for c, path, _, _ in variable_leaves(net) if c == coll}
        saved = set(flatten_tree(variables.get(coll, {})))
        if port != saved:
            raise KeyError(f"{coll} differ: only in the port "
                           f"{sorted(port - saved)}, only in the variables "
                           f"{sorted(saved - port)}")
    for coll, path, t, layout in variable_leaves(net):
        t.copy_(from_flax_layout(tree_get(variables[coll], path, coll), t,
                                 layout, path))
    return net


# ---------------------------------------------------------------------------
# the GAN discriminator: params {layer: {kernel}}, spectral-norm batch_stats
# ---------------------------------------------------------------------------

def discriminator_leaves(net: nn.Module
                         ) -> Iterator[Tuple[str, str, torch.Tensor, str]]:
    """(collection, flax path, tensor, layout) of every variable of an
    ``NLayerDiscriminator``."""
    for i, (name, m) in enumerate(net.spectral_convs()):
        yield "params", f"{name}/kernel", m.weight, "conv"
        sn = f"SpectralNorm_{i}/{name}/kernel"
        yield "batch_stats", f"{sn}/u", m.u, "vector"
        yield "batch_stats", f"{sn}/sigma", m.sigma, "vector"


@torch.no_grad()
def export_discriminator(net: nn.Module) -> dict:
    """The discriminator's flax variables as nested numpy dicts."""
    out = {"params": {}, "batch_stats": {}}
    for coll, path, t, layout in discriminator_leaves(net):
        arr = to_flax_layout(t, layout)
        if coll == "params":
            tree_set(out["params"], path, arr)
        else:
            # flax keeps the layer's path in one key under SpectralNorm_i
            head, rest = path.split("/", 1)
            out["batch_stats"].setdefault(head, {})[rest] = arr
    return out


@torch.no_grad()
def load_discriminator(net: nn.Module, variables: Mapping[str, Any]):
    """Load flax discriminator variables (``params`` and the spectral
    norm's ``batch_stats``) into ``net``; every variable must be covered
    and every entry used."""
    want = {(c, p) for c, p, _, _ in discriminator_leaves(net)}
    have = {("params", p) for p in flatten_tree(variables["params"])}
    have |= {("batch_stats", f"{head}/{rest}")
             for head, leaves in variables.get("batch_stats", {}).items()
             for rest in leaves}
    if want != have:
        raise KeyError(f"discriminator variables differ: only in the port "
                       f"{sorted(want - have)}, only in the variables "
                       f"{sorted(have - want)}")
    for coll, path, t, layout in discriminator_leaves(net):
        if coll == "params":
            arr = tree_get(variables["params"], path, coll)
        else:
            head, rest = path.split("/", 1)
            arr = variables["batch_stats"][head][rest]
        t.copy_(from_flax_layout(arr, t, layout, path))
    return net
