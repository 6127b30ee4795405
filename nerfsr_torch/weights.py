"""Bridge between the JAX package's parameters and the port's modules.

Input: the JAX param tree as nested dicts of numpy arrays, e.g.
``{"prop": {"params": {"layer_0": {"kernel", "bias"}, ...}},
"fine": {"params": {"xyz_encoding_1": {...}, ...}}}``. Each flax Dense
``kernel`` is (in, out); it loads transposed into ``Linear.weight``
(out, in). The layer names are those of
``tools/convert_reference_ckpt.py`` (``xyz_encoding_{i}``,
``xyz_encoding_final``, ``sigma``, ``dir_encoding``, ``rgb``), which the
port's ``VanillaMLP`` and ``ProposalMLP`` use as attribute names.
``export_params`` is the inverse of ``load_jax_params``; ``param_leaves``
names each parameter by its JAX tree path (``fine/params/rgb/kernel``),
which checkpoints and the ``--fix_layers``/``--init_weights_keys``
regexes read.
"""

from __future__ import annotations

from typing import Any, Iterator, Mapping, Tuple

import numpy as np
import torch
from torch import nn


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
    device; the shape must match."""
    arr = np.asarray(arr, np.float32)
    if is_kernel:
        arr = arr.T
    if arr.shape != tuple(like.shape):
        raise ValueError(f"{what}: shape {arr.shape} (port layout), "
                         f"expected {tuple(like.shape)}")
    return torch.from_numpy(np.ascontiguousarray(arr)).to(
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
