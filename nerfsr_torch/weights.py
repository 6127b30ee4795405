"""Bridge between the JAX package's parameters and the port's modules.

Input: the JAX param tree as nested dicts of numpy arrays, e.g.
``{"prop": {"params": {"layer_0": {"kernel", "bias"}, ...}},
"fine": {"params": {"xyz_encoding_1": {...}, ...}}}``. Each flax Dense
``kernel`` is (in, out); it loads transposed into ``Linear.weight``
(out, in). The layer names are those of
``tools/convert_reference_ckpt.py`` (``xyz_encoding_{i}``,
``xyz_encoding_final``, ``sigma``, ``dir_encoding``, ``rgb``), which the
port's ``VanillaMLP`` and ``ProposalMLP`` use as attribute names.
``export_params`` is the inverse of ``load_jax_params``.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch
from torch import nn


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
