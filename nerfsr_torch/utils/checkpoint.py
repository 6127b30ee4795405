"""Checkpoint and resume, in the JAX package's file layout.

Port of ``nerfsr_tpu/utils/checkpoint.py``. A checkpoint holds the state
dict that ``flax.serialization.to_bytes`` writes for the JAX
``TrainState`` (as a msgpack blob, ``nerfsr_torch/utils/msgpack.py``, or
an orbax directory), so either package reads the other's files::

    {"step": int32, "params": {net: {"params": {layer: {bias, kernel}}}},
     "opt_state": {"0": {}?,                       # --grad_clip_val's clip
                   "1": {"count", "mu", "nu"},     # ScaleByAdamState
                   "2": {"count"}}}                # the schedule's count

(the clip entry only with ``--grad_clip_val``, so Adam is "0" and the
schedule "1" without it). Under ``--fix_layers`` the chain sits in
``{"inner_state": ...}`` (``optax.masked``) and a frozen leaf's ``mu``
and ``nu`` are ``{}``. Kernels are transposed into ``Linear.weight`` as
``nerfsr_torch/weights.py`` does; ``mu``/``nu`` go into Adam's
``exp_avg``/``exp_avg_sq`` with the same transform, Adam's ``count``
becomes each parameter's ``step`` (an f64 tensor on the parameter's
device, where the update reads it), and ``TrainState.step`` the step.
The template's ``TemplateState`` is the JAX template's ``TrainState``:
its ``params`` are flax's ``{"params": {"Dense_0", "Dense_1"}}`` and its
chain is always ``{"0": adam, "1": schedule}``. The refine stage's
``RefineState`` is ``{"step", "params",
"batch_stats", "opt_state": {"0": adam, "1": schedule}}``, its
variables and moments in flax's layout (``weights.variable_leaves``:
convolutions HWIO, transposed ones (kh, kw, in, out) flipped).

Two backends, as in the JAX package (``--ckpt_backend``):

- ``msgpack``: ``{checkpoints_dir}/{name}/{epoch}_state.msgpack`` plus
  ``latest_state.msgpack``, each written to a temporary file, fsynced and
  moved into place;
- ``orbax``: the directories ``{epoch}_state.orbax/`` and
  ``latest_state.orbax/`` of orbax's ``StandardCheckpointer``
  (``nerfsr_torch/utils/orbax.py``), the state copied to the host at the
  save and written on a background thread; ``wait_for_saves`` waits for
  it, and every load does first. Under a process group of more than one
  rank (``--num_processes`` > 1) it writes msgpack instead and says so
  once, as the JAX package does on a multi-controller run.

Reads follow the files on disk, so a run resumes across a switch of
backend: the resume scan takes epochs of both, the configured backend's
file of an epoch is read first and the other's when only it exists, and
a torn msgpack file gives way to its orbax sibling. Resume tries the
newest epoch first and falls back to an older one only when its
checkpoint fails to read (a torn file is skipped); a torn ``latest``
falls back to the newest intact epoch.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from nerfsr_torch import spans
from nerfsr_torch.models.refine_system import RefineState
from nerfsr_torch.models.template_system import TemplateState
from nerfsr_torch.utils import msgpack, orbax
from nerfsr_torch.weights import (flatten_tree, from_flax_layout,
                                  from_jax_layout, load_variables,
                                  param_leaves, to_flax_layout,
                                  to_jax_layout, tree_get, tree_set,
                                  variable_leaves)


def _ckpt_dir(opt, name=None):
    return os.path.join(opt.checkpoints_dir, name or opt.name)


def _path(opt, epoch, name=None):
    return os.path.join(_ckpt_dir(opt, name), f"{epoch}_state.msgpack")


def _orbax_path(opt, epoch, name=None):
    return os.path.abspath(os.path.join(_ckpt_dir(opt, name),
                                        f"{epoch}_state.orbax"))


def _use_orbax(opt) -> bool:
    return getattr(opt, "ckpt_backend", "msgpack") == "orbax"


_WARNED_MULTIPROCESS = False


def wait_for_saves() -> None:
    """Wait for the background (orbax) save and re-raise its error; a
    no-op when none is in flight."""
    orbax.wait_for_saves()


def frozen_paths(opt, params: nn.ModuleDict) -> set:
    """Leaf paths that ``--fix_layers`` (a regex over the flattened JAX
    paths, ``fine/params/rgb/kernel``) freezes."""
    if not getattr(opt, "fix_layers", None):
        return set()
    pattern = re.compile(opt.fix_layers)
    return {path for path, _, _ in param_leaves(params)
            if pattern.search(path)}


# ---------------------------------------------------------------------------
# state dict <-> TrainState
# ---------------------------------------------------------------------------

def _sorted_tree(tree):
    """Nested dicts with sorted keys (the order JAX's tree maps leave)."""
    if isinstance(tree, dict):
        return {k: _sorted_tree(tree[k]) for k in sorted(tree)}
    return tree


def _chain_keys(opt) -> Tuple[list, str, str]:
    """The chain's entry names, and which are Adam's and the schedule's."""
    keys = ["0", "1", "2"] if opt.grad_clip_val > 0 else ["0", "1"]
    return keys, keys[-2], keys[-1]


def _refine_state_dict(state) -> Dict[str, Any]:
    """The JAX ``RefineState`` state dict of a ``RefineState``."""
    count = np.asarray(state.step, np.int32)
    tree = {"params": {}, "batch_stats": {}}
    mu, nu = {}, {}
    for coll, path, t, layout in variable_leaves(state.net):
        tree_set(tree[coll], path, to_flax_layout(t, layout))
        if coll != "params":
            continue
        moments = state.optimizer.state.get(t, {})
        for moms, key in ((mu, "exp_avg"), (nu, "exp_avg_sq")):
            tree_set(moms, path, to_flax_layout(moments[key], layout)
                     if key in moments else np.zeros_like(
                         to_flax_layout(t, layout)))
    return {"step": count, "params": _sorted_tree(tree["params"]),
            "batch_stats": _sorted_tree(tree["batch_stats"]),
            "opt_state": {"0": {"count": count, "mu": _sorted_tree(mu),
                                "nu": _sorted_tree(nu)},
                          "1": {"count": count}}}


@torch.no_grad()
def _load_refine_state_dict(state, sd: Dict[str, Any], params_only: bool):
    """Load a JAX ``RefineState`` state dict into a ``RefineState``: the
    network's variables and the step, and (unless ``params_only``) the
    Adam moments and counts."""
    if "batch_stats" not in sd:
        raise ValueError("not a RefineState checkpoint (no batch_stats)")
    load_variables(state.net, {"params": sd["params"],
                               "batch_stats": sd["batch_stats"]})
    state.step = int(sd["step"])
    if params_only:
        return state
    chain = sd["opt_state"]
    if sorted(chain) != ["0", "1"]:
        raise ValueError(f"optimizer chain entries {sorted(chain)}, "
                         "expected ['0', '1'] (adam, schedule)")
    adam = chain["0"]
    counts = {state.step, int(adam["count"]), int(chain["1"]["count"])}
    if len(counts) != 1:
        raise ValueError(f"step and optimizer counts disagree: {counts}")
    for coll, path, t, layout in variable_leaves(state.net):
        if coll == "params":
            mu, nu = (tree_get(adam[k], path, k) for k in ("mu", "nu"))
            state.optimizer.state[t] = {
                "step": torch.tensor(float(state.step), dtype=torch.float64,
                                     device=t.device),
                "exp_avg": from_flax_layout(mu, t, layout, path),
                "exp_avg_sq": from_flax_layout(nu, t, layout, path)}
    return state


def _layout(opt, state):
    """(leaves, frozen paths, chain keys, masked) of a training state: the
    (JAX path, parameter, is a kernel) leaves, the ``--fix_layers``
    paths, the optimizer chain's entries with Adam's and the schedule's,
    and whether ``optax.masked`` wraps the chain. The template's chain is
    always Adam then the schedule."""
    if isinstance(state, TemplateState):
        return list(state.params.leaves()), set(), (["0", "1"], "0", "1"), \
            False
    return (list(param_leaves(state.params)),
            frozen_paths(opt, state.params), _chain_keys(opt),
            bool(getattr(opt, "fix_layers", None)))


def state_dict(opt, state) -> Dict[str, Any]:
    """The JAX ``TrainState`` state dict of ``state`` (host arrays); of a
    ``RefineState``, the JAX ``RefineState``'s."""
    if isinstance(state, RefineState):
        return _refine_state_dict(state)
    leaves, frozen, (keys, adam, sched), masked = _layout(opt, state)
    count = np.asarray(state.step, np.int32)
    params, mu, nu = {}, {}, {}
    for path, p, is_kernel in leaves:
        tree_set(params, path, to_jax_layout(p, is_kernel))
        if path in frozen:
            tree_set(mu, path, {})
            tree_set(nu, path, {})
            continue
        moments = state.optimizer.state.get(p, {})
        for tree, key in ((mu, "exp_avg"), (nu, "exp_avg_sq")):
            tree_set(tree, path, to_jax_layout(moments[key], is_kernel)
                     if key in moments else np.zeros_like(
                         to_jax_layout(p, is_kernel)))
    chain = {k: {} for k in keys}
    chain[adam] = {"count": count, "mu": _sorted_tree(mu),
                   "nu": _sorted_tree(nu)}
    chain[sched] = {"count": count}
    opt_state = {"inner_state": chain} if masked else chain
    return {"step": count, "params": _sorted_tree(params),
            "opt_state": opt_state}


@torch.no_grad()
def load_state_dict(opt, state, sd: Dict[str, Any],
                    params_only: bool = False):
    """Load a JAX ``TrainState`` state dict into ``state`` in place:
    parameters, Adam moments and step counts, and ``state.step``
    (``params_only``: the parameters and the step). A ``RefineState``
    takes a ``RefineState`` dict; ``params_only`` loads its batch
    statistics too."""
    if isinstance(state, RefineState):
        return _load_refine_state_dict(state, sd, params_only)
    leaves, frozen, (keys, adam_key, sched_key), masked = _layout(opt,
                                                                 state)
    params_sd = sd["params"]
    port = {path for path, _, _ in leaves}
    saved = set(flatten_tree(params_sd))
    if port != saved:
        raise KeyError(f"parameter leaves differ: only in the port "
                       f"{sorted(port - saved)}, only in the checkpoint "
                       f"{sorted(saved - port)}")
    for path, p, is_kernel in leaves:
        p.copy_(from_jax_layout(tree_get(params_sd, path, "params"), p,
                                is_kernel, path))
    state.step = int(sd["step"])
    if params_only:
        return state
    chain = sd["opt_state"]
    if ("inner_state" in chain) != masked:
        raise ValueError("the checkpoint's optimizer state was saved "
                         f"{'with' if 'inner_state' in chain else 'without'}"
                         " --fix_layers; pass the same flag to load it")
    chain = chain.get("inner_state", chain)
    if sorted(chain) != keys:
        raise ValueError(f"optimizer chain entries {sorted(chain)}, expected "
                         f"{keys} (--grad_clip_val decides the clip entry)")
    adam = chain[adam_key]
    step = state.step
    counts = {step, int(adam["count"]), int(chain[sched_key]["count"])}
    if len(counts) != 1:
        raise ValueError(f"step and optimizer counts disagree: {counts}")
    trainable = {p for group in state.optimizer.param_groups
                 for p in group["params"]}
    for path, p, is_kernel in leaves:
        if path in frozen:
            continue
        if p not in trainable:
            raise ValueError(f"{path}: not in the optimizer")
        state.optimizer.state[p] = {
            "step": torch.tensor(float(step), dtype=torch.float64,
                                 device=p.device),
            "exp_avg": from_jax_layout(tree_get(adam["mu"], path, "mu"),
                                       p, is_kernel, path),
            "exp_avg_sq": from_jax_layout(tree_get(adam["nu"], path, "nu"),
                                          p, is_kernel, path)}
    return state


# ---------------------------------------------------------------------------
# files
# ---------------------------------------------------------------------------

def _atomic_write(path: str, blob: bytes) -> None:
    """Write to ``path.tmp``, fsync, and move it onto ``path``: a crash
    mid-write never leaves a torn file at ``path``."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(blob)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def save_checkpoint(opt, state, epoch) -> str:
    """Write epoch ``epoch`` and refresh ``latest`` in the configured
    backend: msgpack files (both atomic), or orbax directories written on
    a background thread from a copy taken now. Returns the epoch's
    path."""
    os.makedirs(_ckpt_dir(opt), exist_ok=True)
    sd = state_dict(opt, state)
    if _use_orbax(opt):
        if (getattr(opt, "num_processes", 0) or 1) > 1:
            global _WARNED_MULTIPROCESS
            if not _WARNED_MULTIPROCESS:
                _WARNED_MULTIPROCESS = True
                print("[checkpoint] --ckpt_backend orbax falls back to "
                      "msgpack on multi-controller runs (master-only saves "
                      "would deadlock orbax's cross-process barriers)")
        else:
            path = _orbax_path(opt, epoch)
            orbax.save_async([path, _orbax_path(opt, "latest")], sd)
            return path
    blob = msgpack.packb(sd)
    path = _path(opt, epoch)
    _atomic_write(path, blob)
    _atomic_write(_path(opt, "latest"), blob)
    return path


def read_checkpoint(path: str) -> Dict[str, Any]:
    """Parse one checkpoint (a msgpack file or an orbax directory) into its
    state dict; a torn or foreign one raises ``ValueError``, a missing one
    ``OSError``."""
    if path.endswith(".orbax"):
        if not os.path.isdir(path):
            raise FileNotFoundError(path)
        try:
            sd = orbax.restore(path)
        except (OSError, ValueError, LookupError) as e:
            raise ValueError(f"{path}: unreadable orbax checkpoint ({e})") \
                from e
    else:
        with open(path, "rb") as f:
            sd = msgpack.unpackb(f.read())
    if not isinstance(sd, dict) or set(sd) - {"batch_stats"} != {
            "step", "params", "opt_state"}:
        raise ValueError(f"{path} is not a TrainState or RefineState "
                         "checkpoint")
    return sd


def _read_epoch(opt, epoch, name=None) -> Dict[str, Any]:
    """The checkpoint of ``epoch`` (of this experiment or of ``name``): the
    configured backend's if it exists, else the other's; a torn msgpack
    file gives way to its orbax sibling."""
    mp, op = _path(opt, epoch, name), _orbax_path(opt, epoch, name)
    order = (op, mp) if _use_orbax(opt) else (mp, op)
    found = [p for p in order if os.path.exists(p)]
    if not found:
        raise FileNotFoundError(order[0])
    try:
        return read_checkpoint(found[0])
    except ValueError:
        if len(found) == 2 and found[0] == mp:
            return read_checkpoint(op)
        raise


def _epochs(opt):
    d = _ckpt_dir(opt)
    if not os.path.isdir(d):
        return []
    found = [re.match(r"(\d+)_state\.(msgpack|orbax)$", fn)
             for fn in os.listdir(d)]
    return sorted({int(m.group(1)) for m in found if m}, reverse=True)


def newest_checkpoint(opt) -> Optional[Tuple[int, Dict[str, Any]]]:
    """(epoch, state dict) of the newest epoch, of either backend, whose
    checkpoint reads: the newest is read first, and an older one only
    when it fails."""
    for epoch in _epochs(opt):
        try:
            return epoch, _read_epoch(opt, epoch)
        except ValueError as e:
            print(f"[checkpoint] skipping epoch {epoch}: {e}")
    return None


@spans.spanned("nerfsr.ckpt.load")
def load_checkpoint(opt, state, epoch=None, name=None,
                    params_only: bool = False):
    """Restore ``state`` from epoch ``epoch`` (default ``--load_epoch``;
    an int or ``latest``) of this experiment or of ``name``; with
    ``params_only`` (test and infer) the optimizer state is not read. A
    torn ``latest`` of this experiment falls back to the newest intact
    epoch."""
    wait_for_saves()
    epoch = epoch if epoch is not None else opt.load_epoch
    try:
        sd = _read_epoch(opt, epoch, name)
    except ValueError:
        if str(epoch) != "latest" or name is not None:
            raise
        found = newest_checkpoint(opt)
        if found is None:
            raise OSError(f"corrupt checkpoint {_path(opt, epoch)} and no "
                          "intact epoch to fall back to")
        sd = found[1]
    return load_state_dict(opt, state, sd, params_only)


def resume_if_requested(opt, state) -> int:
    """``--continue_train``: load ``--load_epoch`` (an epoch number, or
    ``latest`` for the newest intact epoch) into ``state`` and return
    that epoch; 0 when not resuming or nothing is saved."""
    if not opt.continue_train:
        return 0
    wait_for_saves()
    if str(opt.load_epoch) != "latest":
        epoch = int(opt.load_epoch)
        sd = _read_epoch(opt, epoch)
    else:
        found = newest_checkpoint(opt)
        if found is None:
            return 0
        epoch, sd = found
    load_state_dict(opt, state, sd)
    return epoch


@torch.no_grad()
def init_weights_from(opt, state):
    """``--init_weights name:epoch``: copy the parameters of another
    experiment's checkpoint (either backend) whose paths match
    ``--init_weights_keys`` and whose shapes agree; the optimizer state
    is left as it is."""
    if not opt.init_weights:
        return state
    wait_for_saves()
    name, _, epoch = opt.init_weights.partition(":")
    other = flatten_tree(_read_epoch(opt, epoch or "latest", name)["params"])
    pattern = re.compile(opt.init_weights_keys)
    for path, p, is_kernel in _layout(opt, state)[0]:
        arr = other.get(path)
        if arr is None or not pattern.search(path):
            continue
        arr = np.asarray(arr)
        if (arr.T if is_kernel else arr).shape == tuple(p.shape):
            p.copy_(from_jax_layout(arr, p, is_kernel, path))
    return state
