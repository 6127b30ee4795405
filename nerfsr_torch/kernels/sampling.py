"""Kernel A: fused inverse-CDF resample (``csrc/invert_cdf.cu``).

Twin of ``nerfsr_tpu/ops/experimental/pallas_sampling.py``
(``pallas_invert_cdf`` / ``pallas_sample_pdf_stratified``). Forward only:
every consumer samples from detached weights, so the inputs are detached
here as the JAX wrapper stop-gradients them.

A CPU tensor takes the plain version (``core/sampling.py:_invert_cdf``);
a CUDA tensor launches the kernel or raises. Any bin count from 2 up:
the kernel holds a ray's CDF in shared memory and, past what a block's
shared memory holds (~29 K bins on the H100), in a workspace of B + 32
floats a ray that this wrapper allocates on the stream (so a CUDA graph
captures it).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from nerfsr_torch.core.sampling import _invert_cdf, stratified_uniforms
from nerfsr_torch.kernels import _lib

_WORKSPACE = {}   # bin count -> workspace floats a ray (one card)


def _workspace_floats(b: int) -> int:
    if b not in _WORKSPACE:
        floats = ctypes.c_int(0)
        _lib.check(_lib.lib().nerfsr_invert_cdf_workspace(
            b, ctypes.byref(floats)), "invert_cdf")
        _WORKSPACE[b] = floats.value
    return _WORKSPACE[b]


def invert_cdf(bins: torch.Tensor, weights: torch.Tensor,
               u: torch.Tensor) -> torch.Tensor:
    """bins (N, B), weights (N, B-1), u (N, Q) f32 -> z (N, Q) f32."""
    bins, weights, u = bins.detach(), weights.detach(), u.detach()
    if bins.device.type == "cpu":
        return _invert_cdf(bins, weights, u)
    n, b = bins.shape
    q = u.shape[-1]
    if b < 2:
        raise ValueError(f"invert_cdf: {b} bins, the kernel takes 2 or more")
    _lib.check_cuda(bins, "bins", (n, b))
    _lib.check_cuda(weights, "weights", (n, b - 1), device=bins.device)
    _lib.check_cuda(u, "u", (n, q), device=bins.device)
    z = torch.empty_like(u)
    with torch.cuda.device(bins.device):
        ptrs = (bins.data_ptr(), weights.data_ptr(), u.data_ptr(),
                z.data_ptr())
        floats = _workspace_floats(b)
        if floats:
            ws = torch.empty((n, floats), dtype=torch.float32,
                             device=bins.device)
            err = _lib.lib().nerfsr_invert_cdf_ws(
                *ptrs, ws.data_ptr(), n, b, q, _lib.stream_ptr(bins))
        else:
            err = _lib.lib().nerfsr_invert_cdf(*ptrs, n, b, q,
                                               _lib.stream_ptr(bins))
    _lib.check(err, "invert_cdf")
    _lib.COUNTS["invert_cdf"] += 1
    return z


def sample_pdf_stratified(bins: torch.Tensor, weights: torch.Tensor,
                          num_samples: int, randomized: bool,
                          jitter: Optional[torch.Tensor] = None,
                          generator: Optional[torch.Generator] = None):
    """Kernel twin of ``core.sampling.sample_pdf_stratified``: the
    stratified ``u`` is built in PyTorch, the inversion is kernel A."""
    u = stratified_uniforms(bins, num_samples, randomized, jitter, generator)
    return invert_cdf(bins, weights, u.contiguous())
