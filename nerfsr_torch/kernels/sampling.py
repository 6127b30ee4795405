"""Kernel A: fused inverse-CDF resample (``csrc/invert_cdf.cu``).

Twin of ``nerfsr_tpu/ops/experimental/pallas_sampling.py``
(``pallas_invert_cdf`` / ``pallas_sample_pdf_stratified``). Forward only:
every consumer samples from detached weights, so the inputs are detached
here as the JAX wrapper stop-gradients them.

A CPU tensor takes the plain version (``core/sampling.py:_invert_cdf``);
a CUDA tensor launches the kernel or raises. Any bin count from 2 up:
the kernel holds a ray's CDF in shared memory and, past 16,384 bins,
streams it through shared memory a chunk at a time. A call allocates
nothing but ``z``.
``launch_plan`` says which route and grid the kernel takes at a shape.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from nerfsr_torch.core.sampling import _invert_cdf, stratified_uniforms
from nerfsr_torch.kernels import _lib

ROUTES = ("register", "shared", "streamed")


def launch_plan(n: int, b: int) -> dict:
    """The launch kernel A takes on this card for n rays of b bins: its
    route (``register`` up to 128 bins, ``shared`` up to 16,384, the
    whole CDF in shared memory, ``streamed`` past that), grid (blocks,
    threads a block, dynamic shared bytes a block), warps a ray and CDF
    entries a chunk (streamed)."""
    out = (ctypes.c_int * 6)()
    _lib.check(_lib.lib().nerfsr_invert_cdf_route(n, b, out),
               "invert_cdf_route")
    return dict(route=ROUTES[out[0]], blocks=out[1], threads=out[2],
                smem_bytes=out[3], warps_per_ray=out[4], chunk=out[5])


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
        err = _lib.lib().nerfsr_invert_cdf(
            bins.data_ptr(), weights.data_ptr(), u.data_ptr(), z.data_ptr(),
            n, b, q, _lib.stream_ptr(bins))
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
