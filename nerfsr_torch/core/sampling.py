"""Stratified and hierarchical (inverse-CDF) sampling along rays.

Port of ``nerfsr_tpu/core/sampling.py``. Randomized draws come from an
optional ``torch.Generator`` or from explicit ``u``/``jitter`` tensors, so
tests can hand the JAX function and this one the same numbers.

``_invert_cdf`` is the plain version of the inverse-CDF kernel
(``nerfsr_torch/kernels/sampling.py``).
"""

from __future__ import annotations

from typing import Optional

import torch

from nerfsr_torch.parallel import mesh


def cast_rays(origins: torch.Tensor, directions: torch.Tensor,
              z_vals: torch.Tensor) -> torch.Tensor:
    """Points ``o + t * d``: (..., 3), (..., 3), (..., S) -> (..., S, 3)."""
    return origins[..., None, :] + z_vals[..., None] * directions[..., None, :]


def _uniform(shape, like: torch.Tensor, generator: Optional[torch.Generator]):
    """U[0, 1) draws in ``like``'s dtype on ``like``'s device (a rank's
    rows of the world's draw inside a split step, ``parallel/mesh.py``)."""
    return mesh.draw(torch.rand, shape, generator=generator,
                     dtype=like.dtype, device=like.device)


def sample_along_rays(origins, directions, near, far, num_samples: int,
                      randomized: bool, lindisp: bool,
                      u: Optional[torch.Tensor] = None,
                      generator: Optional[torch.Generator] = None):
    """Stratified coarse sampling.

    near/far: (..., 1). ``u`` (..., S) overrides the random jitter.
    Returns z_vals (..., S) and points (..., S, 3).
    """
    t_vals = torch.linspace(0.0, 1.0, num_samples, dtype=origins.dtype,
                            device=origins.device)
    if lindisp:
        z_vals = 1.0 / (1.0 / near * (1.0 - t_vals) + 1.0 / far * t_vals)
    else:
        z_vals = near * (1.0 - t_vals) + far * t_vals
    if randomized:
        z_mids = 0.5 * (z_vals[..., :-1] + z_vals[..., 1:])
        upper = torch.cat([z_mids, z_vals[..., -1:]], dim=-1)
        lower = torch.cat([z_vals[..., :1], z_mids], dim=-1)
        if u is None:
            u = _uniform(z_vals.shape, z_vals, generator)
        z_vals = lower + u * (upper - lower)
    return z_vals, cast_rays(origins, directions, z_vals)


def _invert_cdf(bins: torch.Tensor, weights: torch.Tensor,
                u: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Inverse-CDF tail shared by ``sample_pdf``/``sample_pdf_stratified``:
    eps added to the weights, zero-prefixed CDF, searchsorted right,
    below/above clamp, degenerate bins (denom < eps) mapped to denom=1.

    bins: (N, B); weights: (N, B-1); u: (N, Q) -> (N, Q).
    """
    weights = weights + eps
    pdf = weights / torch.sum(weights, dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)

    n_bins = bins.shape[-1]
    # the CDF is non-decreasing, so this equals the JAX package's
    # compare-all count #{b : cdf[b] <= u}
    inds = torch.searchsorted(cdf.contiguous(), u.contiguous(), right=True)
    below = torch.clamp(inds - 1, min=0)
    above = torch.clamp(inds, max=n_bins - 1)

    cdf_below = torch.gather(cdf, -1, below)
    cdf_above = torch.gather(cdf, -1, above)
    bins_below = torch.gather(bins, -1, below)
    bins_above = torch.gather(bins, -1, above)

    denom = cdf_above - cdf_below
    denom = torch.where(denom < eps, torch.ones_like(denom), denom)
    t = (u - cdf_below) / denom
    return bins_below + t * (bins_above - bins_below)


def pdf_uniforms(bins: torch.Tensor, num_samples: int, randomized: bool,
                 generator: Optional[torch.Generator] = None):
    """The ``u`` of ``sample_pdf``: random, or linspace(0, 1)."""
    n_rays = bins.shape[0]
    if randomized:
        return _uniform((n_rays, num_samples), bins, generator)
    u = torch.linspace(0.0, 1.0, num_samples, dtype=bins.dtype,
                       device=bins.device)
    return u.expand(n_rays, num_samples).contiguous()


def stratified_uniforms(bins: torch.Tensor, num_samples: int,
                        randomized: bool,
                        jitter: Optional[torch.Tensor] = None,
                        generator: Optional[torch.Generator] = None):
    """The ``u`` of ``sample_pdf_stratified``: u_i jittered inside its own
    [i/N, (i+1)/N) cell (jitter 0.5 when not randomized), so u and the
    inverse-CDF output are sorted per ray by construction."""
    n_rays = bins.shape[0]
    base = torch.arange(num_samples, dtype=bins.dtype, device=bins.device)
    if jitter is None:
        if randomized:
            jitter = _uniform((n_rays, num_samples), bins, generator)
        else:
            jitter = torch.full((n_rays, num_samples), 0.5,
                                dtype=bins.dtype, device=bins.device)
    return (base + jitter) / num_samples


def sample_pdf(bins: torch.Tensor, weights: torch.Tensor, num_samples: int,
               randomized: bool, u: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Inverse-CDF sampling of ``num_samples`` depths from a piecewise PDF
    over ``bins``: (N, B), (N, B-1) -> (N, num_samples)."""
    if u is None:
        u = pdf_uniforms(bins, num_samples, randomized, generator)
    return _invert_cdf(bins, weights, u)


def sample_pdf_stratified(bins: torch.Tensor, weights: torch.Tensor,
                          num_samples: int, randomized: bool,
                          jitter: Optional[torch.Tensor] = None,
                          generator: Optional[torch.Generator] = None):
    """Inverse-CDF sampling with stratified uniforms (plain version; the
    kernel twin is ``nerfsr_torch.kernels.sampling.sample_pdf_stratified``)."""
    u = stratified_uniforms(bins, num_samples, randomized, jitter, generator)
    return _invert_cdf(bins, weights, u)


def resample_along_rays(origins, directions, z_vals, weights,
                        num_samples: int, randomized: bool,
                        u: Optional[torch.Tensor] = None,
                        generator: Optional[torch.Generator] = None):
    """Hierarchical fine resampling merged with the coarse depths: bins are
    coarse interval midpoints, the first/last coarse weights are dropped,
    and the union of coarse and new depths is sorted. ``weights`` must
    already be detached.

    z_vals, weights: (N, S) -> z_vals (N, S + num_samples), points.
    """
    bins = 0.5 * (z_vals[..., :-1] + z_vals[..., 1:])
    z_new = sample_pdf(bins, weights[..., 1:-1], num_samples, randomized,
                       u, generator)
    z_vals, _ = torch.sort(torch.cat([z_vals, z_new], dim=-1), dim=-1)
    return z_vals, cast_rays(origins, directions, z_vals)
