"""Volume rendering (alpha compositing).

Port of ``nerfsr_tpu/core/rendering.py``: deltas with a 1e10 terminal
interval, ``alpha = 1 - exp(-delta * act(sigma))``, exclusive cumulative
transmittance with eps=1e-10, composited rgb/depth/opacity and the
white-background blend.

``volumetric_rendering`` is the plain version of the composite kernel
(``nerfsr_torch/kernels/composite.py``); ``compute_weights`` also serves
the proposal rounds, which use no kernel, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional

import torch

from nerfsr_torch.parallel import mesh


def sigma_activation(sigma: torch.Tensor, kind: str = "relu") -> torch.Tensor:
    """Density activation: relu, or the shifted softplus log(1+exp(x-1))."""
    if kind == "relu":
        return torch.relu(sigma)
    if kind == "softplus":
        # same stable form as jax.nn.softplus (logaddexp(x, 0))
        return torch.logaddexp(sigma - 1.0, torch.zeros_like(sigma))
    raise ValueError(f"unknown sigma activation: {kind}")


def compute_weights(sigma: torch.Tensor, z_vals: torch.Tensor,
                    activation: str = "relu") -> torch.Tensor:
    """Compositing weights alone: (..., S), (..., S) -> (..., S)."""
    eps = 1e-10
    # the terminal is cut from z_vals, not from the inner deltas, so a
    # single sample (S = 1) gets it too; the JAX package's form yields no
    # weights there
    deltas = z_vals[..., 1:] - z_vals[..., :-1]
    deltas = torch.cat([deltas, torch.full_like(z_vals[..., :1], 1e10)],
                       dim=-1)
    alpha = 1.0 - torch.exp(-deltas * sigma_activation(sigma, activation))
    trans = torch.cat(
        [torch.ones_like(alpha[..., :1]),
         _Cumprod.apply(1.0 - alpha[..., :-1] + eps)], dim=-1)
    return alpha * trans


class _Cumprod(torch.autograd.Function):
    """``torch.cumprod`` over the last axis of factors that are never 0
    (1 - alpha + eps >= eps), with the backward autograd takes for such
    factors, reversed cumulative sum of grad * out over the factors, but
    without its host read: autograd's cumprod backward first asks
    ``(input == 0).any().item()``, which a CUDA-graph capture of the
    training step cannot do. Same operations, so the same bits."""

    @staticmethod
    def forward(ctx, x):
        out = torch.cumprod(x, dim=-1)
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    def backward(ctx, grad):
        x, out = ctx.saved_tensors
        if x.shape[-1] <= 1:
            return grad
        w = out * grad
        return w.flip(-1).cumsum(-1).flip(-1).div(x)


def volumetric_rendering(rgb: torch.Tensor, sigma: torch.Tensor,
                         z_vals: torch.Tensor, white_bkgd: bool,
                         activation: str = "relu"):
    """Composite per-sample rgb/sigma into per-ray colour/depth/opacity.

    rgb: (..., S, 3) (already sigmoid-activated); sigma: (..., S) raw
    density; z_vals: (..., S). Returns comp_rgb (..., 3), depth (...),
    opacity (...), weights (..., S).
    """
    weights = compute_weights(sigma, z_vals, activation)
    comp_rgb = torch.sum(weights[..., None] * rgb, dim=-2)
    depth = torch.sum(weights * z_vals, dim=-1)
    opacity = torch.sum(weights, dim=-1)
    if white_bkgd:
        comp_rgb = comp_rgb + (1.0 - opacity[..., None])
    return comp_rgb, depth, opacity, weights


def add_gaussian_noise(raw: torch.Tensor, randomized: bool,
                       noise_std: float,
                       generator: Optional[torch.Generator] = None,
                       noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sigma noise regularizer; ``noise`` overrides the N(0, 1) draw."""
    if randomized and noise_std > 0:
        if noise is None:
            noise = mesh.draw(torch.randn, raw.shape, generator=generator,
                              dtype=raw.dtype, device=raw.device)
        return raw + noise * noise_std
    return raw
