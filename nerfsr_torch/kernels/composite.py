"""Kernels B and D: fused alpha compositing and its analytic backward
(``csrc/composite.cu``).

Twin of ``nerfsr_tpu/ops/experimental/pallas_composite.py``:
``pallas_volumetric_rendering``'s forward (``_run_fwd``, kernel B) and its
custom VJP's backward (``_run_bwd``, kernel D). ``volumetric_rendering``
is a ``torch.autograd.Function`` whose forward is B and whose backward is
D; it saves rgb, sigma and z, as ``_vjp_fwd`` does.

A CPU tensor takes the plain versions
(``core/rendering.py:volumetric_rendering`` and ``composite_bwd_plain``);
a CUDA tensor launches the kernels or raises.
"""

from __future__ import annotations

import torch

from nerfsr_torch.core import rendering
from nerfsr_torch.kernels import _lib

ACTIVATIONS = ("relu", "softplus")
EPS = 1e-10              # inside the transmittance product
TERMINAL_DELTA = 1e10


def _check_activation(activation):
    if activation not in ACTIVATIONS:
        raise ValueError(f"unknown sigma activation: {activation}")


def composite_fwd(rgb: torch.Tensor, sigma: torch.Tensor,
                  z_vals: torch.Tensor, white_bkgd: bool,
                  activation: str = "relu"):
    """Kernel B (no autograd): rgb (..., S, 3), sigma (..., S), z_vals
    (..., S), all f32 -> comp_rgb (..., 3), depth (...), opacity (...),
    weights (..., S)."""
    _check_activation(activation)
    if sigma.device.type == "cpu":
        return rendering.volumetric_rendering(rgb, sigma, z_vals,
                                              white_bkgd, activation)
    lead, s = sigma.shape[:-1], sigma.shape[-1]
    n = sigma.numel() // s
    _lib.check_cuda(sigma, "sigma", sigma.shape)
    _lib.check_cuda(z_vals, "z_vals", sigma.shape, device=sigma.device)
    _lib.check_cuda(rgb, "rgb", tuple(sigma.shape) + (3,),
                    device=sigma.device)
    comp = torch.empty(lead + (3,), dtype=torch.float32, device=sigma.device)
    depth = torch.empty(lead, dtype=torch.float32, device=sigma.device)
    opacity = torch.empty(lead, dtype=torch.float32, device=sigma.device)
    weights = torch.empty_like(sigma)
    with torch.cuda.device(sigma.device):
        err = _lib.lib().nerfsr_composite_fwd(
            rgb.data_ptr(), sigma.data_ptr(), z_vals.data_ptr(),
            comp.data_ptr(), depth.data_ptr(), opacity.data_ptr(),
            weights.data_ptr(), n, s, int(activation == "softplus"),
            int(bool(white_bkgd)), _lib.stream_ptr(sigma))
    _lib.check(err, "composite_fwd")
    _lib.COUNTS["composite_fwd"] += 1
    return comp, depth, opacity, weights


def composite_bwd_plain(rgb, sigma, z_vals, gc, gd, go, gw,
                        white_bkgd: bool, activation: str = "relu"):
    """Plain PyTorch version of kernel D: the analytic VJP of the
    composite, step by step (``pallas_composite.py``'s formulas).

    rgb (..., S, 3), sigma, z_vals (..., S); cotangents gc (..., 3),
    gd (...), go (...), gw (..., S) -> grgb (..., S, 3), gsigma (..., S),
    gz (..., S)."""
    _check_activation(activation)
    sa = rendering.sigma_activation(sigma, activation)
    deltas = z_vals[..., 1:] - z_vals[..., :-1]
    deltas = torch.cat(
        [deltas, torch.full_like(z_vals[..., :1], TERMINAL_DELTA)], dim=-1)
    one_m_alpha = torch.exp(-deltas * sa)
    alpha = 1.0 - one_m_alpha
    trans = torch.cat(
        [torch.ones_like(alpha[..., :1]),
         torch.cumprod(1.0 - alpha[..., :-1] + EPS, dim=-1)], dim=-1)
    weights = alpha * trans
    if white_bkgd:
        go = go - gc.sum(-1)
    gw_tot = ((gc[..., None, :] * rgb).sum(-1) + gd[..., None] * z_vals
              + go[..., None] + gw)
    grgb = weights[..., None] * gc[..., None, :]
    # exclusive suffix sums sum_{i>j} gw_i w_i, as a shifted reverse cumsum
    m = gw_tot * weights
    incl = torch.flip(torch.cumsum(torch.flip(m, [-1]), -1), [-1])
    suffix = torch.cat([incl[..., 1:], torch.zeros_like(incl[..., :1])], -1)
    ga = gw_tot * trans - suffix / (one_m_alpha + EPS)
    if activation == "relu":
        act_grad = (sigma > 0).to(sigma.dtype)
    else:
        act_grad = torch.sigmoid(sigma - 1.0)
    gsigma = ga * deltas * one_m_alpha * act_grad
    gdelta = (ga * sa * one_m_alpha)[..., :-1]    # terminal delta: constant
    zero = torch.zeros_like(z_vals[..., :1])      # (also at S = 1)
    gz = weights * gd[..., None]
    gz = gz - torch.cat([gdelta, zero], -1)
    gz = gz + torch.cat([zero, gdelta], -1)
    return grgb, gsigma, gz


def composite_bwd(rgb, sigma, z_vals, gc, gd, go, gw, white_bkgd: bool,
                  activation: str = "relu"):
    """Kernel D (shapes as ``composite_bwd_plain``); every input f32 and
    contiguous."""
    _check_activation(activation)
    if sigma.device.type == "cpu":
        return composite_bwd_plain(rgb, sigma, z_vals, gc, gd, go, gw,
                                   white_bkgd, activation)
    lead, s = sigma.shape[:-1], sigma.shape[-1]
    n = sigma.numel() // s
    dev = sigma.device
    _lib.check_cuda(sigma, "sigma", sigma.shape)
    for name, x, shape in (("z_vals", z_vals, sigma.shape),
                           ("rgb", rgb, tuple(sigma.shape) + (3,)),
                           ("gc", gc, tuple(lead) + (3,)),
                           ("gd", gd, lead), ("go", go, lead),
                           ("gw", gw, sigma.shape)):
        _lib.check_cuda(x, name, shape, device=dev)
    grgb = torch.empty_like(rgb)
    gsigma = torch.empty_like(sigma)
    gz = torch.empty_like(sigma)
    with torch.cuda.device(dev):
        err = _lib.lib().nerfsr_composite_bwd(
            rgb.data_ptr(), sigma.data_ptr(), z_vals.data_ptr(),
            gc.data_ptr(), gd.data_ptr(), go.data_ptr(), gw.data_ptr(),
            grgb.data_ptr(), gsigma.data_ptr(), gz.data_ptr(), n, s,
            int(activation == "softplus"), int(bool(white_bkgd)),
            _lib.stream_ptr(sigma))
    _lib.check(err, "composite_bwd")
    _lib.COUNTS["composite_bwd"] += 1
    return grgb, gsigma, gz


class _Composite(torch.autograd.Function):
    """Forward kernel B, backward kernel D."""

    @staticmethod
    def forward(ctx, rgb, sigma, z_vals, white_bkgd, activation):
        ctx.white_bkgd, ctx.activation = white_bkgd, activation
        ctx.save_for_backward(rgb, sigma, z_vals)
        return composite_fwd(rgb, sigma, z_vals, white_bkgd, activation)

    @staticmethod
    def backward(ctx, gc, gd, go, gw):
        rgb, sigma, z_vals = ctx.saved_tensors
        grgb, gsigma, gz = composite_bwd(
            rgb, sigma, z_vals, gc.contiguous(), gd.contiguous(),
            go.contiguous(), gw.contiguous(), ctx.white_bkgd,
            ctx.activation)
        return grgb, gsigma, gz, None, None


def volumetric_rendering(rgb: torch.Tensor, sigma: torch.Tensor,
                         z_vals: torch.Tensor, white_bkgd: bool,
                         activation: str = "relu"):
    """rgb (..., S, 3), sigma (..., S), z_vals (..., S), all f32 ->
    comp_rgb (..., 3), depth (...), opacity (...), weights (..., S);
    differentiable in rgb, sigma and z_vals through kernel D."""
    return _Composite.apply(rgb, sigma, z_vals, bool(white_bkgd),
                            activation)
