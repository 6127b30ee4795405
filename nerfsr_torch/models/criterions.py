"""Losses and metrics of the training path.

Port of ``nerfsr_tpu/models/criterions.py``: ``psnr``, ``_outer_mass`` and
``interlevel_loss`` (the proposal histogram bound of ``--fast_sampling``),
``ssim``, and the refine stage's ``l1``, ``image_gradients`` and
``gradient_loss`` (NHWC images).
The JAX package counts histogram edges by an all-pairs comparison; on
sorted edges that count is ``torch.searchsorted`` (``right=True`` for
``<=``, ``right=False`` for ``<``), which gives the same indices at ties.
"""

from __future__ import annotations

import torch


def psnr(pred, target, valid_mask=None):
    """-10 log10(mse)."""
    err = (pred - target) ** 2
    if valid_mask is not None:
        err = err[valid_mask]
    return -10.0 * torch.log10(torch.mean(err))


def l1(pred, target):
    """Mean absolute error."""
    return torch.mean(torch.abs(pred - target))


def image_gradients(img):
    """Forward differences of (N, H, W, C) images, zero-padded at the far
    edge: (dy, dx), each of the image's shape."""
    dy = img[:, 1:] - img[:, :-1]
    dx = img[:, :, 1:] - img[:, :, :-1]
    dy = torch.cat([dy, torch.zeros_like(img[:, :1])], 1)
    dx = torch.cat([dx, torch.zeros_like(img[:, :, :1])], 2)
    return dy, dx


def gradient_loss(pred, target):
    """Mean L1 between the images' gradients, x and y terms summed and
    halved."""
    pdy, pdx = image_gradients(pred)
    tdy, tdx = image_gradients(target)
    return (torch.mean(torch.abs(pdx - tdx))
            + torch.mean(torch.abs(pdy - tdy))) / 2


def _outer_mass(t_q, t_env, w_env):
    """Upper bound on the env histogram's mass inside each query
    interval: env-CDF(smallest env edge >= hi) - env-CDF(largest env edge
    <= lo). Sorted edges t_q (N, S+1) / t_env (N, P+1), env bin weights
    w_env (N, P) -> (N, S)."""
    cw = torch.cat([torch.zeros_like(w_env[..., :1]),
                    torch.cumsum(w_env, -1)], -1)
    n_edges = cw.shape[-1]
    t_env, t_q = t_env.contiguous(), t_q.contiguous()
    # floor index #{j : t_env[j] <= x} - 1, ceil index #{j : t_env[j] < x}
    le = torch.searchsorted(t_env, t_q, right=True) - 1
    lt = torch.searchsorted(t_env, t_q, right=False)
    idx_lo = torch.clamp(le[..., :-1], 0, n_edges - 1)
    idx_hi = torch.clamp(lt[..., 1:], 0, n_edges - 1)
    mass = torch.gather(cw, -1, idx_hi) - torch.gather(cw, -1, idx_lo)
    # maximum, not clamp: both split the gradient at a tie, as JAX does
    return torch.maximum(mass, torch.zeros_like(mass))


def interlevel_loss(z_fine, w_fine, z_prop, w_prop, eps: float = 1e-6):
    """Penalize the proposal histogram wherever it fails to upper-bound
    the fine histogram (mip-NeRF 360's lossfun_outer). Sample depths are
    bin edges; each histogram's terminal (1e10-interval) weight is
    dropped. The fine weights are detached: only the proposal learns from
    this term."""
    w_f = w_fine[..., :-1].detach()
    w_outer = _outer_mass(z_fine, z_prop, w_prop[..., :-1])
    d = w_f - w_outer
    return torch.mean(torch.maximum(d, torch.zeros_like(d)) ** 2
                      / (w_f + eps))


def _gaussian_kernel(size: int, sigma: float, device) -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float32, device=device) - size // 2
    g = torch.exp(-(x ** 2) / (2.0 * sigma ** 2))
    return g / g.sum()


def _blur_valid(x: torch.Tensor, kernel: torch.Tensor, dim: int):
    """'VALID' correlation of ``x`` with ``kernel`` along ``dim``, as f32
    multiply-adds of shifted slices (no convolution library, so no
    reduced-precision math on any device)."""
    n = x.shape[dim] - kernel.shape[0] + 1
    out = x.narrow(dim, 0, n) * kernel[0]
    for k in range(1, kernel.shape[0]):
        out = out + x.narrow(dim, k, n) * kernel[k]
    return out


def ssim(img0, img1, max_val: float = 1.0, filter_size: int = 11,
         filter_sigma: float = 1.5, k1: float = 0.01, k2: float = 0.03,
         return_map: bool = False):
    """Gaussian-window SSIM (Wang et al.) over (H, W, C) or (N, H, W, C)
    images: an 11-tap separable Gaussian of sigma 1.5, 'VALID' borders,
    in f32 on the images' device. A window wider than the image shrinks
    to it, as the JAX package's does."""
    img0 = torch.as_tensor(img0).float()
    img1 = torch.as_tensor(img1).float()
    if img0.ndim == 3:
        img0, img1 = img0[None], img1[None]
    filter_size = min(filter_size, img0.shape[1], img0.shape[2])
    kernel = _gaussian_kernel(filter_size, filter_sigma, img0.device)

    def blur(x):
        return _blur_valid(_blur_valid(x, kernel, 1), kernel, 2)

    mu0, mu1 = blur(img0), blur(img1)
    mu00, mu11, mu01 = mu0 * mu0, mu1 * mu1, mu0 * mu1
    s00 = blur(img0 * img0) - mu00
    s11 = blur(img1 * img1) - mu11
    s01 = blur(img0 * img1) - mu01
    c1 = (k1 * max_val) ** 2
    c2 = (k2 * max_val) ** 2
    numer = (2 * mu01 + c1) * (2 * s01 + c2)
    denom = (mu00 + mu11 + c1) * (s00 + s11 + c2)
    ssim_map = numer / denom
    return ssim_map if return_map else torch.mean(ssim_map)
