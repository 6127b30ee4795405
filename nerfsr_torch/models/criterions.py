"""Losses and metrics of the training path.

Port of ``nerfsr_tpu/models/criterions.py``: ``psnr``, ``_outer_mass`` and
``interlevel_loss`` (the proposal histogram bound of ``--fast_sampling``).
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
