"""The render pass: coarse -> fine (parity) or proposal -> fine (fast).

Port of ``nerfsr_tpu/models/render.py``. The kernel dispatch points are
where the JAX package has them: ``_eval_level`` runs the fused MLP
(kernel C forward, kernel E backward, when the architecture allows it)
and the composite (kernel B forward, kernel D backward), both as
``torch.autograd.Function``s; ``render_rays_fast``'s ``sample_strat`` is
the inverse-CDF kernel (kernel A, forward only, on detached inputs). On
CPU tensors each wrapper takes its plain version; ``RenderConfig.plain``
asks for the plain versions on the card too, under autograd (the
reference path that the kernels are held against).

The randomized draws (stratified jitter, resample jitter, sigma noise)
come from one optional ``torch.Generator`` on the rays' device.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from nerfsr_torch.core.encoding import positional_encoding
from nerfsr_torch.core.rays import Rays
from nerfsr_torch.core.rendering import (add_gaussian_noise, compute_weights,
                                         volumetric_rendering)
from nerfsr_torch.core.sampling import (cast_rays, resample_along_rays,
                                        sample_along_rays,
                                        sample_pdf_stratified)
from nerfsr_torch.kernels import composite as kcomposite
from nerfsr_torch.kernels import mlp as kmlp
from nerfsr_torch.kernels import sampling as ksampling


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static render-path configuration."""

    n_coarse: int = 64             # --N_coarse
    n_importance: int = 64         # --N_importance
    deg_pos: int = 10              # --deg_pos
    deg_dir: int = 4               # --deg_dir
    include_identity: bool = True  # not --no_xyz
    log_scale: bool = True         # not --no_logscale
    lindisp: bool = False          # --lindisp
    white_bkgd: bool = False       # --white_bkgd
    noise_std: float = 0.0         # --noise_std
    sigma_activation: str = "relu"  # --sigma_activation
    use_dir: bool = True           # not --no_dir
    gamma_correct: bool = False    # --gamma_correct
    use_fused_mlp: bool = False    # architecture fits kernel C
    fused_dtype: str = "bf16"      # kernel C compute dtype: bf16 | f32
    fast_sampling: bool = False    # --fast_sampling
    n_prop: int = 64               # --n_prop
    deg_prop: int = 6              # --deg_prop
    uniform_frac: float = 0.0      # --fast_uniform_frac
    n_prop_levels: int = 1         # --n_prop_levels
    n_prop2: int = 32              # --n_prop2
    prop_pad: float = 0.01         # --prop_pad
    prop_pad_anneal: int = 0       # --prop_pad_anneal (resolved steps)
    prop_pad_final: float = 0.0    # --prop_pad_final
    plain: bool = False            # plain PyTorch versions of every kernel


def _eval_level(mlp, rays: Rays, points, z_vals, dir_emb,
                cfg: RenderConfig, randomized: bool,
                generator: Optional[torch.Generator] = None):
    """One network level: MLP over the sample points (kernel C or the
    module), sigma noise, composite (kernel B)."""
    n, s, _ = points.shape
    if cfg.use_fused_mlp:
        pts_flat = points.reshape(-1, 3)
        dirs_flat = rays.viewdirs[:, None, :].expand(n, s, 3).reshape(-1, 3)
        dtype = torch.bfloat16 if cfg.fused_dtype == "bf16" \
            else torch.float32
        rgb, sigma = kmlp.fused_nerf_mlp(
            kmlp.flatten_params(mlp), pts_flat, dirs_flat, dtype,
            plain=cfg.plain)
        rgb = rgb.reshape(n, s, 3)
        sigma = sigma.reshape(n, s)
    else:
        xyz_emb = positional_encoding(
            points, cfg.deg_pos, cfg.include_identity, cfg.log_scale)
        d_emb = None
        if dir_emb is not None:
            d_emb = dir_emb[:, None, :].expand(n, s, dir_emb.shape[-1])
        rgb, sigma = mlp(xyz_emb, d_emb)
    if cfg.gamma_correct:
        rgb = torch.pow(torch.clamp_min(rgb, 1e-8), 1.0 / 2.2)
    sigma = add_gaussian_noise(sigma, randomized, cfg.noise_std, generator)
    composite = volumetric_rendering if cfg.plain \
        else kcomposite.volumetric_rendering
    return composite(rgb.contiguous(), sigma.contiguous(),
                     z_vals.contiguous(), cfg.white_bkgd,
                     cfg.sigma_activation)


def _annealed_pad(cfg: RenderConfig, step):
    """Resample padding at this train step; ``step=None`` (eval) uses the
    fully annealed value when an anneal is configured."""
    if cfg.prop_pad_anneal <= 0:
        return cfg.prop_pad
    if step is None:
        return cfg.prop_pad_final
    frac = min(max(float(step) / cfg.prop_pad_anneal, 0.0), 1.0)
    return cfg.prop_pad + (cfg.prop_pad_final - cfg.prop_pad) * frac


def render_rays_fast(params, rays: Rays, cfg: RenderConfig,
                     randomized: bool, step=None,
                     generator: Optional[torch.Generator] = None
                     ) -> Dict[str, Any]:
    """Fast-sampling render: a sigma-only proposal MLP (``params["prop"]``)
    shapes the sampling distribution over ``n_prop_levels`` rounds; the
    big MLP (``params["fine"]``) runs once on ``n_importance`` samples.

    Returns fine_* outputs plus the proposal/fine histograms."""
    pad = _annealed_pad(cfg, step)
    sample_strat = sample_pdf_stratified if cfg.plain \
        else ksampling.sample_pdf_stratified

    dir_emb = None
    if cfg.use_dir:
        dir_emb = positional_encoding(
            rays.viewdirs, cfg.deg_dir, cfg.include_identity, cfg.log_scale)

    z_prop, pts = sample_along_rays(
        rays.origins, rays.directions, rays.near, rays.far, cfg.n_prop,
        randomized, cfg.lindisp, generator=generator)
    prop_hists = []
    for lvl in range(max(1, cfg.n_prop_levels)):
        if lvl > 0:
            z_prev, w_prev = prop_hists[-1]
            bins_l = 0.5 * (z_prev[..., :-1] + z_prev[..., 1:])
            z_prop = sample_strat(bins_l, w_prev[..., 1:-1].detach() + pad,
                                  cfg.n_prop2, randomized,
                                  generator=generator)
            pts = cast_rays(rays.origins, rays.directions, z_prop)
        prop_emb = positional_encoding(
            pts, cfg.deg_prop, cfg.include_identity, cfg.log_scale)
        sigma_prop = params["prop"](prop_emb)
        w_prop = compute_weights(sigma_prop, z_prop, cfg.sigma_activation)
        prop_hists.append((z_prop, w_prop))

    n_uni = int(round(cfg.n_importance * cfg.uniform_frac))
    n_cdf = cfg.n_importance - n_uni
    bins = 0.5 * (z_prop[..., :-1] + z_prop[..., 1:])
    fine_pad = pad if cfg.n_prop_levels > 1 else 0.0
    z_fine = sample_strat(bins, w_prop[..., 1:-1].detach() + fine_pad,
                          n_cdf, randomized, generator=generator)
    if n_uni > 0:
        z_uni, _ = sample_along_rays(
            rays.origins, rays.directions, rays.near, rays.far, n_uni,
            randomized, cfg.lindisp, generator=generator)
        z_fine, _ = torch.sort(torch.cat([z_fine, z_uni], dim=-1), dim=-1)
    points = cast_rays(rays.origins, rays.directions, z_fine)

    f_rgb, f_depth, f_opacity, f_weights = _eval_level(
        params["fine"], rays, points, z_fine, dir_emb, cfg, randomized,
        generator)
    out = {
        "fine_rgb": f_rgb,
        "fine_depth": f_depth,
        "fine_opacity": f_opacity,
        "fine_weights": f_weights,
        "prop_z": z_prop,
        "prop_weights": w_prop,
        "fine_z": z_fine,
    }
    for i, (z_i, w_i) in enumerate(prop_hists[:-1]):
        out[f"prop{i}_z"] = z_i
        out[f"prop{i}_weights"] = w_i
    return out


def render_rays(params, rays: Rays, cfg: RenderConfig, randomized: bool,
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, Any]:
    """Parity render: coarse network (``params["coarse"]``) on stratified
    samples, inverse-CDF resample merged with the coarse depths, fine
    network (``params["fine"]``, when ``n_importance > 0``).

    Returns coarse_* (and fine_*) rgb (N, 3), depth (N,), opacity (N,),
    weights (N, S)."""
    dir_emb = None
    if cfg.use_dir:
        dir_emb = positional_encoding(
            rays.viewdirs, cfg.deg_dir, cfg.include_identity, cfg.log_scale)

    z_vals, points = sample_along_rays(
        rays.origins, rays.directions, rays.near, rays.far, cfg.n_coarse,
        randomized, cfg.lindisp, generator=generator)
    c_rgb, c_depth, c_opacity, c_weights = _eval_level(
        params["coarse"], rays, points, z_vals, dir_emb, cfg, randomized,
        generator)
    out = {"coarse_rgb": c_rgb, "coarse_depth": c_depth,
           "coarse_opacity": c_opacity, "coarse_weights": c_weights}
    if cfg.n_importance > 0:
        z_vals, points = resample_along_rays(
            rays.origins, rays.directions, z_vals, c_weights.detach(),
            cfg.n_importance, randomized, generator=generator)
        f_rgb, f_depth, f_opacity, f_weights = _eval_level(
            params["fine"], rays, points, z_vals, dir_emb, cfg, randomized,
            generator)
        out.update({"fine_rgb": f_rgb, "fine_depth": f_depth,
                    "fine_opacity": f_opacity, "fine_weights": f_weights})
    return out
