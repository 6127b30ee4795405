"""The NeRF-SR supersampling system (experiment type 'nerf_downX').

Port of ``nerfsr_tpu/models/nerf_downx_system.py``: each training item is
one LR pixel carrying its ds^2 HR sub-rays; all sub-rays render at HR and
their mean over the ds^2 axis is supervised by the LR ground truth, with
the optional sub-pixel colour and depth variance terms and SISR
supervision. HR rays render in the grouped order (each LR pixel's ds^2
sub-rays contiguous); the eval output carries LR fields (the sub-pixel
mean) and ``*_ori`` HR fields ungrouped to scan order.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from nerfsr_torch.core.rays import Rays
from nerfsr_torch.models import register_model
from nerfsr_torch.models.criterions import psnr as psnr_fn
from nerfsr_torch.models.nerf_system import NeRFSystem


def subpixel_mean(x, ds2):
    """(N*ds2, ...) -> (N, ...) mean over the ds^2 sub-pixel axis."""
    return torch.mean(x.reshape((-1, ds2) + tuple(x.shape[1:])), dim=1)


def subpixel_var(x, ds2):
    """Sum over pixels and channels of the unbiased variance across the
    ds^2 axis."""
    g = x.reshape((-1, ds2) + tuple(x.shape[1:]))
    return torch.sum(torch.var(g, dim=1, unbiased=True))


@register_model("nerf_downX")
class NeRFDownXSystem(NeRFSystem):
    """Supersampling NeRF: HR rays, LR supervision."""

    def __init__(self, opt, device=None):
        super().__init__(opt, device=device)
        self.ds = opt.downscale
        self.ds2 = self.ds * self.ds

    # ------------------------------------------------------------------
    # training
    # ------------------------------------------------------------------
    def _flat_rays(self, batch) -> Rays:
        """(B, ds^2, C) grouped fields -> flat (B*ds^2,) Rays."""
        def flat(x):
            return x.reshape((-1,) + tuple(x.shape[2:]))
        return Rays(
            origins=flat(batch["origins"]),
            directions=flat(batch["directions"]),
            near=flat(batch["near"]),
            far=flat(batch["far"]),
            viewdirs=flat(batch.get("viewdirs", batch["directions"])),
        )

    def _loss_fn(self, params, batch, generator=None, step=None):
        opt = self.opt
        ds2 = self.ds2
        rays = self._flat_rays(batch)
        out = self.render(params, rays, randomized=bool(opt.randomized),
                          step=step, generator=generator)
        lr_rgbs = batch["rgbs"]                   # (B, 3)
        zero = torch.zeros((), device=lr_rgbs.device)
        losses: Dict[str, Any] = {}
        loss_tot = 0.0
        has_coarse = "coarse_rgb" in out          # absent in fast mode

        coarse_lr = None
        if has_coarse:
            coarse_lr = subpixel_mean(out["coarse_rgb"], ds2)
            losses["coarse_mse"] = torch.mean((coarse_lr - lr_rgbs) ** 2)
            loss_tot = loss_tot + losses["coarse_mse"] \
                * opt.lambda_coarse_mse
        fine_lr = None
        if "fine_rgb" in out:
            fine_lr = subpixel_mean(out["fine_rgb"], ds2)
            losses["fine_mse"] = torch.mean((fine_lr - lr_rgbs) ** 2)
            loss_tot = loss_tot + losses["fine_mse"] * opt.lambda_fine_mse
        else:
            losses["fine_mse"] = zero

        loss_tot = self._interlevel(out, losses, loss_tot)

        if opt.use_var_loss:      # sub-pixel colour variance
            cv = subpixel_var(out["coarse_rgb"], ds2) if has_coarse \
                else zero
            fv = subpixel_var(out["fine_rgb"], ds2) if fine_lr is not None \
                else zero
            losses["out_coarse_var"] = cv
            losses["out_fine_var"] = fv
            loss_tot = loss_tot + opt.lambda_coarse_var * cv \
                + opt.lambda_fine_var * fv

        if opt.use_depth_var_loss:   # sub-pixel depth variance, far-scaled
            far = batch["far"].reshape(-1)[0]
            cdv = subpixel_var(out["coarse_depth"] / far, ds2) \
                if has_coarse else zero
            fdv = subpixel_var(out["fine_depth"] / far, ds2) \
                if "fine_depth" in out else zero
            losses["coarse_depth_var"] = cdv
            losses["fine_depth_var"] = fdv
            loss_tot = loss_tot + opt.lambda_coarse_depth_var * cdv \
                + opt.lambda_fine_depth_var * fdv

        if "rgbs_sr" in batch:    # SISR supervision of the HR output
            sr = batch["rgbs_sr"].reshape(-1, batch["rgbs_sr"].shape[-1])
            c_sr = torch.mean((out["coarse_rgb"] - sr) ** 2) if has_coarse \
                else zero
            f_sr = torch.mean((out["fine_rgb"] - sr) ** 2) \
                if "fine_rgb" in out else zero
            losses["coarse_mse_sr"] = c_sr
            losses["fine_mse_sr"] = f_sr
            loss_tot = loss_tot + c_sr + f_sr

        with torch.no_grad():
            if coarse_lr is not None:
                losses["coarse_psnr"] = psnr_fn(coarse_lr, lr_rgbs)
            losses["fine_psnr"] = psnr_fn(fine_lr, lr_rgbs) \
                if fine_lr is not None else zero
            if "rgbs_ori" in batch:   # HR PSNR against the HR truth
                hr = batch["rgbs_ori"].reshape(-1, 3)
                if has_coarse:
                    losses["coarse_psnr_ori"] = psnr_fn(out["coarse_rgb"],
                                                        hr)
                if "fine_rgb" in out:
                    losses["fine_psnr_ori"] = psnr_fn(out["fine_rgb"], hr)
        losses["tot"] = loss_tot
        return loss_tot, losses

    # ------------------------------------------------------------------
    # eval
    # ------------------------------------------------------------------
    def _post_grouped(self, out):
        """Flat grouped-order render rows -> LR (sub-pixel mean) fields
        plus HR ``*_ori`` fields in scan order. uint8 rgb (``quantize_rgb``)
        keeps the HR field uint8 and takes the LR mean in f32 [0, 1] of the
        quantized values."""
        ds2 = self.ds2
        result = {}
        n_lr = next(iter(out.values())).shape[0] // ds2
        for k, v in out.items():
            grouped = v.reshape((n_lr, ds2) + v.shape[1:])
            if grouped.dtype == np.uint8:
                result[k] = grouped.astype(np.float32).mean(axis=1) / 255.0
            else:
                result[k] = grouped.mean(axis=1)
            result[k + "_ori"] = self._ungroup(grouped)
        return result

    def _postprocess_eval(self, flat):
        return self._post_grouped(flat)

    def render_eval(self, params, dataset, idx):
        """Device-raygen eval for grouped datasets: their ``eval_dirs`` are
        pre-permuted to the grouped order, so the flat rows regroup."""
        flat_out = self.render_pose(params, dataset.eval_raygen_spec(idx),
                                    dataset.eval_dirs())
        return self._post_grouped(flat_out)

    def _ungroup(self, grouped, hw=None):
        """(N_lr, ds^2, ...) -> (H*W, ...) HR scan order
        ('(h1 w1)(s1 s2) c -> (h1 s1)(w1 s2) c'); ``hw`` overrides the
        image size as (w, h)."""
        w, h = hw if hw is not None else self.opt.img_wh
        ds = self.ds
        h1, w1 = h // ds, w // ds
        tail = grouped.shape[2:]
        x = grouped.reshape((h1, w1, ds, ds) + tail)
        x = x.transpose((0, 2, 1, 3) + tuple(range(4, x.ndim)))
        return x.reshape((h * w,) + tail)
