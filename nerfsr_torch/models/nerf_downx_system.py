"""The NeRF-SR supersampling system (experiment type 'nerf_downX').

Port of ``nerfsr_tpu/models/nerf_downx_system.py``: each training item is
one LR pixel carrying its ds^2 HR sub-rays; all sub-rays render at HR and
their mean over the ds^2 axis is supervised by the LR ground truth, with
the optional sub-pixel colour and depth variance terms and SISR
supervision. HR rays render in the grouped order (each LR pixel's ds^2
sub-rays contiguous); the eval output carries LR fields (the sub-pixel
mean) and ``*_ori`` HR fields ungrouped to scan order. The engine's
metrics are the LR PSNR and the HR ``_ori`` PSNR and SSIM; its visuals
are the LR strip, the HR ``{i}-{level}-ori`` strip and the depth
matrices ``{i}-{level}-depth[-ori]`` (npz + JET PNG) that the refine
stage reads.

The auxiliary updates, each a full optimizer step (the step count, the
learning rate's schedule and Adam's counts advance, as in the JAX
package): ``--reg_patch``'s total-variation update on a rendered HR
patch (``reg_patch_step`` from a host block, or inside a chunk from
rays made on the device) and ``--with_netD``'s adversarial update
(``create_gan_state``; ``gan_step`` from a host patch, ``_gan_update``:
the patch rendered for D, D's step with its spectral norm refreshed once
and, under ``wgangp``, the gradient penalty, then the patch rendered again
under G's gradient with the same draws, and G's step). Inside a chunk
(``train_steps_scan_gan``, ``train_steps_scan_reg``) the main steps and
the updates that fire after them (at global steps that are multiples of
``--gan_iter`` and ``--reg_patch_freq``, known on the host when the chunk
starts) run as a sequence: on the card each is a replay of its own
graph, the patches made on the device from ``gan_raygen_buffers``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from nerfsr_torch.core.rays import Rays, get_rays, make_rays, ndc_rays
from nerfsr_torch.graphs import run_steps
from nerfsr_torch.models import register_model
from nerfsr_torch.models.criterions import (gan_loss, image_gradients,
                                            tv_loss, wgan_gradient_penalty)
from nerfsr_torch.models.criterions import psnr as psnr_fn
from nerfsr_torch.models.criterions import ssim as ssim_fn
from nerfsr_torch.models.nerf_system import NeRFSystem, TrainState, _host
from nerfsr_torch.models.networks import GanState, create_discriminator
from nerfsr_torch.parallel import mesh
from nerfsr_torch.utils.optim import Adam
from nerfsr_torch.utils.schedule import write_lr
from nerfsr_torch.utils.visualizer import Visualizee, depth2im


def subpixel_mean(x, ds2):
    """(N*ds2, ...) -> (N, ...) mean over the ds^2 sub-pixel axis."""
    return torch.mean(x.reshape((-1, ds2) + tuple(x.shape[1:])), dim=1)


def subpixel_var(x, ds2):
    """Sum over pixels and channels of the unbiased variance across the
    ds^2 axis."""
    g = x.reshape((-1, ds2) + tuple(x.shape[1:]))
    return torch.sum(torch.var(g, dim=1, unbiased=True))


def _pick(x, i):
    """Row ``i`` (a 0-d device tensor) of ``x``: by ``index_select``,
    since indexing by a 0-d tensor reads its value back to the host,
    which a CUDA graph's capture forbids."""
    return torch.index_select(x, 0, i.reshape(1))[0]


GAN_LOSS_NAMES = ("G_GAN", "D_real", "D_fake")


@register_model("nerf_downX")
class NeRFDownXSystem(NeRFSystem):
    """Supersampling NeRF: HR rays, LR supervision."""

    def __init__(self, opt, device=None):
        super().__init__(opt, device=device)
        self.ds = opt.downscale
        self.ds2 = self.ds * self.ds
        # the GAN update's two renders draw from these, one each, seeded
        # alike before every update (seed_gan_renders)
        self.gan_gens = (torch.Generator(device=self.device),
                         torch.Generator(device=self.device))

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
            losses["coarse_mse"] = mesh.row_mean((coarse_lr - lr_rgbs) ** 2)
            loss_tot = loss_tot + losses["coarse_mse"] \
                * opt.lambda_coarse_mse
        fine_lr = None
        if "fine_rgb" in out:
            fine_lr = subpixel_mean(out["fine_rgb"], ds2)
            losses["fine_mse"] = mesh.row_mean((fine_lr - lr_rgbs) ** 2)
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
            c_sr = mesh.row_mean((out["coarse_rgb"] - sr) ** 2) \
                if has_coarse else zero
            f_sr = mesh.row_mean((out["fine_rgb"] - sr) ** 2) \
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
    # --reg_patch: total variation of a rendered HR patch
    # ------------------------------------------------------------------
    def _tv_of_render(self, params, rays, side, generator, step, grouped):
        """``--reg_lambda_tv`` times the TV of each level's render of a
        side x side HR patch: rays in the grouped order (a host block,
        ungrouped to the spatial patch first) or in HR scan order."""
        out = self.render(params, rays, randomized=bool(self.opt.randomized),
                          step=step, generator=generator)
        loss = 0.0
        for level in ("coarse_rgb", "fine_rgb"):
            if level in out:
                img = out[level]
                if grouped:
                    plen_lr = side // self.ds
                    img = self._ungroup(img.reshape(plen_lr * plen_lr,
                                                    self.ds2, -1),
                                        hw=(side, side))
                loss = loss + tv_loss(img.reshape(1, side, side, -1))
        loss = loss * self.opt.reg_lambda_tv
        return loss, {"patch": loss}

    def reg_patch_step(self, state: TrainState, patch_batch,
                       generator: Optional[torch.Generator] = None):
        """One TV update on a host block (``patch_buffer``'s: grouped
        (reg_patch_len^2, ds^2, .) rays); a full optimizer step."""
        write_lr(state.optimizer, self.lr_fn, state.step)
        batch = {k: torch.as_tensor(np.asarray(v)).to(self.device)
                 for k, v in patch_batch.items()}
        side = self.opt.reg_patch_len * self.ds
        losses = self._update(state, *self._tv_of_render(
            state.params, self._flat_rays(batch), side, generator,
            state.step, grouped=True), fill=True)
        state.step += 1
        state.step_t.fill_(state.step)
        return state, losses

    # ------------------------------------------------------------------
    # patches made on the device from gan_raygen_buffers
    # ------------------------------------------------------------------
    def upload_gan_buffers(self, bufs) -> Dict[str, torch.Tensor]:
        """``gan_raygen_buffers()``' arrays on the device, once."""
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                for k, v in bufs.items()}

    def _patch_rays_at(self, gan_bufs, geom, view_i, r0, c0, side):
        """The rays of the side x side HR patch at HR pixel (``r0``,
        ``c0``) of usable view ``view_i`` (0-d device tensors), in HR scan
        order: the direction grid's block rotated by the view's pose and
        NDC-warped per ``geom``; the view directions are the (warped) ray
        directions."""
        ar = torch.arange(side, device=self.device)
        d = gan_bufs["dirs_hw"][(r0 + ar)[:, None],
                                (c0 + ar)[None, :]].reshape(-1, 3)
        ro, rd = get_rays(d, _pick(gan_bufs["poses"], view_i))
        if geom[0] == "ndc":
            _, h, w, focal, near, far = geom
            ro, rd = ndc_rays(h, w, focal, 1.0, ro, rd)
        else:
            _, near, far = geom
        return make_rays(ro, rd, near, far, rd)

    def _gan_patch_at(self, gan_bufs, geom, view_i, r0_lr, c0_lr):
        """The adversarial patch at an LR-aligned position: its rays and
        the real HR pixels there (1, P, P, 3)."""
        plen = self.opt.patch_len
        r0, c0 = r0_lr * self.ds, c0_lr * self.ds
        rays = self._patch_rays_at(gan_bufs, geom, view_i, r0, c0, plen)
        ar = torch.arange(plen, device=self.device)
        ri = _pick(gan_bufs["real_idx"], view_i).long().reshape(1, 1, 1)
        real = gan_bufs["reals"][ri, (r0 + ar)[None, :, None],
                                 (c0 + ar)[None, None, :]]
        return rays, real

    def _draw(self, n, generator):
        """A draw in [0, n) on the device, 0-d."""
        return torch.randint(0, n, (), generator=generator,
                             device=self.device)

    def _gan_sample_patch(self, gan_bufs, geom, generator, draws=None):
        """A random usable view and LR-aligned position (row and column
        exclude the last that fits, as the host ``gan_patch``; at least
        1): the patch's rays and real pixels. ``draws`` (3,) injects the
        view, row and column."""
        plen_lr = self.opt.patch_len // self.ds
        h, w = gan_bufs["dirs_hw"].shape[:2]
        hl, wl = h // self.ds, w // self.ds
        if draws is None:
            draws = (self._draw(gan_bufs["poses"].shape[0], generator),
                     self._draw(max(1, hl - plen_lr), generator),
                     self._draw(max(1, wl - plen_lr), generator))
        return self._gan_patch_at(gan_bufs, geom, *draws)

    def _reg_sample_rays(self, gan_bufs, geom, generator, draws=None):
        """A random ``--reg_patch_len`` LR block (row and column over
        every position that fits, as the host ``patch_buffer``) as HR
        scan-order rays. ``draws`` (3,) injects the view, row and
        column."""
        plen_lr = self.opt.reg_patch_len
        h, w = gan_bufs["dirs_hw"].shape[:2]
        hl, wl = h // self.ds, w // self.ds
        if draws is None:
            draws = (self._draw(gan_bufs["poses"].shape[0], generator),
                     self._draw(hl - plen_lr + 1, generator),
                     self._draw(wl - plen_lr + 1, generator))
        view_i, r0_lr, c0_lr = draws
        return self._patch_rays_at(gan_bufs, geom, view_i, r0_lr * self.ds,
                                   c0_lr * self.ds, plen_lr * self.ds)

    # ------------------------------------------------------------------
    # --with_netD: the adversarial patch update
    # ------------------------------------------------------------------
    def create_gan_state(self, seed: int = 0) -> GanState:
        """A fresh discriminator from ``seed`` (drawn on the CPU) on the
        device, and its Adam."""
        net = create_discriminator(
            self.opt, torch.Generator().manual_seed(seed)).to(self.device)
        return GanState(net=net, optimizer=Adam(
            net.parameters(), lr=self.opt.gan_lr,
            betas=(self.opt.beta1, 0.999), eps=1e-8, device=self.device))

    def _img_grad_mag(self, img):
        """``--use_grad``'s D input: sqrt(dx^2 + dy^2 + 1e-12) of the
        forward differences."""
        dy, dx = image_gradients(img)
        return torch.sqrt(dx ** 2 + dy ** 2 + 1e-12)

    def seed_gan_renders(self, step: int):
        """Seed both render generators (``gan_gens``) alike from
        (--seed, ``step``, the update's global step): the two renders of
        the update draw the same numbers, as the JAX package renders
        twice with one key, and a resumed run and an eager chunk draw
        what the unbroken graphed run draws."""
        seed = (((self.opt.seed & 0x7FFFFFFF) << 32) | (step & 0xFFFFFFFF)) \
            ^ 0x5DEECE66D
        for g in self.gan_gens:
            g.manual_seed(seed)

    def _gan_update(self, state: TrainState, d_state: GanState, rays, real,
                    generator, step, eps=None):
        """The adversarial update over one patch (``rays`` in HR scan
        order, ``real`` (1, P, P, 3)) at ``step``: render the fake patch
        (no gradient), refresh D's spectral norm once, D's loss on fake
        and real (half their sum, plus under ``wgangp`` the gradient
        penalty on interpolates drawn from ``generator``) and D's Adam
        step; then render the patch again with the same draws under G's
        gradient and take ``--lambda_gan`` times D's verdict as G's loss,
        a full optimizer step. ``eps`` injects the penalty's draw.
        Returns (G_GAN, D_real, D_fake)."""
        opt = self.opt
        plen = opt.patch_len
        r1, r2 = self.gan_gens

        def render_patch(gen):
            out = self.render(state.params, rays,
                              randomized=bool(opt.randomized), step=step,
                              generator=gen)
            return out["fine_rgb"].reshape(1, plen, plen, 3)

        def d_in(x):
            return self._img_grad_mag(x) if opt.use_grad else x

        net = d_state.net
        with torch.no_grad():
            fake = render_patch(r1)
        net.refresh_stats()
        d_real = gan_loss(net(d_in(real)), True, opt.gan_mode)
        d_fake = gan_loss(net(d_in(fake)), False, opt.gan_mode)
        d_loss = 0.5 * (d_fake + d_real)
        if opt.gan_mode == "wgangp":
            if eps is None:
                eps = torch.rand((real.shape[0],) + (1,) * (real.ndim - 1),
                                 generator=generator, device=self.device)
            d_loss = d_loss + wgan_gradient_penalty(
                lambda x: net(d_in(x)), real, fake, eps)
        d_state.optimizer.zero_grad(set_to_none=True)
        d_loss.backward()
        d_state.optimizer.step()

        g_gan = gan_loss(net(d_in(render_patch(r2))), True, opt.gan_mode) \
            * opt.lambda_gan
        return self._update(state, g_gan, {"G_GAN": g_gan, "D_real": d_real,
                                           "D_fake": d_fake}, fill=True)

    def gan_step(self, state: TrainState, d_state: GanState, patch,
                 generator: Optional[torch.Generator] = None):
        """One adversarial update on a host patch (``gan_patch``'s: HR
        (P, P, C) ray fields and ``rgbs``); returns (state, d_state,
        losses)."""
        write_lr(state.optimizer, self.lr_fn, state.step)
        self.seed_gan_renders(state.step)
        p = {k: torch.as_tensor(np.asarray(v, np.float32)).to(self.device)
             for k, v in patch.items()}
        flat = {k: v.reshape(-1, v.shape[-1]) for k, v in p.items()}
        losses = self._gan_update(state, d_state, self._batch_to_rays(flat),
                                  p["rgbs"][None], generator, state.step)
        state.step += 1
        state.step_t.fill_(state.step)
        return state, d_state, losses

    # ------------------------------------------------------------------
    # chunks with the auxiliary updates inside
    # ------------------------------------------------------------------
    def _fires(self, it0: int, n_steps: int, freq: int):
        """The chunk's main-step indices i after which an update of
        cadence ``freq`` fires: global step ``it0 + i + 1`` a multiple."""
        return {i for i in range(n_steps) if (it0 + i + 1) % freq == 0}

    def train_steps_scan_gan(self, state: TrainState, d_state, buffer,
                             gan_bufs, n_steps: int, geom, it0: int,
                             generator: Optional[torch.Generator] = None,
                             with_reg: bool = False, gan: bool = True):
        """``n_steps`` buffer-sampled main steps with the adversarial
        update (``gan``) after each whose global step ``it0 + i + 1`` is a
        multiple of ``--gan_iter``, and with ``with_reg`` the TV update
        after each that is a multiple of ``--reg_patch_freq`` (GAN first,
        as the JAX package's ``train_steps_scan_gan`` folds them). On the
        card the main steps between firings are replays of the main
        step's graph and each update a replay of its own graph; the
        patches are made on the device. Every update advances the step
        count. Returns (state, d_state, losses): the last main step's and
        the most recent update's (zeros before the first)."""
        gan_at = self._fires(it0, n_steps, max(1, self.opt.gan_iter)) \
            if gan else set()
        reg_at = self._fires(it0, n_steps, max(1, self.opt.reg_patch_freq)) \
            if with_reg else set()
        zero = torch.zeros((), device=self.device)
        extra = {}
        if gan:
            extra.update({k: zero for k in GAN_LOSS_NAMES})
        if with_reg:
            extra["patch"] = zero
        cuts = sorted(gan_at | reg_at | {n_steps - 1})
        losses, done = {}, -1
        for cut in cuts:
            if cut > done:
                state, losses = self.train_steps_scan(state, buffer,
                                                      cut - done, generator)
                done = cut
            if cut in gan_at:
                extra.update(self._run_aux(
                    "gan", state, d_state, gan_bufs, geom, generator))
            if cut in reg_at:
                extra.update(self._run_aux(
                    "reg", state, d_state, gan_bufs, geom, generator))
        return state, d_state, {**losses, **extra}

    def train_steps_scan_reg(self, state: TrainState, buffer, gan_bufs,
                             n_steps: int, geom, it0: int,
                             generator: Optional[torch.Generator] = None):
        """The GAN-less sibling of ``train_steps_scan_gan``: main steps
        with the TV update at ``--reg_patch_freq``. Returns (state,
        losses)."""
        state, _, losses = self.train_steps_scan_gan(
            state, None, buffer, gan_bufs, n_steps, geom, it0, generator,
            with_reg=True, gan=False)
        return state, losses

    def _run_aux(self, kind, state: TrainState, d_state, gan_bufs, geom,
                 generator, draws=None):
        """One auxiliary update inside a chunk at the state's step: on the
        card a replay of the update's graph (captured at its first
        firing), else eagerly. ``draws`` (3,) injects the patch's view,
        row and column."""
        write_lr(state.optimizer, self.lr_fn, state.step)
        state.step_t.fill_(state.step)
        static = None if draws is None else \
            self._idx_buffer(f"{kind}_draws", draws.shape)
        if static is not None:
            static.copy_(draws)
        if kind == "gan":
            self.seed_gan_renders(state.step)

            def body():
                rays, real = self._gan_sample_patch(gan_bufs, geom,
                                                    generator, static)
                losses = self._gan_update(state, d_state, rays, real,
                                          generator, state.step_t)
                state.step_t.add_(1)
                return losses
            gens = (generator,) + self.gan_gens
            held = (list(d_state.net.parameters())
                    + list(d_state.net.buffers())
                    + d_state.optimizer.state_tensors())
        else:
            def body():
                rays = self._reg_sample_rays(gan_bufs, geom, generator,
                                             static)
                losses = self._update(state, *self._tv_of_render(
                    state.params, rays, self.opt.reg_patch_len * self.ds,
                    generator, state.step_t, grouped=False), fill=True)
                state.step_t.add_(1)
                return losses
            gens, held = generator, []
        losses = run_steps(
            self.graphs, (kind, static is None),
            lambda: (list(state.params.parameters())
                     + state.optimizer.state_tensors() + [state.step_t]
                     + list(gan_bufs.values()) + held
                     + ([] if static is None else [static])),
            body, 1, gens)
        state.step += 1
        return {k: v.clone() if self.graphs is not None else v
                for k, v in losses.items()}

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

    def render_eval(self, params, dataset, idx, sample=None):
        """Device raygen for grouped datasets (their ``eval_dirs`` are
        permuted to the grouped order, so the flat rows regroup), else
        their grouped host rays."""
        if getattr(dataset, "eval_raygen_spec", None) is None:
            return self.render_image(params, sample if sample is not None
                                     else dataset.image_rays(idx))
        flat_out = self.render_pose(params, dataset.eval_raygen_spec(idx),
                                    dataset.eval_dirs())
        return self._post_grouped(flat_out)

    def render_image(self, params, rays_np, chunk=None):
        """Render a whole view from its GROUPED rays (N_lr, ds^2, .):
        LR fields plus ``*_ori`` HR fields in scan order."""
        flat = {k: np.asarray(v).reshape((-1,) + np.asarray(v).shape[2:])
                for k, v in rays_np.items()
                if k in ("origins", "directions", "viewdirs", "near", "far")}
        return self._post_grouped(super().render_image(params, flat, chunk))

    def _metric_gt_pack(self, sample):
        """LR truth, and the HR truth ungrouped to scan order."""
        if sample.get("rgbs") is None:
            return None
        pack = {"gt_lr": np.asarray(sample["rgbs"], np.float32)}
        if "rgbs_ori" in sample:
            pack["gt_hr"] = np.asarray(
                self._ungroup(np.asarray(sample["rgbs_ori"])), np.float32)
        return pack

    def _metrics_device(self, flat_out, gt_pack):
        """Device twin of ``eval_metrics``: flat grouped-order HR rows ->
        LR (sub-pixel mean) PSNR, HR ``_ori`` PSNR and SSIM."""
        gt_lr = gt_pack["gt_lr"]
        n_lr = gt_lr.shape[0]
        ds2 = self.ds2
        lr, hr = {}, {}
        for k, v in flat_out.items():
            grouped = v[:n_lr * ds2].reshape((n_lr, ds2) + v.shape[1:])
            lr[k] = grouped.mean(dim=1)
            hr[k] = self._ungroup(grouped)
        m = {}
        if "coarse_rgb" in lr:
            m["coarse_psnr"] = psnr_fn(lr["coarse_rgb"], gt_lr)
        m["fine_psnr"] = psnr_fn(lr["fine_rgb"], gt_lr) \
            if "fine_rgb" in lr else m["coarse_psnr"]
        if "gt_hr" in gt_pack:
            gt_hr = gt_pack["gt_hr"]
            if "coarse_rgb" in hr:
                m["coarse_psnr_ori"] = psnr_fn(hr["coarse_rgb"], gt_hr)
            if "fine_rgb" in hr:
                m["fine_psnr_ori"] = psnr_fn(hr["fine_rgb"], gt_hr)
                w, h = self.opt.img_wh
                m["fine_ssim_ori"] = ssim_fn(hr["fine_rgb"].reshape(h, w, 3),
                                             gt_hr.reshape(h, w, 3))
        return m

    def eval_metrics(self, out, sample):
        gt = torch.from_numpy(np.asarray(sample["rgbs"], np.float32))
        m = {}
        if "coarse_rgb" in out:
            m["coarse_psnr"] = float(psnr_fn(_host(out["coarse_rgb"]), gt))
        m["fine_psnr"] = float(psnr_fn(_host(out["fine_rgb"]), gt)) \
            if "fine_rgb" in out else m["coarse_psnr"]
        if "rgbs_ori" in sample:
            hr = torch.from_numpy(np.asarray(
                self._ungroup(sample["rgbs_ori"]), np.float32))
            if "coarse_rgb_ori" in out:
                m["coarse_psnr_ori"] = float(psnr_fn(
                    _host(out["coarse_rgb_ori"]), hr))
            if "fine_rgb_ori" in out:
                fine = _host(out["fine_rgb_ori"])
                m["fine_psnr_ori"] = float(psnr_fn(fine, hr))
                w, h = self.opt.img_wh
                m["fine_ssim_ori"] = float(ssim_fn(fine.reshape(h, w, 3),
                                                   hr.reshape(h, w, 3)))
        return m

    def eval_visuals(self, out, sample, idx, with_gt, depth_bounds):
        """LR strips, HR ``-ori`` strips, and the depth matrices
        ``{i}-{level}-depth[-ori]`` (npz + colour-mapped PNG)."""
        w, h = self.opt.img_wh
        wl, hl = w // self.ds, h // self.ds
        near, far = depth_bounds
        vis = []
        for level in ("coarse", "fine"):
            if f"{level}_rgb" not in out:
                continue
            img = out[f"{level}_rgb"].reshape(hl, wl, 3)
            depth = depth2im(out[f"{level}_depth"].reshape(hl, wl), near,
                             far).astype(np.float32) / 255.0
            parts = [img]
            if with_gt and sample.get("rgbs") is not None:
                parts.append(sample["rgbs"].reshape(hl, wl, 3))
            parts.append(depth)
            vis.append(Visualizee("image", self._vis_strip(parts),
                                  name=f"{idx}-{level}", range=(0, 1)))
            # the HR strip: {i}-fine-ori.png feeds the refine stage
            img_o = out[f"{level}_rgb_ori"].reshape(h, w, 3)
            depth_o = depth2im(out[f"{level}_depth_ori"].reshape(h, w),
                               near, far).astype(np.float32) / 255.0
            parts = [img_o]
            if with_gt and sample.get("rgbs_ori") is not None:
                parts.append(self._ungroup(
                    sample["rgbs_ori"]).reshape(h, w, 3))
            parts.append(depth_o)
            vis.append(Visualizee("image", self._vis_strip(parts),
                                  name=f"{idx}-{level}-ori", range=(0, 1)))
            vis.append(Visualizee(
                "matrix", out[f"{level}_depth"].reshape(hl, wl),
                name=f"{idx}-{level}-depth", range=(near, far)))
            vis.append(Visualizee(
                "matrix", out[f"{level}_depth_ori"].reshape(h, w),
                name=f"{idx}-{level}-depth-ori", range=(near, far)))
        return vis

    def _ungroup(self, grouped, hw=None):
        """(N_lr, ds^2, ...) -> (H*W, ...) HR scan order
        ('(h1 w1)(s1 s2) c -> (h1 s1)(w1 s2) c'), of numpy arrays or
        tensors; ``hw`` overrides the image size as (w, h)."""
        w, h = hw if hw is not None else self.opt.img_wh
        ds = self.ds
        h1, w1 = h // ds, w // ds
        tail = grouped.shape[2:]
        x = grouped.reshape((h1, w1, ds, ds) + tail)
        order = (0, 2, 1, 3) + tuple(range(4, x.ndim))
        x = x.permute(order) if torch.is_tensor(x) else x.transpose(order)
        return x.reshape((h * w,) + tail)
