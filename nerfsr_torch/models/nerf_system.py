"""The vanilla NeRF system.

Port of ``nerfsr_tpu/models/nerf_system.py``: construction from ``opt``,
``init_params`` from a seed, ``render``, the training step
(``create_state``, ``compute_losses``, ``train_step``,
``train_step_from_buffer``, ``train_steps``), the eval chunk size, and
the device-raygen eval render (``eval_image_device_pose`` /
``_render_dirs_chunks``, ``render_pose``, ``render_eval_many``). The port
is single-card: there is no mesh.

Parameters are an ``nn.ModuleDict`` of the networks (``prop``/``fine``
under fast sampling, else ``coarse``/``fine``) on the system's device;
``nerfsr_torch.weights.load_jax_params`` fills one from a JAX param tree.
A ``TrainState`` holds the step, the parameters and the Adam optimizer;
the step functions update it in place (no second copy of the parameters
and moments), where the JAX package returns a new state.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn

from nerfsr_torch.core.encoding import posenc_channels
from nerfsr_torch.core.rays import Rays, get_rays, make_rays, ndc_rays
from nerfsr_torch.device import resolve_device
from nerfsr_torch.models import register_model
from nerfsr_torch.models.criterions import interlevel_loss
from nerfsr_torch.models.criterions import psnr as psnr_fn
from nerfsr_torch.models.mlp import ProposalMLP, VanillaMLP
from nerfsr_torch.models.render import (RenderConfig, render_rays,
                                        render_rays_fast)
from nerfsr_torch.utils.schedule import make_lr_schedule


@dataclasses.dataclass
class TrainState:
    """The training state: the step count (host int), the networks and
    the optimizer over their parameters (which holds the Adam moments)."""

    step: int
    params: nn.ModuleDict
    optimizer: torch.optim.Optimizer


def _compute_dtype(precision: str):
    return torch.bfloat16 if precision in ("bf16", "mixed") \
        else torch.float32


@register_model("nerf")
class NeRFSystem:
    """Vanilla NeRF (experiment type 'nerf')."""

    # eval outputs read back to the host (opacity has no eval consumer)
    _EVAL_KEEP = ("coarse_rgb", "coarse_depth", "fine_rgb", "fine_depth")

    def __init__(self, opt, device=None):
        self.opt = opt
        self.device = resolve_device(device)
        if opt.mlp_network != "vanilla_mlp":
            raise NotImplementedError(
                f"--mlp_network {opt.mlp_network} is not ported yet")
        self.compute_dtype = _compute_dtype(opt.precision)
        cfg = RenderConfig(
            n_coarse=opt.N_coarse,
            n_importance=opt.N_importance,
            deg_pos=opt.deg_pos,
            deg_dir=opt.deg_dir,
            include_identity=not opt.no_xyz,
            log_scale=not opt.no_logscale,
            lindisp=opt.lindisp,
            white_bkgd=bool(opt.white_bkgd),
            noise_std=opt.noise_std,
            sigma_activation=opt.sigma_activation,
            use_dir=not opt.no_dir,
            gamma_correct=opt.gamma_correct,
            use_fused_mlp=self._fused_mlp_ok(opt),
            fused_dtype="f32" if opt.precision == "f32" else "bf16",
            fast_sampling=opt.fast_sampling,
            n_prop=opt.n_prop,
            deg_prop=opt.deg_prop,
            uniform_frac=opt.fast_uniform_frac,
            n_prop_levels=opt.n_prop_levels,
            n_prop2=opt.n_prop2,
            prop_pad=opt.prop_pad,
            prop_pad_anneal=opt.prop_pad_anneal,
            prop_pad_final=opt.prop_pad_final,
        )
        self._configured_prop_pad_anneal = cfg.prop_pad_anneal
        self._steps_per_epoch = max(1, opt.steps_per_epoch or 1)
        self.render_cfg = self._resolve_pad_anneal(cfg,
                                                   self._steps_per_epoch)
        self.lr_fn = None          # built in create_state
        self._eval_dirs_cache = {}

    @staticmethod
    def _fused_mlp_ok(opt):
        """Kernel C covers the reference default architecture only; any
        other takes the module path."""
        return (opt.D == 8 and opt.W == 256 and tuple(opt.skips) == (4,)
                and opt.deg_pos == 10 and opt.deg_dir == 4
                and not opt.no_dir and not opt.stop_grad
                and opt.dim_rgb == 3 and opt.color_activation == "sigmoid"
                and not opt.no_xyz and not opt.no_logscale
                and opt.mlp_network == "vanilla_mlp")

    def _resolve_pad_anneal(self, cfg: RenderConfig, steps_per_epoch: int):
        """``--prop_pad_anneal_frac`` -> ``prop_pad_anneal`` steps of the
        whole schedule (``steps_per_epoch * n_epochs``), as the JAX
        package's ``create_state`` resolves it; an explicit
        ``--prop_pad_anneal`` wins."""
        frac = self.opt.prop_pad_anneal_frac
        if frac > 0 and self._configured_prop_pad_anneal == 0:
            total = steps_per_epoch * max(1, self.opt.n_epochs)
            cfg = dataclasses.replace(
                cfg, prop_pad_anneal=max(1, int(frac * total)))
        return cfg

    # ------------------------------------------------------------------
    # parameters
    # ------------------------------------------------------------------
    def _vanilla_mlp(self):
        opt = self.opt
        return VanillaMLP(
            depth=opt.D, width=opt.W, skips=tuple(opt.skips),
            use_dir=not opt.no_dir, dim_rgb=opt.dim_rgb,
            color_activation=opt.color_activation,
            c_pos=posenc_channels(opt.dim_pos, opt.deg_pos, not opt.no_xyz),
            c_dir=posenc_channels(opt.dim_dir, opt.deg_dir, not opt.no_xyz),
            compute_dtype=self.compute_dtype)

    def init_params(self, seed: int = 0) -> nn.ModuleDict:
        """Fresh networks drawn from ``seed`` (prop+fine under fast
        sampling, else coarse+fine), on the system's device, eval mode."""
        opt = self.opt
        gen = torch.Generator().manual_seed(seed)
        if self.render_cfg.fast_sampling:
            nets = {
                "prop": ProposalMLP(
                    depth=opt.prop_D, width=opt.prop_W,
                    c_in=posenc_channels(opt.dim_pos,
                                         self.render_cfg.deg_prop,
                                         not opt.no_xyz),
                    compute_dtype=self.compute_dtype),
                "fine": self._vanilla_mlp(),
            }
        else:
            nets = {"coarse": self._vanilla_mlp()}
            if opt.N_importance > 0:
                nets["fine"] = self._vanilla_mlp()
        for net in nets.values():
            net.reset_parameters(opt.init_type, opt.init_gain, gen)
        return nn.ModuleDict(nets).to(self.device).eval()

    # ------------------------------------------------------------------
    # forward
    # ------------------------------------------------------------------
    def render(self, params, rays: Rays, randomized: bool, step=None,
               generator: Optional[torch.Generator] = None):
        if self.render_cfg.fast_sampling:
            return render_rays_fast(params, rays, self.render_cfg,
                                    randomized, step=step,
                                    generator=generator)
        return render_rays(params, rays, self.render_cfg, randomized,
                           generator=generator)

    # ------------------------------------------------------------------
    # training
    # ------------------------------------------------------------------
    def create_state(self, seed: int = 0,
                     steps_per_epoch: Optional[int] = None) -> TrainState:
        """Fresh networks from ``seed`` and their optimizer. A given
        ``steps_per_epoch`` re-resolves the pad anneal and the LR
        schedule; call it before the first step."""
        if steps_per_epoch:
            self._steps_per_epoch = max(1, steps_per_epoch)
            self.render_cfg = self._resolve_pad_anneal(
                self.render_cfg, self._steps_per_epoch)
        params = self.init_params(seed).train()
        return TrainState(step=0, params=params,
                          optimizer=self._make_tx(params))

    def _make_tx(self, params: nn.ModuleDict) -> torch.optim.Optimizer:
        """Adam (b1 ``--beta1``, b2 0.999, eps 1e-8: optax's
        ``scale_by_adam``) whose LR ``_apply_updates`` sets from the
        per-epoch schedule before each step. The optional clip runs on
        the gradients first (``_clip_grads``)."""
        self.lr_fn = make_lr_schedule(self.opt, self._steps_per_epoch)
        return torch.optim.Adam(params.parameters(), lr=self.lr_fn(0),
                                betas=(self.opt.beta1, 0.999), eps=1e-8)

    def _clip_grads(self, params: nn.ModuleDict):
        """``--grad_clip_val``: optax ``clip_by_global_norm`` (scale by
        max / norm when the global norm exceeds max) or ``clip`` (clamp
        each element). Stays on the device: no host sync."""
        val = self.opt.grad_clip_val
        if val <= 0:
            return
        grads = [p.grad for p in params.parameters() if p.grad is not None]
        if self.opt.grad_clip_type == "norm":
            norm = torch.linalg.vector_norm(
                torch.stack([torch.linalg.vector_norm(g) for g in grads]))
            scale = torch.where(norm < val, torch.ones_like(norm),
                                val / norm)
            for g in grads:
                g.mul_(scale)
        else:
            for g in grads:
                g.clamp_(-val, val)

    def _apply_updates(self, state: TrainState, loss: torch.Tensor):
        """Backward, clip, Adam at the schedule's LR for this step."""
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        self._clip_grads(state.params)
        lr = self.lr_fn(state.step)
        for group in state.optimizer.param_groups:
            group["lr"] = lr
        state.optimizer.step()
        state.step += 1

    def compute_losses(self, out: Dict[str, Any], batch: Dict[str, Any]):
        """MSE + PSNR losses (and the interlevel loss under fast
        sampling). Returns (total, {name: scalar tensor})."""
        opt = self.opt
        rgbs = batch["rgbs"]
        losses = {}
        loss_tot = 0.0
        if "coarse_rgb" in out:
            coarse_mse = torch.mean((out["coarse_rgb"] - rgbs) ** 2)
            losses["coarse_mse"] = coarse_mse
            loss_tot = loss_tot + coarse_mse * opt.lambda_coarse_mse
        if "fine_rgb" in out:
            fine_mse = torch.mean((out["fine_rgb"] - rgbs) ** 2)
            losses["fine_mse"] = fine_mse
            loss_tot = loss_tot + fine_mse * opt.lambda_fine_mse
        else:
            losses["fine_mse"] = torch.zeros((), device=rgbs.device)
        loss_tot = self._interlevel(out, losses, loss_tot)
        with torch.no_grad():
            if "coarse_rgb" in out:
                losses["coarse_psnr"] = psnr_fn(out["coarse_rgb"], rgbs)
            losses["fine_psnr"] = psnr_fn(out["fine_rgb"], rgbs) \
                if "fine_rgb" in out else torch.zeros((), device=rgbs.device)
        losses["tot"] = loss_tot
        return loss_tot, losses

    def _interlevel(self, out, losses, loss_tot):
        """Proposal-histogram bound loss (fast sampling only), over the
        last proposal round and every earlier one."""
        if "prop_weights" not in out:
            return loss_tot
        il = interlevel_loss(out["fine_z"], out["fine_weights"],
                             out["prop_z"], out["prop_weights"])
        lvl = 0
        while f"prop{lvl}_z" in out:
            il = il + interlevel_loss(
                out["fine_z"], out["fine_weights"],
                out[f"prop{lvl}_z"], out[f"prop{lvl}_weights"])
            lvl += 1
        losses["interlevel"] = il
        return loss_tot + il * self.opt.lambda_interlevel

    def _batch_to_rays(self, batch) -> Rays:
        return Rays(
            origins=batch["origins"],
            directions=batch["directions"],
            near=batch["near"],
            far=batch["far"],
            viewdirs=batch.get("viewdirs", batch["directions"]),
        )

    def _loss_fn(self, params, batch, generator=None, step=None):
        """Render + losses for one batch (overridden by subclasses)."""
        rays = self._batch_to_rays(batch)
        out = self.render(params, rays,
                          randomized=bool(self.opt.randomized), step=step,
                          generator=generator)
        return self.compute_losses(out, batch)

    def train_step(self, state: TrainState, batch: Dict[str, Any],
                   generator: Optional[torch.Generator] = None):
        """One optimization step over a ray batch; updates ``state`` in
        place and returns it with the step's losses (detached)."""
        loss, losses = self._loss_fn(state.params, batch, generator,
                                     state.step)
        self._apply_updates(state, loss)
        return state, {k: v.detach() for k, v in losses.items()}

    def sample_batch(self, buffer: Dict[str, torch.Tensor],
                     generator: Optional[torch.Generator] = None):
        """``batch_size`` rows of the device-resident buffer, the indices
        drawn on its device."""
        n_total = buffer["rgbs"].shape[0]
        dev = buffer["rgbs"].device
        idx = torch.randint(0, n_total, (self.opt.batch_size,),
                            generator=generator, device=dev)
        return {k: v[idx] for k, v in buffer.items()}

    def train_step_from_buffer(self, state: TrainState, buffer,
                               generator: Optional[torch.Generator] = None):
        """Sample a batch from the device-resident buffer and step: no
        host-to-device transfer per step."""
        return self.train_step(state, self.sample_batch(buffer, generator),
                               generator)

    def train_steps(self, state: TrainState, buffer, n_steps: int,
                    generator: Optional[torch.Generator] = None):
        """``n_steps`` buffer-sampled steps (the Python-loop counterpart
        of the JAX package's ``train_steps_scan``); returns the state and
        the last step's losses."""
        losses = {}
        for _ in range(n_steps):
            state, losses = self.train_step_from_buffer(state, buffer,
                                                        generator)
        return state, losses

    # ------------------------------------------------------------------
    # eval: device-side raygen
    # ------------------------------------------------------------------
    def _eval_chunk_size(self, n: int, override: Optional[int] = None):
        """The eval ray chunk: an explicit ``--ray_chunk`` or ``override``,
        else 4096; shrunk to one 256-aligned chunk when the image is
        smaller than the chunk."""
        if override is not None:
            chunk = override
        else:
            chunk = self.opt.ray_chunk
            if chunk > n:
                chunk = max(256, -(-n // 256) * 256)
        return chunk

    @torch.no_grad()
    def eval_image_device_pose(self, params, dirs_stacked, c2w_pair,
                               geom, quantize_rgb: bool = False):
        """Render a whole eval image on the device from camera geometry.

        dirs_stacked: (n_chunks, chunk, 3) camera-space directions;
        c2w_pair: (2, 3, 4), row 0 makes origins/directions, row 1 the
        viewdirs; geom: ("ndc", h, w, focal, near, far) or
        ("world", near, far). ``quantize_rgb`` returns rgb as uint8
        (``clip(v, 0, 1) * 255`` truncated, as the visualizer writes it).
        Returns {k: (n_chunks * chunk, ...)} device tensors."""
        out = self._render_dirs_chunks(params, dirs_stacked, c2w_pair,
                                       geom, self._EVAL_KEEP)
        if quantize_rgb:
            out = {k: ((torch.clamp(v.float(), 0.0, 1.0) * 255)
                       .to(torch.uint8) if k.endswith("_rgb") else v)
                   for k, v in out.items()}
        n = dirs_stacked.shape[0] * dirs_stacked.shape[1]
        return {k: v.reshape((n,) + v.shape[2:]) for k, v in out.items()}

    def _render_dirs_chunks(self, params, dirs_stacked, c2w_pair, geom,
                            keep):
        """Render each (chunk, 3) direction chunk of ``dirs_stacked``:
        rays from the pose (NDC with the near plane at 1.0 for forward-
        facing scenes, viewdirs from ``c2w_pair[1]`` through the same
        NDC). Returns {k: (n_chunks, chunk, ...)} for ``keep``."""
        parts = {}
        for d in dirs_stacked:
            ro, rd = get_rays(d, c2w_pair[0])
            vo, vd = get_rays(d, c2w_pair[1])
            if geom[0] == "ndc":
                _, h, w, focal, near, far = geom
                _, vd = ndc_rays(h, w, focal, 1.0, vo, vd)
                ro, rd = ndc_rays(h, w, focal, 1.0, ro, rd)
            else:
                _, near, far = geom
            rays = make_rays(ro, rd, near, far, vd)
            out = self.render(params, rays, randomized=False)
            for k in keep:
                if k in out:
                    parts.setdefault(k, []).append(out[k])
        return {k: torch.stack(v) for k, v in parts.items()}

    def _eval_dirs_device(self, dirs_flat: np.ndarray, n: int, chunk: int):
        """The padded direction grid as (n_chunks, chunk, 3) on the device,
        cached by shape; the host array is kept in the entry and compared
        by identity, and a new grid replaces the entry. Padding repeats
        the last direction."""
        key = (n, chunk)
        cached = self._eval_dirs_cache.get(key)
        if cached is not None and cached[0] is dirs_flat:
            return cached[1]
        pad = (-n) % chunk
        padded = np.concatenate(
            [dirs_flat, np.repeat(dirs_flat[-1:], pad, axis=0)]) \
            if pad else dirs_flat
        dev = torch.from_numpy(
            np.ascontiguousarray(padded.reshape(-1, chunk, 3))).to(
            self.device)
        self._eval_dirs_cache[key] = (dirs_flat, dev)
        return dev

    def _pose_pair(self, spec: Dict[str, Any]) -> torch.Tensor:
        c2w = np.asarray(spec["c2w"], np.float32)
        vd_c2w = np.asarray(spec.get("vd_c2w", spec["c2w"]), np.float32)
        return torch.from_numpy(np.stack([c2w, vd_c2w])).to(self.device)

    def render_pose(self, params, spec: Dict[str, Any], dirs_flat,
                    chunk: Optional[int] = None,
                    quantize_rgb: bool = False) -> Dict[str, np.ndarray]:
        """Render one pose (``spec`` from ``dataset.eval_raygen_spec``):
        the direction grid uploads once per dataset (cached), each image
        ships only its pose pair."""
        dirs_flat = np.asarray(dirs_flat, np.float32)
        n = dirs_flat.shape[0]
        chunk = self._eval_chunk_size(n, chunk)
        dev = self._eval_dirs_device(dirs_flat, n, chunk)
        out = self.eval_image_device_pose(
            params, dev, self._pose_pair(spec), spec["geom"], quantize_rgb)
        return self._finish_pose(out, n)

    def _finish_pose(self, out, n):
        """Read a pose render back to the host and drop the padding."""
        return {k: v.cpu().numpy()[:n] for k, v in out.items()}

    def _postprocess_eval(self, flat):
        """Hook for subclasses that reshape flat render rows."""
        return flat

    def render_eval_many(self, params, dataset, indices,
                         quantize_rgb: bool = False):
        """Multi-view eval: view i+1's render is enqueued before view i's
        outputs are read back. Yields what ``render_eval`` returns, in
        order. ``quantize_rgb`` returns rgb as uint8."""
        dirs_flat = np.asarray(dataset.eval_dirs(), np.float32)
        n = dirs_flat.shape[0]
        chunk = self._eval_chunk_size(n)
        dev_dirs = self._eval_dirs_device(dirs_flat, n, chunk)
        pending = None
        for i in indices:
            spec = dataset.eval_raygen_spec(i)
            out = self.eval_image_device_pose(
                params, dev_dirs, self._pose_pair(spec), spec["geom"],
                quantize_rgb)
            if pending is not None:
                yield self._postprocess_eval(self._finish_pose(pending, n))
            pending = out
        if pending is not None:
            yield self._postprocess_eval(self._finish_pose(pending, n))

    def render_eval(self, params, dataset, idx: int) -> Dict[str, np.ndarray]:
        """Eval render of view ``idx`` by device raygen (only a pose
        crosses to the card)."""
        return self.render_pose(params, dataset.eval_raygen_spec(idx),
                                dataset.eval_dirs())
