"""The vanilla NeRF system.

Port of ``nerfsr_tpu/models/nerf_system.py``: construction from ``opt``,
``init_params`` from a seed, ``render``, the training step
(``create_state``, ``compute_losses``, ``train_step``,
``train_step_from_buffer``, ``train_steps``), the eval chunk size, and
the device-raygen eval render (``eval_image_device_pose`` /
``_render_dirs_chunks``, ``render_pose``, ``render_eval_many``), the
host-rays render (``render_image``), and the engine's metrics and
visuals (``eval_metrics_fast``: PSNR and SSIM on the device, scalars
read back; ``eval_metrics``; ``eval_visuals``). Under a process group
(``nerfsr_torch/parallel/mesh.py``, the JAX package's shard points) the
main step and the with-ref step split the batch's rows over the ranks
and sum the gradients, the eval render splits each chunk's rays and
gathers them, and patch mode, the GAN and the TV updates run whole on
every rank: their losses (D's, the TV, the Laplacian, VGG) are not sums
over rows, and the replicated step is the exact counterpart of the JAX
package's global-semantics sharding, with no collective.

Parameters are an ``nn.ModuleDict`` of the networks (``prop``/``fine``
under fast sampling, else ``coarse``/``fine``) on the system's device;
``nerfsr_torch.weights.load_jax_params`` fills one from a JAX param tree.
A ``TrainState`` holds the step, the parameters and the Adam optimizer
(``utils/optim.py``: its update, learning rate and step counts on the
device); the step functions update it in place (no second copy of the
parameters and moments), where the JAX package returns a new state.

``train_steps_scan`` is the counterpart of the JAX package's one-program
``lax.scan`` chunk: on the card each step of the chunk is one replay of a
captured CUDA graph (``nerfsr_torch/graphs.py``) that samples the batch,
renders, takes the losses, backpropagates, clips, steps Adam and counts
the device step; on the CPU the same step body runs eagerly.
``train_steps`` is the eager loop.

The auxiliary training paths of the JAX package, each in a single-step
form and a chunk (graph replays on the card, as ``train_steps_scan``):
``--with_ref`` (``train_step_with_ref``, ``train_steps_scan_with_ref``:
a same-size batch of the reference view's HR rays rendered beside the
main batch and supervised at weight 1 / downscale^2, the ``--ref_freq``
gate a 0/1 weight inside the chunk) and patch mode (``--patch_size`` >
1: ``train_step_patches``, ``train_steps_scan_patches``: ``batch_size //
ps^2`` contiguous patches of an image-structured buffer, with the
edge-aware depth Laplacian and, from 32 px, the VGG perceptual loss).
Random draws (the batch, the reference rows, the patches' images, rows
and columns) can be injected.

On the card the eval render of one
image (``_render_dirs_chunks``, the JAX package's ``lax.map`` over the
ray chunks) is one replay too, for ``render_pose``, ``render_eval_many``
and ``eval_metrics_fast``.
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
from nerfsr_torch.graphs import GraphCache, run_steps
from nerfsr_torch.kernels import sampling as ksampling
from nerfsr_torch.models import register_model
from nerfsr_torch.models.criterions import interlevel_loss
from nerfsr_torch.models.criterions import psnr as psnr_fn
from nerfsr_torch.models.criterions import ssim as ssim_fn
from nerfsr_torch.models.mlp import NeuTexMLP, ProposalMLP, VanillaMLP
from nerfsr_torch.models.render import (RenderConfig, render_rays,
                                        render_rays_fast)
from nerfsr_torch.parallel import mesh
from nerfsr_torch.utils.checkpoint import frozen_paths
from nerfsr_torch.utils.optim import Adam
from nerfsr_torch.utils.schedule import (lr_writer, make_lr_schedule,
                                         write_lr)
from nerfsr_torch.utils.visualizer import Visualizee, _to_uint8, depth2im
from nerfsr_torch.weights import param_leaves


@dataclasses.dataclass
class TrainState:
    """The training state: the step count (host int), the networks, the
    optimizer over their parameters (which holds the Adam moments), and
    the step count on the device (an int64 0-d tensor), which the steps
    of a chunk read and advance where the host cannot. ``step`` counts
    every optimizer update (main steps and the auxiliary GAN and TV
    updates, as the JAX package's ``TrainState.step`` does): the learning
    rate's schedule reads it. ``train_steps_scan`` writes it into
    ``step_t`` before a chunk, and the two agree after every chunk."""

    step: int
    params: nn.ModuleDict
    optimizer: torch.optim.Optimizer
    step_t: Optional[torch.Tensor] = None


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
        if opt.mlp_network == "neutex_mlp" and opt.no_dir:
            # the JAX package fails at NeuTexMLP's first call instead
            raise ValueError("--mlp_network neutex_mlp conditions its colour "
                             "on the view direction: it cannot take "
                             "--no_dir")
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
        self._check_bins(cfg)
        self._configured_prop_pad_anneal = cfg.prop_pad_anneal
        self._steps_per_epoch = max(1, opt.steps_per_epoch or 1)
        self.render_cfg = self._resolve_pad_anneal(cfg,
                                                   self._steps_per_epoch)
        self.lr_fn = None          # built in create_state
        self._eval_dirs_cache = {}
        self._eval_gt_cache = {}
        self._eval_inputs = {}     # static inputs of the eval graphs
        self._static = {}          # static injected draws of the chunks
        self._vgg = None           # patch mode's VGG, loaded at first use
        # the CUDA graphs of the card's chunks (and eval images); None on
        # the CPU, or set to None to run the card's paths eagerly
        self.graphs = GraphCache(self.device) \
            if self.device.type == "cuda" else None

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

    def _check_bins(self, cfg: RenderConfig):
        """Kernel A takes at most ``MAX_BINS`` bins a ray: refuse a
        configuration that would give it more, here rather than at its
        first launch. Fast sampling resamples from the midpoints of
        ``--n_prop`` (and, with two rounds, ``--n_prop2``) samples; the
        parity path's resample does not run kernel A. The CPU's plain
        version takes any count."""
        if self.device.type != "cuda" or not cfg.fast_sampling:
            return
        flags = [("--n_prop", cfg.n_prop)]
        if cfg.n_prop_levels > 1:
            flags.append(("--n_prop2", cfg.n_prop2))
        for flag, n in flags:
            if n - 1 > ksampling.MAX_BINS:
                raise ValueError(
                    f"{flag} {n} gives the inverse-CDF kernel {n - 1} bins "
                    f"a ray; it takes at most {ksampling.MAX_BINS} (so "
                    f"{flag} <= {ksampling.MAX_BINS + 1})")

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
    def _main_mlp(self):
        """The big network of each level: ``--mlp_network`` vanilla_mlp or
        neutex_mlp (which takes the module path, not kernels C and E)."""
        opt = self.opt
        kw = dict(
            depth=opt.D, width=opt.W, skips=tuple(opt.skips),
            dim_rgb=opt.dim_rgb,
            color_activation=opt.color_activation,
            c_pos=posenc_channels(opt.dim_pos, opt.deg_pos, not opt.no_xyz),
            c_dir=posenc_channels(opt.dim_dir, opt.deg_dir, not opt.no_xyz),
            compute_dtype=self.compute_dtype)
        if opt.mlp_network == "neutex_mlp":
            return NeuTexMLP(**kw)
        return VanillaMLP(use_dir=not opt.no_dir, stop_grad=opt.stop_grad,
                          **kw)

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
                "fine": self._main_mlp(),
            }
        else:
            nets = {"coarse": self._main_mlp()}
            if opt.N_importance > 0:
                nets["fine"] = self._main_mlp()
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
                          optimizer=self._make_tx(params),
                          step_t=torch.zeros((), dtype=torch.int64,
                                             device=self.device))

    def _make_tx(self, params: nn.ModuleDict) -> torch.optim.Optimizer:
        """Adam (b1 ``--beta1``, b2 0.999, eps 1e-8: optax's
        ``scale_by_adam``) with its learning rate a tensor on the device,
        which ``write_lr`` sets from the per-epoch schedule before each
        step (or chunk). The optional clip runs on the gradients first
        (``_clip_grads``). ``--fix_layers`` leaves its leaves out of the
        optimizer: no update, no moments, and no part in the clip's
        global norm."""
        self.lr_fn = make_lr_schedule(self.opt, self._steps_per_epoch)
        frozen = frozen_paths(self.opt, params)
        trainable = [p for path, p, _ in param_leaves(params)
                     if path not in frozen]
        return Adam(trainable, lr=self.lr_fn(0),
                    betas=(self.opt.beta1, 0.999), eps=1e-8,
                    device=self.device)

    def _clip_grads(self, optimizer: torch.optim.Optimizer):
        """``--grad_clip_val``: optax ``clip_by_global_norm`` (scale by
        max / norm when the global norm of the optimizer's gradients
        exceeds max) or ``clip`` (clamp each element). Stays on the
        device: no host sync."""
        val = self.opt.grad_clip_val
        if val <= 0:
            return
        grads = [p.grad for group in optimizer.param_groups
                 for p in group["params"] if p.grad is not None]
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

    def _step(self, state: TrainState, batch, generator, step):
        """Render and losses at ``step`` (host int or device tensor),
        backward, clip, Adam at the learning rate already written; the
        body of ``train_step`` and of each step of ``train_steps_scan``.
        Under a process group the rank takes its share of the batch's rows
        and the gradients are summed over the ranks before the clip
        (``parallel/mesh.py``). Returns the step's losses (detached)."""
        with mesh.split_rows():
            return self._update(state, *self._loss_fn(
                state.params, mesh.rank_rows_tree(batch), generator, step))

    def compute_losses(self, out: Dict[str, Any], batch: Dict[str, Any]):
        """MSE + PSNR losses (and the interlevel loss under fast
        sampling). Returns (total, {name: scalar tensor})."""
        opt = self.opt
        rgbs = batch["rgbs"]
        losses = {}
        loss_tot = 0.0
        if "coarse_rgb" in out:
            coarse_mse = mesh.row_mean((out["coarse_rgb"] - rgbs) ** 2)
            losses["coarse_mse"] = coarse_mse
            loss_tot = loss_tot + coarse_mse * opt.lambda_coarse_mse
        if "fine_rgb" in out:
            fine_mse = mesh.row_mean((out["fine_rgb"] - rgbs) ** 2)
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
        """One optimization step over a ray batch at the schedule's LR for
        this step; updates ``state`` in place and returns it with the
        step's losses (detached)."""
        write_lr(state.optimizer, self.lr_fn, state.step)
        losses = self._step(state, batch, generator, state.step)
        state.step += 1
        return state, losses

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
        """``n_steps`` buffer-sampled steps, each launched from the host
        (the eager counterpart of ``train_steps_scan``, whose steps draw
        and compute the same); returns the state and the last step's
        losses."""
        losses = {}
        for _ in range(n_steps):
            state, losses = self.train_step_from_buffer(state, buffer,
                                                        generator)
        state.step_t.fill_(state.step)
        return state, losses

    def _update(self, state: TrainState, loss, losses, fill: bool = False):
        """Backward of ``loss``, the clip and Adam at the learning rate
        already written; returns the losses detached. ``fill`` (the
        auxiliary updates, whose renders reach only some networks, and
        whose loss may reach a discriminator's weights too) takes the
        gradient of the trained parameters alone and gives one that the
        loss does not reach a zero gradient, as JAX's gradient has one:
        Adam then still moves it by its moments, as optax does. Inside a
        split of the rows (``parallel/mesh.py``) the gradients and the
        losses are summed over the ranks first."""
        state.params.zero_grad(set_to_none=True)
        params = [p for group in state.optimizer.param_groups
                  for p in group["params"]]
        if fill:
            loss.backward(inputs=params)
            for p in params:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
        else:
            loss.backward()
        mesh.all_reduce_grads(params)
        self._clip_grads(state.optimizer)
        state.optimizer.step()
        return {k: v.detach() for k, v in mesh.reduce_losses(losses).items()}

    def _scan_step(self, state: TrainState, buffer, generator, idx):
        """One step of a chunk, as a graph captures it: the batch (drawn
        on the device, or the injected indices), ``_step`` at the device
        step, and the device step's increment."""
        if idx is None:
            batch = self.sample_batch(buffer, generator)
        else:
            batch = {k: v[idx] for k, v in buffer.items()}
        losses = self._step(state, batch, generator, state.step_t)
        state.step_t.add_(1)
        return losses

    def train_steps_scan(self, state: TrainState, buffer, n_steps: int,
                         generator: Optional[torch.Generator] = None,
                         idx: Optional[torch.Tensor] = None):
        """``n_steps`` buffer-sampled steps as the JAX package's
        ``train_steps_scan`` runs them: on the card one CUDA-graph replay
        a step (the step captured at the first chunk of a buffer and
        batch shape, after one eager step), with no host read or
        host-computed value inside a step; on the CPU the same step body,
        eagerly. ``idx`` (n_steps, batch_size) optionally injects each
        step's buffer rows in place of the generator's draws. The device
        step starts at ``state.step``; the learning rate is written before
        the chunk and again only where the chunk crosses an epoch's end.
        Returns the state and the last step's losses (on the card the
        graph's outputs, which its next replay rewrites: read them before
        the next chunk)."""
        if idx is not None and tuple(idx.shape) != (n_steps,
                                                     self.opt.batch_size):
            raise ValueError(f"idx {tuple(idx.shape)}, expected "
                             f"({n_steps}, {self.opt.batch_size})")
        state.step_t.fill_(state.step)
        write = lr_writer(state.optimizer, self.lr_fn, state.step)
        idx_buf = None if idx is None else \
            self._idx_buffer("idx", idx.shape[1:])

        def before(i):
            write(i)
            if idx_buf is not None:
                idx_buf.copy_(idx[i])

        losses = run_steps(
            self.graphs, ("train", idx is None),
            lambda: (list(state.params.parameters())
                     + state.optimizer.state_tensors() + [state.step_t]
                     + list(buffer.values())
                     + ([] if idx_buf is None else [idx_buf])),
            lambda: self._scan_step(state, buffer, generator, idx_buf),
            n_steps, generator, before)
        state.step += n_steps
        return state, losses

    def _idx_buffer(self, name, shape, dtype=torch.long):
        """A static device tensor of ``shape`` that a chunk's injected
        draws are copied into before each step (kept across chunks, so a
        captured graph reads the same one)."""
        buf = self._static.get(name)
        if buf is None or tuple(buf.shape) != tuple(shape):
            buf = self._static[name] = torch.empty(shape, dtype=dtype,
                                                   device=self.device)
        return buf

    # ------------------------------------------------------------------
    # --with_ref: the reference view's HR rays beside the main batch
    # ------------------------------------------------------------------
    def _ref_losses(self, params, ref_batch, generator=None, step=None):
        """The reference view's HR supervision: the mse of each level
        against its rays' colours, divided by downscale^2."""
        out = self.render(params, self._batch_to_rays(ref_batch),
                          randomized=bool(self.opt.randomized), step=step,
                          generator=generator)
        scale = 1.0 / (self.opt.downscale ** 2)
        losses, tot = {}, 0.0
        for level in ("coarse", "fine"):   # no coarse level when fast
            if f"{level}_rgb" in out:
                losses[f"ref_{level}_mse"] = mesh.row_mean(
                    (out[f"{level}_rgb"] - ref_batch["rgbs"]) ** 2) * scale
                tot = tot + losses[f"ref_{level}_mse"]
        return tot, losses

    def _with_ref_step(self, state: TrainState, buffer, ref_buffer,
                       generator, step, ref_w=None, idx=None, ref_idx=None):
        """One with-ref step at ``step``: a main batch and a same-size
        batch of reference rays (drawn, or the injected rows), both
        rendered, the reference losses (times the 0/1 tensor ``ref_w``
        when given) added to the total; backward, clip, Adam. Under a
        process group each rank takes its share of both batches' rows."""
        batch = self.sample_batch(buffer, generator) if idx is None \
            else {k: v[idx] for k, v in buffer.items()}
        if ref_idx is None:
            ref_idx = torch.randint(0, ref_buffer["rgbs"].shape[0],
                                    (self.opt.batch_size,),
                                    generator=generator, device=self.device)
        ref_batch = {k: v[ref_idx] for k, v in ref_buffer.items()}
        with mesh.split_rows():
            loss, losses = self._loss_fn(state.params,
                                         mesh.rank_rows_tree(batch),
                                         generator, step)
            ref_tot, ref_losses = self._ref_losses(
                state.params, mesh.rank_rows_tree(ref_batch), generator,
                step)
            if ref_w is not None:
                ref_losses = {k: v * ref_w for k, v in ref_losses.items()}
                ref_tot = ref_tot * ref_w
            losses.update(ref_losses)
            losses["tot"] = loss + ref_tot
            return self._update(state, losses["tot"], losses)

    def train_step_with_ref(self, state: TrainState, buffer, ref_buffer,
                            generator: Optional[torch.Generator] = None,
                            idx=None, ref_idx=None):
        """One with-ref step from the buffers at the schedule's learning
        rate; updates ``state`` in place and returns it with the losses."""
        write_lr(state.optimizer, self.lr_fn, state.step)
        losses = self._with_ref_step(state, buffer, ref_buffer, generator,
                                     state.step, idx=idx, ref_idx=ref_idx)
        state.step += 1
        state.step_t.fill_(state.step)
        return state, losses

    def train_steps_scan_with_ref(self, state: TrainState, buffer,
                                  ref_buffer, n_steps: int, ref_freq: int,
                                  it0: int,
                                  generator: Optional[torch.Generator] = None,
                                  idx=None, ref_idx=None):
        """``n_steps`` with-ref steps as the JAX package's
        ``train_steps_scan_with_ref`` runs them (on the card one graph
        replay a step). ``--ref_freq`` gates the reference losses by a
        0/1 weight, 1 where the step's within-epoch iteration ``it0 + i``
        is a multiple of ``ref_freq`` (the reference rays render on every
        step); with ``ref_freq`` 1 there is no weight. ``idx`` and
        ``ref_idx`` (n_steps, batch_size) inject each step's rows."""
        state.step_t.fill_(state.step)
        write = lr_writer(state.optimizer, self.lr_fn, state.step)
        ref_w = None if ref_freq == 1 else \
            self._idx_buffer("ref_w", (), torch.float32)
        rows = None if idx is None else \
            self._idx_buffer("idx", idx.shape[1:])
        ref_rows = None if ref_idx is None else \
            self._idx_buffer("ref_idx", ref_idx.shape[1:])

        def before(i):
            write(i)
            if ref_w is not None:
                ref_w.fill_(float((it0 + i) % ref_freq == 0))
            if rows is not None:
                rows.copy_(idx[i])
            if ref_rows is not None:
                ref_rows.copy_(ref_idx[i])

        def body():
            losses = self._with_ref_step(state, buffer, ref_buffer,
                                         generator, state.step_t, ref_w,
                                         rows, ref_rows)
            state.step_t.add_(1)
            return losses

        losses = run_steps(
            self.graphs, ("with_ref", ref_freq == 1, idx is None,
                          ref_idx is None),
            lambda: (list(state.params.parameters())
                     + state.optimizer.state_tensors() + [state.step_t]
                     + list(buffer.values()) + list(ref_buffer.values())
                     + [t for t in (ref_w, rows, ref_rows)
                        if t is not None]),
            body, n_steps, generator, before)
        state.step += n_steps
        return state, losses

    # ------------------------------------------------------------------
    # patch mode: contiguous patches, the depth Laplacian and VGG
    # ------------------------------------------------------------------
    def n_patches(self, ps: int) -> int:
        return max(1, self.opt.batch_size // (ps * ps))

    def sample_patches(self, img_buffer, ps: int, generator=None,
                       draws=None):
        """``n_patches(ps)`` ps x ps patches of the image-structured
        buffer (N_img, H, W, C), flat (n * ps * ps, C) per field. The
        patches' images, rows and columns are drawn on the buffer's device
        (rows in [0, H - ps], columns in [0, W - ps]) or injected as
        ``draws`` (3, n)."""
        n = self.n_patches(ps)
        n_img, h, w = img_buffer["rgbs"].shape[:3]
        dev = img_buffer["rgbs"].device
        if draws is None:
            img_idx = torch.randint(0, n_img, (n,), generator=generator,
                                    device=dev)
            rows = torch.randint(0, h - ps + 1, (n,), generator=generator,
                                 device=dev)
            cols = torch.randint(0, w - ps + 1, (n,), generator=generator,
                                 device=dev)
        else:
            img_idx, rows, cols = draws
        ar = torch.arange(ps, device=dev)
        r = (rows[:, None] + ar)[:, :, None]
        c = (cols[:, None] + ar)[:, None, :]
        i = img_idx[:, None, None]
        return {k: v[i, r, c].reshape(-1, v.shape[-1])
                for k, v in img_buffer.items()}

    def _get_vgg(self):
        if self._vgg is None:
            from nerfsr_torch.models.criterions import VGGPerceptualLoss
            self._vgg = VGGPerceptualLoss(self.opt.vgg_weights)
        return self._vgg

    def _patch_loss(self, params, flat, ps: int, generator=None, step=None):
        """The patch step's objective: the render's losses, the edge-aware
        depth Laplacian of each level (``--lambda_{coarse,fine}_depth_lap``,
        patches above 2 px; its depth cotangent reaches the composite's
        backward) and the VGG perceptual loss (``--lambda_{coarse,fine}
        _vgg``, patches of 32 px and more)."""
        from nerfsr_torch.models.criterions import bilateral_laplacian_loss
        opt = self.opt
        n = self.n_patches(ps)
        out = self.render(params, self._batch_to_rays(flat),
                          randomized=bool(opt.randomized), step=step,
                          generator=generator)
        loss, losses = self.compute_losses(out, flat)
        rgb_p = flat["rgbs"].reshape(n, ps, ps, 3)
        for level in ("coarse", "fine"):
            lam = getattr(opt, f"lambda_{level}_depth_lap")
            if lam > 0 and ps > 2 and f"{level}_depth" in out:
                lap = bilateral_laplacian_loss(
                    out[f"{level}_depth"].reshape(n, ps, ps), rgb_p,
                    opt.bilateral_gamma)
                losses[f"{level}_depth_lap"] = lap
                loss = loss + lap * lam
        if ps >= 32 and (opt.lambda_coarse_vgg > 0
                         or opt.lambda_fine_vgg > 0):
            vgg = self._get_vgg()
            for level in ("coarse", "fine"):
                lam = getattr(opt, f"lambda_{level}_vgg")
                if lam > 0 and f"{level}_rgb" in out:
                    pred = out[f"{level}_rgb"].reshape(n, ps, ps, 3) * 2 - 1
                    v = vgg(pred, rgb_p * 2 - 1) * lam
                    losses[f"{level}_vgg"] = v
                    loss = loss + v
        losses["tot"] = loss
        return loss, losses

    def train_step_patches(self, state: TrainState, img_buffer,
                           generator: Optional[torch.Generator] = None,
                           patch_size: int = 0, draws=None):
        """One patch-mode step (``--patch_size``, or ``patch_size``) at
        the schedule's learning rate; updates ``state`` in place and
        returns it with the losses."""
        ps = patch_size or self.opt.patch_size
        write_lr(state.optimizer, self.lr_fn, state.step)
        flat = self.sample_patches(img_buffer, ps, generator, draws)
        losses = self._update(state, *self._patch_loss(
            state.params, flat, ps, generator, state.step))
        state.step += 1
        state.step_t.fill_(state.step)
        return state, losses

    def train_steps_scan_patches(self, state: TrainState, img_buffer,
                                 n_steps: int, patch_size: int,
                                 generator: Optional[torch.Generator] = None,
                                 draws=None):
        """``n_steps`` patch-mode steps as the JAX package's
        ``train_steps_scan_patches`` runs them (on the card one graph
        replay a step: the patches cut on the device, the render, the
        patch losses, backward, clip, Adam). ``draws`` (n_steps, 3, n)
        injects each step's images, rows and columns."""
        ps = patch_size
        state.step_t.fill_(state.step)
        write = lr_writer(state.optimizer, self.lr_fn, state.step)
        static = None if draws is None else \
            self._idx_buffer("patch_draws", draws.shape[1:])

        def before(i):
            write(i)
            if static is not None:
                static.copy_(draws[i])

        def body():
            flat = self.sample_patches(img_buffer, ps, generator, static)
            losses = self._update(state, *self._patch_loss(
                state.params, flat, ps, generator, state.step_t))
            state.step_t.add_(1)
            return losses

        losses = run_steps(
            self.graphs, ("patches", ps, draws is None),
            lambda: (list(state.params.parameters())
                     + state.optimizer.state_tensors() + [state.step_t]
                     + list(img_buffer.values())
                     + ([] if static is None else [static])),
            body, n_steps, generator, before)
        state.step += n_steps
        return state, losses

    # ------------------------------------------------------------------
    # eval: device-side raygen
    # ------------------------------------------------------------------
    def _eval_chunk_size(self, n: int, override: Optional[int] = None):
        """The eval ray chunk: an explicit ``--ray_chunk`` or ``override``,
        else 4096; shrunk to one 256-aligned chunk when the image is
        smaller than the chunk; rounded up to a multiple of the ranks, whose
        shares of it they render (``parallel/mesh.py``)."""
        if override is not None:
            chunk = override
        else:
            chunk = self.opt.ray_chunk
            if chunk > n:
                chunk = max(256, -(-n // 256) * 256)
        w = mesh.world_size()
        return -(-chunk // w) * w

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
        """One eval image: ``_render_dirs_body`` over every chunk. On the
        card it is one replay of a graph captured per (chunks, chunk
        size, geometry, outputs), the JAX package's one ``lax.map``:
        the directions and the pose pair are copied into the graph's
        static inputs, the geometry's scalars are the key's, and the
        outputs are copied out of the graph's, so a view enqueued after
        this one leaves them be. Returns {k: (n_chunks, chunk, ...)}."""
        if self.graphs is None:
            return self._render_dirs_body(params, dirs_stacked, c2w_pair,
                                          geom, keep)
        key = ("eval", tuple(dirs_stacked.shape), tuple(geom), tuple(keep))
        static = self._eval_inputs.get(key)
        if static is None:
            static = self._eval_inputs[key] = (torch.empty_like(dirs_stacked),
                                               torch.empty_like(c2w_pair))

        def before(_):
            static[0].copy_(dirs_stacked)
            static[1].copy_(c2w_pair)

        out = self.graphs.run(
            key, lambda: list(params.parameters()) + list(static),
            lambda: self._render_dirs_body(params, static[0], static[1],
                                           geom, keep), before=before)
        return {k: v.clone() for k, v in out.items()}

    def _render_dirs_body(self, params, dirs_stacked, c2w_pair, geom, keep):
        """Render each (chunk, 3) direction chunk of ``dirs_stacked``:
        rays from the pose (NDC with the near plane at 1.0 for forward-
        facing scenes, viewdirs from ``c2w_pair[1]`` through the same
        NDC). Under a process group each rank renders its share of a
        chunk's rays and gathers the others' (``parallel/mesh.py``).
        Returns {k: (n_chunks, chunk, ...)} for ``keep``."""
        parts = {}
        with mesh.split_rows():
            for d in dirs_stacked:
                d = mesh.rank_rows(d)
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
                        parts.setdefault(k, []).append(
                            mesh.all_gather_rows(out[k]))
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
        if getattr(dataset, "eval_raygen_spec", None) is None:
            for i in indices:
                yield self.render_eval(params, dataset, i)
            return
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

    def render_eval(self, params, dataset, idx: int,
                    sample=None) -> Dict[str, np.ndarray]:
        """Eval render of view ``idx``: device raygen when the dataset
        gives ``eval_raygen_spec`` (only a pose crosses to the card), else
        its host rays (``sample`` or ``dataset.image_rays(idx)``)."""
        if getattr(dataset, "eval_raygen_spec", None) is not None:
            return self.render_pose(params, dataset.eval_raygen_spec(idx),
                                    dataset.eval_dirs())
        return self.render_image(params, sample if sample is not None
                                 else dataset.image_rays(idx))

    @torch.no_grad()
    def render_image(self, params, rays_np: Dict[str, np.ndarray],
                     chunk: Optional[int] = None) -> Dict[str, np.ndarray]:
        """Render host rays (N, .) chunk by chunk, the last chunk padded
        by repeating the last ray (each rank its share of a chunk under a
        process group); returns {k: (N, ...)} host arrays."""
        n = rays_np["origins"].shape[0]
        chunk = self._eval_chunk_size(n, chunk)
        pad = (-n) % chunk
        fields = {}
        for k in ("origins", "directions", "viewdirs", "near", "far"):
            if k in rays_np:
                v = np.asarray(rays_np[k], np.float32)
                if pad:
                    v = np.concatenate([v, np.repeat(v[-1:], pad, 0)])
                fields[k] = torch.from_numpy(v).to(self.device)
        parts = {}
        with mesh.split_rows():
            for s in range(0, n + pad, chunk):
                batch = mesh.rank_rows_tree(
                    {k: v[s:s + chunk] for k, v in fields.items()})
                out = self.render(params, self._batch_to_rays(batch),
                                  randomized=False)
                for k in self._EVAL_KEEP:
                    if k in out:
                        parts.setdefault(k, []).append(
                            mesh.all_gather_rows(out[k]))
        return {k: torch.cat(v).cpu().numpy()[:n] for k, v in parts.items()}

    # ------------------------------------------------------------------
    # eval metrics on the device: render + PSNR/SSIM, scalars read back
    # ------------------------------------------------------------------
    _METRIC_KEEP = ("coarse_rgb", "fine_rgb")

    def _metric_gt_pack(self, sample) -> Optional[Dict[str, np.ndarray]]:
        """Ground truth ``_metrics_device`` reads, as host arrays (uploaded
        once per (dataset, view)); None without ground truth."""
        if sample.get("rgbs") is None:
            return None
        return {"gt": np.asarray(sample["rgbs"], np.float32)}

    def _metrics_device(self, flat_out, gt_pack):
        """PSNR/SSIM of flat padded render rows on the device, key for key
        as ``eval_metrics``; 0-d tensors."""
        gt = gt_pack["gt"]
        n = gt.shape[0]
        m = {}
        if "coarse_rgb" in flat_out:
            m["coarse_psnr"] = psnr_fn(flat_out["coarse_rgb"][:n], gt)
        fine_key = "fine_rgb" if "fine_rgb" in flat_out else "coarse_rgb"
        m["fine_psnr"] = psnr_fn(flat_out[fine_key][:n], gt)
        w, h = self.opt.img_wh
        m["fine_ssim"] = ssim_fn(flat_out[fine_key][:n].reshape(h, w, 3),
                                 gt.reshape(h, w, 3))
        return m

    @torch.no_grad()
    def eval_metrics_fast(self, params, dataset, idx: int):
        """Metrics of view ``idx`` with device raygen and the reduction on
        the device: per view a pose goes up and a few scalars come back
        (one read). Ground truth uploads once per (dataset, view), checked
        against the dataset's cached direction grid as the grid cache is.
        Returns ``eval_metrics``' dict, or None when the dataset has no
        device raygen or the view no ground truth."""
        spec_fn = getattr(dataset, "eval_raygen_spec", None)
        if spec_fn is None:
            return None
        dirs_flat = np.asarray(dataset.eval_dirs(), np.float32)
        n = dirs_flat.shape[0]
        chunk = self._eval_chunk_size(n)
        dev = self._eval_dirs_device(dirs_flat, n, chunk)
        cached = self._eval_gt_cache.get((idx, n))
        if cached is not None and cached[0] is dirs_flat:
            gt_dev = cached[1]
        else:
            pack = self._metric_gt_pack(dataset.image_rays(idx))
            if pack is None:
                return None
            gt_dev = {k: torch.from_numpy(np.ascontiguousarray(v)).to(
                self.device) for k, v in pack.items()}
            self._eval_gt_cache[(idx, n)] = (dirs_flat, gt_dev)
        spec = spec_fn(idx)
        out = self._render_dirs_chunks(params, dev, self._pose_pair(spec),
                                       spec["geom"], self._METRIC_KEEP)
        flat = {k: v.reshape((-1,) + v.shape[2:]) for k, v in out.items()}
        m = self._metrics_device(flat, gt_dev)
        vals = torch.stack([v.float() for v in m.values()]).cpu().tolist()
        return dict(zip(m, vals))

    # ------------------------------------------------------------------
    # host metrics and visuals (the engine's loops)
    # ------------------------------------------------------------------
    def eval_metrics(self, out, sample):
        """PSNR and SSIM of one rendered image (host arrays) against its
        ground truth."""
        gt = torch.from_numpy(np.asarray(sample["rgbs"], np.float32))
        m = {}
        if "coarse_rgb" in out:
            m["coarse_psnr"] = float(psnr_fn(_host(out["coarse_rgb"]), gt))
        fine_key = "fine_rgb" if "fine_rgb" in out else "coarse_rgb"
        m["fine_psnr"] = float(psnr_fn(_host(out[fine_key]), gt))
        w, h = self.opt.img_wh
        m["fine_ssim"] = float(ssim_fn(_host(out[fine_key]).reshape(h, w, 3),
                                       gt.reshape(h, w, 3)))
        return m

    @staticmethod
    def _vis_strip(parts, rng=(0, 1)):
        """[pred | gt | depth] side by side. When the prediction arrived
        quantized (uint8), the other parts are quantized by the same
        conversion, so the strip's bytes are the float path's."""
        if any(np.asarray(p).dtype == np.uint8 for p in parts):
            parts = [_to_uint8(p, rng) for p in parts]
        return np.concatenate(parts, axis=1)

    def eval_visuals(self, out, sample, idx, with_gt, depth_bounds):
        """[pred | gt | depth] strips per level."""
        w, h = self.opt.img_wh
        near, far = depth_bounds
        vis = []
        for level in ("coarse", "fine"):
            if f"{level}_rgb" not in out:
                continue
            img = out[f"{level}_rgb"].reshape(h, w, 3)
            depth = depth2im(out[f"{level}_depth"].reshape(h, w), near,
                             far).astype(np.float32) / 255.0
            parts = [img]
            if with_gt and sample.get("rgbs") is not None:
                parts.append(sample["rgbs"].reshape(h, w, 3))
            parts.append(depth)
            vis.append(Visualizee("image", self._vis_strip(parts),
                                  name=f"{idx}-{level}", range=(0, 1)))
        return vis


def _host(x) -> torch.Tensor:
    """A host array as an f32 CPU tensor (uint8 rgb scaled to [0, 1])."""
    x = np.asarray(x)
    if x.dtype == np.uint8:
        return torch.from_numpy(x.astype(np.float32) / 255.0)
    return torch.from_numpy(np.ascontiguousarray(x, np.float32))
