"""Training and eval engine of the port.

Port of ``nerfsr_tpu/engine.py`` (``setup``, ``train``, ``validate``,
``test``, ``_rays_per_batch``, ``_vis_dir``) on its plain-step route:
the training buffer is uploaded to the card once (and a warm-up split's,
such as the Blender ``train_crop``, for the first ``warmup_iters``
steps), and each epoch runs in chunks that end every ``--scan_steps``
steps of the epoch, at its end and at the end of the warm-up; their
losses are read back once per chunk and written every ``--log_every``
(else ``--print_freq``) steps with ``rays_per_sec``. As in the JAX
engine, a chunk is ``system.train_steps_scan`` (on the card one
CUDA-graph replay a step) when ``--scan_steps`` > 1 and the chunk draws
from the training buffer, and the eager ``system.train_steps`` with
``--scan_steps 1`` and during the warm-up. Before each chunk the
generator on the card is seeded from ``(--seed, step)``, so a resumed
run draws what an unbroken run draws (graphed or eager: the two draw and
compute the same), and the step counter is the saved
``TrainState.step``.
``validate`` takes PSNR/SSIM on the device where it can and decides per
view whether its render is read back quantized (uint8 rgb: PNG-only
views). ``test`` renders ``--test_split`` from a checkpoint into
``{results_dir}/{name}/{split}_{epoch}/``: ``{i}-fine[-ori].png`` strips,
``{i}-fine-depth[-ori].npz`` depth maps with their PNGs, and a GIF per
strip kind.

The refine stage: ``train_refine`` uploads the ``llff_refine``
dataset's augmented image stacks to the card once and runs chunks of
``RefineSystem.train_steps_scan`` (patches cut on the card; graphed on
the card whatever ``--scan_steps`` says, as the JAX refine engine scans
whenever its buffers are on the device) that end at the
``--log_every`` (else ``--print_freq``) and ``--val_freq`` cadences and
at the epoch's end, each seeded from ``(--seed, step)`` like the NeRF
chunks, so a ``--continue_train`` resume is the unbroken run bit for
bit; it validates one patch every ``--val_freq`` steps (writing its
strip every ``--vis_freq``), saves every ``--save_epoch_freq`` epochs and
validates every image every ``--val_epoch_freq``. ``test_refine`` tiles,
refines and stitches each image of ``--test_split`` from a checkpoint
into ``{results_dir}/{name}/{split}_{epoch}/{i}-sr-refine.png`` ([SR |
refined | truth]) and prints the mean SSIM/PSNR of input and output.

The auxiliary training paths dispatch as the JAX engine's do. Patch
mode (``--patch_size`` > 1 on a dataset with ``image_buffer``) runs
``train_steps_scan_patches`` chunks (``train_step_patches`` with
``--scan_steps 1``; the warm-up's steps stay flat); ``--with_ref`` (off
patch mode, unless ``--no_ref_loss``) runs ``train_steps_scan_with_ref``
(the ``--ref_freq`` gate inside the chunk; with ``--scan_steps 1`` or
in the warm-up a with-ref step where the epoch's iteration is a multiple
of ``--ref_freq``, else a plain one). ``--with_netD`` (after epoch
``--start_epoch``) and ``--reg_patch`` fire after the main steps whose
count is a multiple of ``--gan_iter`` and ``--reg_patch_freq``: inside a
plain chunk (``train_steps_scan_gan`` / ``_reg``, the patches made on the
card), or, where the chunk cannot hold them (patch mode, with_ref, the
warm-up, ``--scan_steps 1``), after a chunk cut to end at the firing,
from the host samplers (``gan_step`` / ``reg_patch_step``). Each update
is a full optimizer step, so ``TrainState.step`` counts them; the cadence
counts the main steps from the step the run started at, as the JAX
engine's ``global_step`` does. The discriminator is not checkpointed.

With ``--refine_as_gan`` the refine chunks are
``RefineSystem.train_steps_scan_gan`` (G and D updates with the device
fake pool); D starts from ``--seed`` and the pool empty, also on a
resume, as in the JAX engine, which saves neither.

Data parallelism (``nerfsr_torch/parallel/mesh.py``): with
``--num_processes`` (and ``--coordinator``, ``--process_id``) ``setup``
joins the process group and the rank runs on its card; with
``--mesh_devices`` N > 1 and no ``--num_processes`` each entry spawns N
ranks, one card each, and returns nothing. Every rank runs every chunk,
validation and render (the systems split the rows), reads a resume, and
takes rank 0's state; only the master writes checkpoints, metrics,
visuals and test artifacts (the others' metrics writer is a null sink).

The template system (``--model template``, both configs' default) has
a loop of its own (``_train_template``), as the JAX engine runs it: one
step at a time, no render, its validations raising where the JAX
engine's do.

Paths the port does not cover yet raise ``NotImplementedError`` naming
their ``ROADMAP.md`` item (``nerfsr_torch.models.UNPORTED``).
"""

from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np
import torch

from nerfsr_torch.data import create_dataset
from nerfsr_torch.models import create_model, refuse_unported
from nerfsr_torch.models.template_system import TemplateSystem
from nerfsr_torch.parallel import mesh
from nerfsr_torch.utils import checkpoint as ckpt
from nerfsr_torch.utils.visualizer import (MetricsWriter, NullMetricsWriter,
                                           Visualizee, save_visuals)


def _refuse_unported(opt):
    """Raise for what the port does not cover yet (ROADMAP.md queue 1 item
    6), and for a world the cards cannot hold."""
    refuse_unported(opt)
    mesh.check_world(opt)


def setup(opt):
    """Refuse what is not ported, join the process group when
    ``--num_processes`` asks for one (the rank's card becomes the device),
    seed, and build the system."""
    _refuse_unported(opt)
    device = opt.device
    if opt.num_processes:
        device = mesh.init_distributed(opt.coordinator, opt.num_processes,
                                       opt.process_id, opt.device)
        print(f"[setup] torch.distributed: rank {mesh.rank()} of "
              f"{mesh.world_size()} on {device}")
    np.random.seed(opt.seed)
    torch.manual_seed(opt.seed)
    return create_model(opt, device=device)


def _make_writer(opt):
    """The metrics sink: the master's file, a null sink on other ranks."""
    return MetricsWriter(opt.summary_dir, opt.name) if mesh.is_master() \
        else NullMetricsWriter()


def _broadcast_state(state):
    """Rank 0's parameters, statistics and Adam state on every rank."""
    if not mesh.active():
        return
    net = state.net if hasattr(state, "net") else state.params
    mesh.broadcast_state(list(net.parameters()) + list(net.buffers())
                         + state.optimizer.state_tensors())


def _deterministic_cudnn():
    """Deterministic cuDNN algorithms (no atomics in the convolutions'
    backward), so a resumed run is the unbroken run bit for bit and a
    graphed chunk the eager one."""
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False


def _seed_chunk(gen: torch.Generator, seed: int, step: int):
    """Seed the card's generator from (seed, step): every chunk's draws
    depend on where it starts, not on what ran before it."""
    gen.manual_seed(((seed & 0x7FFFFFFF) << 32) | (step & 0xFFFFFFFF))


def _read(losses) -> dict:
    """Every loss of a chunk to the host in one read."""
    vals = torch.stack([v.float() for v in losses.values()]).cpu().tolist()
    return dict(zip(losses, vals))


def _fmt(scal):
    return " ".join(f"{k}={v:.4g}" for k, v in scal.items())


def _chunk_steps(opt, step, it, steps_per_epoch, warmup_iters, aux=()):
    """Steps of the chunk that starts at global ``step``, ``it`` steps
    into its epoch: it ends at the next multiple of ``--scan_steps`` in
    the epoch, at the epoch's end, at ``warmup_iters`` while the
    warm-up lasts, and at the next multiple of each cadence in ``aux``
    (auxiliary updates that fire after the chunk). A function of the
    step alone, so a resumed run cuts (and seeds) the chunks an unbroken
    run cuts."""
    scan = max(1, opt.scan_steps)
    k = min(scan - it % scan, steps_per_epoch - it)
    if step < warmup_iters:
        k = min(k, warmup_iters - step)
    for f in aux:
        k = min(k, f - step % f)
    return k


def train(opt, warmup_mode: Optional[str] = None, warmup_iters: int = 1000,
          timings=None):
    """The training loop. ``warmup_mode`` (e.g. ``train_crop``, the
    Blender centre-crop warm-up) draws the first ``warmup_iters`` global
    steps from that split's buffer, uploaded once, instead of the train
    split's. ``timings``, when a dict, receives each epoch's host seconds
    over its steps (ending in the chunk's loss read, which waits for the
    card) under ``"epoch_s"`` and ``steps_per_epoch``. Returns the state
    (nothing when it spawned the ranks)."""
    if mesh.spawns(opt):
        return mesh.spawn(train, opt, warmup_mode, warmup_iters)
    system = setup(opt)
    if isinstance(system, TemplateSystem):
        return _train_template(opt, system)
    writer = _make_writer(opt)

    train_ds = create_dataset(opt, opt.train_split)
    buffer_np = train_ds.ray_buffer()
    n_rays = len(buffer_np["rgbs"])
    steps_per_epoch = _steps_per_epoch(opt, n_rays)
    print(f"[train] {n_rays} rays, {steps_per_epoch} steps/epoch, "
          f"{opt.n_epochs} epochs, device {system.device}")
    aux = _Aux(opt, system, train_ds)
    if aux.convolves() and system.device.type == "cuda":
        _deterministic_cudnn()
    buffer = _upload(train_ds.image_buffer() if aux.patch_mode
                     else buffer_np, system.device)
    if aux.ref_buffer is not None:
        print(f"[train] with_ref: {len(aux.ref_buffer['rgbs'])} ref rays")
    warm_buffer = None
    if warmup_mode is not None:
        warm_buffer = _upload(create_dataset(opt, warmup_mode).ray_buffer(),
                              system.device)
        print(f"[train] warm-up: the first {warmup_iters} steps draw from "
              f"{warmup_mode} ({len(warm_buffer['rgbs'])} rays)")

    val_ds = None
    try:
        val_ds = create_dataset(opt, opt.val_split)
    except (ValueError, KeyError, NotImplementedError, OSError) as e:
        print(f"[train] no val split: {e}")

    log_every = opt.log_every or opt.print_freq
    state = system.create_state(seed=opt.seed,
                                steps_per_epoch=steps_per_epoch)
    start_epoch = ckpt.resume_if_requested(opt, state)
    if start_epoch:
        print(f"[train] resumed from epoch {start_epoch} at step "
              f"{state.step}")
    ckpt.init_weights_from(opt, state)
    _broadcast_state(state)

    gen = torch.Generator(device=system.device)
    rays_per_batch = _rays_per_batch(opt, buffer_np)
    # the cadence counter: main steps, from the step the run started at
    step = state.step
    last_log_step, last_log_time = step, time.time()
    if timings is not None:
        timings.update(epoch_s={}, steps_per_epoch=steps_per_epoch)

    for epoch in range(start_epoch + 1, opt.n_epochs + 1):
        t_epoch = time.perf_counter()
        it = 0
        while it < steps_per_epoch:
            src = buffer
            if warm_buffer is not None:
                if step < warmup_iters:
                    src = warm_buffer
                else:
                    warm_buffer = None      # done: free its memory
            in_chunk = aux.in_chunk(src is buffer)
            k = _chunk_steps(opt, step, it, steps_per_epoch,
                             warmup_iters if warm_buffer is not None else 0,
                             () if in_chunk else aux.cadences(epoch))
            _seed_chunk(gen, opt.seed, state.step)
            state, losses = aux.chunk(state, src, src is buffer, k, it, step,
                                      epoch, gen)
            it += k
            step += k
            if not in_chunk:
                state, losses = aux.after_chunk(state, losses, step, epoch,
                                                gen)
            scal = _read(losses)
            if log_every > 0 and step % log_every < k:
                now = time.time()
                scal["rays_per_sec"] = ((step - last_log_step) * rays_per_batch
                                        / max(now - last_log_time, 1e-9))
                last_log_step, last_log_time = step, now
                writer.add_scalars(scal, step, prefix="train/")
                print(f"[e{epoch} s{step}] {_fmt(scal)}")
            if (val_ds is not None and opt.val_freq > 0
                    and step % opt.val_freq < k):
                _validate_iter(opt, system, state, val_ds, writer, epoch, k,
                               step)
        seconds = time.perf_counter() - t_epoch
        if timings is not None:
            timings["epoch_s"][epoch] = seconds
        print(f"[train] epoch {epoch} done in {seconds:.1f}s "
              f"({seconds / steps_per_epoch * 1e3:.2f} ms/step)")

        if ((opt.save_epoch_freq and epoch % opt.save_epoch_freq == 0)
                or epoch == opt.n_epochs) and mesh.is_master():
            print(f"[train] saved {ckpt.save_checkpoint(opt, state, epoch)}")

        if val_ds is not None and opt.val_epoch_freq and \
                (epoch % opt.val_epoch_freq == 0 or epoch == opt.n_epochs):
            metrics = validate(opt, system, state.params, val_ds,
                               out_dir=_vis_dir(opt, epoch, "val"))
            writer.add_scalars(metrics, state.step, prefix="val/")
            print(f"[val e{epoch}] {_fmt(metrics)}")

        if opt.vis_epoch_freq and epoch % opt.vis_epoch_freq == 0:
            vis_ds = create_dataset(opt, opt.val_epoch_split)
            metrics = validate(opt, system, state.params, vis_ds,
                               out_dir=_vis_dir(opt, epoch,
                                                opt.val_epoch_split),
                               max_images=4)
            writer.add_scalars(metrics, state.step,
                               prefix=f"{opt.val_epoch_split}/")
            print(f"[{opt.val_epoch_split} e{epoch}] {_fmt(metrics)}")

    writer.close()
    return state


def _steps_per_epoch(opt, n_rays: int) -> int:
    """``--steps_per_epoch``, else the buffer's rays over the batch (the
    last partial batch counted with ``--keep_last``), capped by
    ``--max_dataset_size``."""
    if opt.steps_per_epoch:
        steps = opt.steps_per_epoch
    elif opt.keep_last:
        steps = max(1, int(np.ceil(n_rays / opt.batch_size)))
    else:
        steps = max(1, n_rays // opt.batch_size)
    if np.isfinite(opt.max_dataset_size):
        steps = min(steps, max(1, int(opt.max_dataset_size)
                               // opt.batch_size))
    return steps


def _train_template(opt, system):
    """The template's loop, as the JAX engine runs that system: a step at
    a time from the uploaded pairs (its rows drawn from the card's
    generator seeded from (seed, step)), the losses written every
    ``--log_every`` (else ``--print_freq``) steps, a checkpoint every
    ``--save_epoch_freq`` epochs. The template renders nothing, so the
    validations reach no render: a ``--val_freq`` or ``--val_epoch_freq``
    validation raises ``AttributeError`` where the JAX engine's does (at
    the first of them, after that epoch's checkpoint), and the
    ``--vis_epoch_freq`` render is skipped with a message, as there."""
    writer = _make_writer(opt)
    train_ds = create_dataset(opt, opt.train_split)
    buffer = _upload(train_ds.ray_buffer(), system.device)
    steps_per_epoch = _steps_per_epoch(opt, len(train_ds))
    print(f"[train] template: {len(train_ds)} pairs, {steps_per_epoch} "
          f"steps/epoch, {opt.n_epochs} epochs, device {system.device}")
    val_ds = create_dataset(opt, opt.val_split)
    log_every = opt.log_every or opt.print_freq
    state = system.create_state(seed=opt.seed,
                                steps_per_epoch=steps_per_epoch)
    start_epoch = ckpt.resume_if_requested(opt, state)
    if start_epoch:
        print(f"[train] resumed from epoch {start_epoch} at step "
              f"{state.step}")
    ckpt.init_weights_from(opt, state)
    gen = torch.Generator(device=system.device)
    for epoch in range(start_epoch + 1, opt.n_epochs + 1):
        t_epoch = time.perf_counter()
        for _ in range(steps_per_epoch):
            _seed_chunk(gen, opt.seed, state.step)
            state, losses = system.train_step_from_buffer(state, buffer, gen)
            step = state.step
            if log_every > 0 and step % log_every == 0:
                scal = _read(losses)
                writer.add_scalars(scal, step, prefix="train/")
                print(f"[e{epoch} s{step}] {_fmt(scal)}")
            if opt.val_freq > 0 and step % opt.val_freq == 0:
                _validate_iter(opt, system, state, val_ds, writer, epoch, 1,
                               step)
        print(f"[train] epoch {epoch} done in "
              f"{time.perf_counter() - t_epoch:.1f}s")
        if ((opt.save_epoch_freq and epoch % opt.save_epoch_freq == 0)
                or epoch == opt.n_epochs) and mesh.is_master():
            print(f"[train] saved {ckpt.save_checkpoint(opt, state, epoch)}")
        if opt.val_epoch_freq and (epoch % opt.val_epoch_freq == 0
                                   or epoch == opt.n_epochs):
            validate(opt, system, state.params, val_ds,
                     out_dir=_vis_dir(opt, epoch, "val"))
        if opt.vis_epoch_freq and epoch % opt.vis_epoch_freq == 0:
            print(f"[train] vis_epoch render skipped: the template renders "
                  f"no {opt.val_epoch_split} view")
    writer.close()
    return state


class _Aux:
    """The training loop's dispatch between the main path and the
    auxiliary paths (patch mode, with_ref, the GAN and reg updates), as
    the JAX engine decides it from the flags, the dataset and the
    system."""

    def __init__(self, opt, system, train_ds):
        self.opt, self.system, self.ds = opt, system, train_ds
        self.patch_mode = (opt.patch_size > 1
                           and hasattr(train_ds, "image_buffer")
                           and hasattr(system, "train_step_patches"))
        self.ref_buffer = None
        if (opt.with_ref and not opt.no_ref_loss
                and hasattr(train_ds, "ref_buffer") and not self.patch_mode):
            self.ref_buffer = _upload(train_ds.ref_buffer(), system.device)
        self.ref_freq = max(1, opt.ref_freq)
        self.gan_state = None
        if (opt.with_netD and hasattr(system, "create_gan_state")
                and hasattr(train_ds, "gan_patch")):
            self.gan_state = system.create_gan_state(opt.seed + 1)
            print("[train] adversarial patch training enabled")
        self.reg = (opt.reg_patch and hasattr(system, "reg_patch_step")
                    and hasattr(train_ds, "patch_buffer"))
        self.gan_dev = self.geom = None
        if (self.gan_state is not None or self.reg) and \
                hasattr(train_ds, "gan_raygen_buffers"):
            bufs, self.geom = train_ds.gan_raygen_buffers()
            self.gan_dev = system.upload_gan_buffers(bufs)
        # the host samplers of firings outside a chunk
        self.rng = np.random.RandomState(opt.seed + 1)

    def convolves(self) -> bool:
        """Whether the path runs convolutions (the discriminator, VGG)."""
        opt = self.opt
        return self.gan_state is not None or (
            self.patch_mode and opt.patch_size >= 32
            and (opt.lambda_coarse_vgg > 0 or opt.lambda_fine_vgg > 0))

    def gan_active(self, epoch) -> bool:
        return self.gan_state is not None and epoch > self.opt.start_epoch

    def cadences(self, epoch):
        """The cadences of the updates that fire in this epoch."""
        out = [max(1, self.opt.gan_iter)] if self.gan_active(epoch) else []
        if self.reg:
            out.append(max(1, self.opt.reg_patch_freq))
        return out

    def in_chunk(self, main_buffer: bool) -> bool:
        """Whether the updates fire inside the chunk: a graphed plain
        chunk with the patches made on the device."""
        return (self.opt.scan_steps > 1 and main_buffer
                and not self.patch_mode and self.ref_buffer is None
                and self.gan_dev is not None)

    def chunk(self, state, src, main_buffer, k, it, step, epoch, gen):
        """``k`` main steps from ``src`` (the folded updates included)."""
        opt, system = self.opt, self.system
        graphed = opt.scan_steps > 1 and main_buffer
        if self.patch_mode and main_buffer:
            if graphed:
                return system.train_steps_scan_patches(
                    state, src, k, opt.patch_size, gen)
            for _ in range(k):
                state, losses = system.train_step_patches(state, src, gen)
            return state, losses
        if self.patch_mode or self.ref_buffer is None:
            if not graphed:
                return system.train_steps(state, src, k, gen)
            gan = self.gan_active(epoch) and self.gan_dev is not None
            if gan or (self.reg and self.gan_dev is not None):
                state, self.gan_state, losses = system.train_steps_scan_gan(
                    state, self.gan_state, src, self.gan_dev, k, self.geom,
                    step, gen, with_reg=self.reg, gan=gan)
                return state, losses
            return system.train_steps_scan(state, src, k, gen)
        if graphed:
            return system.train_steps_scan_with_ref(
                state, src, self.ref_buffer, k, self.ref_freq, it, gen)
        for j in range(k):
            if (it + j) % self.ref_freq == 0:
                state, losses = system.train_step_with_ref(
                    state, src, self.ref_buffer, gen)
            else:
                state, losses = system.train_step_from_buffer(state, src,
                                                              gen)
        return state, losses

    def after_chunk(self, state, losses, step, epoch, gen):
        """The updates due at main step ``step`` (a chunk's end), from the
        host samplers: the GAN's, then the TV update."""
        opt, system = self.opt, self.system
        if self.gan_active(epoch) and step % max(1, opt.gan_iter) == 0:
            state, self.gan_state, gan_losses = system.gan_step(
                state, self.gan_state, self.ds.gan_patch(self.rng), gen)
            losses = {**losses, **gan_losses}
        if self.reg and step % max(1, opt.reg_patch_freq) == 0:
            state, reg_losses = system.reg_patch_step(
                state, self.ds.patch_buffer(self.rng, 1)[0], gen)
            losses = {**losses, **reg_losses}
        return state, losses


def _upload(buffer_np, device):
    """A numpy ray buffer to ``device``, one copy per field."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in buffer_np.items()}


def _validate_iter(opt, system, state, val_ds, writer, epoch, k, step):
    """Mid-epoch validation of the first val view every ``--val_freq``
    steps: metrics on the device, or (every ``--vis_freq`` steps) a
    read-back render that also writes its strips."""
    need_vis = opt.vis_freq > 0 and step % opt.vis_freq < k
    m = None if need_vis else system.eval_metrics_fast(state.params,
                                                       val_ds, 0)
    if m is None:
        sample = val_ds.image_rays(0)
        out = system.render_eval(state.params, val_ds, 0, sample)
        with_gt = sample.get("rgbs") is not None
        m = system.eval_metrics(out, sample) if with_gt else {}
        if need_vis and mesh.is_master():
            save_visuals(system.eval_visuals(
                out, sample, f"s{step}", with_gt=with_gt,
                depth_bounds=val_ds.depth_bounds),
                _vis_dir(opt, epoch, "iter"))
    if m:
        writer.add_scalars(m, step, prefix="val_iter/")
        print(f"[val_iter s{step}] {_fmt(m)}")


def _rays_per_batch(opt, buffer_np):
    """HR rays a step evaluates (for rays/sec)."""
    r = buffer_np.get("origins")
    if r is not None and r.ndim == 3:  # grouped (N_lr, ds^2, 3)
        return opt.batch_size * r.shape[1]
    return opt.batch_size


def _vis_dir(opt, epoch, split):
    return os.path.join(opt.checkpoints_dir, opt.name,
                        f"{epoch}_{split}_vis")


def _renders_by_quantize(system, params, dataset, indices, quant):
    """(i, render) in ``indices``' order; consecutive views with the same
    quantize decision share one pipelined ``render_eval_many``."""
    run = []
    for i in list(indices) + [None]:
        if run and (i is None or quant[i] != quant[run[0]]):
            yield from zip(run, system.render_eval_many(
                params, dataset, run, quantize_rgb=quant[run[0]]))
            run = []
        if i is not None:
            run.append(i)


def _gif_visuals(gif_frames):
    return [Visualizee("gif", frames, name=level)
            for level, frames in gif_frames.items() if len(frames) > 1]


def validate(opt, system, params, dataset, out_dir=None, max_images=None):
    """Render every view (at most ``max_images``), average its metrics,
    and, with ``out_dir``, write the strips and a GIF per strip kind.

    Metrics come from the device path (``eval_metrics_fast``) where the
    view allows it, else from the read-back render. A view's render is
    read back quantized (uint8 rgb, PNG-identical) when it only feeds
    PNGs: its metrics came from the device, or it has no ground truth.
    Metrics never see quantized values."""
    n = len(dataset)
    if max_images:
        n = min(n, max_images)
    metrics = {}
    for i in range(n):
        m = system.eval_metrics_fast(params, dataset, i)
        if m is not None:
            metrics[i] = m
    todo = list(range(n)) if out_dir is not None else \
        [i for i in range(n) if i not in metrics]
    quant = {i: out_dir is not None and (
        i in metrics or dataset.image_rays(i).get("rgbs") is None)
        for i in todo}
    visuals, gif_frames = [], {}
    for i, out in _renders_by_quantize(system, params, dataset, todo,
                                       quant):
        sample = dataset.image_rays(i)
        if i not in metrics and sample.get("rgbs") is not None:
            metrics[i] = system.eval_metrics(out, sample)
        if out_dir is not None:
            for v in system.eval_visuals(out, sample, i, with_gt=True,
                                         depth_bounds=dataset.depth_bounds):
                visuals.append(v)
                if v.kind == "image":
                    gif_frames.setdefault(v.name.split("-", 1)[1],
                                          []).append(v.data)
    if out_dir is not None and visuals and mesh.is_master():
        save_visuals(visuals + _gif_visuals(gif_frames), out_dir)
    if not metrics:            # a split without ground truth
        return {}
    rows = [metrics[i] for i in sorted(metrics)]
    return {k: float(np.mean([m[k] for m in rows])) for k in rows[0]}


def test(opt, timings=None):
    """Render ``--test_split`` from checkpoint ``--load_epoch`` (its
    parameters) into ``{results_dir}/{name}/{split}_{epoch}/``; each
    view's strips and depth maps are written as it arrives, the GIFs at
    the end. Returns the directory. ``timings``, when a dict, receives
    the host seconds of the render-and-write loop (ending with the last
    GIF written), the part of them spent building and writing the
    artifacts, and the view count. Every rank renders; the master
    writes."""
    if mesh.spawns(opt):
        return mesh.spawn(test, opt)
    system = setup(opt)
    dataset = create_dataset(opt, opt.test_split)
    state = system.create_state(seed=0, steps_per_epoch=1)
    ckpt.load_checkpoint(opt, state, epoch=opt.load_epoch,
                         params_only=True)
    out_dir = os.path.join(opt.results_dir, opt.name,
                           f"{opt.test_split}_{opt.load_epoch}")
    t0 = time.perf_counter()
    gif_frames, n_written, write_s = {}, 0, 0.0
    # rgb comes back display-quantized (uint8); depth stays f32 for the
    # npz artifacts
    renders = system.render_eval_many(state.params, dataset,
                                      range(len(dataset)), quantize_rgb=True)
    for i, out in enumerate(renders):
        t_write = time.perf_counter()
        if not mesh.is_master():
            continue
        sample = dataset.image_rays(i)
        vis = system.eval_visuals(out, sample, i,
                                  with_gt=sample.get("rgbs") is not None,
                                  depth_bounds=dataset.depth_bounds)
        save_visuals(vis, out_dir)
        n_written += len(vis)
        for v in vis:
            if v.kind == "image":
                gif_frames.setdefault(v.name.split("-", 1)[1],
                                      []).append(v.data)
        write_s += time.perf_counter() - t_write
    t_write = time.perf_counter()
    gifs = _gif_visuals(gif_frames)
    if mesh.is_master():
        save_visuals(gifs, out_dir)
    if timings is not None:
        end = time.perf_counter()
        timings.update(seconds=end - t0, write_s=write_s + end - t_write,
                       views=len(dataset))
    print(f"[test] wrote {n_written + len(gifs)} artifacts to {out_dir}")
    return out_dir


# ---------------------------------------------------------------------------
# the refine stage
# ---------------------------------------------------------------------------

def _refine_strip(batch, pred):
    """[SR | refined | truth] of a val patch triple, in (-1, 1)."""
    return np.concatenate([batch["sr_patch"][0], pred[0],
                           batch["gt_patch"][0]], axis=1)


def train_refine(opt, timings=None):
    """The refine stage's training loop; ``timings``, when a dict,
    receives each epoch's host seconds under ``"epoch_s"`` (ending in the
    last chunk's loss read, which waits for the card) and
    ``steps_per_epoch``. Under a process group every rank runs the whole
    step (``RefineSystem``); the master validates and writes."""
    if mesh.spawns(opt):
        return mesh.spawn(train_refine, opt)
    system = setup(opt)
    if system.device.type == "cuda":
        _deterministic_cudnn()
    writer = _make_writer(opt)
    dataset = create_dataset(opt, "train")
    steps_per_epoch = opt.steps_per_epoch or max(
        1, len(dataset) // opt.batch_size)
    state = system.create_state(seed=opt.seed,
                                steps_per_epoch=steps_per_epoch)
    val_ds = None
    try:
        val_ds = create_dataset(opt, "val")
    except (ValueError, KeyError, OSError) as e:
        print(f"[refine] no val split: {e}")
    start_epoch = ckpt.resume_if_requested(opt, state)
    if start_epoch:
        print(f"[refine] resumed from epoch {start_epoch} at step "
              f"{state.step}")
    _broadcast_state(state)
    buffers = system.upload_buffers(dataset.device_buffers())
    d_state = pool = None
    if opt.refine_as_gan:
        # D from --seed and an empty pool, also on a resume: neither is
        # checkpointed, as in the JAX engine
        d_state, pool = system.create_gan_state(opt.seed), system.new_pool()
        print(f"[refine] --refine_as_gan: D at ndf {opt.ndf_dis}, a pool of "
              f"{pool['buf'].shape[0]} fakes on {system.device}")
    print(f"[refine] {len(dataset.sr_imgs)} augmented views "
          f"{opt.img_wh[0]}x{opt.img_wh[1]} on {system.device}, "
          f"{steps_per_epoch} steps/epoch, {opt.n_epochs} epochs")
    gen = torch.Generator(device=system.device)
    log_every = opt.log_every or opt.print_freq
    val_freq = opt.val_freq
    val_counter = 0
    if timings is not None:
        timings.update(epoch_s={}, steps_per_epoch=steps_per_epoch)

    for epoch in range(start_epoch + 1, opt.n_epochs + 1):
        t_epoch = time.perf_counter()
        left = steps_per_epoch
        while left > 0:
            # the chunk ends at the next log or val step, or the epoch's end
            k = min([left] + [f - state.step % f for f in
                              (log_every, val_freq) if f > 0])
            _seed_chunk(gen, opt.seed, state.step)
            if d_state is not None:
                state, d_state, pool, losses = system.train_steps_scan_gan(
                    state, d_state, pool, buffers, k, gen)
            else:
                state, losses = system.train_steps_scan(state, buffers, k,
                                                        gen)
            left -= k
            scal = _read(losses)
            step = state.step
            if log_every > 0 and step % log_every == 0:
                writer.add_scalars(scal, step, prefix="train/")
                print(f"[e{epoch} s{step}] {_fmt(scal)}")
            if (val_ds is not None and val_freq > 0 and step % val_freq == 0
                    and mesh.is_master()):
                batch = val_ds.sample_val_item(val_counter)
                val_counter += 1
                pred, m = system.validate_item(state, batch)
                writer.add_scalars(m, step, prefix="val_iter/")
                print(f"[val_iter s{step}] {_fmt(m)}")
                if opt.vis_freq > 0 and step % opt.vis_freq == 0:
                    save_visuals([Visualizee(
                        "image", _refine_strip(batch, pred),
                        name=f"s{step}-sr-refine-gt", range=(-1, 1))],
                        _vis_dir(opt, epoch, "iter"))
        seconds = time.perf_counter() - t_epoch
        if timings is not None:
            timings["epoch_s"][epoch] = seconds
        print(f"[refine] epoch {epoch} done in {seconds:.1f}s "
              f"({seconds / steps_per_epoch * 1e3:.2f} ms/step)")
        if ((opt.save_epoch_freq and epoch % opt.save_epoch_freq == 0)
                or epoch == opt.n_epochs) and mesh.is_master():
            print(f"[refine] saved {ckpt.save_checkpoint(opt, state, epoch)}")
        if val_ds is not None and opt.val_epoch_freq and mesh.is_master() \
                and (epoch % opt.val_epoch_freq == 0
                     or epoch == opt.n_epochs):
            metrics, visuals = [], []
            for i in range(max(1, val_ds.n_images())):
                batch = val_ds.sample_val_item(i)
                pred, m = system.validate_item(state, batch)
                metrics.append(m)
                visuals.append(Visualizee(
                    "image", _refine_strip(batch, pred),
                    name=f"{i}-sr-refine-gt", range=(-1, 1)))
            agg = {k: float(np.mean([m[k] for m in metrics]))
                   for k in metrics[0]}
            writer.add_scalars(agg, state.step, prefix="val/")
            save_visuals(visuals, _vis_dir(opt, epoch, "val"))
            print(f"[refine val e{epoch}] {_fmt(agg)}")
    writer.close()
    return state


def test_refine(opt, timings=None):
    """Refine and stitch every image of ``--test_split`` from checkpoint
    ``--load_epoch``; each ``{i}-sr-refine.png`` strip is written as its
    image is done. Returns the directory. ``timings``, when a dict,
    receives the host seconds of the loop, the part of them spent
    building and writing the strips, and the image count. Every rank
    refines; the master writes."""
    if mesh.spawns(opt):
        return mesh.spawn(test_refine, opt)
    system = setup(opt)
    dataset = create_dataset(opt, opt.test_split)
    state = system.create_state(seed=0, steps_per_epoch=1)
    ckpt.load_checkpoint(opt, state, epoch=opt.load_epoch,
                         params_only=True)
    out_dir = os.path.join(opt.results_dir, opt.name,
                           f"{opt.test_split}_{opt.load_epoch}")
    t0 = time.perf_counter()
    metrics, write_s = [], 0.0
    n = dataset.n_images()
    for i in range(n):
        refined, sr_img, gt_img = system.refine_image(
            state, dataset.tiles_for_image(i))
        t_write = time.perf_counter()
        parts = [sr_img, refined] + ([gt_img] if gt_img is not None else [])
        if mesh.is_master():
            save_visuals([Visualizee("image", np.concatenate(parts, axis=1),
                                     name=f"{i}-sr-refine", range=(-1, 1))],
                         out_dir)
        write_s += time.perf_counter() - t_write
        if gt_img is not None:
            metrics.append(system.eval_image_metrics(refined, sr_img,
                                                     gt_img))
    if timings is not None:
        timings.update(seconds=time.perf_counter() - t0, write_s=write_s,
                       images=n)
    if metrics:
        agg = {k: float(np.mean([m[k] for m in metrics]))
               for k in metrics[0]}
        print(f"[test_refine] {_fmt(agg)}")
    print(f"[test_refine] wrote {n} artifacts to {out_dir}")
    return out_dir
