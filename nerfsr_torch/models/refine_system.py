"""The patch-refinement system (``--model refine``).

Port of ``nerfsr_tpu/models/refine_system.py``: a CNN refines NeRF-SR's
synthesized patches with nearby patches of the reference view.
``--refine_network unetgenerator`` stacks the SR patch and the reference
patches on the channel axis (``_stack_unet_input``, the one packing
order); ``maxpoolingmodel`` takes them apart. The losses are the mse,
l1, gradient and VGG perceptual (``--vgg_weights``) terms of
``--refine_with_*`` with their lambdas, and each step reports the PSNR
of the input and of the refined patch.

A ``RefineState`` holds the step, the network (its parameters and batch
norm's running statistics) and the Adam optimizer (b1 ``--beta1``, b2
0.999, eps 1e-8, optax's ``scale_by_adam``) at the per-epoch schedule of
``utils/schedule.py`` (``utils/optim.py``: the update, the learning rate
and the step counts on the device); the step functions update it in
place. The image stacks live on the device (``upload_buffers``) and
each step cuts its patches there by index (``sample_patch_batch``), so
no step moves data between host and device. ``train_steps_scan`` is the
counterpart of the JAX package's ``train_steps_scan``: on the card each
step is one replay of a captured CUDA graph (``nerfsr_torch/graphs.py``:
the patch cut, the network's step with its batch statistics moving in
place, Adam), on the CPU the same step body eagerly; ``train_steps`` is
the eager loop. ``refine_image`` tiles an image, refines the
tiles eight at a time (the last batch padded) and stitches them by
``start_locs``.

``--refine_as_gan`` (the JAX package's ``create_gan_state``,
``gan_fakes``, ``gan_train_step``, ``_pool_query`` and
``train_steps_scan_gan``): pix2pix's lsgan update pair with the
spectral-norm ``NLayerDiscriminator`` on the patch alone (3 channels, the
reference's latent bug kept, as in JAX) at ``--ndf_dis``, its depth from
``--patch_len``, and its own Adam (``--gan_lr``, b1 ``--beta1``, b2 0.999,
eps 1e-8). D's spectral norm is refreshed once an update, then D takes
one step on half the sum of mean(D(fake)^2) and mean((D(gt) - 1)^2)
(lsgan whatever ``--gan_mode`` says); G's loss is mean((D'(G) - 1)^2) plus
``--lambda_L1`` times the L1 to the truth under D's updated weights, and
G's Adam steps at the refine schedule's rate; no ``--refine_with_*`` term
enters it. One training-mode forward of G serves the step: its detached
output feeds the fake pool and D, the output itself G's loss, so batch
norm's running values move once a step, as JAX keeps ``g_loss_fn``'s
statistics only. The fake pool is a device buffer (``new_pool``) that
``train_steps_scan_gan`` queries image by image inside each step (one
graph replay a step on the card); the host ``utils/image_pool.py`` serves
the single-step route (``gan_fakes``, then ``ImagePool.query``, then
``gan_train_step``). Neither D nor the pool is checkpointed, as in JAX.

Under a process group (``nerfsr_torch/parallel/mesh.py``) every rank runs
the refine steps whole on the same batch: the JAX package's sharding has
global semantics (its batch norm sees the whole batch), and the exact
torch counterpart is the replicated step, which needs no collective.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from nerfsr_torch.device import resolve_device
from nerfsr_torch import spans
from nerfsr_torch.graphs import GraphCache, run_steps
from nerfsr_torch.models import register_model
from nerfsr_torch.models.criterions import (VGGPerceptualLoss,
                                            gradient_loss)
from nerfsr_torch.models.criterions import l1 as l1_loss
from nerfsr_torch.models.criterions import psnr as psnr_fn
from nerfsr_torch.models.criterions import ssim as ssim_fn
from nerfsr_torch.models.networks import (GanState, MaxPoolingModel,
                                          UnetGenerator,
                                          create_discriminator)
from nerfsr_torch.utils.optim import Adam
from nerfsr_torch.utils.schedule import (lr_writer, make_lr_schedule,
                                         write_lr)

# the fake pool's size (the JAX engine's ImagePool and device pool)
POOL_SIZE = 50
GAN_LOSS_NAMES = ("G_GAN", "G_L1", "D_real", "D_fake")


@dataclasses.dataclass
class RefineState:
    """The training state: the step count (host int), the network and
    the optimizer over its parameters (which holds the Adam moments)."""

    step: int
    net: nn.Module
    optimizer: torch.optim.Optimizer


def _tensor(x, device):
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(device)


def _between(u, lo, hi):
    """``rng.randint(lo, max(lo + 1, hi))`` from uniforms ``u`` in [0, 1)
    (float64), elementwise over tensors."""
    n = torch.clamp_min(hi - lo, 1)
    return lo + torch.minimum((u * n).long(), n - 1)


def _cut(imgs, idx, ys, xs, plen):
    """(..., P, P, C) patches of ``imgs`` (A, H, W, C) — of image ``idx``
    at (``ys``, ``xs``), or of one image (H, W, C) when ``idx`` is None.
    Starts are clamped into the image, as ``lax.dynamic_slice`` clamps
    them."""
    h, w = imgs.shape[-3], imgs.shape[-2]
    ar = torch.arange(plen, device=imgs.device)
    rows = (torch.clamp(ys, 0, h - plen)[..., None] + ar)[..., :, None]
    cols = (torch.clamp(xs, 0, w - plen)[..., None] + ar)[..., None, :]
    if idx is None:
        return imgs[rows, cols]
    return imgs[idx[..., None, None], rows, cols]


@register_model("refine")
class RefineSystem:
    def __init__(self, opt, device=None):
        self.opt = opt
        self.device = resolve_device(device)
        if opt.refine_network not in ("unetgenerator", "maxpoolingmodel"):
            raise KeyError(f"unknown refine network {opt.refine_network}")
        self.is_unet = opt.refine_network == "unetgenerator"
        if self.is_unet:
            # --input_nc must describe the stacked sr + refs input
            expect = 3 * (1 + opt.num_ref_patches)
            if opt.input_nc not in (expect, 27):   # 27: the default
                raise ValueError(
                    f"--input_nc {opt.input_nc} != 3*(1+num_ref_patches) "
                    f"= {expect}; adjust --num_ref_patches instead")
        self._steps_per_epoch = 1
        self.lr_fn = None          # built in create_state
        self.vgg = VGGPerceptualLoss(opt.vgg_weights) \
            if opt.refine_with_vgg else None
        # the CUDA graphs of the card's chunks (and eval images); None on
        # the CPU, or set to None to run the card's paths eagerly
        self.graphs = GraphCache(self.device) \
            if self.device.type == "cuda" else None

    def build_net(self, seed: int = 0) -> nn.Module:
        """The network with fresh weights from ``seed`` (drawn on the CPU,
        so every device starts from the same ones), on the device."""
        opt = self.opt
        gen = torch.Generator().manual_seed(seed)
        if self.is_unet:
            net = UnetGenerator(
                input_nc=3 * (1 + opt.num_ref_patches),
                output_nc=opt.output_nc, ngf=opt.ngf,
                num_downs=opt.num_downs, norm=opt.norm,
                learn_residual=opt.learn_residual, generator=gen)
        else:
            net = MaxPoolingModel(use_ref=not opt.not_use_ref, generator=gen)
        return net.to(self.device)

    # ------------------------------------------------------------------
    @staticmethod
    def _stack_unet_input(sr, refs):
        """sr (N,P,P,3) + refs (N,K,P,P,3) -> the UNet input (N,P,P,3+3K):
        the SR patch's channels, then each reference patch's."""
        n, k, h, w, c = refs.shape
        return torch.cat([sr, refs.permute(0, 2, 3, 1, 4).reshape(
            n, h, w, k * c)], -1)

    def _apply(self, net, sr, refs, train: bool):
        """The network on NHWC patches, in training mode (batch
        statistics, which move the running ones) or in eval mode."""
        net.train(train)
        if self.is_unet:
            return net(self._stack_unet_input(sr, refs))
        return net(sr, refs)

    def create_state(self, seed: int = 0,
                     steps_per_epoch: Optional[int] = None) -> RefineState:
        """A fresh network from ``seed`` and its optimizer."""
        if steps_per_epoch:
            self._steps_per_epoch = max(1, steps_per_epoch)
        net = self.build_net(seed)
        self.lr_fn = make_lr_schedule(self.opt, self._steps_per_epoch)
        optimizer = Adam(net.parameters(), lr=self.lr_fn(0),
                         betas=(self.opt.beta1, 0.999), eps=1e-8,
                         device=self.device)
        return RefineState(step=0, net=net, optimizer=optimizer)

    # ------------------------------------------------------------------
    def compute_losses(self, pred, batch):
        """(total, {name: scalar tensor}) in the JAX package's order."""
        opt = self.opt
        gt = batch["gt_patch"]
        mse = torch.mean((pred - gt) ** 2)
        losses, tot = {}, 0.0
        if opt.refine_with_mse:
            mse = mse * opt.lambda_refine_mse
            tot = tot + mse
        losses["mse"] = mse
        if opt.refine_with_l1:
            losses["l1"] = l1_loss(pred, gt) * opt.lambda_refine_l1
            tot = tot + losses["l1"]
        if opt.refine_with_grad:
            losses["grad"] = gradient_loss(pred, gt) * opt.lambda_refine_grad
            tot = tot + losses["grad"]
        if self.vgg is not None:
            losses["vgg"] = self.vgg(pred, gt) * opt.lambda_refine_vgg
            tot = tot + losses["vgg"]
        if not isinstance(tot, torch.Tensor):   # no loss flag: no update
            tot = pred.sum() * 0.0
        losses["tot"] = tot
        with torch.no_grad():
            losses["psnr_input"] = psnr_fn(batch["sr_patch"], gt)
            losses["psnr_refine"] = psnr_fn(pred, gt)
        return losses["tot"], losses

    def train_step(self, state: RefineState, batch: Dict[str, torch.Tensor]):
        """One step on a patch batch (device tensors): training-mode
        forward (the running statistics move), losses, backward, Adam at
        the schedule's LR for this step. Updates ``state`` in place;
        returns it with the losses (detached)."""
        write_lr(state.optimizer, self.lr_fn, state.step)
        losses = self._step(state, batch)
        state.step += 1
        return state, losses

    def _step(self, state: RefineState, batch):
        """Forward, losses, backward and Adam at the learning rate already
        written: the body of ``train_step`` and of each step of
        ``train_steps_scan``. Returns the losses (detached)."""
        pred = self._apply(state.net, batch["sr_patch"],
                           batch["ref_patches"], train=True)
        loss, losses = self.compute_losses(pred, batch)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        state.optimizer.step()
        return {k: v.detach() for k, v in losses.items()}

    def upload_buffers(self, buffers) -> Dict[str, torch.Tensor]:
        """The dataset's ``device_buffers()`` on the device, once."""
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                for k, v in buffers.items()}

    def sample_patch_batch(self, buffers, generator=None):
        """``--batch_size`` patch triples cut on the device: an augmented
        view at random, an SR/GT patch inside its valid box, and
        ``--num_ref_patches`` patches of the unwarped reference view
        within ``--ref_offset`` of it (``--with_gt_patch`` plants the GT
        patch at a random one of them). The draws are uniforms on the
        buffers' device, so the step moves nothing from the host."""
        opt = self.opt
        plen, k, off = opt.patch_len, opt.num_ref_patches, opt.ref_offset
        b = opt.batch_size
        sr_imgs = buffers["sr_imgs"]
        n_aug = sr_imgs.shape[0]
        u = torch.rand((b, 4 + 2 * k), dtype=torch.float64,
                       generator=generator, device=sr_imgs.device)
        i = torch.clamp_max((u[:, 0] * n_aug).long(), n_aug - 1)
        x0, y0, x1, y1 = buffers["bboxes"].long()[i].unbind(1)
        xs = _between(u[:, 1], x0, x1 - plen)
        ys = _between(u[:, 2], y0, y1 - plen)
        sr = _cut(sr_imgs, i, ys, xs, plen)
        gt = _cut(buffers["gt_imgs"], i, ys, xs, plen)
        rxl = torch.maximum(x0, xs - off)[:, None]
        rxh = torch.minimum(x1 - plen, xs + off)[:, None]
        ryl = torch.maximum(y0, ys - off)[:, None]
        ryh = torch.minimum(y1 - plen, ys + off)[:, None]
        rx = _between(u[:, 4:4 + k], rxl, rxh)
        ry = _between(u[:, 4 + k:], ryl, ryh)
        refs = _cut(buffers["gt_img"], None, ry, rx, plen)
        if opt.with_gt_patch:
            j = torch.clamp_max((u[:, 3] * k).long(), k - 1)
            plant = torch.arange(k, device=j.device)[None] == j[:, None]
            refs = torch.where(plant[:, :, None, None, None], gt[:, None],
                               refs)
        return {"sr_patch": sr, "ref_patches": refs, "gt_patch": gt}

    def train_steps(self, state: RefineState, buffers, n_steps: int,
                    generator: Optional[torch.Generator] = None):
        """``n_steps`` steps on device-cut patch batches, each launched
        from the host (the eager counterpart of ``train_steps_scan``);
        returns the state and the last step's losses (device tensors: the
        caller reads them once)."""
        losses = {}
        for _ in range(n_steps):
            batch = self.sample_patch_batch(buffers, generator)
            state, losses = self.train_step(state, batch)
        return state, losses

    @spans.spanned("nerfsr.train.chunk")
    def train_steps_scan(self, state: RefineState, buffers, n_steps: int,
                         generator: Optional[torch.Generator] = None):
        """``n_steps`` steps as the JAX package's ``train_steps_scan`` runs
        them: on the card one CUDA-graph replay a step (captured at the
        first chunk of these buffers, after one eager step: the patch
        cut, the step, Adam), on the CPU the same body eagerly. The
        learning rate is written before the chunk and again only where the
        chunk crosses an epoch's end. Returns the state and the last
        step's losses (on the card the graph's outputs, which its next
        replay rewrites: read them before the next chunk)."""
        losses = run_steps(
            self.graphs, ("train",),
            lambda: (list(state.net.parameters()) + list(state.net.buffers())
                     + state.optimizer.state_tensors()
                     + list(buffers.values())),
            lambda: self._step(state, self.sample_patch_batch(buffers,
                                                              generator)),
            n_steps, generator,
            lr_writer(state.optimizer, self.lr_fn, state.step))
        state.step += n_steps
        return state, losses

    # ------------------------------------------------------------------
    # --refine_as_gan
    # ------------------------------------------------------------------
    def create_gan_state(self, seed: int = 0) -> GanState:
        """A fresh discriminator from ``seed`` (drawn on the CPU) on the
        device, seeing the patch alone (3 channels), and its Adam."""
        net = create_discriminator(
            self.opt, torch.Generator().manual_seed(seed)).to(self.device)
        return GanState(net=net, optimizer=Adam(
            net.parameters(), lr=self.opt.gan_lr,
            betas=(self.opt.beta1, 0.999), eps=1e-8, device=self.device))

    def new_pool(self, size: int = POOL_SIZE) -> Dict[str, torch.Tensor]:
        """An empty device fake pool: ``buf`` (size, P, P, 3) and the 0-d
        count ``n`` of the images it holds."""
        plen = self.opt.patch_len
        return {"buf": torch.zeros((size, plen, plen, 3),
                                   device=self.device),
                "n": torch.zeros((), dtype=torch.long, device=self.device)}

    @torch.no_grad()
    def gan_fakes(self, state: RefineState, batch) -> torch.Tensor:
        """G's training-mode output on ``batch`` (no gradient) for the host
        pool's query; the running statistics are left as they were (the
        step's own forward moves them)."""
        stats = [t.clone() for t in state.net.buffers()]
        fakes = self._apply(state.net, batch["sr_patch"],
                            batch["ref_patches"], train=True)
        for t, v in zip(state.net.buffers(), stats):
            t.copy_(v)
        return fakes

    def _pool_query(self, pool, imgs, u=None, ridx=None, generator=None):
        """The device fake pool queried with ``imgs`` (N, P, P, 3), one
        image after another as the host pool does: while it has a free
        slot the image is stored and passes through; once full, where the
        uniform ``u`` is above 1/2 the image swaps with the buffered one
        at ``ridx`` (D sees that one), else it passes through. ``u`` (N,)
        and ``ridx`` (N,) are drawn from ``generator`` unless given.
        Updates ``pool`` in place; returns D's fake batch."""
        buf, n = pool["buf"], pool["n"]
        size = buf.shape[0]
        if u is None:
            u = torch.rand(imgs.shape[0], generator=generator,
                           device=imgs.device)
        if ridx is None:
            ridx = torch.randint(0, size, (imgs.shape[0],),
                                 generator=generator, device=imgs.device)
        outs = []
        for i in range(imgs.shape[0]):
            img = imgs[i]
            not_full = n < size
            swap = u[i] > 0.5
            idx = torch.where(not_full, n, ridx[i]).reshape(1)
            old = torch.index_select(buf, 0, idx)[0]
            outs.append(torch.where(not_full | ~swap, img, old))
            buf.index_copy_(0, idx, torch.where(not_full | swap, img,
                                                old)[None])
            n.add_(not_full.long())
        return torch.stack(outs)

    def _gan_step(self, state: RefineState, d_state: GanState, batch,
                  pool=None, pool_fakes=None, generator=None):
        """One G + D update pair at the learning rate already written:
        G's one training-mode forward; D's fake batch (the device pool's
        answer to G's detached output, or ``pool_fakes``, or that output
        itself); D's spectral norm refreshed, D's lsgan loss and Adam
        step; then G's loss under D's updated weights and G's Adam step.
        Returns the losses (detached) and G's detached output."""
        opt = self.opt
        gt = batch["gt_patch"]
        pred = self._apply(state.net, batch["sr_patch"],
                           batch["ref_patches"], train=True)
        fake = fake_in = pred.detach()
        if pool is not None:
            fake_in = self._pool_query(pool, fake, generator=generator)
        elif pool_fakes is not None:
            fake_in = pool_fakes
        net = d_state.net
        net.refresh_stats()
        d_fake = torch.mean(net(fake_in) ** 2)
        d_real = torch.mean((net(gt) - 1.0) ** 2)
        d_state.optimizer.zero_grad(set_to_none=True)
        (0.5 * (d_fake + d_real)).backward()
        d_state.optimizer.step()

        g_gan = torch.mean((net(pred) - 1.0) ** 2)
        g_l1 = l1_loss(pred, gt) * opt.lambda_L1
        state.optimizer.zero_grad(set_to_none=True)
        (g_gan + g_l1).backward(inputs=list(state.net.parameters()))
        state.optimizer.step()
        return {k: v.detach() for k, v in zip(
            GAN_LOSS_NAMES, (g_gan, g_l1, d_real, d_fake))}, fake

    def gan_train_step(self, state: RefineState, d_state: GanState, batch,
                       pool_fakes=None):
        """One update pair on a patch batch (device tensors); D trains on
        ``pool_fakes`` (the host pool's answer to ``gan_fakes``) when
        given, else on G's detached output. Updates both states in place;
        returns (state, d_state, losses, G's detached output)."""
        write_lr(state.optimizer, self.lr_fn, state.step)
        losses, fake = self._gan_step(state, d_state, batch,
                                      pool_fakes=pool_fakes)
        state.step += 1
        return state, d_state, losses, fake

    @spans.spanned("nerfsr.train.chunk")
    def train_steps_scan_gan(self, state: RefineState, d_state: GanState,
                             pool, buffers, n_steps: int,
                             generator: Optional[torch.Generator] = None):
        """``n_steps`` update pairs as the JAX package's
        ``train_steps_scan_gan`` runs them: on the card one CUDA-graph
        replay a step (the patch cut, G's forward, the pool's query, D's
        update, G's update, both Adams on the device), on the CPU the same
        body eagerly, or with ``graphs`` None on the card. ``pool``
        (``new_pool``) carries over between chunks. Returns (state,
        d_state, pool, the last step's losses)."""
        losses = run_steps(
            self.graphs, ("gan",),
            lambda: (list(state.net.parameters()) + list(state.net.buffers())
                     + state.optimizer.state_tensors()
                     + list(d_state.net.parameters())
                     + list(d_state.net.buffers())
                     + d_state.optimizer.state_tensors()
                     + list(pool.values()) + list(buffers.values())),
            lambda: self._gan_step(
                state, d_state, self.sample_patch_batch(buffers, generator),
                pool=pool, generator=generator)[0],
            n_steps, generator,
            lr_writer(state.optimizer, self.lr_fn, state.step))
        state.step += n_steps
        return state, d_state, pool, losses

    # ------------------------------------------------------------------
    @torch.no_grad()
    def predict(self, state: RefineState, sr, refs) -> torch.Tensor:
        """Eval-mode refinement of a patch batch (host or device arrays)
        on the device."""
        return self._apply(state.net, _tensor(sr, self.device),
                           _tensor(refs, self.device), train=False)

    def validate_item(self, state: RefineState, batch):
        """Refine one val patch triple and score it: mse on (-1, 1), PSNR
        of the input and of the refined patch on (0, 1). Returns (pred,
        metrics)."""
        pred = self.predict(state, batch["sr_patch"],
                            batch["ref_patches"]).cpu()
        gt = torch.from_numpy(batch["gt_patch"])
        sr = torch.from_numpy(batch["sr_patch"])
        metrics = {
            "mse": float(torch.mean((pred - gt) ** 2)),
            "psnr_input": float(psnr_fn((sr + 1) / 2, (gt + 1) / 2)),
            "psnr_refine": float(psnr_fn((pred + 1) / 2, (gt + 1) / 2)),
        }
        return pred.numpy(), metrics

    def refine_image(self, state: RefineState, tiles, batch: int = 8):
        """Refine every tile of one image, ``batch`` at a time (the last
        batch padded with its last tile), and stitch by ``start_locs``.
        Returns (refined, sr, gt or None), (H, W, 3) in (-1, 1)."""
        w, h = [int(x) for x in tiles["wh"]]
        plen = int(tiles["patch_len"])
        n = tiles["sr_patch"].shape[0]
        preds = []
        for s in range(0, n, batch):
            e = min(s + batch, n)
            sr = tiles["sr_patch"][s:e]
            refs = tiles["ref_patches"][s:e]
            pad = batch - (e - s)
            if pad:
                sr = np.concatenate([sr, np.repeat(sr[-1:], pad, 0)])
                refs = np.concatenate([refs, np.repeat(refs[-1:], pad, 0)])
            preds.append(self.predict(state, sr, refs)[: e - s])
        preds = torch.cat(preds).cpu().numpy()

        refined = np.zeros((h, w, 3), np.float32)
        sr_img = np.zeros_like(refined)
        gt_img = np.zeros_like(refined) if "gt_patch" in tiles else None
        for p in range(n):
            x, y = [int(v) for v in tiles["start_locs"][p]]
            refined[y:y + plen, x:x + plen] = preds[p]
            sr_img[y:y + plen, x:x + plen] = tiles["sr_patch"][p]
            if gt_img is not None:
                gt_img[y:y + plen, x:x + plen] = tiles["gt_patch"][p]
        return refined, sr_img, gt_img

    def eval_image_metrics(self, refined, sr_img, gt_img):
        """SSIM (``max_val`` 2 on the (-1, 1) images) and PSNR (on (0, 1))
        of the input and of the refined image against the ground truth."""
        refined, sr_img, gt_img = (torch.from_numpy(x) for x in
                                   (refined, sr_img, gt_img))
        return {
            "ssim_input": float(ssim_fn(sr_img, gt_img, max_val=2.0)),
            "ssim_refine": float(ssim_fn(refined, gt_img, max_val=2.0)),
            "psnr_input": float(psnr_fn((sr_img + 1) / 2, (gt_img + 1) / 2)),
            "psnr_refine": float(psnr_fn((refined + 1) / 2,
                                         (gt_img + 1) / 2)),
        }
