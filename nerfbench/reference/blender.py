"""The plain reference of NeRF-SR on a Blender (nerf_synthetic) scene:
world-space rays with per-ray near and far bounds, proposal sampling,
the white composite, the LR truth of RGBA images, and training's first
steps, in float32 PyTorch.

It reuses ``reference/nerf.py``'s networks, stratified sampler, inverse
CDF, compositing weights, interlevel loss, resample padding and Adam,
and departs from its forward-facing render only where a Blender scene
does, as NeRF (arXiv:2003.08934) renders its synthetic scenes and
NeRF-SR (arXiv:2112.01759) supervises them:

- rays stay in world space (no NDC): the camera centre as origin, the
  unit direction through the pixel centre, depths from each ray's near
  bound to its far bound (NeRF's 2 and 6);
- the fine composite is blended over white: ``rgb + (1 - acc)``, where
  ``acc`` is the sum of the ray's weights (the proposal rounds keep
  their weights alone, as there);
- the LR truth is PIL's Lanczos of the RGBA image, which resizes
  through premultiplied alpha (RGBA -> RGBa, the filter on all four
  channels, RGBa -> RGBA), blended over white after the resize
  (``rgb a + 1 - a``), as NeRF-SR's Blender loader does.

Only the proposal schedule (``fast_sampling``) is followed: the Blender
cells run it. It imports nothing of the system under test, no JAX and
no kernel; the benchmark hands it the poses, the RGBA images and the
weights it hands the system. The random draws of a step come from a
``torch.Generator`` seeded as the system seeds its chunk, in the order
the system draws them (the rows, the proposal jitter, each resample's
jitter; no density noise, whose scale is 0 on these scenes).
"""

from __future__ import annotations

import numpy as np
import torch

from nerfbench.reference import nerf as ref
from nerfbench.reference.lanczos import lanczos_downscale


def premultiply(rgba: np.ndarray) -> np.ndarray:
    """PIL's RGBA -> RGBa of uint8 pixels: each colour c becomes
    ``c a / 255`` rounded as PIL's ``MULDIV255`` (t = c a + 128;
    ((t >> 8) + t) >> 8)."""
    x = rgba.astype(np.int64)
    t = x[..., :3] * x[..., 3:] + 128
    return np.concatenate([((t >> 8) + t) >> 8, x[..., 3:]],
                          -1).astype(np.uint8)


def unpremultiply(rgba: np.ndarray) -> np.ndarray:
    """PIL's RGBa -> RGBA of uint8 pixels: ``255 c / a`` in integers,
    clipped to 255; a colour under alpha 0 or 255 is kept as it is."""
    x = rgba.astype(np.int64)
    a = x[..., 3:]
    c = np.minimum(255 * x[..., :3] // np.maximum(a, 1), 255)
    c = np.where((a == 0) | (a == 255), x[..., :3], c)
    return np.concatenate([c, a], -1).astype(np.uint8)


def lr_truth(rgba: np.ndarray, ds: int) -> np.ndarray:
    """float32 (h / ds, w / ds, 3) LR truth of one uint8 RGBA image."""
    lr = unpremultiply(lanczos_downscale(premultiply(rgba), ds))
    lr = lr.astype(np.float32) / 255.0
    a = lr[..., 3:]
    return lr[..., :3] * a + (1.0 - a)


class TrainData:
    """The training rows as the system's Blender buffer orders them: view
    by view, LR pixels in scan order, each with its ds^2 HR sub-rays
    (row-major in the block)."""

    def __init__(self, poses, rgba_u8, focal: float, ds: int, near: float,
                 far: float, device):
        self.poses = torch.as_tensor(poses, dtype=torch.float32,
                                     device=device)
        self.lr = torch.as_tensor(np.stack([lr_truth(im, ds)
                                            for im in rgba_u8]),
                                  device=device)
        self.n, self.h, self.w = rgba_u8.shape[:3]
        self.focal, self.ds = focal, ds
        self.near, self.far = near, far
        self.hl, self.wl = self.h // ds, self.w // ds

    def rows(self, idx: torch.Tensor):
        """(origins, unit directions (B * ds^2, 3) in world space, near,
        far (B * ds^2, 1), LR targets (B, 3))."""
        ds = self.ds
        v = idx // (self.hl * self.wl)
        p = idx % (self.hl * self.wl)
        r, c = p // self.wl, p % self.wl
        s = torch.arange(ds * ds, device=idx.device)
        hr_r = (r[:, None] * ds + s // ds).reshape(-1)
        hr_c = (c[:, None] * ds + s % ds).reshape(-1)
        dirs = torch.stack([(hr_c + 0.5 - self.w / 2) / self.focal,
                            -(hr_r + 0.5 - self.h / 2) / self.focal,
                            -torch.ones_like(hr_r, dtype=torch.float32)], -1)
        c2w = self.poses[v.repeat_interleave(ds * ds)]
        d = torch.einsum("nk,njk->nj", dirs, c2w[:, :, :3])
        d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
        bound = torch.ones_like(d[:, :1])
        return (c2w[:, :, 3], d, bound * self.near, bound * self.far,
                self.lr[v, r, c])

    def __len__(self):
        return self.n * self.hl * self.wl


def render(wts, o, d, near, far, arch, precision: str, gen, pad: float):
    """Render a training step's world rays (N, 3) between their bounds
    (N, 1) by the proposal schedule, over white, ``gen`` drawing the
    step's jitter in the system's order. Returns (rgb (N, 3), the parts
    the losses read)."""
    if not arch["fast_sampling"]:
        raise ValueError("the Blender reference follows the proposal "
                         "schedule (fast_sampling) alone")
    n = o.shape[0]

    def jitter(k):
        return torch.rand((n, k), generator=gen, device=o.device)

    def strat_u(k):
        return (torch.arange(k, device=o.device) + jitter(k)) / k

    def mids(z):
        return 0.5 * (z[:, :-1] + z[:, 1:])

    z = ref.stratified(o, d, near, far, arch["n_prop"],
                       jitter(arch["n_prop"]))
    hists = []
    for lvl in range(arch["n_prop_levels"]):
        if lvl > 0:
            zp, wp = hists[-1]
            z = ref.invert_cdf(mids(zp), wp[:, 1:-1].detach() + pad,
                               strat_u(arch["n_prop2"]))
        w = ref.weights_of(ref.proposal_mlp(wts, ref.points(o, d, z), arch,
                                            precision), z)
        hists.append((z, w))
    zp, wp = hists[-1]
    z = ref.invert_cdf(mids(zp), wp[:, 1:-1].detach()
                       + (pad if arch["n_prop_levels"] > 1 else 0.0),
                       strat_u(arch["N_importance"]))
    rgb, sigma = ref.nerf_mlp(wts, "fine", ref.points(o, d, z), d, arch,
                              precision)
    w = ref.weights_of(sigma, z)
    rgb = (w[..., None] * rgb).sum(-2) + (1.0 - w.sum(-1, keepdim=True))
    return rgb, {"w": w, "z": z, "hists": hists}


def step_loss(wts, data: TrainData, arch, gen, batch: int, pad: float,
              precision: str):
    """One step's batch (drawn from ``gen``) rendered; the LR mse of the
    sub-pixel mean plus the interlevel loss of every proposal round."""
    if arch["noise_std"] > 0:
        raise ValueError("the Blender reference draws no density noise")
    idx = torch.randint(0, len(data), (batch,), generator=gen,
                        device=data.poses.device)
    o, d, near, far, target = data.rows(idx)
    rgb, out = render(wts, o, d, near, far, arch, precision, gen, pad)
    ds2 = data.ds * data.ds
    loss = torch.mean((rgb.reshape(-1, ds2, 3).mean(1) - target) ** 2)
    for zp, wp in out["hists"]:
        loss = loss + ref.interlevel(out["z"], out["w"], zp, wp)
    return loss


def train_steps(wts, data: TrainData, arch, seeds, batch: int,
                steps_per_epoch: int, lr: float, precision: str = "f32"):
    """``nerf.train_steps`` on Blender rows: step i draws from a
    generator seeded with ``seeds[i]``. Returns (the losses, each step's
    gradient by leaf as the optimizer got it, the leaves after)."""
    wts = {k: v.detach().clone() for k, v in wts.items()}
    opt = ref.Adam(wts, lr)
    losses = []
    for step, seed in enumerate(seeds):
        gen = torch.Generator(device=data.poses.device).manual_seed(seed)
        leaves = {k: v.detach().requires_grad_(True) for k, v in wts.items()}
        loss = step_loss(leaves, data, arch, gen, batch,
                         ref.annealed_pad(arch, step, steps_per_epoch),
                         precision)
        grads = dict(zip(leaves, torch.autograd.grad(loss,
                                                     list(leaves.values()))))
        opt.step(wts, grads)
        losses.append(float(loss.detach()))
    return losses, opt.grads, wts
