"""The plain reference of NeRF-SR's refinement stage: the training views'
perspective augmentation, the patch cut, the U-Net, its L1 loss and
Adam, in float32 PyTorch and float64 NumPy.

It follows NeRF-SR (arXiv:2112.01759, section 3.3, and
``scripts/train_llff_refine.sh``: ``--refine_network unetgenerator``,
64x64 patches, 8 reference patches, ``--refine_with_l1``) and pix2pix's
``UnetGenerator`` (arXiv:1611.07004) as the configuration states them,
with the conventions of the system under test where the published code
leaves a choice open or draws from another generator: the augmentations
drawn from ``np.random.RandomState(seed)`` in torchvision's
``RandomPerspective`` order, a warp's bilinear taps outside the image
weighed 0 and its valid box where a warped image of ones is above 0.5,
the patch cut from one (batch, 4 + 2 k) float64 draw of a
``torch.Generator``, batch norm by flax's rule (the biased batch
variance, running values moved 0.1 of the way), and the U-Net's leaves
in the system's naming. It imports nothing of the system under test, no
JAX and no kernel, and takes nothing the system made: the benchmark
hands it the same views and leaves it hands the system, and it works out
the augmented views, the patches and everything after them itself.

``precision`` picks how every convolution is computed: ``f32`` (TF32
off), or ``bf16``, the control, the step below the configuration's TF32
convolutions: both operands of each convolution (and of each of its
backward products) rounded to bfloat16, accumulated in f32.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from nerfbench.reference.nerf import ROUNDING, Adam, strict_f32

BN_MOMENTUM, BN_EPS = 0.9, 1e-5


# ---------------------------------------------------------------------
# the network
# ---------------------------------------------------------------------

def widths(arch: dict) -> Tuple[List[int], List[int]]:
    """The U-Net's output channels going down and coming up."""
    ngf = arch["ngf"]
    downs = [ngf, ngf * 2, ngf * 4] + [ngf * 8] * (arch["num_downs"] - 3)
    return downs, list(reversed(downs[:-1])) + [arch["output_nc"]]


def leaf_shapes(arch: dict) -> List[Tuple[str, Tuple[int, ...]]]:
    """(name, shape) of every leaf: each 4x4 kernel (down: (out, in, 4,
    4); up, transposed: (in, out, 4, 4)), batch norm's scale and bias
    after every down but the outermost and innermost and after every up
    but the last, and the last up's bias."""
    downs, ups = widths(arch)
    out, cin = [], arch["input_nc"]
    for i, feats in enumerate(downs):
        out.append((f"down_{i}.weight", (feats, cin, 4, 4)))
        if 0 < i < len(downs) - 1:
            out += [(f"down_norm_{i}.BatchNorm_0.scale", (feats,)),
                    (f"down_norm_{i}.BatchNorm_0.bias", (feats,))]
        cin = feats
    for i, feats in enumerate(ups):
        out.append((f"up_{i}.weight", (cin, feats, 4, 4)))
        if i < len(ups) - 1:
            out += [(f"up_norm_{i}.BatchNorm_0.scale", (feats,)),
                    (f"up_norm_{i}.BatchNorm_0.bias", (feats,))]
        else:
            out.append((f"up_{i}.bias", (feats,)))
        cin = 2 * feats
    return out


def stat_shapes(arch: dict) -> List[Tuple[str, Tuple[int, ...]]]:
    """(name, shape) of every running mean and variance."""
    return [(n[:-len("scale")] + k, s) for n, s in leaf_shapes(arch)
            if n.endswith(".scale") for k in ("mean", "var")]


class _RoundedConv(torch.autograd.Function):
    """A convolution ``op(x, w)`` with both operands, and the output's
    gradient, rounded by ``rnd``: each backward product with rounded
    operands too."""

    @staticmethod
    def forward(ctx, x, w, op, rnd):
        xq, wq = rnd(x), rnd(w)
        ctx.save_for_backward(xq, wq)
        ctx.op, ctx.rnd = op, rnd
        return op(xq, wq)

    @staticmethod
    def backward(ctx, gy):
        xq, wq = ctx.saved_tensors
        with torch.enable_grad():
            xr = xq.detach().requires_grad_()
            wr = wq.detach().requires_grad_()
            gx, gw = torch.autograd.grad(ctx.op(xr, wr), (xr, wr),
                                         ctx.rnd(gy))
        return gx, gw, None, None


def _down(x, w):
    return F.conv2d(x, w, stride=2, padding=1)


def _up(x, w):
    return F.conv_transpose2d(x, w, stride=2, padding=1)


def _conv(op, x, w, precision: str):
    if precision == "f32":
        return op(x, w)
    return _RoundedConv.apply(x, w, op, ROUNDING[precision])


def batch_norm(x, scale, bias, mean, var, moved: Dict[str, torch.Tensor],
               name: str):
    """Training-mode batch norm over NCHW: the batch's mean and biased
    variance normalize; the running values (``mean``, ``var``) moved 0.1
    of the way to them go to ``moved``."""
    m = x.mean((0, 2, 3))
    v = ((x - m[:, None, None]) ** 2).mean((0, 2, 3))
    with torch.no_grad():
        moved[name + "mean"] = BN_MOMENTUM * mean + (1 - BN_MOMENTUM) * m
        moved[name + "var"] = BN_MOMENTUM * var + (1 - BN_MOMENTUM) * v
    return (x - m[:, None, None]) / torch.sqrt(v + BN_EPS)[:, None, None] \
        * scale[:, None, None] + bias[:, None, None]


def unet(wts, stats, x, arch: dict, precision: str):
    """The U-Net in training mode on NCHW ``x``: (tanh output NCHW, the
    running statistics after the call). Down: leaky relu (0.2) before
    every convolution but the first, batch norm after every one but the
    outermost and innermost; up: relu, the transposed convolution, batch
    norm and the skip (the down's output) concatenated ahead of it, on
    every up but the last."""
    n = arch["num_downs"]
    moved: Dict[str, torch.Tensor] = {}

    def norm(h, prefix):
        return batch_norm(h, wts[prefix + "scale"], wts[prefix + "bias"],
                          stats[prefix + "mean"], stats[prefix + "var"],
                          moved, prefix)
    skips, h = [], x
    for i in range(n):
        if i > 0:
            h = F.leaky_relu(h, 0.2)
        h = _conv(_down, h, wts[f"down_{i}.weight"], precision)
        if 0 < i < n - 1:
            h = norm(h, f"down_norm_{i}.BatchNorm_0.")
        skips.append(h)
    for i in range(n):
        h = _conv(_up, torch.relu(h), wts[f"up_{i}.weight"], precision)
        if i < n - 1:
            h = torch.cat([skips[n - 2 - i],
                           norm(h, f"up_norm_{i}.BatchNorm_0.")], 1)
        else:
            h = h + wts[f"up_{i}.bias"][:, None, None]
    return torch.tanh(h), moved


# ---------------------------------------------------------------------
# the augmented views
# ---------------------------------------------------------------------

def perspective_corners(rng: np.random.RandomState, w: int, h: int,
                        scale: float) -> np.ndarray:
    """Where the image's corners (top left, top right, bottom right,
    bottom left) move: each within ``scale`` of half the width and half
    the height toward the centre, drawn as torchvision's RandomPerspective
    draws them."""
    hw, hh = int(scale * w // 2), int(scale * h // 2)
    tl = [rng.randint(0, hw + 1), rng.randint(0, hh + 1)]
    tr = [w - 1 - rng.randint(0, hw + 1), rng.randint(0, hh + 1)]
    br = [w - 1 - rng.randint(0, hw + 1), h - 1 - rng.randint(0, hh + 1)]
    bl = [rng.randint(0, hw + 1), h - 1 - rng.randint(0, hh + 1)]
    return np.array([tl, tr, br, bl], np.float64)


def homography(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """The 3x3 projective map (its [2, 2] entry 1) taking the four points
    ``src`` to ``dst``."""
    a, b = [], []
    for (x, y), (u, v) in zip(src, dst):
        a.append([x, y, 1, 0, 0, 0, -u * x, -u * y])
        b.append(u)
    for (x, y), (u, v) in zip(src, dst):
        a.append([0, 0, 0, x, y, 1, -v * x, -v * y])
        b.append(v)
    h = np.linalg.solve(np.array(a, np.float64), np.array(b, np.float64))
    return np.append(h, 1.0).reshape(3, 3)


def warp(img: np.ndarray, corners: np.ndarray):
    """``img`` (h, w, c) under the map that takes its corners to
    ``corners``: each output pixel samples the image bilinearly at its
    preimage, a tap outside the image counting 0. Returns (the warped
    image in f32, the valid box (x0, y0, x1, y1): the pixels whose taps
    inside the image weigh more than 0.5)."""
    h, w = img.shape[:2]
    src = np.array([[0, 0], [w - 1, 0], [w - 1, h - 1], [0, h - 1]],
                   np.float64)
    inv = np.linalg.inv(homography(src, corners))
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    den = inv[2, 0] * xs + inv[2, 1] * ys + inv[2, 2]
    den = np.divide(1.0, den, out=np.zeros_like(den), where=den != 0)
    sx = (inv[0, 0] * xs + inv[0, 1] * ys + inv[0, 2]) * den
    sy = (inv[1, 0] * xs + inv[1, 1] * ys + inv[1, 2]) * den
    x0, y0 = np.floor(sx), np.floor(sy)
    out = np.zeros(img.shape, np.float64)
    weight = np.zeros((h, w), np.float64)
    src_img = np.asarray(img, np.float64)
    for dy in (0, 1):
        for dx in (0, 1):
            xi, yi = x0 + dx, y0 + dy
            wt = (1 - np.abs(sx - xi)) * (1 - np.abs(sy - yi))
            inside = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
            wt = np.where(inside, wt, 0.0)
            tap = src_img[np.where(inside, yi, 0).astype(np.int64),
                          np.where(inside, xi, 0).astype(np.int64)]
            out += wt[..., None] * tap
            weight += wt
    rows, cols = np.nonzero(weight > 0.5)
    box = (0, 0, w, h) if len(cols) == 0 else (
        int(cols.min()), int(rows.min()), int(cols.max()) + 1,
        int(rows.max()) + 1)
    return out.astype(np.float32), box


class Views:
    """The training views as the configuration augments them: view 0 the
    reference view and its synthesis, views 1 to ``aug_num`` - 1 both
    warped by one random perspective each, drawn from
    ``RandomState(seed)``; each view's pair and valid box worked out when
    a patch first asks for it. Images in (-1, 1)."""

    def __init__(self, gt_u8: np.ndarray, sr_u8: np.ndarray, arch: dict,
                 seed: int):
        self.gt = gt_u8.astype(np.float32) / 255.0 * 2.0 - 1.0
        self.sr = sr_u8.astype(np.float32) / 255.0 * 2.0 - 1.0
        self.h, self.w = self.gt.shape[:2]
        self.n = max(1, arch["aug_num"])
        rng = np.random.RandomState(seed)
        self.corners = [None] + [
            perspective_corners(rng, self.w, self.h, arch["distort_scale"])
            for _ in range(1, arch["aug_num"])]
        self._done = {}

    def __getitem__(self, a: int):
        """(gt, sr, box) of view ``a``."""
        if a not in self._done:
            if a == 0:
                self._done[a] = (self.gt, self.sr, (0, 0, self.w, self.h))
            else:
                both, box = warp(np.concatenate([self.gt, self.sr], -1),
                                 self.corners[a])
                self._done[a] = (both[..., :3], both[..., 3:], box)
        return self._done[a]


def _between(u, lo, hi):
    """Integers in [lo, max(lo + 1, hi)) from uniforms ``u`` in [0, 1)."""
    n = np.maximum(hi - lo, 1)
    return lo + np.minimum(np.floor(u * n).astype(np.int64), n - 1)


def _crop(img: np.ndarray, y: int, x: int, plen: int) -> np.ndarray:
    """The ``plen`` square of ``img`` at (y, x), the start clamped into
    the image."""
    y = min(max(int(y), 0), img.shape[0] - plen)
    x = min(max(int(x), 0), img.shape[1] - plen)
    return img[y:y + plen, x:x + plen]


def patches(views: Views, u: np.ndarray, arch: dict):
    """The batch that the (batch, 4 + 2 k) uniforms ``u`` cut: per row a
    view (u0), an SR and truth patch inside its valid box (u1 x, u2 y),
    and k reference patches of the unwarped truth within ``ref_offset``
    of it (x, then y). Returns NHWC float32 (sr, refs (B, k, P, P, 3),
    gt)."""
    plen, k, off = arch["patch_len"], arch["num_ref_patches"], \
        arch["ref_offset"]
    sr, gt, refs = [], [], []
    for row in u:
        a = min(int(np.floor(row[0] * views.n)), views.n - 1)
        g, s, (x0, y0, x1, y1) = views[a]
        xs = int(_between(row[1], x0, x1 - plen))
        ys = int(_between(row[2], y0, y1 - plen))
        sr.append(_crop(s, ys, xs, plen))
        gt.append(_crop(g, ys, xs, plen))
        rx = _between(row[4:4 + k], max(x0, xs - off),
                      min(x1 - plen, xs + off))
        ry = _between(row[4 + k:], max(y0, ys - off),
                      min(y1 - plen, ys + off))
        refs.append(np.stack([_crop(views.gt, y, x, plen)
                              for x, y in zip(rx, ry)]))
    return np.stack(sr), np.stack(refs), np.stack(gt)


# ---------------------------------------------------------------------
# training
# ---------------------------------------------------------------------

def lr_at(arch: dict, step: int, steps_per_epoch: int) -> float:
    """The exp schedule, stepped once an epoch: lr to lr_final over the
    last n_epochs_decay + 1 epochs."""
    e = step // max(1, steps_per_epoch)
    t = max(0.0, e + 1 - arch["n_epochs"] + arch["n_epochs_decay"]) \
        / float(arch["n_epochs_decay"] + 1)
    return math.exp(math.log(arch["lr"]) * (1 - t)
                    + math.log(arch["lr_final"]) * t)


def step_loss(wts, stats, views: Views, arch: dict, gen, device,
              precision: str):
    """One step's batch (drawn from ``gen``) through the U-Net: (the L1
    loss, the running statistics after it)."""
    k = arch["num_ref_patches"]
    u = torch.rand((arch["batch_size"], 4 + 2 * k), dtype=torch.float64,
                   generator=gen, device=device).cpu().numpy()
    sr, refs, gt = (torch.from_numpy(x).to(device)
                    for x in patches(views, u, arch))
    x = torch.cat([sr] + [refs[:, j] for j in range(k)], -1)
    out, moved = unet(wts, stats, x.permute(0, 3, 1, 2), arch, precision)
    return torch.mean(torch.abs(out.permute(0, 2, 3, 1) - gt)), moved


def train_steps(wts, stats, views: Views, arch: dict, seeds,
                steps_per_epoch: int, device, precision: str = "f32"):
    """Follow the system's first steps: step i draws from a generator
    seeded with ``seeds[i]``. Returns (the losses, each step's gradient by
    leaf, the leaves after the last step, the running statistics after
    each step)."""
    strict_f32()
    wts = {k: v.detach().clone() for k, v in wts.items()}
    stats = {k: v.detach().clone() for k, v in stats.items()}
    opt = Adam(wts, arch["lr"], b1=arch["beta1"])
    losses, moved = [], []
    for step, seed in enumerate(seeds):
        gen = torch.Generator(device=device).manual_seed(seed)
        leaves = {k: v.detach().requires_grad_(True) for k, v in wts.items()}
        loss, stats = step_loss(leaves, stats, views, arch, gen, device,
                                precision)
        grads = dict(zip(leaves, torch.autograd.grad(
            loss, list(leaves.values()))))
        opt.lr = lr_at(arch, step, steps_per_epoch)
        opt.step(wts, grads)
        losses.append(float(loss.detach()))
        moved.append(stats)
    return losses, opt.grads, wts, moved
