"""The Blender supersampling dataset (``--dataset_mode blender_downX``).

Port of ``nerfsr_tpu/data/blender_downx.py:BlenderDownXDataset``: HR rays
at ``img_wh`` grouped so that each item is one LR pixel's ds^2 sub-rays;
the LR truth is the HR image downscaled by ``--ds_method`` and blended
over white after the resize (Lanczos on the premultiplied RGBA, as PIL;
``avg`` means RGBA blocks and blends the means); the HR truth is kept
grouped as ``rgbs_ori``. ``train_crop`` keeps a centre window whose size
and start are both multiples of ds (``_hr_crop_bounds``), and
``--rand_dir`` jitters each pixel's ray within the pixel, drawn from
``np.random.RandomState(--seed)`` as the JAX package draws it. Modes
``train``, ``train_crop``, ``val``, ``test`` and ``test_train``.
"""

from __future__ import annotations

import numpy as np

from nerfsr_torch.data import register_dataset
from nerfsr_torch.data.blender import BlenderScene, frame_c2w
from nerfsr_torch.data.downx_common import (blend_white, downscale,
                                            group_subpixels,
                                            lanczos_resize, read_pixels)
from nerfsr_torch.data.llff import _ray_dirs_np, cached_eval_dirs


def _rand_ray_dirs(h, w, focal, rng):
    """Per-pixel directions through a uniform point of each pixel
    (``--rand_dir``) instead of its centre."""
    u = rng.rand(h, w).astype(np.float32)
    v = rng.rand(h, w).astype(np.float32)
    i, j = np.meshgrid(np.arange(w, dtype=np.float32),
                       np.arange(h, dtype=np.float32), indexing="xy")
    return np.stack([(i + u - w / 2) / focal, -(j + v - h / 2) / focal,
                     -np.ones_like(i)], -1)


@register_dataset("blender_downX")
class BlenderDownXDataset(BlenderScene):
    """Modes: train, train_crop, val, test, test_train."""

    def __init__(self, opt, mode):
        self._read_meta(opt, mode)
        self.ds = opt.downscale
        w, h = self.img_wh
        if opt.rand_dir:
            rng = np.random.RandomState(opt.seed)
            self.directions = _rand_ray_dirs(h, w, self.focal, rng)
        else:
            self.directions = _ray_dirs_np(h, w, self.focal,
                                           opt.use_pixel_centers)

    def _load(self, frame):
        """-> HR rgb (h, w, 3), LR rgb (h/ds, w/ds, 3), blended over
        white after each resize."""
        px = read_pixels(self._path(frame))
        if tuple(px.shape[1::-1]) != self.img_wh:
            px = lanczos_resize(px, self.img_wh)
        if px.ndim == 2:
            px = px[..., None]
        lr = blend_white(downscale(px, self.ds, self.opt.ds_method))
        hr = blend_white(px.astype(np.float32) / 255.0)
        return hr[..., :3], lr[..., :3]

    def _hr_crop_bounds(self):
        """The ``train_crop`` window (y0, y1, x0, x1) by
        ``--precrop_frac``, its size and its start both multiples of ds,
        so that each group of cropped rays is one real ds x ds block."""
        w, h = self.img_wh
        ds = self.ds
        dh = int(h // 2 * self.opt.precrop_frac) // ds * ds
        dw = int(w // 2 * self.opt.precrop_frac) // ds * ds
        y0 = (h // 2 - dh) // ds * ds
        x0 = (w // 2 - dw) // ds * ds
        return y0, y0 + 2 * dh, x0, x0 + 2 * dw

    def _crop_hr(self, x):
        y0, y1, x0, x1 = self._hr_crop_bounds()
        return x[y0:y1, x0:x1]

    def _crop_lr(self, x):
        y0, y1, x0, x1 = self._hr_crop_bounds()
        ds = self.ds
        return x[y0 // ds:y1 // ds, x0 // ds:x1 // ds]

    def _pose_rays_grouped(self, c2w, crop=False):
        return {k: group_subpixels(self._crop_hr(v) if crop else v, self.ds)
                for k, v in self._rays(c2w).items()}

    def ray_buffer(self):
        """Grouped training buffer: origins, directions, near, far
        (N_lr, ds^2, .), rgbs (N_lr, 3) LR truth, rgbs_ori (N_lr, ds^2, 3)
        HR truth."""
        if self.mode not in ("train", "train_crop"):
            raise ValueError(f"ray_buffer is the train split's, not "
                             f"{self.mode}'s")
        crop = self.mode == "train_crop"
        parts = {k: [] for k in ("origins", "directions", "near", "far",
                                 "rgbs", "rgbs_ori")}
        for frame in self.frames:
            hr, lr = self._load(frame)
            if crop:
                hr, lr = self._crop_hr(hr), self._crop_lr(lr)
            rays = self._pose_rays_grouped(frame_c2w(frame), crop=crop)
            for k, v in rays.items():
                parts[k].append(v)
            parts["rgbs"].append(lr.reshape(-1, 3).astype(np.float32))
            parts["rgbs_ori"].append(
                group_subpixels(hr, self.ds).astype(np.float32))
        return {k: np.concatenate(v) for k, v in parts.items()}

    def eval_dirs(self):
        """The direction grid in the grouped order (each LR pixel's ds^2
        sub-rays contiguous), cached."""
        return cached_eval_dirs(self, self.ds)

    def image_rays(self, idx):
        """Grouped eval rays of view ``idx`` with its LR and HR truth."""
        frame = self.frames[idx]
        c2w = frame_c2w(frame)
        hr, lr = self._load(frame)
        rays = self._pose_rays_grouped(c2w)
        rays["rgbs"] = lr.reshape(-1, 3).astype(np.float32)
        rays["rgbs_ori"] = group_subpixels(hr, self.ds).astype(np.float32)
        rays["c2w"] = c2w
        return rays
