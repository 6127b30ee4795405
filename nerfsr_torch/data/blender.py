"""The NeRF-synthetic (Blender) dataset (``--dataset_mode blender``).

Port of ``nerfsr_tpu/data/blender.py:BlenderDataset``:
``transforms_{split}.json`` (``train_crop`` and ``test_train`` read the
train split), the focal from ``camera_angle_x`` scaled from 800 px to
``img_wh``, near/far 2/6, images through ``load_image`` (Lanczos on the
premultiplied RGBA as PIL does, then the blend over white), the
``train_crop`` centre window (``--precrop_frac``) and a val split capped
at 8 frames. Modes ``train``, ``train_crop``, ``val``, ``test`` and
``test_train``.

The training buffer is flat: origins, directions, near, far (N, .) and
rgbs (N, 3); the JAX package's ``viewdirs`` field equals ``directions``
here and is left out (the systems take the directions). Eval views
render from their pose on the device (``eval_raygen_spec``: world
geometry, constant bounds) or from ``image_rays``, which adds the
``valid_mask`` of pixels with alpha > 0.
"""

from __future__ import annotations

import json
import os

import numpy as np

from nerfsr_torch.data import register_dataset
from nerfsr_torch.data.downx_common import blend_white, load_image
from nerfsr_torch.data.llff import (_ray_dirs_np, cached_eval_dirs,
                                    image_buffer, pose_rays)

NEAR, FAR = 2.0, 6.0
MODES = ("train", "train_crop", "val", "test", "test_train")


def frame_c2w(frame):
    """A frame's (3, 4) camera-to-world matrix."""
    return np.array(frame["transform_matrix"], np.float32)[:3, :4]


class BlenderScene:
    """What both blender datasets read: the split's frames, the focal at
    ``img_wh`` and the bounds."""

    def _read_meta(self, opt, mode):
        if mode not in MODES:
            raise ValueError(f"{opt.dataset_mode} has no mode {mode!r}; "
                             f"modes: {MODES}")
        self.opt = opt
        self.mode = mode
        self.root = opt.dataset_root
        self.img_wh = tuple(opt.img_wh)
        split = {"train_crop": "train", "test_train": "train"}.get(mode, mode)
        with open(os.path.join(self.root,
                               f"transforms_{split}.json")) as f:
            self.meta = json.load(f)
        w = self.img_wh[0]
        self.focal = (0.5 * 800 / np.tan(
            0.5 * self.meta["camera_angle_x"])) * w / 800.0
        self.near, self.far = NEAR, FAR
        self.frames = self.meta["frames"]
        if mode == "val":
            self.frames = self.frames[:8]

    def _path(self, frame):
        return os.path.join(self.root, frame["file_path"] + ".png")

    def __len__(self):
        return len(self.frames)

    @property
    def depth_bounds(self):
        return self.near, self.far

    def _rays(self, c2w):
        """World rays of one pose as (H, W, .) fields, constant bounds."""
        return pose_rays(self.directions, c2w, self.img_wh, self.focal,
                         (self.near, self.far), spheric=True)

    def eval_raygen_spec(self, idx):
        """Pose of frame ``idx`` and the static geometry (world rays,
        constant near/far) for device-side eval raygen."""
        return {"c2w": frame_c2w(self.frames[idx]),
                "geom": ("world", float(self.near), float(self.far))}


@register_dataset("blender")
class BlenderDataset(BlenderScene):
    """Modes: train, train_crop, val, test, test_train."""

    def __init__(self, opt, mode):
        self._read_meta(opt, mode)
        w, h = self.img_wh
        self.directions = _ray_dirs_np(h, w, self.focal,
                                       opt.use_pixel_centers)

    def ray_buffer(self):
        """All rays of all training images (the centre window of each
        under ``train_crop``), flat: origins, directions, near, far (N, .),
        rgbs (N, 3)."""
        if self.mode not in ("train", "train_crop"):
            raise ValueError(f"ray_buffer is the train split's, not "
                             f"{self.mode}'s")
        w, h = self.img_wh
        dh = int(h // 2 * self.opt.precrop_frac)
        dw = int(w // 2 * self.opt.precrop_frac)
        keys = ("origins", "directions", "near", "far", "rgbs")
        parts = {k: [] for k in keys}
        for frame in self.frames:
            rays = self._rays(frame_c2w(frame))
            rays["rgbs"] = load_image(self._path(frame),
                                      self.img_wh).astype(np.float32)
            for k in keys:
                v = rays[k]
                if self.mode == "train_crop":
                    v = v[h // 2 - dh:h // 2 + dh, w // 2 - dw:w // 2 + dw]
                parts[k].append(v.reshape(-1, v.shape[-1]))
        return {k: np.concatenate(v) for k, v in parts.items()}

    def image_buffer(self):
        """The training rays image by image, (N_img, H, W, C) for each
        field of ``ray_buffer``: patch mode's (``--patch_size`` > 1)
        source of contiguous pixels."""
        if self.mode != "train":
            raise ValueError(f"image_buffer is the train split's, not "
                             f"{self.mode}'s")
        return image_buffer(self.ray_buffer(), self.img_wh)

    def eval_dirs(self):
        """The direction grid in raster order (cached)."""
        return cached_eval_dirs(self)

    def image_rays(self, idx):
        """Rays, truth and the alpha > 0 mask of eval view ``idx``."""
        frame = self.frames[idx]
        c2w = frame_c2w(frame)
        arr = load_image(self._path(frame), self.img_wh, keep_alpha=True)
        if arr.shape[-1] == 4:
            valid_mask = (arr[..., 3] > 0).reshape(-1)
        else:
            valid_mask = np.ones(arr.shape[0] * arr.shape[1], bool)
        rays = {k: v.reshape(-1, v.shape[-1])
                for k, v in self._rays(c2w).items()}
        rays.update(viewdirs=rays["directions"],
                    rgbs=blend_white(arr).reshape(-1, 3).astype(np.float32),
                    valid_mask=valid_mask, c2w=c2w)
        return rays
