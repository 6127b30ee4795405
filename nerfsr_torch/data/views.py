"""Views of a forward-facing supersampling scene, from camera geometry
and images in memory.

``LLFFDownXViews`` is the pose half of ``LLFFDownXDataset``
(``data/llff_downx.py``) in ``test_train`` mode, built from ``(poses,
focal, img_wh, downscale)`` with no COLMAP model and no images: spiral
poses and NDC geometry. It provides what ``NeRFSystem.render_eval_many``
calls: ``eval_raygen_spec(idx)`` and ``eval_dirs()``.

``LLFFDownXTrainViews`` adds HR images (H, W, 3), uint8 or float in
[0, 1], and builds the dataset's grouped training buffer with the
dataset's own code (``pose_rays_grouped`` and ``downscale``); the buffer
is uploaded to the device once.
"""

from __future__ import annotations

import numpy as np
import torch

from nerfsr_torch.data.downx_common import downscale, group_subpixels
from nerfsr_torch.data.llff import (_ray_dirs_np, cached_eval_dirs,
                                    llff_eval_raygen_spec, spiral_path)
from nerfsr_torch.data.llff_downx import pose_rays_grouped


class LLFFDownXViews:
    """Forward-facing (NDC) views of the supersampling dataset.

    poses: (n, 3, 4) c2w; focal in HR pixels; img_wh the HR (w, h);
    downscale the LR factor. NDC depth bounds are (0, 1)."""

    depth_bounds = (0.0, 1.0)
    mode = "test_train"
    spheric = False

    def __init__(self, poses, focal: float, img_wh, downscale: int,
                 use_pixel_centers: bool = True):
        self.poses = np.asarray(poses, np.float32)
        self.focal = float(focal)
        self.img_wh = tuple(img_wh)
        self.ds = int(downscale)
        w, h = self.img_wh
        if h % self.ds or w % self.ds:
            raise ValueError(f"img_wh {self.img_wh} is not a multiple of "
                             f"downscale {self.ds}")
        self.directions = _ray_dirs_np(h, w, self.focal, use_pixel_centers)
        self._eval_dirs = None

    @classmethod
    def spiral(cls, focal: float, img_wh, downscale: int, n_views: int,
               radii=(0.3, 0.3, 0.1), focus_depth: float = 3.5):
        """Views on the spiral test path LLFF renders (``spiral_path``),
        at the given per-axis radii."""
        return cls(spiral_path(np.asarray(radii), focus_depth, n_views),
                   focal, img_wh, downscale)

    def __len__(self):
        return len(self.poses)

    def _near_far(self):
        return self.depth_bounds

    def eval_raygen_spec(self, idx):
        """Pose + static NDC geometry for device-side eval raygen."""
        return llff_eval_raygen_spec(self, idx)

    def eval_dirs(self):
        """The camera-space direction grid in the grouped flatten order
        (each LR pixel's ds^2 sub-rays contiguous), cached."""
        return cached_eval_dirs(self, self.ds)


class LLFFDownXTrainViews(LLFFDownXViews):
    """Training views: poses (n, 3, 4) c2w with their HR images (n, H, W,
    3), uint8 or float in [0, 1]. ``val_idx`` is the view nearest the
    mean pose centre (as the dataset picks it); ``ray_buffer`` leaves it
    out unless ``include_var``. ``lanc`` needs uint8 images."""

    def __init__(self, poses, images, focal: float, img_wh, downscale: int,
                 ds_method: str = "avg", use_pixel_centers: bool = True):
        super().__init__(poses, focal, img_wh, downscale, use_pixel_centers)
        self.images = np.asarray(images)
        if self.images.dtype != np.uint8:
            self.images = self.images.astype(np.float32)
        w, h = self.img_wh
        if self.images.shape != (len(self.poses), h, w, 3):
            raise ValueError(f"images {self.images.shape}, expected "
                             f"{(len(self.poses), h, w, 3)}")
        self.ds_method = ds_method
        dists = np.linalg.norm(self.poses[..., 3], axis=1)
        self.val_idx = int(np.argmin(dists))

    @classmethod
    def rendered(cls, system, params, focal: float, img_wh, downscale: int,
                 n_views: int, radii=(0.2, 0.2, 0.05), ds_method="avg",
                 poses=None):
        """Training views of the scene that ``system`` renders from
        ``params`` (``render_eval_many``, float rgb clipped to [0, 1]) on
        ``poses``, by default ``n_views`` spiral poses: a synthetic scene
        for runs with no dataset."""
        views = LLFFDownXViews.spiral(focal, img_wh, downscale, n_views,
                                      radii=radii) if poses is None \
            else LLFFDownXViews(poses, focal, img_wh, downscale)
        w, h = img_wh
        imgs = np.stack([
            np.clip(out["fine_rgb_ori"], 0.0, 1.0).reshape(h, w, 3)
            for out in system.render_eval_many(params, views,
                                               range(len(views)))])
        return cls(views.poses, imgs, focal, img_wh, downscale, ds_method)

    def ray_buffer(self, device=None, include_var: bool = True):
        """The grouped training buffer on ``device``: origins, directions,
        near, far (N_lr, ds^2, .), rgbs (N_lr, 3) LR truth, rgbs_ori
        (N_lr, ds^2, 3) HR truth. One upload per field."""
        keys = ("origins", "directions", "near", "far", "rgbs", "rgbs_ori")
        parts = {k: [] for k in keys}
        for i, c2w in enumerate(self.poses):
            if i == self.val_idx and not include_var:
                continue
            rays = pose_rays_grouped(self.directions, c2w, self.img_wh,
                                     self.focal, self.ds, self.depth_bounds)
            for k in ("origins", "directions", "near", "far"):
                parts[k].append(rays[k])
            img = self.images[i]
            lr = downscale(img, self.ds, self.ds_method)
            hr = img.astype(np.float32) / 255.0 if img.dtype == np.uint8 \
                else img
            parts["rgbs"].append(lr.reshape(-1, 3).astype(np.float32))
            parts["rgbs_ori"].append(group_subpixels(hr, self.ds))
        return {k: torch.from_numpy(np.ascontiguousarray(
                    np.concatenate(v))).to(device)
                for k, v in parts.items()}
