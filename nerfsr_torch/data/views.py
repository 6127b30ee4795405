"""Views of a forward-facing supersampling scene, from camera geometry
and images in memory.

``LLFFDownXViews`` is the pose half of
``nerfsr_tpu/data/llff_downx.py:LLFFDownXDataset`` in test mode: built
from ``(poses, focal, img_wh, downscale)`` with no COLMAP model and no
images, which is all an LLFF test split is (spiral poses and NDC
geometry). It provides what ``NeRFSystem.render_eval_many`` calls:
``eval_raygen_spec(idx)`` and ``eval_dirs()``.

``LLFFDownXTrainViews`` adds HR images (H, W, 3) and builds the grouped
training buffer of ``LLFFDownXDataset.ray_buffer()`` (its own copies of
``_pose_rays_grouped`` and ``ray_buffer``, NDC through the port's ray
code), the LR truth by the ``avg`` branch of ``downscale_pil``
(``data/downx_common.py``); the buffer is uploaded to the device once.

The module holds its own copies of ``_ray_dirs_np`` (``data/blender.py``),
``group_subpixels`` (``data/downx_common.py``), ``spiral_path`` and the
non-spheric ``llff_eval_raygen_spec`` (``data/llff.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from nerfsr_torch.core.rays import get_rays, ndc_rays


def _ray_dirs_np(h, w, focal, use_pixel_centers=True):
    center = 0.5 if use_pixel_centers else 0.0
    i, j = np.meshgrid(
        np.arange(w, dtype=np.float32) + center,
        np.arange(h, dtype=np.float32) + center,
        indexing="xy")
    return np.stack(
        [(i - w / 2) / focal, -(j - h / 2) / focal, -np.ones_like(i)], -1)


def group_subpixels(arr: np.ndarray, ds: int) -> np.ndarray:
    """(H, W, C) -> (H/ds * W/ds, ds*ds, C): each LR pixel's ds^2 HR
    sub-elements, row-major within the block."""
    h, w = arr.shape[:2]
    c = arr.shape[2:]
    x = arr.reshape((h // ds, ds, w // ds, ds) + c)
    x = np.moveaxis(x, 1, 2)  # (h1, w1, ds, ds, C)
    return x.reshape((h // ds * (w // ds), ds * ds) + c)


def _normalize(v):
    return v / np.linalg.norm(v)


def spiral_path(radii, focus_depth, n_poses=120):
    """Two-turn spiral render path: (n_poses, 3, 4) c2w."""
    poses = []
    for t in np.linspace(0, 4 * np.pi, n_poses + 1)[:-1]:
        center = np.array([np.cos(t), -np.sin(t), -np.sin(0.5 * t)]) * radii
        z = _normalize(center - np.array([0, 0, -focus_depth]))
        x = _normalize(np.cross(np.array([0, 1.0, 0]), z))
        y = np.cross(z, x)
        poses.append(np.stack([x, y, z, center], 1))
    return np.stack(poses)


class LLFFDownXViews:
    """Forward-facing (NDC) test views of the supersampling dataset.

    poses: (n, 3, 4) c2w test poses; focal in HR pixels; img_wh the HR
    (w, h); downscale the LR factor. NDC depth bounds are (0, 1)."""

    depth_bounds = (0.0, 1.0)

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

    def eval_raygen_spec(self, idx):
        """Pose + static NDC geometry for device-side eval raygen."""
        c2w = self.poses[idx]
        near, far = self.depth_bounds
        w, h = self.img_wh
        return {"c2w": c2w, "vd_c2w": c2w,
                "geom": ("ndc", h, w, float(self.focal), float(near),
                         float(far))}

    def eval_dirs(self):
        """The camera-space direction grid in the grouped flatten order
        (each LR pixel's ds^2 sub-rays contiguous), cached."""
        if self._eval_dirs is None:
            d = group_subpixels(self.directions.astype(np.float32), self.ds)
            self._eval_dirs = np.ascontiguousarray(d.reshape(-1, 3))
        return self._eval_dirs


def downscale_avg(img: np.ndarray, ds: int) -> np.ndarray:
    """The ``avg`` branch of ``downscale_pil``: (H, W, C) float image ->
    (H/ds, W/ds, C) mean over each ds x ds block (rows and columns past a
    multiple of ds are dropped)."""
    arr = np.asarray(img, np.float32)
    if arr.ndim == 2:
        arr = arr[..., None]
    h, w = arr.shape[:2]
    arr = arr[:(h // ds) * ds, :(w // ds) * ds]
    return arr.reshape(h // ds, ds, w // ds, ds, -1).mean((1, 3))


def downscale(img: np.ndarray, ds: int, method: str) -> np.ndarray:
    """LR ground truth by ``--ds_method``. Lanczos (``lanc``) needs PIL's
    resampler, which the port does not carry yet: it raises rather than
    substituting another filter."""
    if method == "avg":
        return downscale_avg(img, ds)
    raise NotImplementedError(
        f"--ds_method {method} is not ported yet (only 'avg')")


class LLFFDownXTrainViews(LLFFDownXViews):
    """Training views: poses (n, 3, 4) c2w with their HR images (n, H, W,
    3) in [0, 1]. ``val_idx`` is the view nearest the mean pose centre
    (as the JAX dataset picks it); ``ray_buffer`` leaves it out unless
    ``include_var``."""

    def __init__(self, poses, images, focal: float, img_wh, downscale: int,
                 ds_method: str = "avg", use_pixel_centers: bool = True):
        super().__init__(poses, focal, img_wh, downscale, use_pixel_centers)
        self.images = np.asarray(images, np.float32)
        w, h = self.img_wh
        if self.images.shape != (len(self.poses), h, w, 3):
            raise ValueError(f"images {self.images.shape}, expected "
                             f"{(len(self.poses), h, w, 3)}")
        self.ds_method = ds_method
        dists = np.linalg.norm(self.poses[..., 3], axis=1)
        self.val_idx = int(np.argmin(dists))

    @classmethod
    def rendered(cls, system, params, focal: float, img_wh, downscale: int,
                 n_views: int, radii=(0.2, 0.2, 0.05), ds_method="avg"):
        """Training views of the scene that ``system`` renders from
        ``params`` (``render_eval_many``, float rgb clipped to [0, 1]) on
        ``n_views`` spiral poses: a synthetic scene for runs with no
        dataset."""
        views = LLFFDownXViews.spiral(focal, img_wh, downscale, n_views,
                                      radii=radii)
        w, h = img_wh
        imgs = np.stack([
            np.clip(out["fine_rgb_ori"], 0.0, 1.0).reshape(h, w, 3)
            for out in system.render_eval_many(params, views,
                                               range(n_views))])
        return cls(views.poses, imgs, focal, img_wh, downscale, ds_method)

    def _pose_rays_grouped(self, c2w):
        """HR rays for one pose, NDC-warped, grouped (N_lr, ds^2, .)."""
        w, h = self.img_wh
        ro, rd = get_rays(torch.from_numpy(self.directions),
                          torch.from_numpy(np.asarray(c2w, np.float32)))
        ro, rd = ndc_rays(h, w, self.focal, 1.0, ro.reshape(-1, 3),
                          rd.reshape(-1, 3))
        near, far = self.depth_bounds
        fields = {
            "origins": ro.numpy().reshape(h, w, 3),
            "directions": rd.numpy().reshape(h, w, 3),
            "near": np.full((h, w, 1), near, np.float32),
            "far": np.full((h, w, 1), far, np.float32),
        }
        return {k: group_subpixels(v, self.ds) for k, v in fields.items()}

    def ray_buffer(self, device=None, include_var: bool = True):
        """The grouped training buffer on ``device``: origins, directions,
        near, far (N_lr, ds^2, .), rgbs (N_lr, 3) LR truth, rgbs_ori
        (N_lr, ds^2, 3) HR truth. One upload per field."""
        keys = ("origins", "directions", "near", "far", "rgbs", "rgbs_ori")
        parts = {k: [] for k in keys}
        for i, c2w in enumerate(self.poses):
            if i == self.val_idx and not include_var:
                continue
            rays = self._pose_rays_grouped(c2w)
            for k in ("origins", "directions", "near", "far"):
                parts[k].append(rays[k])
            hr = self.images[i]
            lr = downscale(hr, self.ds, self.ds_method)
            parts["rgbs"].append(lr.reshape(-1, 3).astype(np.float32))
            parts["rgbs_ori"].append(
                group_subpixels(hr, self.ds).astype(np.float32))
        return {k: torch.from_numpy(np.ascontiguousarray(
                    np.concatenate(v))).to(device)
                for k, v in parts.items()}
