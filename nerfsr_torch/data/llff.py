"""Forward-facing (LLFF) scene geometry: COLMAP poses to NeRF poses,
render paths and rays, in numpy.

Port of the pose half of ``nerfsr_tpu/data/llff.py`` (``average_pose``,
``center_poses``, ``spiral_path``, ``spheric_path``, ``ndc_rays_np``,
``llff_eval_raygen_spec``, ``load_colmap_scene``) and of the camera
helpers of ``nerfsr_tpu/data/blender.py`` (``_ray_dirs_np``,
``rays_from_pose``, ``cached_eval_dirs``) that the LLFF datasets share.

``load_colmap_scene`` reads the sparse model, turns each image's w2c
into a c2w, takes per-image depth bounds from the 0.1 and 99.9
percentiles of its visible points, sorts by image name, flips COLMAP's
"right down front" axes to NeRF's "right up back", centres the poses on
their average pose and rescales the world so the nearest bound is 4/3.

``LLFFDataset`` (``--dataset_mode llff``) is the port of the JAX
package's vanilla dataset: flat rays at ``img_wh``, NDC-warped for
forward-facing scenes (near/far 0/1) or in world bounds with
``--spheric_poses``, images Lanczos-resized to ``img_wh``; modes
``train``, ``val``, ``test`` (spiral or spheric path), ``test_train`` and
``test_viewdir`` (test pose 10 seen with each path pose's view
directions); ``--include_var``; the auxiliary paths' ``ref_buffer``
(the ``--ref_idx`` view's HR rays and colours, ``--with_ref``) and
``image_buffer`` (the training rays image by image, patch mode). As the
JAX package builds a forward-facing scene's training rays with its host
C++ raygen, ``ray_buffer`` builds them with the port's host C
(``utils/raygen.py``); spheric scenes take the numpy ``pose_rays``, as in
JAX.
"""

from __future__ import annotations

import os

import numpy as np

from nerfsr_torch.data import register_dataset
from nerfsr_torch.data.colmap import read_model
from nerfsr_torch.data.downx_common import group_subpixels, load_image
from nerfsr_torch.utils import raygen


def _normalize(v):
    return v / np.linalg.norm(v)


def _ray_dirs_np(h, w, focal, use_pixel_centers=True):
    """Camera-space ray directions (H, W, 3) of a pinhole camera looking
    down -z."""
    center = 0.5 if use_pixel_centers else 0.0
    i, j = np.meshgrid(
        np.arange(w, dtype=np.float32) + center,
        np.arange(h, dtype=np.float32) + center,
        indexing="xy")
    return np.stack(
        [(i - w / 2) / focal, -(j - h / 2) / focal, -np.ones_like(i)], -1)


def rays_from_pose(directions, c2w):
    """World rays of camera-space directions under a (3, 4) c2w: unit
    directions and the camera centre as every origin."""
    rays_d = directions @ c2w[:, :3].T
    rays_d = rays_d / np.linalg.norm(rays_d, axis=-1, keepdims=True)
    rays_o = np.broadcast_to(c2w[:, 3], rays_d.shape).copy()
    return rays_o.astype(np.float32), rays_d.astype(np.float32)


def cached_eval_dirs(ds_obj, group_ds: int = 0):
    """The dataset's flat camera-space direction grid in its eval ray
    order (raster, or sub-pixel grouped when ``group_ds`` > 1), cached on
    the dataset: ``NeRFSystem.render_pose`` uploads it once."""
    if getattr(ds_obj, "_eval_dirs", None) is None:
        d = ds_obj.directions.astype(np.float32)
        if group_ds > 1:
            d = group_subpixels(d, group_ds)
        ds_obj._eval_dirs = np.ascontiguousarray(d.reshape(-1, 3))
    return ds_obj._eval_dirs


def average_pose(poses):
    """Average c2w: mean centre, mean z, y from the mean y via x = y' x z."""
    center = poses[..., 3].mean(0)
    z = _normalize(poses[..., 2].mean(0))
    y_ = poses[..., 1].mean(0)
    x = _normalize(np.cross(y_, z))
    y = np.cross(z, x)
    return np.stack([x, y, z, center], 1)


def center_poses(poses):
    """Express every pose in the frame of the average pose."""
    avg = average_pose(poses)
    avg_homo = np.eye(4)
    avg_homo[:3] = avg
    last = np.tile(np.array([0, 0, 0, 1.0]), (len(poses), 1, 1))
    homo = np.concatenate([poses, last], 1)
    centered = (np.linalg.inv(avg_homo) @ homo)[:, :3]
    return centered, avg


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


def spheric_path(radius, n_poses=120):
    """Circular path looking 36 degrees down: (n_poses, 3, 4) c2w."""
    def pose(theta, phi, r):
        trans = np.array([[1, 0, 0, 0], [0, 1, 0, -0.9 * r],
                          [0, 0, 1, r], [0, 0, 0, 1.0]])
        rot_phi = np.array([
            [1, 0, 0, 0],
            [0, np.cos(phi), -np.sin(phi), 0],
            [0, np.sin(phi), np.cos(phi), 0],
            [0, 0, 0, 1]])
        rot_theta = np.array([
            [np.cos(theta), 0, -np.sin(theta), 0],
            [0, 1, 0, 0],
            [np.sin(theta), 0, np.cos(theta), 0],
            [0, 0, 0, 1]])
        c2w = rot_theta @ rot_phi @ trans
        flip = np.array([[-1, 0, 0, 0], [0, 0, 1, 0],
                         [0, 1, 0, 0], [0, 0, 0, 1.0]])
        return (flip @ c2w)[:3]

    return np.stack([pose(th, -np.pi / 5, radius)
                     for th in np.linspace(0, 2 * np.pi, n_poses + 1)[:-1]])


def ndc_rays_np(h, w, focal, near, rays_o, rays_d):
    """Rays into normalized device coordinates (numpy twin of
    ``core.rays.ndc_rays``)."""
    t = -(near + rays_o[..., 2]) / rays_d[..., 2]
    rays_o = rays_o + t[..., None] * rays_d
    ox_oz = rays_o[..., 0] / rays_o[..., 2]
    oy_oz = rays_o[..., 1] / rays_o[..., 2]
    o0 = -1.0 / (w / (2.0 * focal)) * ox_oz
    o1 = -1.0 / (h / (2.0 * focal)) * oy_oz
    o2 = 1.0 + 2.0 * near / rays_o[..., 2]
    d0 = -1.0 / (w / (2.0 * focal)) * (
        rays_d[..., 0] / rays_d[..., 2] - ox_oz)
    d1 = -1.0 / (h / (2.0 * focal)) * (
        rays_d[..., 1] / rays_d[..., 2] - oy_oz)
    d2 = 1.0 - o2
    return (np.stack([o0, o1, o2], -1).astype(np.float32),
            np.stack([d0, d1, d2], -1).astype(np.float32))


def pose_rays(directions, c2w, img_wh, focal, near_far, spheric=False):
    """Rays of one pose as (H, W, .) fields: origins and directions
    (NDC-warped unless ``spheric``), near and far (constant)."""
    w, h = img_wh
    ro, rd = rays_from_pose(directions, c2w)
    ro, rd = ro.reshape(-1, 3), rd.reshape(-1, 3)
    near, far = near_far
    if not spheric:
        ro, rd = ndc_rays_np(h, w, focal, 1.0, ro, rd)
    return {"origins": ro.reshape(h, w, 3),
            "directions": rd.reshape(h, w, 3),
            "near": np.full((h, w, 1), near, np.float32),
            "far": np.full((h, w, 1), far, np.float32)}


def image_buffer(flat, img_wh):
    """A flat training buffer of whole images, (N_img * H * W, C) a
    field, as (N_img, H, W, C)."""
    w, h = img_wh
    n_img = len(flat["rgbs"]) // (h * w)
    return {k: v.reshape(n_img, h, w, v.shape[-1]) for k, v in flat.items()}


def llff_eval_raygen_spec(ds_obj, idx):
    """Pose and static geometry of view ``idx`` for device-side eval
    raygen: the val view, a training pose (``test_train``) or a test-path
    pose; NDC geometry for forward-facing scenes, world bounds for
    spheric ones. ``test_viewdir`` renders from test pose 10 with view
    directions of pose ``idx``."""
    if ds_obj.mode == "val":
        c2w = ds_obj.poses[ds_obj.val_idx]
    elif ds_obj.mode == "test_train":
        c2w = ds_obj.poses[idx]
    else:
        c2w = ds_obj._poses_test[idx]
    vd_c2w = c2w
    if ds_obj.mode == "test_viewdir":
        c2w = ds_obj._poses_test[10]
    near, far = ds_obj._near_far()
    w, h = ds_obj.img_wh
    if ds_obj.spheric:
        geom = ("world", float(near), float(far))
    else:
        geom = ("ndc", h, w, float(ds_obj.focal), float(near),
                float(far))
    return {"c2w": c2w, "vd_c2w": vd_c2w, "geom": geom}


def load_colmap_scene(root_dir, img_wh):
    """COLMAP sparse model under ``root_dir/sparse/0`` -> (poses (N, 3, 4),
    bounds (N, 2), focal at ``img_wh``, image paths), processed as the
    module docstring says."""
    cams, imdata, pts3d = read_model(os.path.join(root_dir, "sparse/0"))
    cam = cams[min(cams)]
    focal = cam.params[0] * img_wh[0] / cam.width

    keys = list(imdata)
    names = [imdata[k].name for k in keys]
    perm = np.argsort(names)
    image_paths = [os.path.join(root_dir, "images", n)
                   for n in sorted(names)]

    w2c = []
    bottom = np.array([[0, 0, 0, 1.0]])
    for k in keys:
        im = imdata[k]
        R = im.qvec2rotmat()
        t = im.tvec.reshape(3, 1)
        w2c.append(np.concatenate(
            [np.concatenate([R, t], 1), bottom], 0))
    poses = np.linalg.inv(np.stack(w2c))[:, :3]  # c2w, order of `keys`

    # per-image depth bounds from visible 3D points
    id_to_idx = {imdata[k].id: i for i, k in enumerate(keys)}
    n_img = len(keys)
    pts_xyz = np.stack([p.xyz for p in pts3d.values()])  # (P, 3)
    vis = np.zeros((n_img, len(pts_xyz)), bool)
    for j, p in enumerate(pts3d.values()):
        for img_id in p.image_ids:
            if img_id in id_to_idx:
                vis[id_to_idx[img_id], j] = True
    # depth of each point w.r.t. each camera: (p - center) . z_axis
    depths = np.einsum(
        "pk,nk->np", pts_xyz, poses[..., 2]) - np.einsum(
        "nk,nk->n", poses[..., 3], poses[..., 2])[:, None]
    bounds = np.zeros((n_img, 2))
    for i in range(n_img):
        zs = depths[i][vis[i]]
        if len(zs) == 0:
            zs = depths[i]
        bounds[i] = [np.percentile(zs, 0.1), np.percentile(zs, 99.9)]

    poses = poses[perm]
    bounds = bounds[perm]

    # COLMAP "right down front" -> NeRF "right up back"
    poses = np.concatenate(
        [poses[..., 0:1], -poses[..., 1:3], poses[..., 3:4]], -1)
    poses, _ = center_poses(poses)

    scale = bounds.min() * 0.75  # nearest depth at ~1.33
    bounds /= scale
    poses[..., 3] /= scale
    return poses.astype(np.float32), bounds.astype(np.float32), focal, \
        image_paths


@register_dataset("llff")
class LLFFDataset:
    """Modes: train, val, test, test_train, test_viewdir."""

    MODES = ("train", "val", "test", "test_train", "test_viewdir")

    def __init__(self, opt, mode):
        if mode not in self.MODES:
            raise ValueError(f"llff has no mode {mode!r}; modes: "
                             f"{self.MODES}")
        self.opt = opt
        self.mode = mode
        self.img_wh = tuple(opt.img_wh)
        self.spheric = opt.spheric_poses
        w, h = self.img_wh

        self.poses, self.bounds, self.focal, self.image_paths = \
            load_colmap_scene(opt.dataset_root, self.img_wh)
        self.directions = _ray_dirs_np(h, w, self.focal,
                                       opt.use_pixel_centers)
        dists = np.linalg.norm(self.poses[..., 3], axis=1)
        self.val_idx = int(np.argmin(dists))

        self._poses_test = None
        if mode in ("test", "test_viewdir"):
            if not self.spheric:
                radii = np.percentile(
                    np.abs(self.poses[..., 3]), 90, axis=0)
                self._poses_test = spiral_path(radii, focus_depth=3.5)
            else:
                self._poses_test = spheric_path(1.1 * self.bounds.min())

    def _near_far(self):
        if not self.spheric:
            return 0.0, 1.0
        near = float(self.bounds.min())
        return near, float(min(8 * near, self.bounds.max()))

    @property
    def depth_bounds(self):
        return self._near_far()

    def _pose_rays(self, c2w):
        """Rays of one pose (NDC-warped unless spheric), flat (H*W, .):
        origins, directions, viewdirs (the directions), near, far."""
        rays = {k: v.reshape(-1, v.shape[-1]) for k, v in pose_rays(
            self.directions, c2w, self.img_wh, self.focal,
            self._near_far(), self.spheric).items()}
        rays["viewdirs"] = rays["directions"]
        return rays

    def __len__(self):
        if self.mode == "train":
            n = len(self.image_paths)
            return (n if self.opt.include_var else n - 1) * \
                self.img_wh[0] * self.img_wh[1]
        if self.mode == "val":
            return max(1, self.opt.val_num)
        if self.mode == "test_train":
            return len(self.poses)
        return len(self._poses_test)

    def ray_buffer(self):
        """All training rays (the val view left out unless
        ``--include_var``), flat: origins, directions, near, far (N, .),
        rgbs (N, 3). The JAX package's ``viewdirs`` field equals
        ``directions`` and is left out. A forward-facing scene's rays come
        from the host C builder (``utils/raygen.py``), as JAX's come from
        its C++; a spheric scene's from ``pose_rays``."""
        if self.mode != "train":
            raise ValueError(f"ray_buffer is the train split's, not "
                             f"{self.mode}'s")
        keep = [i for i in range(len(self.image_paths))
                if self.opt.include_var or i != self.val_idx]
        if self.spheric:
            rays = [self._pose_rays(self.poses[i]) for i in keep]
            out = {k: np.concatenate([r[k] for r in rays])
                   for k in ("origins", "directions", "near", "far")}
        else:
            w, h = self.img_wh
            origins, dirs = raygen.build_rays(
                self.poses[keep], h, w, self.focal,
                self.opt.use_pixel_centers, apply_ndc=True)
            n = origins.shape[0] * h * w
            near, far = self._near_far()
            out = {"origins": origins.reshape(n, 3),
                   "directions": dirs.reshape(n, 3),
                   "near": np.full((n, 1), near, np.float32),
                   "far": np.full((n, 1), far, np.float32)}
        out["rgbs"] = np.concatenate([
            load_image(self.image_paths[i], self.img_wh).reshape(-1, 3)
            for i in keep]).astype(np.float32)
        return out

    def ref_buffer(self, downscale=None):
        """Flat HR rays and colours of the reference view (``--ref_idx``)
        at ``img_wh * downscale`` for the ``--with_ref`` loss: origins,
        directions, viewdirs, near, far, rgbs."""
        ds = downscale or self.opt.downscale
        w, h = self.img_wh
        wh_hr, focal_hr = (w * ds, h * ds), self.focal * ds
        dirs = _ray_dirs_np(h * ds, w * ds, focal_hr,
                            self.opt.use_pixel_centers)
        ref_idx = self.opt.ref_idx
        rays = {k: v.reshape(-1, v.shape[-1]) for k, v in pose_rays(
            dirs, self.poses[ref_idx], wh_hr, focal_hr, self._near_far(),
            self.spheric).items()}
        rays["viewdirs"] = rays["directions"]
        rays["rgbs"] = load_image(self.image_paths[ref_idx], wh_hr).reshape(
            -1, 3).astype(np.float32)
        return rays

    def image_buffer(self):
        """The training rays image by image, (N_img, H, W, C) for each
        field of ``ray_buffer``: patch mode's (``--patch_size`` > 1)
        source of contiguous pixels."""
        return image_buffer(self.ray_buffer(), self.img_wh)

    def eval_raygen_spec(self, idx):
        """Pose + static geometry for device-side eval raygen."""
        return llff_eval_raygen_spec(self, idx)

    def eval_dirs(self):
        """The direction grid in raster order (cached)."""
        return cached_eval_dirs(self)

    def image_rays(self, idx):
        """Host rays of view ``idx`` with its truth (None on a path);
        ``test_viewdir`` renders test pose 10 with pose ``idx``'s view
        directions."""
        if self.mode == "val":
            pose_idx = self.val_idx
            c2w = self.poses[pose_idx]
        elif self.mode == "test_train":
            pose_idx = idx
            c2w = self.poses[idx]
        else:
            pose_idx = None
            c2w = self._poses_test[idx]
        if self.mode == "test_viewdir":
            sample = self._pose_rays(self._poses_test[10])
            sample["viewdirs"] = self._pose_rays(c2w)["directions"]
        else:
            sample = self._pose_rays(c2w)
        sample["c2w"] = c2w
        if pose_idx is not None:
            sample["rgbs"] = load_image(self.image_paths[pose_idx],
                                        self.img_wh).reshape(
                -1, 3).astype(np.float32)
        else:
            sample["rgbs"] = None
        return sample
