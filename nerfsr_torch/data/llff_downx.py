"""The LLFF supersampling dataset (``--dataset_mode llff_downX``).

Port of ``nerfsr_tpu/data/llff_downx.py:LLFFDownXDataset``: the COLMAP
pose pipeline (``data/llff.py``), HR rays at ``img_wh``, NDC-warped for
forward-facing scenes and grouped per LR pixel, LR ground truth by
``--ds_method`` from the HR image (read by the port's PNG reader and
Lanczos-resized to ``img_wh`` when its size differs), HR truth kept
grouped as ``rgbs_ori``. Modes ``train``, ``val``, ``test``,
``test_train``, ``reg_patch`` and ``gan`` (the last two as ``train``);
options ``--use_subset``/``--subset_num``, ``--spheric_poses``,
``--unified_dir``, ``--include_var`` and ``--sisr_path``.

The auxiliary paths' sources: ``ref_buffer`` (``--with_ref``: the
reference view's HR rays and colours, both in the grouped order),
``patch_buffer`` and ``gan_patch`` (host samplers of a ``--reg_patch``
block and of a ``--with_netD`` patch with its real pixels, for a firing
outside a chunk) and ``gan_raygen_buffers`` (the direction grid, the
usable views' poses and the real images, uploaded once, from which a
chunk makes those patches on the device).

``pose_rays_grouped`` and ``load_pair`` are shared with the in-memory
views of ``data/views.py``.
"""

from __future__ import annotations

import os

import numpy as np

from nerfsr_torch.data import register_dataset
from nerfsr_torch.data.downx_common import (downscale, group_subpixels,
                                            lanczos_resize, load_image,
                                            ungroup_subpixels)
from nerfsr_torch.data.llff import (_ray_dirs_np, cached_eval_dirs,
                                    llff_eval_raygen_spec,
                                    load_colmap_scene, pose_rays,
                                    spheric_path, spiral_path)
from nerfsr_torch.utils import image


def pose_rays_grouped(directions, c2w, img_wh, focal, ds, near_far,
                      spheric=False):
    """HR rays of one pose (NDC-warped unless ``spheric``), grouped:
    origins, directions, near, far as (N_lr, ds^2, .)."""
    return {k: group_subpixels(v, ds) for k, v in pose_rays(
        directions, c2w, img_wh, focal, near_far, spheric).items()}


def load_pair(hr_u8, img_wh, ds, ds_method):
    """HR uint8 (H, W, 3) -> HR float (h, w, 3) in [0, 1] at ``img_wh``
    (Lanczos when the size differs) and LR truth (h/ds, w/ds, 3)."""
    if tuple(hr_u8.shape[1::-1]) != tuple(img_wh):
        hr_u8 = lanczos_resize(hr_u8, img_wh)
    lr = downscale(hr_u8, ds, ds_method)
    return hr_u8.astype(np.float32) / 255.0, lr


@register_dataset("llff_downX")
class LLFFDownXDataset:
    """Modes: train, val, test, test_train, reg_patch, gan."""

    MODES = ("train", "val", "test", "test_train", "reg_patch", "gan")

    def __init__(self, opt, mode):
        if mode not in self.MODES:
            raise ValueError(f"llff_downX has no mode {mode!r}; modes: "
                             f"{self.MODES}")
        self.opt = opt
        self.mode = mode
        self.img_wh = tuple(opt.img_wh)  # HR size
        self.ds = opt.downscale
        self.spheric = opt.spheric_poses
        w, h = self.img_wh

        self.poses, self.bounds, self.focal, self.image_paths = \
            load_colmap_scene(opt.dataset_root, self.img_wh)
        dists = np.linalg.norm(self.poses[..., 3], axis=1)
        self.val_idx = int(np.argmin(dists))

        if opt.use_subset:
            self.poses = self.poses[:opt.subset_num]
            self.image_paths = self.image_paths[:opt.subset_num]
            # val_idx is chosen before the subset (as the JAX package
            # does) and clamped into it
            if self.val_idx >= len(self.poses):
                self.val_idx = len(self.poses) - 1

        self.sr_image_paths = None
        if opt.sisr_path:
            self.sr_image_paths = [
                os.path.join(opt.sisr_path, f)
                for f in sorted(os.listdir(opt.sisr_path))
                if f.lower().endswith(("jpg", "jpeg", "png"))]
            if opt.use_subset:
                self.sr_image_paths = self.sr_image_paths[:opt.subset_num]

        if not opt.unified_dir:
            self.directions = _ray_dirs_np(h, w, self.focal,
                                           opt.use_pixel_centers)
        else:
            # every sub-pixel takes its LR pixel's centre direction;
            # focal / ds is true division
            lr_dirs = _ray_dirs_np(h // self.ds, w // self.ds,
                                   self.focal / self.ds,
                                   opt.use_pixel_centers)
            self.directions = np.repeat(
                np.repeat(lr_dirs, self.ds, axis=0), self.ds, axis=1)

        self._poses_test = None
        if mode == "test":
            if not self.spheric:
                radii = np.percentile(
                    np.abs(self.poses[..., 3]), 90, axis=0)
                self._poses_test = spiral_path(radii, focus_depth=3.5)
            else:
                self._poses_test = spheric_path(1.1 * self.bounds.min())

    # ------------------------------------------------------------------
    def _near_far(self):
        if not self.spheric:
            return 0.0, 1.0
        near = float(self.bounds.min())
        return near, float(min(8 * near, self.bounds.max()))

    @property
    def depth_bounds(self):
        return self._near_far()

    def __len__(self):
        if self.mode in ("train", "reg_patch", "gan"):
            n = len(self.image_paths)
            n_eff = n if self.opt.include_var else n - 1
            wl, hl = self.img_wh[0] // self.ds, self.img_wh[1] // self.ds
            return n_eff * wl * hl
        if self.mode == "val":
            return max(1, self.opt.val_num)
        if self.mode == "test_train":
            return len(self.poses)
        return len(self._poses_test)

    def _pose_rays_grouped(self, c2w):
        return pose_rays_grouped(self.directions, c2w, self.img_wh,
                                 self.focal, self.ds, self._near_far(),
                                 self.spheric)

    def _load_pair(self, path):
        """-> HR rgb (h, w, 3) + LR rgb (h/ds, w/ds, 3), floats."""
        return load_pair(image.read_rgb(path), self.img_wh, self.ds,
                         self.opt.ds_method)

    def ray_buffer(self):
        """Grouped training buffer (val view left out unless
        ``--include_var``): origins/directions/near/far (N_lr, ds^2, .),
        rgbs (N_lr, 3), rgbs_ori (N_lr, ds^2, 3) [+ rgbs_sr]."""
        if self.mode != "train":
            raise ValueError(f"ray_buffer is the train split's, not "
                             f"{self.mode}'s")
        keys = ["origins", "directions", "near", "far", "rgbs", "rgbs_ori"]
        if self.sr_image_paths:
            keys.append("rgbs_sr")
        parts = {k: [] for k in keys}
        for i, path in enumerate(self.image_paths):
            if i == self.val_idx and not self.opt.include_var:
                continue
            rays = self._pose_rays_grouped(self.poses[i])
            hr, lr = self._load_pair(path)
            for k in ("origins", "directions", "near", "far"):
                parts[k].append(rays[k])
            parts["rgbs"].append(lr.reshape(-1, 3).astype(np.float32))
            parts["rgbs_ori"].append(
                group_subpixels(hr, self.ds).astype(np.float32))
            if self.sr_image_paths:
                sr = load_image(self.sr_image_paths[i], self.img_wh)
                parts["rgbs_sr"].append(
                    group_subpixels(sr, self.ds).astype(np.float32))
        return {k: np.concatenate(v) for k, v in parts.items()}

    def ref_buffer(self):
        """Flat HR rays and colours of the reference view (``--ref_idx``)
        at ``img_wh`` for the ``--with_ref`` loss. The rays flatten in the
        grouped order, so the colours are grouped the same way before
        they flatten (a raster-order image would pair most rays with
        another pixel's colour)."""
        rays = self._pose_rays_grouped(self.poses[self.opt.ref_idx])
        flat = {k: v.reshape((-1,) + v.shape[2:]) for k, v in rays.items()}
        flat["viewdirs"] = flat["directions"]
        img = load_image(self.image_paths[self.opt.ref_idx], self.img_wh)
        flat["rgbs"] = group_subpixels(img.astype(np.float32),
                                       self.ds).reshape(-1, 3)
        return flat

    def _grouped_rays_for_view(self, i):
        """View ``i``'s grouped rays, built once (the host samplers below
        cut a small block of them at each firing)."""
        cache = self.__dict__.setdefault("_grouped_cache", {})
        if i not in cache:
            cache[i] = self._pose_rays_grouped(self.poses[i])
        return cache[i]

    def _usable_views(self):
        """The training views the auxiliary samplers draw from: the val
        view joins them under ``--include_var``."""
        return [i for i in range(len(self.image_paths))
                if self.opt.include_var or i != self.val_idx]

    def patch_buffer(self, rng, n_patches):
        """``n_patches`` contiguous LR blocks of ``--reg_patch_len``^2
        grouped rays (reg_patch_len^2, ds^2, .), each from a view drawn
        from ``rng`` (a ``numpy.random.RandomState``), its row and column
        uniform over every position the block fits."""
        plen = self.opt.reg_patch_len
        wl, hl = self.img_wh[0] // self.ds, self.img_wh[1] // self.ds
        usable = self._usable_views()
        out = []
        for _ in range(n_patches):
            rays = self._grouped_rays_for_view(
                usable[rng.randint(len(usable))])
            row = rng.randint(hl - plen + 1)
            col = rng.randint(wl - plen + 1)
            idx = ((row + np.arange(plen))[:, None] * wl
                   + (col + np.arange(plen))[None, :]).reshape(-1)
            out.append({k: v[idx] for k, v in rays.items()})
        return out

    def gan_patch(self, rng):
        """One ``--patch_len`` HR patch for the adversarial update: the HR
        rays (patch_len, patch_len, .) of a view drawn from ``rng``, at an
        LR-aligned position whose row and column exclude the last one
        that fits (as the reference's sampler does; at least 1), and the
        real pixels at the same place: of the reference view, or of the
        view itself under ``--all_ref``."""
        plen = self.opt.patch_len
        pl_lr = plen // self.ds
        w, h = self.img_wh
        wl, hl = w // self.ds, h // self.ds
        usable = self._usable_views()
        i = usable[rng.randint(len(usable))]
        r0 = rng.randint(max(1, hl - pl_lr))
        c0 = rng.randint(max(1, wl - pl_lr))
        rays = self._grouped_rays_for_view(i)
        idx = ((r0 + np.arange(pl_lr))[:, None] * wl
               + (c0 + np.arange(pl_lr))[None, :]).reshape(-1)
        patch = {k: ungroup_subpixels(v[idx], (plen, plen), self.ds)
                 for k, v in rays.items()}
        src = self.image_paths[i] if self.opt.all_ref \
            else self.image_paths[self.opt.ref_idx]
        img = load_image(src, self.img_wh)
        patch["rgbs"] = img[r0 * self.ds:r0 * self.ds + plen,
                            c0 * self.ds:c0 * self.ds + plen]
        return patch

    def gan_raygen_buffers(self):
        """What a chunk needs to make the adversarial and ``--reg_patch``
        patches on the device, uploaded once: the HR camera-space
        direction grid ``dirs_hw`` (h, w, 3), the usable views' ``poses``
        (n, 3, 4), the real HR images ``reals`` (the reference view, or
        every usable view under ``--all_ref``) and ``real_idx``, each
        usable view's row of ``reals``. Returns (buffers, geom), geom as
        ``eval_raygen_spec``'s."""
        usable = self._usable_views()
        poses = np.stack([self.poses[i] for i in usable]).astype(np.float32)
        if self.opt.all_ref:
            reals = np.stack([load_image(self.image_paths[i], self.img_wh)
                              for i in usable])
            real_idx = np.arange(len(usable), dtype=np.int32)
        else:
            reals = load_image(self.image_paths[self.opt.ref_idx],
                               self.img_wh)[None]
            real_idx = np.zeros(len(usable), np.int32)
        near, far = self._near_far()
        if self.spheric:
            geom = ("world", float(near), float(far))
        else:
            w, h = self.img_wh
            geom = ("ndc", h, w, float(self.focal), float(near), float(far))
        return {"dirs_hw": self.directions.astype(np.float32),
                "poses": poses,
                "reals": reals.astype(np.float32),
                "real_idx": real_idx}, geom

    def eval_raygen_spec(self, idx):
        """Pose + static geometry for device-side eval raygen."""
        return llff_eval_raygen_spec(self, idx)

    def eval_dirs(self):
        """The direction grid in the grouped flatten order (each LR
        pixel's ds^2 sub-rays contiguous), so device-raygen rows match
        ``image_rays``'s grouped rows."""
        return cached_eval_dirs(self, self.ds)

    def image_rays(self, idx):
        if self.mode == "val":
            pose_idx = self.val_idx
            c2w = self.poses[pose_idx]
        elif self.mode == "test_train":
            pose_idx = idx
            c2w = self.poses[idx]
        else:
            pose_idx = None
            c2w = self._poses_test[idx]
        sample = self._pose_rays_grouped(c2w)
        sample["c2w"] = c2w
        if pose_idx is not None:
            hr, lr = self._load_pair(self.image_paths[pose_idx])
            sample["rgbs"] = lr.reshape(-1, 3).astype(np.float32)
            sample["rgbs_ori"] = group_subpixels(
                hr, self.ds).astype(np.float32)
        else:
            sample["rgbs"] = None
        return sample
