"""The refine stage's dataset (``--dataset_mode llff_refine``).

Port of ``nerfsr_tpu/data/refine.py``. Modes:

- train: the reference view (``--ref_idx``) and its NeRF-SR synthesis
  ``{ref_idx}-fine-ori.png`` from ``--syn_dataroot``, plus ``--aug_num``
  - 1 random perspective warps of both, each with the bounding box of
  its valid region; ``device_buffers`` gives the stacks for the
  system's device sampler, ``sample_train_batch`` samples on the host
  with the same rules.
- val: random aligned patches of every (truth, synthesis) pair
  (``sample_val_item``).
- test_train / test: every image tiled into ``--patch_len`` patches,
  each with the reference patches that the warp's ``{i}_locs.npz``
  correspondences point at (``tiles_for_image``).

Images are in (-1, 1). The perspective warps are the port's own
(``get_perspective_transform``: the 8x8 system solved in float64;
``warp_perspective``: an inverse map, bilinear, border 0, in float64
coordinates), in place of cv2's. The warp parameters are drawn from
``np.random.RandomState(--seed)`` in the JAX package's order, so its
corners are the same numbers.
"""

from __future__ import annotations

import os

import numpy as np

from nerfsr_torch.data import register_dataset
from nerfsr_torch.data.colmap import read_model
from nerfsr_torch.data.downx_common import load_image
from nerfsr_torch.utils import png


def _to_norm(img):
    """[0, 1] float -> (-1, 1)."""
    return (img * 2.0 - 1.0).astype(np.float32)


def random_perspective_params(w, h, distortion_scale, rng):
    """Random corner displacements (torchvision's RandomPerspective
    scheme): each corner moves uniformly within distortion_scale *
    (w/2, h/2) toward the center. Returns (start, end), (4, 2) f32."""
    half_w = int(distortion_scale * w // 2)
    half_h = int(distortion_scale * h // 2)
    tl = [rng.randint(0, half_w + 1), rng.randint(0, half_h + 1)]
    tr = [w - 1 - rng.randint(0, half_w + 1), rng.randint(0, half_h + 1)]
    br = [w - 1 - rng.randint(0, half_w + 1),
          h - 1 - rng.randint(0, half_h + 1)]
    bl = [rng.randint(0, half_w + 1), h - 1 - rng.randint(0, half_h + 1)]
    start = np.array([[0, 0], [w - 1, 0], [w - 1, h - 1], [0, h - 1]],
                     np.float32)
    end = np.array([tl, tr, br, bl], np.float32)
    return start, end


def get_perspective_transform(src, dst):
    """The 3x3 homography (float64, [2, 2] = 1) that maps the four
    points ``src`` onto ``dst``: cv2's 8x8 linear system."""
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    a = np.zeros((8, 8))
    b = np.zeros(8)
    for i in range(4):
        (x, y), (u, v) = src[i], dst[i]
        a[i] = [x, y, 1, 0, 0, 0, -x * u, -y * u]
        a[i + 4] = [0, 0, 0, x, y, 1, -x * v, -y * v]
        b[i], b[i + 4] = u, v
    return np.append(np.linalg.solve(a, b), 1.0).reshape(3, 3)


def _warp_map(start, end, wh):
    """For each output pixel the four bilinear taps of its source point
    (the homography inverted, float64): flat indices (4, H*W) and weights
    (4, H*W), a tap outside the image weighted 0 (border 0)."""
    w, h = wh
    minv = np.linalg.inv(get_perspective_transform(start, end))
    xs, ys = np.meshgrid(np.arange(w, dtype=np.float64),
                         np.arange(h, dtype=np.float64))
    xs, ys = xs.ravel(), ys.ravel()
    den = minv[2, 0] * xs + minv[2, 1] * ys + minv[2, 2]
    den = np.divide(1.0, den, out=np.zeros_like(den), where=den != 0)
    sx = (minv[0, 0] * xs + minv[0, 1] * ys + minv[0, 2]) * den
    sy = (minv[1, 0] * xs + minv[1, 1] * ys + minv[1, 2]) * den
    x0, y0 = np.floor(sx), np.floor(sy)
    fx, fy = sx - x0, sy - y0
    idx, wts = [], []
    for dy, wy in ((0, 1 - fy), (1, fy)):
        for dx, wx in ((0, 1 - fx), (1, fx)):
            xi, yi = x0 + dx, y0 + dy
            inside = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
            idx.append(np.where(inside, yi * w + xi, 0).astype(np.int64))
            wts.append(np.where(inside, wx * wy, 0.0))
    return np.stack(idx), np.stack(wts)


def _apply_map(img, idx, wts):
    """The weighted sum of each output pixel's four taps, in f32."""
    h, w = img.shape[:2]
    flat = np.asarray(img, np.float32).reshape(h * w, -1)
    w32 = wts.astype(np.float32)
    out = w32[0][:, None] * flat[idx[0]]
    for t in range(1, 4):
        out += w32[t][:, None] * flat[idx[t]]
    return out.reshape(img.shape)


def warp_perspective(img, start, end):
    """``img`` (H, W[, C]) warped by the homography that maps ``start``
    onto ``end``: each output pixel samples its source point bilinearly,
    0 outside the image."""
    h, w = img.shape[:2]
    return _apply_map(img, *_warp_map(start, end, (w, h)))


def _valid_box(wts, wh):
    """(x0, y0, x1, y1) around the output pixels whose taps inside the
    image weigh more than 0.5 (a warped image of ones above 0.5)."""
    w, h = wh
    ys, xs = np.nonzero(wts.sum(0).reshape(h, w) > 0.5)
    if len(xs) == 0:
        return np.array([0, 0, w, h])
    return np.array([xs.min(), ys.min(), xs.max() + 1, ys.max() + 1])


def valid_bbox(start, end, wh):
    """Bounding box (x0, y0, x1, y1) of the warped image's valid region."""
    return _valid_box(_warp_map(start, end, wh)[1], wh)


@register_dataset("llff_refine")
class LLFFRefineDataset:
    """Modes: train, val, test_train, test."""

    MODES = ("train", "val", "test_train", "test")

    def __init__(self, opt, mode):
        if mode not in self.MODES:
            raise ValueError(f"llff_refine has no mode {mode!r}; modes: "
                             f"{self.MODES}")
        self.opt = opt
        self.mode = mode
        self.img_wh = tuple(opt.img_wh)
        self.plen = opt.patch_len
        self.rng = np.random.RandomState(opt.seed)

        # the image list comes from the COLMAP model, as the llff
        # datasets' does
        _, imdata, _ = read_model(os.path.join(opt.dataset_root, "sparse/0"))
        names = sorted(im.name for im in imdata.values())
        self.image_paths = [
            os.path.join(opt.dataset_root, "images", n) for n in names]
        self.ref_idx = opt.ref_idx

        if mode == "train":
            self._setup_train()
        elif mode in ("val", "test_train"):
            self._load_pairs()
            if mode == "test_train":
                self.locs = np.stack([
                    self._load_locs(i) for i in range(len(self.image_paths))])
        else:  # test: spiral-path syntheses; ref = the reference view
            self.sr_imgs = np.stack([
                self._load_syn(i) for i in range(self._n_test_syn())])
            self.ref_img = self._load_gt(self.image_paths[self.ref_idx])
            self.locs = np.stack([
                self._load_locs(i) for i in range(len(self.sr_imgs))])

    # -- loading ---------------------------------------------------------
    def _load_gt(self, path):
        return _to_norm(load_image(path, self.img_wh))

    def _load_syn(self, idx):
        """The synthesis' first ``img_wh`` panel (the file may be a strip
        of panels), alpha dropped; pixels past the file's edge are 0."""
        rgb = png.read_rgb(os.path.join(self.opt.syn_dataroot,
                                        f"{idx}-fine-ori.png"))
        w, h = self.img_wh
        img = np.zeros((h, w, 3), np.uint8)
        crop = rgb[:h, :w]
        img[:crop.shape[0], :crop.shape[1]] = crop
        return _to_norm(img.astype(np.float32) / 255.0)

    def _load_locs(self, idx):
        z = np.load(os.path.join(self.opt.syn_dataroot, f"{idx}_locs.npz"))
        key = "arr_0" if "arr_0" in z else list(z.keys())[0]
        return z[key]

    def _n_test_syn(self):
        n = 0
        while os.path.exists(os.path.join(self.opt.syn_dataroot,
                                          f"{n}-fine-ori.png")):
            n += 1
        return n

    def _setup_train(self):
        w, h = self.img_wh
        gt = self._load_gt(self.image_paths[self.ref_idx])
        sr = self._load_syn(self.ref_idx)
        n = self.opt.aug_num
        self.gt_imgs = np.empty((max(n, 1), h, w, 3), np.float32)
        self.sr_imgs = np.empty_like(self.gt_imgs)
        self.bboxes = np.empty((max(n, 1), 4), np.int64)
        self.gt_imgs[0], self.sr_imgs[0] = gt, sr
        self.bboxes[0] = [0, 0, w, h]
        both = np.concatenate([gt, sr], -1)     # one gather for the two
        for a in range(1, n):
            start, end = random_perspective_params(
                w, h, self.opt.distort_scale, self.rng)
            idx, wts = _warp_map(start, end, self.img_wh)
            warped = _apply_map(both, idx, wts)
            self.gt_imgs[a], self.sr_imgs[a] = warped[..., :3], warped[..., 3:]
            self.bboxes[a] = _valid_box(wts, self.img_wh)
        self.gt_img = gt

    def device_buffers(self):
        """The train-mode stacks that the system's device sampler cuts
        patches from (uploaded once)."""
        return {
            "sr_imgs": self.sr_imgs,
            "gt_imgs": self.gt_imgs,
            "gt_img": self.gt_img,
            "bboxes": np.asarray(self.bboxes, np.int32),
        }

    def _load_pairs(self):
        self.gt_imgs = np.stack([self._load_gt(p) for p in self.image_paths])
        self.sr_imgs = np.stack([self._load_syn(i)
                                 for i in range(len(self.image_paths))])
        self.ref_img = self.gt_imgs[self.ref_idx]

    # -- sampling --------------------------------------------------------
    def __len__(self):
        if self.mode == "train":
            return int(self.opt.data_num)
        if self.mode == "val":
            return len(self.image_paths)
        if self.mode == "test_train":
            return len(self.image_paths) * self.opt.test_img_split
        return len(self.sr_imgs) * self.opt.test_img_split

    def sample_train_batch(self, batch_size):
        """A random train batch on the host: an SR/GT patch inside a
        random augmented view's valid box and ``--num_ref_patches``
        nearby patches of the reference view."""
        plen = self.plen
        k = self.opt.num_ref_patches
        off = self.opt.ref_offset
        rng = self.rng
        sr_p = np.empty((batch_size, plen, plen, 3), np.float32)
        gt_p = np.empty_like(sr_p)
        ref_p = np.empty((batch_size, k, plen, plen, 3), np.float32)
        for b in range(batch_size):
            i = rng.randint(len(self.sr_imgs))
            x0, y0, x1, y1 = self.bboxes[i]
            xs = rng.randint(x0, max(x0 + 1, x1 - plen))
            ys = rng.randint(y0, max(y0 + 1, y1 - plen))
            sr_p[b] = self.sr_imgs[i][ys:ys + plen, xs:xs + plen]
            gt_p[b] = self.gt_imgs[i][ys:ys + plen, xs:xs + plen]
            rxl = max(x0, xs - off)
            rxh = min(x1 - plen, xs + off)
            ryl = max(y0, ys - off)
            ryh = min(y1 - plen, ys + off)
            for j in range(k):
                rx = rng.randint(rxl, max(rxl + 1, rxh))
                ry = rng.randint(ryl, max(ryl + 1, ryh))
                ref_p[b, j] = self.gt_img[ry:ry + plen, rx:rx + plen]
            if self.opt.with_gt_patch:
                ref_p[b, rng.randint(k)] = gt_p[b]
        return {"sr_patch": sr_p, "ref_patches": ref_p, "gt_patch": gt_p}

    def sample_val_item(self, idx):
        """One random aligned patch triple of image ``idx``."""
        plen = self.plen
        w, h = self.img_wh
        rng = self.rng
        i = idx % len(self.image_paths)
        # max(1, .): a patch as wide as the image starts at 0
        xs = rng.randint(0, max(1, w - plen))
        ys = rng.randint(0, max(1, h - plen))
        k = self.opt.num_ref_patches
        ref_p = np.empty((k, plen, plen, 3), np.float32)
        rxl, rxh = max(0, xs - plen), min(w - plen, xs + plen)
        ryl, ryh = max(0, ys - plen), min(h - plen, ys + plen)
        for j in range(k):
            rx = rng.randint(rxl, max(rxl + 1, rxh))
            ry = rng.randint(ryl, max(ryl + 1, ryh))
            ref_p[j] = self.ref_img[ry:ry + plen, rx:rx + plen]
        return {
            "sr_patch": self.sr_imgs[i][ys:ys + plen, xs:xs + plen][None],
            "gt_patch": self.gt_imgs[i][ys:ys + plen, xs:xs + plen][None],
            "ref_patches": ref_p[None],
        }

    def tiles_for_image(self, img_idx):
        """Every patch of one image, with its reference patches and its
        start location for stitching. A tile's reference patches sit at
        its first k valid correspondences, scanned column-major (x outer,
        y inner) over every pixel of the tile; missing ones are the SR
        patch itself. (The JAX package reshapes the warp's 3-channel locs
        to pairs, so it scans every other pixel; on 2-channel locs the
        two agree.)"""
        plen = self.plen
        w, h = self.img_wh
        k = self.opt.num_ref_patches
        sr_img = self.sr_imgs[img_idx]
        gt_img = self.gt_imgs[img_idx] if self.mode != "test" else None
        locs = self.locs[img_idx]

        srs, gts, refs, starts = [], [], [], []
        for i in range(0, w, plen):
            for j in range(0, h, plen):
                xs = min(w - plen, i)
                ys = min(h - plen, j)
                starts.append((xs, ys))
                srs.append(sr_img[ys:ys + plen, xs:xs + plen])
                if gt_img is not None:
                    gts.append(gt_img[ys:ys + plen, xs:xs + plen])
                block = locs[ys:ys + plen, xs:xs + plen]   # [y, x, 3]
                flat = block.transpose(1, 0, 2).reshape(-1, block.shape[-1])
                valid = ((flat[:, 0] >= 0) & (flat[:, 0] < w)
                         & (flat[:, 1] >= 0) & (flat[:, 1] < h))
                ref_patch = []
                for loc in flat[valid][:k]:
                    rx = min(w - plen, int(loc[0]))
                    ry = min(h - plen, int(loc[1]))
                    ref_patch.append(self.ref_img[ry:ry + plen, rx:rx + plen])
                while len(ref_patch) < k:
                    ref_patch.append(sr_img[ys:ys + plen, xs:xs + plen])
                refs.append(np.stack(ref_patch))
        out = {
            "sr_patch": np.stack(srs).astype(np.float32),
            "ref_patches": np.stack(refs).astype(np.float32),
            "start_locs": np.array(starts, np.int32),
            "wh": np.array(self.img_wh, np.int32),
            "patch_len": plen,
        }
        if gt_img is not None:
            out["gt_patch"] = np.stack(gts).astype(np.float32)
        return out

    def n_images(self):
        if self.mode == "test":
            return len(self.sr_imgs)
        return len(self.image_paths)
