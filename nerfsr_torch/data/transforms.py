"""pix2pix-style image preprocessing (host numpy).

Port of ``nerfsr_tpu/data/transforms.py``: ``get_params``, ``resize``,
``scale_width``, ``make_power_2`` (with its print-once warning),
``crop`` (PIL's zero-padded box), ``flip``, ``to_grayscale`` and
``get_transform``, over HWC numpy images, uint8 or float. No dataset
calls them, in either package.

The JAX package resizes with ``cv2.resize``; the port carries its own,
with cv2's conventions: ``nearest`` takes source pixel ``floor(x *
src / dst)``; ``bilinear``, ``bicubic`` (a = -0.75, 4 taps) and
``lanczos`` (8 taps of sinc(t) sinc(t / 4), normalized) sample at
pixel centres, ``(x + 0.5) * src / dst - 0.5``, and replicate the edge
pixels (bilinear clamps its position into the image first). Like
``cv2.resize``, a one-channel HWC image comes back HW. The sums are
taken in float64; a uint8 image is rounded half up and saturated, where
cv2 sums in 11-bit fixed point (and takes an exact 2x bilinear
reduction as the 2x2 mean), so a uint8 result may differ from cv2's by
one level at some pixels.
"""

from __future__ import annotations

import numpy as np

_WARNED_POWER2 = False


def get_params(preprocess: str, size, load_size: int, crop_size: int,
               rng: np.random.RandomState | None = None):
    """Crop position and flip decision for one image; ``size`` is
    (w, h)."""
    rng = rng or np.random
    w, h = size
    new_w, new_h = w, h
    if preprocess == "resize_and_crop":
        new_w = new_h = load_size
    elif preprocess == "scale_width_and_crop":
        new_w = load_size
        new_h = load_size * h // w
    x = rng.randint(0, max(0, new_w - crop_size) + 1)
    y = rng.randint(0, max(0, new_h - crop_size) + 1)
    flip = rng.rand() > 0.5
    return {"crop_pos": (int(x), int(y)), "flip": bool(flip)}


def _cubic(t):
    a = -0.75
    return [((a * (t + 1) - 5 * a) * (t + 1) + 8 * a) * (t + 1) - 4 * a,
            ((a + 2) * t - (a + 3)) * t * t + 1,
            ((a + 2) * (1 - t) - (a + 3)) * (1 - t) * (1 - t) + 1]


def _taps(src: int, dst: int, method: str):
    """(indices (dst, k), weights (dst, k)) of one axis."""
    x = np.arange(dst, dtype=np.float64)
    if method == "nearest":
        idx = np.minimum(np.floor(x * (1.0 / (dst / src))), src - 1)
        return idx.astype(np.int64)[:, None], np.ones((dst, 1))
    # cv2 rounds the position to f32 before splitting it
    pos = ((x + 0.5) * (1.0 / (dst / src)) - 0.5).astype(np.float32)
    base = np.floor(pos).astype(np.int64)
    t = (pos - base).astype(np.float64)
    if method == "bilinear":
        low, high = base < 0, base >= src - 1
        t[low | high] = 0.0
        base = np.where(low, 0, np.where(high, src - 1, base))
        offsets, w = np.arange(2), np.stack([1.0 - t, t], -1)
    elif method == "bicubic":
        c = _cubic(t)
        offsets = np.arange(-1, 3)
        w = np.stack(c + [1.0 - c[0] - c[1] - c[2]], -1)
    elif method == "lanczos":
        offsets = np.arange(-3, 5)
        d = t[:, None] + 3 - np.arange(8)[None]
        w = np.where(np.abs(d) < 1e-6, 1.0,
                     np.sinc(d) * np.sinc(d / 4.0))
        w = w / w.sum(-1, keepdims=True)
    else:
        raise KeyError(f"unknown interpolation {method!r} (nearest, "
                       "bilinear, bicubic, lanczos)")
    idx = np.clip(base[:, None] + offsets[None], 0, src - 1)
    return idx, w


def _resample(img: np.ndarray, axis: int, dst: int, method: str):
    idx, w = _taps(img.shape[axis], dst, method)
    moved = np.moveaxis(img, axis, 0).astype(np.float64)
    taps = moved[idx]                                    # (dst, k, ...)
    w = w.reshape(w.shape + (1,) * (moved.ndim - 1))
    return np.moveaxis((taps * w).sum(1), 0, axis)


def resize(img: np.ndarray, wh, method: str = "bicubic") -> np.ndarray:
    """``cv2.resize(img, wh, interpolation)`` of an HW or HWC image."""
    w, h = (int(v) for v in wh)
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[..., 0]
    out = _resample(_resample(img, 1, w, method), 0, h, method)
    if np.issubdtype(img.dtype, np.integer):
        info = np.iinfo(img.dtype)
        out = np.clip(np.floor(out + 0.5), info.min, info.max)
    return out.astype(img.dtype)


def scale_width(img: np.ndarray, target_size: int, crop_size: int,
                method: str = "bicubic") -> np.ndarray:
    """Width to ``target_size``, height in proportion but at least
    ``crop_size``; unchanged when the width is already the target and
    the height at least the crop."""
    h, w = img.shape[:2]
    if w == target_size and h >= crop_size:
        return img
    new_h = int(max(target_size * h / w, crop_size))
    return resize(img, (target_size, new_h), method)


def make_power_2(img: np.ndarray, base: int = 4,
                 method: str = "bicubic") -> np.ndarray:
    """Height and width rounded to multiples of ``base``; says so once."""
    global _WARNED_POWER2
    h, w = img.shape[:2]
    nh = int(round(h / base) * base)
    nw = int(round(w / base) * base)
    if nh == h and nw == w:
        return img
    if not _WARNED_POWER2:
        print(f"The image size needs to be a multiple of {base}. "
              f"The loaded image size was ({w}, {h}), so it was adjusted "
              f"to ({nw}, {nh}).")
        _WARNED_POWER2 = True
    return resize(img, (nw, nh), method)


def crop(img: np.ndarray, pos, size: int) -> np.ndarray:
    """A ``size`` x ``size`` box at ``pos`` (x, y), zero where it leaves
    the image (PIL's ``Image.crop``), when either side exceeds ``size``;
    else the image as it is."""
    h, w = img.shape[:2]
    x, y = pos
    if w > size or h > size:
        out = np.zeros((size, size) + img.shape[2:], img.dtype)
        sub = img[y:y + size, x:x + size]
        out[:sub.shape[0], :sub.shape[1]] = sub
        return out
    return img


def flip(img: np.ndarray, do_flip: bool) -> np.ndarray:
    return img[:, ::-1] if do_flip else img


def to_grayscale(img: np.ndarray) -> np.ndarray:
    """ITU-R 601 luma, HWC with one channel, in the image's dtype (a
    uint8 value truncated)."""
    f = img.astype(np.float32)
    g = 0.299 * f[..., 0] + 0.587 * f[..., 1] + 0.114 * f[..., 2]
    return g[..., None].astype(img.dtype)


def get_transform(preprocess: str = "resize_and_crop",
                  load_size: int = 286, crop_size: int = 256,
                  no_flip: bool = False, params: dict | None = None,
                  grayscale: bool = False, method: str = "bicubic",
                  convert: bool = True,
                  rng: np.random.RandomState | None = None):
    """The pipeline as one callable over an HWC image: grayscale, resize
    or scale_width, crop, make_power_2 (``preprocess == "none"``), flip,
    then (``convert``) float32 in (-1, 1). ``params`` fixes the crop and
    flip; without them each call draws its own from ``rng``."""
    rng = rng or np.random

    def apply(img: np.ndarray) -> np.ndarray:
        p = params
        if p is None and ("crop" in preprocess or not no_flip):
            h, w = img.shape[:2]
            p = get_params(preprocess, (w, h), load_size, crop_size,
                           rng if isinstance(rng, np.random.RandomState)
                           else None)
        out = to_grayscale(img) if grayscale else img
        if "resize" in preprocess:
            out = resize(out, (load_size, load_size), method)
        elif "scale_width" in preprocess:
            out = scale_width(out, load_size, crop_size, method)
        if "crop" in preprocess:
            out = crop(out, p["crop_pos"], crop_size)
        if preprocess == "none":
            out = make_power_2(out, base=4, method=method)
        if not no_flip:
            out = flip(out, p["flip"])
        if out.ndim == 2:
            out = out[..., None]
        if convert:
            f = out.astype(np.float32)
            if np.issubdtype(out.dtype, np.integer):
                f = f / 255.0
            out = f * 2.0 - 1.0
        return np.ascontiguousarray(out)

    return apply
