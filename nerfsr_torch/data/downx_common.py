"""Sub-pixel grouping, downscaling and resampling of the supersampling
datasets.

Port of ``nerfsr_tpu/data/downx_common.py``: ``group_subpixels`` /
``ungroup_subpixels`` (the einops order ``'(h s1) (w s2) c -> (h w)
(s1 s2) c'``), ``blend_white``, and ``downscale`` by ``--ds_method``
(``avg``: block means; ``lanc``: Lanczos).

``lanczos_resize`` is PIL's ``Image.resize(size, Image.LANCZOS)`` for
uint8 images (``libImaging/Resample.c``) in host C
(``nerfsr_torch/csrc_host/resample.c``, built by ``utils/hostlib.py`` at
first use): a separable filter of support 3 x scale, coefficients
normalized in double and rounded to 22-bit fixed point, the horizontal
pass first and then the vertical, each output clipped to uint8 (so the
vertical pass reads the clipped horizontal result). Images with alpha
(LA, RGBA) go through PIL's premultiplied modes (``libImaging/Convert.c``)
around the filter. It gives PIL's bytes. ``_lanczos_resize_np`` is the
same filter in numpy, kept as the tests' oracle.

``load_image`` reads an image file (PNG or JPEG) the way the datasets'
``load_image`` does: Lanczos to the working size, gray repeated, alpha
blended over white after the resize (or kept).
"""

from __future__ import annotations

import ctypes
import math

import numpy as np

from nerfsr_torch.utils import hostlib, image

PRECISION_BITS = 32 - 8 - 2       # PIL's fixed-point precision
_LANCZOS_SUPPORT = 3.0


def group_subpixels(arr: np.ndarray, ds: int) -> np.ndarray:
    """(H, W, C) -> (H/ds * W/ds, ds*ds, C): each LR pixel's ds^2 HR
    sub-elements, row-major within the block."""
    h, w = arr.shape[:2]
    c = arr.shape[2:]
    x = arr.reshape((h // ds, ds, w // ds, ds) + c)
    x = np.moveaxis(x, 1, 2)  # (h1, w1, ds, ds, C)
    return x.reshape((h // ds * (w // ds), ds * ds) + c)


def ungroup_subpixels(arr: np.ndarray, hw, ds: int) -> np.ndarray:
    """Inverse of ``group_subpixels``: (N_lr, ds^2, C) -> (H, W, C)."""
    h, w = hw
    c = arr.shape[2:]
    x = arr.reshape((h // ds, w // ds, ds, ds) + c)
    x = np.moveaxis(x, 2, 1)
    return x.reshape((h, w) + c)


def blend_white(arr: np.ndarray) -> np.ndarray:
    """RGBA -> RGB over white (the blender convention)."""
    if arr.shape[-1] == 4:
        rgb, a = arr[..., :3], arr[..., 3:]
        return rgb * a + (1.0 - a)
    return arr


def _lanczos(x: float) -> float:
    def sinc(v):
        if v == 0.0:
            return 1.0
        v = v * math.pi
        return math.sin(v) / v
    if -3.0 <= x < 3.0:
        return sinc(x) * sinc(x / 3)
    return 0.0


def _coeffs(in_size: int, out_size: int):
    """PIL's ``precompute_coeffs`` + ``normalize_coeffs_8bpc`` for the
    Lanczos filter over the whole input: (first source index (out,),
    fixed-point weights (out, ksize) int64, zero past each window)."""
    scale = float(in_size) / out_size
    filterscale = max(scale, 1.0)
    support = _LANCZOS_SUPPORT * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    first = np.zeros(out_size, np.int64)
    kk = np.zeros((out_size, ksize), np.int64)
    ss = 1.0 / filterscale
    one = float(1 << PRECISION_BITS)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        w = [_lanczos((x + xmin - center + 0.5) * ss) for x in range(xmax)]
        total = 0.0
        for v in w:
            total += v
        for x, v in enumerate(w):
            if total != 0.0:
                v /= total
            # C's (int) truncates toward zero
            kk[xx, x] = int(-0.5 + v * one) if v < 0 else int(0.5 + v * one)
        first[xx] = xmin
    return first, kk


def _resample_axis(img: np.ndarray, out_size: int, axis: int,
                   block: int = 64) -> np.ndarray:
    """One pass along ``axis`` (0 rows, 1 columns) of an (H, W, C) uint8
    image, clipped to uint8; rows of the other axis go ``block`` at a
    time to bound the gather's memory."""
    in_size = img.shape[axis]
    first, kk = _coeffs(in_size, out_size)
    idx = np.minimum(first[:, None] + np.arange(kk.shape[1]), in_size - 1)
    src = np.moveaxis(img, axis, 0).astype(np.int64)   # (in, other, C)
    out = np.empty((out_size,) + src.shape[1:], np.uint8)
    half = 1 << (PRECISION_BITS - 1)
    for s in range(0, src.shape[1], block):
        part = src[:, s:s + block]                      # (in, b, C)
        acc = np.einsum("okbc,ok->obc", part[idx], kk) + half
        out[:, s:s + block] = np.clip(acc >> PRECISION_BITS, 0, 255)
    return np.moveaxis(out, 0, axis)


def premultiply(img: np.ndarray) -> np.ndarray:
    """PIL's RGBA -> RGBa (and LA -> La) of a uint8 image whose last
    channel is alpha: each colour channel c becomes c * a / 255, rounded
    as ``MULDIV255`` (t = c a + 128; (t / 256 + t) / 256, integer)."""
    x = img.astype(np.int64)
    t = x[..., :-1] * x[..., -1:] + 128
    return np.concatenate([((t >> 8) + t) >> 8, x[..., -1:]],
                          -1).astype(np.uint8)


def unpremultiply(img: np.ndarray) -> np.ndarray:
    """PIL's RGBa -> RGBA (and La -> LA): c * 255 / a in integers,
    truncated and clipped to 255; a colour with alpha 0 or 255 is kept."""
    x = img.astype(np.int64)
    a = x[..., -1:]
    c = np.minimum(x[..., :-1] * 255 // np.maximum(a, 1), 255)
    c = np.where((a == 0) | (a == 255), x[..., :-1], c)
    return np.concatenate([c, a], -1).astype(np.uint8)


def _resize_np(x: np.ndarray, w: int, h: int) -> np.ndarray:
    if x.shape[1] != w:              # horizontal pass first, as PIL
        x = _resample_axis(x, w, axis=1)
    if x.shape[0] != h:
        x = _resample_axis(x, h, axis=0)
    return x


def _host_lib() -> ctypes.CDLL:
    h = hostlib.lib()
    if h.nerfsr_lanczos_resize.argtypes is None:
        h.nerfsr_lanczos_resize.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
        h.nerfsr_lanczos_resize.restype = ctypes.c_int
    return h


def _resize_c(x: np.ndarray, w: int, h: int) -> np.ndarray:
    x = np.ascontiguousarray(x)
    out = np.empty((h, w, x.shape[2]), np.uint8)
    rc = _host_lib().nerfsr_lanczos_resize(
        x.ctypes.data, x.shape[1], x.shape[0], x.shape[2], out.ctypes.data,
        w, h)
    if rc == -1:
        raise MemoryError("lanczos_resize: out of memory")
    if rc:
        raise ValueError(f"lanczos_resize: {x.shape} -> ({h}, {w}) refused")
    return out


def _premultiplied_resize(img, size, resize) -> np.ndarray:
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise TypeError(f"lanczos_resize takes uint8 pixels, got "
                        f"{img.dtype}")
    gray = img.ndim == 2
    x = img[..., None] if gray else img
    w, h = int(size[0]), int(size[1])
    if x.shape[:2] == (h, w):
        return img.copy()
    alpha = x.shape[-1] in (2, 4)
    if alpha:
        x = premultiply(x)
    x = resize(x, w, h)
    if alpha:
        x = unpremultiply(x)
    return x[..., 0] if gray else x


def lanczos_resize(img: np.ndarray, size) -> np.ndarray:
    """PIL's ``Image.resize(size, Image.LANCZOS)`` of a uint8 (H, W) or
    (H, W, C) image (C 1-4), in host C; ``size`` is (w, h) as PIL takes
    it. Every channel is filtered alike, as PIL does for L and RGB; an LA
    or RGBA image (2 or 4 channels, alpha last) is premultiplied first
    and unpremultiplied after, as PIL resizes it (through La / RGBa)."""
    return _premultiplied_resize(img, size, _resize_c)


def _lanczos_resize_np(img: np.ndarray, size) -> np.ndarray:
    """``lanczos_resize`` in numpy: the tests' oracle for the C."""
    return _premultiplied_resize(img, size, _resize_np)


def read_pixels(path) -> np.ndarray:
    """An image file's (PNG or JPEG) uint8 pixels (H, W[, C]), a palette
    looked up (with its alpha)."""
    img = image.read(path)
    px = img.pixels
    if img.mode == "P":
        px = np.concatenate([img.palette, img.palette_alpha[:, None]],
                            1)[px]
    return px


def load_image(path, wh, keep_alpha: bool = False) -> np.ndarray:
    """An image as float in [0, 1] at ``wh`` (``load_image`` of the JAX
    package): Lanczos when the size differs (premultiplied, as PIL, when
    it has alpha), gray repeated, and alpha blended over white after the
    resize, or kept as a fourth channel with ``keep_alpha``."""
    px = read_pixels(path)
    if tuple(px.shape[1::-1]) != tuple(wh):
        px = lanczos_resize(px, wh)
    arr = px.astype(np.float32) / 255.0
    if arr.ndim == 2:
        arr = np.repeat(arr[..., None], 3, -1)
    elif arr.shape[-1] == 2:
        arr = np.concatenate([np.repeat(arr[..., :1], 3, -1),
                              arr[..., 1:]], -1)
    return arr if keep_alpha else blend_white(arr)


def downscale(img: np.ndarray, ds: int, method: str) -> np.ndarray:
    """LR ground truth of an HR image by ``--ds_method``, as float32 in
    [0, 1] with the image's channels (``downscale_pil`` of the JAX
    package). ``lanc``: Lanczos to (W/ds, H/ds) of a uint8 image. ``avg``:
    the mean of each ds x ds block (rows and columns past a multiple of
    ds dropped) of a uint8 image / 255 or of a float image in [0, 1]."""
    img = np.asarray(img)
    h, w = img.shape[:2]
    if method == "lanc":
        if img.dtype != np.uint8:
            raise ValueError("--ds_method lanc resamples uint8 pixels, as "
                             "PIL does; got " + str(img.dtype))
        return lanczos_resize(img, (w // ds, h // ds)).astype(
            np.float32) / 255.0
    if method != "avg":
        raise ValueError(f"unknown --ds_method {method}")
    arr = img.astype(np.float32) / 255.0 if img.dtype == np.uint8 \
        else img.astype(np.float32)
    if arr.ndim == 2:
        arr = arr[..., None]
    arr = arr[:(h // ds) * ds, :(w // ds) * ds]
    return arr.reshape(h // ds, ds, w // ds, ds, -1).mean((1, 3))
