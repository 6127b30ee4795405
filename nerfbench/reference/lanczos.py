"""PIL's ``Image.resize(size, Image.LANCZOS)`` of an 8-bit RGB image, in
numpy: the LR ground truth that ``--ds_method lanc`` gives (NeRF-SR's
``downscale_pil``). Integer arithmetic, so it gives PIL's bytes.

A frozen copy of the numpy Lanczos that ``nerfsr_torch`` keeps as the
oracle of its host C (``data/downx_common.py``), so that a change to the
program cannot move the benchmark's targets.
"""

from __future__ import annotations

import math

import numpy as np

PRECISION_BITS = 32 - 8 - 2       # PIL's fixed-point precision
SUPPORT = 3.0


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
    """PIL's ``precompute_coeffs`` + ``normalize_coeffs_8bpc``: (first
    source index (out,), fixed-point weights (out, ksize))."""
    scale = float(in_size) / out_size
    filterscale = max(scale, 1.0)
    support = SUPPORT * filterscale
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
            kk[xx, x] = int(-0.5 + v * one) if v < 0 else int(0.5 + v * one)
        first[xx] = xmin
    return first, kk


def _resample_axis(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    in_size = img.shape[axis]
    first, kk = _coeffs(in_size, out_size)
    idx = np.minimum(first[:, None] + np.arange(kk.shape[1]), in_size - 1)
    src = np.moveaxis(img, axis, 0).astype(np.int64)
    acc = np.einsum("okbc,ok->obc", src[idx], kk) + (1 << (PRECISION_BITS - 1))
    out = np.clip(acc >> PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def lanczos_downscale(img: np.ndarray, ds: int) -> np.ndarray:
    """uint8 (H, W, 3) -> uint8 (H // ds, W // ds, 3): the horizontal pass
    first, as PIL."""
    h, w = img.shape[:2]
    x = np.asarray(img, np.uint8)
    if x.shape[1] != w // ds:
        x = _resample_axis(x, w // ds, axis=1)
    if x.shape[0] != h // ds:
        x = _resample_axis(x, h // ds, axis=0)
    return x
