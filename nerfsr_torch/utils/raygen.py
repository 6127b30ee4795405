"""The LLFF dataset's training rays built in host C.

``build_rays`` is the port's counterpart of the JAX package's
``nerfsr_tpu/native`` ``build_rays``: the C source
(``nerfsr_torch/csrc_host/raygen.c``) is part of the host library that
``utils/hostlib.py`` builds at first use, and a failed build raises. It
gives what ``data/llff.py:pose_rays`` gives for a stack of poses, to
rounding (the C sums the rotation in its own order).
"""

from __future__ import annotations

import ctypes

import numpy as np

from nerfsr_torch.utils import hostlib

_state = {"lib": None}


def lib() -> ctypes.CDLL:
    """The host library with ``nerfsr_build_rays`` bound."""
    if _state["lib"] is None:
        h = hostlib.lib()
        fp = ctypes.c_void_p
        h.nerfsr_build_rays.argtypes = [
            fp, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
            ctypes.c_int, ctypes.c_int, ctypes.c_float, fp, fp, ctypes.c_int]
        h.nerfsr_build_rays.restype = ctypes.c_int
        _state["lib"] = h
    return _state["lib"]


def build_rays(c2w: np.ndarray, h: int, w: int, focal: float,
               use_pixel_centers: bool = True, apply_ndc: bool = False,
               ndc_near: float = 1.0, n_threads: int = 0):
    """(n_img, 3, 4) poses -> origins, directions, each (n_img, h, w, 3)
    f32: unit world directions and the camera centres, NDC-warped with
    ``apply_ndc``. ``n_threads`` <= 0 takes every core."""
    c2w = np.ascontiguousarray(c2w, np.float32)
    n_img = c2w.shape[0]
    origins = np.empty((n_img, h, w, 3), np.float32)
    dirs = np.empty((n_img, h, w, 3), np.float32)
    if lib().nerfsr_build_rays(
            c2w.ctypes.data, n_img, h, w, float(focal),
            int(use_pixel_centers), int(apply_ndc), float(ndc_near),
            origins.ctypes.data, dirs.ctypes.data, int(n_threads)) != 0:
        raise MemoryError("build_rays: out of memory")
    return origins, dirs
