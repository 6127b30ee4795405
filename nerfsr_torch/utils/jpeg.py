"""JPEG decoding on the host, to the bytes PIL gives.

The decoder is C (``nerfsr_torch/csrc_host/jpeg_decode.c``), part of the
host library that ``utils/hostlib.py`` builds at first use and binds with
``ctypes``. It decodes baseline, extended sequential and progressive
Huffman JPEGs of 8-bit samples as libjpeg-turbo does with the defaults
PIL leaves it (islow IDCT, fancy upsampling, no merged upsampler), so
``decode`` equals ``np.asarray(Image.open(f))`` byte for byte. What it
does not cover (arithmetic coding, 12-bit samples, lossless and
hierarchical frames, CMYK/YCCK, sampling layouts other than 4:4:4, 4:2:2,
4:2:0 and gray) raises ``ValueError`` by name, as do truncated and
corrupt files.
"""

from __future__ import annotations

import ctypes
from typing import Tuple, Union

import numpy as np

from nerfsr_torch.utils import hostlib

SOI = b"\xff\xd8\xff"
MODES = {1: "L", 3: "RGB"}
ERRCAP = 256

_state = {"lib": None}
Bytes = Union[bytes, bytearray, memoryview]


def lib() -> ctypes.CDLL:
    """The host library with the decoder's functions bound (built at
    first use)."""
    if _state["lib"] is None:
        h = hostlib.lib()
        h.nerfsr_jpeg_header.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.POINTER(ctypes.c_int32),
            ctypes.c_char_p, ctypes.c_size_t]
        h.nerfsr_jpeg_decode.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p,
            ctypes.c_size_t, ctypes.c_char_p, ctypes.c_size_t]
        h.nerfsr_jpeg_header.restype = ctypes.c_int
        h.nerfsr_jpeg_decode.restype = ctypes.c_int
        _state["lib"] = h
    return _state["lib"]


def _check(rc: int, err) -> None:
    if rc != 0:
        raise ValueError(f"JPEG: {err.value.decode(errors='replace')}")


def header(data: Bytes) -> Tuple[int, int, int]:
    """(width, height, components) from the frame header."""
    data = bytes(data)
    whc = (ctypes.c_int32 * 3)()
    err = ctypes.create_string_buffer(ERRCAP)
    _check(lib().nerfsr_jpeg_header(data, len(data), whc, err, ERRCAP), err)
    return whc[0], whc[1], whc[2]


def decode(data: Bytes) -> Tuple[np.ndarray, str]:
    """The pixels and PIL's mode: (H, W) uint8 "L" for one component,
    (H, W, 3) uint8 "RGB" for three."""
    data = bytes(data)
    w, h, c = header(data)
    px = np.empty((h, w, c), np.uint8)
    err = ctypes.create_string_buffer(ERRCAP)
    _check(lib().nerfsr_jpeg_decode(data, len(data), px.ctypes.data,
                                     px.nbytes, err, ERRCAP), err)
    return (px[..., 0] if c == 1 else px), MODES[c]
