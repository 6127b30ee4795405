"""zstd frames, crc32c and xxhash64 on the host, for orbax checkpoints.

The decoder is C (``nerfsr_torch/csrc_host/zstd_decode.c``, RFC 8878
with the frame checksum; no dictionaries), part of the host library
that ``utils/hostlib.py`` builds at first use and binds with ``ctypes``.

The encoder writes frames of raw (stored) blocks only: what orbax's
readers need to read an array back, with no compression.
"""

from __future__ import annotations

import ctypes
import struct
from typing import Iterator, Union

from nerfsr_torch.utils import hostlib

MAGIC = 0xFD2FB528
BLOCK_MAX = 128 * 1024

_state = {"lib": None}
Bytes = Union[bytes, bytearray, memoryview]


def lib() -> ctypes.CDLL:
    """The host library with the decoder's functions bound (built at
    first use)."""
    if _state["lib"] is None:
        h = hostlib.lib()
        size_p = ctypes.POINTER(ctypes.c_size_t)
        h.nerfsr_zstd_decompress.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p,
            ctypes.c_size_t, size_p]
        h.nerfsr_zstd_content_size.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.POINTER(ctypes.c_uint64)]
        h.nerfsr_zstd_error.argtypes = [ctypes.c_int]
        h.nerfsr_zstd_error.restype = ctypes.c_char_p
        h.nerfsr_crc32c.argtypes = [ctypes.c_uint32, ctypes.c_char_p,
                                    ctypes.c_size_t]
        h.nerfsr_crc32c.restype = ctypes.c_uint32
        h.nerfsr_xxh64.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                   ctypes.c_uint64]
        h.nerfsr_xxh64.restype = ctypes.c_uint64
        _state["lib"] = h
    return _state["lib"]


def _error(code: int) -> str:
    return lib().nerfsr_zstd_error(code).decode()


def decompress(data: Bytes) -> bytearray:
    """Decode every zstd frame of ``data``, back to back; raises
    ``ValueError`` on a corrupt or truncated frame, a checksum mismatch or
    a frame that needs a dictionary."""
    data = bytes(data)
    h = lib()
    size = ctypes.c_uint64()
    rc = h.nerfsr_zstd_content_size(data, len(data), ctypes.byref(size))
    if rc < 0:
        raise ValueError(f"zstd: {_error(rc)}")
    known = rc == 0
    cap = size.value if known else max(1 << 16, 4 * len(data))
    while True:
        out = bytearray(cap)
        n = ctypes.c_size_t()
        ptr = (ctypes.c_char * max(cap, 1)).from_buffer(out) if cap else None
        rc = h.nerfsr_zstd_decompress(data, len(data), ptr, cap,
                                      ctypes.byref(n))
        del ptr
        if rc == -3 and not known:
            cap *= 4                        # no stated size: grow and retry
            continue
        if rc != 0:
            raise ValueError(f"zstd: {_error(rc)}")
        del out[n.value:]
        return out


def crc32c(data: Bytes, crc: int = 0) -> int:
    """crc32c (Castagnoli) of ``data``, continuing from ``crc``."""
    data = bytes(data)
    return lib().nerfsr_crc32c(crc, data, len(data))


def xxh64(data: Bytes, seed: int = 0) -> int:
    data = bytes(data)
    return lib().nerfsr_xxh64(data, len(data), seed)


def raw_frame_parts(data: Bytes) -> Iterator[Bytes]:
    """A zstd frame holding ``data`` in raw blocks, as the byte strings to
    write one after another (the data's blocks are views, not copies): a
    single-segment header with the 8-byte content size, then blocks of at
    most 128 KiB, the last one flagged."""
    mv = memoryview(data).cast("B")
    n = len(mv)
    yield struct.pack("<IBQ", MAGIC, 0xE0, n)
    pos = 0
    while True:
        size = min(BLOCK_MAX, n - pos)
        last = pos + size == n
        yield struct.pack("<I", (size << 3) | int(last))[:3]
        if size:
            yield mv[pos:pos + size]
        pos += size
        if last:
            return
