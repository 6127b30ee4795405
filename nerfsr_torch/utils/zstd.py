"""zstd frames, crc32c and xxhash64 on the host, for orbax checkpoints.

The decoder is C (``nerfsr_torch/csrc_host/zstd_decode.c``, RFC 8878
with the frame checksum; no dictionaries), built at first use with the
host's C compiler (``$CC``, else ``cc``, ``gcc`` or ``clang``; ``-O2
-shared -fPIC``) into ``nerfsr_torch/_build/libnerfsr_host-<hash>.so``
and bound with ``ctypes``. A failed build raises with the compiler's
output: there is no Python fallback. Nothing is built at import.

The encoder writes frames of raw (stored) blocks only: what orbax's
readers need to read an array back, with no compression.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import struct
import subprocess
import tempfile
from pathlib import Path
from typing import Iterator, Union

PKG = Path(__file__).resolve().parent.parent
SOURCE = PKG / "csrc_host" / "zstd_decode.c"
BUILD = PKG / "_build"
CFLAGS = ("-O2", "-shared", "-fPIC")

MAGIC = 0xFD2FB528
BLOCK_MAX = 128 * 1024

_state = {"lib": None}
Bytes = Union[bytes, bytearray, memoryview]


def _compiler() -> str:
    for cand in (os.environ.get("CC"), "cc", "gcc", "clang"):
        path = cand and shutil.which(cand)
        if path:
            return path
    raise RuntimeError("no C compiler found ($CC, cc, gcc, clang): the "
                       "zstd decoder builds from nerfsr_torch/csrc_host/")


def build() -> Path:
    """Compile the decoder into ``_build/libnerfsr_host-<hash>.so`` unless
    this source's library is there already; returns its path."""
    src = SOURCE.read_bytes()
    digest = hashlib.sha256(" ".join(CFLAGS).encode() + src).hexdigest()
    so = BUILD / f"libnerfsr_host-{digest[:16]}.so"
    if so.exists():
        return so
    BUILD.mkdir(parents=True, exist_ok=True)
    fd, part = tempfile.mkstemp(dir=BUILD, suffix=".so")
    os.close(fd)
    try:
        run = subprocess.run([_compiler(), *CFLAGS, str(SOURCE), "-o", part],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                             text=True)
        if run.returncode != 0:
            raise RuntimeError(f"building {SOURCE.name} failed:\n{run.stdout}")
        os.replace(part, so)
    finally:
        if os.path.exists(part):
            os.unlink(part)
    return so


def lib() -> ctypes.CDLL:
    """The loaded decoder library (built at first use)."""
    if _state["lib"] is None:
        h = ctypes.CDLL(str(build()))
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
