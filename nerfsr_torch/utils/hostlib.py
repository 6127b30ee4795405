"""The port's host C library: every ``nerfsr_torch/csrc_host/*.c`` in one
shared object, bound with ``ctypes``.

The sources (the zstd decoder, crc32c and xxhash64 of ``utils/zstd.py``;
the JPEG decoder of ``utils/jpeg.py``; the LLFF ray builder of
``utils/raygen.py``; PIL's Lanczos resize of ``data/downx_common.py``)
are compiled together at first use with the host's C compiler (``$CC``,
else ``cc``, ``gcc`` or ``clang``; ``-O2 -shared -fPIC -pthread``, and
``-ffp-contract=off`` so that no multiply and add is fused: the resize's
fixed-point coefficients are doubles rounded, and a fused one could move
by a unit) into
``nerfsr_torch/_build/libnerfsr_host-<hash>.so``, the hash taken over the
flags and every source. The library is written to a temporary name and
renamed into place, so processes that build it at once do not see each
other's partial files. A failed build raises with the compiler's output:
there is no Python fallback. Nothing is built at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import List

PKG = Path(__file__).resolve().parent.parent
SOURCE_DIR = PKG / "csrc_host"
BUILD = PKG / "_build"
CFLAGS = ("-O2", "-shared", "-fPIC", "-pthread", "-ffp-contract=off")

_state = {"lib": None}


def sources() -> List[Path]:
    return sorted(SOURCE_DIR.glob("*.c"))


def _compiler() -> str:
    for cand in (os.environ.get("CC"), "cc", "gcc", "clang"):
        path = cand and shutil.which(cand)
        if path:
            return path
    raise RuntimeError("no C compiler found ($CC, cc, gcc, clang): the "
                       "host library builds from nerfsr_torch/csrc_host/")


def build() -> Path:
    """Compile the library into ``_build/libnerfsr_host-<hash>.so`` unless
    these sources' library is there already; returns its path."""
    srcs = sources()
    h = hashlib.sha256(" ".join(CFLAGS).encode())
    for src in srcs:
        h.update(src.name.encode() + b"\0" + src.read_bytes())
    so = BUILD / f"libnerfsr_host-{h.hexdigest()[:16]}.so"
    if so.exists():
        return so
    BUILD.mkdir(parents=True, exist_ok=True)
    fd, part = tempfile.mkstemp(dir=BUILD, suffix=".so")
    os.close(fd)
    try:
        run = subprocess.run([_compiler(), *CFLAGS, *map(str, srcs),
                              "-o", part],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                             text=True)
        if run.returncode != 0:
            names = ", ".join(s.name for s in srcs)
            raise RuntimeError(f"building {names} failed:\n{run.stdout}")
        os.replace(part, so)
    finally:
        if os.path.exists(part):
            os.unlink(part)
    return so


def lib() -> ctypes.CDLL:
    """The loaded library (built at first use)."""
    if _state["lib"] is None:
        _state["lib"] = ctypes.CDLL(str(build()))
    return _state["lib"]
