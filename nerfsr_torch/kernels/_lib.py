"""Build, load and call the port's CUDA kernels.

The sources in ``nerfsr_torch/csrc/`` are compiled with ``nvcc`` for
``sm_90a`` into one shared library with a plain C interface and loaded
with ``ctypes``; every pointer and the stream cross as ``c_void_p``. Each
source compiles in its own ``nvcc`` process, all started together, and
the objects link into ``nerfsr_torch/_build/libnerfsr_kernels-<hash>.so``
at first use (the hash covers the sources and flags, so an edited source
rebuilds). Nothing here runs at import time: the CPU tests import every
module on a host with no ``nvcc``.

Each C entry returns ``cudaGetLastError()`` after its launch; ``check``
raises on anything but 0. Launch counts are plain integers in ``COUNTS``,
raised by one where a wrapper launches its kernel and nowhere else.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD = PKG / "_build"
SOURCES = ("invert_cdf.cu", "composite.cu", "fused_mlp.cu",
           "fused_mlp_bwd.cu")
HEADERS = ("common.cuh", "mlp_tile.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

COUNTS = {"invert_cdf": 0, "composite_fwd": 0, "fused_mlp_fwd": 0,
          "composite_bwd": 0, "fused_mlp_bwd": 0}
# kernel launches behind one count of a wrapper (kernel E runs as three:
# tile recompute and backprop, weight-gradient partials, reduce)
LAUNCHES_PER_CALL = {"invert_cdf": 1, "composite_fwd": 1,
                     "fused_mlp_fwd": 1, "composite_bwd": 1,
                     "fused_mlp_bwd": 3}

_P, _I = ctypes.c_void_p, ctypes.c_int
_IP = ctypes.POINTER(ctypes.c_int)
_SIGNATURES = {
    # bins, w, u, z, n, n_bins, n_q, stream
    "nerfsr_invert_cdf": [_P, _P, _P, _P, _I, _I, _I, _P],
    # rgb, sigma, z, comp, depth, opacity, weights, n, s, softplus,
    # white_bkgd, stream
    "nerfsr_composite_fwd": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    # x0, dmb, w, b, rgb, sigma, n_points, bf16, stream
    "nerfsr_fused_mlp_fwd": [_P, _P, _P, _P, _P, _P, _I, _I, _P],
    # rgb, sigma, z, gc, gd, go, gw, grgb, gsigma, gz, n, s, softplus,
    # white_bkgd, stream
    "nerfsr_composite_bwd": [_P] * 10 + [_I, _I, _I, _I, _P],
    # x0, dmb, grgb, gsigma, w, wt, b, acts, grads, partial, out,
    # n_points, bf16, stream
    "nerfsr_fused_mlp_bwd": [_P] * 11 + [_I, _I, _P],
    # -> act_width, grad_width, splits, total
    "nerfsr_fused_mlp_bwd_layout": [_IP, _IP, _IP, _IP],
}

_state = {"lib": None, "log": ""}


def reset_counts():
    for k in COUNTS:
        COUNTS[k] = 0


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the sources (in parallel) and link the shared library,
    unless this content's library is already built. Returns its path."""
    so = BUILD / f"libnerfsr_kernels-{_digest()}.so"
    if so.exists():
        return so
    nvcc = _nvcc()
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=BUILD))
    try:
        objs, procs = [], []
        for src in SOURCES:
            obj = tmp / (src + ".o")
            objs.append(obj)
            procs.append((src, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(CSRC / src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs, failed = [], []
        for src, proc in procs:
            out, _ = proc.communicate()
            logs.append(f"== {src}\n{out}")
            if proc.returncode != 0:
                failed.append(src)
        if failed:
            raise RuntimeError("nvcc failed on " + ", ".join(failed) + "\n"
                               + "\n".join(logs))
        part = tmp / "lib.so"
        link = subprocess.run(
            [nvcc, "-shared", *NVCC_FLAGS[:2], *map(str, objs), "-o",
             str(part)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
        if link.returncode != 0:
            raise RuntimeError("link failed\n" + link.stdout)
        os.replace(part, so)
        _state["log"] = "\n".join(logs)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return so


def build_log() -> str:
    """The compiler's output (``-Xptxas -v``) of this process's build."""
    return _state["log"]


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built at first use)."""
    if _state["lib"] is None:
        handle = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        handle.nerfsr_error_string.argtypes = [ctypes.c_int]
        handle.nerfsr_error_string.restype = ctypes.c_char_p
        _state["lib"] = handle
    return _state["lib"]


def check(err: int, name: str):
    if err != 0:
        msg = lib().nerfsr_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def check_cuda(t: torch.Tensor, name: str, shape, dtype=torch.float32,
               device=None):
    """Raise unless ``t`` is a contiguous CUDA tensor of this shape/dtype
    (on ``device`` when given)."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")

