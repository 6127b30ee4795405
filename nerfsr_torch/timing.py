"""Device timing of the port's kernels on the card.

    python -m nerfsr_torch.timing --other DIR [--out FILE]

``time_ms`` (calls captured in a CUDA graph, one replay timed by CUDA
events) is the harness ``chip_smoke.py`` times every kernel with;
``floor_ms`` is the same harness around an empty kernel, the cost of a
launch that does nothing. ``ptxas_report`` reads the compiler's
``-Xptxas -v`` figures of the kernels in a build log.

The command line times kernels A (inverse CDF), B (composite forward)
and D (composite backward) of this tree against those of the checkout at
DIR, whose ``nerfsr_torch/csrc/invert_cdf.cu`` and ``composite.cu`` are
built into a library of their own (the same C entries). Both run in one
process on the same inputs, in turns (other, this, this, other), at the
main path's shapes: A at N = 4096 with (B, Q) = (47, 24) and (23, 16),
and at N = 2048 with both; B at N = 4096 and 2048, S = 16, and at N =
2048, S = 64 and 128; D at N = 2048 (the training batch) and S = 16 (the
llff step), 64 and 128 (the parity step's coarse and fine levels); relu,
black background. Beside them:
each call's byte bound, the plain version's time, the launch floor at
each kernel's grid and both builds' register figures, and the largest
difference between the two builds' B outputs at every activation,
background and S that D is timed at. It prints the card and one JSON
line, also written to FILE when given. Needs a CUDA card and ``nvcc``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
from pathlib import Path

import torch

from nerfsr_torch.kernels import _lib

HBM_BYTES_PER_S = 3.35e12    # H100 SXM, NVIDIA's data sheet

A_SHAPES = ((4096, 47, 24), (4096, 23, 16), (2048, 47, 24), (2048, 23, 16))
B_SHAPES = ((4096, 16), (2048, 16), (2048, 64), (2048, 128))
D_SHAPES = ((2048, 16), (2048, 64), (2048, 128))


def time_ms(fn, iters=20, warmup=3):
    """Mean device time of ``fn`` per call: ``iters`` calls captured in a
    CUDA graph, one replay timed by CUDA events. Replaying keeps the
    host's per-call overhead (Python, the wrappers' checks) out of the
    time of kernels that take microseconds."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def floor_ms(blocks=1, threads=32, iters=20):
    """``time_ms`` of an empty kernel on a grid of ``blocks`` x
    ``threads``: what a launch of that shape costs before any work."""
    lib = _lib.lib()

    def launch():
        _lib.check(lib.nerfsr_empty_kernel(
            blocks, threads, torch.cuda.current_stream().cuda_stream),
            "empty_kernel")
    return time_ms(launch, iters=iters)


def ptxas_report(log: str, kernels) -> dict:
    """{mangled name: {"registers", "stack", "spill_stores",
    "spill_loads"}} of every entry function in ``log`` (``-Xptxas -v``
    output) whose name contains one of ``kernels``."""
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            cur = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and cur:
            out.setdefault(cur, {}).update(
                stack=int(m.group(1)), spill_stores=int(m.group(2)),
                spill_loads=int(m.group(3)))
            continue
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = m.group(1)
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and cur:
            out.setdefault(cur, {})["registers"] = int(m.group(1))
    return {k: v for k, v in out.items() if any(n in k for n in kernels)}


def invert_cdf_inputs(n, b, q, gen, dev):
    """bins (n, b) of a sorted row, weights (n, b - 1) uniform with a
    degenerate row (all 0) and a row of concentrated mass, stratified u
    (n, q) at the cell centres."""
    from nerfsr_torch.core.sampling import stratified_uniforms
    z = torch.sort(torch.rand((n, b + 1), generator=gen), -1)[0]
    bins = (0.5 * (z[:, :-1] + z[:, 1:])).to(dev)
    w = torch.rand((n, b - 1), generator=gen)
    w[0] = 0.0
    w[1, :2] = 100.0
    u = stratified_uniforms(bins, q, False).contiguous()
    return bins, w.to(dev), u


def composite_inputs(n, s, gen, dev):
    """rgb (n, s, 3) in [0, 1), sigma (n, s) ~ 2 N(0, 1), sorted z."""
    rgb = torch.rand((n, s, 3), generator=gen).to(dev)
    sigma = (torch.randn((n, s), generator=gen) * 2).to(dev)
    z = torch.sort(torch.rand((n, s), generator=gen), -1)[0].to(dev)
    return rgb, sigma, z


def composite_bwd_inputs(n, s, gen, dev):
    """composite_inputs and every cotangent of kernel D nonzero: gc (n, 3),
    gd, go (n), gw (n, s), each ~ N(0, 1)."""
    rgb, sigma, z = composite_inputs(n, s, gen, dev)
    gc = torch.randn((n, 3), generator=gen).to(dev)
    gd = torch.randn((n,), generator=gen).to(dev)
    go = torch.randn((n,), generator=gen).to(dev)
    gw = torch.randn((n, s), generator=gen).to(dev)
    return rgb, sigma, z, gc, gd, go, gw


def lane_grid(n, s):
    """Blocks of kernels B and D: 8 warps a block, a segment of S lanes
    rounded up to a power of two (at most 32) a ray."""
    seg = min(32, 1 << (s - 1).bit_length())
    return -(-n // (8 * (32 // seg)))


def invert_cdf_bytes(n, b, q, bins_read=None):
    """Bytes kernel A must move: the weights and u read once, z written
    once, and the bins: all n b of them, or ``bins_read`` (what
    ``invert_cdf_bins_read`` counts on a call's inputs)."""
    return 4 * (n * ((b - 1) + q + q) + (n * b if bins_read is None
                                         else bins_read))


def invert_cdf_bins_read(bins, w, u):
    """The bins a call's queries land in: per ray the distinct below and
    above indices of the plain version's search, summed over the rays.
    Past ~2 Q bins a ray the function needs no more of them."""
    wp = w + 1e-5
    cdf = torch.cat([torch.zeros_like(wp[:, :1]),
                     (wp / wp.sum(-1, keepdim=True)).cumsum(-1)], -1)
    k = torch.searchsorted(cdf, u, right=True)
    idx = torch.cat([(k - 1).clamp(min=0), k.clamp(max=bins.shape[1] - 1)],
                    -1).sort(-1).values
    return int(idx.shape[0] + (idx[:, 1:] != idx[:, :-1]).sum())


def composite_fwd_bytes(n, s):
    return 4 * n * (3 * s + s + s + 3 + 1 + 1 + s)


def composite_bwd_bytes(n, s):
    """Kernel D reads rgb, sigma, z, gc, gd, go and gw (6S + 5 floats a
    ray) and writes grgb, gsigma and gz (5S)."""
    return 4 * n * (11 * s + 5)


def _other_library(root: Path):
    """(library, build log) of kernels A, B and D of the checkout at
    root."""
    so = _lib.build(root / "nerfsr_torch" / "csrc",
                    ("invert_cdf.cu", "composite.cu"), "nerfsr_other")
    return (_lib.bind(ctypes.CDLL(str(so)),
                      ("nerfsr_invert_cdf", "nerfsr_composite_fwd",
                       "nerfsr_composite_bwd")),
            _lib.build_log(so))


def _turns(other_fn, this_fn):
    """(other, this, this, other) -> ([other ms x 2], [this ms x 2])."""
    t = [time_ms(f) for f in (other_fn, this_fn, this_fn, other_fn)]
    return [t[0], t[3]], [t[1], t[2]]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", required=True, type=Path,
                    help="root of the checkout to time against")
    ap.add_argument("--out", help="also write the JSON result here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("nerfsr_torch.timing needs a CUDA card")
    from nerfsr_torch.core.rendering import volumetric_rendering as plain_b
    from nerfsr_torch.core.sampling import _invert_cdf as plain_a
    from nerfsr_torch.kernels.composite import (composite_bwd,
                                                composite_bwd_plain,
                                                composite_fwd)
    from nerfsr_torch.kernels.sampling import invert_cdf

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    names = ("invert_cdf_kernel", "composite_fwd_kernel",
             "composite_bwd_kernel")
    other, other_log = _other_library(args.other.resolve())
    ptxas = {"this": ptxas_report(_lib.build_log(), names),
             "other": ptxas_report(other_log, names)}
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(0)
    stream = torch.cuda.current_stream

    rows = {"A": [], "B": [], "D": []}
    for n, b, q in A_SHAPES:
        bins, w, u = invert_cdf_inputs(n, b, q, gen, dev)

        def a_other():
            z = torch.empty_like(u)
            _lib.check(other.nerfsr_invert_cdf(
                bins.data_ptr(), w.data_ptr(), u.data_ptr(), z.data_ptr(),
                n, b, q, stream().cuda_stream), "other invert_cdf")
            return z

        def a_this():
            return invert_cdf(bins, w, u)

        ref = plain_a(bins, w, u)
        errs = [float((f() - ref).abs().max()) for f in (a_other, a_this)]
        other_ms, this_ms = _turns(a_other, a_this)
        rows["A"].append(dict(
            n=n, b=b, q=q, other_ms=other_ms, this_ms=this_ms,
            plain_ms=time_ms(lambda: plain_a(bins, w, u)),
            bound_ms=invert_cdf_bytes(n, b, q) / HBM_BYTES_PER_S * 1e3,
            # grids: this tree's A, 8 rays of 32 lanes a block; the
            # single-thread-per-ray design, 64 rays a block
            floor_ms=floor_ms(-(-n // 8), 256),
            other_grid_floor_ms=floor_ms(-(-n // 64), 64),
            max_abs_err_other=errs[0], max_abs_err_this=errs[1]))

    def b_other(rgb, sigma, z, softplus=False, white=False):
        n, s = sigma.shape
        outs = (torch.empty((n, 3), device=dev), torch.empty((n,), device=dev),
                torch.empty((n,), device=dev), torch.empty_like(sigma))
        _lib.check(other.nerfsr_composite_fwd(
            rgb.data_ptr(), sigma.data_ptr(), z.data_ptr(),
            *(o.data_ptr() for o in outs), n, s, int(softplus), int(white),
            stream().cuda_stream), "other composite_fwd")
        return outs

    for n, s in B_SHAPES:
        rgb, sigma, z = composite_inputs(n, s, gen, dev)

        def b_this():
            return composite_fwd(rgb, sigma, z, False)

        ref = plain_b(rgb, sigma, z, False)
        errs = [max(float((g - r).abs().max()) for g, r in zip(f(), ref))
                for f in (lambda: b_other(rgb, sigma, z), b_this)]
        other_ms, this_ms = _turns(lambda: b_other(rgb, sigma, z), b_this)
        rows["B"].append(dict(
            n=n, s=s, other_ms=other_ms, this_ms=this_ms,
            plain_ms=time_ms(lambda: plain_b(rgb, sigma, z, False)),
            bound_ms=composite_fwd_bytes(n, s) / HBM_BYTES_PER_S * 1e3,
            # grids: this tree's B; the single-thread-per-ray design, 64
            # rays a block
            floor_ms=floor_ms(lane_grid(n, s), 256),
            other_grid_floor_ms=floor_ms(-(-n // 64), 64),
            max_abs_err_other=errs[0], max_abs_err_this=errs[1]))

    # B of both builds, every case, at every S that D is timed at: the
    # forward half D shares with B must leave B's bits as they were
    b_diff = 0.0
    for n, s in D_SHAPES:
        rgb, sigma, z = composite_inputs(n, s, gen, dev)
        for act in ("relu", "softplus"):
            for white in (False, True):
                mine = composite_fwd(rgb, sigma, z, white, act)
                theirs = b_other(rgb, sigma, z, act == "softplus", white)
                b_diff = max(b_diff, *(float((a - b).abs().max())
                                       for a, b in zip(mine, theirs)))

    for n, s in D_SHAPES:
        d_args = composite_bwd_inputs(n, s, gen, dev)

        def d_other():
            outs = (torch.empty_like(d_args[0]),
                    torch.empty_like(d_args[1]),
                    torch.empty_like(d_args[1]))
            _lib.check(other.nerfsr_composite_bwd(
                *(a.data_ptr() for a in d_args),
                *(o.data_ptr() for o in outs), n, s, 0, 0,
                stream().cuda_stream), "other composite_bwd")
            return outs

        def d_this():
            return composite_bwd(*d_args, False)

        ref = composite_bwd_plain(*d_args, False)
        errs = [max(float((g - r).abs().max()) for g, r in zip(f(), ref))
                for f in (d_other, d_this)]
        other_ms, this_ms = _turns(d_other, d_this)
        rows["D"].append(dict(
            n=n, s=s, other_ms=other_ms, this_ms=this_ms,
            plain_ms=time_ms(lambda: composite_bwd_plain(*d_args, False)),
            bound_ms=composite_bwd_bytes(n, s) / HBM_BYTES_PER_S * 1e3,
            # grids: this tree's D, as B; the thread-per-ray design, 64
            # rays a block
            floor_ms=floor_ms(lane_grid(n, s), 256),
            other_grid_floor_ms=floor_ms(-(-n // 64), 64),
            max_abs_err_other=errs[0], max_abs_err_this=errs[1]))
    result = {"card": card, "other": str(args.other),
              "floor_ms_one_block": floor_ms(), "ptxas": ptxas,
              "b_max_abs_diff_vs_other": b_diff, **rows}
    for key, rs in rows.items():
        for r in rs:
            shape = {k: r[k] for k in ("n", "b", "q", "s") if k in r}
            print(f"[{key}] {shape}: other {r['other_ms']} ms, this "
                  f"{r['this_ms']} ms, plain {r['plain_ms']:.4f}, bound "
                  f"{r['bound_ms']:.5f}, floor {r['floor_ms']:.4f} "
                  f"(other's grid {r['other_grid_floor_ms']:.4f})")
    print(f"[B] largest difference from the other build's B: {b_diff}")
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(card)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
