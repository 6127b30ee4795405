#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``nerfsr_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

1. prints the card's name and power limit (nvidia-smi);
2. builds the CUDA kernels from ``nerfsr_torch/csrc`` (one nvcc per
   source, in parallel) and writes the compiler's report to
   ``chiprun_out/chip_smoke_build.log``;
3. holds each kernel against its plain PyTorch version on the card and
   times both: the forward kernels at the serving path's shapes (inverse
   CDF at both (B, Q) pairs, composite with both activations and both
   backgrounds, fused MLP in bf16 and f32), the backward kernels at the
   training path's (composite backward at N=2048, S=16 with every
   cotangent nonzero; fused MLP backward at P=32,768 in bf16 and f32);
4. serving: renders three 504x378 NeRF-SR x2 views (``--fast_preset
   llff``, ``--precision mixed``, full-width D8/W256 MLP, random weights
   from a seed) through ``render_eval_many(..., quantize_rgb=True)``,
   checks the shapes, finiteness and every kernel's launch count, and
   holds one chunk against the plain path on the card;
5. training: renders 4 training views of a teacher scene (random
   weights, seed 1, sigma biases +3), derives the LR truth by ``avg``,
   uploads the grouped buffer, and trains a seed-0 student with Adam
   (``--batch_size 512`` LR pixels, 2048 HR rays a step): exact per-step
   launch counts, ms/step and HR rays/s over a timed window, finite
   parameters and moments, a falling ``fine_mse``, and one step's loss
   and gradients through the kernels against the plain path;
6. prints a JSON line of details, the JSON line of kernel summaries
   (``{"kernels": [...]}``), the card line, and last
   ``{"ok": true, "device": {...}}``. Any failure exits non-zero.

It needs a CUDA card: without one it exits 1 and prints no result.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "chiprun_out")

# published H100 SXM peaks (NVIDIA data sheet, dense): the least-time
# bound of each kernel is the larger of bytes / HBM rate and operations /
# the peak rate of their type
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}

# tolerances, each against the plain PyTorch version on the same card
TOL_INVERT_CDF = 1e-4        # abs on z in [0, 1]: the CDF's f32 rounding
                             # (~1e-7, another sum order) divided by the
                             # local density; sparse bins amplify it ~1e2
TOL_COMPOSITE = (2e-4, 1e-5)  # (rtol, atol): serial vs scanned cumprod
TOL_MLP_F32 = (1e-4, 2e-5)   # (rtol, atol): f32 accumulation order
TOL_MLP_BF16 = (2e-2, 2e-2)  # (rtol, atol): as f32, plus rare bf16
                             # rounding flips (one ulp, 2^-8) of single
                             # activations where the two sum orders
                             # straddle a rounding midpoint; a flip
                             # cascades to ~1e-3 (seen 2.5e-3)
# kernel D: serial vs scanned transmittance and suffix sums, on
# gradients of order 1-100 (seen: 4.7e-6 abs at most)
TOL_COMPOSITE_BWD = (1e-3, 1e-4)
# kernel E, per leaf ||got - ref|| / ||ref||: sums over 32,768 points in
# another order (f32; seen 1.5e-6); in bf16 also rounding flips of single
# gradients where the two orders straddle a bf16 rounding midpoint
# (seen 1.7e-4)
TOL_MLP_BWD = {"f32": 1e-4, "bf16": 2e-3}
# a chunk's fine rgb/depth through the kernels vs the plain path, as
# (mean abs err, max abs err) bars. Kernel A's depths differ from the
# plain version's by up to ~1e-4 (CDF rounding over sparse bins), and
# the inverse CDF's `denom < eps -> 1` rule can move a sample by a bin
# width where an empty bin's CDF step sits at eps (pad annealed to 0).
# The 2^9-frequency encoding turns such depth changes into input
# changes; in mixed precision these meet bf16's rounding step (2^-8),
# so a few percent of the rays move by up to ~3e-2.
SLICE_MIXED = (2e-3, 0.1)
SLICE_F32 = (1e-4, 0.1)

HR_WH = (504, 378)
DOWNSCALE = 2
N_VIEWS = 3
FOCAL = 407.0                # HR pixels, ~0.8 x width (forward-facing)

# training phase (scripts/train_llff_downX_fast.sh: --batch_size 512,
# --n_epochs 30 --n_epochs_decay 10, --lr 5e-4 --lr_final 5e-6, exp)
N_TRAIN_VIEWS = 4
BATCH = 512                  # LR pixels; x ds^2 = 2048 HR rays a step
WARMUP_STEPS = 3
TIMED_STEPS = 20
FALL_STEPS = 200
# fine_mse, mean of the last 20 of FALL_STEPS steps over the mean of the
# first 20: the student starts from an empty-ish scene against a teacher
# with content, so the colour error drops fast
FALL_RATIO = 0.7
# one step through the kernels vs the plain path: loss (relative) and
# every gradient leaf (norm-relative). The first trunk layers' gradients
# are sums of products of 2^9-frequency encodings, and kernel A's depths
# differ from the plain version's by CDF roundings (up to ~1e-4 over
# sparse bins), so those leaves move most; mixed adds bf16 roundings
# (the plain path's autograd also rounds each weight gradient to bf16).
# Seen: f32 loss 3.7e-7, worst leaf 1.6e-3 (layer 1); mixed loss 4.7e-5,
# worst leaf 1.0e-2 (layer 1).
STEP_BARS = {"f32": (1e-5, 1e-2), "mixed": (5e-4, 0.1)}


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line():
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if res.returncode != 0:
        fail(f"nvidia-smi: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


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


def max_err(got, ref, rtol, atol, what):
    """Max |got - ref|; fails where |got - ref| > atol + rtol |ref|."""
    got, ref = got.double(), ref.double()
    diff = (got - ref).abs()
    if not torch.isfinite(got).all():
        fail(f"{what}: non-finite output")
    bad = diff > atol + rtol * ref.abs()
    if bad.any():
        fail(f"{what}: {int(bad.sum())} elements off, max abs err "
             f"{float(diff.max()):.3e} (rtol {rtol}, atol {atol})")
    return float(diff.max())


def check_invert_cdf(dev, gen):
    from nerfsr_torch.core.sampling import _invert_cdf, stratified_uniforms
    from nerfsr_torch.kernels import COUNTS
    from nerfsr_torch.kernels.sampling import invert_cdf

    n = 4096
    errs, ms, plain_ms, bytes_moved = [], 0.0, 0.0, 0
    for b, q in ((47, 24), (23, 16)):
        z = torch.sort(torch.rand((n, b + 1), generator=gen), -1)[0]
        bins = (0.5 * (z[:, :-1] + z[:, 1:])).to(dev)
        w = torch.rand((n, b - 1), generator=gen)
        w[0] = 0.0          # degenerate-denominator row
        w[1, :2] = 100.0    # concentrated mass
        w = w.to(dev)
        u = stratified_uniforms(bins, q, False).contiguous()
        got = invert_cdf(bins, w, u)
        torch.cuda.synchronize()
        errs.append(max_err(got, _invert_cdf(bins, w, u), 0.0,
                            TOL_INVERT_CDF, f"invert_cdf B={b} Q={q}"))
        ms += time_ms(lambda: invert_cdf(bins, w, u))
        plain_ms += time_ms(lambda: _invert_cdf(bins, w, u))
        bytes_moved += 4 * n * (b + (b - 1) + q + q)
        print(f"[kernel A] invert_cdf N={n} B={b} Q={q}: max abs err "
              f"{errs[-1]:.3e} (tol {TOL_INVERT_CDF})")
    print(f"[kernel A] both calls of a chunk: {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms; launches so far {COUNTS['invert_cdf']}")
    return {"max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bytes_moved / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes"}


def check_composite(dev, gen):
    from nerfsr_torch.core.rendering import volumetric_rendering as plain
    from nerfsr_torch.kernels import COUNTS
    from nerfsr_torch.kernels.composite import volumetric_rendering

    n, s = 4096, 16
    rgb = torch.rand((n, s, 3), generator=gen).to(dev)
    sigma = (torch.randn((n, s), generator=gen) * 2).to(dev)
    z = torch.sort(torch.rand((n, s), generator=gen), -1)[0].to(dev)
    errs, timed = [], None
    for act in ("relu", "softplus"):
        for white in (False, True):
            got = volumetric_rendering(rgb, sigma, z, white, act)
            torch.cuda.synchronize()
            ref = plain(rgb, sigma, z, white, act)
            for g, r, name in zip(got, ref, ("rgb", "depth", "opacity",
                                             "weights")):
                errs.append(max_err(g, r, *TOL_COMPOSITE,
                                    f"composite {act} white={white} "
                                    f"{name}"))
            print(f"[kernel B] composite {act} white={white}: max abs "
                  f"err {max(errs[-4:]):.3e} (rtol, atol {TOL_COMPOSITE})")
    # the serving path's variant: relu, no white background
    timed = (time_ms(lambda: volumetric_rendering(rgb, sigma, z, False)),
             time_ms(lambda: plain(rgb, sigma, z, False)))
    bytes_moved = 4 * n * (3 * s + s + s + 3 + 1 + 1 + s)
    print(f"[kernel B] relu, no white background: {timed[0]:.4f} ms, plain "
          f"{timed[1]:.4f} ms; launches so far {COUNTS['composite_fwd']}")
    return {"max_abs_err": max(errs), "ms": timed[0], "plain_ms": timed[1],
            "bound_ms": bytes_moved / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes"}


def check_fused_mlp(dev, gen):
    from nerfsr_torch.kernels import COUNTS
    from nerfsr_torch.kernels import mlp as kmlp
    from nerfsr_torch.models.mlp import VanillaMLP

    p = 4096 * 16
    net = VanillaMLP().reset_parameters("kaiming", 0.02, gen).to(dev)
    pts = (torch.rand((p, 3), generator=gen) * 2 - 1).to(dev)
    dirs = torch.nn.functional.normalize(
        torch.randn((p, 3), generator=gen), dim=-1).to(dev)
    out = {}
    with torch.no_grad():
        flat = kmlp.flatten_params(net)
        x0, dmb = kmlp.embed(pts, dirs)
        for dtype, tol, key in ((torch.bfloat16, TOL_MLP_BF16, "bf16"),
                                (torch.float32, TOL_MLP_F32, "f32")):
            rgb, sigma = kmlp.fused_mlp_fwd(flat, x0, dmb, dtype)
            torch.cuda.synchronize()
            rgb_r, sigma_r = kmlp.fused_mlp_plain(flat, x0, dmb, dtype)
            err = max(max_err(rgb, rgb_r, *tol, f"fused_mlp {key} rgb"),
                      max_err(sigma, sigma_r, *tol, f"fused_mlp {key} "
                              "sigma"))
            ms = time_ms(lambda: kmlp.fused_mlp_fwd(flat, x0, dmb, dtype),
                         iters=10)
            plain_ms = time_ms(
                lambda: kmlp.fused_mlp_plain(flat, x0, dmb, dtype), iters=10)
            flops = 2.0 * kmlp.N_WEIGHTS * p
            bytes_moved = (4 * p * (kmlp.C_POS + kmlp.C_DIR + 3 + 1)
                           + kmlp.N_WEIGHTS * (2 if key == "bf16" else 4)
                           + 4 * kmlp.N_BIASES)
            bound = max(flops / PEAK_FLOPS[key],
                        bytes_moved / HBM_BYTES_PER_S) * 1e3
            out[key] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                        "bound_ms": bound, "bound_by": "operations",
                        "tflops": flops / ms / 1e9}
            print(f"[kernel C] fused_mlp {key} P={p}: max abs err "
                  f"{err:.3e} (rtol, atol {tol}); {ms:.3f} ms "
                  f"({out[key]['tflops']:.1f} TFLOP/s), plain "
                  f"{plain_ms:.3f} ms, bound {bound:.3f} ms; launches so "
                  f"far {COUNTS['fused_mlp_fwd']}")
    return out


def check_composite_bwd(dev, gen):
    from nerfsr_torch.kernels import COUNTS
    from nerfsr_torch.kernels.composite import (composite_bwd,
                                                composite_bwd_plain)

    n, s = 2048, 16
    rgb = torch.rand((n, s, 3), generator=gen).to(dev)
    sigma = (torch.randn((n, s), generator=gen) * 2).to(dev)
    z = torch.sort(torch.rand((n, s), generator=gen), -1)[0].to(dev)
    gc = torch.randn((n, 3), generator=gen).to(dev)
    gd = torch.randn((n,), generator=gen).to(dev)
    go = torch.randn((n,), generator=gen).to(dev)
    gw = torch.randn((n, s), generator=gen).to(dev)
    args = (rgb, sigma, z, gc, gd, go, gw)
    errs = []
    for act in ("relu", "softplus"):
        for white in (False, True):
            got = composite_bwd(*args, white, act)
            torch.cuda.synchronize()
            ref = composite_bwd_plain(*args, white, act)
            for g, r, name in zip(got, ref, ("grgb", "gsigma", "gz")):
                errs.append(max_err(g, r, *TOL_COMPOSITE_BWD,
                                    f"composite_bwd {act} white={white} "
                                    f"{name}"))
            print(f"[kernel D] composite_bwd {act} white={white}: max abs "
                  f"err {max(errs[-3:]):.3e} (rtol, atol "
                  f"{TOL_COMPOSITE_BWD})")
    # the training path's variant: relu, no white background
    ms = time_ms(lambda: composite_bwd(*args, False))
    plain_ms = time_ms(lambda: composite_bwd_plain(*args, False))
    bytes_moved = 4 * n * ((3 * s + s + s + 3 + 1 + 1 + s)
                           + (3 * s + s + s))
    print(f"[kernel D] relu, no white background: {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms; launches so far {COUNTS['composite_bwd']}")
    return {"max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bytes_moved / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes"}


# multiply-adds per point of kernel E: forward recompute, input gradients
# (every layer but layer 0's input, the skip's x0 rows and the direction
# layer's dmb rows: 128x3 + 256x128 + 256x256 + 256 + 7 x 256x256), and
# the weight gradients
E_MACS_PER_POINT = 593408 + (384 + 32768 + 65536 + 256 + 7 * 65536) \
    + 593408


def check_fused_mlp_bwd(dev, gen):
    from nerfsr_torch.kernels import COUNTS
    from nerfsr_torch.kernels import mlp as kmlp
    from nerfsr_torch.models.mlp import VanillaMLP

    p = BATCH * DOWNSCALE ** 2 * 16      # the training step's points
    net = VanillaMLP().reset_parameters("kaiming", 0.02, gen).to(dev)
    pts = (torch.rand((p, 3), generator=gen) * 2 - 1).to(dev)
    dirs = torch.nn.functional.normalize(
        torch.randn((p, 3), generator=gen), dim=-1).to(dev)
    grgb = (torch.randn((p, 3), generator=gen) * 1e-3).to(dev)
    gsig = (torch.randn((p,), generator=gen) * 1e-3).to(dev)
    out = {}
    with torch.no_grad():
        flat = kmlp.flatten_params(net)
        x0, dmb = kmlp.embed(pts, dirs)
        for dtype, key in ((torch.bfloat16, "bf16"), (torch.float32,
                                                        "f32")):
            got = kmlp.fused_mlp_bwd(flat, x0, dmb, grgb, gsig, dtype)
            torch.cuda.synchronize()
            ref = kmlp.fused_mlp_bwd_plain(flat, x0, dmb, grgb, gsig, dtype)
            rel, abs_err = 0.0, 0.0
            for i, (g, r) in enumerate(zip(got, ref)):
                if not torch.isfinite(g).all():
                    fail(f"fused_mlp_bwd {key} leaf {i}: non-finite")
                d = (g.double() - r.double())
                rel = max(rel, float(d.norm() / r.double().norm()
                                     .clamp_min(1e-30)))
                abs_err = max(abs_err, float(d.abs().max()))
            if rel > TOL_MLP_BWD[key]:
                fail(f"fused_mlp_bwd {key}: leaf norm-relative error "
                     f"{rel:.3e} > {TOL_MLP_BWD[key]}")
            ms = time_ms(lambda: kmlp.fused_mlp_bwd(flat, x0, dmb, grgb,
                                                    gsig, dtype), iters=10)
            plain_ms = time_ms(lambda: kmlp.fused_mlp_bwd_plain(
                flat, x0, dmb, grgb, gsig, dtype), iters=10)
            flops = 2.0 * E_MACS_PER_POINT * p
            bytes_moved = (4 * p * (kmlp.C_POS + kmlp.C_DIR + 3 + 1)
                           + kmlp.N_WEIGHTS * (2 if key == "bf16" else 4)
                           + 4 * kmlp.N_BIASES
                           + 4 * (kmlp.N_WEIGHTS + kmlp.N_BIASES))
            bound = max(flops / PEAK_FLOPS[key],
                        bytes_moved / HBM_BYTES_PER_S) * 1e3
            out[key] = {"max_abs_err": abs_err, "max_leaf_rel_err": rel,
                        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                        "bound_by": "operations",
                        "tflops": flops / ms / 1e9}
            print(f"[kernel E] fused_mlp_bwd {key} P={p}: max leaf "
                  f"norm-relative err {rel:.3e} (bar {TOL_MLP_BWD[key]}), "
                  f"max abs err {abs_err:.3e}; {ms:.3f} ms "
                  f"({out[key]['tflops']:.1f} TFLOP/s), plain "
                  f"{plain_ms:.3f} ms, bound {bound:.3f} ms; calls so far "
                  f"{COUNTS['fused_mlp_bwd']}")
    return out


def slice_phase(dev, card):
    from nerfsr_torch.config import default_options
    from nerfsr_torch.core.rays import get_rays, make_rays, ndc_rays
    from nerfsr_torch.data.views import LLFFDownXViews
    from nerfsr_torch.kernels import COUNTS, reset_counts
    from nerfsr_torch.models import create_model

    opt = default_options("test", model="nerf_downX",
                          dataset_mode="llff_downX", fast_preset="llff",
                          img_wh=HR_WH, downscale=DOWNSCALE,
                          precision="mixed")
    system = create_model(opt, device=dev)
    if not system.render_cfg.use_fused_mlp:
        fail("the slice's architecture must take the fused MLP kernel")
    if system.render_cfg.prop_pad_anneal <= 0:
        fail("the pad anneal was not resolved")
    params = system.init_params(seed=0)
    views = LLFFDownXViews.spiral(FOCAL, HR_WH, DOWNSCALE, N_VIEWS)
    w, h = HR_WH
    n_hr = w * h
    chunk = system._eval_chunk_size(n_hr)
    n_chunks = -(-n_hr // chunk)

    # warm-up render (library initialisation), outside the counted run
    next(iter(system.render_eval_many(params, views, [0],
                                      quantize_rgb=True)))
    torch.cuda.synchronize()

    reset_counts()
    t0 = time.perf_counter()
    outs = list(system.render_eval_many(params, views, range(N_VIEWS),
                                        quantize_rgb=True))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(COUNTS)

    expect = {"invert_cdf": 2 * n_chunks * N_VIEWS,
              "composite_fwd": n_chunks * N_VIEWS,
              "fused_mlp_fwd": n_chunks * N_VIEWS,
              "composite_bwd": 0, "fused_mlp_bwd": 0}
    if counts != expect:
        fail(f"launch counts {counts}, expected {expect}")
    n_lr = (w // DOWNSCALE) * (h // DOWNSCALE)
    for out in outs:
        shapes = {k: v.shape for k, v in out.items()}
        want = {"fine_rgb": (n_lr, 3), "fine_depth": (n_lr,),
                "fine_rgb_ori": (n_hr, 3), "fine_depth_ori": (n_hr,)}
        if shapes != want:
            fail(f"output shapes {shapes}, expected {want}")
        if out["fine_rgb_ori"].dtype != np.uint8:
            fail("quantized rgb must be uint8")
        for k, v in out.items():
            if not np.isfinite(np.asarray(v, np.float64)).all():
                fail(f"{k}: non-finite values")
        # a scene with content: not a blank (all-empty) render
        if (out["fine_rgb_ori"].std() / 255 < 0.01
                or not 0.01 < out["fine_depth_ori"].mean() < 1.0):
            fail("the render is blank: no density along the rays")
    ms_per_image = wall / N_VIEWS * 1e3
    print(f"[slice] {N_VIEWS} views {w}x{h} (LR {w // DOWNSCALE}x"
          f"{h // DOWNSCALE}), {n_chunks} chunks of {chunk} per image: "
          f"{ms_per_image:.1f} ms/image, {n_hr / (wall / N_VIEWS):.0f} HR "
          f"rays/s on {card}; launches {counts}")

    # one chunk through the kernels and through the plain path, in the
    # slice's mixed precision and in f32 (same weights: same seed)
    spec = views.eval_raygen_spec(1)
    d = torch.from_numpy(views.eval_dirs()[:chunk]).to(dev)
    c2w = torch.from_numpy(np.asarray(spec["c2w"], np.float32)).to(dev)
    _, hh, ww, focal, near, far = spec["geom"]
    ro, rd = ndc_rays(hh, ww, focal, 1.0, *get_rays(d, c2w))
    rays = make_rays(ro, rd, near, far, rd)
    f32_opt = default_options("test", model="nerf_downX",
                              dataset_mode="llff_downX", fast_preset="llff",
                              img_wh=HR_WH, downscale=DOWNSCALE,
                              precision="f32")
    f32_system = create_model(f32_opt, device=dev)
    errs = {}
    for name, sys_, prm, (mean_bar, max_bar) in (
            ("mixed", system, params, SLICE_MIXED),
            ("f32", f32_system, f32_system.init_params(seed=0), SLICE_F32)):
        kernel_cfg = sys_.render_cfg
        with torch.no_grad():
            got = sys_.render(prm, rays, randomized=False)
            sys_.render_cfg = dataclasses.replace(kernel_cfg, plain=True)
            ref = sys_.render(prm, rays, randomized=False)
            sys_.render_cfg = kernel_cfg
        torch.cuda.synchronize()
        dz = float((got["fine_z"] - ref["fine_z"]).abs().max())
        for k in ("fine_rgb", "fine_depth"):
            if not torch.isfinite(got[k]).all():
                fail(f"slice chunk {name} {k}: non-finite output")
            diff = (got[k].double() - ref[k].double()).abs()
            mean, mx = float(diff.mean()), float(diff.max())
            print(f"[slice] one chunk {name} {k}, kernels vs plain path: "
                  f"mean abs err {mean:.3e} (bar {mean_bar}), max "
                  f"{mx:.3e} (bar {max_bar}); fine_z max diff {dz:.3e}")
            if mean > mean_bar or mx > max_bar:
                fail(f"slice chunk {name} {k} beyond its bars")
            errs[f"{name}_{k}"] = {"mean": mean, "max": mx}
    return counts, ms_per_image, n_hr / (wall / N_VIEWS), errs


def train_options(precision, **extra):
    from nerfsr_torch.config import default_options
    return default_options(
        "train", model="nerf_downX", dataset_mode="llff_downX",
        fast_preset="llff", img_wh=HR_WH, downscale=DOWNSCALE,
        precision=precision, batch_size=BATCH, n_epochs=30,
        n_epochs_decay=10, lr=5e-4, lr_final=5e-6, lr_policy="exp",
        include_var=True, ds_method="avg", **extra)


def teacher_buffer(dev):
    """4 training views of a teacher scene rendered by the port itself
    (random weights, seed 1, sigma biases +3 so the scene has content),
    LR truth by avg, as the grouped buffer on the card."""
    from nerfsr_torch.data.views import LLFFDownXTrainViews
    from nerfsr_torch.models import create_model

    system = create_model(train_options("mixed"), device=dev)
    teacher = system.init_params(seed=1)
    with torch.no_grad():
        for net in teacher.values():
            net.sigma.bias += 3.0
    views = LLFFDownXTrainViews.rendered(system, teacher, FOCAL, HR_WH,
                                         DOWNSCALE, N_TRAIN_VIEWS)
    if views.images.std() < 0.01:
        fail("the teacher scene is blank")
    return views.ray_buffer(dev, include_var=True)


def _grad_leaves(params):
    return [(name, p.grad) for name, p in params.named_parameters()]


def step_vs_plain(dev, buffer):
    """One step's loss and gradients through the kernels and through the
    plain path on the card: same params, batch and draws, no
    randomization."""
    from nerfsr_torch.models import create_model

    out = {}
    for precision in ("mixed", "f32"):
        opt = train_options(precision, randomized=False, noise_std=0.0)
        system = create_model(opt, device=dev)
        kernel_cfg = system.render_cfg
        gen = torch.Generator(device=dev).manual_seed(7)
        batch = system.sample_batch(buffer, gen)
        res = {}
        for name, plain in (("kernels", False), ("plain", True)):
            system.render_cfg = dataclasses.replace(kernel_cfg, plain=plain)
            state = system.create_state(seed=0)
            loss, _ = system._loss_fn(state.params, batch, None, 0)
            loss.backward()
            res[name] = (loss.item(), _grad_leaves(state.params))
        system.render_cfg = kernel_cfg
        loss_bar, grad_bar = STEP_BARS[precision]
        (lk, gk), (lp, gp) = res["kernels"], res["plain"]
        loss_rel = abs(lk - lp) / abs(lp)
        rels = {}
        for (name, a), (_, b) in zip(gk, gp):
            if not torch.isfinite(a).all():
                fail(f"step {precision} grad {name}: non-finite")
            rels[name] = float((a.double() - b.double()).norm()
                               / b.double().norm().clamp_min(1e-30))
        worst = max(rels, key=rels.get)
        median = float(np.median(list(rels.values())))
        print(f"[train] one step {precision}, kernels vs plain path: loss "
              f"{lk:.6f} vs {lp:.6f} (rel {loss_rel:.2e}, bar {loss_bar}); "
              f"gradients max leaf norm-relative err {rels[worst]:.3e} "
              f"({worst}, bar {grad_bar}), median {median:.3e}")
        if loss_rel > loss_bar or rels[worst] > grad_bar:
            fail(f"one step {precision}: kernels vs plain beyond the bars")
        out[precision] = {"loss_rel": loss_rel, "max_leaf_rel": rels[worst],
                          "worst_leaf": worst, "median_leaf_rel": median}
    return out


def train_phase(dev, card):
    from nerfsr_torch.kernels import COUNTS, LAUNCHES_PER_CALL, reset_counts
    from nerfsr_torch.models import create_model

    t0 = time.perf_counter()
    buffer = teacher_buffer(dev)
    n_lr = buffer["rgbs"].shape[0]
    print(f"[train] teacher scene: {N_TRAIN_VIEWS} views {HR_WH[0]}x"
          f"{HR_WH[1]}, {n_lr} LR pixels in the buffer, built in "
          f"{time.perf_counter() - t0:.1f} s")

    system = create_model(train_options("mixed"), device=dev)
    if not system.render_cfg.use_fused_mlp:
        fail("the training path must take the fused MLP kernels")
    state = system.create_state(seed=0, steps_per_epoch=n_lr // BATCH)
    gen = torch.Generator(device=dev).manual_seed(0)
    state, _ = system.train_steps(state, buffer, WARMUP_STEPS, gen)
    torch.cuda.synchronize()

    # one step: exact launch counts of every kernel
    reset_counts()
    state, _ = system.train_steps(state, buffer, 1, gen)
    torch.cuda.synchronize()
    per_step = dict(COUNTS)
    want = {"invert_cdf": 2, "composite_fwd": 1, "fused_mlp_fwd": 1,
            "composite_bwd": 1, "fused_mlp_bwd": 1}
    if per_step != want:
        fail(f"per-step launch counts {per_step}, expected {want}")

    # the timed window: TIMED_STEPS steps, one synchronize
    reset_counts()
    t0 = time.perf_counter()
    state, _ = system.train_steps(state, buffer, TIMED_STEPS, gen)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(COUNTS)
    if counts != {k: v * TIMED_STEPS for k, v in want.items()}:
        fail(f"launch counts over {TIMED_STEPS} steps: {counts}")
    ms_step = wall / TIMED_STEPS * 1e3
    rays_s = BATCH * DOWNSCALE ** 2 * TIMED_STEPS / wall
    sub = {k: v * LAUNCHES_PER_CALL[k] for k, v in counts.items()}
    print(f"[train] {TIMED_STEPS} steps of {BATCH} LR pixels "
          f"({BATCH * DOWNSCALE ** 2} HR rays): {ms_step:.2f} ms/step, "
          f"{rays_s:.0f} HR rays/s on {card}; calls {counts}, kernel "
          f"launches {sub} (E: tile, weight-gradient, reduce)")

    # the loss falls from a fresh student
    state = system.create_state(seed=0, steps_per_epoch=n_lr // BATCH)
    gen = torch.Generator(device=dev).manual_seed(1)
    mses = []
    for _ in range(FALL_STEPS):
        state, losses = system.train_step_from_buffer(state, buffer, gen)
        mses.append(losses["fine_mse"])
    mses = torch.stack(mses).cpu().numpy()
    first, last = float(mses[:20].mean()), float(mses[-20:].mean())
    print(f"[train] fine_mse over {FALL_STEPS} steps: first 20 mean "
          f"{first:.5f}, last 20 mean {last:.5f} (ratio {last / first:.3f},"
          f" bar {FALL_RATIO})")
    if not np.isfinite(mses).all() or last > FALL_RATIO * first:
        fail("fine_mse did not fall")
    for p in state.params.parameters():
        moments = state.optimizer.state[p]
        for t in (p, moments["exp_avg"], moments["exp_avg_sq"]):
            if not torch.isfinite(t).all():
                fail("non-finite parameters or Adam moments")
    print(f"[train] {sum(p.numel() for p in state.params.parameters())} "
          f"parameters and their Adam moments are finite after "
          f"{state.step} steps")
    step_err = step_vs_plain(dev, buffer)
    return counts, {"ms_per_step": ms_step, "hr_rays_per_s": rays_s,
                    "fine_mse_first20": first, "fine_mse_last20": last,
                    "step_vs_plain": step_err, "launches_per_step":
                    per_step, "kernel_launches_window": sub}


def main():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a "
             "CUDA card")
    sys.path.insert(0, ROOT)
    from nerfsr_torch.kernels import _lib

    card = card_line()
    print(f"[card] {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    t0 = time.perf_counter()
    _lib.lib()
    print(f"[build] kernels built and loaded in "
          f"{time.perf_counter() - t0:.1f} s")
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke_build.log"), "w") as f:
        f.write(_lib.build_log())

    gen = torch.Generator().manual_seed(0)
    a = check_invert_cdf(dev, gen)
    b = check_composite(dev, gen)
    c = check_fused_mlp(dev, gen)
    d = check_composite_bwd(dev, gen)
    e = check_fused_mlp_bwd(dev, gen)
    serve_counts, ms_img, rays_s, slice_err = slice_phase(dev, card)
    counts, train = train_phase(dev, card)

    # launches: the timed training window, which runs all five kernels
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")
    ops = "nerfsr_tpu/ops/experimental/"
    kernels = [
        dict(name="invert_cdf", route="cuda",
             source="nerfsr_torch/csrc/invert_cdf.cu",
             replaces=ops + "pallas_sampling.py:102",
             launches=counts["invert_cdf"], **{k: a[k] for k in keys}),
        dict(name="composite_fwd", route="cuda",
             source="nerfsr_torch/csrc/composite.cu",
             replaces=ops + "pallas_composite.py:155",
             launches=counts["composite_fwd"], **{k: b[k] for k in keys}),
        dict(name="fused_mlp_fwd", route="cuda",
             source="nerfsr_torch/csrc/fused_mlp.cu",
             replaces=ops + "pallas_mlp.py:183",
             launches=counts["fused_mlp_fwd"],
             **{k: c["bf16"][k] for k in keys}),
        dict(name="composite_bwd", route="cuda",
             source="nerfsr_torch/csrc/composite.cu",
             replaces=ops + "pallas_composite.py:177",
             launches=counts["composite_bwd"], **{k: d[k] for k in keys}),
        dict(name="fused_mlp_bwd", route="cuda",
             source="nerfsr_torch/csrc/fused_mlp_bwd.cu",
             replaces=ops + "pallas_mlp.py:433",
             launches=counts["fused_mlp_bwd"],
             **{k: e["bf16"][k] for k in keys}),
    ]
    for k in kernels:
        k["library_ms"] = None
    print(json.dumps({"detail": {"fused_mlp_f32": c["f32"],
                                 "fused_mlp_bf16_tflops":
                                     c["bf16"]["tflops"],
                                 "fused_mlp_bwd": e,
                                 "slice": {"ms_per_image": ms_img,
                                           "hr_rays_per_s": rays_s,
                                           "chunk_errors": slice_err,
                                           "launches": serve_counts},
                                 "train": train,
                                 "card": card}}))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
