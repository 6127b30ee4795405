#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``nerfsr_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

1. prints the card's name and power limit (nvidia-smi);
2. builds the CUDA kernels from ``nerfsr_torch/csrc`` (one nvcc per
   source, in parallel) and writes the compiler's report to
   ``chiprun_out/chip_smoke_build.log``;
   checks in that report that kernels A, B and D use no stack frame and
   no spills; times an empty kernel through the same harness as the
   kernels (the launch floor);
3. holds each kernel against its plain PyTorch version on the card and
   times both (device time per call, ``nerfsr_torch/timing.py``): the
   forward kernels at the serving path's shapes (inverse CDF per call at
   each of its two (B, Q) pairs, composite with both activations and both
   backgrounds, fused MLP in bf16 on the tensor cores and in f32 on
   SIMT, beside the same bf16 forward as a chain of cuBLAS products), the
   backward kernels at the training path's (composite backward at
   N=2048 with every cotangent nonzero, both activations and both
   backgrounds, at S=16 (the llff step) and S=64 and 128 (the parity
   step's two levels), each timed beside its bound; fused MLP backward at
   P=32,768 in bf16 and f32, with its three launches' split from the
   profiler). The MLP kernels are timed on weights packed before the
   timed calls (the wrapper's cache), so the packing is not in the time.
   Then each kernel again at the shapes the datasets phase gives it
   first (``check_new_shapes``): A at 95 and 47 bins (Q 48), B at S = 48,
   64 and 128 and D at S = 48 with a white background, C and E in bf16 at
   P = 131,072 and 262,144;
4. serving: renders three 504x378 NeRF-SR x2 views (``--fast_preset
   llff``, ``--precision mixed``, full-width D8/W256 MLP, random weights
   from a seed) through ``render_eval_many(..., quantize_rgb=True)``,
   checks the shapes, finiteness and every kernel's launch count, and
   holds one chunk against the plain path on the card;
5. training: renders 4 training views of a teacher scene (random
   weights, seed 1, sigma biases +3), derives the LR truth by ``avg``,
   uploads the grouped buffer, and trains a seed-0 student with Adam
   (``--batch_size 512`` LR pixels, 2048 HR rays a step) on the main
   path, ``train_steps_scan``'s graphed chunk (one CUDA-graph replay a
   step, as ``--scan_steps 20`` runs it): exact per-step launch counts,
   ms/step and HR rays/s over a timed window of replays of one graph,
   finite parameters and moments, a falling ``fine_mse``, and one
   step's loss and gradients through the kernels against the plain path;
   then the graphs phase: for llff and parity (mixed), a 20-step graphed
   chunk against the eager ``train_steps`` from the same seed (every
   parameter, moment and step count bit for bit, exact launch counts on
   both routes), each route's ms/step, the capture's time and memory; and
   the serving render, each view one replay, against the chunk loop bit
   for bit, with both routes' ms/image;
6. engine: renders the teacher (seed 1) at 504x378 on 8 centred spiral
   poses, writes them as a COLMAP scene (``nerfsr_torch/data/
   synthetic.py``) into a temporary directory, and drives
   ``nerfsr_torch.engine`` in-process with the flags of
   ``scripts/train_llff_downX_fast.sh`` (``--ds_method lanc``, 40 steps
   an epoch): trains 2 epochs, resumes with ``--continue_train`` for a
   third (the resumed parameters, Adam moments and step against the
   first run's, bit for bit), re-encodes ``latest_state.msgpack`` with
   the port's codec (same bytes), and renders ``--test_split
   test_train`` from epoch 3: every artifact file is there and each HR
   panel of ``{i}-fine-ori.png`` equals ``render_eval_many(...,
   quantize_rgb=True)``. It checks that every chunk of both training runs
   went through ``train_steps_scan`` (graph replays), the exact launch
   counts of each run (2 A, 1 B, 1 C, 1 D, 1 E a step; 94 A, 47 B, 47 C
   an image, replays included), and
   prints the engine's ms/step beside ``train_steps``', ms per test image
   with the writes, and the validation PSNR/SSIM;
7. datasets: writes an 800x800 RGBA Blender scene of the blob field
   (``write_blender_scene``, 8 train, 2 val, 2 test views) and checks
   that it reads back (poses, PNGs, the loaded HR truth); then trains and
   tests four runs through the engine with their scripts' flags and the
   cuts stated at ``DS_RUNS``: bx2 (NeRF-SR x2, parity, with the
   ``train_crop`` warm-up), bx4 (x4, ``--fast_preset blender``), vb
   (vanilla NeRF on Blender) and vl (vanilla NeRF on the engine phase's
   COLMAP scene at 252x189, tested at 504x378). Each run: exact launch
   counts, finite parameters and moments, ms/step, HR rays/s, the
   validation metrics, ``fine_mse`` on a fixed batch before and after
   (it must fall on bx2 and bx4), that the warm-up's chunks ran eagerly
   and every other chunk as graph replays, a 20-step graphed chunk equal
   to the eager one from the same seed with both routes' ms/step, and
   the test panels equal to
   ``render_eval_many(..., quantize_rgb=True)`` with the test ms/image
   with and without the writes; bx2 also checks that its first 50 steps
   drew only from the crop buffer and that a resume from epoch 1, across
   the warm-up's end, equals the unbroken run bit for bit;
8. refine: the refine stage on the engine phase's scene and its
   ``test_train`` renders (``scripts/train_llff_refine.sh`` at full width,
   cut as ``REFINE_TRAIN`` says): ``python -m nerfsr_torch.warp`` (files,
   the share of pixels that land in the reference view, one view's
   coordinates against the CPU's), ``train_refine`` for 3 epochs and for
   2 plus a ``--continue_train`` to 3 (the two equal bit for bit; each
   chunk graph replays, as the JAX refine engine scans), a fixed batch's
   l1 before and after, one step on the card against the CPU's (each
   gradient leaf held to an f64 step beside the CPU's), a graphed chunk
   against the eager one from the same seed (bit for bit) for the UNet
   and ``maxpoolingmodel`` with and without the references, and
   ``test_refine --test_split test_train`` (each stitched panel equal to
   a direct ``refine_image``); it prints ms/step (graphed and eager) and
   patches/s of the UNet and of ``maxpoolingmodel``, warp ms/view and
   test_refine
   ms/image with and without the writes. The path launches none of the
   five kernels (its convolutions are cuDNN's), and it checks that;
9. aux: the auxiliary training paths at full width on the engine
   phase's scene, each through ``engine.train`` for one epoch of 20
   steps with the flags of ``scripts/train_llff_downX_fast.sh``
   (``AUX_PATHS``): ``--with_netD`` (vanilla, ``--patch_len 32``,
   ``--gan_iter 10``) with ``--reg_patch --reg_patch_freq 5``;
   ``--gan_mode wgangp --use_grad``; ``--with_ref`` at ``--ref_freq`` 1
   and 3; and patch mode at ``scripts/train_llff.sh``'s widths
   (vanilla NeRF, 252x189, batch 2048, 64 + 64 samples, ``--patch_size
   32``, both depth-Laplacian weights and the fine VGG weight on a
   synthetic VGG19 archive it writes). Each: the engine's launch counts
   exactly the cadence's (20 main steps, 2 GAN and 4 TV updates: 56 A,
   28 B, 28 C, 26 D, 26 E), one update through the kernels against the
   plain versions in f32 and mixed precision, a graphed 20-step chunk
   equal to the eager one bit for bit (the discriminator too) with exact
   counts on both routes, and both routes' ms/step. Before it (with the
   kernel checks) ``check_aux_shapes`` holds A, B and D at N = 4 and
   1,024 rays and C and E at P = 64 and 16,384 points, the reg and GAN
   patches' shapes, against their plain versions;
10. refine_gan: ``--refine_as_gan`` at ``scripts/train_llff_refine.sh``'s
   full width on the engine phase's scene and renders (UNet ngf 64, 6
   downs, 32 patches of 64 px, D at ndf 64 with the 64 px depth, a fake
   pool of 50): one update pair on the card against the CPU's (D's rate
   1e-9), a graphed 20-step chunk equal to the eager one bit for bit (G,
   its running statistics, D, both Adams, the pool) with no port kernel
   launched, each route's ms/step, the capture and the pools' memory;
   then ``train_refine`` for one epoch of 40 steps (every logged loss
   finite, ``G_L1`` falling) and ``test_refine`` from it;
11. dist: the engine phase's run for one epoch with ``--num_processes 1
   --process_id 0 --coordinator 127.0.0.1:<port>`` (NCCL at world size
   1: the split step's collectives and the eval render's gather inside
   the graphs) against the same run without: each chunk's state bit for
   bit, the launch counts of training and test equal, the test PNGs
   byte for byte; a graphed chunk's ms/step with the collectives and
   without; and ``--mesh_devices 2`` refused, naming the card count;
12. zoo: the rest of the network zoo on the engine phase's scene.
   NeuTexMLP at full width (D8/W256, ``--mlp_network neutex_mlp``) in
   NeRF-SR x2 with ``scripts/train_llff_downX_fast.sh``'s flags: its
   layers take the module path (cuBLAS), not kernels C and E, so a step
   runs A twice, B and D once. One step through the kernels against the
   plain path (the training phase's bars), a graphed 20-step chunk
   against the eager one bit for bit with exact launch counts (2 A, 1 B,
   0 C, 1 D, 0 E a step) and both routes' ms/step, one engine epoch of
   40 steps (exact launches, the val view's fine PSNR rising from the
   seed's weights) and ``test`` from it (each HR panel equal to
   ``render_eval_many``'s, serving ms/image at 504x378); the template
   system trained through the engine with no ``--model`` (its mse
   falling, no port kernel launched); ResnetGenerator (ngf 64, 9 blocks,
   4x256x256) forward and backward on the card against the CPU in f32
   with its ms, and the bilateral renderer, ``grad_loss``, ConvBlock and
   Up2x against the CPU;
13. prints a JSON line of details (also written to
   ``chiprun_out/chip_smoke_detail.json``), the JSON line of kernel
   summaries (``{"kernels": [...]}``), the card line, and last
   ``{"ok": true, "device": {...}}``. Any failure exits non-zero.

It needs a CUDA card: without one it exits 1 and prints no result.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
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
# kernel D: its segmented shuffle scans (transmittance and suffix sums)
# vs the plain version's torch.cumprod and cumsum, on gradients of order
# 1-100 (seen: 4.8e-6, 9.5e-6 and 1.1e-5 abs at S = 16, 64 and 128)
TOL_COMPOSITE_BWD = (1e-3, 1e-4)
# kernel E, per leaf ||got - ref|| / ||ref||: sums over 32,768 points in
# another order (f32; seen 1.5e-6). In bf16 the rule itself is chaotic:
# a summation order that straddles a bf16 rounding midpoint flips one
# activation by an ulp, and the flip cascades through the later layers'
# roundings and masks. The plain version (cuBLAS f32 sums) is 7.3e-3 from
# the same rule with f64 sums at P = 32,768 on the H100; the tensor-core
# kernel is 9.3e-3 from it and 9.9e-3 from the plain version (the SIMT
# kernel read 1.7e-4 against the plain version: its sequential f32 sums
# flip less often). So the bf16 bar is 2e-2 against the plain version,
# and the kernel may be no further from the f64 rule than BWD_F64_RATIO
# times the plain version is.
TOL_MLP_BWD = {"f32": 1e-4, "bf16": 2e-2}
BWD_F64_RATIO = 2.0
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


def leaf_errors(got, ref):
    """(max over leaves of ||got - ref|| / ||ref||, max abs err)."""
    rel, abs_err = 0.0, 0.0
    for g, r in zip(got, ref):
        d = g.double() - r.double()
        rel = max(rel, float(d.norm() / r.double().norm().clamp_min(1e-30)))
        abs_err = max(abs_err, float(d.abs().max()))
    return rel, abs_err


def launch_split_ms(fn, calls=5):
    """Device ms per call of each of kernel E's launches (E1 tile, E2
    weight gradients, E3 reduce), from torch.profiler over `calls`
    calls."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        for part, tag in (("E1", "tile"), ("E2", "wgrad"),
                          ("E3", "reduce")):
            if "mlp_bwd" in e.key and tag in e.key:
                out[part] = out.get(part, 0.0) + \
                    e.device_time_total / calls / 1e3
    return out


def check_registers(log):
    """Kernels A, B and D keep every value in registers: no stack frame
    and no spills in the compiler's report."""
    from nerfsr_torch.timing import ptxas_report
    report = ptxas_report(log, ("invert_cdf_kernel", "composite_fwd_kernel",
                                "composite_bwd_kernel"))
    if len(report) != 9:        # A, and B's and D's four template cases
        fail(f"ptxas report of kernels A, B and D incomplete: {report}")
    for name, fig in report.items():
        print(f"[registers] {name}: {fig}")
        if fig["stack"] or fig["spill_stores"] or fig["spill_loads"]:
            fail(f"{name} uses local memory: {fig}")
    return report


def launch_floor():
    """Device ms of an empty kernel (one block of 32 threads) through the
    same graph harness as the kernels: what any launch costs."""
    from nerfsr_torch.timing import floor_ms
    floor = floor_ms()
    print(f"[floor] empty kernel: {floor:.4f} ms a launch")
    return floor


def check_invert_cdf(dev, gen):
    from nerfsr_torch.core.sampling import _invert_cdf
    from nerfsr_torch.kernels import COUNTS
    from nerfsr_torch.kernels.sampling import invert_cdf
    from nerfsr_torch.timing import (invert_cdf_bytes, invert_cdf_inputs,
                                     time_ms)

    # both (B, Q) pairs of the serving chunk; each launches once a chunk
    # (and once a training step), so the launch-weighted mean per call is
    # their plain mean
    n = 4096
    shapes = []
    for b, q in ((47, 24), (23, 16)):
        bins, w, u = invert_cdf_inputs(n, b, q, gen, dev)
        got = invert_cdf(bins, w, u)
        torch.cuda.synchronize()
        err = max_err(got, _invert_cdf(bins, w, u), 0.0, TOL_INVERT_CDF,
                      f"invert_cdf B={b} Q={q}")
        again = invert_cdf(bins, w, u)
        if not torch.equal(again, got):
            fail(f"invert_cdf B={b} Q={q}: two calls differ")
        shapes.append({
            "b": b, "q": q, "max_abs_err": err,
            "ms": time_ms(lambda: invert_cdf(bins, w, u)),
            "plain_ms": time_ms(lambda: _invert_cdf(bins, w, u)),
            "bound_ms": invert_cdf_bytes(n, b, q) / HBM_BYTES_PER_S * 1e3})
        print(f"[kernel A] invert_cdf N={n} B={b} Q={q}: max abs err "
              f"{err:.3e} (tol {TOL_INVERT_CDF}); {shapes[-1]['ms']:.4f} ms "
              f"a call, plain {shapes[-1]['plain_ms']:.4f} ms, bound "
              f"{shapes[-1]['bound_ms']:.5f} ms")
    out = {k: sum(sh[k] for sh in shapes) / len(shapes)
           for k in ("ms", "plain_ms", "bound_ms")}
    print(f"[kernel A] per call, mean of the two shapes: {out['ms']:.4f} ms, "
          f"plain {out['plain_ms']:.4f} ms, bound {out['bound_ms']:.5f} ms; "
          f"launches so far {COUNTS['invert_cdf']}")
    return {**out, "max_abs_err": max(sh["max_abs_err"] for sh in shapes),
            "bound_by": "bytes", "shapes": shapes}


def check_composite(dev, gen):
    from nerfsr_torch.core.rendering import volumetric_rendering as plain
    from nerfsr_torch.kernels import COUNTS
    from nerfsr_torch.kernels.composite import volumetric_rendering
    from nerfsr_torch.timing import (composite_fwd_bytes, composite_inputs,
                                     time_ms)

    n, s = 4096, 16
    rgb, sigma, z = composite_inputs(n, s, gen, dev)
    errs = []
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
    got = volumetric_rendering(rgb, sigma, z, False)
    if not all(torch.equal(a, g) for a, g in
               zip(volumetric_rendering(rgb, sigma, z, False), got)):
        fail("composite: two calls differ")
    timed = (time_ms(lambda: volumetric_rendering(rgb, sigma, z, False)),
             time_ms(lambda: plain(rgb, sigma, z, False)))
    bytes_moved = composite_fwd_bytes(n, s)
    print(f"[kernel B] relu, no white background: {timed[0]:.4f} ms, plain "
          f"{timed[1]:.4f} ms; launches so far {COUNTS['composite_fwd']}")
    return {"max_abs_err": max(errs), "ms": timed[0], "plain_ms": timed[1],
            "bound_ms": bytes_moved / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes"}


def bf16_chain(flat, x0, dmb):
    """The bf16 forward as a chain of cuBLAS bf16 products (torch.addmm,
    bf16 in and out) with ReLU, concat and sigmoid in PyTorch: a yardstick
    for kernel C, timed here and used nowhere in the port."""
    from nerfsr_torch.kernels import mlp as kmlp
    ws = [k.to(torch.bfloat16).contiguous() for k in flat[0::2]]
    bs = [b.reshape(-1).to(torch.bfloat16) for b in flat[1::2]]
    xb, db = x0.to(torch.bfloat16), dmb.to(torch.bfloat16)

    def run():
        h = xb
        for i in range(kmlp.D):
            inp = torch.cat([xb, h], -1) if i == kmlp.SKIP else h
            h = torch.relu(torch.addmm(bs[i], inp, ws[i]))
        d = kmlp.D
        feat = torch.addmm(bs[d], h, ws[d])
        sigma = torch.addmm(bs[d + 1], h, ws[d + 1])
        g = torch.relu(torch.addmm(bs[d + 2], torch.cat([feat, db], -1),
                                   ws[d + 2]))
        return torch.sigmoid(torch.addmm(bs[d + 3], g, ws[d + 3])), sigma
    return run


def mlp_fwd_bound(p, key):
    """(operations, bound ms) of kernel C over P points: the products at
    the peak rate of their type, or the inputs, weights and outputs over
    the memory rate."""
    from nerfsr_torch.kernels import mlp as kmlp
    flops = 2.0 * kmlp.N_WEIGHTS * p
    bytes_moved = (4 * p * (kmlp.C_POS + kmlp.C_DIR + 3 + 1)
                   + kmlp.N_WEIGHTS * (2 if key == "bf16" else 4)
                   + 4 * kmlp.N_BIASES)
    return flops, max(flops / PEAK_FLOPS[key],
                      bytes_moved / HBM_BYTES_PER_S) * 1e3


def mlp_bwd_bound(p, key):
    """(operations, bound ms) of kernel E over P points, as
    ``mlp_fwd_bound`` with E's multiply-adds and its gradient output."""
    from nerfsr_torch.kernels import mlp as kmlp
    flops = 2.0 * E_MACS_PER_POINT * p
    bytes_moved = (4 * p * (kmlp.C_POS + kmlp.C_DIR + 3 + 1)
                   + kmlp.N_WEIGHTS * (2 if key == "bf16" else 4)
                   + 4 * kmlp.N_BIASES
                   + 4 * (kmlp.N_WEIGHTS + kmlp.N_BIASES))
    return flops, max(flops / PEAK_FLOPS[key],
                      bytes_moved / HBM_BYTES_PER_S) * 1e3


def check_fused_mlp(dev, gen):
    from nerfsr_torch.kernels import COUNTS
    from nerfsr_torch.kernels import mlp as kmlp
    from nerfsr_torch.models.mlp import VanillaMLP
    from nerfsr_torch.timing import time_ms

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
            flops, bound = mlp_fwd_bound(p, key)
            out[key] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                        "bound_ms": bound, "bound_by": "operations",
                        "tflops": flops / ms / 1e9}
            if key == "bf16":
                chain = bf16_chain(flat, x0, dmb)
                out[key]["cublas_chain_ms"] = time_ms(chain, iters=10)
                print(f"[kernel C] yardstick: the same bf16 forward as a "
                      f"chain of bf16 torch.addmm calls (cuBLAS) with "
                      f"bias/ReLU in PyTorch: "
                      f"{out[key]['cublas_chain_ms']:.3f} ms")
            print(f"[kernel C] fused_mlp {key} P={p}: max abs err "
                  f"{err:.3e} (rtol, atol {tol}); {ms:.3f} ms "
                  f"({out[key]['tflops']:.1f} TFLOP/s), plain "
                  f"{plain_ms:.3f} ms, bound {bound:.3f} ms; launches so "
                  f"far {COUNTS['fused_mlp_fwd']}")
    return out


def check_composite_bwd(dev, gen):
    """Kernel D at the training batch (N = 2048) and each S a training step
    composites: 16 (llff), 64 and 128 (parity's coarse and fine levels).
    The first is the kernels line's entry, the others the detail line's."""
    from nerfsr_torch.kernels import COUNTS
    from nerfsr_torch.kernels.composite import (composite_bwd,
                                                composite_bwd_plain,
                                                composite_fwd)
    from nerfsr_torch.timing import (composite_bwd_bytes,
                                     composite_bwd_inputs, time_ms)

    n = BATCH * DOWNSCALE ** 2
    shapes = []
    for s in (16, 64, 128):
        args = composite_bwd_inputs(n, s, gen, dev)
        errs = []
        for act in ("relu", "softplus"):
            for white in (False, True):
                got = composite_bwd(*args, white, act)
                torch.cuda.synchronize()
                ref = composite_bwd_plain(*args, white, act)
                for g, r, name in zip(got, ref, ("grgb", "gsigma", "gz")):
                    errs.append(max_err(g, r, *TOL_COMPOSITE_BWD,
                                        f"composite_bwd S={s} {act} "
                                        f"white={white} {name}"))
                if not all(torch.equal(a, g) for a, g in
                           zip(composite_bwd(*args, white, act), got)):
                    fail(f"composite_bwd S={s} {act} white={white}: two "
                         "calls differ")
        # grgb = w gc: with gc = 1 it is B's weights, to the bit
        ones = (torch.ones_like(args[3]), torch.zeros_like(args[4]),
                torch.zeros_like(args[5]), torch.zeros_like(args[6]))
        if not torch.equal(composite_bwd(*args[:3], *ones, False)[0][..., 0],
                           composite_fwd(*args[:3], False)[3]):
            fail(f"composite_bwd S={s}: its weights are not B's")
        # the training path's variant: relu, no white background
        shapes.append({
            "n": n, "s": s, "max_abs_err": max(errs),
            "ms": time_ms(lambda: composite_bwd(*args, False)),
            "plain_ms": time_ms(lambda: composite_bwd_plain(*args, False)),
            "bound_ms": composite_bwd_bytes(n, s) / HBM_BYTES_PER_S * 1e3})
        sh = shapes[-1]
        print(f"[kernel D] composite_bwd N={n} S={s}: max abs err "
              f"{sh['max_abs_err']:.3e} (rtol, atol {TOL_COMPOSITE_BWD}); "
              f"relu, no white background {sh['ms']:.4f} ms a call, plain "
              f"{sh['plain_ms']:.4f} ms, bound {sh['bound_ms']:.5f} ms; "
              f"launches so far {COUNTS['composite_bwd']}")
    return {**shapes[0], "bound_by": "bytes", "shapes": shapes}


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
    from nerfsr_torch.timing import time_ms

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
            for i, g in enumerate(got):
                if not torch.isfinite(g).all():
                    fail(f"fused_mlp_bwd {key} leaf {i}: non-finite")
            rel, abs_err = leaf_errors(got, ref)
            # the rule's own floor: the plain version (f32 sums) and the
            # kernel, each against the same rule with f64 sums
            ref64 = kmlp.fused_mlp_bwd_plain(
                tuple(t.double() for t in flat), x0.double(), dmb.double(),
                grgb.double(), gsig.double(), dtype)
            plain_vs_f64 = leaf_errors(ref, ref64)[0]
            kernel_vs_f64 = leaf_errors(got, ref64)[0]
            print(f"[kernel E] {key}: max leaf norm-relative err against "
                  f"the rule in f64: plain {plain_vs_f64:.3e}, kernel "
                  f"{kernel_vs_f64:.3e}")
            if rel > TOL_MLP_BWD[key]:
                fail(f"fused_mlp_bwd {key}: leaf norm-relative error "
                           f"{rel:.3e} > {TOL_MLP_BWD[key]}")
            if key == "bf16" and kernel_vs_f64 > BWD_F64_RATIO * plain_vs_f64:
                fail(f"fused_mlp_bwd bf16: {kernel_vs_f64:.3e} from "
                           f"the f64 rule, over {BWD_F64_RATIO} x the plain "
                           f"version's {plain_vs_f64:.3e}")
            again = kmlp.fused_mlp_bwd(flat, x0, dmb, grgb, gsig, dtype)
            if not all(torch.equal(a, g) for a, g in zip(again, got)):
                fail(f"fused_mlp_bwd {key}: two calls differ")
            ms = time_ms(lambda: kmlp.fused_mlp_bwd(flat, x0, dmb, grgb,
                                                    gsig, dtype), iters=10)
            plain_ms = time_ms(lambda: kmlp.fused_mlp_bwd_plain(
                flat, x0, dmb, grgb, gsig, dtype), iters=10)
            flops, bound = mlp_bwd_bound(p, key)
            out[key] = {"max_abs_err": abs_err, "max_leaf_rel_err": rel,
                        "plain_vs_f64_rel": plain_vs_f64,
                        "kernel_vs_f64_rel": kernel_vs_f64,
                        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                        "bound_by": "operations",
                        "tflops": flops / ms / 1e9,
                        "launch_ms": launch_split_ms(
                            lambda: kmlp.fused_mlp_bwd(flat, x0, dmb, grgb,
                                                       gsig, dtype))}
            print(f"[kernel E] {key} per launch (profiler, ms): "
                  f"{out[key]['launch_ms']}")
            print(f"[kernel E] fused_mlp_bwd {key} P={p}: max leaf "
                  f"norm-relative err {rel:.3e} (bar {TOL_MLP_BWD[key]}), "
                  f"max abs err {abs_err:.3e}; {ms:.3f} ms "
                  f"({out[key]['tflops']:.1f} TFLOP/s), plain "
                  f"{plain_ms:.3f} ms, bound {bound:.3f} ms; calls so far "
                  f"{COUNTS['fused_mlp_bwd']}")
    return out


def _mlp_case(p, gen, dev):
    """A full-width MLP's flat weights and P points' embeddings and
    cotangents (as kernel E meets them in a step)."""
    from nerfsr_torch.kernels import mlp as kmlp
    from nerfsr_torch.models.mlp import VanillaMLP
    net = VanillaMLP().reset_parameters("kaiming", 0.02, gen).to(dev)
    pts = (torch.rand((p, 3), generator=gen) * 2 - 1).to(dev)
    dirs = torch.nn.functional.normalize(
        torch.randn((p, 3), generator=gen), dim=-1).to(dev)
    grgb = (torch.randn((p, 3), generator=gen) * 1e-3).to(dev)
    gsig = (torch.randn((p,), generator=gen) * 1e-3).to(dev)
    with torch.no_grad():
        flat = tuple(t.detach() for t in kmlp.flatten_params(net))
        x0, dmb = kmlp.embed(pts, dirs)
    return flat, x0, dmb, grgb, gsig


@torch.no_grad()
def check_new_shapes(dev, gen):
    """Every kernel against its plain version, and timed, at the shapes
    the datasets phase gives it for the first time (N = 2048 HR rays a
    step): A at the --fast_preset blender step's 95 and 47 bins (Q 48);
    B and D at S = 48 (that step) and B at 64 and 128 (the parity step's
    levels), white background; C and E in bf16 at P = 131,072 and 262,144
    (the parity step's coarse and fine levels), E to its 2e-2-a-leaf bar
    and within BWD_F64_RATIO of the plain version's distance from the f64
    rule."""
    from nerfsr_torch.core.rendering import volumetric_rendering as plain
    from nerfsr_torch.core.sampling import _invert_cdf
    from nerfsr_torch.kernels import mlp as kmlp
    from nerfsr_torch.kernels.composite import (composite_bwd,
                                                composite_bwd_plain,
                                                volumetric_rendering)
    from nerfsr_torch.kernels.sampling import invert_cdf
    from nerfsr_torch.timing import (composite_bwd_bytes,
                                     composite_bwd_inputs,
                                     composite_fwd_bytes, composite_inputs,
                                     invert_cdf_bytes, invert_cdf_inputs,
                                     time_ms)
    n = BATCH * DOWNSCALE ** 2
    out = {"A": [], "B": [], "D": [], "C": [], "E": []}

    def record(kernel, shape, err, fn, plain_fn, bound, **extra):
        iters = 5 if kernel in "CE" else 20
        row = {**shape, "max_abs_err": err, "ms": time_ms(fn, iters=iters),
               "plain_ms": time_ms(plain_fn, iters=iters),
               "bound_ms": bound, **extra}
        out[kernel].append(row)
        print(f"[new shapes] kernel {kernel} {shape}: max abs err "
              f"{err:.3e}; {row['ms']:.4f} ms a call, plain "
              f"{row['plain_ms']:.4f} ms, bound {bound:.5f} ms"
              + "".join(f", {k} {v:.3e}" for k, v in extra.items()))

    for b, q in ((95, 48), (47, 48)):
        bins, w, u = invert_cdf_inputs(n, b, q, gen, dev)
        err = max_err(invert_cdf(bins, w, u), _invert_cdf(bins, w, u), 0.0,
                      TOL_INVERT_CDF, f"invert_cdf B={b} Q={q}")
        record("A", {"n": n, "bins": b, "q": q}, err,
               lambda: invert_cdf(bins, w, u),
               lambda: _invert_cdf(bins, w, u),
               invert_cdf_bytes(n, b, q) / HBM_BYTES_PER_S * 1e3)
    for s in (48, 64, 128):
        rgb, sigma, z = composite_inputs(n, s, gen, dev)
        got = volumetric_rendering(rgb, sigma, z, True)
        err = max(max_err(g, r, *TOL_COMPOSITE, f"composite S={s} white")
                  for g, r in zip(got, plain(rgb, sigma, z, True)))
        record("B", {"n": n, "s": s, "white": True}, err,
               lambda: volumetric_rendering(rgb, sigma, z, True),
               lambda: plain(rgb, sigma, z, True),
               composite_fwd_bytes(n, s) / HBM_BYTES_PER_S * 1e3)
    args = composite_bwd_inputs(n, 48, gen, dev)
    err = 0.0
    for act in ("relu", "softplus"):
        for white in (False, True):
            for g, r in zip(composite_bwd(*args, white, act),
                            composite_bwd_plain(*args, white, act)):
                err = max(err, max_err(g, r, *TOL_COMPOSITE_BWD,
                                       f"composite_bwd S=48 {act} "
                                       f"white={white}"))
    record("D", {"n": n, "s": 48, "white": True}, err,
           lambda: composite_bwd(*args, True),
           lambda: composite_bwd_plain(*args, True),
           composite_bwd_bytes(n, 48) / HBM_BYTES_PER_S * 1e3)
    bf16 = torch.bfloat16
    for p in (n * 64, n * 128):
        flat, x0, dmb, grgb, gsig = _mlp_case(p, gen, dev)
        rgb, sigma = kmlp.fused_mlp_fwd(flat, x0, dmb, bf16)
        rgb_r, sigma_r = kmlp.fused_mlp_plain(flat, x0, dmb, bf16)
        err = max(max_err(rgb, rgb_r, *TOL_MLP_BF16, f"fused_mlp P={p} rgb"),
                  max_err(sigma, sigma_r, *TOL_MLP_BF16,
                          f"fused_mlp P={p} sigma"))
        del rgb, sigma, rgb_r, sigma_r
        record("C", {"p": p, "dtype": "bf16"}, err,
               lambda: kmlp.fused_mlp_fwd(flat, x0, dmb, bf16),
               lambda: kmlp.fused_mlp_plain(flat, x0, dmb, bf16),
               mlp_fwd_bound(p, "bf16")[1])
        got = kmlp.fused_mlp_bwd(flat, x0, dmb, grgb, gsig, bf16)
        ref = kmlp.fused_mlp_bwd_plain(flat, x0, dmb, grgb, gsig, bf16)
        rel, abs_err = leaf_errors(got, ref)
        ref64 = kmlp.fused_mlp_bwd_plain(
            tuple(t.double() for t in flat), x0.double(), dmb.double(),
            grgb.double(), gsig.double(), bf16)
        plain_vs_f64 = leaf_errors(ref, ref64)[0]
        kernel_vs_f64 = leaf_errors(got, ref64)[0]
        del ref64
        if rel > TOL_MLP_BWD["bf16"] or \
                kernel_vs_f64 > BWD_F64_RATIO * plain_vs_f64:
            fail(f"fused_mlp_bwd bf16 P={p}: leaf err {rel:.3e} (bar "
                 f"{TOL_MLP_BWD['bf16']}), {kernel_vs_f64:.3e} from the f64 "
                 f"rule against the plain version's {plain_vs_f64:.3e}")
        record("E", {"p": p, "dtype": "bf16"}, abs_err,
               lambda: kmlp.fused_mlp_bwd(flat, x0, dmb, grgb, gsig, bf16),
               lambda: kmlp.fused_mlp_bwd_plain(flat, x0, dmb, grgb, gsig,
                                                bf16),
               mlp_bwd_bound(p, "bf16")[1], max_leaf_rel_err=rel,
               plain_vs_f64_rel=plain_vs_f64,
               kernel_vs_f64_rel=kernel_vs_f64)
        del flat, x0, dmb, grgb, gsig, got, ref
        torch.cuda.empty_cache()
    return out


@torch.no_grad()
def check_aux_shapes(dev, gen):
    """Every kernel against its plain version, and timed, at the shapes
    the auxiliary paths give it for the first time: the reg patch's 4 HR
    rays and the GAN patch's 1,024 (``--fast_preset llff``): A at both
    proposal rounds (47 bins, Q 24; 23 bins, Q 16), B and D at S = 16
    (every cotangent nonzero: the depth's, as patch mode's Laplacian
    sends one), C and E in bf16 at P = 64 and 16,384 (16 samples a ray);
    P = 64 is below one of C's and E's tiles."""
    from nerfsr_torch.core.rendering import volumetric_rendering as plain
    from nerfsr_torch.core.sampling import _invert_cdf
    from nerfsr_torch.kernels import mlp as kmlp
    from nerfsr_torch.kernels.composite import (composite_bwd,
                                                composite_bwd_plain,
                                                volumetric_rendering)
    from nerfsr_torch.kernels.sampling import invert_cdf
    from nerfsr_torch.timing import (composite_bwd_bytes,
                                     composite_bwd_inputs,
                                     composite_fwd_bytes, composite_inputs,
                                     invert_cdf_bytes, invert_cdf_inputs,
                                     time_ms)
    out = {"A": [], "B": [], "D": [], "C": [], "E": []}

    def record(kernel, shape, err, fn, plain_fn, bound, **extra):
        iters = 5 if kernel in "CE" else 20
        row = {**shape, "max_abs_err": err, "ms": time_ms(fn, iters=iters),
               "plain_ms": time_ms(plain_fn, iters=iters),
               "bound_ms": bound, **extra}
        out[kernel].append(row)
        print(f"[aux shapes] kernel {kernel} {shape}: max abs err "
              f"{err:.3e}; {row['ms']:.4f} ms a call, plain "
              f"{row['plain_ms']:.4f} ms, bound {bound:.6f} ms")

    bf16 = torch.bfloat16
    for n in (4, 1024):
        for b, q in ((47, 24), (23, 16)):
            bins, w, u = invert_cdf_inputs(n, b, q, gen, dev)
            err = max_err(invert_cdf(bins, w, u), _invert_cdf(bins, w, u),
                          0.0, TOL_INVERT_CDF, f"invert_cdf N={n} B={b}")
            record("A", {"n": n, "bins": b, "q": q}, err,
                   lambda: invert_cdf(bins, w, u),
                   lambda: _invert_cdf(bins, w, u),
                   invert_cdf_bytes(n, b, q) / HBM_BYTES_PER_S * 1e3)
        rgb, sigma, z = composite_inputs(n, 16, gen, dev)
        err = max(max_err(g, r, *TOL_COMPOSITE, f"composite N={n}")
                  for g, r in zip(volumetric_rendering(rgb, sigma, z, False),
                                  plain(rgb, sigma, z, False)))
        record("B", {"n": n, "s": 16}, err,
               lambda: volumetric_rendering(rgb, sigma, z, False),
               lambda: plain(rgb, sigma, z, False),
               composite_fwd_bytes(n, 16) / HBM_BYTES_PER_S * 1e3)
        args = composite_bwd_inputs(n, 16, gen, dev)
        err = max(max_err(g, r, *TOL_COMPOSITE_BWD, f"composite_bwd N={n}")
                  for g, r in zip(composite_bwd(*args, False),
                                  composite_bwd_plain(*args, False)))
        record("D", {"n": n, "s": 16}, err,
               lambda: composite_bwd(*args, False),
               lambda: composite_bwd_plain(*args, False),
               composite_bwd_bytes(n, 16) / HBM_BYTES_PER_S * 1e3)
        p = n * 16
        flat, x0, dmb, grgb, gsig = _mlp_case(p, gen, dev)
        rgb, sigma = kmlp.fused_mlp_fwd(flat, x0, dmb, bf16)
        rgb_r, sigma_r = kmlp.fused_mlp_plain(flat, x0, dmb, bf16)
        err = max(max_err(rgb, rgb_r, *TOL_MLP_BF16, f"fused_mlp P={p}"),
                  max_err(sigma, sigma_r, *TOL_MLP_BF16,
                          f"fused_mlp P={p} sigma"))
        record("C", {"p": p, "dtype": "bf16"}, err,
               lambda: kmlp.fused_mlp_fwd(flat, x0, dmb, bf16),
               lambda: kmlp.fused_mlp_plain(flat, x0, dmb, bf16),
               mlp_fwd_bound(p, "bf16")[1])
        got = kmlp.fused_mlp_bwd(flat, x0, dmb, grgb, gsig, bf16)
        ref = kmlp.fused_mlp_bwd_plain(flat, x0, dmb, grgb, gsig, bf16)
        rel, abs_err = leaf_errors(got, ref)
        if rel > TOL_MLP_BWD["bf16"]:
            fail(f"fused_mlp_bwd bf16 P={p}: leaf err {rel:.3e} (bar "
                 f"{TOL_MLP_BWD['bf16']})")
        record("E", {"p": p, "dtype": "bf16"}, abs_err,
               lambda: kmlp.fused_mlp_bwd(flat, x0, dmb, grgb, gsig, bf16),
               lambda: kmlp.fused_mlp_bwd_plain(flat, x0, dmb, grgb, gsig,
                                                bf16),
               mlp_bwd_bound(p, "bf16")[1], max_leaf_rel_err=rel)
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


def train_options(precision, preset="llff", **extra):
    from nerfsr_torch.config import default_options
    return default_options(
        "train", model="nerf_downX", dataset_mode="llff_downX",
        fast_preset=preset, img_wh=HR_WH, downscale=DOWNSCALE,
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


def step_vs_plain(dev, buffer, mlp_network="vanilla_mlp"):
    """One step's loss and gradients through the kernels and through the
    plain path on the card: same params, batch and draws, no
    randomization."""
    from nerfsr_torch.models import create_model

    out = {}
    for precision in ("mixed", "f32"):
        opt = train_options(precision, randomized=False, noise_std=0.0,
                            mlp_network=mlp_network)
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
        print(f"[train] one step {precision} ({mlp_network}), kernels vs "
              f"plain path: loss "
              f"{lk:.6f} vs {lp:.6f} (rel {loss_rel:.2e}, bar {loss_bar}); "
              f"gradients max leaf norm-relative err {rels[worst]:.3e} "
              f"({worst}, bar {grad_bar}), median {median:.3e}")
        if loss_rel > loss_bar or rels[worst] > grad_bar:
            fail(f"one step {precision}: kernels vs plain beyond the bars")
        out[precision] = {"loss_rel": loss_rel, "max_leaf_rel": rels[worst],
                          "worst_leaf": worst, "median_leaf_rel": median}
    return out


def train_phase(dev, card):
    """The training slice on its main path, the graphed chunk
    (``train_steps_scan``, as ``--scan_steps 20`` runs it): exact launch
    counts a step, ms/step over a timed window of replays, a falling
    ``fine_mse``, finite parameters and moments, one step against the
    plain path. Returns the window's counts, the details and the
    teacher buffer."""
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
    # the first chunk: one eager step, the capture, then replays
    state, _ = system.train_steps_scan(state, buffer, WARMUP_STEPS, gen)
    torch.cuda.synchronize()

    # one step, one replay: exact launch counts of every kernel
    reset_counts()
    state, _ = system.train_steps_scan(state, buffer, 1, gen)
    torch.cuda.synchronize()
    per_step = dict(COUNTS)
    want = {"invert_cdf": 2, "composite_fwd": 1, "fused_mlp_fwd": 1,
            "composite_bwd": 1, "fused_mlp_bwd": 1}
    if per_step != want:
        fail(f"per-step launch counts {per_step}, expected {want}")

    # the timed window: TIMED_STEPS replays, one synchronize
    graph = _train_graph(system)
    replays = graph.replays
    reset_counts()
    t0 = time.perf_counter()
    state, _ = system.train_steps_scan(state, buffer, TIMED_STEPS, gen)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(COUNTS)
    if counts != {k: v * TIMED_STEPS for k, v in want.items()}:
        fail(f"launch counts over {TIMED_STEPS} steps: {counts}")
    if graph.replays - replays != TIMED_STEPS or \
            _train_graph(system) is not graph:
        fail("the timed window's steps were not replays of one graph")
    ms_step = wall / TIMED_STEPS * 1e3
    rays_s = BATCH * DOWNSCALE ** 2 * TIMED_STEPS / wall
    sub = {k: v * LAUNCHES_PER_CALL[k] for k, v in counts.items()}
    print(f"[train] {TIMED_STEPS} steps of {BATCH} LR pixels "
          f"({BATCH * DOWNSCALE ** 2} HR rays), graph replays: "
          f"{ms_step:.2f} ms/step, {rays_s:.0f} HR rays/s on {card}; calls "
          f"{counts}, kernel launches {sub} (E: tile, weight-gradient, "
          f"reduce)")

    # the loss falls from a fresh student (one-step chunks: every step's
    # loss, copied out of the graph's outputs before the next replay)
    state = system.create_state(seed=0, steps_per_epoch=n_lr // BATCH)
    gen = torch.Generator(device=dev).manual_seed(1)
    mses = []
    for _ in range(FALL_STEPS):
        state, losses = system.train_steps_scan(state, buffer, 1, gen)
        mses.append(losses["fine_mse"].clone())
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
                    per_step, "kernel_launches_window": sub}, buffer


def _train_graph(system):
    """The captured training step of ``system``'s chunks."""
    graphs = [e for k, e in system.graphs.entries().items()
              if k[0] == "train"]
    if len(graphs) != 1:
        fail(f"{len(graphs)} captured training steps, expected 1")
    return graphs[0]


# graphs phase: each chunk and eval image as CUDA-graph replays against
# the eager route from the same seed, and the two routes' times
GRAPH_STEPS = 20            # a chunk, as --scan_steps 20 cuts it


def _states_equal(a, b):
    """The number of tensors of two training or refine states
    (parameters, batch statistics, Adam moments and steps); fails unless
    each is equal bit for bit."""
    from nerfsr_torch.models.refine_system import RefineState
    fn = _refine_tensors if isinstance(a, RefineState) else _state_tensors
    ta, tb = fn(a), fn(b)
    differ = [k for k in ta if k not in tb or not torch.equal(ta[k], tb[k])]
    if differ or ta.keys() != tb.keys():
        fail(f"the graphed chunk differs from the eager one in "
             f"{len(differ)} tensors, first {differ[:3]}")
    return len(ta)


def chunk_vs_eager(dev, make_system, buffers, steps=GRAPH_STEPS,
                   counts=None):
    """``steps`` steps of the eager ``train_steps`` and of the graphed
    ``train_steps_scan`` from the same seed on fresh states: every state
    tensor bit for bit, the launch counts of both (``counts``: a step's),
    then each route's ms/step over another chunk (host clock to a
    synchronize), and the graph's capture time and memory."""
    from nerfsr_torch.kernels import COUNTS, reset_counts
    runs, out = {}, {}
    for route in ("eager", "graphed"):
        system = make_system()
        state = system.create_state(seed=0, steps_per_epoch=10 * steps)
        run = system.train_steps if route == "eager" \
            else system.train_steps_scan
        gen = torch.Generator(device=dev).manual_seed(0)
        reset_counts()
        state, _ = run(state, buffers, steps, gen)
        torch.cuda.synchronize()
        if counts is not None and dict(COUNTS) != {
                k: v * steps for k, v in counts.items()}:
            fail(f"{route} chunk: launch counts {dict(COUNTS)}, a step "
                 f"{counts}")
        runs[route] = state
        gen.manual_seed(1)
        t0 = time.perf_counter()
        state, _ = run(state, buffers, steps, gen)
        torch.cuda.synchronize()
        out[f"{route}_ms_per_step"] = (time.perf_counter() - t0) / steps * 1e3
        if route == "graphed":
            graph = _train_graph(system)
            out.update(capture_s=graph.capture_s,
                       graph_pool_mib=graph.pool_bytes / 2 ** 20,
                       replays=graph.replays)
            if graph.replays != 2 * steps - 1:
                fail(f"{graph.replays} replays, expected {2 * steps - 1}")
        del system, state
        torch.cuda.empty_cache()
    out["tensors_equal"] = _states_equal(runs["eager"], runs["graphed"])
    return out


def eval_vs_eager(dev, card):
    """NeRF-SR x2 serving: each view one graph replay against the chunk
    loop (the same system's eager route) on the same weights, bit for
    bit, and both routes' ms/image."""
    from nerfsr_torch.config import default_options
    from nerfsr_torch.data.views import LLFFDownXViews
    from nerfsr_torch.kernels import COUNTS, reset_counts
    from nerfsr_torch.models import create_model

    opt = default_options("test", model="nerf_downX",
                          dataset_mode="llff_downX", fast_preset="llff",
                          img_wh=HR_WH, downscale=DOWNSCALE,
                          precision="mixed")
    views = LLFFDownXViews.spiral(FOCAL, HR_WH, DOWNSCALE, N_VIEWS + 1)
    chunks = -(-(HR_WH[0] * HR_WH[1]) // 4096)
    out, renders = {}, {}
    for route in ("eager", "graphed"):
        system = create_model(opt, device=dev)
        if route == "eager":
            system.graphs = None
        params = system.init_params(seed=0)
        list(system.render_eval_many(params, views, [0]))   # warm-up
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        renders[route] = list(system.render_eval_many(
            params, views, range(1, N_VIEWS + 1)))
        torch.cuda.synchronize()
        out[f"{route}_ms_per_image"] = (time.perf_counter() - t0) \
            / N_VIEWS * 1e3
        want = {"invert_cdf": 2 * chunks * N_VIEWS,
                "composite_fwd": chunks * N_VIEWS,
                "fused_mlp_fwd": chunks * N_VIEWS,
                "composite_bwd": 0, "fused_mlp_bwd": 0}
        if dict(COUNTS) != want:
            fail(f"eval {route}: launch counts {dict(COUNTS)}, expected "
                 f"{want}")
        if route == "graphed":
            graphs = system.graphs.entries()
            if len(graphs) != 1:
                fail(f"{len(graphs)} eval graphs, expected 1")
            graph = next(iter(graphs.values()))
            if graph.replays != N_VIEWS:
                fail(f"{graph.replays} eval replays, expected {N_VIEWS}")
            out.update(capture_s=graph.capture_s,
                       graph_pool_mib=graph.pool_bytes / 2 ** 20)
    for a, b in zip(renders["eager"], renders["graphed"]):
        for k in a:
            if not np.array_equal(a[k], b[k]):
                fail(f"eval {k}: the graph replay differs from the chunk "
                     "loop")
    print(f"[graphs] eval: {N_VIEWS} views {HR_WH[0]}x{HR_WH[1]}, one "
          f"replay of {chunks} chunks each, equal to the chunk loop bit for "
          f"bit; {out['graphed_ms_per_image']:.1f} ms/image graphed, "
          f"{out['eager_ms_per_image']:.1f} eager; capture "
          f"{out['capture_s']:.2f} s, graph pool "
          f"{out['graph_pool_mib']:.0f} MiB; on {card}")
    return out


def graphs_phase(dev, card, buffer):
    """llff mixed and parity: a 20-step graphed chunk against the eager
    chunk, bit for bit, with both routes' ms/step; the eval image."""
    from nerfsr_torch.models import create_model
    out = {}
    for preset, counts in (("llff", FAST[0]), ("parity", PARITY[0])):
        res = chunk_vs_eager(
            dev, lambda: create_model(train_options("mixed", preset),
                                      device=dev), buffer, counts=counts)
        print(f"[graphs] {preset} mixed: a {GRAPH_STEPS}-step graphed chunk "
              f"equals the eager chunk in {res['tensors_equal']} tensors "
              f"bit for bit; {res['graphed_ms_per_step']:.2f} ms/step "
              f"graphed, {res['eager_ms_per_step']:.2f} eager; capture "
              f"{res['capture_s']:.2f} s, graph pool "
              f"{res['graph_pool_mib']:.0f} MiB; on {card}")
        out[preset] = res
    out["eval"] = eval_vs_eager(dev, card)
    return out


# engine phase (scripts/train_llff_downX_fast.sh at full width; cut to a
# synthetic scene of 8 views and 40 steps an epoch)
ENGINE_VIEWS = 8
ENGINE_STEPS = 40
ENGINE_RADII = (0.2, 0.2, 0.05)
ENGINE_FILES = ("{i}-fine.png", "{i}-fine-ori.png", "{i}-fine-depth.npz",
                "{i}-fine-depth.png", "{i}-fine-depth-ori.npz",
                "{i}-fine-depth-ori.png")


def engine_argv(scene, work, phase, *extra):
    argv = ["--name", "engine", "--model", "nerf_downX",
            "--dataset_mode", "llff_downX", "--dataset_root", scene,
            "--fast_preset", "llff", "--precision", "mixed",
            "--img_wh", str(HR_WH[0]), str(HR_WH[1]),
            "--downscale", str(DOWNSCALE), "--ds_method", "lanc",
            "--sigma_activation", "relu",
            "--checkpoints_dir", os.path.join(work, "checkpoints")]
    if phase == "train":
        argv += ["--batch_size", str(BATCH), "--include_var",
                 "--lr", "5e-4", "--lr_final", "5e-6", "--lr_policy", "exp",
                 "--scan_steps", "20",
                 "--steps_per_epoch", str(ENGINE_STEPS),
                 "--save_epoch_freq", "1", "--val_epoch_freq", "2",
                 "--val_freq", "0",
                 "--summary_dir", os.path.join(work, "runs")]
    else:
        argv += ["--results_dir", os.path.join(work, "results")]
    return argv + list(extra)


def engine_scene(dev, scene):
    """The teacher (seed 1, sigma biases +3) rendered at HR on centred
    spiral poses, written as a COLMAP scene with points from its depth."""
    from nerfsr_torch.data.llff import (center_poses, load_colmap_scene,
                                        spiral_path)
    from nerfsr_torch.data.synthetic import depth_points, write_llff_scene
    from nerfsr_torch.data.views import LLFFDownXViews
    from nerfsr_torch.models import create_model

    system = create_model(train_options("mixed"), device=dev)
    teacher = system.init_params(seed=1)
    with torch.no_grad():
        for net in teacher.values():
            net.sigma.bias += 3.0
    poses, _ = center_poses(spiral_path(np.asarray(ENGINE_RADII), 3.5,
                                        ENGINE_VIEWS))
    views = LLFFDownXViews(poses, FOCAL, HR_WH, DOWNSCALE)
    w, h = HR_WH
    imgs, depths = [], []
    for out in system.render_eval_many(teacher, views, range(ENGINE_VIEWS)):
        imgs.append((np.clip(out["fine_rgb_ori"], 0, 1) * 255).astype(
            np.uint8).reshape(h, w, 3))
        depths.append(out["fine_depth_ori"].reshape(h, w))
    imgs = np.stack(imgs)
    if imgs.std() < 2.0:
        fail("the engine's teacher scene is blank")
    pts, cols = depth_points(poses, np.stack(depths), imgs, FOCAL)
    write_llff_scene(scene, poses, imgs, FOCAL, pts, cols)
    # the loader must see the poses the images were rendered from
    loaded, _, focal, _ = load_colmap_scene(scene, HR_WH)
    err = float(np.abs(loaded - poses).max())
    if err > 1e-5 or focal != FOCAL:
        fail(f"the scene reads back to other poses (max err {err:.2e}) "
             f"or focal ({focal})")
    return poses


def _launches_per(counts, steps, images):
    """Kernel counts of `steps` training steps and `images` full renders
    at the engine's shapes."""
    w, h = HR_WH
    chunks = -(-(w * h) // 4096)
    step = {"invert_cdf": 2, "composite_fwd": 1, "fused_mlp_fwd": 1,
            "composite_bwd": 1, "fused_mlp_bwd": 1}
    image = {"invert_cdf": 2 * chunks, "composite_fwd": chunks,
             "fused_mlp_fwd": chunks, "composite_bwd": 0, "fused_mlp_bwd": 0}
    want = {k: steps * step[k] + images * image[k] for k in step}
    if counts != want:
        fail(f"engine launch counts {counts}, expected {want} ({steps} "
             f"steps, {images} images)")
    return step, image


def _state_tensors(state):
    from nerfsr_torch.weights import param_leaves
    out = {}
    for path, p, _ in param_leaves(state.params):
        out[path] = p
        moments = state.optimizer.state[p]
        out[path + "/exp_avg"] = moments["exp_avg"]
        out[path + "/exp_avg_sq"] = moments["exp_avg_sq"]
        out[path + "/adam_step"] = moments["step"]
    return out


def engine_phase(dev, card, train_ms_step, work):
    from nerfsr_torch import engine
    from nerfsr_torch.config import parse_options
    from nerfsr_torch.data import create_dataset
    from nerfsr_torch.kernels import COUNTS, reset_counts
    from nerfsr_torch.models import create_model
    from nerfsr_torch.utils import checkpoint as ckpt
    from nerfsr_torch.utils import msgpack, png

    out = {}
    scene = os.path.join(work, "scene")
    t0 = time.perf_counter()
    engine_scene(dev, scene)
    print(f"[engine] scene: {ENGINE_VIEWS} views {HR_WH[0]}x{HR_WH[1]} "
          f"written as COLMAP + PNG in {time.perf_counter() - t0:.1f} s")

    # train 2 epochs, saving each
    opt = parse_options("train", engine_argv(scene, work, "train",
                                             "--n_epochs", "2"))
    first_t = {}
    reset_counts()
    with _ChunkLog() as log:
        first = engine.train(opt, timings=first_t)
    torch.cuda.synchronize()
    if set(log.routes()) != {"train_steps_scan"}:
        fail(f"the engine's chunks under --scan_steps 20: {log.chunks}")
    # 80 steps, and validation at epoch 2 renders the val view twice
    # (device metrics, then the read-back strips)
    _launches_per(dict(COUNTS), 2 * ENGINE_STEPS, 2)
    if first.step != 2 * ENGINE_STEPS:
        fail(f"the first run ended at step {first.step}")

    # the state the resume will load, against the first run's
    opt3 = parse_options("train", engine_argv(
        scene, work, "train", "--n_epochs", "3", "--continue_train"))
    probe = create_model(opt3, device=opt3.device)
    state = probe.create_state(seed=0, steps_per_epoch=ENGINE_STEPS)
    epoch = ckpt.resume_if_requested(opt3, state)
    if (epoch, state.step) != (2, 2 * ENGINE_STEPS):
        fail(f"resumed at epoch {epoch} step {state.step}, expected "
             f"epoch 2 step {2 * ENGINE_STEPS}")
    got, want = _state_tensors(state), _state_tensors(first)
    if got.keys() != want.keys():
        fail("resumed state has other leaves")
    for k in want:
        if not torch.equal(got[k].cpu(), want[k].cpu()):
            fail(f"resumed {k} differs from the saved state")
    print(f"[engine] resume: epoch 2, step {state.step}; "
          f"{len(want)} parameter and Adam tensors equal the first "
          "run's bit for bit")
    del probe, state

    # the resumed run: epoch 3, timed by the engine
    timings = {}
    reset_counts()
    with _ChunkLog() as log:
        third = engine.train(opt3, timings=timings)
    torch.cuda.synchronize()
    if set(log.routes()) != {"train_steps_scan"}:
        fail(f"the resumed run's chunks: {log.chunks}")
    step_counts, image_counts = _launches_per(dict(COUNTS),
                                              ENGINE_STEPS, 2)
    if third.step != 3 * ENGINE_STEPS:
        fail(f"the resumed run ended at step {third.step}")
    ms_step = timings["epoch_s"][3] / ENGINE_STEPS * 1e3
    first_ms = [first_t["epoch_s"][e] / ENGINE_STEPS * 1e3
                for e in (1, 2)]
    print(f"[engine] resumed epoch: {ms_step:.2f} ms/step over "
          f"{ENGINE_STEPS} steps (engine, host clock to the chunk's "
          f"loss read; the first run's epochs {first_ms[0]:.2f} and "
          f"{first_ms[1]:.2f}), train_steps in the training phase "
          f"{train_ms_step:.2f} ms/step, on {card}")
    print(f"[engine] launches a step under the engine {step_counts}; "
          f"an image {image_counts}")

    # the checkpoint codec round trip
    latest = os.path.join(work, "checkpoints", "engine",
                          "latest_state.msgpack")
    with open(latest, "rb") as f:
        blob = f.read()
    if msgpack.packb(msgpack.unpackb(blob)) != blob:
        fail("latest_state.msgpack re-encodes to other bytes")
    print(f"[engine] latest_state.msgpack ({len(blob)} bytes) "
          "re-encodes to the same bytes")

    metrics = _val_metrics(work, "engine", 3 * ENGINE_STEPS)
    print(f"[engine] validation at epoch 3: {metrics} on {card}")

    # test: render test_train from epoch 3
    topt = parse_options("test", engine_argv(
        scene, work, "test", "--test_split", "test_train",
        "--load_epoch", "3"))
    test_t = {}
    reset_counts()
    out_dir = engine.test(topt, timings=test_t)
    _launches_per(dict(COUNTS), 0, ENGINE_VIEWS)
    ms_image = test_t["seconds"] / test_t["views"] * 1e3
    ms_write = test_t["write_s"] / test_t["views"] * 1e3
    print(f"[engine] test: {test_t['views']} views rendered and written "
          f"in {test_t['seconds']:.2f} s, {ms_image:.1f} ms/image with "
          f"the writes, of which {ms_write:.1f} ms/image on the host "
          f"between renders (rays and truth of the view, strips, PNG, "
          f"npz, the GIFs' share), on {card}")
    names = set(os.listdir(out_dir))
    need = {f.format(i=i) for i in range(ENGINE_VIEWS)
            for f in ENGINE_FILES} | {"fine.gif", "fine-ori.gif"}
    if need - names:
        fail(f"test artifacts missing: {sorted(need - names)}")
    system = create_model(topt, device=dev)
    dataset = create_dataset(topt, "test_train")
    w, h = HR_WH
    for i, r in enumerate(system.render_eval_many(
            third.params, dataset, range(ENGINE_VIEWS),
            quantize_rgb=True)):
        panel = png.read_rgb(os.path.join(
            out_dir, f"{i}-fine-ori.png"))[:, :w]
        if not np.array_equal(panel, r["fine_rgb_ori"].reshape(h, w, 3)):
            fail(f"{i}-fine-ori.png's render panel differs from "
                 "render_eval_many(quantize_rgb=True)")
        depth = np.load(os.path.join(out_dir,
                                     f"{i}-fine-depth-ori.npz"))["matrix"]
        if not np.array_equal(depth, r["fine_depth_ori"].reshape(h, w)):
            fail(f"{i}-fine-depth-ori.npz differs from the render")
    print(f"[engine] {len(need)} test artifacts present; the "
          f"{ENGINE_VIEWS} HR render panels and depth maps equal "
          "render_eval_many's")
    os.makedirs(OUT_DIR, exist_ok=True)
    for name in ("0-fine-ori.png", "0-fine.png"):
        with open(os.path.join(out_dir, name), "rb") as src, \
                open(os.path.join(OUT_DIR, f"engine_{name}"), "wb") as dst:
            dst.write(src.read())
    out.update(ms_per_step=ms_step, first_run_ms_per_step=first_ms,
               train_steps_ms_per_step=train_ms_step,
               test_ms_per_image=ms_image,
               test_host_ms_per_image=ms_write, val_metrics=metrics,
               launches_per_step=step_counts,
               launches_per_image=image_counts,
               checkpoint_bytes=len(blob), card=card)
    return out


# datasets phase: the Blender and vanilla LLFF datasets through the engine
# at full width, each run with its script's flags and these cuts: a
# synthetic scene; 2 epochs of 40 steps (vl: 1), the LR held at 5e-4
# (--n_epochs_decay 0), a loss line every chunk (--print_freq 10),
# Blender epoch checkpoints (--save_epoch_freq 1, for the resume) and a
# train_crop warm-up of 50 steps, which ends inside epoch 2 and off the
# 20-step chunk grid
BLENDER_HW = (800, 800)            # the size nerf_synthetic ships
BLENDER_SPLITS = dict(n_train=8, n_val=2, n_test=2)
DS_STEPS = 40
DS_WARMUP = 50
DS_CUTS = ["--n_epochs_decay", "0", "--steps_per_epoch", str(DS_STEPS),
           "--print_freq", "10"]
PARITY = ({"invert_cdf": 0, "composite_fwd": 2, "fused_mlp_fwd": 2,
           "composite_bwd": 2, "fused_mlp_bwd": 2},
          {"invert_cdf": 0, "composite_fwd": 2, "fused_mlp_fwd": 2,
           "composite_bwd": 0, "fused_mlp_bwd": 0})
FAST = ({"invert_cdf": 2, "composite_fwd": 1, "fused_mlp_fwd": 1,
         "composite_bwd": 1, "fused_mlp_bwd": 1},
        {"invert_cdf": 2, "composite_fwd": 1, "fused_mlp_fwd": 1,
         "composite_bwd": 0, "fused_mlp_bwd": 0})
_TRAIN = ["--lr_policy", "exp", "--lr", "5e-4", "--lr_final", "5e-6"]
# each run: the flags of the model and data (train and test), the
# training flags, and the test split and its flags
DS_RUNS = {
    # scripts/train_blender_downX.sh, through train_blender's warm-up
    "bx2": dict(
        model=["--dataset_mode", "blender_downX", "--img_wh", "200", "200",
               "--model", "nerf_downX", "--N_coarse", "64",
               "--N_importance", "64", "--downscale", "2",
               "--sigma_activation", "relu"],
        train=["--batch_size", "512", "--val_epoch_split", "test",
               "--n_epochs", "2", "--vis_freq", "1000", "--val_freq",
               "1000", "--val_epoch_freq", "20", "--vis_epoch_freq", "20",
               "--save_epoch_freq", "1", *_TRAIN, "--scan_steps", "20"],
        warmup=True, falls=True, counts=PARITY, rays=512 * 4,
        split="test", panel="{i}-fine-ori.png"),
    # tools/run_blender_ds4.sh, its --fast_preset blender run
    "bx4": dict(
        model=["--dataset_mode", "blender_downX", "--img_wh", "400", "400",
               "--downscale", "4", "--model", "nerf_downX", "--N_coarse",
               "64", "--sigma_activation", "relu", "--precision", "mixed",
               "--fast_preset", "blender"],
        train=["--batch_size", "128", "--val_epoch_split", "val",
               "--n_epochs", "2", *_TRAIN, "--scan_steps", "100",
               "--val_freq", "0", "--val_epoch_freq", "20",
               "--vis_epoch_freq", "0", "--save_epoch_freq", "1"],
        warmup=True, falls=True, counts=FAST, rays=128 * 16,
        split="test", panel="{i}-fine-ori.png"),
    # scripts/train_blender.sh
    "vb": dict(
        model=["--dataset_mode", "blender", "--img_wh", "200", "200",
               "--init_type", "kaiming", "--model", "nerf", "--N_coarse",
               "64", "--N_importance", "64", "--sigma_activation", "relu"],
        train=["--batch_size", "2048", "--n_epochs", "2",
               "--val_epoch_split", "test", "--vis_freq", "1000",
               "--val_freq", "1000", "--val_epoch_freq", "20",
               "--vis_epoch_freq", "20", "--save_epoch_freq", "1", *_TRAIN,
               "--scan_steps", "20"],
        warmup=True, falls=False, counts=PARITY, rays=2048,
        split="test", panel="{i}-fine.png"),
    # scripts/train_llff.sh, then scripts/test_llff.sh at 504x378
    "vl": dict(
        model=["--dataset_mode", "llff", "--img_wh", "252", "189",
               "--model", "nerf", "--N_coarse", "64", "--N_importance", "64",
               "--sigma_activation", "relu"],
        train=["--batch_size", "2048", "--n_epochs", "1", "--vis_freq",
               "1000", "--val_freq", "1000", "--vis_epoch_freq", "30",
               "--val_epoch_freq", "30", "--save_epoch_freq", "10", *_TRAIN,
               "--scan_steps", "20"],
        warmup=False, falls=False, counts=PARITY, rays=2048,
        split="test_train", panel="{i}-fine.png",
        test=["--img_wh", "504", "378"]),
}


def _chunks(wh):
    return -(-(wh[0] * wh[1]) // 4096)


def _expect(counts, per, steps, images):
    """Fail unless ``counts`` are ``steps`` training steps and the renders
    ``images`` = [(w, h), ...] of a run's per-step and per-chunk counts."""
    step, chunk = per
    want = {k: steps * step[k] + sum(_chunks(wh) for wh in images)
            * chunk[k] for k in step}
    if counts != want:
        fail(f"launch counts {counts}, expected {want} ({steps} steps, "
             f"renders {images})")


class _ChunkLog:
    """While entered, records every training chunk the NeRF engine runs:
    its route (``train_steps``, eager; ``train_steps_scan``, graph
    replays on the card), first step, steps and buffer size."""

    ROUTES = ("train_steps", "train_steps_scan")

    def __enter__(self):
        from nerfsr_torch.models.nerf_system import NeRFSystem
        self.chunks, self._cls = [], NeRFSystem
        self._real = {name: getattr(NeRFSystem, name) for name in self.ROUTES}
        chunks = self.chunks

        def recorder(name, real):
            def run(system, state, buffer, n_steps, generator=None):
                chunks.append((name, state.step, n_steps,
                               len(buffer["rgbs"])))
                return real(system, state, buffer, n_steps, generator)
            return run
        for name, real in self._real.items():
            setattr(NeRFSystem, name, recorder(name, real))
        return self

    def __exit__(self, *exc):
        for name, real in self._real.items():
            setattr(self._cls, name, real)

    def sizes(self):
        """The buffer size of every step, in order."""
        return [n for _, _, k, n in self.chunks for _ in range(k)]

    def routes(self):
        return [r for r, _, _, _ in self.chunks]


def _val_metrics(work, name, step):
    metrics = {}
    with open(os.path.join(work, "runs", name, "metrics.jsonl")) as f:
        for line in f:
            rec = json.loads(line)
            if rec["tag"].startswith("val/") and rec["step"] == step:
                metrics[rec["tag"][4:]] = rec["value"]
    if not metrics or not all(np.isfinite(v) for v in metrics.values()):
        fail(f"{name}: validation metrics at step {step}: {metrics}")
    return metrics


@torch.no_grad()
def _fixed_batch_mse(opt, state, dev):
    """(coarse_mse, fine_mse) (coarse NaN without a coarse level) of the
    seed's initial weights and of
    ``state``'s on one fixed batch of the train split (every k-th item,
    2048 HR rays, no jitter, no noise): the losses the run brought
    down."""
    from nerfsr_torch.data import create_dataset
    from nerfsr_torch.models import create_model
    eval_opt = copy.copy(opt)
    eval_opt.randomized, eval_opt.noise_std = False, 0.0
    system = create_model(eval_opt, device=dev)
    buf = create_dataset(eval_opt, "train").ray_buffer()
    n = len(buf["rgbs"])
    rows = 2048 // (buf["origins"].shape[1] if buf["origins"].ndim == 3
                    else 1)
    idx = np.arange(rows) * (n // rows)
    batch = {k: torch.from_numpy(np.ascontiguousarray(v[idx])).to(dev)
             for k, v in buf.items()}
    before = system.create_state(seed=opt.seed).params
    return [tuple(float(losses.get(k, float("nan")))    # fast: no coarse
                  for k in ("coarse_mse", "fine_mse"))
            for losses in (system._loss_fn(p, batch)[1]
                           for p in (before, state.params))]


def _check_scene(scene, poses, dev):
    """The written Blender scene reads back: every train frame's pose is
    the pose it was rendered from (as float32), the first PNG is the
    render's RGBA (within a rounding: the render is done again), and
    each loaded HR truth is the frame's PNG
    Lanczos-resized to 200x200 and blended over white."""
    from nerfsr_torch.config import default_options
    from nerfsr_torch.data import create_dataset
    from nerfsr_torch.data.downx_common import (blend_white, group_subpixels,
                                                lanczos_resize)
    from nerfsr_torch.data.synthetic import (CAMERA_ANGLE_X,
                                             render_blob_view, rgba_pixels)
    from nerfsr_torch.utils import png
    opt = default_options("train", model="nerf_downX",
                          dataset_mode="blender_downX", dataset_root=scene,
                          img_wh=(200, 200), downscale=2)
    ds = create_dataset(opt, "test_train")
    focal = 0.5 * BLENDER_HW[0] / np.tan(0.5 * CAMERA_ANGLE_X)
    for i in range(len(ds)):
        if not np.array_equal(ds.eval_raygen_spec(i)["c2w"],
                              poses[i][:3].astype(np.float32)):
            fail(f"frame {i} reads back to another pose")
        px = png.read(os.path.join(scene, ds.frames[i]["file_path"]
                                   + ".png")).pixels
        if i == 0 and np.abs(px.astype(int) - rgba_pixels(
                *render_blob_view(poses[i], BLENDER_HW, focal,
                                  device=dev))).max() > 1:
            fail("the written PNG is not the render's RGBA")
        want = blend_white(lanczos_resize(px, (200, 200)).astype(
            np.float32) / 255.0)
        if not np.array_equal(ds.image_rays(i)["rgbs_ori"],
                              group_subpixels(want, 2)):
            fail(f"frame {i}'s loaded HR truth is not its PNG over white")
    return len(ds)


def datasets_phase(dev, card, work, llff_scene):
    """The four runs of DS_RUNS through the engine (train, test), each
    with exact launch counts, test panels equal to ``render_eval_many``'s,
    validation metrics, timings; bx2 also a resume across the end of the
    warm-up, and a check of which buffer each step drew from."""
    from nerfsr_torch import engine
    from nerfsr_torch.config import parse_options
    from nerfsr_torch.data import create_dataset
    from nerfsr_torch.data.synthetic import blender_poses, write_blender_scene
    from nerfsr_torch.kernels import COUNTS, reset_counts
    from nerfsr_torch.models import create_model
    from nerfsr_torch.utils import png

    t0 = time.perf_counter()
    scene = os.path.join(work, "blender")
    write_blender_scene(scene, hw=BLENDER_HW, device=dev, **BLENDER_SPLITS)
    n_views = _check_scene(scene, blender_poses(sum(BLENDER_SPLITS.values())),
                           dev)
    print(f"[datasets] blender scene: {sum(BLENDER_SPLITS.values())} views "
          f"{BLENDER_HW[0]}x{BLENDER_HW[1]} RGBA written and read back "
          f"({n_views} train poses and truths checked) in "
          f"{time.perf_counter() - t0:.1f} s")
    out = {}
    for name, run in DS_RUNS.items():
        t_run = time.perf_counter()
        root = scene if name != "vl" else llff_scene
        base = ["--name", name, "--dataset_root", root, "--checkpoints_dir",
                os.path.join(work, "ck")]
        opt = parse_options("train", base + run["model"] + run["train"]
                            + DS_CUTS + ["--summary_dir",
                                         os.path.join(work, "runs")])
        warm = dict(warmup_mode="train_crop", warmup_iters=DS_WARMUP) \
            if run["warmup"] else {}
        timings = {}
        reset_counts()
        with _ChunkLog() as log:
            state = engine.train(opt, timings=timings, **warm)
        torch.cuda.synchronize()
        steps = opt.n_epochs * DS_STEPS
        n_val = len(create_dataset(opt, "val"))
        _expect(dict(COUNTS), run["counts"], steps, [opt.img_wh] * 2 * n_val)
        sizes = log.sizes()
        if state.step != steps or len(sizes) != steps:
            fail(f"{name}: {state.step} steps, {len(sizes)} batches")
        n_full = len(create_dataset(opt, "train").ray_buffer()["rgbs"])
        # the warm-up's chunks eager, every other one graph replays
        want_routes = ["train_steps_scan" if n == n_full else "train_steps"
                       for _, _, _, n in log.chunks]
        if log.routes() != want_routes or "train_steps_scan" not in \
                want_routes:
            fail(f"{name}: chunk routes {log.chunks}")
        if run["warmup"]:
            n_crop = len(create_dataset(opt, "train_crop").ray_buffer()[
                "rgbs"])
            want = [n_crop] * DS_WARMUP + [n_full] * (steps - DS_WARMUP)
            if n_crop >= n_full or sizes != want:
                fail(f"{name}: the steps drew from buffers of "
                     f"{sorted(set(sizes))} rays, not {DS_WARMUP} from "
                     f"the crop's {n_crop} and then the train split's "
                     f"{n_full}")
        for p in state.params.parameters():
            moments = state.optimizer.state[p]
            for t in (p, moments["exp_avg"], moments["exp_avg_sq"]):
                if not torch.isfinite(t).all():
                    fail(f"{name}: non-finite parameters or moments")
        (cmse0, mse0), (cmse1, mse1) = _fixed_batch_mse(opt, state, dev)
        if run["falls"] and not mse1 < FALL_RATIO * mse0:
            fail(f"{name}: fine_mse {mse0:.5f} -> {mse1:.5f} on a fixed "
                 f"batch, not below {FALL_RATIO} of its start")
        epoch_ms = [timings["epoch_s"][e] / DS_STEPS * 1e3
                    for e in sorted(timings["epoch_s"])]
        chunk_ms = chunk_vs_eager(
            dev, lambda: create_model(opt, device=dev),
            {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
             for k, v in create_dataset(opt, "train").ray_buffer().items()},
            counts=run["counts"][0])
        res = {"chunk": chunk_ms, "ms_per_step": epoch_ms, "hr_rays_per_s":
               [run["rays"] / ms * 1e3 for ms in epoch_ms],
               "fine_mse_fixed_batch": [mse0, mse1],
               "coarse_mse_fixed_batch": [cmse0, cmse1],
               "val": _val_metrics(work, name, steps)}

        if name == "bx2":       # resume from epoch 1 across the warm-up
            resumed = parse_options(
                "train", base + run["model"] + run["train"] + DS_CUTS + [
                    "--summary_dir", os.path.join(work, "runs_resume"),
                    "--continue_train", "--load_epoch", "1"])
            reset_counts()
            again = engine.train(resumed, **warm)
            torch.cuda.synchronize()
            _expect(dict(COUNTS), run["counts"], DS_STEPS,
                    [opt.img_wh] * 2 * n_val)
            got, want = _state_tensors(again), _state_tensors(state)
            if again.step != state.step or got.keys() != want.keys() or \
                    not all(torch.equal(got[k], want[k]) for k in want):
                fail("bx2: the run resumed from epoch 1 differs from the "
                     "unbroken run")
            res["resume_tensors_equal"] = len(want)
            del again

        targv = ["--name", name, "--dataset_root", root,
                 "--checkpoints_dir", os.path.join(work, "ck"),
                 "--results_dir", os.path.join(work, "results"),
                 "--test_split", run["split"], "--load_epoch",
                 str(opt.n_epochs)] + run["model"] + run.get("test", [])
        topt = parse_options("test", targv)
        test_t = {}
        reset_counts()
        out_dir = engine.test(topt, timings=test_t)
        dataset = create_dataset(topt, run["split"])
        _expect(dict(COUNTS), run["counts"], 0,
                [topt.img_wh] * len(dataset))
        w, h = topt.img_wh
        system = create_model(topt, device=dev)
        key = "fine_rgb_ori" if "ori" in run["panel"] else "fine_rgb"
        for i, r in enumerate(system.render_eval_many(
                state.params, dataset, range(len(dataset)),
                quantize_rgb=True)):
            panel = png.read_rgb(os.path.join(
                out_dir, run["panel"].format(i=i)))[:, :w]
            if not np.array_equal(panel, r[key].reshape(h, w, 3)):
                fail(f"{name}: {run['panel'].format(i=i)}'s render panel "
                     "differs from render_eval_many(quantize_rgb=True)")
        step, chunk = run["counts"]
        res.update(launches_per_step=step, launches_per_image={
                       k: v * _chunks(topt.img_wh) for k, v in chunk.items()},
                   test_views=test_t["views"], test_wh=[w, h],
                   test_ms_per_image=test_t["seconds"] / test_t["views"]
                   * 1e3,
                   test_render_ms_per_image=(test_t["seconds"]
                                             - test_t["write_s"])
                   / test_t["views"] * 1e3,
                   run_s=time.perf_counter() - t_run)
        print(f"[datasets] {name}: {steps} steps, {np.mean(epoch_ms):.2f} "
              f"ms/step (epochs {', '.join(f'{m:.2f}' for m in epoch_ms)}; "
              f"the warm-up's chunks eager, the rest graph replays); a "
              f"{GRAPH_STEPS}-step chunk equal to the eager one bit for bit, "
              f"{chunk_ms['graphed_ms_per_step']:.2f} ms/step graphed, "
              f"{chunk_ms['eager_ms_per_step']:.2f} eager, capture "
              f"{chunk_ms['capture_s']:.2f} s, graph pool "
              f"{chunk_ms['graph_pool_mib']:.0f} MiB; "
              f"{np.mean(res['hr_rays_per_s']):.0f} HR rays/s; fine_mse on "
              f"a fixed batch {mse0:.5f} -> {mse1:.5f} (coarse_mse "
              f"{cmse0:.5f} -> {cmse1:.5f}); validation "
              f"{res['val']}; test {res['test_views']} views {w}x{h}: "
              f"{res['test_ms_per_image']:.1f} ms/image with the writes, "
              f"{res['test_render_ms_per_image']:.1f} without; launches "
              f"exact; run {res['run_s']:.1f} s; on {card}")
        out[name] = res
        del state
        torch.cuda.empty_cache()
    return out


# refine phase: scripts/train_llff_refine.sh at full width (UnetGenerator
# ngf 64, 6 downs, 27 input channels, batch norm; 64 px patches, 32 a
# batch, --aug_num 200 views at 504x378, --refine_with_l1, exp LR 5e-4 ->
# 5e-6 over --n_epochs 3) on the engine phase's scene and test_train
# renders, with these cuts: --steps_per_epoch 100 (the script's epoch is
# --data_num 500000 / 32 = 15,625 steps), --print_freq 50, --val_freq 50
# and --vis_freq 100 (the script: 100, 1000, 1000)
REFINE_STEPS = 100
REFINE_TRAIN = ["--batch_size", "32", "--n_epochs_decay", "0",
                "--lr_policy", "exp", "--lr", "5e-4", "--lr_final", "5e-6",
                "--save_epoch_freq", "1", "--val_epoch_freq", "1",
                "--refine_with_l1", "--steps_per_epoch", str(REFINE_STEPS),
                "--print_freq", "50", "--val_freq", "50", "--vis_freq", "100"]
REFINE_MAXPOOL_STEPS = 5   # each maxpoolingmodel chunk (~0.26 s a step)
# the fixed batch's l1 after 300 steps over the fresh network's
REFINE_FALL = 0.7
# one UNet step on the card (cuDNN, TF32 off) against the same step on
# the CPU (oneDNN), each held to the step in f64 on the CPU: the loss
# (relative) and the new batch statistics (abs) against the CPU's f32
# step; each gradient leaf's distance to the f64 step (||d|| / ||f64||)
# may be at most REFINE_F64_RATIO times the CPU's f32 step's, plus
# REFINE_LEAF_FLOOR (f32 sums in another order)
REFINE_STEP_BARS = (1e-5, 1e-4)
REFINE_F64_RATIO, REFINE_LEAF_FLOOR = 2.0, 1e-5
# warp locs, card against CPU: the share of pixels whose truncated
# coordinate may differ (f32 values within a rounding of an integer)
WARP_FLIP_SHARE = 1e-3


def refine_argv(scene, syn, work, name, phase, *extra):
    argv = ["--name", name, "--model", "refine",
            "--dataset_mode", "llff_refine", "--dataset_root", scene,
            "--img_wh", str(HR_WH[0]), str(HR_WH[1]),
            "--syn_dataroot", syn,
            "--checkpoints_dir", os.path.join(work, "refine_ck")]
    if phase == "train":
        argv += REFINE_TRAIN + ["--summary_dir",
                                os.path.join(work, "refine_runs")]
    else:
        argv += ["--results_dir", os.path.join(work, "refine_results")]
    return argv + list(extra)


def _refine_tensors(state):
    """Every parameter, running statistic and Adam tensor of a refine
    state, by name."""
    out = dict(state.net.state_dict())
    for name, p in state.net.named_parameters():
        for k, v in state.optimizer.state[p].items():
            out[f"{name}/{k}"] = v
    return out


def _warp_phase(scene, syn, dev, card):
    from nerfsr_torch import warp as warp_entry
    from nerfsr_torch.data.llff import load_colmap_scene
    from nerfsr_torch.ops.warp import ref_world_to_cam, warp_view

    argv = ["--dataset_root", scene, "--result_dir", syn, "--img_wh",
            str(HR_WH[0]), str(HR_WH[1])]
    t0 = time.perf_counter()
    written = warp_entry.main(argv)
    ms_view = (time.perf_counter() - t0) / max(1, len(written)) * 1e3
    if written != list(range(ENGINE_VIEWS)):
        fail(f"warp wrote views {written}")
    w, h = HR_WH
    poses, _, focal, _ = load_colmap_scene(scene, HR_WH)
    ref_w2c = ref_world_to_cam(poses[0])
    shares, flips = [], 0
    for i in written:
        locs = np.load(os.path.join(syn, f"{i}_locs.npz"))["arr_0"]
        if locs.shape != (h, w, 3) or locs.dtype != np.float32 or \
                not (locs[..., 2] == -1).all():
            fail(f"{i}_locs.npz: {locs.shape} {locs.dtype}")
        inside = ((locs[..., 0] >= 0) & (locs[..., 0] < w)
                  & (locs[..., 1] >= 0) & (locs[..., 1] < h))
        shares.append(float(inside.mean()))
        if i == ENGINE_VIEWS - 1:    # the card against the CPU
            depth = np.load(os.path.join(
                syn, f"{i}-fine-depth-ori.npz"))["matrix"]
            ref = np.zeros((h, w, 3), np.float32)
            cpu, _ = warp_view(depth, poses[i], ref_w2c, ref, focal, HR_WH,
                               device="cpu")
            flips = int((cpu[..., :2] != locs[..., :2]).any(-1).sum())
            if flips > WARP_FLIP_SHARE * w * h:
                fail(f"warp view {i}: {flips} pixels differ between the "
                     "card and the CPU")
    if min(shares) < 0.5:
        fail(f"warp: shares of pixels inside the reference view {shares}")
    print(f"[refine] warp: {len(written)} views {w}x{h}, {ms_view:.1f} "
          f"ms/view (scene load, depth read, warp on the card, npz and PNG "
          f"writes); inside the reference view {min(shares):.3f}-"
          f"{max(shares):.3f}; view {ENGINE_VIEWS - 1} card vs CPU "
          f"{flips} pixels differ; on {card}")
    return {"ms_per_view": ms_view, "inside_share": shares,
            "card_vs_cpu_pixels": flips}


def _step_vs_cpu(opt, dev, buffers):
    """One UNet step on the card, the same step on the CPU and in f64 on
    the CPU, from the same weights and batch: the card's loss and
    statistics against the CPU's, and each gradient leaf's distance to
    the f64 step beside the CPU's."""
    from nerfsr_torch.models import create_model
    batch = create_model(opt, device=dev).sample_patch_batch(
        buffers, torch.Generator(device=dev).manual_seed(7))
    runs = {}
    for name, device, dtype in (("card", dev, torch.float32),
                                ("cpu", torch.device("cpu"), torch.float32),
                                ("f64", torch.device("cpu"), torch.float64)):
        system = create_model(opt, device=device)
        state = system.create_state(seed=opt.seed, steps_per_epoch=1)
        state.net.to(dtype)
        _, losses = system.train_step(state, {
            k: v.to(device, dtype) for k, v in batch.items()})
        runs[name] = (float(losses["tot"]),
                      {n: p.grad.cpu().double()
                       for n, p in state.net.named_parameters()},
                      [t.cpu().double() for t in state.net.buffers()])
    (loss_d, grads_d, stats_d), (loss_c, grads_c, stats_c), \
        (_, grads_64, _) = runs["card"], runs["cpu"], runs["f64"]
    loss_rel = abs(loss_d - loss_c) / abs(loss_c)
    stats = max(float((a - b).abs().max()) for a, b in zip(stats_d, stats_c))

    def dist(grads, name):
        ref = grads_64[name]
        return float((grads[name] - ref).norm() / ref.norm().clamp_min(1e-30))

    leaves = {n: (dist(grads_d, n), dist(grads_c, n)) for n in grads_64}
    worst = max(leaves, key=lambda n: leaves[n][0] - REFINE_F64_RATIO
                * leaves[n][1])
    card_leaf, cpu_leaf = leaves[worst]
    loss_bar, stats_bar = REFINE_STEP_BARS
    if not (loss_rel <= loss_bar and stats <= stats_bar
            and card_leaf <= REFINE_F64_RATIO * cpu_leaf
            + REFINE_LEAF_FLOOR):
        fail(f"refine step, card vs CPU: loss {loss_rel:.2e} (bar "
             f"{loss_bar}), batch statistics {stats:.2e} (bar {stats_bar}); "
             f"gradient leaf {worst} {card_leaf:.2e} from the f64 step, the "
             f"CPU's f32 step {cpu_leaf:.2e} (bar {REFINE_F64_RATIO}x + "
             f"{REFINE_LEAF_FLOOR})")
    return {"loss_rel": loss_rel, "stats_abs": stats,
            "worst_leaf": worst, "worst_leaf_card_vs_f64": card_leaf,
            "worst_leaf_cpu_vs_f64": cpu_leaf,
            "max_card_vs_f64": max(v[0] for v in leaves.values()),
            "max_cpu_vs_f64": max(v[1] for v in leaves.values()),
            "max_card_vs_cpu": max(
                float((grads_d[n] - grads_c[n]).norm()
                      / grads_c[n].norm().clamp_min(1e-30))
                for n in grads_c)}


def refine_phase(dev, card, work):
    """The refine stage on the engine phase's scene and test_train
    renders: warp, train_refine (2 epochs, a resume to 3, an unbroken 3),
    a falling l1, one step against the CPU, maxpoolingmodel steps, and
    test_refine against a direct refine_image."""
    from nerfsr_torch import engine
    from nerfsr_torch.config import parse_options
    from nerfsr_torch.data import create_dataset
    from nerfsr_torch.kernels import COUNTS, reset_counts
    from nerfsr_torch.models import create_model
    from nerfsr_torch.utils import checkpoint as ckpt
    from nerfsr_torch.utils import png
    from nerfsr_torch.utils.visualizer import _to_uint8

    t_phase = time.perf_counter()
    scene = os.path.join(work, "scene")
    syn = os.path.join(work, "results", "engine", "test_train_3")
    reset_counts()
    out = {"warp": _warp_phase(scene, syn, dev, card)}

    def topt(name, *extra):
        return parse_options("train", refine_argv(scene, syn, work, name,
                                                  "train", *extra))

    # the unbroken run, timed by the engine
    timings = {}
    t0 = time.perf_counter()
    whole = engine.train_refine(topt("u", "--n_epochs", "3"),
                                timings=timings)
    run_s = time.perf_counter() - t0
    if whole.step != 3 * REFINE_STEPS:
        fail(f"the unbroken refine run ended at step {whole.step}")
    epoch_ms = [timings["epoch_s"][e] / REFINE_STEPS * 1e3
                for e in (1, 2, 3)]
    # 2 epochs, then a resume to 3
    engine.train_refine(topt("r", "--n_epochs", "2"))
    resumed = engine.train_refine(topt("r", "--n_epochs", "3",
                                       "--continue_train"))
    got, want = _refine_tensors(resumed), _refine_tensors(whole)
    if resumed.step != whole.step or got.keys() != want.keys() or \
            not all(torch.equal(got[k], want[k]) for k in want):
        fail("refine: the run resumed at epoch 2 differs from the "
             "unbroken run")
    print(f"[refine] resume: 2 epochs, then --continue_train to 3: "
          f"{len(want)} parameter, statistic and Adam tensors equal the "
          "unbroken run's bit for bit")

    # a fixed batch's l1, fresh network against the trained one
    opt = topt("u", "--n_epochs", "3")
    system = create_model(opt, device=dev)
    buffers = system.upload_buffers(
        create_dataset(opt, "train").device_buffers())
    batch = system.sample_patch_batch(
        buffers, torch.Generator(device=dev).manual_seed(3))
    fresh = system.create_state(seed=opt.seed, steps_per_epoch=1)
    l1 = [float(torch.mean(torch.abs(system.predict(
        s, batch["sr_patch"], batch["ref_patches"]) - batch["gt_patch"])))
        for s in (fresh, whole)]
    l1_input = float(torch.mean(torch.abs(batch["sr_patch"]
                                          - batch["gt_patch"])))
    if not l1[1] < REFINE_FALL * l1[0]:
        fail(f"refine: l1 on a fixed batch {l1[0]:.4f} -> {l1[1]:.4f}")
    step_err = _step_vs_cpu(opt, dev, buffers)

    # a graphed chunk against the eager one from the same seed, bit for
    # bit, and both routes' ms/step: the UNet, then maxpoolingmodel
    none = {k: 0 for k in FAST[0]}
    chunks = {"unet": chunk_vs_eager(
        dev, lambda: create_model(opt, device=dev), buffers, counts=none)}
    for name, extra in (("maxpool", []), ("maxpool_no_ref",
                                          ["--not_use_ref"])):
        mopt = topt("m", "--refine_network", "maxpoolingmodel", *extra)
        chunks[name] = chunk_vs_eager(
            dev, lambda: create_model(mopt, device=dev), buffers,
            steps=REFINE_MAXPOOL_STEPS, counts=none)
        torch.cuda.empty_cache()
    nets = {k: v["graphed_ms_per_step"] for k, v in chunks.items()}
    bs = opt.batch_size
    for name, res in chunks.items():
        ms, eager = res["graphed_ms_per_step"], res["eager_ms_per_step"]
        print(f"[refine] {name}: a graphed chunk equals the eager one in "
              f"{res['tensors_equal']} tensors bit for bit; {ms:.2f} "
              f"ms/step graphed, {bs / ms * 1e3:.0f} patches/s (batch {bs}, "
              f"{opt.patch_len} px, host clock to a synchronize), "
              f"{eager:.2f} ms/step eager; capture {res['capture_s']:.2f} s, "
              f"graph pool {res['graph_pool_mib']:.0f} MiB; on {card}")
    epochs = ", ".join(f"{m:.2f}" for m in epoch_ms)
    print(f"[refine] train_refine epochs {epochs} ms/step ({REFINE_STEPS} "
          f"steps with their val_iter; the epoch's save and val pass "
          f"outside); the run {run_s:.1f} s with the augmentation; l1 on a "
          f"fixed batch "
          f"{l1[0]:.4f} -> {l1[1]:.4f} (the input's {l1_input:.4f}); "
          f"one step card vs CPU: loss {step_err['loss_rel']:.2e}, "
          f"statistics {step_err['stats_abs']:.2e}, gradient leaves "
          f"{step_err['max_card_vs_cpu']:.2e} (worst); from the f64 step "
          f"the card {step_err['max_card_vs_f64']:.2e}, the CPU "
          f"{step_err['max_cpu_vs_f64']:.2e} (worst leaves); on {card}")

    # test_refine, against a direct refine_image
    tst = parse_options("test", refine_argv(
        scene, syn, work, "u", "test", "--test_split", "test_train",
        "--load_epoch", "3"))
    test_t = {}
    out_dir = engine.test_refine(tst, timings=test_t)
    tsys = create_model(tst, device=dev)
    state = tsys.create_state(seed=0, steps_per_epoch=1)
    ckpt.load_checkpoint(tst, state, epoch=3, params_only=True)
    dataset = create_dataset(tst, "test_train")
    w, h = HR_WH
    for i in range(dataset.n_images()):
        refined, _, _ = tsys.refine_image(state, dataset.tiles_for_image(i))
        panel = png.read_rgb(os.path.join(out_dir,
                                          f"{i}-sr-refine.png"))[:, w:2 * w]
        if not np.array_equal(panel, _to_uint8(refined, (-1, 1))):
            fail(f"{i}-sr-refine.png's refined panel differs from "
                 "refine_image")
    ms_image = test_t["seconds"] / test_t["images"] * 1e3
    ms_render = (test_t["seconds"] - test_t["write_s"]) / test_t[
        "images"] * 1e3
    if any(COUNTS.values()):
        fail(f"the refine path launched port kernels: {dict(COUNTS)}")
    print(f"[refine] test_refine: {test_t['images']} images {w}x{h}, "
          f"{ms_image:.1f} ms/image with the writes, {ms_render:.1f} "
          f"without; stitched panels equal refine_image's; on {card}")
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(out_dir, "0-sr-refine.png"), "rb") as src, \
            open(os.path.join(OUT_DIR, "refine_0-sr-refine.png"),
                 "wb") as dst:
        dst.write(src.read())
    out.update(train_epoch_ms_per_step=epoch_ms, run_s=run_s,
               ms_per_step={k: v for k, v in nets.items()}, chunks=chunks,
               patches_per_s={k: bs / v * 1e3 for k, v in nets.items()},
               l1_fixed_batch=l1, l1_input=l1_input,
               step_vs_cpu=step_err, resume_tensors_equal=len(want),
               test_ms_per_image=ms_image,
               test_render_ms_per_image=ms_render,
               phase_s=time.perf_counter() - t_phase, card=card)
    return out


# aux phase: the auxiliary training paths at full width on the engine
# phase's scene, with scripts/train_llff_downX_fast.sh's flags (504x378,
# x2, --batch_size 512, --fast_preset llff, mixed, --scan_steps 20) cut to
# one epoch of 20 steps; patch mode at scripts/train_llff.sh's (vanilla
# NeRF, 252x189, batch 2048, 64 + 64 samples) with --patch_size 32
AUX_STEPS = 20
AUX_PATCH_WH = (252, 189)
AUX_PATCH_BATCH = 2048
_MAIN = FAST[0]
_GAN = {"invert_cdf": 4, "composite_fwd": 2, "fused_mlp_fwd": 2,
        "composite_bwd": 1, "fused_mlp_bwd": 1}     # two renders, one bwd
_REF = {k: 2 * v for k, v in _MAIN.items()}        # the main and ref rays


def _sum(*parts):
    """{kernel: launches} of (counts, times) parts."""
    return {k: sum(c[k] * n for c, n in parts) for k in _MAIN}


# a gradient leaf's norm floor, as a share of the update's whole gradient
AUX_LEAF_FLOOR = 1e-2
# in mixed precision, what D says of a rendered patch (D_fake, G_GAN):
# the bf16 renders of the kernels and of the plain versions differ by up
# to SLICE_MIXED's mean, and D's logits carry it (seen 1.4e-3 and
# 3.3e-3; in f32 the same losses agree to 5e-6)
AUX_VERDICT_MIXED = 1e-2
AUX_PATHS = {
    # 20 main steps, the GAN after steps 10 and 20, the TV update after
    # 5, 10, 15 and 20
    "gan_reg": dict(flags=["--with_netD", "--patch_len", "32",
                           "--gan_iter", "10", "--reg_patch",
                           "--reg_patch_freq", "5"],
                    counts=_sum((_MAIN, 20), (_GAN, 2), (_MAIN, 4)),
                    updates=6),
    "wgangp": dict(flags=["--with_netD", "--patch_len", "32", "--gan_iter",
                          "10", "--gan_mode", "wgangp", "--use_grad"],
                   counts=_sum((_MAIN, 20), (_GAN, 2)), updates=2),
    "ref1": dict(flags=["--with_ref", "--ref_freq", "1"],
                 counts=_sum((_REF, 20)), updates=0),
    "ref3": dict(flags=["--with_ref", "--ref_freq", "3"],
                 counts=_sum((_REF, 20)), updates=0),
    "patch": dict(flags=["--lambda_coarse_depth_lap", "0.1",
                         "--lambda_fine_depth_lap", "0.1",
                         "--lambda_fine_vgg", "0.05"],
                  counts=_sum((PARITY[0], 20)), updates=0),
}


def aux_argv(scene, work, name, *extra):
    """The training flags of an aux path (``name``)."""
    if name == "patch":
        argv = ["--name", "aux_patch", "--model", "nerf", "--dataset_mode",
                "llff", "--dataset_root", scene,
                "--img_wh", *map(str, AUX_PATCH_WH),
                "--N_coarse", "64", "--N_importance", "64",
                "--sigma_activation", "relu",
                "--batch_size", str(AUX_PATCH_BATCH),
                "--patch_size", "32", "--vgg_weights",
                os.path.join(work, "vgg_synthetic.npz"),
                "--lr", "5e-4", "--lr_final", "5e-6", "--lr_policy", "exp",
                "--scan_steps", "20",
                "--checkpoints_dir", os.path.join(work, "checkpoints"),
                "--summary_dir", os.path.join(work, "runs")]
    else:
        argv = engine_argv(scene, work, "train", "--name", f"aux_{name}")
    return argv + ["--n_epochs", "1", "--steps_per_epoch", str(AUX_STEPS),
                   "--val_freq", "0", "--val_epoch_freq", "0",
                   "--save_epoch_freq", "1"] \
        + AUX_PATHS[name]["flags"] + list(extra)


def _gan_tensors(gs):
    """The discriminator's parameters, spectral-norm statistics and Adam
    state, by name."""
    out = {}
    for name, t in list(gs.net.named_parameters()) + list(
            gs.net.named_buffers()):
        out[f"D/{name}"] = t
    for i, p in enumerate(gs.net.parameters()):
        for k, v in gs.optimizer.state[p].items():
            out[f"D/{i}/{k}"] = v
    return out


def _aux_buffers(name, opt, dev):
    """The path's device buffers, built once from its training split: the
    ray buffer (patch mode: the image buffer), the reference rays, and
    the GAN/TV patches' raygen buffers with their geometry."""
    from nerfsr_torch.data import create_dataset
    ds = create_dataset(opt, "train")

    def up(b):
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                for k, v in b.items()}
    out = {"buf": up(ds.image_buffer() if name == "patch"
                     else ds.ray_buffer()),
           "ref": up(ds.ref_buffer()) if opt.with_ref else None,
           "gan": None, "geom": None}
    if opt.with_netD or opt.reg_patch:
        bufs, out["geom"] = ds.gan_raygen_buffers()
        out["gan"] = up(bufs)
    return out


class _AuxCase:
    """One aux path's system and fresh state (and discriminator) from its
    options, on the path's buffers; ``chunk`` runs the path's chunk of
    ``AUX_STEPS`` main steps, ``step`` one update of its own kind."""

    def __init__(self, name, opt, dev, bufs):
        from nerfsr_torch.models import create_model
        self.name, self.opt, self.b = name, opt, bufs
        self.system = create_model(opt, device=dev)
        self.state = self.system.create_state(seed=opt.seed,
                                              steps_per_epoch=AUX_STEPS)
        self.gs = self.system.create_gan_state(opt.seed + 1) \
            if opt.with_netD else None

    def chunk(self, gen, it0=0):
        sys_, st, b = self.system, self.state, self.b
        if self.name == "patch":
            self.state, losses = sys_.train_steps_scan_patches(
                st, b["buf"], AUX_STEPS, self.opt.patch_size, gen)
        elif b["ref"] is not None:
            self.state, losses = sys_.train_steps_scan_with_ref(
                st, b["buf"], b["ref"], AUX_STEPS, self.opt.ref_freq, it0,
                gen)
        else:
            self.state, self.gs, losses = sys_.train_steps_scan_gan(
                st, self.gs, b["buf"], b["gan"], AUX_STEPS, b["geom"], it0,
                gen, with_reg=self.opt.reg_patch)
        return losses

    def step(self, gen):
        """One update of the path's own kind, eagerly (a with-ref or patch
        step; the GAN update and then the TV update at fixed patches).
        Returns the losses and the gradient leaves each update left (the
        NeRF's, and D's), copied."""
        sys_, st, b = self.system, self.state, self.b

        def leaves(tag):
            out = [(f"{tag}{n}", p.grad.clone())
                   for n, p in st.params.named_parameters()]
            if self.gs is not None and tag == "gan/":
                out += [(f"D/{n}", p.grad.clone())
                        for n, p in self.gs.net.named_parameters()]
            return out
        if self.name == "patch":
            return sys_.train_step_patches(st, b["buf"], gen)[1], leaves("")
        if b["ref"] is not None:
            losses = sys_.train_step_with_ref(st, b["buf"], b["ref"],
                                              gen)[1]
            return losses, leaves("")
        # the patches: view 1 at the middle LR position, view 2 at a third
        wl, hl = HR_WH[0] // DOWNSCALE, HR_WH[1] // DOWNSCALE
        plen_lr = self.opt.patch_len // DOWNSCALE
        losses = sys_._run_aux("gan", st, self.gs, b["gan"], b["geom"], gen,
                               draws=torch.tensor([1, (hl - plen_lr) // 2,
                                                   (wl - plen_lr) // 2]))
        grads = leaves("gan/")
        if self.opt.reg_patch:
            losses.update(sys_._run_aux(
                "reg", st, None, b["gan"], b["geom"], gen,
                draws=torch.tensor([2, hl // 3, wl // 3])))
            grads += leaves("reg/")
        return losses, grads

    def tensors(self):
        out = _state_tensors(self.state)
        if self.gs is not None:
            out.update(_gan_tensors(self.gs))
        return out


def _aux_vs_plain(name, opt, dev, bufs):
    """One update of the path through the kernels and through the plain
    versions on the card (no jitter, no noise, eager), in f32 and in the
    path's mixed precision: each loss within the bar times max(|loss|, 1)
    (the TV of a 2x2 HR patch is a difference of nearly equal colours,
    small beside them) and each gradient leaf of the NeRF (and of D)
    within the bar of its norm, floored at ``AUX_LEAF_FLOOR`` of the
    update's whole gradient (a one-element bias sums terms that cancel);
    the training step's bars (``STEP_BARS``; in mixed precision D's
    verdict on the patch to ``AUX_VERDICT_MIXED``). D's Adam step takes
    ``--gan_lr`` 1e-9 here: its first step is lr times a sign, which
    turns where D's gradient is within rounding of zero and would move
    what D says to G by far more than the kernels' rounding."""
    out = {}
    for precision in ("f32", "mixed"):
        popt = copy.copy(opt)
        popt.randomized, popt.noise_std = False, 0.0
        popt.precision, popt.gan_lr = precision, 1e-9
        res = {}
        for route in ("kernels", "plain"):
            case = _AuxCase(name, popt, dev, bufs)
            case.system.graphs = None
            case.system.render_cfg = dataclasses.replace(
                case.system.render_cfg, plain=route == "plain")
            gen = torch.Generator(device=dev).manual_seed(5)
            losses, leaves = case.step(gen)
            res[route] = ({k: float(v) for k, v in losses.items()}, leaves)
            del case
        (lk, gk), (lp, gp) = res["kernels"], res["plain"]
        loss_err = {k: abs(lk[k] - lp[k]) / max(abs(lp[k]), 1.0)
                    for k in lp if "psnr" not in k}
        total = float(torch.sqrt(sum(b.double().pow(2).sum()
                                     for _, b in gp)))
        rels = {}
        for (leaf, a), (_, b) in zip(gk, gp):
            if not torch.isfinite(a).all():
                fail(f"aux {name} {precision}: gradient {leaf} non-finite")
            rels[leaf] = float((a.double() - b.double()).norm()) / max(
                float(b.double().norm()), AUX_LEAF_FLOOR * total, 1e-30)
        worst = max(rels, key=rels.get)
        loss_bar, grad_bar = STEP_BARS[precision]
        bars = {k: AUX_VERDICT_MIXED if precision == "mixed"
                and k in ("D_fake", "G_GAN") else loss_bar for k in loss_err}
        out[precision] = {"loss_err": loss_err, "max_leaf_rel": rels[worst],
                          "worst_leaf": worst, "median_leaf_rel":
                          float(np.median(list(rels.values())))}
        over = [k for k in loss_err if loss_err[k] > bars[k]]
        if over or rels[worst] > grad_bar:
            fail(f"aux {name} {precision}: kernels vs plain: losses "
                 f"{ {k: loss_err[k] for k in over} } (bars "
                 f"{ {k: bars[k] for k in over} }), gradient {worst} "
                 f"{rels[worst]:.3e} (bar {grad_bar})")
    return out


def aux_phase(dev, card, work):
    """The auxiliary training paths (``AUX_PATHS``) through the entry
    points on the engine phase's scene: each trains one epoch (one chunk
    of 20 main steps) through ``engine.train`` with exact launch counts
    (the GAN and TV updates at their cadence); then one update through
    the kernels against the plain versions; a graphed chunk equal to the
    eager one from the same seed bit for bit (the discriminator's
    parameters, statistics and moments too), with exact counts on both
    routes; and each route's ms/step over a second chunk."""
    from nerfsr_torch import engine
    from nerfsr_torch.config import parse_options
    from nerfsr_torch.kernels import COUNTS, reset_counts
    from nerfsr_torch.models.criterions import write_synthetic_vgg_npz

    # the discriminator's and VGG's convolutions: deterministic cuDNN, as
    # the engine asks for on these paths (graphed equal to eager)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    scene = os.path.join(work, "scene")
    write_synthetic_vgg_npz(os.path.join(work, "vgg_synthetic.npz"))
    out = {}
    for name, path in AUX_PATHS.items():
        t_run = time.perf_counter()
        argv = aux_argv(scene, work, name)
        opt = parse_options("train", argv)
        reset_counts()
        state = engine.train(opt)
        torch.cuda.synchronize()
        if dict(COUNTS) != path["counts"]:
            fail(f"aux {name}: the engine's launch counts {dict(COUNTS)}, "
                 f"expected {path['counts']}")
        if state.step != AUX_STEPS + path["updates"]:
            fail(f"aux {name}: the engine ended at step {state.step}")
        bufs = _aux_buffers(name, opt, dev)
        res = {"engine_launches": dict(COUNTS),
               "vs_plain": _aux_vs_plain(name, opt, dev, bufs)}
        runs = {}
        for route in ("eager", "graphed"):
            case = _AuxCase(name, opt, dev, bufs)
            if route == "eager":
                case.system.graphs = None
            gen = torch.Generator(device=dev).manual_seed(0)
            reset_counts()
            case.chunk(gen)
            torch.cuda.synchronize()
            if dict(COUNTS) != path["counts"]:
                fail(f"aux {name} {route} chunk: launch counts "
                     f"{dict(COUNTS)}, expected {path['counts']}")
            runs[route] = case.tensors()
            gen.manual_seed(1)
            t0 = time.perf_counter()
            losses = case.chunk(gen, it0=AUX_STEPS)
            vals = torch.stack([v.float() for v in losses.values()]).cpu()
            res[f"{route}_ms_per_step"] = (time.perf_counter() - t0) \
                / AUX_STEPS * 1e3
            if not torch.isfinite(vals).all():
                fail(f"aux {name} {route}: non-finite losses")
            if route == "graphed":
                graphs = case.system.graphs.entries()
                res["graphs"] = {str(k): {
                    "capture_s": e.capture_s,
                    "pool_mib": e.pool_bytes / 2 ** 20,
                    "replays": e.replays} for k, e in graphs.items()}
            del case
        a, b = runs["eager"], runs["graphed"]
        differ = [k for k in a if not torch.equal(a[k], b[k])]
        if differ or a.keys() != b.keys():
            fail(f"aux {name}: the graphed chunk differs from the eager one "
                 f"in {len(differ)} tensors, first {differ[:3]}")
        res.update(tensors_equal=len(a), run_s=time.perf_counter() - t_run)
        pools = sum(g["pool_mib"] for g in res["graphs"].values())
        vp = res["vs_plain"]
        print(f"[aux] {name}: engine epoch of {AUX_STEPS} main steps to step "
              f"{state.step}, launches {res['engine_launches']} as the "
              f"cadence says; one update kernels vs plain (f32 / mixed): "
              f"worst loss {max(vp['f32']['loss_err'].values()):.2e} / "
              f"{max(vp['mixed']['loss_err'].values()):.2e}, worst "
              f"gradient leaf {vp['f32']['max_leaf_rel']:.2e} / "
              f"{vp['mixed']['max_leaf_rel']:.2e} "
              f"({vp['mixed']['worst_leaf']}); a {AUX_STEPS}-step chunk "
              f"graphed equal to eager in {len(a)} tensors bit for bit; "
              f"{res['graphed_ms_per_step']:.2f} ms/step graphed, "
              f"{res['eager_ms_per_step']:.2f} eager; {len(res['graphs'])} "
              f"graphs, pools {pools:.0f} MiB; run {res['run_s']:.1f} s; on "
              f"{card}")
        out[name] = res
        del state, runs, bufs
        torch.cuda.empty_cache()
    return out


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _empty_cache(dev):
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def _upload_buffer(dataset, dev):
    """A dataset's training ray buffer on ``dev``."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
            for k, v in dataset.ray_buffer().items()}


# refine_gan phase: --refine_as_gan at scripts/train_llff_refine.sh's full
# width (UNet ngf 64, 6 downs, 32 patches of 64 px a step, D at ndf 64
# with the 64 px depth, a pool of 50) on the engine phase's scene and
# renders, cut to one engine epoch of REFINE_GAN_STEPS steps
REFINE_GAN_STEPS = 40
# one step on the card against the plain step on the CPU (the aux
# bars, STEP_BARS f32): each loss within 1e-5 of max(|loss|, 1), each
# gradient leaf of G and of D within 1e-2 of its norm, floored at
# AUX_LEAF_FLOOR of the step's whole gradient; D steps at --gan_lr 1e-9
# there, so that what D' tells G does not turn with a sign of D's first
# Adam step (the aux phase's rule)
REFINE_GAN_BARS = STEP_BARS["f32"]


def _gan_run_tensors(state, gs, pool):
    """G's parameters, statistics and Adam state, D's, and the pool."""
    out = _refine_tensors(state)
    out.update(_gan_tensors(gs))
    out.update({f"pool/{k}": v for k, v in pool.items()})
    return out


def _gan_step_vs_cpu(opt, dev, buffers):
    """One update pair on the card and on the CPU from the same G, D and
    batch, with D's learning rate 1e-9: the four losses and every
    gradient leaf of G and D against the CPU's."""
    from nerfsr_torch.models import create_model
    popt = copy.copy(opt)
    popt.gan_lr = 1e-9
    batch = create_model(popt, device=dev).sample_patch_batch(
        buffers, torch.Generator(device=dev).manual_seed(7))
    runs = {}
    for name, device in (("card", dev), ("cpu", torch.device("cpu"))):
        system = create_model(popt, device=device)
        state = system.create_state(seed=opt.seed, steps_per_epoch=1)
        gs = system.create_gan_state(opt.seed)
        _, _, losses, _ = system.gan_train_step(
            state, gs, {k: v.to(device) for k, v in batch.items()})
        grads = [(f"G/{n}", p.grad.cpu().double())
                 for n, p in state.net.named_parameters()]
        grads += [(f"D/{n}", p.grad.cpu().double())
                  for n, p in gs.net.named_parameters()]
        runs[name] = ({k: float(v) for k, v in losses.items()}, grads)
    (lk, gk), (lc, gc) = runs["card"], runs["cpu"]
    loss_err = {k: abs(lk[k] - lc[k]) / max(abs(lc[k]), 1.0) for k in lc}
    total = float(torch.sqrt(sum(b.pow(2).sum() for _, b in gc)))
    rels = {}
    for (leaf, a), (_, b) in zip(gk, gc):
        if not torch.isfinite(a).all():
            fail(f"refine_gan: gradient {leaf} non-finite on the card")
        rels[leaf] = float((a - b).norm()) / max(
            float(b.norm()), AUX_LEAF_FLOOR * total, 1e-30)
    worst = max(rels, key=rels.get)
    loss_bar, grad_bar = REFINE_GAN_BARS
    if max(loss_err.values()) > loss_bar or rels[worst] > grad_bar:
        fail(f"refine_gan one step, card vs CPU: losses {loss_err} (bar "
             f"{loss_bar}), gradient {worst} {rels[worst]:.3e} (bar "
             f"{grad_bar})")
    return {"loss_err": loss_err, "max_leaf_rel": rels[worst],
            "worst_leaf": worst,
            "median_leaf_rel": float(np.median(list(rels.values())))}


def refine_gan_phase(dev, card, work):
    """``--refine_as_gan`` on the engine phase's scene and renders: a
    graphed 20-step chunk against the eager one from the same seed (G,
    its running statistics, D, both Adams and the pool, bit for bit; no
    port kernel launched), each route's ms/step, the capture and the
    pool's memory; one step against the CPU; the engine for one epoch
    (G_L1 falling, every loss finite) and test_refine from it."""
    from nerfsr_torch import engine
    from nerfsr_torch.config import parse_options
    from nerfsr_torch.data import create_dataset
    from nerfsr_torch.kernels import COUNTS, reset_counts
    from nerfsr_torch.models import create_model

    # deterministic cuDNN, as train_refine asks for (graphed equal to
    # eager)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    t_phase = time.perf_counter()
    scene = os.path.join(work, "scene")
    syn = os.path.join(work, "results", "engine", "test_train_3")
    opt = parse_options("train", refine_argv(
        scene, syn, work, "gan", "train", "--refine_as_gan", "--device",
        dev.type, "--n_epochs", "1", "--steps_per_epoch",
        str(REFINE_GAN_STEPS), "--print_freq", str(REFINE_GAN_STEPS // 4),
        "--val_freq", "0"))
    buffers = create_model(opt, device=dev).upload_buffers(
        create_dataset(opt, "train").device_buffers())
    out = {"step_vs_cpu": _gan_step_vs_cpu(opt, dev, buffers)}

    runs = {}
    for route in ("eager", "graphed"):
        system = create_model(opt, device=dev)
        if route == "eager":
            system.graphs = None
        state = system.create_state(seed=0, steps_per_epoch=10 * GRAPH_STEPS)
        gs, pool = system.create_gan_state(0), system.new_pool()
        gen = torch.Generator(device=dev).manual_seed(0)
        reset_counts()
        state, gs, pool, losses = system.train_steps_scan_gan(
            state, gs, pool, buffers, GRAPH_STEPS, gen)
        _sync(dev)
        if any(COUNTS.values()):
            fail(f"refine_gan {route}: port kernels launched {dict(COUNTS)}")
        runs[route] = _gan_run_tensors(state, gs, pool)
        gen.manual_seed(1)
        t0 = time.perf_counter()
        state, gs, pool, losses = system.train_steps_scan_gan(
            state, gs, pool, buffers, GRAPH_STEPS, gen)
        vals = torch.stack(list(losses.values())).cpu()
        out[f"{route}_ms_per_step"] = (time.perf_counter() - t0) \
            / GRAPH_STEPS * 1e3
        if not torch.isfinite(vals).all():
            fail(f"refine_gan {route}: non-finite losses {losses}")
        if route == "graphed" and system.graphs is not None:
            (graph,) = system.graphs.entries().values()
            out.update(capture_s=graph.capture_s,
                       graph_pool_mib=graph.pool_bytes / 2 ** 20,
                       replays=graph.replays)
        out["fake_pool_mib"] = pool["buf"].numel() * 4 / 2 ** 20
        del system, state, gs, pool
        _empty_cache(dev)
    a, b = runs["eager"], runs["graphed"]
    differ = [k for k in a if not torch.equal(a[k], b[k])]
    if differ or a.keys() != b.keys():
        fail(f"refine_gan: the graphed chunk differs from the eager one in "
             f"{len(differ)} tensors, first {differ[:3]}")
    out["tensors_equal"] = len(a)
    del runs, a, b, buffers

    # the engine: one epoch, then test_refine from it
    reset_counts()
    t0 = time.perf_counter()
    state = engine.train_refine(opt)
    out["engine_s"] = time.perf_counter() - t0
    if state.step != REFINE_GAN_STEPS:
        fail(f"refine_gan: the engine ended at step {state.step}")
    g_l1 = []
    with open(os.path.join(work, "refine_runs", "gan", "metrics.jsonl")) as f:
        for line in f:
            rec = json.loads(line)
            if rec["tag"].startswith("train/") and not \
                    np.isfinite(rec["value"]):
                fail(f"refine_gan: {rec['tag']} at step {rec['step']} is "
                     f"{rec['value']}")
            if rec["tag"] == "train/G_L1":
                g_l1.append(rec["value"])
    if len(g_l1) != 4 or not g_l1[-1] < g_l1[0]:
        fail(f"refine_gan: G_L1 over the run {g_l1}")
    tst = parse_options("test", refine_argv(
        scene, syn, work, "gan", "test", "--device", dev.type,
        "--test_split", "test_train", "--load_epoch", "1"))
    out_dir = engine.test_refine(tst)
    if len([f for f in os.listdir(out_dir) if f.endswith("-sr-refine.png")]) \
            != ENGINE_VIEWS:
        fail(f"refine_gan: test_refine wrote {os.listdir(out_dir)}")
    if any(COUNTS.values()):
        fail(f"refine_gan: the engine launched port kernels {dict(COUNTS)}")
    vp = out["step_vs_cpu"]
    print(f"[refine_gan] a {GRAPH_STEPS}-step chunk graphed equals the eager "
          f"one in {out['tensors_equal']} tensors bit for bit (G, its "
          f"statistics, D, both Adams, the pool); "
          f"{out['graphed_ms_per_step']:.2f} ms/step graphed, "
          f"{out['eager_ms_per_step']:.2f} eager (batch {opt.batch_size}, "
          f"{opt.patch_len} px, host clock to a synchronize); capture "
          f"{out.get('capture_s', 0):.2f} s, graph pool "
          f"{out.get('graph_pool_mib', 0):.0f} MiB, fake pool "
          f"{out['fake_pool_mib']:.2f} MiB; one step card vs CPU: worst loss "
          f"{max(vp['loss_err'].values()):.2e}, worst gradient leaf "
          f"{vp['max_leaf_rel']:.2e} ({vp['worst_leaf']}); engine epoch of "
          f"{REFINE_GAN_STEPS} steps in {out['engine_s']:.1f} s, G_L1 "
          f"{g_l1[0]:.3f} -> {g_l1[-1]:.3f}; test_refine wrote "
          f"{ENGINE_VIEWS} strips; no port kernel launched; on {card}")
    out.update(g_l1=g_l1, phase_s=time.perf_counter() - t_phase, card=card)
    return out


# dist phase: the engine phase's run (scripts/train_llff_downX_fast.sh's
# flags, one epoch of ENGINE_STEPS) with and without --num_processes 1
# (NCCL at world size 1: every collective of the split step and the
# eval render runs, inside the graphs)
class _StateLog(_ChunkLog):
    """A ``_ChunkLog`` that also keeps every state tensor after each
    chunk (on the host)."""

    def __enter__(self):
        super().__enter__()
        self.states = []
        real, states = dict(self._real), self.states
        from nerfsr_torch.models.nerf_system import NeRFSystem

        def keeper(run):
            def wrapped(system, state, *a, **kw):
                out = run(system, state, *a, **kw)
                states.append({k: v.detach().cpu().clone()
                               for k, v in _state_tensors(out[0]).items()})
                return out
            return wrapped
        for name in real:
            setattr(NeRFSystem, name, keeper(getattr(NeRFSystem, name)))
        return self


def _graphed_ms(dev, opt, buffer):
    """ms/step of a graphed chunk of GRAPH_STEPS after the one that
    captures it (host clock to a synchronize)."""
    from nerfsr_torch.models import create_model
    system = create_model(opt, device=dev)
    state = system.create_state(seed=0, steps_per_epoch=10 * GRAPH_STEPS)
    gen = torch.Generator(device=dev).manual_seed(0)
    state, _ = system.train_steps_scan(state, buffer, GRAPH_STEPS, gen)
    _sync(dev)
    t0 = time.perf_counter()
    state, losses = system.train_steps_scan(state, buffer, GRAPH_STEPS, gen)
    torch.stack(list(losses.values())).cpu()
    return (time.perf_counter() - t0) / GRAPH_STEPS * 1e3


def dist_phase(dev, card, work):
    """The engine with ``--num_processes 1 --process_id 0 --coordinator``
    (NCCL at world size 1) against the same run without a group: each
    chunk's state bit for bit, the launch counts, the test PNGs byte for
    byte; ms/step of a graphed chunk with the collectives and without;
    ``--mesh_devices 2`` refused with the card count."""
    from nerfsr_torch import engine
    from nerfsr_torch.config import parse_options
    from nerfsr_torch.data import create_dataset
    from nerfsr_torch.kernels import COUNTS, reset_counts
    from nerfsr_torch.parallel import mesh

    t_phase = time.perf_counter()
    scene = os.path.join(work, "scene")
    group = ["--num_processes", "1", "--process_id", "0", "--coordinator",
             f"127.0.0.1:{mesh.free_port()}"]
    out, runs = {}, {}
    buffer = None
    for name, extra in (("plain", []), ("group", group)):
        argv = ["--name", f"dist_{name}", "--device", dev.type] + extra
        opt = parse_options("train", engine_argv(
            scene, work, "train", "--n_epochs", "1", *argv))
        reset_counts()
        with _StateLog() as log:
            state = engine.train(opt)
        _sync(dev)
        if set(log.routes()) != {"train_steps_scan"}:
            fail(f"dist {name}: the engine's chunks {log.chunks}")
        if (name == "group") != mesh.active():
            fail(f"dist {name}: process group active: {mesh.active()}")
        train_counts = dict(COUNTS)
        topt = parse_options("test", engine_argv(
            scene, work, "test", "--test_split", "test_train",
            "--load_epoch", "1", *argv))
        reset_counts()
        out_dir = engine.test(topt)
        test_counts = dict(COUNTS)
        if buffer is None:
            buffer = _upload_buffer(create_dataset(opt, "train"), dev)
        runs[name] = {"states": log.states, "train_counts": train_counts,
                      "test_counts": test_counts, "dir": out_dir,
                      "ms": _graphed_ms(dev, opt, buffer), "step": state.step}
        _empty_cache(dev)
    a, b = runs["plain"], runs["group"]
    if len(a["states"]) != len(b["states"]) or not a["states"]:
        fail(f"dist: {len(a['states'])} and {len(b['states'])} chunks")
    n_tensors = 0
    for i, (sa, sb) in enumerate(zip(a["states"], b["states"])):
        differ = [k for k in sa if not torch.equal(sa[k], sb[k])]
        if differ or sa.keys() != sb.keys():
            fail(f"dist: chunk {i} at world size 1 differs from the plain "
                 f"run's in {len(differ)} tensors, first {differ[:3]}")
        n_tensors += len(sa)
    for k in ("train_counts", "test_counts"):
        if a[k] != b[k]:
            fail(f"dist: {k} {b[k]} at world size 1, {a[k]} without")
    files = sorted(f for f in os.listdir(a["dir"]) if f.endswith(".png"))
    if not files or files != sorted(f for f in os.listdir(b["dir"])
                                    if f.endswith(".png")):
        fail(f"dist: test PNGs {files} and {os.listdir(b['dir'])}")
    for f in files:
        with open(os.path.join(a["dir"], f), "rb") as x, \
                open(os.path.join(b["dir"], f), "rb") as y:
            if x.read() != y.read():
                fail(f"dist: {f} differs at world size 1")
    mesh.shutdown()
    refused = None
    if dev.type == "cuda":     # on the CPU it would spawn two gloo ranks
        try:
            engine.train(parse_options("train", engine_argv(
                scene, work, "train", "--name", "dist_two",
                "--mesh_devices", "2")))
        except RuntimeError as e:
            refused = str(e)
        count = torch.cuda.device_count()
        if refused is None or f"{count} card" not in refused:
            fail(f"dist: --mesh_devices 2 on {count} card(s): {refused}")
    out.update(chunks_equal=len(a["states"]), tensors_equal=n_tensors,
               launches=b["train_counts"], test_launches=b["test_counts"],
               test_pngs_equal=len(files), graphed_ms_per_step=b["ms"],
               plain_graphed_ms_per_step=a["ms"], mesh_devices_2=refused,
               phase_s=time.perf_counter() - t_phase, card=card)
    print(f"[dist] --num_processes 1 (NCCL, world size 1) against no group: "
          f"{len(a['states'])} chunks of the engine equal bit for bit "
          f"({n_tensors} tensors), launch counts equal (train "
          f"{b['train_counts']}, test {b['test_counts']}), {len(files)} test "
          f"PNGs equal byte for byte; graphed {b['ms']:.3f} ms/step with the "
          f"collectives, {a['ms']:.3f} without; --mesh_devices 2 refused: "
          f"{refused}; on {card}")
    return out


# zoo phase: the rest of the network zoo at full width on the engine
# phase's scene. NeuTexMLP (D8/W256) in NeRF-SR x2 with
# scripts/train_llff_downX_fast.sh's flags plus --mlp_network neutex_mlp,
# cut to one engine epoch of ENGINE_STEPS steps; the template system with
# no --model; and the modules no path calls, card against CPU
NEUTEX = ["--mlp_network", "neutex_mlp"]
# NeuTex does not fit kernel C, so its layers take the module path (cuBLAS)
# and its backward is autograd's: a step runs A twice, B and D once
NEUTEX_STEP = {"invert_cdf": 2, "composite_fwd": 1, "fused_mlp_fwd": 0,
               "composite_bwd": 1, "fused_mlp_bwd": 0}
TEMPLATE_STEPS, TEMPLATE_EPOCHS = 50, 4
# ResnetGenerator at pix2pix's width (ngf 64, 9 blocks) on 4 256x256
# images in training mode, card (f32, TF32 off) against the CPU in f32
# and in f64: the output (after tanh) against the CPU's f32 to
# RESNET_OUT_ABS; each gradient leaf's distance to the f64 pass, over the
# larger of the leaf's f64 norm and RESNET_LEAF_FLOOR of the largest
# leaf's (a conv bias under a batch norm in training has a zero
# gradient: rounding noise), at most the refine phase's
# REFINE_F64_RATIO times the CPU's f32 distance plus REFINE_LEAF_FLOOR
RESNET_SHAPE = (4, 256, 256, 3)
RESNET_OUT_ABS, RESNET_LEAF_FLOOR = 1e-4, 1e-2
# the small modules, card against CPU, f32: max abs error of the output
# (grad_loss: relative, it grows as the fourth power of the gradients)
ZOO_ABS, ZOO_GRAD_LOSS_REL = 1e-4, 1e-4


def _zoo_modules_vs_cpu(dev, card):
    """ResnetGenerator forward and backward on the card against the CPU
    (f32, and f64 for the gradients' reference) with its ms for a forward
    and backward; the bilateral renderer, grad_loss, ConvBlock and Up2x
    on the card against the CPU, f32."""
    from nerfsr_torch.core.rendering import bilateral_volumetric_rendering
    from nerfsr_torch.models import networks
    from nerfsr_torch.models.criterions import grad_loss

    out = {}
    gen = torch.Generator().manual_seed(5)
    net = networks.ResnetGenerator(ngf=64, n_blocks=9, generator=gen).train()
    x = torch.rand(RESNET_SHAPE, generator=gen) * 2 - 1
    res = {}
    for name, where, dtype in (("card", dev, torch.float32),
                               ("cpu", "cpu", torch.float32),
                               ("f64", "cpu", torch.float64)):
        n = copy.deepcopy(net).to(where, dtype)
        y = n(x.to(where, dtype))
        y.square().mean().backward()
        res[name] = (y.detach().cpu().double(),
                     {k: p.grad.cpu().double()
                      for k, p in n.named_parameters()})
        del n, y
    out_err = float((res["card"][0] - res["cpu"][0]).abs().max())
    ref = res["f64"][1]
    floor = RESNET_LEAF_FLOOR * max(float(g.norm()) for g in ref.values())

    def dist(name, k):
        return float((res[name][1][k] - ref[k]).norm()) / max(
            float(ref[k].norm()), floor)
    leaves = {k: (dist("card", k), dist("cpu", k)) for k in ref}
    worst = max(leaves, key=lambda k: leaves[k][0] - REFINE_F64_RATIO
                * leaves[k][1])
    card_leaf, cpu_leaf = leaves[worst]
    n = copy.deepcopy(net).to(dev)
    xd = x.to(dev)
    for _ in range(2):                    # cuDNN's algorithms, the pool
        n(xd).square().mean().backward()
    _sync(dev)
    reps = 5
    t0 = time.perf_counter()
    for _ in range(reps):
        n.zero_grad(set_to_none=True)
        n(xd).square().mean().backward()
    _sync(dev)
    ms = (time.perf_counter() - t0) / reps * 1e3
    print(f"[zoo] ResnetGenerator ngf 64, 9 blocks, {RESNET_SHAPE[0]}x"
          f"{RESNET_SHAPE[1]}x{RESNET_SHAPE[2]}, f32 (TF32 off), card vs "
          f"CPU: output max abs err {out_err:.2e} (bar {RESNET_OUT_ABS}); "
          f"gradient leaf {worst} {card_leaf:.2e} from the f64 pass, the "
          f"CPU's f32 {cpu_leaf:.2e} (bar {REFINE_F64_RATIO}x + "
          f"{REFINE_LEAF_FLOOR}; the card's worst leaf "
          f"{max(v[0] for v in leaves.values()):.2e}); forward + backward "
          f"{ms:.2f} ms on {card}")
    if out_err > RESNET_OUT_ABS or \
            card_leaf > REFINE_F64_RATIO * cpu_leaf + REFINE_LEAF_FLOOR:
        fail("ResnetGenerator: the card and the CPU disagree")
    out["resnet_generator"] = dict(
        out_max_abs=out_err, worst_leaf=worst,
        worst_leaf_card_vs_f64=card_leaf, worst_leaf_cpu_vs_f64=cpu_leaf,
        max_card_vs_f64=max(v[0] for v in leaves.values()),
        max_cpu_vs_f64=max(v[1] for v in leaves.values()), fwd_bwd_ms=ms)
    del n, xd, res
    _empty_cache(dev)

    def both(fn, *args):
        got = fn(*[a.to(dev) for a in args])
        want = fn(*args)
        if isinstance(want, torch.Tensor):
            got, want = (got,), (want,)
        return max(float((g.cpu() - w).abs().max())
                   for g, w in zip(got, want)), want

    n_rays, s = 4096, 64
    rgb = torch.rand((n_rays, s, 3), generator=gen)
    neighbors = (rgb.repeat(5, 1, 1) + 0.2 * torch.randn(
        (5 * n_rays, s, 3), generator=gen)).clamp(0, 1)
    sigma = torch.randn((n_rays, s), generator=gen) * 3
    z = torch.sort(torch.rand((n_rays, s), generator=gen), -1)[0]
    errs = {"bilateral": both(
        lambda *a: bilateral_volumetric_rendering(*a, white_bkgd=True,
                                                  gamma=0.1),
        rgb, neighbors, sigma, z)[0]}
    pred = torch.rand((4, 128, 128, 3), generator=gen)
    target = torch.rand((4, 128, 128, 3), generator=gen)
    err, want = both(grad_loss, pred, target)
    errs["grad_loss_rel"] = err / abs(float(want[0]))
    img = torch.rand((4, 64, 64, 32), generator=gen)
    for name, mod in (("conv_block", networks.ConvBlock(
            32, 64, 3, 1, 1, "batch", generator=gen)),
            ("up2x", networks.Up2x(32, 64, "batch", generator=gen))):
        mod.train()
        card_mod = copy.deepcopy(mod).to(dev)
        got = card_mod(img.to(dev))
        errs[name] = float((got.cpu() - mod(img)).abs().detach().max())
        errs[name + "_running_var"] = float(
            (card_mod.BatchNorm_0.var.cpu() - mod.BatchNorm_0.var).abs()
            .max())
    print(f"[zoo] card vs CPU, f32: {errs} (bars: {ZOO_ABS} abs, grad_loss "
          f"{ZOO_GRAD_LOSS_REL} relative)")
    if errs.pop("grad_loss_rel") > ZOO_GRAD_LOSS_REL or \
            max(errs.values()) > ZOO_ABS:
        fail("zoo modules: the card and the CPU disagree")
    out["modules_vs_cpu"] = errs
    return out


def _template_run(dev, work):
    """The template through the engine with no --model: the mse the
    engine logged falls, no port kernel runs."""
    from nerfsr_torch import engine
    from nerfsr_torch.config import parse_options
    from nerfsr_torch.kernels import COUNTS, reset_counts

    argv = ["--name", "zoo_template", "--dataset_root", work, "--img_wh",
            "8", "8", "--device", dev.type, "--checkpoints_dir",
            os.path.join(work, "checkpoints"), "--summary_dir",
            os.path.join(work, "runs"), "--val_freq", "0",
            "--val_epoch_freq", "0", "--vis_epoch_freq", "0",
            "--batch_size", "256", "--lr", "1e-2", "--n_epochs_decay", "0",
            "--steps_per_epoch", str(TEMPLATE_STEPS), "--print_freq", "10",
            "--n_epochs", str(TEMPLATE_EPOCHS)]
    opt = parse_options("train", argv)
    if opt.model != "template":
        fail(f"no --model gave {opt.model}")
    reset_counts()
    t0 = time.perf_counter()
    state = engine.train(opt)
    _sync(dev)
    seconds = time.perf_counter() - t0
    counts = dict(COUNTS)
    mses = []
    with open(os.path.join(work, "runs", "zoo_template",
                           "metrics.jsonl")) as f:
        for line in f:
            rec = json.loads(line)
            if rec["tag"] == "train/mse":
                mses.append(rec["value"])
    steps = TEMPLATE_STEPS * TEMPLATE_EPOCHS
    print(f"[zoo] template (no --model) on {dev}: {state.step} steps in "
          f"{seconds:.2f} s, mse {mses[0]:.4f} -> {mses[-1]:.4f}; launches "
          f"{counts}")
    if state.step != steps or len(mses) != steps // 10 or \
            not np.isfinite(mses).all() or mses[-1] > 0.5 * mses[0]:
        fail(f"template: step {state.step}, mse {mses}")
    if any(counts.values()):
        fail(f"template: port kernels launched {counts}")
    return dict(steps=state.step, mse_first=mses[0], mse_last=mses[-1],
                seconds=seconds)


def zoo_phase(dev, card, work):
    """NeuTexMLP in NeRF-SR x2 at full width: one step through the
    kernels against the plain path, a graphed 20-step chunk against the
    eager one (bit for bit, 2 A, 1 B, 0 C, 1 D, 0 E a step), one engine
    epoch (fine PSNR rising) and test (PNGs equal to
    ``render_eval_many``'s, serving ms/image); the template with no
    --model; the unused modules card against CPU."""
    from nerfsr_torch import engine
    from nerfsr_torch.config import parse_options
    from nerfsr_torch.data import create_dataset
    from nerfsr_torch.kernels import COUNTS, reset_counts
    from nerfsr_torch.models import create_model
    from nerfsr_torch.models.mlp import NeuTexMLP
    from nerfsr_torch.utils import png

    t_phase = time.perf_counter()
    out = {}
    scene = os.path.join(work, "scene")
    argv = ["--name", "zoo_neutex", "--n_epochs", "1", *NEUTEX]
    opt = parse_options("train", engine_argv(scene, work, "train", *argv))
    buffer = _upload_buffer(create_dataset(opt, "train"), dev)
    out["step_vs_plain"] = step_vs_plain(dev, buffer, "neutex_mlp")

    def make():
        system = create_model(train_options("mixed",
                                            mlp_network="neutex_mlp"),
                              device=dev)
        if system.render_cfg.use_fused_mlp or not isinstance(
                system.init_params(0)["fine"], NeuTexMLP):
            fail("--mlp_network neutex_mlp did not build NeuTexMLP off "
                 "kernel C")
        return system
    res = chunk_vs_eager(dev, make, buffer, counts=NEUTEX_STEP)
    print(f"[zoo] NeuTex x2 llff mixed: a {GRAPH_STEPS}-step graphed chunk "
          f"equals the eager chunk in {res['tensors_equal']} tensors bit for "
          f"bit, launches a step {NEUTEX_STEP}; "
          f"{res['graphed_ms_per_step']:.2f} ms/step graphed, "
          f"{res['eager_ms_per_step']:.2f} eager; capture "
          f"{res['capture_s']:.2f} s, graph pool "
          f"{res['graph_pool_mib']:.0f} MiB; on {card}")
    out["chunk"] = res
    del buffer
    _empty_cache(dev)

    # one engine epoch, from the seed's weights: the val view's fine PSNR
    # before and after
    probe = create_model(opt, device=dev)
    val_ds = create_dataset(opt, "val")
    before = engine.validate(opt, probe, probe.create_state(
        seed=opt.seed, steps_per_epoch=ENGINE_STEPS).params, val_ds)
    del probe
    timings = {}
    reset_counts()
    with _ChunkLog() as log:
        state = engine.train(opt, timings=timings)
    _sync(dev)
    if set(log.routes()) != {"train_steps_scan"}:
        fail(f"zoo engine chunks: {log.chunks}")
    w, h = HR_WH
    chunks = -(-(w * h) // 4096)
    image = {"invert_cdf": 2 * chunks, "composite_fwd": chunks}
    # the epoch's validation renders the val view twice (device metrics,
    # then the read-back strips)
    want = {k: ENGINE_STEPS * v + 2 * image.get(k, 0)
            for k, v in NEUTEX_STEP.items()}
    if dict(COUNTS) != want or state.step != ENGINE_STEPS:
        fail(f"zoo engine: launches {dict(COUNTS)}, expected {want}; step "
             f"{state.step}")
    after = _val_metrics(work, "zoo_neutex", ENGINE_STEPS)
    ms_step = timings["epoch_s"][1] / ENGINE_STEPS * 1e3
    print(f"[zoo] NeuTex engine epoch: {ENGINE_STEPS} steps, "
          f"{ms_step:.2f} ms/step (engine, host clock to the chunk's loss "
          f"read); val fine_psnr {before['fine_psnr']:.3f} -> "
          f"{after['fine_psnr']:.3f} dB; launches {want}")
    if not after["fine_psnr"] > before["fine_psnr"]:
        fail("zoo engine: the fine PSNR did not rise")

    topt = parse_options("test", engine_argv(
        scene, work, "test", "--name", "zoo_neutex", "--test_split",
        "test_train", "--load_epoch", "1", *NEUTEX))
    test_t = {}
    reset_counts()
    out_dir = engine.test(topt, timings=test_t)
    want = {k: ENGINE_VIEWS * image.get(k, 0) for k in NEUTEX_STEP}
    if dict(COUNTS) != want:
        fail(f"zoo test: launches {dict(COUNTS)}, expected {want}")
    system = create_model(topt, device=dev)
    dataset = create_dataset(topt, "test_train")
    list(system.render_eval_many(state.params, dataset, [0],
                                 quantize_rgb=True))      # the capture
    _sync(dev)
    t0 = time.perf_counter()
    renders = list(system.render_eval_many(
        state.params, dataset, range(ENGINE_VIEWS), quantize_rgb=True))
    _sync(dev)
    serve_ms = (time.perf_counter() - t0) / ENGINE_VIEWS * 1e3
    for i, r in enumerate(renders):
        panel = png.read_rgb(os.path.join(out_dir,
                                          f"{i}-fine-ori.png"))[:, :w]
        if not np.array_equal(panel, r["fine_rgb_ori"].reshape(h, w, 3)):
            fail(f"zoo: {i}-fine-ori.png differs from render_eval_many's")
    test_ms = test_t["seconds"] / test_t["views"] * 1e3
    print(f"[zoo] NeuTex serving: {ENGINE_VIEWS} views {w}x{h}, "
          f"{serve_ms:.1f} ms/image (render_eval_many, one replay an "
          f"image), test {test_ms:.1f} ms/image with the writes; "
          f"{ENGINE_VIEWS} test panels equal render_eval_many's; launches "
          f"an image {image}; on {card}")
    out["engine"] = dict(ms_per_step=ms_step, psnr_before=before,
                         psnr_after=after, serve_ms_per_image=serve_ms,
                         test_ms_per_image=test_ms,
                         launches_per_step=NEUTEX_STEP,
                         launches_per_image=image)
    del system, state, renders
    _empty_cache(dev)
    out["template"] = _template_run(dev, work)
    out.update(_zoo_modules_vs_cpu(dev, card))
    out.update(phase_s=time.perf_counter() - t_phase, card=card)
    print(f"[zoo] phase done in {out['phase_s']:.1f} s")
    return out


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
    log = _lib.build_log()
    with open(os.path.join(OUT_DIR, "chip_smoke_build.log"), "w") as f:
        f.write(log)
    regs = check_registers(log)
    floor = launch_floor()

    gen = torch.Generator().manual_seed(0)
    a = check_invert_cdf(dev, gen)
    b = check_composite(dev, gen)
    c = check_fused_mlp(dev, gen)
    d = check_composite_bwd(dev, gen)
    e = check_fused_mlp_bwd(dev, gen)
    new_shapes = check_new_shapes(dev, gen)
    new_shapes["aux"] = check_aux_shapes(dev, gen)
    serve_counts, ms_img, rays_s, slice_err = slice_phase(dev, card)
    counts, train, buffer = train_phase(dev, card)
    graphs_out = graphs_phase(dev, card, buffer)
    del buffer
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="nerfsr_smoke_") as work:
        engine_out = engine_phase(dev, card, train["ms_per_step"], work)
        t0 = time.perf_counter()
        datasets_out = datasets_phase(dev, card, work,
                                      os.path.join(work, "scene"))
        datasets_out["phase_s"] = time.perf_counter() - t0
        refine_out = refine_phase(dev, card, work)
        t0 = time.perf_counter()
        aux_out = aux_phase(dev, card, work)
        aux_out["phase_s"] = time.perf_counter() - t0
        refine_gan_out = refine_gan_phase(dev, card, work)
        dist_out = dist_phase(dev, card, work)
        zoo_out = zoo_phase(dev, card, work)

    # launches: the timed training window (graph replays), which runs all
    # five kernels
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
             source="nerfsr_torch/csrc/fused_mlp_tc.cu",
             replaces=ops + "pallas_mlp.py:183",
             launches=counts["fused_mlp_fwd"],
             **{k: c["bf16"][k] for k in keys}),
        dict(name="composite_bwd", route="cuda",
             source="nerfsr_torch/csrc/composite.cu",
             replaces=ops + "pallas_composite.py:177",
             launches=counts["composite_bwd"], **{k: d[k] for k in keys}),
        dict(name="fused_mlp_bwd", route="cuda",
             source="nerfsr_torch/csrc/fused_mlp_bwd_tc.cu",
             replaces=ops + "pallas_mlp.py:433",
             launches=counts["fused_mlp_bwd"],
             **{k: e["bf16"][k] for k in keys}),
    ]
    for k in kernels:
        k["library_ms"] = None
    detail = json.dumps({"detail": {"invert_cdf_shapes": a["shapes"],
                                 "launch_floor_ms": floor,
                                 "registers_a_b_d": regs,
                                 "composite_bwd_shapes": d["shapes"],
                                 "fused_mlp_f32": c["f32"],
                                 "fused_mlp_bf16_tflops":
                                     c["bf16"]["tflops"],
                                 "fused_mlp_bf16_cublas_chain_ms":
                                     c["bf16"]["cublas_chain_ms"],
                                 "fused_mlp_bwd": e,
                                 "slice": {"ms_per_image": ms_img,
                                           "hr_rays_per_s": rays_s,
                                           "chunk_errors": slice_err,
                                           "launches": serve_counts},
                                 "train": train,
                                 "graphs": graphs_out,
                                 "engine": engine_out,
                                 "new_shapes": new_shapes,
                                 "datasets": datasets_out,
                                 "refine": refine_out,
                                 "aux": aux_out,
                                 "refine_gan": refine_gan_out,
                                 "dist": dist_out,
                                 "zoo": zoo_out,
                                 "card": card}})
    with open(os.path.join(OUT_DIR, "chip_smoke_detail.json"), "w") as f:
        f.write(detail + "\n")
    print(detail)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
