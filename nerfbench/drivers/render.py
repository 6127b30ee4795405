"""The ``render`` cells: serving novel views, one after another.

Set-up makes the capture's poses and the weights from the seed, the
spiral test path that the LLFF test split renders from those poses,
builds the system for its ``test`` phase with the benchmark's weights,
and renders ``warmup_views`` views, which captures the eval image's
CUDA graph. The window consumes ``render_eval_many(params, views,
indices, quantize_rgb=True)`` view by view, round the spiral, until
``seconds`` have passed; the view in flight then arrives and ends it.
An image's latency runs from the previous image's arrival on the host to
its own (the first image's from the window's start); the tail is the
95th percentile of every image's latency in the window.

The check renders ``check_images`` of the window's images, drawn from
the seed, with the reference, and compares each with the system's HR
image byte for byte as the mean absolute difference in levels.
"""

from __future__ import annotations

import sys

import numpy as np

from nerfbench import inputs
from nerfbench import trace as tracing
from nerfbench.drivers import (Phases, Result, arch_of, by_thirds, free,
                               image_mae, memory_peak, now, pick,
                               program_options, sync)
from nerfbench.reference import nerf as ref


def spiral_views(seed, cell):
    """The spiral path the LLFF test split renders: radii the 90th
    percentile of the capture's camera offsets."""
    traffic = cell.traffic
    c2ws = inputs.poses(seed, traffic["capture_views"], traffic["scene"])
    radii = np.percentile(np.abs(c2ws[..., 3]), 90, axis=0)
    return inputs.spiral(radii, traffic["focus_depth"], traffic["views"])


def run(cell, seed: int, seconds: float, trace: bool, device) -> Result:
    from nerfsr_torch.data.views import LLFFDownXViews
    from nerfsr_torch.models import create_model

    config, traffic = cell.config, cell.traffic
    ph = Phases()
    arch = arch_of(config)
    w, h = arch["img_wh"]
    path = spiral_views(seed, cell)
    wts = inputs.weights(seed, arch, device)
    opt = program_options(config, "test", device)
    system = create_model(opt, device=device)
    params = system.init_params(seed=0)
    inputs.load_into(params, wts)
    views = LLFFDownXViews(path, config["focal"], (w, h), arch["downscale"])
    n_views = len(views)
    for _ in system.render_eval_many(params, views,
                                     range(traffic["warmup_views"]),
                                     quantize_rgb=True):
        pass
    sync(device)
    ph.done("inputs, system and warm-up")
    window_start = now()

    order, arrivals, images = [], [], []

    def indices(end):
        i = 0
        while now() < end:
            order.append(i % n_views)
            yield i % n_views
            i += 1

    t0 = now()
    for out in system.render_eval_many(params, views, indices(t0 + seconds),
                                       quantize_rgb=True):
        arrivals.append(now())
        images.append(out["fine_rgb_ori"])
    window_s = arrivals[-1] - t0
    peak = memory_peak(device)
    n = len(images)
    ph.done(f"window ({n} images)")
    print("[nerfbench] ms an image by thirds of the window: " + " ".join(
        f"{s * 1e3:.3f}" for s in by_thirds(t0, arrivals)), file=sys.stderr)

    ctx = {"kind": "render", "arch": arch, "rays_per_unit": w * h,
           "units": n, "window_s": window_s}
    if trace:
        k = traffic["traced_views"]
        box = [k]
        with tracing.record(box) as got:
            for _ in system.render_eval_many(
                    params, views, [i % n_views for i in range(k)],
                    quantize_rgb=True):
                pass
            sync(device)
        ctx["trace"] = got[0]
        ph.done("trace")

    del system, params
    free(device)
    ref.strict_f32()
    checks = []
    worst = 0.0
    for k in pick(seed, n, traffic["check_images"], 3):
        want = reference_image(wts, path[order[k]], arch, config, device)
        got_img = np.asarray(images[k]).reshape(h, w, 3)
        worst = max(worst, image_mae(got_img, want))
    checks.append(("rgb_mae", worst, cell.limits["rgb_mae"]))
    ph.done("check")
    return Result({"render_image_ms": window_s / n * 1e3,
                   "render_image_ms_p95": tail_ms(t0, arrivals)},
                  ctx, checks, n, 0, peak, window_start)


def tail_ms(t0: float, arrivals, q: float = 95) -> float:
    """The ``q``th percentile, in ms, of every image's latency: from the
    previous image's arrival (the first's from ``t0``) to its own."""
    return float(np.percentile(np.diff([t0] + list(arrivals)), q)) * 1e3


def reference_image(wts, c2w, arch, config, device, precision="f32"):
    import torch
    w, h = arch["img_wh"]
    return ref.render_view(wts, torch.as_tensor(c2w, device=device), arch,
                           (h, w), config["focal"], precision).cpu().numpy()
