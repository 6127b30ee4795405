"""The ``test`` cells: the user's ``test`` command, again and again.

Set-up makes the scene from the seed and writes it as a COLMAP capture
(``sparse/0`` and ``images/*.png``, the system's own writer) under the
run's temporary directory, with a checkpoint of the seeded weights
(epoch 1, the system's own save), and warms the card with one view
rendered from that scene. The window calls ``engine.test`` on that
capture's ``test_split`` until ``seconds`` have passed; the call then
running ends it. Each call pays its own set-up, dataset and checkpoint
load, as a user's command does, and its results directory is removed
after it. From each call the benchmark keeps one HR strip, of a view
drawn from the seed, as bytes.

The check decodes ``check_views`` of the kept strips with the
benchmark's own PNG reader and holds the rendered panel to the
reference's render of that view (the mean absolute difference in
levels) and the ground-truth panel to the capture's image, quantized as
the writer quantizes it, byte for byte.
"""

from __future__ import annotations

import os
import shutil
import tempfile

import numpy as np

from nerfbench import inputs, png
from nerfbench import trace as tracing
from nerfbench.drivers import (Phases, Result, arch_of, free, image_mae,
                               memory_peak, now, pick, program_options, sync)
from nerfbench.drivers.render import reference_image
from nerfbench.reference import nerf as ref


def _write_capture(work, c2ws, imgs, config, seed, cell, wts, device):
    from nerfsr_torch.data.synthetic import write_llff_scene
    from nerfsr_torch.models import create_model
    from nerfsr_torch.utils import checkpoint as ckpt

    scene_dir = os.path.join(work, "scene")
    write_llff_scene(scene_dir, c2ws, imgs, config["focal"],
                     inputs.scene_points(seed, cell.traffic["scene"]),
                     save=png.write)
    opt = program_options(
        config, "test", device, name="nerfbench",
        dataset_root=scene_dir,
        checkpoints_dir=os.path.join(work, "checkpoints"),
        results_dir=os.path.join(work, "results"),
        test_split=cell.traffic["test_split"], load_epoch=1)
    system = create_model(opt, device=device)
    state = system.create_state(seed=0, steps_per_epoch=1)
    inputs.load_into(state.params, wts)
    ckpt.save_checkpoint(opt, state, 1)
    return opt, system, state


def run(cell, seed: int, seconds: float, trace: bool, device) -> Result:
    from nerfsr_torch import engine
    from nerfsr_torch.data import create_dataset

    config, traffic = cell.config, cell.traffic
    ph = Phases()
    arch = arch_of(config)
    w, h = arch["img_wh"]
    c2ws = inputs.poses(seed, traffic["views"], traffic["scene"])
    imgs = inputs.render_images(c2ws, (h, w), config["focal"], seed,
                                traffic["scene"], device)
    wts = inputs.weights(seed, arch, device)
    work = tempfile.mkdtemp(prefix="nerfbench_")
    try:
        sync(device)
        ph.done("inputs")
        opt, system, state = _write_capture(work, c2ws, imgs, config, seed,
                                            cell, wts, device)
        ph.done("capture and checkpoint written")
        dataset = create_dataset(opt, opt.test_split)
        n_views = len(dataset)
        for _ in system.render_eval_many(state.params, dataset, [0],
                                         quantize_rgb=True):
            pass
        del system, state, dataset
        sync(device)
        ph.done("warm-up")
        window_start = now()

        rng = np.random.default_rng([int(seed) & (2 ** 64 - 1), 4])
        spans, kept = [], []
        t0 = now()
        while True:
            timings = {}
            out_dir = engine.test(opt, timings=timings)
            spans.append(timings)
            v = int(rng.integers(n_views))
            with open(os.path.join(out_dir, f"{v}-fine-ori.png"), "rb") as f:
                kept.append((v, f.read()))
            shutil.rmtree(out_dir)
            if now() - t0 >= seconds:
                break
        sync(device)
        window_s = now() - t0
        peak = memory_peak(device)
        views = sum(s["views"] for s in spans)
        ph.done(f"window ({len(spans)} calls)")

        ctx = {"kind": "test", "arch": arch, "rays_per_unit": w * h,
               "units": views, "window_s": window_s, "spans": spans}
        if trace:
            box = [n_views]
            with tracing.record(box) as got:
                shutil.rmtree(engine.test(opt))
                sync(device)
            ctx["trace"] = got[0]
            ph.done("trace")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    free(device)

    ref.strict_f32()
    mae, gt_bad = 0.0, 0
    for k in pick(seed, len(kept), traffic["check_views"], 5):
        v, blob = kept[k]
        strip = png.decode(blob)
        if strip.shape != (h, 3 * w, 3):
            raise ValueError(f"strip of view {v}: {strip.shape}, expected "
                             f"{(h, 3 * w, 3)}")
        want = reference_image(wts, c2ws[v], arch, config, device)
        mae = max(mae, image_mae(strip[:, :w], want))
        gt = (np.clip((imgs[v].astype(np.float32) / 255.0) / (1.0 + 1e-12),
                      0, 1) * 255).astype(np.uint8)
        gt_bad += int(np.count_nonzero(strip[:, w:2 * w] != gt))
    ph.done("check")
    checks = [("rgb_mae", mae, cell.limits["rgb_mae"]),
              ("gt_bytes_differ", float(gt_bad),
               cell.limits["gt_bytes_differ"])]
    return Result({"test_image_ms": window_s / views * 1e3}, ctx, checks,
                  len(spans), 0, peak, window_start)
