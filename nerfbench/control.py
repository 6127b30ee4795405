"""The readings that a cell's limits are set from: the system's on many
seeds, and the control's and each fault's on a few.

    python3 -m nerfbench.control --workload <cell> --seeds 1 2 3
        [--system 4 5 ... 15] [--seconds 1] [--out chiprun_out/x.jsonl]

``--system`` seeds run the whole cell (a short window, then the check)
in this one process and report the numbers compared. ``--seeds`` read,
in place of the system, the control, the reference computed a precision
below the configuration's (its ``control``: every product's operands in
float8 e4m3 under bf16's ``mixed``, the default, or in bfloat16 under
float32 or TF32), and each fault the cell can have, planted in the
reference: for a train cell half of the batch left out (the mean over
the rest) and one leaf's gradient doubled, the first leaf in an LLFF
cell, in a Blender cell the first outside the density heads whose norm
is at least the median leaf's, in a refine cell the first whose norm is
at least the median leaf's, and in a refine cell too batch norm's
running statistics left where they were (a state left unchanged reads 1
by the change's measure and needs no run); for a render or test cell an
eighth of an image's pixels moved by 64 levels (one bit flipped) and
half of them left black.
Needs a CUDA card; the benchmark's own runs do not run it.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import torch

from nerfbench import inputs, refine_inputs, run, spec
from nerfbench.drivers import arch_of, image_mae, pick
from nerfbench.drivers import train as train_driver
from nerfbench.drivers import train_blender, train_refine
from nerfbench.drivers.render import reference_image, spiral_views
from nerfbench.reference import blender as bref
from nerfbench.reference import nerf as ref
from nerfbench.reference import refine as rref

# the faults planted in each kind of train cell; a Blender cell doubles
# the gradient of a leaf that its compared numbers see whole (its first
# leaf, the proposal MLP's first weight, has 0.07-0.48 of the median
# leaf's norm, and a gap is read over the larger of the two)
TRAIN_FAULTS = {"train": ("half_batch", "doubled_leaf"),
                "train_blender": ("half_batch", "doubled_body_leaf"),
                "train_refine": ("half_batch", "doubled_median_leaf",
                                 "stats_unmoved")}
TRAIN_KINDS = tuple(TRAIN_FAULTS)


class _Planted:
    """A fault planted in the reference for the length of a ``with``."""

    def __init__(self, fault: str):
        self.fault, self.undo = fault, []

    def __enter__(self):
        if self.fault == "half_batch":
            for data_class in (ref.TrainData, bref.TrainData):
                self._half_rows(data_class)
            patches = rref.patches
            self._patch(rref, "patches", lambda views, u, arch: patches(
                views, u[:len(u) // 2], arch))
        elif self.fault == "doubled_leaf":
            self._double(lambda grads: next(iter(grads)))
        elif self.fault == "doubled_body_leaf":
            self._double(_first_body_leaf)
        elif self.fault == "doubled_median_leaf":
            self._double(_first_median_leaf)
        elif self.fault == "stats_unmoved":
            norm = rref.batch_norm

            def unmoved(x, scale, bias, mean, var, moved, name):
                out = norm(x, scale, bias, mean, var, moved, name)
                moved[name + "mean"], moved[name + "var"] = mean, var
                return out
            self._patch(rref, "batch_norm", unmoved)
        return self

    def _double(self, pick):
        step = ref.Adam.step

        def doubled(opt, wts, grads):
            leaf = pick(grads)
            return step(opt, wts, {k: g * 2.0 if k == leaf else g
                                   for k, g in grads.items()})
        self._patch(ref.Adam, "step", doubled)

    def _half_rows(self, data_class):
        rows = data_class.rows
        self._patch(data_class, "rows",
                    lambda data, idx: rows(data, idx[:len(idx) // 2]))

    def _patch(self, obj, name, value):
        self.undo.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    def __exit__(self, *exc):
        for obj, name, value in reversed(self.undo):
            setattr(obj, name, value)


def _first_median_leaf(grads, keep=lambda g: True):
    """The first leaf (that ``keep`` takes) whose gradient's norm is at
    least the median leaf's."""
    norms = {k: float(torch.linalg.vector_norm(g)) for k, g in grads.items()}
    med = statistics.median(norms.values())
    return next(k for k, g in grads.items() if keep(g) and norms[k] >= med)


def _first_body_leaf(grads):
    """The first leaf, outside the density heads, whose gradient's norm is
    at least the median leaf's."""
    return _first_median_leaf(
        grads, lambda g: not train_blender.density_head(g))


def control_precision(cell) -> str:
    """The precision one step below the configuration's."""
    return cell.config.get("control", "fp8")


def train_readings(cell, seed, device, precision="fp8", fault=None):
    """The train numbers of the reference at ``precision`` (with
    ``fault`` planted) read against the f32 reference."""
    if cell.kind == "train_blender":
        return blender_readings(cell, seed, device, precision, fault)
    if cell.kind == "train_refine":
        return refine_readings(cell, seed, device, precision, fault)
    config, traffic = cell.config, cell.traffic
    arch = arch_of(config)
    w, h = arch["img_wh"]
    c2ws = inputs.poses(seed, traffic["views"], traffic["scene"])
    imgs = inputs.render_images(c2ws, (h, w), config["focal"], seed,
                                traffic["scene"], device)
    wts = inputs.weights(seed, arch, device)
    n_rows = traffic["views"] * (h // arch["downscale"]) \
        * (w // arch["downscale"])
    spe = max(1, n_rows // arch["batch_size"])
    args = (wts, c2ws, imgs, arch, config, seed, spe, traffic["check_steps"],
            device)
    with _Planted(fault):
        low = train_driver.reference_steps(*args, precision=precision)
    high = train_driver.reference_steps(*args)
    return train_driver.gaps(wts, *low, *high)


def blender_readings(cell, seed, device, precision="fp8", fault=None):
    """``train_readings`` of a Blender cell, on its scene."""
    arch = arch_of(cell.config)
    c2ws, rgba, wts = train_blender.scene_inputs(cell, seed, device)
    n_rows = len(c2ws) * (rgba.shape[1] // arch["downscale"]) \
        * (rgba.shape[2] // arch["downscale"])
    args = (wts, c2ws, rgba, arch, cell.config, seed,
            max(1, n_rows // arch["batch_size"]),
            cell.traffic["check_steps"], device)
    with _Planted(fault):
        low = train_blender.reference_steps(*args, precision=precision)
    high = train_blender.reference_steps(*args)
    return train_blender.numbers(wts, *low, *high)


def refine_readings(cell, seed, device, precision="bf16", fault=None):
    """``train_readings`` of a refine cell, on its views."""
    arch = train_refine.arch_of(cell.config)
    _, imgs, sr = refine_inputs.views(cell, seed, device)
    wts, stats = refine_inputs.weights(seed, arch, device)
    spe = max(1, arch["data_num"] // arch["batch_size"])
    args = (wts, stats, imgs[arch["ref_idx"]], sr, arch, seed, spe,
            cell.traffic["check_steps"], device)
    with _Planted(fault):
        low = train_refine.reference_steps(*args, precision=precision)
    high = train_refine.reference_steps(*args)
    return train_refine.numbers(wts, stats, *low, *high)


def _checked_poses(cell, seed):
    traffic = cell.traffic
    if cell.kind == "render":
        path = spiral_views(seed, cell)
        return [path[i] for i in pick(seed, len(path),
                                      traffic["check_images"], 3)]
    c2ws = inputs.poses(seed, traffic["views"], traffic["scene"])
    return [c2ws[i] for i in pick(seed, len(c2ws), traffic["check_views"],
                                  5)]


def image_readings(cell, seed, device, precision="fp8"):
    """The image number of the reference at ``precision``, and of the two
    image faults, read against the f32 reference; one dict a reading."""
    arch = arch_of(cell.config)
    wts = inputs.weights(seed, arch, device)
    worst = {"fp8": 0.0, "altered": 0.0, "half_image": 0.0}
    for c2w in _checked_poses(cell, seed):
        high = reference_image(wts, c2w, arch, cell.config, device)
        low = reference_image(wts, c2w, arch, cell.config, device,
                              precision)
        flat = high.reshape(-1, 3).copy()
        n = len(flat)
        altered = flat.copy()
        altered[:n // 8] ^= 64
        half = flat.copy()
        half[n // 2:] = 0
        for k, img in (("fp8", low.reshape(-1, 3)), ("altered", altered),
                       ("half_image", half)):
            worst[k] = max(worst[k], image_mae(img, flat))
    return {k: {"rgb_mae": v} for k, v in worst.items()}


def readings(cell, seed, device):
    """{reading: {number: value}} of the control and the faults."""
    if cell.kind not in TRAIN_KINDS:
        return image_readings(cell, seed, device)
    low = control_precision(cell)
    out = {low: train_readings(cell, seed, device, low)}
    for fault in TRAIN_FAULTS[cell.kind]:
        out[fault] = train_readings(cell, seed, device, "f32", fault)
    return out


def _emit(row, out):
    print(json.dumps(row), flush=True)
    if out:
        with open(out, "a") as f:
            f.write(json.dumps(row) + "\n")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--system", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("nerfbench.control needs a CUDA card", file=sys.stderr)
        return 2
    run.pin_caches()
    device = torch.device("cuda", 0)
    for seed in args.system:
        cell = spec.Cell(args.workload)
        res = cell.driver().run(cell, seed, args.seconds, False, device)
        _emit({"workload": cell.name, "seed": seed, "reading": "system",
               **{name: v for name, v, _ in res.checks},
               "correct": res.correct}, args.out)
    for seed in args.seeds:
        cell = spec.Cell(args.workload)
        t0 = time.perf_counter()
        for name, vals in readings(cell, seed, device).items():
            _emit({"workload": cell.name, "seed": seed, "reading": name,
                   **vals, "fails_limits": any(
                       vals[k] > v for k, v in cell.limits.items()
                       if k in vals),
                   "seconds": time.perf_counter() - t0}, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
