"""The Blender ``train`` cells: the engine's training chunk on a 360-degree
scene, repeated.

Set-up makes the scene and the weights from the seed
(``nerfbench/scene360.py``), writes the views as a nerf_synthetic
directory under the run's temporary directory, and reads it through the
system's own loader, ``BlenderDownXDataset`` in mode ``train``
(``--dataset_mode blender_downX``): its ``ray_buffer`` (world rays, the
constant near and far bounds, the LR truth blended over white) goes to
the card one field at a time, as the engine takes it there. The
directory is removed once read. The ``train_crop`` warm-up, which draws
a run's first 1000 steps from the views' centre crops, is left out: the
window is the run's steady state, past the warm-up.

The rest is the flow every training cell shares (``drivers/chunks.py``):
one captured step, the state back at the seed, ``check_steps`` replayed
steps, the window of ``chunk_steps``-step chunks, each followed by its
loss read. The check follows the checked steps with the Blender
reference (``reference/blender.py``) on the same rows and draws, and
adds one number of the first gradient to ``drivers/train.py``'s
(``numbers``).
"""

from __future__ import annotations

import shutil
import statistics
import tempfile

import numpy as np
import torch

from nerfbench import inputs, scene360
from nerfbench.drivers import (arch_of, chunk_seed, leaf_norms,
                               program_options, sync)
from nerfbench.drivers import chunks
from nerfbench.drivers.train import gaps
from nerfbench.reference import blender as bref
from nerfbench.reference import nerf as ref


def scene_inputs(cell, seed: int, device):
    """(c2ws (n, 3, 4), RGBA images (n, h, w, 4) uint8, weights: as
    ``inputs.weights`` draws them, each density head's bias then lowered
    to leave ``scene360.EMPTY_SHARE`` of the space empty,
    ``scene360.empty_space``)."""
    config, scene = cell.config, cell.traffic["scene"]
    arch = arch_of(config)
    w, h = arch["img_wh"]
    c2ws = scene360.poses(seed, cell.traffic["views"], scene)
    rgba = scene360.render_rgba(c2ws, (h, w), config["focal"],
                                config["near"], config["far"], seed, scene,
                                device)
    wts = inputs.weights(seed, arch, device)
    return c2ws, rgba, scene360.empty_space(wts, arch, seed, device)


def _options(config, device, root):
    """The system's options, with what ``program_options`` does not hold
    checked here: the white background and a constant resample pad."""
    opt = program_options(config, "train", device, dataset_root=root)
    got = (opt.white_bkgd, opt.prop_pad_anneal)
    if got != (True, 0):
        raise ValueError(f"the system runs white_bkgd, prop_pad_anneal = "
                         f"{got} where the configuration states (True, 0)")
    return opt


def load_buffer(config, c2ws, rgba, device):
    """The scene written as nerf_synthetic and read back by the system's
    loader: (options, the ray buffer on ``device``)."""
    from nerfsr_torch.data import create_dataset

    work = tempfile.mkdtemp(prefix="nerfbench_")
    try:
        scene360.write_scene(work, c2ws, rgba, config["focal"])
        opt = _options(config, device, work)
        ds = create_dataset(opt, "train")
        if tuple(ds.depth_bounds) != (config["near"], config["far"]):
            raise ValueError(f"the loader's bounds {ds.depth_bounds} differ "
                             f"from the configuration's")
        buffer = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                  for k, v in ds.ray_buffer().items()}
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return opt, buffer


def load(cell, seed: int, device, ph) -> chunks.Loaded:
    from nerfsr_torch.models import create_model

    config, limits = cell.config, cell.limits
    arch = arch_of(config)
    batch, ds = arch["batch_size"], arch["downscale"]
    c2ws, rgba, wts = scene_inputs(cell, seed, device)
    sync(device)
    ph.done("inputs")

    opt, buffer = load_buffer(config, c2ws, rgba, device)
    ph.done("scene written and read")
    system = create_model(opt, device=device)
    steps_per_epoch = max(1, buffer["rgbs"].shape[0] // batch)
    state = system.create_state(seed=0, steps_per_epoch=steps_per_epoch)
    inputs.load_into(state.params, wts)
    ph.done("system")

    def check(losses, grads, after, _stats):
        r = reference_steps(wts, c2ws, rgba, arch, config, seed,
                            steps_per_epoch, len(losses), device)
        return [(name, v, limits.get(name)) for name, v in
                numbers(wts, losses, grads, after, *r).items()]
    return chunks.Loaded(
        system, state, buffer, state.params, wts, {}, opt.beta1, check,
        {"kind": "train", "arch": arch}, "rays", batch * ds * ds)


def run(cell, seed: int, seconds: float, trace: bool, device):
    return chunks.run(cell, seed, seconds, trace, device, load)


def numbers(wts, losses, grads, after, r_losses, r_grads, r_after) -> dict:
    """``drivers/train.py``'s numbers (``gaps``) and ``grad_diff_body``:
    ``grad_diff``, the worst leaf's norm of the two first gradients'
    difference over the larger of that leaf's and the median leaf's
    reference norm, taken over every leaf but the density heads
    (``density_head``). A head's gradient takes a sample only where its
    density is positive, and near 0 bf16 and f32 put samples on relu's
    two sides, so the heads' gap swings from seed to seed in sound runs
    as far as the control's: ``grad_diff``, which they set, is a reading
    here."""
    out = gaps(wts, losses, grads, after, r_losses, r_grads, r_after)
    norms = leaf_norms(r_grads[0])
    med = statistics.median(norms.values())
    body = {k: g for k, g in r_grads[0].items() if not density_head(g)}
    diff = leaf_norms({k: grads[0][k].to(g.device) - g if k in grads[0]
                       else g for k, g in body.items()})
    out["grad_diff_body"] = max(diff[k] / max(norms[k], med, 1e-30)
                                for k in body)
    return out


def density_head(leaf: torch.Tensor) -> bool:
    """Whether a leaf (a weight or a bias, output rows first) belongs to a
    layer with one output: the NeRF MLP's and the proposal MLP's density
    heads."""
    return leaf.shape[0] == 1


def reference_steps(wts, c2ws, rgba, arch, config, seed, steps_per_epoch,
                    n_steps, device, precision="f32"):
    """The Blender reference's first ``n_steps`` steps from the
    benchmark's inputs: (losses, each step's gradient by leaf, leaves
    after)."""
    ref.strict_f32()
    data = bref.TrainData(c2ws, rgba, config["focal"], arch["downscale"],
                          config["near"], config["far"], device)
    seeds = [chunk_seed(seed, s) for s in range(n_steps)]
    return bref.train_steps(wts, data, arch, seeds, arch["batch_size"],
                            steps_per_epoch, arch["lr"], precision)
