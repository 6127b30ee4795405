"""The ``train_refine`` cells: the refine engine's training chunk,
repeated.

Set-up makes the reference view, its synthesis and the U-Net's leaves
from the seed (``nerfbench/refine_inputs.py``), writes the view as a
COLMAP capture and the synthesis as ``{ref_idx}-fine-ori.png`` under the
run's temporary directory, and reads them through the system's own
loader, ``LLFFRefineDataset`` in mode ``train`` (``--dataset_mode
llff_refine``: ``aug_num`` - 1 perspective warps of both, drawn from
``--seed``, each with its valid box), whose stacks go to the card by the
system's ``upload_buffers``; the directory is removed once read. As
``engine.train_refine`` does, cuDNN runs its deterministic algorithms,
and the convolutions run as the configuration states (TF32, torch's
default). The rest is the flow every training cell shares
(``drivers/chunks.py``): one captured step, the state (the leaves, batch
norm's running statistics, Adam's) back at the seed, ``check_steps``
replayed steps, the window of ``chunk_steps``-step chunks, each followed
by its loss read.

The check follows the checked steps with the reference
(``reference/refine.py``), which warps the views and cuts the patches
itself from the same seed and draws: ``drivers/train.py``'s numbers, and
of batch norm's running statistics after the first step and after the
last, the worst statistic's norm of the difference of the two sides'
moves over the larger of its and the median statistic's move in the
reference (``numbers``).
"""

from __future__ import annotations

import os
import shutil
import statistics
import tempfile

import torch

from nerfbench import drivers, inputs, png, refine_inputs
from nerfbench.drivers import chunk_seed, chunks, leaf_norms, sync
from nerfbench.drivers.train import gaps
from nerfbench.reference import refine as rref

# the sizes the reference and the arithmetic read, each also an option of
# the system, which must hold the value the configuration states
ARCH_KEYS = ("img_wh", "batch_size", "patch_len", "num_ref_patches",
             "ref_offset", "ref_idx", "aug_num", "distort_scale", "data_num",
             "input_nc", "output_nc", "ngf", "num_downs", "norm",
             "learn_residual", "lambda_refine_l1", "lr", "lr_final",
             "n_epochs", "n_epochs_decay", "beta1")


def arch_of(config: dict) -> dict:
    return drivers.arch_of(config, ARCH_KEYS)


def system_seed(seed: int) -> int:
    """The system's ``--seed`` (its augmentations' ``RandomState``), as
    the engine masks a seed for its chunks."""
    return int(seed) & 0x7FFFFFFF


def options(config: dict, device, **extra):
    """The system's options for the configuration, checked key by key."""
    return drivers.program_options(config, "train", device, ARCH_KEYS,
                                   **extra)


def load_buffers(cell, seed: int, c2ws, imgs, sr, device):
    """The capture and the synthesis written and read back by the
    system's loader: (options, system, the device stacks, steps an
    epoch)."""
    from nerfsr_torch.data import create_dataset
    from nerfsr_torch.data.synthetic import write_llff_scene
    from nerfsr_torch.models import create_model

    config = cell.config
    work = tempfile.mkdtemp(prefix="nerfbench_")
    try:
        scene_dir, syn = os.path.join(work, "scene"), os.path.join(work,
                                                                   "syn")
        write_llff_scene(scene_dir, c2ws, imgs, cell.traffic["focal"],
                         inputs.scene_points(seed, cell.traffic["scene"]),
                         save=png.write)
        os.makedirs(syn)
        png.write(os.path.join(syn, f"{config['ref_idx']}-fine-ori.png"), sr)
        opt = options(config, device, dataset_root=scene_dir,
                      syn_dataroot=syn, seed=system_seed(seed))
        dataset = create_dataset(opt, "train")
        system = create_model(opt, device=device)
        buffers = system.upload_buffers(dataset.device_buffers())
        steps_per_epoch = max(1, len(dataset) // opt.batch_size)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return opt, system, buffers, steps_per_epoch


def load_state(net, wts, stats):
    """The benchmark's leaves and running statistics into the U-Net, name
    for name; every leaf and statistic of the module must be given."""
    given = set(wts) | set(stats)
    if set(net.state_dict()) != given:
        raise KeyError(f"the system's leaves "
                       f"{sorted(set(net.state_dict()) ^ given)} differ "
                       "from the benchmark's")
    with torch.no_grad():
        for k, p in net.named_parameters():
            p.copy_(wts[k])
        for k, b in net.named_buffers():
            b.copy_(stats[k])


def load(cell, seed: int, device, ph) -> chunks.Loaded:
    from nerfsr_torch import engine

    config, limits = cell.config, cell.limits
    arch = arch_of(config)
    c2ws, imgs, sr = refine_inputs.views(cell, seed, device)
    wts, stats = refine_inputs.weights(seed, arch, device)
    sync(device)
    ph.done("inputs")

    if torch.device(device).type == "cuda":
        engine._deterministic_cudnn()
        torch.backends.cudnn.allow_tf32 = True
    opt, system, buffers, steps_per_epoch = load_buffers(
        cell, seed, c2ws, imgs, sr, device)
    ph.done("scene written and read")
    state = system.create_state(seed=0, steps_per_epoch=steps_per_epoch)
    load_state(state.net, wts, stats)
    ph.done("system")
    gt = imgs[config["ref_idx"]]

    def check(losses, grads, after, moved):
        r = reference_steps(wts, stats, gt, sr, arch, seed, steps_per_epoch,
                            len(losses), device)
        return [(name, v, limits.get(name)) for name, v in
                numbers(wts, stats, losses, grads, after, moved,
                        *r).items()]
    return chunks.Loaded(
        system, state, buffers, state.net, wts, stats, opt.beta1, check,
        {"kind": "train_refine", "arch": arch}, "patches",
        arch["batch_size"])


def run(cell, seed: int, seconds: float, trace: bool, device):
    return chunks.run(cell, seed, seconds, trace, device, load)


def reference_steps(wts, stats, gt, sr, arch, seed, steps_per_epoch,
                    n_steps, device, precision="f32"):
    """The reference's first ``n_steps`` steps from the benchmark's
    inputs: (losses, each step's gradient by leaf, leaves after, running
    statistics after each step)."""
    views = rref.Views(gt, sr, arch, system_seed(seed))
    seeds = [chunk_seed(seed, s) for s in range(n_steps)]
    return rref.train_steps(wts, stats, views, arch, seeds, steps_per_epoch,
                            device, precision)


def numbers(wts, stats, losses, grads, after, moved, r_losses, r_grads,
            r_after, r_moved) -> dict:
    """``drivers/train.py``'s numbers (``gaps``), and of batch norm's
    running statistics after the first step and after the last
    (``moved``: each step's), ``first_stats_diff`` and ``stats_diff``:
    the worst statistic's norm of the difference between the system's
    move and the reference's, over the larger of that statistic's and the
    median statistic's move in the reference (a statistic left where it
    started reads 1 or less, the largest 1)."""
    out = gaps(wts, losses, grads, after, r_losses, r_grads, r_after)

    def diff(got, want):
        step = leaf_norms({k: want[k] - stats[k] for k in stats})
        med = statistics.median(step.values())
        gap = leaf_norms({k: (got[k].to(stats[k].device) - stats[k])
                          - (want[k] - stats[k]) for k in stats})
        return max(gap[k] / max(step[k], med, 1e-30) for k in stats)
    out["first_stats_diff"] = diff(moved[0], r_moved[0])
    out["stats_diff"] = diff(moved[-1], r_moved[-1])
    return out
