"""The ``train`` cells: the engine's training chunk, repeated.

Set-up makes the scene and the weights from the seed, builds the system
and its device buffer of the training views (``LLFFDownXTrainViews``),
and creates the training state with the benchmark's weights; the rest
is the flow that every training cell shares (``drivers/chunks.py``): one
captured step, the state back at the seed, ``check_steps`` replayed
steps, the window of ``chunk_steps``-step chunks, each followed by its
loss read.

The check follows those steps with the reference, on the same rows and
draws: each step's loss, each step's gradient as Adam got it, and each
leaf's change after the last step.
"""

from __future__ import annotations

import numpy as np

from nerfbench import inputs
from nerfbench.drivers import (arch_of, chunk_seed, leaf_norms,
                               program_options, sync, worst_leaf_gap)
from nerfbench.drivers import chunks
from nerfbench.reference import nerf as ref
from nerfbench.reference.lanczos import lanczos_downscale


def load(cell, seed: int, device, ph) -> chunks.Loaded:
    from nerfsr_torch.data.views import LLFFDownXTrainViews
    from nerfsr_torch.models import create_model

    config, traffic, limits = cell.config, cell.traffic, cell.limits
    arch = arch_of(config)
    w, h = arch["img_wh"]
    ds, batch = arch["downscale"], arch["batch_size"]
    scene = traffic["scene"]
    c2ws = inputs.poses(seed, traffic["views"], scene)
    imgs = inputs.render_images(c2ws, (h, w), config["focal"], seed, scene,
                                device)
    wts = inputs.weights(seed, arch, device)
    sync(device)
    ph.done("inputs")

    opt = program_options(config, "train", device)
    system = create_model(opt, device=device)
    views = LLFFDownXTrainViews(c2ws, imgs, config["focal"], (w, h), ds,
                                ds_method=opt.ds_method)
    buffer = views.ray_buffer(device, include_var=opt.include_var)
    steps_per_epoch = max(1, buffer["rgbs"].shape[0] // batch)
    state = system.create_state(seed=0, steps_per_epoch=steps_per_epoch)
    inputs.load_into(state.params, wts)
    ph.done("system and buffer")

    def check(losses, grads, after, _stats):
        return compare(wts, c2ws, imgs, arch, config, seed, steps_per_epoch,
                       losses, grads, after, limits, device)
    return chunks.Loaded(
        system, state, buffer, state.params, wts, {}, opt.beta1, check,
        {"kind": "train", "arch": arch}, "rays", batch * ds * ds)


def run(cell, seed: int, seconds: float, trace: bool, device):
    return chunks.run(cell, seed, seconds, trace, device, load)


def reference_steps(wts, c2ws, imgs, arch, config, seed, steps_per_epoch,
                    n_steps, device, precision="f32"):
    """The reference's first ``n_steps`` steps from the benchmark's
    inputs: (losses, each step's gradient by leaf, leaves after)."""
    ref.strict_f32()
    lr_imgs = np.stack([lanczos_downscale(im, arch["downscale"])
                        for im in imgs])
    data = ref.TrainData(c2ws, imgs, lr_imgs, config["focal"],
                         arch["downscale"], device)
    seeds = [chunk_seed(seed, s) for s in range(n_steps)]
    losses, grad, after = ref.train_steps(
        wts, data, arch, seeds, arch["batch_size"], steps_per_epoch,
        arch["lr"], precision)
    return losses, grad, after


def gaps(wts, losses, grads, after, r_losses, r_grads, r_after) -> dict:
    """The numbers of a train cell, from each step's loss and gradient
    and the leaves after the steps: ``loss_gap``, the worst step's
    relative loss gap; ``grad_gap``, the worst leaf's gap between the two
    first gradients' norms; ``grad_diff``, the worst leaf's norm of the
    difference of the two first gradients; ``later_grad_diff``, the same
    of the later steps' gradients (a reading: from step 2 on the two
    sides start from weights that rounding has already parted);
    ``change_gap``, as ``grad_gap`` for each leaf's change over the steps
    (leaves whose first reference gradient is under a thousandth of the
    median leaf's left out: Adam moves them by round-off alone). A leaf
    gap is over the larger of that leaf's and the median leaf's reference
    norm. A leaf the system does not report reads 0."""
    diffs = []
    for grad, r_grad in zip(grads, r_grads):
        r_norms = leaf_norms(r_grad)
        med = float(np.median(list(r_norms.values())))
        diff = leaf_norms({k: grad[k].to(g.device) - g if k in grad else g
                           for k, g in r_grad.items()})
        diffs.append(max(v / max(r_norms[k], med, 1e-30)
                         for k, v in diff.items()))
    r_norms = leaf_norms(r_grads[0])
    med = float(np.median(list(r_norms.values())))
    keep = {k for k, v in r_norms.items() if v >= 1e-3 * med}
    change = leaf_norms({k: after[k].to(wts[k].device) - wts[k]
                         for k in wts})
    r_change = leaf_norms({k: r_after[k] - wts[k] for k in wts})
    return {"loss_gap": max(abs(a - b) / max(abs(b), 1e-30)
                            for a, b in zip(losses, r_losses)),
            "grad_gap": worst_leaf_gap(leaf_norms(grads[0]), r_norms),
            "later_grad_diff": max(diffs[1:], default=0.0),
            "change_gap": worst_leaf_gap(change, r_change, keep),
            "grad_diff": diffs[0]}


def compare(wts, c2ws, imgs, arch, config, seed, steps_per_epoch, losses,
            grads, after, limits, device):
    """Every number with its limit from the cell's limits file, or None
    where it holds none (a reading, compared with nothing)."""
    r = reference_steps(wts, c2ws, imgs, arch, config, seed,
                        steps_per_epoch, len(losses), device)
    return [(name, v, limits.get(name)) for name, v in
            gaps(wts, losses, grads, after, *r).items()]
