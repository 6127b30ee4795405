"""The ``train`` cells: the engine's training chunk, repeated.

Set-up makes the scene and the weights from the seed, builds the system
and its device buffer of the training views (``LLFFDownXTrainViews``),
creates the training state with the benchmark's weights, and calls the
window's own call, ``train_steps_scan``, for one step: the first call of
a step runs eagerly and captures the step's CUDA graph. It puts that same
state back at the seed in place (the graph holds its tensors: the
weights, Adam's moments and counts) and drives it through its first
``check_steps`` steps, one step a chunk, each chunk seeded from (seed,
step) as the engine seeds it: each a replay of the graph that the window
replays. The same state then runs the window: chunks of ``chunk_steps``
steps, each followed by the engine's one read of the chunk's losses,
until ``seconds`` have passed; the window ends in that read, which waits
for the card.

The check follows those steps with the reference, on the same rows and
draws: each step's loss, each step's gradient as Adam got it (from its
first moments after that step and the one before: ``g_t = (m_t - beta1
m_{t-1}) / (1 - beta1)``), and each leaf's change after the last step.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from nerfbench import inputs
from nerfbench import trace as tracing
from nerfbench.drivers import (Phases, Result, arch_of, by_thirds,
                               chunk_seed, free, leaf_norms, memory_peak, now,
                               program_options, sync, worst_leaf_gap)
from nerfbench.reference import nerf as ref
from nerfbench.reference.lanczos import lanczos_downscale


def _read(losses):
    """The engine's read of a chunk's losses: all of them, once."""
    return torch.stack([v.float() for v in losses.values()]).cpu().tolist()


def run(cell, seed: int, seconds: float, trace: bool, device) -> Result:
    from nerfsr_torch.data.views import LLFFDownXTrainViews
    from nerfsr_torch.models import create_model

    config, traffic, limits = cell.config, cell.traffic, cell.limits
    ph = Phases()
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
    gen = torch.Generator(device=device)
    names = {id(p): k for k, p in state.params.named_parameters()}

    gen.manual_seed(chunk_seed(seed, state.step))
    state, _ = system.train_steps_scan(state, buffer, 1, gen)
    restart(state, wts)
    losses, grads, moment = [], [], None
    for _ in range(traffic["check_steps"]):
        gen.manual_seed(chunk_seed(seed, state.step))
        state, out = system.train_steps_scan(state, buffer, 1, gen)
        losses.append(float(out["tot"]))
        m = {names[id(p)]: st["exp_avg"].detach().clone()
             for p, st in state.optimizer.state.items()}
        grads.append(step_grad(m, moment, opt.beta1))
        moment = m
    del moment
    after = {k: p.detach().clone()
             for k, p in state.params.named_parameters()}
    sync(device)
    ph.done("first steps")
    window_start = now()

    chunk = traffic["chunk_steps"]
    steps, t0, ends = 0, now(), []
    while True:
        gen.manual_seed(chunk_seed(seed, state.step))
        state, out = system.train_steps_scan(state, buffer, chunk, gen)
        _read(out)
        steps += chunk
        ends.append(now())
        if ends[-1] - t0 >= seconds:
            break
    sync(device)
    window_s = now() - t0
    peak = memory_peak(device)
    ph.done(f"window ({steps} steps)")

    rays_per_step = batch * ds * ds
    print("[nerfbench] rays/s by thirds of the window: " + " ".join(
        f"{chunk * rays_per_step / s:.1f}" for s in by_thirds(t0, ends)),
        file=sys.stderr)
    ctx = {"kind": "train", "arch": arch, "rays_per_unit": rays_per_step,
           "units": steps, "window_s": window_s}
    if trace:
        n = traffic["traced_chunks"]
        box = [n * chunk]
        with tracing.record(box) as got:
            for _ in range(n):
                gen.manual_seed(chunk_seed(seed, state.step))
                state, out = system.train_steps_scan(state, buffer, chunk,
                                                     gen)
                _read(out)
            sync(device)
        ctx["trace"] = got[0]
        ph.done("trace")

    del system, state, buffer, views, gen
    free(device)
    checks = compare(wts, c2ws, imgs, arch, config, seed, steps_per_epoch,
                     losses, grads, after, limits, device)
    ph.done("check")
    return Result({"train_rays_per_s": steps * rays_per_step / window_s},
                  ctx, checks, steps, 0, peak, window_start)


def restart(state, wts):
    """Put the state back at the seed, in place: the benchmark's weights,
    Adam's moments and step counts at 0, the step count at 0."""
    inputs.load_into(state.params, wts)
    with torch.no_grad():
        for st in state.optimizer.state.values():
            for t in st.values():
                t.zero_()
    state.step = 0


def step_grad(m: dict, m_prev, beta1: float) -> dict:
    """A step's gradient as Adam got it, from its first moment after the
    step (``m``) and before it (``m_prev``; None before the first)."""
    if m_prev is None:
        return {k: v / (1.0 - beta1) for k, v in m.items()}
    return {k: (v - beta1 * m_prev[k]) / (1.0 - beta1)
            for k, v in m.items()}


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
