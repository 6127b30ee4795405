"""The flow every training cell shares, whatever its model and data: the
window's own call, the system's ``train_steps_scan``, driven in chunks.

A cell's driver hands ``run`` a loader, which makes the cell's inputs
from the seed, builds the system, its training state with the
benchmark's leaves and the device buffer its chunks draw from
(``Loaded``), and says how its check is made. The flow is then the same
for each: ``train_steps_scan`` runs one step (the first call of a step
runs eagerly and captures the step's CUDA graph); the same state goes
back to the seed in place (``restart``: the graph holds its tensors: the
leaves, the module's buffers, Adam's moments and counts) and runs its
first ``check_steps`` steps, one step a chunk, each chunk seeded from
(seed, step) as the engine seeds it: each a replay of the graph that the
window replays. The same state then runs the window: chunks of
``chunk_steps`` steps, each followed by the engine's one read of the
chunk's losses, until ``seconds`` have passed; the window ends in that
read, which waits for the card. A traced run profiles ``traced_chunks``
more chunks. The system is then freed and the loader's check follows
the checked steps with the reference: each step's loss, each step's
gradient as Adam got it (from its first moments after that step and the
one before: ``g_t = (m_t - beta1 m_{t-1}) / (1 - beta1)``) and the
module's buffers after it, and each leaf after the last step.
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Callable, Dict

import torch

from nerfbench import trace as tracing
from nerfbench.drivers import (Phases, Result, by_thirds, chunk_seed, free,
                               memory_peak, now, sync)


@dataclasses.dataclass
class Loaded:
    """What a cell's loader hands the flow. ``net`` is the module whose
    leaves the benchmark set (``wts``, by name) and whose buffers start
    from ``stats`` (none where it has none); ``check(losses, grads,
    after, stats)`` (each checked step's loss, gradient and buffers, and
    the leaves after the last) gives every number with its limit or None;
    ``ctx`` is what the per-layer readers read besides the window's
    counts (``kind`` and ``arch``); a step trains ``per_step`` of
    ``unit`` (``rays``, ``patches``), which names the end-to-end rate,
    ``train_<unit>_per_s``, and the readers' ``<unit>_per_unit``."""

    system: object
    state: object
    buffer: dict
    net: torch.nn.Module
    wts: Dict[str, torch.Tensor]
    stats: Dict[str, torch.Tensor]
    beta1: float
    check: Callable
    ctx: dict
    unit: str
    per_step: int


def _read(losses):
    """The engine's read of a chunk's losses: all of them, once."""
    return torch.stack([v.float() for v in losses.values()]).cpu().tolist()


def restart(state, net, wts, stats):
    """Put the state back at the seed, in place: the benchmark's leaves
    and buffers, Adam's moments and step counts at 0, the step count at
    0."""
    with torch.no_grad():
        for k, p in net.named_parameters():
            p.copy_(wts[k])
        for k, b in net.named_buffers():
            b.copy_(stats[k])
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


def run(cell, seed: int, seconds: float, trace: bool, device,
        load: Callable) -> Result:
    """Drive the cell: ``load(cell, seed, device, phases)`` gives the
    ``Loaded`` system (and marks its own set-up phases)."""
    traffic = cell.traffic
    ph = Phases()
    got = load(cell, seed, device, ph)
    system, state, buffer = got.system, got.state, got.buffer
    gen = torch.Generator(device=device)
    names = {id(p): k for k, p in got.net.named_parameters()}

    gen.manual_seed(chunk_seed(seed, state.step))
    state, _ = system.train_steps_scan(state, buffer, 1, gen)
    restart(state, got.net, got.wts, got.stats)
    losses, grads, stats, moment = [], [], [], None
    for _ in range(traffic["check_steps"]):
        gen.manual_seed(chunk_seed(seed, state.step))
        state, out = system.train_steps_scan(state, buffer, 1, gen)
        losses.append(float(out["tot"]))
        m = {names[id(p)]: st["exp_avg"].detach().clone()
             for p, st in state.optimizer.state.items()}
        grads.append(step_grad(m, moment, got.beta1))
        stats.append({k: b.detach().clone()
                      for k, b in got.net.named_buffers()})
        moment = m
    del moment
    after = {k: p.detach().clone() for k, p in got.net.named_parameters()}
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

    print(f"[nerfbench] {got.unit}/s by thirds of the window: " + " ".join(
        f"{chunk * got.per_step / s:.1f}" for s in by_thirds(t0, ends)),
        file=sys.stderr)
    ctx = dict(got.ctx, units=steps, window_s=window_s)
    ctx[f"{got.unit}_per_unit"] = got.per_step
    if trace:
        n = traffic["traced_chunks"]
        box = [n * chunk]
        with tracing.record(box) as rec:
            for _ in range(n):
                gen.manual_seed(chunk_seed(seed, state.step))
                state, out = system.train_steps_scan(state, buffer, chunk,
                                                     gen)
                _read(out)
            sync(device)
        ctx["trace"] = rec[0]
        ph.done("trace")

    check = got.check
    rate = {f"train_{got.unit}_per_s": steps * got.per_step / window_s}
    got.system = got.state = got.buffer = got.net = None
    del got, system, state, buffer, gen, out
    free(device)
    checks = check(losses, grads, after, stats)
    ph.done("check")
    return Result(rate, ctx, checks, steps, 0, peak, window_start)
