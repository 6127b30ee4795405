"""Learning-rate schedules.

Port of ``nerfsr_tpu/utils/schedule.py:make_lr_schedule``: the LR steps
once per epoch, with the epoch derived from the global step as
``step // steps_per_epoch``. The optimizer holds its learning rate as a
0-d tensor on the parameters' device (``utils/optim.py``):
``write_lr`` writes ``lr(step)`` into it in place before a step, or before
a chunk of captured steps, since the value only moves at an epoch's end.
"""

from __future__ import annotations

import math

import torch


def make_lr_schedule(opt, steps_per_epoch: int):
    """Return ``lr(step)``.

    policies (evaluated at integer epoch e):
      linear: lr * (1-t) + lr_final * t,
              t = max(0, e+1-n_epochs+n_epochs_decay)/(n_epochs_decay+1)
      exp:    exp(log(lr)*(1-t) + log(lr_final)*t)
      step:   lr * gamma^(e // lr_decay_epochs)
    """
    lr0 = opt.lr
    policy = opt.lr_policy

    def t_of_epoch(e):
        return max(
            0.0, e + 1 - opt.n_epochs + opt.n_epochs_decay
        ) / float(opt.n_epochs_decay + 1)

    def lr_fn(step: int) -> float:
        e = int(step) // max(1, steps_per_epoch)
        if policy == "linear":
            t = t_of_epoch(e)
            return lr0 * (1 - t) + opt.lr_final * t
        if policy == "exp":
            t = t_of_epoch(e)
            return math.exp(
                math.log(lr0) * (1 - t) + math.log(opt.lr_final) * t)
        if policy == "step":
            return lr0 * (opt.lr_decay_gamma ** (e // opt.lr_decay_epochs))
        raise NotImplementedError(f"lr policy {policy}")

    return lr_fn


def write_lr(optimizer, lr_fn, step: int) -> float:
    """Write ``lr_fn(step)`` into every param group's learning rate: in
    place into a tensor (the value a captured graph reads at its next
    replay), or as the float a caller put there. Returns the value."""
    value = lr_fn(step)
    for group in optimizer.param_groups:
        if isinstance(group["lr"], torch.Tensor):
            group["lr"].fill_(value)
        else:
            group["lr"] = value
    return value


def lr_writer(optimizer, lr_fn, start: int):
    """``before(i)`` for the steps of a chunk that starts at global step
    ``start``: writes ``lr_fn(start + i)`` (``write_lr``) where it differs
    from the value written last, so at the chunk's start and where the
    chunk crosses an epoch's end, between the steps, never inside one."""
    last = [None]

    def before(i):
        if lr_fn(start + i) != last[0]:
            last[0] = write_lr(optimizer, lr_fn, start + i)
    return before
