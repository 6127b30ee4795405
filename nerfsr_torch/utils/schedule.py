"""Learning-rate schedules.

Port of ``nerfsr_tpu/utils/schedule.py:make_lr_schedule``: the LR steps
once per epoch, with the epoch derived from the global step as
``step // steps_per_epoch``.
"""

from __future__ import annotations

import math


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
