"""Adam whose whole update stays on the parameters' device.

optax's ``scale_by_adam`` followed by the scale by ``-lr`` (b1, b2, eps;
bias-corrected moments), as ``torch.optim.Adam`` computes it, with every
per-step value on the parameters' device: each parameter's step count is
an f64 0-d tensor there, the learning rate an f64 0-d tensor, and the
bias corrections and step size are computed there in f64, where
``torch.optim.Adam`` (without ``capturable``) computes them on the host
from ``step.item()``. Nothing in ``step`` reads a tensor back to the
host or derives a launch argument from one, so the same update runs
eagerly on the CPU, eagerly on the card, and captured in a CUDA graph
(``nerfsr_torch/graphs.py``). The operations and their roundings are
``torch.optim.Adam``'s, so on the CPU it gives that optimizer's bits
(``torch.optim.Adam(capturable=True)`` refuses the CPU and rounds its
bias corrections in f32). The subclass keeps the state layout
(``step``, ``exp_avg``, ``exp_avg_sq`` per parameter; ``lr``, ``betas``,
``eps`` per group) that the checkpoints read and write, and replaces
only ``step``.

The schedule writes the learning rate into the group's tensor in place
(``utils/schedule.py:write_lr``), so a captured graph reads the value of
its replay. A group whose ``lr`` a caller replaced by a float steps at
that float.
"""

from __future__ import annotations

import torch


class Adam(torch.optim.Adam):
    """``torch.optim.Adam`` (no weight decay, no amsgrad) with a device
    learning rate and the capturable update on every device."""

    def __init__(self, params, lr: float, betas=(0.9, 0.999),
                 eps: float = 1e-8, device=None):
        params = list(params)
        if device is None:
            device = params[0].device if params else torch.device("cpu")
        super().__init__(params, lr=torch.tensor(float(lr),
                                                 dtype=torch.float64,
                                                 device=device),
                         betas=betas, eps=eps, foreach=True,
                         capturable=True)

    def state_tensors(self) -> list:
        """Every tensor a step reads or updates in place besides the
        parameters and their gradients: the step counts, the moments and
        the learning rates."""
        return ([t for st in self.state.values() for t in st.values()]
                + [g["lr"] for g in self.param_groups
                   if isinstance(g["lr"], torch.Tensor)])

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("Adam.step takes no closure")
        for group in self.param_groups:
            params, grads, exp_avgs, exp_avg_sqs, steps = [], [], [], [], []
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:      # lazily, as torch.optim.Adam does
                    state["step"] = torch.zeros((), dtype=torch.float64,
                                                device=p.device)
                    state["exp_avg"] = torch.zeros_like(
                        p, memory_format=torch.preserve_format)
                    state["exp_avg_sq"] = torch.zeros_like(
                        p, memory_format=torch.preserve_format)
                params.append(p)
                grads.append(p.grad)
                exp_avgs.append(state["exp_avg"])
                exp_avg_sqs.append(state["exp_avg_sq"])
                steps.append(state["step"])
            if params:
                _adam(params, grads, exp_avgs, exp_avg_sqs, steps,
                      group["lr"], *group["betas"], group["eps"])


def _adam(params, grads, exp_avgs, exp_avg_sqs, steps, lr, beta1, beta2,
          eps):
    """The update of ``torch.optim.adam._multi_tensor_adam`` without
    capture: the bias corrections and the step size in f64, here from the
    f64 step counts on the device where torch takes them on the host, the
    same roundings in the same order, so the CPU gives its bits."""
    torch._foreach_add_(steps, 1)
    torch._foreach_lerp_(exp_avgs, grads, 1 - beta1)
    torch._foreach_mul_(exp_avg_sqs, beta2)
    torch._foreach_addcmul_(exp_avg_sqs, grads, grads, 1 - beta2)
    bias1 = torch._foreach_pow(beta1, steps)       # 1 - b1^t
    torch._foreach_neg_(bias1)
    torch._foreach_add_(bias1, 1)
    bias2 = torch._foreach_pow(beta2, steps)       # sqrt(1 - b2^t)
    torch._foreach_neg_(bias2)
    torch._foreach_add_(bias2, 1)
    torch._foreach_sqrt_(bias2)
    lrs = [lr] * len(steps) if isinstance(lr, torch.Tensor) \
        else [torch.full_like(steps[0], lr)] * len(steps)
    step_size = torch._foreach_div(lrs, bias1)     # -lr / (1 - b1^t)
    torch._foreach_neg_(step_size)
    # each parameter's two f64 scalars rounded to f32 once, as torch
    # rounds a Python scalar against an f32 tensor
    step_size = torch.stack(step_size).to(exp_avgs[0].dtype).unbind()
    bias2 = torch.stack(bias2).to(exp_avgs[0].dtype).unbind()
    denom = torch._foreach_sqrt(exp_avg_sqs)
    torch._foreach_div_(denom, bias2)
    torch._foreach_add_(denom, eps)
    update = torch._foreach_mul(exp_avgs, step_size)
    torch._foreach_div_(update, denom)
    torch._foreach_add_(params, update)
