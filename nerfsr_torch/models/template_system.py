"""The template system: a toy regression (x -> x^2).

Port of ``nerfsr_tpu/models/template_system.py``, the smoke-test scaffold
of the option, training-loop and checkpoint plumbing: ``_TinyMLP``
(``Dense_0`` 1 -> 64, relu, ``Dense_1`` 64 -> 1; flax's default
lecun-normal kernels and zero biases) trained by Adam (b1 ``--beta1``,
b2 0.999, eps 1e-8) at the ``--lr_policy`` schedule, on the mean squared
error of at most 256 rows drawn from the buffer. Both configs default
``--model`` and ``--dataset_mode`` to ``template``, so a command line
without them trains this. The JAX package draws the rows from
``jax.random``; here they come from a ``torch.Generator`` on the
buffer's device, or are injected (``idx``). The engine drives it
(``nerfsr_torch/engine.py:train``); its checkpoint is the JAX
``TrainState``'s (``nerfsr_torch/utils/checkpoint.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional, Tuple

import torch
from torch import nn

from nerfsr_torch.device import resolve_device
from nerfsr_torch.models import register_model
from nerfsr_torch.models.mlp import _DenseStack
from nerfsr_torch.utils.optim import Adam
from nerfsr_torch.utils.schedule import make_lr_schedule, write_lr

# the most rows a step draws from the buffer (the JAX system's cap)
MAX_BATCH = 256


class _TinyMLP(_DenseStack):
    """1 -> 64 -> 1 with a relu between."""

    def __init__(self):
        super().__init__()
        self.compute_dtype = torch.float32
        self.Dense_0 = nn.Linear(1, 64)
        self.Dense_1 = nn.Linear(64, 1)

    def forward(self, x):
        return self._dense("Dense_1", torch.relu(self._dense("Dense_0", x)))

    def leaves(self) -> Iterator[Tuple[str, nn.Parameter, bool]]:
        """(JAX path, parameter, is a kernel) of each leaf, as
        ``weights.param_leaves`` names a NeRF network's: the JAX
        ``TrainState.params`` is flax's ``{"params": {"Dense_0": ...}}``."""
        for name, lin in self.named_children():
            yield f"params/{name}/kernel", lin.weight, True
            yield f"params/{name}/bias", lin.bias, False


@dataclasses.dataclass
class TemplateState:
    """The step count, the network and its Adam."""

    step: int
    params: _TinyMLP
    optimizer: torch.optim.Optimizer


@register_model("template")
class TemplateSystem:
    """The toy regression system (``--model template``)."""

    def __init__(self, opt, device=None):
        self.opt = opt
        self.device = resolve_device(device)
        self._steps_per_epoch = 1
        self.lr_fn = None          # built in create_state
        self.train_loss_names = ["mse", "tot"]

    def create_state(self, seed: int = 0,
                     steps_per_epoch: Optional[int] = None) -> TemplateState:
        """A fresh network drawn from ``seed`` and its Adam; a given
        ``steps_per_epoch`` sets the schedule's epoch length."""
        if steps_per_epoch:
            self._steps_per_epoch = steps_per_epoch
        gen = torch.Generator().manual_seed(seed)
        net = _TinyMLP().reset_parameters("lecun_normal", generator=gen)
        net = net.to(self.device)
        self.lr_fn = make_lr_schedule(self.opt, self._steps_per_epoch)
        optimizer = Adam(net.parameters(), lr=self.lr_fn(0),
                         betas=(self.opt.beta1, 0.999), eps=1e-8,
                         device=self.device)
        return TemplateState(step=0, params=net, optimizer=optimizer)

    def train_step(self, state: TemplateState,
                   batch: Dict[str, torch.Tensor]):
        """One Adam step on ``batch`` (``x``, ``y``) at the schedule's
        learning rate for this step; updates ``state`` in place."""
        write_lr(state.optimizer, self.lr_fn, state.step)
        mse = torch.mean((state.params(batch["x"]) - batch["y"]) ** 2)
        state.params.zero_grad(set_to_none=True)
        mse.backward()
        state.optimizer.step()
        state.step += 1
        mse = mse.detach()
        return state, {"mse": mse, "tot": mse}

    def sample_indices(self, n_total: int,
                       generator: Optional[torch.Generator] = None):
        """``min(--batch_size, 256)`` buffer rows, drawn on the device."""
        return torch.randint(0, n_total, (min(self.opt.batch_size,
                                              MAX_BATCH),),
                             generator=generator, device=self.device)

    def train_step_from_buffer(self, state: TemplateState, buffer,
                               generator: Optional[torch.Generator] = None,
                               idx: Optional[torch.Tensor] = None):
        """A step on rows of the device buffer: ``idx``, or drawn from
        ``generator``."""
        if idx is None:
            idx = self.sample_indices(buffer["x"].shape[0], generator)
        return self.train_step(state, {k: v[idx] for k, v in buffer.items()})
