"""Whole runs on the CPU at a test's size (``conftest.shrink``): the
plain reference agrees with the system's CPU path; with the timed path
broken underneath, ``correct`` comes out false, once for each fault a
cell can have; and the control, the reference a precision below the
configuration's, fails the cell's limits."""

import numpy as np
import pytest
import torch

from nerfbench import control, run, spec
from nerfbench.tests.conftest import shrink

CPU = torch.device("cpu")
CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


def _run(name, seed=2 ** 31 + 77):
    return run.run_cell(shrink(spec.Cell(name)), seed, 0.3, False, CPU)


@pytest.mark.parametrize("name", CELLS)
def test_reference_agrees_with_the_system(name):
    line = _run(name)
    assert line["correct"], line["checks"]
    # f32 on both sides: round-off (which Adam's first steps raise where
    # a gradient element is near 0), or a level where the truncation to
    # uint8 falls the other way
    most = {"loss_gap": 1e-4, "grad_gap": 1e-4, "grad_diff": 1e-4,
            "later_grad_diff": 1e-4, "grad_diff_body": 1e-4,
            "change_gap": 3e-3, "first_stats_diff": 1e-4, "stats_diff": 1e-4,
            "rgb_mae": 0.5,
            "gt_bytes_differ": 0}
    for k, c in line["checks"].items():
        assert c["value"] <= most[k], (k, c)


def _stuck_adam(monkeypatch):
    from nerfsr_torch.utils import optim
    monkeypatch.setattr(optim.Adam, "step", lambda self, closure=None: None)


def _half_batch(monkeypatch):
    from nerfsr_torch.models.nerf_downx_system import NeRFDownXSystem
    orig = NeRFDownXSystem._loss_fn

    def half(self, params, batch, generator=None, step=None):
        n = batch["rgbs"].shape[0] // 2
        return orig(self, params, {k: v[:n] for k, v in batch.items()},
                    generator, step)
    monkeypatch.setattr(NeRFDownXSystem, "_loss_fn", half)


def _doubled_leaf(monkeypatch):
    from nerfsr_torch.models.nerf_system import NeRFSystem

    def double_first(self, optimizer):
        optimizer.param_groups[0]["params"][0].grad.mul_(2.0)
    monkeypatch.setattr(NeRFSystem, "_clip_grads", double_first)


def _doubled_body_leaf(monkeypatch):
    """One leaf's gradient doubled: the first outside the density heads
    (a layer with one output) whose norm is at least the median leaf's."""
    from nerfbench.drivers.train_blender import density_head
    from nerfsr_torch.models.nerf_system import NeRFSystem

    def double_body(self, optimizer):
        params = optimizer.param_groups[0]["params"]
        norms = [float(p.grad.norm()) for p in params]
        med = float(np.median(norms))
        next(p for p, n in zip(params, norms)
             if not density_head(p) and n >= med).grad.mul_(2.0)
    monkeypatch.setattr(NeRFSystem, "_clip_grads", double_body)


def _half_patches(monkeypatch):
    """The refine step on half of its patches (the mean over the rest,
    batch norm's statistics over them)."""
    from nerfsr_torch.models.refine_system import RefineSystem
    orig = RefineSystem.sample_patch_batch

    def half(self, buffers, generator=None):
        batch = orig(self, buffers, generator)
        n = batch["gt_patch"].shape[0] // 2
        return {k: v[:n] for k, v in batch.items()}
    monkeypatch.setattr(RefineSystem, "sample_patch_batch", half)


def _doubled_median_leaf(monkeypatch):
    """One leaf's gradient doubled before Adam's step: the first whose
    norm is at least the median leaf's."""
    from nerfsr_torch.utils import optim
    step = optim.Adam.step

    def doubled(self, closure=None):
        params = [p for p in self.param_groups[0]["params"]
                  if p.grad is not None]
        norms = [float(p.grad.norm()) for p in params]
        med = float(np.median(norms))
        next(p for p, n in zip(params, norms) if n >= med).grad.mul_(2.0)
        return step(self, closure)
    monkeypatch.setattr(optim.Adam, "step", doubled)


def _stats_unmoved(monkeypatch):
    """Batch norm normalizes by the batch's statistics but leaves its
    running ones where they were."""
    from nerfsr_torch.models import networks

    def forward(self, x):
        mean = x.mean((0, 2, 3))
        var = torch.clamp_min((x * x).mean((0, 2, 3)) - mean * mean, 0)
        mul = torch.rsqrt(var + self.eps) * self.scale
        return (x - mean[:, None, None]) * mul[:, None, None] \
            + self.bias[:, None, None]
    monkeypatch.setattr(networks.BatchNorm, "forward", forward)


def _altered_image(monkeypatch):
    from nerfsr_torch.models.nerf_system import NeRFSystem
    orig = NeRFSystem.eval_image_device_pose

    def altered(self, *a, **k):
        out = orig(self, *a, **k)
        rgb = out["fine_rgb"]
        rgb[:rgb.shape[0] // 8] ^= 64
        return out
    monkeypatch.setattr(NeRFSystem, "eval_image_device_pose", altered)


def _half_image(monkeypatch):
    from nerfsr_torch.models.nerf_system import NeRFSystem
    orig = NeRFSystem.eval_image_device_pose

    def half(self, *a, **k):
        out = orig(self, *a, **k)
        out["fine_rgb"][out["fine_rgb"].shape[0] // 2:] = 0
        return out
    monkeypatch.setattr(NeRFSystem, "eval_image_device_pose", half)


FAULTS = {"train": [_stuck_adam, _half_batch, _doubled_leaf],
          "train_blender": [_stuck_adam, _half_batch, _doubled_body_leaf],
          "train_refine": [_stuck_adam, _half_patches, _doubled_median_leaf,
                           _stats_unmoved],
          "render": [_altered_image, _half_image],
          "test": [_altered_image, _half_image]}
CASES = [(name, f) for name in CELLS
         for f in FAULTS[spec.Cell(name).kind]]


@pytest.mark.parametrize("name,fault", CASES,
                         ids=[f"{n}-{f.__name__}" for n, f in CASES])
def test_a_fault_is_not_correct(name, fault, monkeypatch):
    fault(monkeypatch)
    line = _run(name)
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_the_control_and_the_faults_fail_the_limits(name):
    """The control, and each fault planted in the reference, fail one of
    the cell's numbers at least."""
    cell = shrink(spec.Cell(name))
    for reading, got in control.readings(cell, 2 ** 31 + 5, CPU).items():
        assert any(got[k] > v for k, v in cell.limits.items()
                   if k in got), (reading, got)


def test_a_stuck_state_reads_one():
    """A state left unchanged reads 1 by the change's measure."""
    from nerfbench.drivers import leaf_norms, worst_leaf_gap
    w = {"a": torch.ones(3), "b": torch.full((2,), 2.0)}
    moved = leaf_norms({k: v * 0.01 for k, v in w.items()})
    still = leaf_norms({k: v * 0.0 for k, v in w.items()})
    assert worst_leaf_gap(still, moved) == pytest.approx(1.0)
    assert np.isfinite(worst_leaf_gap(moved, moved))
