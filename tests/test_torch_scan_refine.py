"""The refine system's chunk of training steps (``RefineSystem
.train_steps_scan``) on the CPU, where the same body runs eagerly that the
card replays as a CUDA graph (``nerfsr_torch/graphs.py``), for the UNet
and ``maxpoolingmodel``:

- the chunk body reads nothing back to the host (what a capture
  forbids), with ``Tensor.item`` and the other reads made to raise;
- the chunk against the eager per-step loop, bit for bit.

These cases were ``tests/test_torch_scan.py``'s; they live in a file of
their own so that the test run's workers share the time they take.
"""

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch's threads in a test worker)

from nerfsr_torch.config import default_options
from nerfsr_torch.models import create_model

# ---------------------------------------------------------------------
# what a capture forbids
# ---------------------------------------------------------------------

HOST_READS = ("item", "tolist", "__bool__", "__float__", "__int__", "cpu",
              "numpy")


@pytest.fixture
def no_host_reads(monkeypatch):
    """Inside the ``with``: every read of a tensor's value into the host
    raises, as it would break a CUDA-graph capture on the card."""
    import contextlib

    @contextlib.contextmanager
    def forbid():
        with monkeypatch.context() as m:
            for name in HOST_READS:
                def read(*_, _name=name, **__):
                    raise AssertionError(f"Tensor.{_name} inside a chunk")
                m.setattr(torch.Tensor, name, read)
            yield
    return forbid


def _refine(tmp_path=None, **extra):
    kw = dict(model="refine", dataset_mode="llff_refine", img_wh=(32, 24),
              batch_size=4, patch_len=16, num_downs=4, ngf=8,
              refine_with_l1=True, refine_with_grad=True, with_gt_patch=True,
              n_epochs=3, n_epochs_decay=1)
    kw.update(extra)
    system = create_model(default_options("train", **kw), device="cpu")
    rng = np.random.RandomState(0)
    views = rng.rand(5, 24, 32, 3).astype(np.float32) * 2 - 1
    buffers = system.upload_buffers({
        "sr_imgs": views, "gt_imgs": views[::-1].copy(), "gt_img": views[0],
        "bboxes": np.tile(np.array([2, 1, 30, 23], np.int32), (5, 1))})
    return system, buffers


@pytest.mark.parametrize("network", ["unetgenerator", "maxpoolingmodel"])
def test_refine_chunk_reads_nothing_back(network, no_host_reads):
    """One refine chunk (patches cut on the device, the network with its
    batch statistics, Adam) with every host read made to raise."""
    system, buffers = _refine(refine_network=network)
    state = system.create_state(0, steps_per_epoch=2)
    gen = torch.Generator().manual_seed(3)
    with no_host_reads():
        state, losses = system.train_steps_scan(state, buffers, 3, gen)
    assert state.step == 3
    assert all(torch.isfinite(v) for v in losses.values())


# ---------------------------------------------------------------------
# chunks against their loops
# ---------------------------------------------------------------------

@pytest.mark.parametrize("network", ["unetgenerator", "maxpoolingmodel"])
def test_refine_chunk_equals_the_eager_loop(network):
    """The refine chunk equals its per-step loop bit for bit: the network,
    its batch statistics, the moments and the last step's losses, across
    an epoch's end (the learning rate moves)."""
    runs = []
    for scan in (True, False):
        system, buffers = _refine(refine_network=network)
        state = system.create_state(0, steps_per_epoch=2)
        gen = torch.Generator().manual_seed(5)
        run = system.train_steps_scan if scan else system.train_steps
        state, losses = run(state, buffers, 5, gen)
        runs.append((state, losses))
    (a, la), (b, lb) = runs
    assert a.step == b.step == 5
    sa, sb = a.net.state_dict(), b.net.state_dict()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    for p, q in zip(a.net.parameters(), b.net.parameters()):
        for key in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(a.optimizer.state[p][key],
                               b.optimizer.state[q][key])
    for k in la:
        assert torch.equal(la[k], lb[k]), k
