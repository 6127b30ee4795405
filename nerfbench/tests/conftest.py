"""Settings of the benchmark's own tests (``python -m pytest
nerfbench/tests``): the ``cuda`` marker, and ``tiny``, a cell of
``BENCHMARK.json`` cut to a size the CPU runs in seconds (f32, two-layer
networks, 32x24 images; the U-Net at 8 features, 4 downs and 16x16
patches, 8 a step), for the tests that drive a whole run there."""

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips without one")


def shrink(cell, precision="f32"):
    """The cell at a CPU test's size; its limits stay the chip's."""
    c = cell.config
    if cell.kind == "train_refine":
        c.update(img_wh=[32, 24], batch_size=8, patch_len=16, ngf=8,
                 num_downs=4, aug_num=5, ref_offset=8)
        cell.traffic["focal"] = 26.0
        cell.traffic["scene"]["samples"] = 32
        return cell
    c.update(img_wh=[32, 24], batch_size=16, D=2, W=32, n_prop=8,
             n_prop2=6, N_coarse=8, prop_W=16, prop_D=2,
             N_importance=4 if c["fast_sampling"] else 8, focal=26.0)
    c["options"]["precision"] = precision
    t = cell.traffic
    for k in ("views", "capture_views"):
        if k in t:
            t[k] = 5 if t["kind"] == "render" and k == "views" else 3
    t["scene"]["samples"] = 32
    return cell


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the benchmark runs only on the card")
    return torch.device("cuda", 0)
