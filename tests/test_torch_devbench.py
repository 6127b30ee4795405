"""The training log's achieved-TFLOP/s scalar: the port's FLOP count
(``nerfsr_torch/utils/devbench.py``) against the JAX package's on the
same weights, and the port's engine logging ``tflops`` by the JAX
engine's rule (``tf >= 0.1``, rounded to one decimal)."""

import json
import os
import sys

import jax
import pytest
import torch_threads  # noqa: F401  (torch's threads in a test worker)

from nerfsr_tpu.config import default_options as j_default_options
from nerfsr_tpu.models import create_model as j_create_model
from nerfsr_tpu.utils.devbench import \
    train_matmul_flops_per_ray as j_flops_per_ray

from nerfsr_torch import engine
from nerfsr_torch.config import default_options
from nerfsr_torch.models import create_model
from nerfsr_torch.utils.devbench import train_matmul_flops_per_ray
from nerfsr_torch.weights import export_params, load_jax_params

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from tools.make_synthetic_llff import make_llff_scene  # noqa: E402

PRESETS = {"llff": dict(fast_preset="llff"),
           "parity": dict(fast_preset="parity", N_coarse=16,
                          N_importance=16)}


@pytest.mark.parametrize("width", [(2, 32), (4, 64)])
@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_flops_per_ray_equal_the_jax_count(preset, width):
    """The JAX system's weights carried into the port's networks: both
    counts agree exactly, and the count is what the networks' 2-D weights
    give (3 x the forward's 2 m n a point)."""
    d, w = width
    kw = dict(model="nerf_downX", dataset_mode="llff_downX",
              img_wh=(16, 12), downscale=2, precision="f32", D=d, W=w,
              **PRESETS[preset])
    jsys = j_create_model(j_default_options("train", **kw))
    jstate = jsys.create_state(jax.random.PRNGKey(0), steps_per_epoch=1)
    system = create_model(default_options("train", device="cpu", **kw),
                          device="cpu")
    params = system.init_params(0)
    tree = jax.tree_util.tree_map(lambda x: x.__array__(), jstate.params)
    load_jax_params(params, tree)
    assert export_params(params).keys() == tree.keys()
    got = train_matmul_flops_per_ray(system.render_cfg, params)
    want = j_flops_per_ray(jsys.render_cfg, jstate.params)
    assert got == want > 0
    cfg = system.render_cfg
    per_point = {k: sum(2 * p.numel() for p in net.parameters()
                        if p.ndim == 2) for k, net in params.items()}
    if cfg.fast_sampling:
        prop_pts = cfg.n_prop + cfg.n_prop2 * (cfg.n_prop_levels >= 2)
        fwd = prop_pts * per_point["prop"] \
            + cfg.n_importance * per_point["fine"]
    else:
        fwd = cfg.n_coarse * per_point["coarse"] \
            + (cfg.n_coarse + cfg.n_importance) * per_point["fine"]
    assert got == 3.0 * fwd


def _logged(path):
    """[{tag: value}] of each logged training step."""
    steps = {}
    with open(path) as f:
        for line in f:
            rec = json.loads(line)
            if rec["tag"].startswith("train/"):
                steps.setdefault(rec["step"], {})[rec["tag"][6:]] = \
                    rec["value"]
    return [steps[k] for k in sorted(steps)]


@pytest.mark.parametrize("scale", [1.0, 1e9])
def test_engine_logs_tflops_by_the_jax_rule(tmp_path, monkeypatch, scale):
    """A short engine run on the CPU: every logged step carries
    ``tflops`` exactly where rays_per_sec x FLOPs a ray / 1e12 >= 0.1, as
    that figure rounded to one decimal. With the count as it is the CPU
    run is far below 0.1; with the count scaled up (``scale``) every step
    is above it."""
    scene = str(tmp_path / "scene")
    make_llff_scene(scene, hw=(24, 32), n_imgs=4)
    counted = []

    def flops(cfg, params):
        counted.append(train_matmul_flops_per_ray(cfg, params) * scale)
        return counted[-1]

    monkeypatch.setattr(engine, "train_matmul_flops_per_ray", flops)
    opt = default_options(
        "train", device="cpu", model="nerf_downX",
        dataset_mode="llff_downX", dataset_root=scene, img_wh=(32, 24),
        downscale=2, fast_preset="llff", precision="f32", D=2, W=32,
        checkpoints_dir=str(tmp_path / "ck"), name="tf",
        summary_dir=str(tmp_path / "runs"), batch_size=32, n_epochs=1,
        steps_per_epoch=6, scan_steps=2, print_freq=2, val_freq=0,
        val_epoch_freq=0)
    engine.train(opt)
    assert len(counted) == 1
    lines = _logged(tmp_path / "runs" / "tf" / "metrics.jsonl")
    assert len(lines) == 3
    for scal in lines:
        tf = scal["rays_per_sec"] * counted[0] / 1e12
        if tf >= 0.1:
            assert scal["tflops"] == round(tf, 1)
        else:
            assert "tflops" not in scal
    assert all(("tflops" in s) == (scale > 1) for s in lines)
