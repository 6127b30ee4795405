"""Vanilla NeRF (``--model nerf``) on the CPU against the JAX package, on
the parity schedule (16+16 samples here, to keep the interpret-mode runs
short), with the same weights and inputs:

- ``render_eval`` of a Blender view (white background, world rays from
  the pose on the device) and of an LLFF view (NDC), coarse and fine
  levels, against JAX plain and through its Pallas kernels in interpret
  mode, at full width (D8/W256: the port's fused-MLP route) and at a
  small width (D4/W64: the module route);
- ``_loss_fn`` and every gradient leaf on a Blender ray batch;
- the packed-weight cache of ``kernels/mlp.py`` holding two networks'
  four packings in its slots, on a call order written here (the real
  step's packs are counted on the card, ``tests/test_torch_gpu.py``).
"""

import collections
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch's threads in a test worker)

from nerfsr_tpu.config import default_options as j_default_options
from nerfsr_tpu.data import create_dataset as j_create_dataset
from nerfsr_tpu.models import create_model as j_create_model

from nerfsr_torch.config import default_options
from nerfsr_torch.data import create_dataset
from nerfsr_torch.data.synthetic import write_blender_scene
from nerfsr_torch.kernels import mlp as kmlp
from nerfsr_torch.models import create_model
from nerfsr_torch.weights import load_jax_params

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
from tools.make_synthetic_llff import make_llff_scene  # noqa: E402

PALLAS = dict(use_pallas=True, use_pallas_mlp=True, pallas_mlp_bwd="pallas",
              use_pallas_sampling=True, pallas_interpret=True)
WIDTHS = {"full": dict(D=8, W=256), "small": dict(D=4, W=64)}
# f32 renders: another summation order through the MLP and the
# composite, and the inverse CDF's rounding carried by the 2^9-frequency
# encoding (tests/test_torch_slice.py's bar)
F32_ATOL = 2e-4
LOSS_RTOL = 1e-5
# f32 gradients per leaf, norm-relative (tests/test_torch_train.py)
GRAD_REL = 2e-2


@pytest.fixture(scope="module")
def blender_scene(tmp_path_factory):
    d = tmp_path_factory.mktemp("blender")
    write_blender_scene(str(d), hw=(48, 48), n_train=3, n_val=1, n_test=1)
    return str(d)


@pytest.fixture(scope="module")
def llff_scene(tmp_path_factory):
    d = tmp_path_factory.mktemp("llff")
    make_llff_scene(str(d), hw=(24, 32), n_imgs=4)
    return str(d)


@pytest.fixture
def interpret_composite(monkeypatch):
    """The JAX system calls its composite kernel without ``interpret``
    (``models/render.py:_eval_level``), which the CPU cannot lower; route
    that one call through interpret mode, in this test process only."""
    from nerfsr_tpu.ops.experimental import pallas_composite as pc
    kernel = pc.pallas_volumetric_rendering

    def interpreted(rgb, sigma, z_vals, white_bkgd, activation="relu",
                    interpret=True):
        del interpret
        return kernel(rgb, sigma, z_vals, white_bkgd, activation, True)
    monkeypatch.setattr(pc, "pallas_volumetric_rendering", interpreted)


def _kw(scene, dataset, width, **extra):
    kw = dict(model="nerf", dataset_mode=dataset, dataset_root=scene,
              img_wh=(16, 16) if dataset == "blender" else (16, 12),
              N_coarse=16, N_importance=16, precision="f32",
              **WIDTHS[width])
    kw.update(extra)
    return kw


def _systems(phase, kw, pallas):
    jsys = j_create_model(j_default_options(phase, **kw,
                                            **(PALLAS if pallas else {})))
    state = jsys.create_state(jax.random.PRNGKey(0), steps_per_epoch=4)
    tree = jax.tree_util.tree_map(np.array, state.params)
    # a +3 sigma bias gives both sides a scene with content
    for net in tree.values():
        net["params"]["sigma"]["bias"] += 3.0
    system = create_model(default_options(phase, device="cpu", **kw),
                          device="cpu")
    return jsys, tree, system, load_jax_params(system.init_params(0), tree)


@pytest.mark.parametrize("dataset,width,pallas", [
    ("blender", "full", False), ("blender", "full", True),
    ("blender", "small", False), ("llff", "full", False)],
    ids=["blender-full-plain", "blender-full-pallas",
         "blender-small-plain", "llff-full-plain"])
def test_render_eval_matches_jax(blender_scene, llff_scene, dataset, width,
                                 pallas, interpret_composite):
    scene = blender_scene if dataset == "blender" else llff_scene
    kw = _kw(scene, dataset, width)
    jsys, tree, system, params = _systems("test", kw, pallas)
    assert system.render_cfg.use_fused_mlp == (width == "full")
    assert system.render_cfg.white_bkgd == (dataset == "blender")
    split = "test" if dataset == "blender" else "test_train"
    ds = create_dataset(default_options("test", **kw), split)
    jds = j_create_dataset(j_default_options("test", **kw), split)
    assert ds.eval_raygen_spec(0)["geom"][0] == (
        "world" if dataset == "blender" else "ndc")
    got = system.render_eval(params, ds, 0)
    ref = jsys.render_eval(jax.tree_util.tree_map(jnp.asarray, tree), jds, 0)
    assert set(got) == set(ref) == {"coarse_rgb", "coarse_depth",
                                    "fine_rgb", "fine_depth"}
    assert float(np.asarray(ref["fine_rgb"]).std()) > 0.01
    for k in ref:
        np.testing.assert_allclose(got[k], np.asarray(ref[k]),
                                   atol=F32_ATOL, err_msg=k)
    # the host-rays route renders the same view
    host = system.render_image(params, ds.image_rays(0))
    np.testing.assert_allclose(host["fine_rgb"], got["fine_rgb"],
                               atol=F32_ATOL)


def _grad_tree(params):
    return {key: {"params": {
        name: {"kernel": lin.weight.grad.numpy().T,
               "bias": lin.bias.grad.numpy()}
        for name, lin in module.named_children()
        if isinstance(lin, torch.nn.Linear)}}
        for key, module in params.items()}


@pytest.mark.parametrize("pallas", [False, True], ids=["plain", "pallas"])
def test_loss_fn_and_grads_match_jax(blender_scene, pallas,
                                     interpret_composite):
    """A batch of 192 Blender rays (white background, world rays): the
    coarse + fine MSE and every gradient leaf of both networks."""
    kw = _kw(blender_scene, "blender", "full", randomized=False,
             noise_std=0.0, batch_size=192)
    jsys, tree, system, _ = _systems("train", kw, pallas)
    buf = create_dataset(default_options("train", **kw), "train").ray_buffer()
    batch = {k: v[100:292] for k, v in buf.items()}
    (j_loss, j_losses), j_grads = jax.value_and_grad(
        lambda p: jsys._loss_fn(p, batch, jax.random.PRNGKey(1), 0),
        has_aux=True)(jax.tree_util.tree_map(jnp.asarray, tree))
    state = system.create_state(0, steps_per_epoch=4)
    load_jax_params(state.params, tree)
    loss, losses = system._loss_fn(
        state.params, {k: torch.from_numpy(v) for k, v in batch.items()},
        None, 0)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=LOSS_RTOL)
    assert set(losses) == set(j_losses) == {
        "coarse_mse", "fine_mse", "coarse_psnr", "fine_psnr", "tot"}
    for k in j_losses:
        np.testing.assert_allclose(losses[k].item(), float(j_losses[k]),
                                   rtol=1e-4, err_msg=k)
    grads = _grad_tree(state.params)
    n = 0
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(j_grads),
                            jax.tree_util.tree_leaves(grads)):
        a = np.asarray(a, np.float64)
        rel = np.linalg.norm(b - a) / max(np.linalg.norm(a), 1e-12)
        assert rel < GRAD_REL, (jax.tree_util.keystr(path), rel)
        assert np.abs(b).max() > 0
        n += 1
    assert n == 48                     # 24 leaves each, coarse and fine


def test_packed_cache_holds_both_parity_networks(monkeypatch):
    """The cache's rule on a parity step's call order as written here
    (C on the coarse and the fine network, then E on each): two networks
    fit its slots, a repeat of the order packs nothing, and an in-place
    update packs each once again. The engine's own step is counted by
    ``test_parity_step_through_the_engine`` on the card."""
    packs = collections.Counter()
    for kind in ("pack_tc", "pack_tc_bwd"):
        real = getattr(kmlp, kind)

        def counted(params_flat, _real=real, _kind=kind):
            packs[_kind] += 1
            return _real(params_flat)
        monkeypatch.setattr(kmlp, kind, counted)
    monkeypatch.setattr(kmlp, "_cache", collections.OrderedDict())
    system = create_model(default_options(
        "train", model="nerf", dataset_mode="blender", precision="mixed",
        N_coarse=16, N_importance=16), device="cpu")
    state = system.create_state(0)
    nets = [kmlp.flatten_params(state.params[k]) for k in ("coarse", "fine")]

    def step_packs():
        for flat in nets:                      # forward: C, C
            kmlp.packed(flat, "tc")
        for flat in reversed(nets):            # backward: E, E
            kmlp.packed(flat, "tc")
            kmlp.packed(flat, "tc_bwd")
    for step in range(3):
        packs.clear()
        step_packs()
        step_packs()               # eval within the step: all cached
        assert packs == {"pack_tc": 2, "pack_tc_bwd": 2}, (step, packs)
        with torch.no_grad():      # the optimizer's in-place update
            for p in state.params.parameters():
                p.add_(1e-3)
