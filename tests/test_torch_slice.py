"""The serving slice as a whole: the port's ``NeRFDownXSystem.render_eval``
against the JAX package's, with the same weights, on a tiny non-square
view (HR 16x12, downscale 2, full-width D8/W256 MLP), for
``--fast_preset llff`` and ``parity`` (parity at 16+16 samples to keep the
interpret-mode run short). JAX runs twice: plain, and through its Pallas
kernels in interpret mode. Plus the port's guards: no JAX import, no
silent CPU fallback, the pad anneal at eval.
"""

import dataclasses
import pathlib
import re
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch's threads in a test worker)

from nerfsr_tpu.config import FAST_PRESETS as J_PRESETS
from nerfsr_tpu.config import default_options as j_default_options
from nerfsr_tpu.data.blender import _ray_dirs_np as j_ray_dirs
from nerfsr_tpu.data.downx_common import group_subpixels as j_group
from nerfsr_tpu.data.llff import spiral_path as j_spiral
from nerfsr_tpu.models import create_model as j_create_model

from nerfsr_torch.config import FAST_PRESETS, default_options
from nerfsr_torch.data import views as tviews
from nerfsr_torch.data.views import LLFFDownXViews
from nerfsr_torch.models import create_model
from nerfsr_torch.models.render import _annealed_pad
from nerfsr_torch.weights import load_jax_params

REPO = pathlib.Path(__file__).resolve().parent.parent
HR_WH = (16, 12)          # non-square: a grouped-order transposition shows
FOCAL = 14.0
PRESETS = {"llff": dict(fast_preset="llff"),
           "parity": dict(fast_preset="parity", N_coarse=16,
                          N_importance=16)}
PALLAS = dict(use_pallas=True, use_pallas_mlp=True,
              use_pallas_sampling=True, pallas_interpret=True)
# f32: depths from the inverse CDF differ by a CDF rounding (~1e-7) over
# the local density, and the 2^9-frequency encoding carries that into
# the MLP input; colours and NDC depths in [0, 1] were seen to agree to
# 6.5e-5 at most
F32_ATOL = 2e-4
# mixed: each side rounds to bf16 at other places (the three numerics of
# nerfsr_torch/kernels/mlp.py); bars on the mean and the max abs error
# (seen: mean 2.4e-3, max 1.7e-2)
MIXED_MEAN, MIXED_MAX = 1e-2, 0.1


def _views():
    return LLFFDownXViews.spiral(FOCAL, HR_WH, 2, 3, radii=(0.2, 0.2, 0.05))


def _rays_for(views, idx):
    """The NDC rays ``render_eval`` builds on the device for view idx."""
    from nerfsr_torch.core.rays import get_rays, make_rays, ndc_rays
    spec = views.eval_raygen_spec(idx)
    d = torch.from_numpy(views.eval_dirs())
    c2w = torch.from_numpy(np.asarray(spec["c2w"], np.float32))
    _, h, w, focal, near, far = spec["geom"]
    ro, rd = ndc_rays(h, w, focal, 1.0, *get_rays(d, c2w))
    return make_rays(ro, rd, near, far, rd)


def _kw(preset, precision):
    return dict(model="nerf_downX", dataset_mode="llff_downX",
                img_wh=HR_WH, downscale=2, precision=precision,
                **PRESETS[preset])


@pytest.fixture
def interpret_composite(monkeypatch):
    """The JAX system calls its composite kernel without ``interpret``
    (``models/render.py:_eval_level``), which the CPU cannot lower; route
    that one call through interpret mode, in this test process only."""
    from nerfsr_tpu.ops.experimental import pallas_composite as pc
    kernel = pc.pallas_volumetric_rendering

    def interpreted(rgb, sigma, z_vals, white_bkgd, activation="relu"):
        return kernel(rgb, sigma, z_vals, white_bkgd, activation, True)
    monkeypatch.setattr(pc, "pallas_volumetric_rendering", interpreted)


def _jax_render(preset, precision, pallas, views, idx):
    opt = j_default_options("test", **_kw(preset, precision),
                            **(PALLAS if pallas else {}))
    system = j_create_model(opt)
    # as engine.test: create_state resolves --prop_pad_anneal_frac
    state = system.create_state(jax.random.PRNGKey(0), steps_per_epoch=1)
    tree = jax.tree_util.tree_map(np.array, state.params)
    # a fresh init can put every density below 0 (an empty, black scene);
    # a +3 sigma bias gives both sides a scene with content
    for net in tree.values():
        net["params"]["sigma"]["bias"] += 3.0
    out = system.render_eval(jax.tree_util.tree_map(jax.numpy.asarray,
                                                    tree), views, idx)
    assert float(np.asarray(out["fine_rgb_ori"]).std()) > 0.01
    assert float(np.asarray(out["fine_depth_ori"]).mean()) > 0.05
    return out, tree


def _port(preset, precision, tree):
    system = create_model(default_options("test", **_kw(preset, precision)),
                          device="cpu")
    params = load_jax_params(system.init_params(0), tree)
    return system, params


@pytest.mark.parametrize("pallas", [False, True], ids=["plain", "pallas"])
@pytest.mark.parametrize("preset", ["llff", "parity"])
def test_render_eval_matches_jax_f32(preset, pallas, interpret_composite):
    views = _views()
    ref, tree = _jax_render(preset, "f32", pallas, views, 1)
    system, params = _port(preset, "f32", tree)
    got = system.render_eval(params, views, 1)
    assert set(got) == set(ref)
    n_lr = (HR_WH[0] // 2) * (HR_WH[1] // 2)
    assert got["fine_rgb"].shape == (n_lr, 3)
    assert got["fine_rgb_ori"].shape == (HR_WH[0] * HR_WH[1], 3)
    for k in ref:
        np.testing.assert_allclose(got[k], np.asarray(ref[k]),
                                   atol=F32_ATOL, err_msg=k)


def test_render_eval_matches_jax_mixed(interpret_composite):
    """Mixed precision against both JAX paths (flax Dense(bf16) and the
    Pallas megakernel's bf16 activations x f32 weights)."""
    views = _views()
    ref_plain, tree = _jax_render("llff", "mixed", False, views, 2)
    ref_pallas, _ = _jax_render("llff", "mixed", True, views, 2)
    system, params = _port("llff", "mixed", tree)
    got = system.render_eval(params, views, 2)
    for ref in (ref_plain, ref_pallas):
        for k in ("fine_rgb_ori", "fine_depth_ori"):
            diff = np.abs(got[k] - np.asarray(ref[k]))
            assert diff.mean() < MIXED_MEAN and diff.max() < MIXED_MAX, k


def test_render_eval_many_quantized():
    views = _views()
    system = create_model(default_options("test", **_kw("llff", "f32")),
                          device="cpu")
    params = system.init_params(3)
    outs = list(system.render_eval_many(params, views, range(2),
                                        quantize_rgb=True))
    assert len(outs) == 2
    for i, out in enumerate(outs):
        ref = system.render_eval(params, views, i)
        assert out["fine_rgb_ori"].dtype == np.uint8
        np.testing.assert_array_equal(
            out["fine_rgb_ori"],
            (np.clip(ref["fine_rgb_ori"], 0, 1) * 255).astype(np.uint8))
        # LR preview from quantized sub-pixels: within 1/255 of the mean
        np.testing.assert_allclose(out["fine_rgb"], ref["fine_rgb"],
                                   atol=1 / 255)
        np.testing.assert_array_equal(out["fine_depth"], ref["fine_depth"])


def test_views_match_jax_data_helpers():
    np.testing.assert_array_equal(tviews.spiral_path(np.array([.3, .2, .1]),
                                                     3.5, 7),
                                  j_spiral(np.array([.3, .2, .1]), 3.5, 7))
    d = j_ray_dirs(12, 16, FOCAL)
    np.testing.assert_array_equal(tviews._ray_dirs_np(12, 16, FOCAL), d)
    np.testing.assert_array_equal(tviews.group_subpixels(d, 2),
                                  j_group(d, 2))
    views = _views()
    np.testing.assert_array_equal(views.eval_dirs(),
                                  j_group(d, 2).reshape(-1, 3))
    assert views.eval_dirs() is views.eval_dirs()      # cached
    spec = views.eval_raygen_spec(0)
    assert spec["geom"] == ("ndc", 12, 16, FOCAL, 0.0, 1.0)
    assert views.depth_bounds == (0.0, 1.0) and len(views) == 3
    with pytest.raises(ValueError, match="multiple of downscale"):
        LLFFDownXViews(views.poses, FOCAL, (15, 12), 2)


def test_ungroup_inverts_grouping_non_square():
    system = create_model(default_options("test", **_kw("llff", "f32")),
                          device="cpu")
    img = np.arange(12 * 16 * 3, dtype=np.float32).reshape(12, 16, 3)
    grouped = tviews.group_subpixels(img, 2)
    np.testing.assert_array_equal(system._ungroup(grouped),
                                  img.reshape(-1, 3))
    np.testing.assert_array_equal(
        system._ungroup(tviews.group_subpixels(img[:4, :6], 2), hw=(6, 4)),
        img[:4, :6].reshape(-1, 3))


def test_config_matches_jax():
    assert FAST_PRESETS == J_PRESETS
    port = vars(default_options("test", **_kw("llff", "mixed")))
    jax_opt = vars(j_default_options("test", **_kw("llff", "mixed")))
    # dataset_root is a placeholder in both; the compile cache is TPU-only
    shared = set(port) & set(jax_opt) - {"dataset_root",
                                         "compilation_cache_dir"}
    assert len(shared) > 50
    assert {k: port[k] for k in shared} == {k: jax_opt[k] for k in shared}
    with pytest.raises(SystemExit, match="REFUSING"):
        default_options("test", dataset_mode="blender", fast_preset="llff")


def test_pad_anneal_resolves_to_final_at_eval():
    system = create_model(default_options("test", **_kw("llff", "mixed")),
                          device="cpu")
    cfg = system.render_cfg
    assert cfg.prop_pad_anneal > 0 and cfg.prop_pad == 0.01
    assert _annealed_pad(cfg, None) == 0.0
    assert _annealed_pad(cfg, 0) == 0.01


def test_architecture_check_and_chunk_size():
    opt = default_options("test", **_kw("llff", "f32"))
    system = create_model(opt, device="cpu")
    assert system.render_cfg.use_fused_mlp
    assert system._eval_chunk_size(504 * 378) == 4096
    assert system._eval_chunk_size(192) == 256
    assert system._eval_chunk_size(1000, override=512) == 512
    # RenderConfig.plain picks the plain versions on the card too; on
    # the CPU the wrappers take them anyway, so both renders are equal
    params = system.init_params(0)
    with torch.no_grad():
        rays = _rays_for(_views(), 0)
        wrapped = system.render(params, rays, randomized=False)
        system.render_cfg = dataclasses.replace(system.render_cfg,
                                                plain=True)
        plain = system.render(params, rays, randomized=False)
    for k in ("fine_rgb", "fine_depth", "fine_z"):
        assert torch.equal(wrapped[k], plain[k]), k
    # another architecture takes the module path, and still renders
    small = create_model(default_options("test", **_kw("llff", "f32"),
                                         D=4, W=64), device="cpu")
    assert not small.render_cfg.use_fused_mlp
    out = small.render_eval(small.init_params(0), _views(), 0)
    assert np.isfinite(out["fine_rgb"]).all()


def test_entry_points_need_a_card_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    opt = default_options("test", **_kw("llff", "mixed"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        create_model(opt)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        create_model(opt, device="cuda")
    assert create_model(opt, device="cpu").device.type == "cpu"


def test_port_imports_no_jax_subprocess():
    code = (
        "import importlib, pkgutil, sys, nerfsr_torch\n"
        "for m in pkgutil.walk_packages(nerfsr_torch.__path__, "
        "'nerfsr_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'nerfsr_tpu')]\n"
        "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)


def test_port_sources_name_no_jax_import():
    pattern = re.compile(
        r"^\s*(import|from)\s+(jax|jaxlib|flax|optax|nerfsr_tpu)\b",
        re.MULTILINE)
    files = sorted((REPO / "nerfsr_torch").rglob("*.py")) + \
        [REPO / "chip_smoke.py"]
    assert len(files) > 15
    for f in files:
        assert not pattern.search(f.read_text()), f
