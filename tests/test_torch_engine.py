"""The port's engine on the CPU: against the JAX engine from one JAX
checkpoint, resume, ``--stop_grad``, the refusals, the entry points, and
the import rule.
"""

import ast
import json
import os
import pathlib
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from nerfsr_tpu import engine as j_engine
from nerfsr_tpu.config import default_options as j_default_options
from nerfsr_tpu.data import create_dataset as j_create_dataset
from nerfsr_tpu.models import create_model as j_create_model
from nerfsr_tpu.utils import checkpoint as j_ckpt

from nerfsr_torch import engine
from nerfsr_torch.config import default_options
from nerfsr_torch.data import create_dataset
from nerfsr_torch.models import create_model
from nerfsr_torch.utils import png
from nerfsr_torch.utils.checkpoint import load_checkpoint

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
from tools.make_synthetic_llff import make_llff_scene  # noqa: E402

# f32 metrics of one render, the port against JAX: another summation
# order through the MLP, the composite and the inverse CDF
PSNR_DB, SSIM_ABS = 1e-3, 1e-4
# the same f32 renders quantized to 8 bits: a value within a rounding of
# a quantization step may land one step apart
PNG_EQUAL_SHARE, DEPTH_ABS = 0.999, 1e-4
GRAD_REL = 2e-2          # f32 gradients per leaf (test_torch_train.py)
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "msgpack", "PIL", "imageio",
             "cv2", "nerfsr_tpu", "tools"}


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    d = tmp_path_factory.mktemp("llff")
    make_llff_scene(str(d), hw=(24, 32), n_imgs=4)
    return str(d)


def _kw(scene, tmp_path, **extra):
    kw = dict(model="nerf_downX", dataset_mode="llff_downX",
              dataset_root=scene, img_wh=(32, 24), downscale=2,
              fast_preset="llff", precision="f32", D=4, W=32,
              checkpoints_dir=str(tmp_path / "ck"), name="exp",
              summary_dir=str(tmp_path / "runs"))
    kw.update(extra)
    return kw


def _opts(phase, scene, tmp_path, **extra):
    kw = _kw(scene, tmp_path, **extra)
    if phase == "train":
        return default_options(phase, device="cpu", **kw), \
            j_default_options(phase, **kw)
    kw.pop("summary_dir")
    return default_options(phase, device="cpu", **kw), \
        j_default_options(phase, **kw)


def _jax_checkpoint(jopt):
    """A JAX-written epoch-1 checkpoint (fresh weights, sigma biases +3
    so the scene has content)."""
    jsys = j_create_model(jopt)
    state = jsys.create_state(jax.random.PRNGKey(0), steps_per_epoch=4)
    params = jax.tree_util.tree_map(np.array, state.params)
    for net in params.values():
        net["params"]["sigma"]["bias"] += 3.0
    state = state.replace(params=params)
    j_ckpt.save_checkpoint(jopt, state, 1)
    return jsys, state


def test_engine_matches_jax_from_one_jax_checkpoint(scene, tmp_path):
    opt, jopt = _opts("train", scene, tmp_path)
    jsys, jstate = _jax_checkpoint(jopt)
    system = create_model(opt, device="cpu")
    state = system.create_state(0, steps_per_epoch=4)
    load_checkpoint(opt, state, epoch=1)

    got = engine.validate(opt, system, state.params,
                          create_dataset(opt, "val"))
    want = j_engine.validate(jopt, jsys, jstate.params,
                             j_create_dataset(jopt, "val"))
    assert set(got) == set(want) == {"fine_psnr", "fine_psnr_ori",
                                     "fine_ssim_ori"}
    for k in ("fine_psnr", "fine_psnr_ori"):
        assert abs(got[k] - want[k]) < PSNR_DB, (k, got[k], want[k])
    assert abs(got["fine_ssim_ori"] - want["fine_ssim_ori"]) < SSIM_ABS

    extra = dict(test_split="test_train", load_epoch="1")
    topt, jtopt = _opts("test", scene, tmp_path,
                        results_dir=str(tmp_path / "port"), **extra)
    jtopt.results_dir = str(tmp_path / "jax")
    ours, theirs = engine.test(topt), j_engine.test(jtopt)
    names = sorted(os.listdir(ours))
    assert names == sorted(os.listdir(theirs))
    assert {"0-fine-ori.png", "3-fine-depth-ori.npz", "fine.gif",
            "fine-ori.gif"} <= set(names)
    for i in range(4):
        a = png.read_rgb(os.path.join(ours, f"{i}-fine-ori.png")).astype(int)
        b = np.asarray(Image.open(os.path.join(theirs,
                                               f"{i}-fine-ori.png")),
                       np.int64)
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= 1
        assert (a == b).mean() >= PNG_EQUAL_SHARE
        for name in (f"{i}-fine-depth.npz", f"{i}-fine-depth-ori.npz"):
            np.testing.assert_allclose(
                np.load(os.path.join(ours, name))["matrix"],
                np.load(os.path.join(theirs, name))["matrix"],
                atol=DEPTH_ABS)


def test_host_rays_render_matches_device_raygen(scene, tmp_path):
    """A dataset without device raygen renders from its grouped host rays
    (``render_image``, chunked), through ``render_eval`` and
    ``render_eval_many``; against device raygen from the pose."""
    import types
    opt, _ = _opts("train", scene, tmp_path)
    system = create_model(opt, device="cpu")
    params = system.init_params(0)
    dataset = create_dataset(opt, "test_train")
    rays_only = types.SimpleNamespace(image_rays=dataset.image_rays)
    host = system.render_eval(params, rays_only, 2)
    many = next(system.render_eval_many(params, rays_only, [2]))
    for k in host:
        np.testing.assert_array_equal(many[k], host[k])
    np.testing.assert_array_equal(
        system.render_image(params, dataset.image_rays(2), chunk=256)[
            "fine_rgb"], host["fine_rgb"])
    dev = system.render_eval(params, dataset, 2)
    assert set(host) == set(dev) == {"fine_rgb", "fine_depth",
                                     "fine_rgb_ori", "fine_depth_ori"}
    # rays built in numpy (f64, then f32) against rays built in torch f32:
    # origins a rounding apart, which the 2^9-frequency encoding carries
    # into the MLP (test_torch_slice.py's f32 bar)
    for k in host:
        np.testing.assert_allclose(host[k], dev[k], atol=2e-4, err_msg=k)


def _train_lines(path, after_step):
    out = []
    with open(path) as f:
        for line in f:
            rec = json.loads(line)
            if rec["tag"].startswith("train/") and \
                    rec["tag"] != "train/rays_per_sec" and \
                    rec["step"] > after_step:
                out.append((rec["tag"], rec["value"], rec["step"]))
    return out


@pytest.mark.parametrize("scan_steps", [1, 4])
def test_resume_rebuilds_the_epoch_bit_for_bit(scene, tmp_path, scan_steps):
    """Two epochs saved each; epoch 2's files removed; a rerun from
    epoch 1 rebuilds epoch 2's checkpoint to the byte (parameters, Adam
    moments, step) and writes the same loss lines. Randomized rendering
    and sigma noise on: the draws follow (seed, step). With
    ``--scan_steps 1`` every chunk is the eager ``train_steps``, with 4
    ``train_steps_scan``."""
    kw = dict(batch_size=32, n_epochs=2, steps_per_epoch=6,
              scan_steps=scan_steps,
              save_epoch_freq=1, val_epoch_freq=1, val_freq=0,
              print_freq=2, device="cpu")
    opt = default_options("train", **_kw(scene, tmp_path, **kw))
    assert opt.randomized and opt.noise_std == 1.0
    engine.train(opt)
    d = tmp_path / "ck" / "exp"
    epoch2 = (d / "2_state.msgpack").read_bytes()
    (d / "2_state.msgpack").unlink()
    (d / "latest_state.msgpack").unlink()
    again = default_options("train", **_kw(
        scene, tmp_path, continue_train=True, load_epoch="1",
        **dict(kw, summary_dir=str(tmp_path / "runs2"))))
    state = engine.train(again)
    assert state.step == 12
    assert (d / "2_state.msgpack").read_bytes() == epoch2
    first = _train_lines(tmp_path / "runs" / "exp" / "metrics.jsonl", 6)
    second = _train_lines(tmp_path / "runs2" / "exp" / "metrics.jsonl", 6)
    assert first and first == second


def _grads_in_jax_layout(params):
    """Gradients as a JAX tree; a parameter no gradient reached (None)
    reads as zeros."""
    def g(p):
        return (torch.zeros_like(p) if p.grad is None else p.grad).numpy()
    return {key: {"params": {
        name: {"kernel": g(lin.weight).T, "bias": g(lin.bias)}
        for name, lin in module.named_children()
        if isinstance(lin, torch.nn.Linear)}}
        for key, module in params.items()}


def test_stop_grad_matches_jax():
    """One step's gradients with --stop_grad against JAX's (module path
    on both sides), and the colour alone trains no trunk layer."""
    from nerfsr_torch.data.views import LLFFDownXTrainViews, LLFFDownXViews
    from nerfsr_torch.weights import load_jax_params
    kw = dict(model="nerf_downX", dataset_mode="llff_downX",
              fast_preset="llff", img_wh=(16, 12), downscale=2,
              precision="f32", D=4, W=64, stop_grad=True, randomized=False,
              noise_std=0.0)
    jsys = j_create_model(j_default_options("train", **kw))
    tree = jax.tree_util.tree_map(
        np.array, jsys.create_state(jax.random.PRNGKey(0), 4).params)
    for net in tree.values():
        net["params"]["sigma"]["bias"] += 3.0
    system = create_model(default_options("train", **kw), device="cpu")
    assert not system.render_cfg.use_fused_mlp
    state = system.create_state(0, steps_per_epoch=4)
    load_jax_params(state.params, tree)
    views = LLFFDownXViews.spiral(14.0, (16, 12), 2, 2)
    imgs = (np.random.RandomState(1).rand(2, 12, 16, 3) * 255).astype(
        np.uint8)
    buf = LLFFDownXTrainViews(views.poses, imgs, 14.0, (16, 12),
                              2).ray_buffer("cpu")

    j_grads = jax.grad(lambda p: jsys._loss_fn(
        p, {k: v.numpy() for k, v in buf.items()}, jax.random.PRNGKey(1),
        0)[0])(jax.tree_util.tree_map(jax.numpy.asarray, tree))
    loss, _ = system._loss_fn(state.params, buf, None, 0)
    loss.backward()
    grads = _grads_in_jax_layout(state.params)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(j_grads),
                            jax.tree_util.tree_leaves(grads)):
        a = np.asarray(a, np.float64)
        rel = np.linalg.norm(b - a) / max(np.linalg.norm(a), 1e-12)
        assert rel < GRAD_REL, (jax.tree_util.keystr(path), rel)
    # xyz_encoding_final feeds only the colour branch: zero in both
    for g in (grads, j_grads):
        final = g["fine"]["params"]["xyz_encoding_final"]
        assert not np.any(final["kernel"]) and not np.any(final["bias"])
    # the colour alone trains no trunk layer, in either package
    rng = np.random.RandomState(0)
    xyz = rng.randn(5, 63).astype(np.float32)
    dirs = rng.randn(5, 27).astype(np.float32)
    j_rgb = jax.grad(lambda p: jsys.mlp.apply(p, xyz, dirs)[0].sum())(
        jax.tree_util.tree_map(jax.numpy.asarray, tree["fine"]))
    state.params.zero_grad(set_to_none=True)
    state.params["fine"](torch.from_numpy(xyz),
                         torch.from_numpy(dirs))[0].sum().backward()
    port = _grads_in_jax_layout(torch.nn.ModuleDict(
        {"fine": state.params["fine"]}))["fine"]["params"]
    for name in ["xyz_encoding_final"] + [f"xyz_encoding_{i}"
                                          for i in range(1, 5)]:
        assert not np.any(port[name]["kernel"]), name
        assert not np.any(np.asarray(j_rgb["params"][name]["kernel"])), name
    assert np.any(port["rgb"]["kernel"])


def test_kernel_a_bin_cap_does_not_bind_on_the_cpu():
    opt = default_options("train", model="nerf_downX",
                          dataset_mode="llff_downX", fast_preset="llff",
                          n_prop=200, n_prop2=150, D=2, W=16,
                          img_wh=(16, 12))
    system = create_model(opt, device="cpu")
    from nerfsr_torch.data.views import LLFFDownXViews
    views = LLFFDownXViews.spiral(14.0, (16, 12), 2, 1)
    out = system.render_eval(system.init_params(0), views, 0)
    assert np.isfinite(out["fine_rgb"]).all()


@pytest.mark.parametrize("flags,match", [
    (dict(ckpt_backend="orbax"), "orbax")])
def test_engine_refuses_unported_paths(tmp_path, flags, match):
    opt = default_options("train", **_kw(str(tmp_path), tmp_path,
                                         device="cpu", **flags))
    with pytest.raises(NotImplementedError, match=match):
        engine.train(opt)


def test_train_crop_runs_the_warmup(scene, tmp_path):
    """``--train_crop`` (``python -m nerfsr_torch.train``) and a
    ``warmup_mode`` given to ``engine.train`` both take the first steps
    from the Blender ``train_crop`` split; a split without that mode
    says so."""
    from nerfsr_torch import train as train_entry
    from nerfsr_torch.data.synthetic import write_blender_scene
    blender = str(tmp_path / "blender")
    write_blender_scene(blender, hw=(32, 32), n_train=2, n_val=1, n_test=1)
    argv = ["--name", "crop", "--model", "nerf", "--dataset_mode", "blender",
            "--dataset_root", blender, "--img_wh", "16", "16", "--N_coarse",
            "8", "--N_importance", "8", "--precision", "f32", "--D", "2",
            "--W", "16", "--device", "cpu", "--batch_size", "16",
            "--n_epochs", "1", "--steps_per_epoch", "3", "--val_freq", "0",
            "--checkpoints_dir", str(tmp_path / "ck"),
            "--summary_dir", str(tmp_path / "runs"), "--train_crop"]
    train_entry.main(argv)
    assert (tmp_path / "ck" / "crop" / "1_state.msgpack").exists()
    opt = default_options("train", **_kw(scene, tmp_path, device="cpu"))
    with pytest.raises(ValueError, match="no mode 'train_crop'"):
        engine.train(opt, warmup_mode="train_crop")


def test_entry_points_run_end_to_end(scene, tmp_path):
    common = ["--name", "cli", "--model", "nerf_downX", "--dataset_mode",
              "llff_downX", "--dataset_root", scene, "--img_wh", "32", "24",
              "--downscale", "2", "--fast_preset", "llff", "--precision",
              "f32", "--D", "2", "--W", "16", "--device", "cpu",
              "--checkpoints_dir", str(tmp_path / "ck")]
    runs = [("train", ["--batch_size", "32", "--n_epochs", "1",
                       "--steps_per_epoch", "3", "--val_freq", "0",
                       "--summary_dir", str(tmp_path / "runs")]),
            ("test", ["--results_dir", str(tmp_path / "res"),
                      "--test_split", "test_train"]),
            ("infer", ["--results_dir", str(tmp_path / "inf"),
                       "--test_split", "test_train"])]
    for phase, extra in runs:
        subprocess.run([sys.executable, "-m", f"nerfsr_torch.{phase}",
                        *common, *extra], cwd=REPO, check=True,
                       timeout=300, capture_output=True)
    assert (tmp_path / "ck" / "cli" / "1_state.msgpack").exists()
    for d in ("res", "inf"):
        out = tmp_path / d / "cli" / "test_train_latest"
        assert {"0-fine-ori.png", "3-fine-depth-ori.npz"} <= set(
            os.listdir(out))
    assert (tmp_path / "inf" / "cli" / "test_train_latest" /
            "index.html").exists()
    shutil.rmtree(tmp_path / "ck")


def test_port_imports_none_of_the_replaced_libraries():
    files = sorted((REPO / "nerfsr_torch").rglob("*.py")) + \
        [REPO / "chip_smoke.py"]
    assert len(files) > 30
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            if isinstance(node, ast.Import):
                roots = {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                roots = {node.module.split(".")[0]}
            else:
                continue
            assert not roots & FORBIDDEN, (f, roots & FORBIDDEN)
