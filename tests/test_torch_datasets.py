"""The Blender and vanilla LLFF datasets and the Blender warm-up on the
CPU, against the JAX package and PIL:

- PIL's premultiplied resize of RGBA and LA images (``lanczos_resize``,
  ``premultiply``, ``unpremultiply``), to the byte;
- ``BlenderDataset`` and ``BlenderDownXDataset`` on RGBA scenes written
  with PIL here, in every mode and option (ds 2 and 4, ``lanc`` and
  ``avg``, ``--rand_dir``, a resize from a larger source, a crop window
  whose centre is not a multiple of ds): truth equal to the bit, rays
  within 1e-6;
- ``LLFFDataset`` on ``tools/make_synthetic_llff.py`` scenes in every
  mode, spheric and forward-facing, with and without ``--include_var``
  (the JAX package may build its rays with its host C++ raygen);
- ``write_blender_scene`` against ``tools/make_synthetic_scene.py``;
- the engine's ``train_crop`` warm-up: which buffer each step draws from,
  where the chunks end, a resume across the warm-up rebuilt to the byte;
- ``python -m nerfsr_torch.train_blender`` and ``.test`` end to end.
"""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch_threads  # noqa: F401  (torch's threads in a test worker)
from PIL import Image

from nerfsr_tpu.config import default_options as j_default_options
from nerfsr_tpu.data import create_dataset as j_create_dataset

from nerfsr_torch import engine
from nerfsr_torch.config import default_options
from nerfsr_torch.data import create_dataset, synthetic
from nerfsr_torch.data.downx_common import (blend_white, lanczos_resize,
                                            premultiply, unpremultiply)
from nerfsr_torch.models.nerf_system import NeRFSystem
from nerfsr_torch.utils import png

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
from tools import make_synthetic_scene as tool_scene  # noqa: E402
from tools.make_synthetic_llff import make_llff_scene  # noqa: E402

RAY_ATOL = 1e-6


# ---------------------------------------------------------------------
# premultiplied Lanczos
# ---------------------------------------------------------------------

def _alpha_image(rng, h, w, c):
    """Random uint8 pixels whose alpha is 0, 255 or in between, a third
    of each."""
    img = (rng.rand(h, w, c) * 256).astype(np.uint8)
    pick = rng.randint(0, 3, (h, w))
    img[..., -1] = np.where(pick == 0, 0, np.where(pick == 1, 255,
                                                   img[..., -1]))
    return img


def test_premultiply_is_pils_conversion():
    v, a = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    for mode, pm, chans in (("RGBA", "RGBa", [v, v // 2, 255 - v, a]),
                            ("LA", "La", [v, a])):
        img = np.stack(chans, -1).astype(np.uint8)
        np.testing.assert_array_equal(
            premultiply(img),
            np.asarray(Image.fromarray(img, mode).convert(pm)))
        np.testing.assert_array_equal(
            unpremultiply(img),
            np.asarray(Image.fromarray(img, pm).convert(mode)))


@pytest.mark.parametrize("src,dst", [((40, 40), (20, 20)),
                                     ((63, 47), (31, 23)),
                                     ((800, 800), (200, 200)),
                                     ((30, 22), (47, 41)),
                                     ((33, 50), (33, 17))])
def test_lanczos_with_alpha_is_pils_bytes(src, dst):
    rng = np.random.RandomState(sum(src))
    w, h = src
    for mode, c in (("RGBA", 4), ("LA", 2)):
        img = _alpha_image(rng, h, w, c)
        want = np.asarray(Image.fromarray(img, mode).resize(
            dst, Image.LANCZOS))
        np.testing.assert_array_equal(lanczos_resize(img, dst), want,
                                      err_msg=mode)


# ---------------------------------------------------------------------
# the Blender datasets
# ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def blender_scene(tmp_path_factory):
    """An RGBA NeRF-synthetic scene written with PIL: 40x40 images of
    random colour over soft, empty and opaque alpha; 3 train, 9 val (the
    split is capped at 8), 2 test frames on the sphere of cameras."""
    d = tmp_path_factory.mktemp("blender")
    rng = np.random.RandomState(0)
    poses = synthetic.blender_poses(14)
    idx = 0
    for split, n in (("train", 3), ("val", 9), ("test", 2)):
        (d / split).mkdir()
        frames = []
        for _ in range(n):
            yy, xx = np.mgrid[:40, :40]
            img = _alpha_image(rng, 40, 40, 4)
            img[..., 3] = np.where(np.hypot(yy - 20, xx - 20) > 17, 0,
                                   img[..., 3])
            Image.fromarray(img, "RGBA").save(d / split / f"r_{idx}.png")
            frames.append({"file_path": f"./{split}/r_{idx}",
                           "transform_matrix": np.concatenate(
                               [poses[idx], [[0, 0, 0, 1.0]]]).tolist()})
            idx += 1
        (d / f"transforms_{split}.json").write_text(json.dumps(
            {"camera_angle_x": 0.69, "frames": frames}))
    return str(d)


def _same(got, want):
    """Port and JAX samples: the truth to the bit, rays within 1e-6. The
    JAX buffers' ``viewdirs`` field is their ``directions``; the port's
    training buffers leave it out."""
    if "viewdirs" in want and "viewdirs" not in got:
        np.testing.assert_array_equal(want["viewdirs"], want["directions"])
        want = {k: v for k, v in want.items() if k != "viewdirs"}
    assert set(got) == set(want)
    for k, v in want.items():
        if v is None:
            assert got[k] is None
        elif k.startswith("rgbs") or k == "valid_mask":
            np.testing.assert_array_equal(got[k], v, err_msg=k)
        else:
            np.testing.assert_allclose(got[k], v, rtol=0, atol=RAY_ATOL,
                                       err_msg=k)


BLENDER_CASES = {
    "blender": dict(dataset_mode="blender", img_wh=(24, 24)),
    "blender-source-size": dict(dataset_mode="blender", img_wh=(40, 40),
                                precrop_frac=0.3),
    "x2-lanc": dict(dataset_mode="blender_downX", downscale=2,
                    img_wh=(24, 24)),
    "x4-lanc-rand-dir": dict(dataset_mode="blender_downX", downscale=4,
                             img_wh=(32, 32), rand_dir=True),
    "x4-avg": dict(dataset_mode="blender_downX", downscale=4,
                   img_wh=(40, 40), ds_method="avg"),
    # h // 2 = 22 and w // 2 = 18, neither a multiple of 4: the window's
    # start is rounded down to a block
    "x4-crop-off-block": dict(dataset_mode="blender_downX", downscale=4,
                              img_wh=(36, 44), precrop_frac=0.6),
    "x2-avg-rand-dir": dict(dataset_mode="blender_downX", downscale=2,
                            img_wh=(30, 26), ds_method="avg", rand_dir=True,
                            seed=5),
}


@pytest.mark.parametrize("case", sorted(BLENDER_CASES))
def test_blender_datasets_match_jax_in_every_mode(blender_scene, case):
    kw = dict(model="nerf", dataset_root=blender_scene,
              **BLENDER_CASES[case])
    if kw["dataset_mode"] == "blender_downX":
        kw["model"] = "nerf_downX"
    opt, jopt = default_options("train", **kw), j_default_options("train",
                                                                   **kw)
    assert opt.white_bkgd and opt.noise_std == 0.0
    for mode in ("train", "train_crop", "val", "test", "test_train"):
        ds, jds = create_dataset(opt, mode), j_create_dataset(jopt, mode)
        assert len(ds) == len(jds) == {"val": 8, "test": 2}.get(mode, 3)
        assert ds.depth_bounds == jds.depth_bounds == (2.0, 6.0)
        assert ds.focal == jds.focal
        np.testing.assert_array_equal(ds.eval_dirs(), jds.eval_dirs())
        if mode in ("train", "train_crop"):
            buf = ds.ray_buffer()
            _same(buf, jds.ray_buffer())
            if mode == "train_crop":
                assert len(buf["rgbs"]) < len(create_dataset(
                    opt, "train").ray_buffer()["rgbs"])
            continue
        for i in {0, len(ds) - 1}:
            _same(ds.image_rays(i), jds.image_rays(i))
            spec, jspec = ds.eval_raygen_spec(i), jds.eval_raygen_spec(i)
            assert spec["geom"] == jspec["geom"] == ("world", 2.0, 6.0)
            np.testing.assert_array_equal(spec["c2w"], jspec["c2w"])


def test_blender_truth_is_blended_after_the_resize(blender_scene):
    """The LR truth and HR truth of one frame by hand: PIL's resize of
    the RGBA file, then the blend over white."""
    opt = default_options("train", model="nerf_downX",
                          dataset_mode="blender_downX",
                          dataset_root=blender_scene, img_wh=(24, 24),
                          downscale=2)
    sample = create_dataset(opt, "test_train").image_rays(1)
    src = Image.open(os.path.join(blender_scene, "train", "r_1.png"))
    hr = src.resize((24, 24), Image.LANCZOS)
    lr = hr.resize((12, 12), Image.LANCZOS)
    np.testing.assert_array_equal(
        sample["rgbs"],
        blend_white(np.asarray(lr, np.float32) / 255.0).reshape(-1, 3))
    assert sample["rgbs_ori"].shape == (144, 4, 3)


def test_blender_dataset_refusals(blender_scene):
    kw = dict(model="nerf", dataset_mode="blender",
              dataset_root=blender_scene, img_wh=(24, 24))
    opt = default_options("train", **kw)
    # patch mode's image_buffer is ported: the JAX dataset's, to the bit
    # for the truth; only the train split has one
    _same(create_dataset(opt, "train").image_buffer(),
          j_create_dataset(j_default_options("train", **kw),
                           "train").image_buffer())
    with pytest.raises(ValueError, match="train split"):
        create_dataset(opt, "val").image_buffer()
    with pytest.raises(ValueError, match="modes"):
        create_dataset(opt, "test_viewdir")
    with pytest.raises(ValueError, match="train split"):
        create_dataset(opt, "val").ray_buffer()


# ---------------------------------------------------------------------
# the vanilla LLFF dataset
# ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def llff_scene(tmp_path_factory):
    d = tmp_path_factory.mktemp("llff")
    make_llff_scene(str(d), hw=(24, 32), n_imgs=5)
    return str(d)


@pytest.mark.parametrize("option", ["plain", "spheric", "include_var",
                                    "resize"])
def test_llff_dataset_matches_jax_in_every_mode(llff_scene, option):
    extra = {"plain": {}, "spheric": dict(spheric_poses=True),
             "include_var": dict(include_var=True),
             "resize": dict(img_wh=(16, 12), use_pixel_centers=False)}
    kw = dict(model="nerf", dataset_mode="llff", dataset_root=llff_scene,
              img_wh=(32, 24))
    kw.update(extra[option])
    opt, jopt = default_options("train", **kw), j_default_options("train",
                                                                   **kw)
    assert not opt.white_bkgd and opt.noise_std == 1.0
    for mode in ("train", "val", "test", "test_train", "test_viewdir"):
        ds, jds = create_dataset(opt, mode), j_create_dataset(jopt, mode)
        assert len(ds) == len(jds) and ds.val_idx == jds.val_idx
        assert ds.depth_bounds == jds.depth_bounds
        np.testing.assert_array_equal(ds.eval_dirs(), jds.eval_dirs())
        if mode == "train":
            _same(ds.ray_buffer(), jds.ray_buffer())
            continue
        for i in {0, 10 % len(ds), len(ds) - 1}:
            _same(ds.image_rays(i), jds.image_rays(i))
            spec, jspec = ds.eval_raygen_spec(i), jds.eval_raygen_spec(i)
            assert spec["geom"] == jspec["geom"]
            for k in ("c2w", "vd_c2w"):
                np.testing.assert_array_equal(spec[k], jspec[k])
    # the auxiliary paths' buffers: the reference view's HR rays
    # (--with_ref) and the training rays image by image (patch mode)
    ds, jds = create_dataset(opt, "train"), j_create_dataset(jopt, "train")
    ref, jref = ds.ref_buffer(), jds.ref_buffer()
    assert set(ref) == set(jref)
    _same({k: v for k, v in ref.items() if k != "viewdirs"},
          {k: v for k, v in jref.items() if k != "viewdirs"})
    np.testing.assert_array_equal(ref["viewdirs"], ref["directions"])
    _same(ds.image_buffer(), jds.image_buffer())


# ---------------------------------------------------------------------
# the Blender scene the port writes
# ---------------------------------------------------------------------

def test_write_blender_scene_matches_the_tool(tmp_path):
    """The torch blob renderer against the tool's numpy ``render_view``,
    the cameras against the tool's, and the RGBA files against the
    render they store."""
    hw, focal = (20, 24), 26.0
    poses = synthetic.blender_poses(14)
    for c2w in poses[:2]:
        np.testing.assert_allclose(c2w, tool_scene.look_at_pose(c2w[:, 3]),
                                   atol=1e-12)
        colour, opacity = synthetic.render_blob_view(c2w, hw, focal)
        want = tool_scene.render_view(c2w, hw, focal)
        np.testing.assert_allclose(
            np.clip(colour + 1 - opacity[..., None], 0, 1), want, atol=1e-5)
        assert 0.02 < opacity.mean() < 0.98
    synthetic.write_blender_scene(str(tmp_path / "port"), hw=(16, 16),
                                  n_train=3, n_val=2, n_test=2)
    tool_scene.make_scene(str(tmp_path / "tool"), hw=(16, 16), n_train=3)
    w = 16
    focal = 0.5 * w / np.tan(0.5 * synthetic.CAMERA_ANGLE_X)
    for split in ("train", "val", "test"):
        port = json.loads((tmp_path / "port" /
                           f"transforms_{split}.json").read_text())
        tool = json.loads((tmp_path / "tool" /
                           f"transforms_{split}.json").read_text())
        assert port["camera_angle_x"] == tool["camera_angle_x"]
        assert [f["file_path"] for f in port["frames"]] == \
            [f["file_path"] for f in tool["frames"]]
        for f, g in zip(port["frames"], tool["frames"]):
            c2w = np.array(f["transform_matrix"])
            np.testing.assert_allclose(c2w, g["transform_matrix"],
                                       atol=1e-12)
            img = png.read(str(tmp_path / "port" / f"{f['file_path']}.png"))
            assert img.mode == "RGBA"
            rgba = img.pixels.astype(np.float32) / 255.0
            colour, opacity = synthetic.render_blob_view(c2w[:3], (16, 16),
                                                         focal)
            np.testing.assert_array_equal(
                img.pixels, synthetic.rgba_pixels(colour, opacity))
            # over white: the render, within the two 8-bit roundings
            np.testing.assert_allclose(
                blend_white(rgba), np.clip(colour + 1 - opacity[..., None],
                                           0, 1), atol=1.5 / 255)


# ---------------------------------------------------------------------
# the train_crop warm-up
# ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def blob_scene(tmp_path_factory):
    d = tmp_path_factory.mktemp("blobs")
    synthetic.write_blender_scene(str(d), hw=(32, 32), n_train=3, n_val=1,
                                  n_test=2)
    return str(d)


def _warm_kw(scene, tmp_path, **extra):
    kw = dict(name="warm", model="nerf_downX", dataset_mode="blender_downX",
              dataset_root=scene, img_wh=(16, 16), downscale=2,
              N_coarse=8, N_importance=8, precision="f32", D=2, W=16,
              batch_size=8, n_epochs=2, steps_per_epoch=6, scan_steps=4,
              save_epoch_freq=1, val_epoch_freq=1, val_freq=0,
              vis_epoch_freq=0, print_freq=1, device="cpu",
              checkpoints_dir=str(tmp_path / "ck"),
              summary_dir=str(tmp_path / "runs"))
    kw.update(extra)
    return kw


def _recorded_train(monkeypatch, opt, **train_kw):
    """Run ``engine.train``, recording each chunk's (first step, steps),
    the route it took (``train_steps``: eager, ``train_steps_scan``: one
    graph replay a step on the card) and each step's buffer size."""
    chunks, routes, sizes = [], [], []
    real_sample = NeRFSystem.sample_batch

    def recorder(name):
        real = getattr(NeRFSystem, name)

        def run(self, state, buffer, n_steps, generator=None):
            chunks.append((state.step, n_steps))
            routes.append(name)
            return real(self, state, buffer, n_steps, generator)
        return run

    def sample_batch(self, buffer, generator=None):
        sizes.append(len(buffer["rgbs"]))
        return real_sample(self, buffer, generator)
    for name in ("train_steps", "train_steps_scan"):
        monkeypatch.setattr(NeRFSystem, name, recorder(name))
    monkeypatch.setattr(NeRFSystem, "sample_batch", sample_batch)
    state = engine.train(opt, **train_kw)
    monkeypatch.undo()
    return state, chunks, routes, sizes


def test_warmup_draws_from_the_crop_buffer_and_ends_a_chunk(
        blob_scene, tmp_path, monkeypatch):
    opt = default_options("train", **_warm_kw(blob_scene, tmp_path))
    n_full = len(create_dataset(opt, "train").ray_buffer()["rgbs"])
    n_crop = len(create_dataset(opt, "train_crop").ray_buffer()["rgbs"])
    assert n_crop == 3 * 4 * 4 < n_full == 3 * 8 * 8
    state, chunks, routes, sizes = _recorded_train(
        monkeypatch, opt, warmup_mode="train_crop", warmup_iters=8)
    assert state.step == 12
    # the warm-up ends inside epoch 2, off a --scan_steps boundary
    assert chunks == [(0, 4), (4, 2), (6, 2), (8, 2), (10, 2)]
    assert sizes == [n_crop] * 8 + [n_full] * 4
    # the warm-up's chunks run eagerly, the rest as the JAX engine scans
    assert routes == ["train_steps"] * 3 + ["train_steps_scan"] * 2
    # without a warm-up the chunks are the --scan_steps grid
    opt2 = default_options("train", **_warm_kw(
        blob_scene, tmp_path, name="plain"))
    _, chunks, routes, sizes = _recorded_train(monkeypatch, opt2)
    assert chunks == [(0, 4), (4, 2), (6, 4), (10, 2)]
    assert sizes == [n_full] * 12
    assert routes == ["train_steps_scan"] * 4


def test_resume_across_the_warmup_rebuilds_the_epoch(blob_scene, tmp_path):
    """Epoch 2 (steps 6-12) crosses the end of the warm-up at step 8: a
    rerun from epoch 1 rebuilds its checkpoint to the byte. Randomized
    rendering on: the draws follow (seed, step)."""
    kw = _warm_kw(blob_scene, tmp_path)
    engine.train(default_options("train", **kw), warmup_mode="train_crop",
                 warmup_iters=8)
    d = tmp_path / "ck" / "warm"
    epoch2 = (d / "2_state.msgpack").read_bytes()
    (d / "2_state.msgpack").unlink()
    (d / "latest_state.msgpack").unlink()
    again = default_options("train", **dict(
        kw, continue_train=True, load_epoch="1",
        summary_dir=str(tmp_path / "runs2")))
    state = engine.train(again, warmup_mode="train_crop", warmup_iters=8)
    assert state.step == 12
    assert (d / "2_state.msgpack").read_bytes() == epoch2


def test_train_blender_and_test_run_end_to_end(blob_scene, tmp_path):
    common = ["--name", "cli", "--model", "nerf_downX", "--dataset_mode",
              "blender_downX", "--dataset_root", blob_scene, "--img_wh",
              "16", "16", "--downscale", "2", "--N_coarse", "8",
              "--N_importance", "8", "--precision", "f32", "--D", "2",
              "--W", "16", "--device", "cpu", "--checkpoints_dir",
              str(tmp_path / "ck")]
    runs = [("train_blender", ["--batch_size", "8", "--n_epochs", "1",
                               "--steps_per_epoch", "3", "--val_freq", "0",
                               "--summary_dir", str(tmp_path / "runs")]),
            ("test", ["--results_dir", str(tmp_path / "res")])]
    logs = []
    for entry, extra in runs:
        res = subprocess.run([sys.executable, "-m", f"nerfsr_torch.{entry}",
                              *common, *extra], cwd=REPO, check=True,
                             timeout=300, capture_output=True, text=True)
        logs.append(res.stdout)
    assert "the first 1000 steps draw from train_crop" in logs[0]
    assert (tmp_path / "ck" / "cli" / "1_state.msgpack").exists()
    out = tmp_path / "res" / "cli" / "test_latest"
    assert {"0-fine-ori.png", "1-fine-depth-ori.npz", "0-coarse.png",
            "fine.gif"} <= set(os.listdir(out))
