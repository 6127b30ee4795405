"""The auxiliary training paths through the port's engine on the CPU
(``engine.train``, as ``python -m nerfsr_torch.train`` runs it), against
the JAX engine where a tiny run is cheap:

- ``--with_ref`` (``--ref_freq 2``): both engines train from the same
  flags; the step counts and the losses they log agree in name, and the
  port's losses are finite; patch mode logs its patch losses (held to
  JAX's step in ``tests/test_torch_aux_steps.py``);
- ``--with_netD`` and ``--reg_patch``: the GAN and TV updates fire at
  the JAX engine's cadence and each counts as a step, graphed chunks
  (``--scan_steps`` > 1) and single dispatch (``--scan_steps 1``) alike;
  the discriminator is not checkpointed (nor is it by the JAX package);
- a resume of a patch-mode and a with-ref run rebuilds the unbroken
  run's checkpoint to the byte.
"""

import json
import os
import pathlib
import sys

import numpy as np
import pytest
import torch_threads  # noqa: F401  (torch's threads in a test worker)

from nerfsr_tpu import engine as j_engine
from nerfsr_tpu.config import default_options as j_default_options

from nerfsr_torch import engine
from nerfsr_torch import train as train_entry
from nerfsr_torch.config import default_options
from nerfsr_torch.models.criterions import write_synthetic_vgg_npz
from nerfsr_torch.utils import msgpack

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
from tools.make_synthetic_llff import make_llff_scene  # noqa: E402

STEPS = 6


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    d = tmp_path_factory.mktemp("llff")
    make_llff_scene(str(d), hw=(48, 64), n_imgs=4)
    return str(d)


DOWNX = dict(model="nerf_downX", dataset_mode="llff_downX", downscale=2,
             fast_preset="llff", batch_size=16)
PATHS = {
    "patch": dict(model="nerf", dataset_mode="llff", fast_preset="parity",
                  N_coarse=8, N_importance=8, batch_size=128,
                  patch_size=8, lambda_coarse_depth_lap=0.1,
                  lambda_fine_depth_lap=0.1),
    "with_ref": dict(DOWNX, with_ref=True, ref_freq=2),
    "with_netD": dict(DOWNX, with_netD=True, gan_iter=3, patch_len=32,
                      ndf_dis=8),
    "reg_patch": dict(DOWNX, reg_patch=True, reg_patch_freq=2),
}


def _kw(scene, tmp_path, path, **extra):
    kw = dict(dataset_root=scene, img_wh=(64, 48), precision="f32", D=2,
              W=32, name=path, checkpoints_dir=str(tmp_path / "ck"),
              summary_dir=str(tmp_path / "runs"), n_epochs=1,
              steps_per_epoch=STEPS, scan_steps=3, val_freq=0,
              val_epoch_freq=0, vis_epoch_freq=0, print_freq=3,
              save_epoch_freq=1)
    kw.update(PATHS[path])
    kw.update(extra)
    return kw


def _logged(runs_dir, name):
    """{tag: value} of the last logged train losses."""
    out = {}
    with open(os.path.join(runs_dir, name, "metrics.jsonl")) as f:
        for line in f:
            rec = json.loads(line)
            if rec["tag"].startswith("train/") and \
                    rec["tag"] not in ("train/rays_per_sec",
                                       "train/tflops"):
                out[rec["tag"][6:]] = rec["value"]
    return out


def test_with_ref_run_matches_the_jax_engine(scene, tmp_path):
    """Both engines from the same flags (``--ref_freq 2``, chunks of 3):
    the same step count and logged losses, the port's finite."""
    kw = _kw(scene, tmp_path, "with_ref")
    state = engine.train(default_options("train", device="cpu", **kw))
    jkw = dict(kw, summary_dir=str(tmp_path / "jruns"),
               checkpoints_dir=str(tmp_path / "jck"))
    jstate = j_engine.train(j_default_options("train", **jkw))
    assert state.step == int(jstate.step) == STEPS
    got, want = _logged(tmp_path / "runs", "with_ref"), \
        _logged(tmp_path / "jruns", "with_ref")
    assert set(got) == set(want) and "ref_fine_mse" in got
    assert all(np.isfinite(v) for v in got.values())


@pytest.mark.parametrize("scan_steps", [3, 1])
def test_patch_mode_runs_through_the_engine(scene, tmp_path, scan_steps):
    """Patch mode from an image buffer: the losses
    ``tests/test_torch_aux_steps.py`` holds to JAX's
    ``train_step_patches`` are logged and finite, in chunks and single
    steps; a dataset without ``image_buffer`` (llff_downX) trains flat,
    as the JAX engine decides."""
    kw = _kw(scene, tmp_path, "patch", scan_steps=scan_steps)
    state = engine.train(default_options("train", device="cpu", **kw))
    assert state.step == STEPS
    got = _logged(tmp_path / "runs", "patch")
    assert {"coarse_depth_lap", "fine_depth_lap", "coarse_mse",
            "fine_mse"} <= set(got)
    assert all(np.isfinite(v) for v in got.values())
    kw = _kw(scene, tmp_path, "with_ref", name="flat", with_ref=False,
             patch_size=8)
    assert engine.train(default_options("train", device="cpu",
                                        **kw)).step == STEPS
    assert "coarse_depth_lap" not in _logged(tmp_path / "runs", "flat")


@pytest.mark.parametrize("scan_steps", [3, 1])
@pytest.mark.parametrize("path", ["with_netD", "reg_patch", "both"])
def test_gan_and_reg_fire_at_the_jax_engines_cadence(scene, tmp_path, path,
                                                     scan_steps):
    """Two epochs of 6 main steps. The GAN fires after every main step
    that is a multiple of ``--gan_iter`` once the epoch passes
    ``--start_epoch`` (1 here: only in epoch 2), the TV update after every
    multiple of ``--reg_patch_freq``; each is a step. The JAX engine
    counts the same: 6 + 2 + 3 = 11 main, GAN and TV steps for one epoch
    of the ``both`` flags (its ``train_steps_scan_gan``), measured."""
    extra = dict(n_epochs=2, start_epoch=1, scan_steps=scan_steps)
    if path == "both":
        kw = _kw(scene, tmp_path, "with_netD", reg_patch=True,
                 reg_patch_freq=2, **extra)
    else:
        kw = _kw(scene, tmp_path, path, **extra)
    state = engine.train(default_options("train", device="cpu", **kw))
    gan = 2 if path != "reg_patch" else 0       # epoch 2: main steps 9, 12
    reg = 6 if path != "with_netD" else 0       # 2, 4, ..., 12
    assert state.step == 2 * STEPS + gan + reg
    logged = _logged(tmp_path / "runs", kw["name"])
    assert ("G_GAN" in logged) == (gan > 0)
    assert ("patch" in logged) == (reg > 0)
    assert all(np.isfinite(v) for v in logged.values())
    # the checkpoint holds the NeRF's state only: no discriminator
    ck = msgpack.unpackb((tmp_path / "ck" / kw["name"] /
                          "2_state.msgpack").read_bytes())
    assert int(ck["step"]) == state.step
    assert not any("SpectralNorm" in k for k in _flat_keys(ck))


def _flat_keys(tree, prefix=""):
    for k, v in tree.items():
        yield f"{prefix}/{k}"
        if isinstance(v, dict):
            yield from _flat_keys(v, f"{prefix}/{k}")


@pytest.mark.parametrize("path", ["patch", "with_ref"])
def test_aux_resume_rebuilds_the_epoch_bit_for_bit(scene, tmp_path, path,
                                                   tmp_path_factory):
    """Two epochs saved each, epoch 2's files removed, a rerun from
    epoch 1 through the entry point: the same checkpoint bytes
    (randomized rendering and sigma noise on; the draws follow (seed,
    step)). Patch mode at 32 px with the VGG loss."""
    extra = dict(n_epochs=2, noise_std=1.0)
    if path == "patch":
        vgg = write_synthetic_vgg_npz(str(tmp_path / "vgg.npz"))
        extra.update(patch_size=32, batch_size=1024, lambda_fine_vgg=0.1,
                     vgg_weights=vgg)
    kw = _kw(scene, tmp_path, path, **extra)
    engine.train(default_options("train", device="cpu", **kw))
    d = tmp_path / "ck" / path
    epoch2 = (d / "2_state.msgpack").read_bytes()
    (d / "2_state.msgpack").unlink()
    (d / "latest_state.msgpack").unlink()
    argv = []
    for k, v in dict(kw, device="cpu", continue_train=True,
                     load_epoch="1").items():
        if isinstance(v, bool):
            argv += [f"--{k}"] if v else []
        elif isinstance(v, (tuple, list)):
            argv += [f"--{k}", *map(str, v)]
        else:
            argv += [f"--{k}", str(v)]
    train_entry.main(argv)
    assert (d / "2_state.msgpack").read_bytes() == epoch2
