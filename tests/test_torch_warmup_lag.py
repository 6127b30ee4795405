"""The fine level after the Blender ``train_crop`` warm-up, the port's
engine against the JAX package's, on the CPU at a small width.

On a Blender scene, a run whose first steps draw from the centre crop
ends with its fine level behind its coarse one on whole views; a run
without the warm-up does not. Both packages train here with the same
flags and the same warm-up (with their own random streams). Then:

- the port's epoch checkpoint, read by the JAX system, gives the port's
  coarse_mse and fine_mse on one fixed batch of whole views (the
  checkpoints are interchangeable, so both evaluate the same weights);
- the fine-to-coarse MSE ratio of the port's run and of the JAX run
  lie on the same side of 1: above it after the warm-up (the fine level
  lags), below it without one. The two runs draw other random batches,
  so their ratios are not held closer than that (seen here: 1.54 and
  3.53 after the warm-up, 0.43 and 0.68 without).
"""

import copy

import jax
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch's threads in a test worker)

from nerfsr_tpu import engine as j_engine
from nerfsr_tpu.config import default_options as j_default_options
from nerfsr_tpu.models import create_model as j_create_model
from nerfsr_tpu.utils import checkpoint as j_ckpt

from nerfsr_torch import engine
from nerfsr_torch.config import default_options
from nerfsr_torch.data import create_dataset
from nerfsr_torch.data.synthetic import write_blender_scene
from nerfsr_torch.models import create_model

# one f32 evaluation of trained weights in two summation orders; the
# fine level's MSE is small, so its relative error is the larger
LOSS_RTOL = 1e-4
WARMUP, STEPS, EPOCHS = 50, 100, 2


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    d = tmp_path_factory.mktemp("blender")
    write_blender_scene(str(d), hw=(128, 128), n_train=8, n_val=1, n_test=1)
    return str(d)


def _kw(scene, tmp_path, name):
    return dict(name=name, model="nerf", dataset_mode="blender",
                dataset_root=scene, img_wh=(32, 32), N_coarse=32,
                N_importance=32, D=4, W=64, batch_size=256,
                n_epochs=EPOCHS, steps_per_epoch=STEPS, n_epochs_decay=0,
                precision="f32", val_freq=0, val_epoch_freq=0,
                vis_epoch_freq=0, print_freq=STEPS, scan_steps=20,
                checkpoints_dir=str(tmp_path / "ck"),
                summary_dir=str(tmp_path / "runs"))


def _fixed_batch(opt):
    """1024 rays of whole training views, every k-th of the buffer."""
    buf = create_dataset(opt, "train").ray_buffer()
    k = len(buf["rgbs"]) // 1024
    return {key: np.ascontiguousarray(v[::k][:1024])
            for key, v in buf.items()}


def _eval_opt(opt):
    opt = copy.copy(opt)
    opt.randomized, opt.noise_std = False, 0.0
    return opt


def _port_mses(opt, params, batch):
    system = create_model(_eval_opt(opt), device="cpu")
    with torch.no_grad():
        _, losses = system._loss_fn(
            params, {k: torch.from_numpy(v) for k, v in batch.items()})
    return float(losses["coarse_mse"]), float(losses["fine_mse"])


def _jax_mses(jopt, params, batch):
    _, losses = j_create_model(_eval_opt(jopt))._loss_fn(
        params, batch, jax.random.PRNGKey(0), 0)
    return float(losses["coarse_mse"]), float(losses["fine_mse"])


@pytest.mark.parametrize("warm", [True, False], ids=["warmup", "no-warmup"])
def test_fine_level_after_the_warmup_matches_jax(scene, tmp_path, warm):
    opt = default_options("train", device="cpu",
                          **_kw(scene, tmp_path, "port"))
    jopt = j_default_options("train", **_kw(scene, tmp_path, "jax"))
    warmup = dict(warmup_mode="train_crop" if warm else None,
                  warmup_iters=WARMUP)
    state = engine.train(opt, **warmup)
    jstate = j_engine.train(jopt, **warmup)
    assert state.step == int(jstate.step) == EPOCHS * STEPS

    batch = _fixed_batch(opt)
    port = _port_mses(opt, state.params, batch)
    # the port's epoch checkpoint in the JAX system: the same losses
    read = copy.copy(jopt)
    read.name = "port"
    template = j_create_model(jopt).create_state(jax.random.PRNGKey(0),
                                                 STEPS)
    loaded = j_ckpt.load_checkpoint(read, template, epoch=EPOCHS)
    np.testing.assert_allclose(_jax_mses(jopt, loaded.params, batch), port,
                               rtol=LOSS_RTOL)

    coarse, fine = _jax_mses(jopt, jstate.params, batch)
    ours, theirs = port[1] / port[0], fine / coarse
    assert (ours > 1) == (theirs > 1) == warm, (ours, theirs)
