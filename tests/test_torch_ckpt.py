"""Checkpoints of the port against the JAX package, on the CPU.

- the port's msgpack codec (``nerfsr_torch/utils/msgpack.py``) against
  flax's serialization both ways, bit for bit, on JAX-shaped train states
  (plain, ``--grad_clip_val``, ``--fix_layers``), and on scalars;
- a JAX checkpoint loaded into the port, and one more step of each side
  on the same batch; a port checkpoint loaded by the JAX package;
- resume semantics: torn files, ``--init_weights``, ``--fix_layers``,
  and a ``--ckpt_backend orbax`` round trip (the orbax format itself is
  ``tests/test_torch_orbax.py``'s).
"""

import os

import flax.serialization as fs
import jax
import jax.numpy as jnp
import msgpack as ref_msgpack
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch's threads in a test worker)

from nerfsr_tpu.config import default_options as j_default_options
from nerfsr_tpu.models import create_model as j_create_model
from nerfsr_tpu.utils import checkpoint as j_ckpt
from nerfsr_tpu.utils.schedule import make_jax_lr_schedule

from nerfsr_torch.config import default_options
from nerfsr_torch.data.views import LLFFDownXTrainViews, LLFFDownXViews
from nerfsr_torch.models import create_model
from nerfsr_torch.utils import checkpoint as ckpt
from nerfsr_torch.utils import msgpack
from nerfsr_torch.weights import export_params, load_jax_params, param_leaves

HR_WH = (16, 12)
FOCAL = 14.0
# f32 updates of one Adam step from the same moments, per leaf,
# norm-relative: the two sides' gradients differ by summation order and
# the 2^9-frequency encodings (the gradient bar of test_torch_train.py)
UPDATE_REL = 2e-2
VARIANTS = {"plain": {}, "clip": dict(grad_clip_val=0.05),
            "fix_layers": dict(fix_layers="fine/params/xyz_encoding_1")}


def _kw(tmp_path=None, **extra):
    kw = dict(model="nerf_downX", dataset_mode="llff_downX",
              fast_preset="llff", img_wh=HR_WH, downscale=2,
              precision="f32", D=4, W=64, batch_size=48, n_epochs=4,
              n_epochs_decay=2, randomized=False, noise_std=0.0)
    if tmp_path is not None:
        kw.update(checkpoints_dir=str(tmp_path), name="ck")
    kw.update(extra)
    return kw


def _jax(tmp_path=None, **extra):
    opt = j_default_options("train", **_kw(tmp_path, **extra))
    system = j_create_model(opt)
    state = system.create_state(jax.random.PRNGKey(0), steps_per_epoch=4)
    return opt, system, state


def _port(tmp_path=None, **extra):
    opt = default_options("train", **_kw(tmp_path, **extra))
    system = create_model(opt, device="cpu")
    return opt, system, system.create_state(0, steps_per_epoch=4)


def _batch(seed=0):
    views = LLFFDownXViews.spiral(FOCAL, HR_WH, 2, 3, radii=(0.2, 0.2, .05))
    rng = np.random.RandomState(seed)
    imgs = (rng.rand(3, HR_WH[1], HR_WH[0], 3) * 255).astype(np.uint8)
    buf = LLFFDownXTrainViews(views.poses, imgs, FOCAL, HR_WH,
                              2).ray_buffer("cpu")
    n = (HR_WH[0] // 2) * (HR_WH[1] // 2)
    return {k: v[n:2 * n].numpy() for k, v in buf.items()}


def _leaves(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def _jax_trained_state(variant, steps=3):
    """A JAX train state after ``steps`` steps on explicit batches."""
    opt, system, state = _jax(**VARIANTS[variant])
    for s in range(steps):
        state, _ = system.train_step(state, _batch(s), jax.random.PRNGKey(s))
    return opt, system, state


# ---------------------------------------------------------------------
# the codec
# ---------------------------------------------------------------------

@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_flax_blob_decodes_and_reencodes_in_port(variant):
    _, _, state = _jax_trained_state(variant, steps=1)
    blob = fs.to_bytes(state)
    got = msgpack.unpackb(blob)
    want = fs.to_state_dict(jax.tree_util.tree_map(np.asarray, state))
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(want)
    for a, b in zip(_leaves(got), _leaves(want)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    assert msgpack.packb(got) == blob


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_port_blob_restores_through_flax(variant):
    _, _, state = _jax_trained_state(variant, steps=1)
    sd = jax.tree_util.tree_map(np.asarray, fs.to_state_dict(state))
    restored = fs.from_bytes(state, msgpack.packb(sd))
    for a, b in zip(_leaves(restored), _leaves(state)):
        np.testing.assert_array_equal(a, b)


def test_codec_scalars_and_torn_blobs():
    values = [None, True, False, 0, 127, 128, -32, -33, 255, 65536, -2 ** 40,
              2 ** 64 - 1, 1.5, "x" * 31, "y" * 40, "z" * 70000, b"b" * 300,
              list(range(17)), {f"k{i}": i for i in range(17)}]
    for v in values:
        blob = msgpack.packb(v)
        assert blob == ref_msgpack.packb(v, use_bin_type=True), v
        assert msgpack.unpackb(blob) == v
    for v in (np.float32(2.5), np.int64(-7), 3 - 4j,
              np.arange(6, dtype=np.int16).reshape(2, 3)):
        blob = fs.msgpack_serialize({"v": v})
        assert msgpack.packb({"v": v}) == blob
        np.testing.assert_array_equal(msgpack.unpackb(blob)["v"], v)
        assert type(msgpack.unpackb(blob)["v"]) is type(
            fs.msgpack_restore(blob)["v"])
    blob = fs.to_bytes({"w": np.ones((4, 4), np.float32)})
    for cut in (1, 7, len(blob) - 1):
        with pytest.raises(ValueError, match="truncated"):
            msgpack.unpackb(blob[:cut])
    with pytest.raises(ValueError, match="after its value"):
        msgpack.unpackb(blob + b"\x00")


# ---------------------------------------------------------------------
# checkpoints both ways
# ---------------------------------------------------------------------

def test_jax_checkpoint_loads_into_port_and_next_step_matches(tmp_path):
    jopt, jsys, jstate = _jax_trained_state("plain")
    jopt.checkpoints_dir, jopt.name = str(tmp_path), "ck"
    j_ckpt.save_checkpoint(jopt, jstate, 1)
    opt, system, state = _port(tmp_path)
    ckpt.load_checkpoint(opt, state, epoch=1)
    adam = jstate.opt_state[0]
    assert state.step == int(jstate.step) == int(adam.count) == 3
    mu = export_params_like(state, "exp_avg")
    nu = export_params_like(state, "exp_avg_sq")
    for got, want in ((export_params(state.params), jstate.params),
                      (mu, adam.mu), (nu, adam.nu)):
        for a, b in zip(_leaves(got), _leaves(want)):
            np.testing.assert_array_equal(a, b)   # bit for bit
    for path, p, _ in param_leaves(state.params):
        assert float(state.optimizer.state[p]["step"]) == 3.0, path

    # one more step of each on the same explicit batch
    batch = _batch(5)
    old = [np.array(x) for x in _leaves(jstate.params)]
    jstate, _ = jsys.train_step(jstate, batch, jax.random.PRNGKey(9))
    state, _ = system.train_step(
        state, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert state.step == int(jstate.step) == int(jstate.opt_state[0].count)
    for path, p, _ in param_leaves(state.params):
        assert float(state.optimizer.state[p]["step"]) == 4.0
    # the LR at count 3 (the port's schedule in f64, JAX's in f32)
    np.testing.assert_allclose(
        system.lr_fn(3), float(make_jax_lr_schedule(jopt, 4)(
            jnp.asarray(3))), rtol=1e-6)
    for a, b, o in zip(_leaves(export_params(state.params)),
                       _leaves(jstate.params), old):
        ua, ub = a - o, np.asarray(b) - o
        assert np.linalg.norm(ua - ub) <= UPDATE_REL * np.linalg.norm(ub)


def export_params_like(state, key):
    """An Adam moment of every parameter in the JAX layout."""
    tree = {}
    for path, p, is_kernel in param_leaves(state.params):
        net, _, layer, leaf = path.split("/")
        m = state.optimizer.state[p][key].numpy()
        tree.setdefault(net, {"params": {}})["params"].setdefault(
            layer, {})[leaf] = m.T if is_kernel else m
    return tree


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_port_checkpoint_loads_into_jax(tmp_path, variant):
    opt, system, state = _port(tmp_path, **VARIANTS[variant])
    for s in range(2):
        system.train_step(state, {k: torch.from_numpy(v)
                                  for k, v in _batch(s).items()})
    ckpt.save_checkpoint(opt, state, 1)
    jopt, _, template = _jax(tmp_path, **VARIANTS[variant])
    restored = j_ckpt.load_checkpoint(jopt, template, epoch=1)
    assert int(restored.step) == 2
    for a, b in zip(_leaves(restored.params),
                    _leaves(export_params(state.params))):
        np.testing.assert_array_equal(a, b)
    chain = restored.opt_state
    if variant == "fix_layers":
        chain = chain.inner_state
    adam = chain[1 if variant == "clip" else 0]
    assert int(adam.count) == 2
    frozen = ckpt.frozen_paths(opt, state.params)
    for key, tree in (("exp_avg", adam.mu), ("exp_avg_sq", adam.nu)):
        flat = {"/".join(str(k.key) for k in path): leaf for path, leaf in
                jax.tree_util.tree_leaves_with_path(tree)}
        for path, p, is_kernel in param_leaves(state.params):
            if path in frozen:
                assert path not in flat and p not in state.optimizer.state
                continue
            m = state.optimizer.state[p][key].numpy()
            np.testing.assert_array_equal(flat[path],
                                          m.T if is_kernel else m)


# ---------------------------------------------------------------------
# resume semantics
# ---------------------------------------------------------------------

def _step(system, state, seed):
    return system.train_step(state, {k: torch.from_numpy(v)
                                     for k, v in _batch(seed).items()})[0]


def test_torn_files_fall_back_to_the_newest_intact_epoch(tmp_path):
    opt, system, state = _port(tmp_path)
    saved = {}
    for epoch in (1, 2, 3):
        state = _step(system, state, epoch)
        ckpt.save_checkpoint(opt, state, epoch)
        saved[epoch] = export_params(state.params)
    d = os.path.join(str(tmp_path), "ck")
    for name in ("latest_state.msgpack", "3_state.msgpack"):
        with open(os.path.join(d, name), "r+b") as f:
            f.truncate(100)
    _, _, fresh = _port(tmp_path)
    ckpt.load_checkpoint(opt, fresh, epoch="latest")
    assert fresh.step == 2
    for a, b in zip(_leaves(export_params(fresh.params)),
                    _leaves(saved[2])):
        np.testing.assert_array_equal(a, b)
    opt.continue_train = True
    _, _, resumed = _port(tmp_path)
    assert ckpt.resume_if_requested(opt, resumed) == 2 and resumed.step == 2
    with pytest.raises(ValueError, match="truncated"):
        ckpt.load_checkpoint(opt, fresh, epoch=3)
    # no resume without --continue_train, nothing saved: epoch 0
    opt.continue_train, opt.name = False, "other"
    assert ckpt.resume_if_requested(opt, fresh) == 0


def test_init_weights_copies_only_matching_leaves(tmp_path):
    opt, system, src = _port(tmp_path)
    src = _step(system, src, 0)
    ckpt.save_checkpoint(opt, src, 4)
    opt2, _, dst = _port(tmp_path, name="dst", init_weights="ck:4",
                         init_weights_keys="fine/params/(rgb|sigma)/")
    before = {path: p.detach().clone()
              for path, p, _ in param_leaves(dst.params)}
    ckpt.init_weights_from(opt2, dst)
    copied = 0
    for (path, p, _), (_, q, _) in zip(param_leaves(dst.params),
                                       param_leaves(src.params)):
        if path.startswith(("fine/params/rgb/", "fine/params/sigma/")):
            assert torch.equal(p, q)
            copied += 1
        else:
            assert torch.equal(p, before[path]), path
    assert copied == 4


def test_fix_layers_freezes_leaves_moments_and_clip_norm_as_jax():
    """Frozen leaves get no update, no moments and no share of the clip's
    global norm (their gradients are made 100x larger, so a norm over
    them would change every trainable update). The trainable leaves match
    optax's masked chain on the same gradients. optax.masked passes the
    frozen leaves' raw gradients through as updates, so the JAX package
    moves them by +gradient: the port keeps them fixed."""
    extra = dict(fix_layers="fine/params/xyz_encoding_1",
                 grad_clip_val=0.05, lr=1e-2)
    jopt, jsys, jstate = _jax(**extra)
    opt, system, state = _port(**extra)
    tree = jax.tree_util.tree_map(np.array, jstate.params)
    load_jax_params(state.params, tree)
    frozen = ckpt.frozen_paths(opt, state.params)
    assert len(frozen) == 2
    j_params, j_opt = tree, jsys.tx.init(tree)
    rng = np.random.RandomState(4)
    raw_sum = 0.0
    for _ in range(3):
        grads = jax.tree_util.tree_map(
            lambda x: (rng.randn(*x.shape) * 0.01).astype(np.float32),
            j_params)
        grads["fine"]["params"]["xyz_encoding_1"] = jax.tree_util.tree_map(
            lambda g: g * 100, grads["fine"]["params"]["xyz_encoding_1"])
        raw_sum = raw_sum + grads["fine"]["params"]["xyz_encoding_1"][
            "kernel"]
        updates, j_opt = jsys.tx.update(grads, j_opt, j_params)
        j_params = jax.tree_util.tree_map(
            lambda p, u: np.asarray(p + u), j_params, updates)
        grad_module = load_jax_params(system.init_params(0), grads)
        for p, g in zip(state.params.parameters(),
                        grad_module.parameters()):
            p.grad = g.detach().clone()
        system._clip_grads(state.optimizer)
        for group in state.optimizer.param_groups:
            group["lr"] = system.lr_fn(state.step)
        state.optimizer.step()
        state.step += 1
    got = export_params(state.params)
    flat_got = {path: leaf for path, leaf in _paths(got)}
    for path, want in _paths(j_params):
        if path in frozen:
            np.testing.assert_array_equal(flat_got[path],
                                          _get(tree, path))
            continue
        np.testing.assert_allclose(flat_got[path], want, rtol=1e-5,
                                   atol=1e-6, err_msg=path)
    np.testing.assert_allclose(
        j_params["fine"]["params"]["xyz_encoding_1"]["kernel"],
        tree["fine"]["params"]["xyz_encoding_1"]["kernel"] + raw_sum,
        rtol=1e-5, atol=1e-6)
    for path, p, _ in param_leaves(state.params):
        assert (p in state.optimizer.state) == (path not in frozen)


def test_fix_layers_train_steps_keep_frozen_leaves(tmp_path):
    opt, system, state = _port(tmp_path,
                               fix_layers="prop/|fine/params/sigma/")
    before = {path: p.detach().clone()
              for path, p, _ in param_leaves(state.params)}
    for s in range(3):
        state = _step(system, state, s)
    frozen = ckpt.frozen_paths(opt, state.params)
    assert len(frozen) == 2 + 2 * 4      # sigma, and the 4 prop layers
    for path, p, _ in param_leaves(state.params):
        moved = not torch.equal(p, before[path])
        assert moved == (path not in frozen), path
    ckpt.save_checkpoint(opt, state, 1)
    _, _, again = _port(tmp_path, fix_layers="prop/|fine/params/sigma/")
    ckpt.load_checkpoint(opt, again, epoch=1)
    for (_, p, _), (_, q, _) in zip(param_leaves(again.params),
                                    param_leaves(state.params)):
        assert torch.equal(p, q)
    with pytest.raises(ValueError, match="fix_layers"):
        _, _, plain = _port(tmp_path)
        ckpt.load_checkpoint(default_options("train", **_kw(tmp_path)),
                             plain, epoch=1)


def test_orbax_backend_saves_resumes_and_reads_under_msgpack(tmp_path):
    opt, system, state = _port(tmp_path, ckpt_backend="orbax")
    state = _step(system, state, 0)
    path = ckpt.save_checkpoint(opt, state, 1)
    ckpt.wait_for_saves()
    assert path.endswith("1_state.orbax") and os.path.isdir(path)
    assert sorted(os.listdir(os.path.join(str(tmp_path), "ck"))) == [
        "1_state.orbax", "latest_state.orbax"]
    opt.continue_train = True
    _, _, resumed = _port(tmp_path)
    assert ckpt.resume_if_requested(opt, resumed) == 1 and resumed.step == 1
    for (_, p, _), (_, q, _) in zip(param_leaves(resumed.params),
                                    param_leaves(state.params)):
        assert torch.equal(p, q)
        for key in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(resumed.optimizer.state[p][key],
                               state.optimizer.state[q][key])
    # the orbax directory, read with the msgpack backend configured
    opt.ckpt_backend = "msgpack"
    _, _, again = _port(tmp_path)
    ckpt.load_checkpoint(opt, again, epoch=1)
    for (_, p, _), (_, q, _) in zip(param_leaves(again.params),
                                    param_leaves(state.params)):
        assert torch.equal(p, q)


def _paths(tree):
    return [("/".join(str(k.key) for k in path), np.asarray(leaf))
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)]


def _get(tree, path):
    for k in path.split("/"):
        tree = tree[k]
    return tree
