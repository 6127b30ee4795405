"""The refine stage's GAN mode (``--refine_as_gan``) on the CPU, against
the JAX package from the same weights, inputs and draws:

- the host pix2pix pool (``utils/image_pool.py``) against JAX's, bit for
  bit, over a stream of query batches;
- the device pool (``RefineSystem._pool_query``) fed JAX's draws against
  JAX's ``_pool_query``, exactly;
- the single-step route with the host pool (``gan_fakes``, ``ImagePool``,
  ``gan_train_step``) against the JAX engine's host route over 3 steps;
- D at ``--patch_len 64``'s depth across the weight bridge both ways;
- one update pair against JAX's ``_gan_step_impl`` (a small UNet and D at
  32 px, with and without pool fakes): the four losses, each leaf of G
  and of D by ``tests/test_torch_aux_steps.py``'s one-step rule, the
  spectral norm's statistics, and batch norm's running values, which
  move once a step as JAX's ``batch_stats`` do;
- the chunk (``train_steps_scan_gan``) with every host read made to
  raise, and equal to its single steps (``gan_fakes``, the pool, then
  ``gan_train_step``) bit for bit;
- ``train_refine --refine_as_gan`` through the entry point with a
  resume, which starts D and the pool afresh as the JAX engine does.
"""

import contextlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch_threads  # noqa: F401  (torch's threads in a test worker)

from nerfsr_tpu.config import default_options as j_default_options
from nerfsr_tpu.models import create_model as j_create_model
from nerfsr_tpu.models.refine_system import RefineState as JRefineState
from nerfsr_tpu.utils.image_pool import ImagePool as JImagePool
from nerfsr_tpu.utils.schedule import make_jax_lr_schedule

from nerfsr_torch import train_refine as train_refine_entry
from nerfsr_torch.config import default_options
from nerfsr_torch.data.synthetic import write_llff_scene
from nerfsr_torch.data.llff import center_poses, spiral_path
from nerfsr_torch.models import create_model
from nerfsr_torch.utils.image_pool import ImagePool
from nerfsr_torch.utils import png
from nerfsr_torch.weights import (discriminator_leaves, export_discriminator,
                                  export_variables, load_discriminator,
                                  to_flax_layout, variable_leaves)

LR = 1e-5
# the losses: f32 convolutions in another summation order (oneDNN against
# XLA) through G and D
LOSS_RTOL = 1e-5
# batch norm's running values after the step: 0.1 of the batch's
# statistics, which agree to NET_ABS of tests/test_torch_refine.py
STATS_ATOL = 1e-6
# the spectral norm's u and sigma (tests/test_torch_aux_steps.py)
SN_ATOL = 1e-5
# gradient leaves, norm-relative: D's (its inputs agree to the
# networks' rounding) and G's, whose loss is D's verdict through D's
# convolutions after D's step (tests/test_torch_aux_steps.py's
# GRAD_REL and GAN_GRAD_REL)
D_GRAD_REL, G_GRAD_REL = 2e-2, 5e-2
# the one-step rule of tests/test_torch_aux_steps.py: a firm gradient
# element is above FIRM_GRAD of its leaf's largest and within FIRM_AGREE
# of JAX's; the firm elements must be at least FIRM_SHARE of the whole
FIRM_GRAD, FIRM_AGREE, FIRM_SHARE = 1e-2, 1e-2, 0.25


def _opts(**kw):
    base = dict(model="refine", dataset_mode="llff_refine", patch_len=32,
                batch_size=2, num_ref_patches=2, ngf=8, num_downs=5,
                ndf_dis=8, n_epochs=1, n_epochs_decay=0, lr=LR, gan_lr=LR,
                refine_as_gan=True)
    base.update(kw)
    return default_options("train", device="cpu", **base), \
        j_default_options("train", **base)


def _batch(seed, n=2, plen=32, k=2):
    rng = np.random.RandomState(seed)
    gt = rng.rand(n, plen, plen, 3).astype(np.float32) * 2 - 1
    sr = np.clip(gt + rng.randn(n, plen, plen, 3).astype(np.float32) * 0.1,
                 -1, 1)
    refs = np.clip(gt[:, None] + rng.randn(n, k, plen, plen, 3).astype(
        np.float32) * 0.05, -1, 1)
    return {"sr_patch": sr, "ref_patches": refs, "gt_patch": gt}


def _by_path(tree):
    return {jax.tree_util.keystr(p): np.asarray(v, np.float64)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


# ---------------------------------------------------------------------------
# the pools
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pool_size", [0, 4, 50])
def test_image_pool_matches_jax(pool_size):
    """Both host pools from one seed answer a stream of batches alike,
    through the fill and the swaps."""
    rng = np.random.RandomState(1)
    mine, ref = ImagePool(pool_size, seed=3), JImagePool(pool_size, seed=3)
    for _ in range(8):
        imgs = rng.rand(5, 4, 4, 3).astype(np.float32)
        assert np.array_equal(mine.query(imgs), ref.query(imgs))
    assert len(mine.images) == len(ref.images) == min(pool_size, 40)


def test_pool_query_matches_jax():
    """The device pool fed the uniforms and indices of JAX's keys gives
    JAX's ``_pool_query``'s answers, buffer and count, through the fill
    and past it."""
    opt, jopt = _opts(patch_len=4)
    system = create_model(opt, device="cpu")
    jsys = j_create_model(jopt)
    size = 4
    pool = system.new_pool(size)
    jbuf, jn = jnp.zeros((size, 4, 4, 3)), jnp.int32(0)
    rng = np.random.RandomState(2)
    for q in range(5):
        imgs = rng.rand(3, 4, 4, 3).astype(np.float32)
        key = jax.random.PRNGKey(q)
        u, ridx = [], []
        for k in jax.random.split(key, 3):
            k1, k2 = jax.random.split(k)
            u.append(float(jax.random.uniform(k1)))
            ridx.append(int(jax.random.randint(k2, (), 0, size)))
        jbuf, jn, jout = jsys._pool_query(jbuf, jn, jnp.asarray(imgs), key)
        out = system._pool_query(pool, torch.from_numpy(imgs),
                                 torch.tensor(u), torch.tensor(ridx))
        assert np.array_equal(out.numpy(), np.asarray(jout))
        assert np.array_equal(pool["buf"].numpy(), np.asarray(jbuf))
        assert int(pool["n"]) == int(jn)
    assert int(pool["n"]) == size


# ---------------------------------------------------------------------------
# one update pair against JAX's
# ---------------------------------------------------------------------------

def _jax_pair(jsys, jopt, system, state, d_state):
    """JAX's RefineState and D state holding the port's weights, with
    fresh Adam states (``jsys.tx`` as ``create_state`` builds it)."""
    jd = jsys.create_gan_state(jax.random.PRNGKey(0))
    dvars = export_discriminator(d_state.net)
    jd = {"params": jax.tree_util.tree_map(jnp.asarray, dvars["params"]),
          "batch_stats": jax.tree_util.tree_map(jnp.asarray,
                                                dvars["batch_stats"])}
    jd["opt_state"] = jsys.txD.init(jd["params"])
    sched = make_jax_lr_schedule(jopt, 1)
    jsys.tx = optax.chain(optax.scale_by_adam(b1=jopt.beta1, b2=0.999),
                          optax.scale_by_schedule(lambda s: -sched(s)))
    variables = export_variables(state.net)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    jstate = JRefineState(
        step=jnp.zeros((), jnp.int32), params=params,
        batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                           variables["batch_stats"]),
        opt_state=jsys.tx.init(params))
    return jstate, jd


def _one_step(got, want, p0, grads, port_grads, grad_rel):
    """tests/test_torch_aux_steps.py's rule over leaves keyed by path:
    each gradient leaf within ``grad_rel`` of JAX's (norm-relative), each
    parameter after the Adam step within 2 lr of JAX's, and to the
    one-step atol where the gradient is firm. Returns the firm share."""
    assert got.keys() == want.keys() == grads.keys() == port_grads.keys()
    n_firm = n_all = 0
    for k in want:
        a, b, p, g, gp = got[k], want[k], p0[k], grads[k], port_grads[k]
        assert np.linalg.norm(gp - g) <= grad_rel * np.linalg.norm(g), k
        assert np.abs(a - b).max() <= 2 * LR * (1 + 1e-5), k
        firm = (np.abs(g) > max(FIRM_GRAD * np.abs(g).max(), 1e-5)) & \
            (np.abs(g - gp) <= FIRM_AGREE * np.abs(g))
        np.testing.assert_allclose(a[firm], b[firm], rtol=0,
                                   atol=1e-6 + 1e-6 * np.abs(p).max(),
                                   err_msg=k)
        n_firm += int(firm.sum())
        n_all += g.size
    return n_firm / n_all


def _port_grads(leaves):
    """The parameters' gradients in flax's layout, keyed as ``_by_path``
    keys a nested dict."""
    return {"".join(f"['{part}']" for part in path.split("/")):
            np.asarray(to_flax_layout(t.grad, layout), np.float64)
            for coll, path, t, layout in leaves if coll == "params"}


@pytest.mark.parametrize("with_pool", [False, True])
def test_gan_step_matches_jax(with_pool):
    """One update pair from the same G, D and batch against JAX's
    ``_gan_step_impl`` (D on G's detached output, or on fixed pool
    fakes): G_GAN, G_L1, D_real and D_fake; G's and D's leaves by the
    one-step rule; D's spectral-norm statistics; batch norm's running
    values, moved once, against JAX's ``batch_stats``; G's output."""
    opt, jopt = _opts()
    system = create_model(opt, device="cpu")
    state = system.create_state(seed=0, steps_per_epoch=1)
    d_state = system.create_gan_state(1)
    jsys = j_create_model(jopt)
    jstate, jd = _jax_pair(jsys, jopt, system, state, d_state)
    g0 = _by_path(jstate.params)
    d0 = _by_path(jd["params"])
    batch = _batch(5)
    fakes = np.random.RandomState(6).uniform(
        -1, 1, (2, 32, 32, 3)).astype(np.float32) if with_pool else None

    jstate, jd, jlosses, jpred = jax.jit(jsys._gan_step_impl)(
        jstate, jd, {k: jnp.asarray(v) for k, v in batch.items()},
        None if fakes is None else jnp.asarray(fakes))
    state, d_state, losses, pred = system.gan_train_step(
        state, d_state, {k: torch.from_numpy(v) for k, v in batch.items()},
        None if fakes is None else torch.from_numpy(fakes))

    assert set(losses) == set(jlosses) == {"G_GAN", "G_L1", "D_real",
                                           "D_fake"}
    for k in jlosses:
        np.testing.assert_allclose(float(losses[k]), float(jlosses[k]),
                                   rtol=LOSS_RTOL, atol=1e-7, err_msg=k)
    np.testing.assert_allclose(pred.numpy(), np.asarray(jpred), atol=1e-4)
    assert state.step == int(jstate.step) == 1

    b1 = opt.beta1
    jg = {k: v / (1 - b1) for k, v in _by_path(jstate.opt_state[0].mu)
          .items()}
    g_share = _one_step(_by_path(export_variables(state.net)["params"]),
                        _by_path(jstate.params), g0, jg,
                        _port_grads(variable_leaves(state.net)), G_GRAD_REL)
    jgd = {k: v / (1 - b1) for k, v in _by_path(jd["opt_state"][0].mu)
           .items()}
    d_share = _one_step(_by_path(export_discriminator(d_state.net)[
        "params"]), _by_path(jd["params"]), d0, jgd,
        _port_grads(discriminator_leaves(d_state.net)), D_GRAD_REL)
    assert g_share > FIRM_SHARE and d_share > FIRM_SHARE, (g_share, d_share)

    got = _by_path(export_discriminator(d_state.net)["batch_stats"])
    want = _by_path(jd["batch_stats"])
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=SN_ATOL,
                                   err_msg=k)
    got = _by_path(export_variables(state.net)["batch_stats"])
    want = _by_path(jstate.batch_stats)
    assert got.keys() == want.keys() and got
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0,
                                   atol=STATS_ATOL, err_msg=k)


def test_host_route_matches_jax():
    """The single-step route, as the JAX engine's host route runs it
    (``gan_fakes``, the host ``ImagePool`` of 2 from one seed on both
    sides, ``gan_train_step``), over 3 steps on 3 batches: the pools swap
    the same slots, and every step's losses agree to ``LOSS_RTOL`` (at lr
    1e-5 the two sides' weights stay within rounding: seen 3.1e-6)."""
    opt, jopt = _opts()
    system = create_model(opt, device="cpu")
    state = system.create_state(seed=0, steps_per_epoch=1)
    d_state = system.create_gan_state(1)
    jsys = j_create_model(jopt)
    jstate, jd = _jax_pair(jsys, jopt, system, state, d_state)
    pool, jpool = ImagePool(2, seed=0), JImagePool(2, seed=0)
    key = jax.random.PRNGKey(0)
    for step in range(3):
        batch = _batch(10 + step)
        fakes = system.gan_fakes(state, {k: torch.from_numpy(v)
                                         for k, v in batch.items()})
        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
        jfakes = np.asarray(jsys.gan_fakes(jstate, jbatch))
        np.testing.assert_allclose(fakes.numpy(), jfakes, atol=1e-4)
        mixed, jmixed = pool.query(fakes.numpy()), jpool.query(jfakes)
        np.testing.assert_allclose(mixed, jmixed, atol=1e-4)
        state, d_state, losses, _ = system.gan_train_step(
            state, d_state, {k: torch.from_numpy(v)
                             for k, v in batch.items()},
            torch.from_numpy(mixed))
        jstate, jd, jlosses, _ = jsys.gan_train_step(
            jstate, jd, jbatch, key, jnp.asarray(jmixed))
        for k in jlosses:
            np.testing.assert_allclose(float(losses[k]), float(jlosses[k]),
                                       rtol=LOSS_RTOL, atol=1e-7,
                                       err_msg=f"{k} at step {step}")
    assert len(pool.images) == len(jpool.images) == 2
    assert state.step == int(jstate.step) == 3


def test_discriminator_at_64_px_crosses_both_ways():
    """``--patch_len 64`` (``llff_refine``'s default) gives D its fifth
    layer (``c0``): JAX's D loads into the port's and exports back to the
    same variables, and both give the same verdicts."""
    opt, jopt = _opts(patch_len=64)
    system = create_model(opt, device="cpu")
    d_state = system.create_gan_state(0)
    jsys = j_create_model(jopt)
    jd = jsys.create_gan_state(jax.random.PRNGKey(3))
    jvars = jax.tree_util.tree_map(np.asarray, {
        "params": jd["params"], "batch_stats": jd["batch_stats"]})
    assert "c0" in jvars["params"]
    load_discriminator(d_state.net, jvars)
    back = export_discriminator(d_state.net)
    for coll in ("params", "batch_stats"):
        got, want = _by_path(back[coll]), _by_path(jvars[coll])
        assert got.keys() == want.keys()
        for k in want:
            assert np.array_equal(got[k], want[k]), k
    x = np.random.RandomState(4).uniform(-1, 1, (2, 64, 64, 3)).astype(
        np.float32)
    want = jsys.netD.apply({"params": jd["params"],
                            "batch_stats": jd["batch_stats"]},
                           jnp.asarray(x), update_stats=False)
    with torch.no_grad():
        got = d_state.net(torch.from_numpy(x))
    assert got.shape == (2, 1, 1, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# the chunk
# ---------------------------------------------------------------------------

def _chunk_case(**extra):
    opt, _ = _opts(img_wh=(40, 36), batch_size=3, lr=5e-4, gan_lr=5e-4,
                   with_gt_patch=True, **extra)
    system = create_model(opt, device="cpu")
    rng = np.random.RandomState(0)
    views = rng.rand(4, 36, 40, 3).astype(np.float32) * 2 - 1
    buffers = system.upload_buffers({
        "sr_imgs": views, "gt_imgs": views[::-1].copy(), "gt_img": views[0],
        "bboxes": np.tile(np.array([1, 2, 39, 35], np.int32), (4, 1))})
    state = system.create_state(seed=0, steps_per_epoch=2)
    return system, buffers, state, system.create_gan_state(1), \
        system.new_pool(4)


@contextlib.contextmanager
def _no_host_reads(monkeypatch):
    """Every read of a tensor's value into the host raises, as it would
    break a CUDA-graph capture on the card."""
    with monkeypatch.context() as m:
        for name in ("item", "tolist", "__bool__", "__float__", "__int__",
                     "cpu", "numpy"):
            def read(*_, _name=name, **__):
                raise AssertionError(f"Tensor.{_name} inside a chunk")
            m.setattr(torch.Tensor, name, read)
        yield


def test_gan_chunk_reads_nothing_back(monkeypatch):
    system, buffers, state, d_state, pool = _chunk_case()
    gen = torch.Generator().manual_seed(3)
    with _no_host_reads(monkeypatch):
        state, d_state, pool, losses = system.train_steps_scan_gan(
            state, d_state, pool, buffers, 3, gen)
    assert state.step == 3
    assert set(losses) == {"G_GAN", "G_L1", "D_real", "D_fake"}
    assert all(torch.isfinite(v) for v in losses.values())


def _tensors(state, d_state, pool):
    out = {f"G/{k}": v for k, v in state.net.state_dict().items()}
    out.update({f"D/{k}": v for k, v in d_state.net.state_dict().items()})
    for tag, s in (("G", state), ("D", d_state)):
        for i, p in enumerate(s.optimizer.param_groups[0]["params"]):
            for k, v in s.optimizer.state[p].items():
                out[f"{tag}/{i}/{k}"] = v
    out.update({f"pool/{k}": v for k, v in pool.items()})
    return out


def test_gan_chunk_equals_single_steps():
    """A 3-step chunk, across an epoch's end (the learning rate moves),
    with the pool filling up, against 3 single steps from the same seed
    (the batch and the pool's draws from one generator): G with its
    running values, D with its spectral-norm statistics, both Adams, the
    pool and the last losses, bit for bit."""
    system, buffers, state, d_state, pool = _chunk_case()
    gen = torch.Generator().manual_seed(7)
    state, d_state, pool, losses = system.train_steps_scan_gan(
        state, d_state, pool, buffers, 3, gen)
    chunk = _tensors(state, d_state, pool)

    system, buffers, state, d_state, pool = _chunk_case()
    gen = torch.Generator().manual_seed(7)
    for _ in range(3):
        batch = system.sample_patch_batch(buffers, gen)
        fakes = system.gan_fakes(state, batch)
        pool_fakes = system._pool_query(pool, fakes, generator=gen)
        state, d_state, single, _ = system.gan_train_step(
            state, d_state, batch, pool_fakes)
    steps = _tensors(state, d_state, pool)
    assert int(pool["n"]) == 4 and state.step == 3
    assert chunk.keys() == steps.keys()
    for k in chunk:
        assert torch.equal(chunk[k], steps[k]), k
    for k in losses:
        assert torch.equal(losses[k], single[k]), k


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

H, W, N_VIEWS = 48, 64, 3


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """A COLMAP scene and a synthesis strip with its 2-channel locs per
    view (what ``warp`` writes, without its third channel)."""
    d = tmp_path_factory.mktemp("refine_gan")
    rng = np.random.RandomState(0)
    poses, _ = center_poses(spiral_path(np.array([0.2, 0.2, 0.05]), 3.5,
                                        N_VIEWS))
    yy, xx = np.mgrid[0:H, 0:W] / 7.0
    imgs = np.stack([np.stack([np.sin(xx * (1 + c) + i) * np.cos(yy + c)
                               for c in range(3)], -1)
                     for i in range(N_VIEWS)])
    imgs = ((imgs * 0.5 + 0.5) * 255).astype(np.uint8)
    write_llff_scene(str(d / "scene"), poses, imgs, 60.0,
                     rng.randn(300, 3) * 0.5 + [0, 0, -4.0])
    os.makedirs(d / "syn")
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
    for i in range(N_VIEWS):
        noisy = np.clip(imgs[i].astype(int) + rng.randint(-20, 20, imgs[i]
                                                          .shape), 0, 255)
        png.write(str(d / "syn" / f"{i}-fine-ori.png"),
                  np.concatenate([noisy.astype(np.uint8), imgs[i]], 1))
        np.savez(d / "syn" / f"{i}_locs.npz", np.stack([xs, ys], -1))
    return d


def test_train_refine_gan_through_the_entry_point(scene, tmp_path):
    """``train_refine --refine_as_gan`` 2 epochs, then ``--continue_train``
    to 3: the resume reads G at step 8 and ends at 12, and its epoch 3
    differs from an unbroken 3-epoch run's because D and the pool start
    afresh (neither is checkpointed, as in JAX); every value finite."""
    common = ["--model", "refine", "--dataset_mode", "llff_refine",
              "--dataset_root", str(scene / "scene"), "--img_wh", str(W),
              str(H), "--syn_dataroot", str(scene / "syn"), "--device",
              "cpu", "--checkpoints_dir", str(tmp_path / "ck"),
              "--patch_len", "32", "--ngf", "8", "--num_downs", "5",
              "--num_ref_patches", "2", "--ndf_dis", "8", "--ref_offset",
              "8", "--refine_as_gan", "--batch_size", "2", "--aug_num", "3",
              "--steps_per_epoch", "4", "--print_freq", "2",
              "--n_epochs_decay", "0", "--val_epoch_freq", "0",
              "--summary_dir", str(tmp_path / "runs")]
    train_refine_entry.main(["--name", "r", "--n_epochs", "2"] + common)
    resumed = train_refine_entry.main(["--name", "r", "--n_epochs", "3",
                                       "--continue_train"] + common)
    unbroken = train_refine_entry.main(["--name", "u", "--n_epochs", "3"]
                                       + common)
    assert resumed.step == unbroken.step == 12
    assert os.path.exists(tmp_path / "ck" / "r" / "3_state.msgpack")
    assert any(not torch.equal(v, unbroken.net.state_dict()[k])
               for k, v in resumed.net.state_dict().items())
    for state in (resumed, unbroken):
        assert all(torch.isfinite(v).all()
                   for v in state.net.state_dict().values())
