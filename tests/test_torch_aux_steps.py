"""The auxiliary training paths' steps on the CPU, against the JAX
package, from the same weights, inputs and draws:

- ``--with_ref``: one step (``train_step_with_ref``) and one step of the
  chunk with the ``--ref_freq`` weight at 0;
- patch mode: ``train_step_patches`` with the bilateral depth Laplacian
  at 8 px and with the VGG losses at 32 px;
- ``--with_netD``: the adversarial update (``_gan_update_impl``) in each
  ``--gan_mode``, with ``--use_grad``, twice, so the spectral norm's
  ``u`` and sigma are held after two D updates;
- ``--reg_patch``: the TV update on a device-made patch
  (``_reg_update_impl``) and on a host block (``reg_patch_step``);
- the step counter and Adam's counts after GAN and TV firings;
- ``--refine_with_vgg``: one refine step;

then each chunk body with every host read made to raise (what a CUDA
graph's capture forbids), and the chunks against their single-step forms
bit for bit.

The bars: losses to ``LOSS_RTOL``; each gradient leaf of the NeRF and
of D to ``GRAD_REL``; after one update, each parameter of
the NeRF and of D within 2 lr of JAX's (Adam's first update is lr times a
sign, which may turn where a gradient is within rounding of zero) and,
where the gradient is firm (``FIRM_GRAD``, ``FIRM_AGREE``), to the one-step atol of
``tests/test_torch_scan.py`` (1e-6 + 1e-6 of the leaf's largest value);
D's logits' statistics (``u``, sigma) to 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch's threads in a test worker)

from nerfsr_tpu.config import default_options as j_default_options
from nerfsr_tpu.models import create_model as j_create_model
from nerfsr_tpu.models.criterions import write_synthetic_vgg_npz

from nerfsr_torch.config import default_options
from nerfsr_torch.data.llff import _ray_dirs_np, pose_rays
from nerfsr_torch.data.llff_downx import pose_rays_grouped
from nerfsr_torch.data.views import LLFFDownXTrainViews, LLFFDownXViews
from nerfsr_torch.models import create_model
from nerfsr_torch.weights import (export_discriminator, export_params,
                                  load_discriminator, load_jax_params)

HR_WH = (48, 40)
FOCAL = 40.0
LR = 1e-5
LOSS_RTOL = 1e-5
STATS_ATOL = 1e-5
# what D says of the rendered patch (D_fake, G_GAN) and, in the second
# update, of anything: the 32x32 patch's render agrees with JAX's to
# 2.8e-5 (the f32 render bar is 2e-4, tests/test_torch_slice.py), and
# D's first Adam update is lr times a sign that may turn where a
# gradient is within rounding of zero (seen up to 1.1e-4 relative)
RENDER_LOSS_RTOL = 2e-4
# f32 gradients per leaf, norm-relative (tests/test_torch_train.py's
# GRAD_REL): the first layer's agrees with JAX to ~8e-3 (ROADMAP queue 3)
GRAD_REL = 2e-2
# a firm gradient element, as tests/test_torch_scan.py defines it: above
# this share of its leaf's largest on JAX's side and within FIRM_AGREE of
# JAX's on the port's (at 1e-3 and without the agreement, one element of
# the first layer's kernel, 1.2e-3 of its leaf's largest, turned)
FIRM_GRAD, FIRM_AGREE = 1e-2, 1e-2
# G's gradient in the adversarial update: D's verdict on the rendered
# patch backpropagated through D's convolutions and the render; the
# trunk's leaves agree with JAX to 1-2%, the one-element sigma bias (a
# sum that cancels to 1e-2 of the network's norm) to 3.5% (measured, all
# three modes); D's own leaves to 7e-5
GAN_GRAD_REL = 5e-2
# the share of the NeRF's and D's elements that must be firm; below it
# the comparison would hold little
FIRM_SHARE = 0.25


def t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _kw(**extra):
    kw = dict(model="nerf_downX", dataset_mode="llff_downX", img_wh=HR_WH,
              downscale=2, fast_preset="llff", precision="f32", D=2, W=32,
              randomized=False, noise_std=0.0, batch_size=16, lr=LR,
              n_epochs=4, n_epochs_decay=2, patch_len=32, ndf_dis=8,
              gan_lr=LR, reg_patch_len=2, gan_iter=3, reg_patch_freq=2)
    kw.update(extra)
    return kw


def _pair(**extra):
    """The JAX system and state (sigma biases +3, so the scene has
    content) and the port's from the same weights."""
    kw = _kw(**extra)
    jsys = j_create_model(j_default_options("train", **kw))
    jstate = jsys.create_state(jax.random.PRNGKey(0), steps_per_epoch=4)
    tree = jax.tree_util.tree_map(np.array, jstate.params)
    for net in tree.values():
        net["params"]["sigma"]["bias"] += 3.0
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    jstate = jstate.replace(params=params, opt_state=jsys.tx.init(params))
    system = create_model(default_options("train", **kw), device="cpu")
    state = system.create_state(0, steps_per_epoch=4)
    load_jax_params(state.params, tree)
    return jsys, jstate, tree, system, state


def _jax_grads(opt_state, b1=0.9):
    """JAX's gradients after its first Adam step: mu = (1 - b1) g."""
    return jax.tree_util.tree_map(lambda m: np.asarray(m) / (1 - b1),
                                  opt_state[0].mu)


def _port_grads(params):
    """The NeRF's gradients in the JAX layout of ``export_params`` (a
    leaf no gradient reached reads as zeros)."""
    def g(p, transpose):
        x = torch.zeros_like(p) if p.grad is None else p.grad
        return (x.T if transpose else x).numpy()
    return {key: {"params": {
        name: {"kernel": g(lin.weight, True), "bias": g(lin.bias, False)}
        for name, lin in module.named_children()
        if isinstance(lin, torch.nn.Linear)}}
        for key, module in params.items()}


def _port_d_grads(net):
    """D's kernel gradients in flax's HWIO layout."""
    return {name: {"kernel": m.weight.grad.permute(2, 3, 1, 0).numpy()}
            for name, m in net.spectral_convs()}


def _one_step(got, want, p0, grads, port_grads, lr=LR, grad_rel=None):
    """After one Adam step from ``p0``: each gradient leaf within
    ``GRAD_REL`` of JAX's (norm-relative), each parameter within 2 lr of
    JAX's, and to the one-step atol where the gradient is firm (above
    ``FIRM_GRAD`` of its leaf's largest on JAX's side, and within
    ``FIRM_AGREE`` of JAX's on the port's). Returns the firm share."""
    n_firm = n_all = 0
    for a, b, p, g, gp in zip(*(jax.tree_util.tree_leaves(x) for x in
                                (got, want, p0, grads, port_grads))):
        a, b, p, g, gp = (np.asarray(x, np.float64)
                          for x in (a, b, p, g, gp))
        if np.abs(g).max() > 0:
            assert np.linalg.norm(gp - g) <= \
                (grad_rel or GRAD_REL) * np.linalg.norm(g)
        else:
            assert np.abs(gp).max() == 0
        assert np.abs(a - b).max() <= 2 * lr * (1 + 1e-5)
        firm = (np.abs(g) > max(FIRM_GRAD * np.abs(g).max(), 1e-5)) & \
            (np.abs(g - gp) <= FIRM_AGREE * np.abs(g))
        np.testing.assert_allclose(a[firm], b[firm], rtol=0,
                                   atol=1e-6 + 1e-6 * np.abs(p).max())
        n_firm += int(firm.sum())
        n_all += g.size
    return n_firm / n_all


def _close_losses(got, want, keys=None):
    keys = keys or want.keys()
    for k in keys:
        np.testing.assert_allclose(float(got[k]), float(want[k]),
                                   rtol=LOSS_RTOL, atol=1e-7, err_msg=k)


def _adam_steps(optimizer):
    return {int(st["step"]) for st in optimizer.state.values()}


# ---------------------------------------------------------------------
# --with_ref
# ---------------------------------------------------------------------

def _buffers():
    """Two training views' grouped rays with random colours, and the
    reference view's flat HR rays (view 0) with its own."""
    views = LLFFDownXViews.spiral(FOCAL, HR_WH, 2, 3, radii=(0.2, 0.2, .05))
    imgs = np.random.RandomState(4).rand(3, HR_WH[1], HR_WH[0], 3)
    buf = LLFFDownXTrainViews(views.poses, imgs, FOCAL, HR_WH, 2
                              ).ray_buffer("cpu", include_var=False)
    buf = {k: v.numpy() for k, v in buf.items()}
    ref = {k: v.reshape(-1, v.shape[-1]) for k, v in pose_rays(
        views.directions, views.poses[0], HR_WH, FOCAL, (0.0, 1.0)).items()}
    ref["viewdirs"] = ref["directions"]
    ref["rgbs"] = np.random.RandomState(5).rand(len(ref["origins"]), 3
                                                ).astype(np.float32)
    return buf, ref


def _ref_draws(key, step, batch, n_total, n_ref):
    k_idx, k_ref, _, _ = jax.random.split(jax.random.fold_in(key, step), 4)
    return (np.array(jax.random.randint(k_idx, (batch,), 0, n_total)),
            np.array(jax.random.randint(k_ref, (batch,), 0, n_ref)))


@pytest.mark.parametrize("ref_w", [None, 0.0], ids=["ref", "ref_off"])
def test_with_ref_step_matches_jax(ref_w):
    """``train_step_with_ref`` (and, with the weight 0, one step of
    ``train_steps_scan_with_ref`` at an iteration off ``--ref_freq``)
    against JAX's ``_with_ref_step_impl`` on its own draws: the losses
    (the reference terms at weight 1 / downscale^2, or 0) and the
    parameters after the step."""
    jsys, jstate, tree, system, state = _pair()
    buf, ref = _buffers()
    key = jax.random.PRNGKey(3)
    idx, ref_idx = _ref_draws(key, 0, 16, len(buf["rgbs"]),
                              len(ref["rgbs"]))
    jstep = jax.jit(jsys._with_ref_step_impl)
    jstate, jlosses = jstep(jstate, {k: jnp.asarray(v) for k, v in
                                     buf.items()},
                            {k: jnp.asarray(v) for k, v in ref.items()},
                            key, None if ref_w is None else jnp.float32(0))
    tbuf = {k: t(v) for k, v in buf.items()}
    tref = {k: t(v) for k, v in ref.items()}
    if ref_w is None:
        state, losses = system.train_step_with_ref(
            state, tbuf, tref, idx=torch.from_numpy(idx),
            ref_idx=torch.from_numpy(ref_idx))
    else:
        state, losses = system.train_steps_scan_with_ref(
            state, tbuf, tref, 1, 2, 1, idx=torch.from_numpy(idx[None]),
            ref_idx=torch.from_numpy(ref_idx[None]))
    assert set(losses) == set(jlosses) >= {"ref_fine_mse", "fine_mse",
                                           "interlevel", "tot"}
    _close_losses(losses, jlosses)
    assert (float(losses["ref_fine_mse"]) == 0) == (ref_w is not None)
    assert state.step == int(jstate.step) == 1
    assert _one_step(export_params(state.params), jstate.params, tree,
                     _jax_grads(jstate.opt_state),
                     _port_grads(state.params)) > FIRM_SHARE


# ---------------------------------------------------------------------
# patch mode
# ---------------------------------------------------------------------

def _image_buffer(n_img=2):
    """Vanilla NeRF's image-structured buffer: NDC rays of two views
    (N_img, H, W, C) with random colours."""
    views = LLFFDownXViews.spiral(FOCAL, HR_WH, 2, n_img,
                                  radii=(0.2, 0.2, .05))
    dirs = _ray_dirs_np(HR_WH[1], HR_WH[0], FOCAL)
    fields = [pose_rays(dirs, p, HR_WH, FOCAL, (0.0, 1.0))
              for p in views.poses]
    buf = {k: np.stack([f[k] for f in fields]) for k in fields[0]}
    buf["rgbs"] = np.random.RandomState(6).rand(
        n_img, HR_WH[1], HR_WH[0], 3).astype(np.float32)
    return buf


@pytest.fixture(scope="module")
def vgg_npz(tmp_path_factory):
    return write_synthetic_vgg_npz(
        str(tmp_path_factory.mktemp("vgg") / "vgg.npz"), seed=1)


@pytest.mark.parametrize("ps", [8, 32])
def test_patch_step_matches_jax(ps, vgg_npz):
    """``train_step_patches`` against JAX's on its draws (the patches'
    images, rows and columns): vanilla NeRF (parity, 8 + 8 samples),
    both levels' bilateral depth Laplacian (whose depth cotangent runs
    through the composite's backward) and, at 32 px, both levels' VGG
    loss on the synthetic archive."""
    extra = dict(model="nerf", dataset_mode="llff", fast_preset="parity",
                 N_coarse=8, N_importance=8, batch_size=2 * ps * ps,
                 patch_size=ps, lambda_coarse_depth_lap=0.5,
                 lambda_fine_depth_lap=0.3, bilateral_gamma=0.2)
    if ps == 32:
        extra.update(batch_size=ps * ps, lambda_coarse_vgg=0.1,
                     lambda_fine_vgg=0.2, vgg_weights=vgg_npz)
    jsys, jstate, tree, system, state = _pair(**extra)
    buf = _image_buffer()
    key = jax.random.PRNGKey(7)
    n = system.n_patches(ps)
    k_i, k_r, k_c, _ = jax.random.split(jax.random.fold_in(key, 0), 4)
    h, w = HR_WH[1], HR_WH[0]
    draws = np.stack([np.array(jax.random.randint(k, (n,), 0, hi)) for
                      k, hi in ((k_i, 2), (k_r, h - ps + 1),
                                (k_c, w - ps + 1))])
    jstate, jlosses = jsys.train_step_patches(
        jstate, {k: jnp.asarray(v) for k, v in buf.items()}, key, ps)
    state, losses = system.train_step_patches(
        state, {k: t(v) for k, v in buf.items()}, None, ps,
        draws=torch.from_numpy(draws))
    want = {"coarse_depth_lap", "fine_depth_lap"} | (
        {"coarse_vgg", "fine_vgg"} if ps == 32 else set())
    assert want <= set(losses) and set(losses) == set(jlosses)
    _close_losses(losses, jlosses)
    assert state.step == int(jstate.step) == 1
    assert _one_step(export_params(state.params), jstate.params, tree,
                     _jax_grads(jstate.opt_state),
                     _port_grads(state.params)) > FIRM_SHARE


# ---------------------------------------------------------------------
# --with_netD and --reg_patch
# ---------------------------------------------------------------------

def _gan_buffers():
    views = LLFFDownXViews.spiral(FOCAL, HR_WH, 2, 3, radii=(0.2, 0.2, .05))
    bufs = {"dirs_hw": views.directions.astype(np.float32),
            "poses": views.poses.astype(np.float32),
            "reals": np.random.RandomState(8).rand(
                1, HR_WH[1], HR_WH[0], 3).astype(np.float32),
            "real_idx": np.zeros(3, np.int32)}
    geom = ("ndc", HR_WH[1], HR_WH[0], FOCAL, 0.0, 1.0)
    return bufs, geom


def _d_pair(jsys, system):
    jd = jsys.create_gan_state(jax.random.PRNGKey(1))
    gs = system.create_gan_state(0)
    load_discriminator(gs.net, jax.tree_util.tree_map(
        np.asarray, {"params": jd["params"],
                     "batch_stats": jd["batch_stats"]}))
    return jd, gs


@pytest.mark.parametrize("mode,use_grad", [
    ("vanilla", False), ("lsgan", False), ("wgangp", True)])
def test_gan_update_matches_jax(mode, use_grad):
    """Two adversarial updates on one patch against JAX's
    ``_gan_update_impl`` (the penalty's draw fed to both): G_GAN, D_real,
    D_fake (what reads the render, or D after a step, to
    ``RENDER_LOSS_RTOL``); after
    the first, D's and the NeRF's parameters (one-step rule) and the step
    counts; after each, D's spectral-norm ``u`` and sigma."""
    jsys, jstate, tree, system, state = _pair(gan_mode=mode,
                                              use_grad=use_grad)
    jd, gs = _d_pair(jsys, system)
    d0 = export_discriminator(gs.net)
    bufs, geom = _gan_buffers()
    jbufs = {k: jnp.asarray(v) for k, v in bufs.items()}
    dev = system.upload_gan_buffers(bufs)
    rays, real = system._gan_patch_at(dev, geom, torch.tensor(1),
                                      torch.tensor(2), torch.tensor(3))
    step_key = jax.random.PRNGKey(9)

    @jax.jit
    def jupdate(st, ds):
        jrays, jreal = jsys._gan_patch_at(jbufs, geom, 1, 2, 3)
        return jsys._gan_update_impl(st, ds, jrays, jreal, step_key)

    eps = t(jax.random.uniform(jax.random.fold_in(step_key, 7),
                               (1, 1, 1, 1)))
    for update in range(2):
        jstate, jd, jlosses = jupdate(jstate, jd)
        losses = system._gan_update(state, gs, rays, real, None, update,
                                    eps=eps)
        state.step += 1
        # in D's loss units (G_GAN carries --lambda_gan)
        scale = {"G_GAN": 1 / system.opt.lambda_gan}
        for k in ("D_real", "D_fake", "G_GAN"):
            got, want = (float(x[k]) * scale.get(k, 1.0)
                         for x in (losses, jlosses))
            bar = LOSS_RTOL if update == 0 and k == "D_real" \
                else RENDER_LOSS_RTOL
            assert abs(got - want) <= bar * max(abs(want), 1.0), (k, update)
        for a, b in zip(jax.tree_util.tree_leaves(
                export_discriminator(gs.net)["batch_stats"]),
                jax.tree_util.tree_leaves(jd["batch_stats"])):
            np.testing.assert_allclose(a, np.asarray(b), rtol=0,
                                       atol=STATS_ATOL)
        if update == 0:
            assert int(jstate.step) == state.step == 1
            assert int(jstate.opt_state[0].count) == 1
            # every NeRF leaf took an Adam step, the proposal network's
            # with a zero gradient, as optax steps every leaf
            assert _adam_steps(state.optimizer) == {1}
            assert _adam_steps(gs.optimizer) == {1}
            assert _one_step(export_params(state.params), jstate.params,
                             tree, _jax_grads(jstate.opt_state),
                             _port_grads(state.params),
                             grad_rel=GAN_GRAD_REL) > 0.05
            assert _one_step(export_discriminator(gs.net)["params"],
                             jd["params"], d0["params"],
                             _jax_grads(jd["opt_state"]),
                             _port_d_grads(gs.net)) > FIRM_SHARE


def test_reg_updates_match_jax():
    """The TV update on a device-made 4x4 HR patch against JAX's
    ``_reg_update_impl`` on its ``_patch_rays_at`` rays, then on a host
    block (grouped rays, ungrouped before the TV) against JAX's
    ``reg_patch_step``: the loss, the step count (each a full optimizer
    step: Adam's counts advance on every leaf) and the parameters."""
    jsys, jstate, tree, system, state = _pair()
    bufs, geom = _gan_buffers()
    jbufs = {k: jnp.asarray(v) for k, v in bufs.items()}
    dev = system.upload_gan_buffers(bufs)
    step_key = jax.random.PRNGKey(11)

    @jax.jit
    def jupdate(st):
        rays = jsys._patch_rays_at(jbufs, geom, 2, 6, 10, 4)
        return jsys._reg_update_impl(st, rays, step_key)
    jstate, jlosses = jupdate(jstate)
    losses = system._run_aux("reg", state, None, dev, geom, None,
                             draws=torch.tensor([2, 3, 5]))
    _close_losses(losses, jlosses)
    assert state.step == int(jstate.step) == 1 and int(state.step_t) == 1
    assert _adam_steps(state.optimizer) == {1}
    assert _one_step(export_params(state.params), jstate.params, tree,
                     _jax_grads(jstate.opt_state),
                     _port_grads(state.params)) > 0.05

    # the host block: rows 3-4, columns 5-6 of view 1 (LR 24 x 20)
    views = LLFFDownXViews.spiral(FOCAL, HR_WH, 2, 3, radii=(0.2, 0.2, .05))
    rays = pose_rays_grouped(views.directions, views.poses[1], HR_WH, FOCAL,
                             2, (0.0, 1.0))
    wl = HR_WH[0] // 2
    idx = ((3 + np.arange(2))[:, None] * wl + 5 + np.arange(2)).reshape(-1)
    block = {k: v[idx] for k, v in rays.items()}
    jstate, jlosses = jsys.reg_patch_step(
        jstate, {k: jnp.asarray(v) for k, v in block.items()},
        jax.random.PRNGKey(12))
    state, losses = system.reg_patch_step(state, block)
    _close_losses(losses, jlosses)
    assert state.step == int(jstate.step) == 2
    assert _adam_steps(state.optimizer) == {2}


def test_step_counts_after_gan_and_reg_firings():
    """Six main steps with ``--gan_iter 3`` and ``--reg_patch_freq 2``
    from global step 0 fire the GAN after steps 3 and 6 and the TV
    update after 2, 4 and 6 (GAN first): 11 optimizer steps, as the JAX
    package's ``train_steps_scan_gan`` counts them (``state.step + 1`` a
    firing). Every NeRF leaf's Adam count is 11, D's 2; the losses are
    the last main step's and the last updates'."""
    _, _, _, system, state = _pair(randomized=True, noise_std=1.0)
    gs = system.create_gan_state(0)
    buf, _ = _buffers()
    bufs, geom = _gan_buffers()
    dev = system.upload_gan_buffers(bufs)
    assert system._fires(0, 6, 3) == {2, 5}
    assert system._fires(0, 6, 2) == {1, 3, 5}
    assert system._fires(4, 6, 3) == {1, 4}
    gen = torch.Generator().manual_seed(0)
    state, gs, losses = system.train_steps_scan_gan(
        state, gs, {k: t(v) for k, v in buf.items()}, dev, 6, geom, 0, gen,
        with_reg=True)
    assert state.step == int(state.step_t) == 11
    assert _adam_steps(state.optimizer) == {11}
    assert _adam_steps(gs.optimizer) == {2}
    assert {"G_GAN", "D_real", "D_fake", "patch", "fine_mse"} <= set(losses)
    assert all(torch.isfinite(v) for v in losses.values())
    # the reg-only chunk from global step 1: firings after steps 2 and 4
    state, losses = system.train_steps_scan_reg(
        state, {k: t(v) for k, v in buf.items()}, dev, 4, geom, 1, gen)
    assert state.step == 11 + 4 + 2 and "G_GAN" not in losses


# ---------------------------------------------------------------------
# the chunk bodies: no host reads, and the single-step forms' bits
# ---------------------------------------------------------------------

HOST_READS = ("item", "tolist", "__bool__", "__float__", "__int__", "cpu",
              "numpy")


@pytest.fixture
def no_host_reads(monkeypatch):
    import contextlib

    @contextlib.contextmanager
    def forbid():
        with monkeypatch.context() as m:
            for name in HOST_READS:
                def read(*_, _name=name, **__):
                    raise AssertionError(f"Tensor.{_name} inside a chunk")
                m.setattr(torch.Tensor, name, read)
            yield
    return forbid


@pytest.mark.parametrize("path", ["with_ref", "patches", "gan_wgangp",
                                  "gan_reg"])
def test_aux_chunks_read_nothing_back(path, no_host_reads, vgg_npz):
    """Each auxiliary chunk (randomized, sigma noise) with every host
    read made to raise, as a CUDA graph's capture would fail on one."""
    gen = torch.Generator().manual_seed(1)
    if path == "patches":
        system = create_model(default_options("train", **_kw(
            model="nerf", dataset_mode="llff", fast_preset="parity",
            N_coarse=8, N_importance=8, batch_size=1024, patch_size=32,
            lambda_fine_depth_lap=0.1, lambda_fine_vgg=0.1,
            vgg_weights=vgg_npz, randomized=True, noise_std=1.0)),
            device="cpu")
        state = system.create_state(0, steps_per_epoch=4)
        buf = {k: t(v) for k, v in _image_buffer().items()}
        with no_host_reads():
            state, losses = system.train_steps_scan_patches(state, buf, 2,
                                                            32, gen)
        assert "fine_vgg" in losses and state.step == 2
        return
    extra = dict(gan_mode="wgangp", use_grad=True) \
        if path == "gan_wgangp" else {}
    system = create_model(default_options("train", **_kw(
        randomized=True, noise_std=1.0, **extra)), device="cpu")
    state = system.create_state(0, steps_per_epoch=4)
    buf, ref = _buffers()
    buf = {k: t(v) for k, v in buf.items()}
    if path == "with_ref":
        with no_host_reads():
            state, losses = system.train_steps_scan_with_ref(
                state, buf, {k: t(v) for k, v in ref.items()}, 3, 3, 0, gen)
        assert state.step == 3 and "ref_fine_mse" in losses
        return
    gs = system.create_gan_state(0)
    bufs, geom = _gan_buffers()
    dev = system.upload_gan_buffers(bufs)
    with no_host_reads():
        state, gs, losses = system.train_steps_scan_gan(
            state, gs, buf, dev, 3, geom, 2, gen,
            with_reg=path == "gan_reg")
    assert state.step == 3 + 1 + (1 if path == "gan_reg" else 0)


def test_aux_chunks_equal_their_single_steps():
    """A with-ref chunk (``--ref_freq`` 1) equals its single steps, and a
    patch chunk equals ``train_step_patches`` step by step, bit for bit,
    on injected draws (no generator: nothing else is drawn)."""
    buf, ref = _buffers()
    tbuf = {k: t(v) for k, v in buf.items()}
    tref = {k: t(v) for k, v in ref.items()}
    rng = np.random.RandomState(2)
    idx = torch.from_numpy(rng.randint(0, len(buf["rgbs"]), (3, 16)))
    ref_idx = torch.from_numpy(rng.randint(0, len(ref["rgbs"]), (3, 16)))
    runs = []
    for chunk in (True, False):
        _, _, _, system, state = _pair()
        if chunk:
            state, _ = system.train_steps_scan_with_ref(
                state, tbuf, tref, 3, 1, 0, idx=idx, ref_idx=ref_idx)
        else:
            for i in range(3):
                state, _ = system.train_step_with_ref(
                    state, tbuf, tref, idx=idx[i], ref_idx=ref_idx[i])
        runs.append(state)
    for a, b in zip(runs[0].params.parameters(), runs[1].params.parameters()):
        assert torch.equal(a, b)

    img = {k: t(v) for k, v in _image_buffer().items()}
    draws = torch.from_numpy(np.stack([
        [rng.randint(0, 2, 2), rng.randint(0, 33, 2), rng.randint(0, 41, 2)]
        for _ in range(3)]))
    runs = []
    extra = dict(model="nerf", dataset_mode="llff", fast_preset="parity",
                 N_coarse=8, N_importance=8, batch_size=128, patch_size=8,
                 lambda_fine_depth_lap=0.1)
    for chunk in (True, False):
        _, _, _, system, state = _pair(**extra)
        if chunk:
            state, _ = system.train_steps_scan_patches(state, img, 3, 8,
                                                       draws=draws)
        else:
            for i in range(3):
                state, _ = system.train_step_patches(state, img, None, 8,
                                                     draws=draws[i])
        runs.append(state)
    for a, b in zip(runs[0].params.parameters(), runs[1].params.parameters()):
        assert torch.equal(a, b)
    assert runs[0].step == runs[1].step == int(runs[0].step_t) == 3
