"""The training slice on the CPU against the JAX package: the same numpy
inputs and weights go through both.

- the losses of the path (``psnr``, ``_outer_mass``, ``interlevel_loss``,
  the sub-pixel mean and variance), the LR schedule and the optimizer
  step against their JAX counterparts;
- the grouped training buffer against the JAX data helpers;
- the slice as a whole: ``NeRFDownXSystem._loss_fn``'s loss and every
  gradient leaf against ``jax.value_and_grad(system._loss_fn)`` at HR
  16x12 (full-width D8/W256 MLP), f32, for ``--fast_preset llff`` and
  ``parity`` (16+16 samples), with JAX plain and through its Pallas
  kernels in interpret mode (``pallas_mlp_bwd="pallas"``: the v3
  backward); one mixed-precision case; one ``train_step``; a few steps
  whose loss falls.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from PIL import Image

from nerfsr_tpu.config import default_options as j_default_options
from nerfsr_tpu.data.blender import _ray_dirs_np as j_ray_dirs
from nerfsr_tpu.data.blender import rays_from_pose as j_rays_from_pose
from nerfsr_tpu.data.downx_common import downscale_pil as j_downscale
from nerfsr_tpu.data.downx_common import group_subpixels as j_group
from nerfsr_tpu.data.llff import ndc_rays_np as j_ndc
from nerfsr_tpu.models import create_model as j_create_model
from nerfsr_tpu.models import criterions as jcrit
from nerfsr_tpu.models import nerf_downx_system as jdownx
from nerfsr_tpu.utils.schedule import make_jax_lr_schedule

from nerfsr_torch.config import default_options
from nerfsr_torch.data import views as tviews
from nerfsr_torch.data.views import LLFFDownXTrainViews, LLFFDownXViews
from nerfsr_torch.models import create_model
from nerfsr_torch.models import criterions as tcrit
from nerfsr_torch.models import nerf_downx_system as tdownx
from nerfsr_torch.utils.schedule import make_lr_schedule
from nerfsr_torch.weights import export_params, load_jax_params

HR_WH = (16, 12)
FOCAL = 14.0
PRESETS = {"llff": dict(fast_preset="llff"),
           "parity": dict(fast_preset="parity", N_coarse=16,
                          N_importance=16)}
PALLAS = dict(use_pallas=True, use_pallas_mlp=True, pallas_mlp_bwd="pallas",
              use_pallas_sampling=True, pallas_interpret=True)
# f32 loss: another summation order through the MLP and the composite
LOSS_RTOL = 1e-5
# f32 gradients, per leaf, norm-relative. The first trunk layers' weight
# gradients are sums over the batch of products of 2^9-frequency
# encodings: a 1e-7 relative change of the ray origins moves the port's
# own first-layer gradient by 8.0e-3, and JAX and the port differ by
# such roundings (another summation order, another sin/cos, the inverse
# CDF). Seen: 8.3e-3 at most (llff, layer 1, against the Pallas path);
# the median leaf 4.7e-4, held to GRAD_REL_MEDIAN.
GRAD_REL, GRAD_REL_MEDIAN = 2e-2, 2e-3
# mixed precision: each side rounds to bf16 at other places (the three
# numerics of nerfsr_torch/kernels/mlp.py), through the forward and the
# backward; norm-relative per leaf. Seen: loss 8.4e-4, gradients 0.15 at
# most (layer 1, the f32 floor above times bf16's coarser inputs),
# median 3.1e-2.
MIXED_LOSS_RTOL, MIXED_GRAD_REL = 5e-3, 0.3


def t(x):
    return torch.from_numpy(np.asarray(x, np.float32).copy())


def _kw(preset, precision, **extra):
    kw = dict(model="nerf_downX", dataset_mode="llff_downX",
              img_wh=HR_WH, downscale=2, precision=precision,
              batch_size=48, n_epochs=4, n_epochs_decay=2,
              **PRESETS[preset])
    kw.update(extra)
    return kw


@pytest.fixture
def interpret_composite(monkeypatch):
    """The JAX system calls its composite kernel without ``interpret``
    (``models/render.py:_eval_level``), which the CPU cannot lower; route
    that one call through interpret mode, in this test process only."""
    from nerfsr_tpu.ops.experimental import pallas_composite as pc
    kernel = pc.pallas_volumetric_rendering

    def interpreted(rgb, sigma, z_vals, white_bkgd, activation="relu",
                    interpret=True):
        del interpret          # the custom VJP's forward passes its own
        return kernel(rgb, sigma, z_vals, white_bkgd, activation, True)
    monkeypatch.setattr(pc, "pallas_volumetric_rendering", interpreted)


# ---------------------------------------------------------------------
# losses, schedule, optimizer
# ---------------------------------------------------------------------

def _histograms(seed, n=6, s_f=9, s_p=13):
    rng = np.random.RandomState(seed)
    z_prop = np.sort(rng.rand(n, s_p), -1).astype(np.float32)
    z_fine = np.sort(rng.rand(n, s_f), -1).astype(np.float32)
    # ties: fine depths equal to proposal edges, and a repeated edge
    z_fine[:, 2] = z_prop[:, 4]
    z_fine[:, 5] = z_prop[:, 9]
    z_prop[:, 7] = z_prop[:, 6]
    z_fine[0, :7] = z_prop[0, ::2]         # every other edge, exactly
    z_fine[0] = np.sort(z_fine[0])
    w_prop = rng.rand(n, s_p).astype(np.float32)
    w_prop[1, 3:6] = 0.0          # an empty stretch: a flat CDF
    w_fine = rng.rand(n, s_f).astype(np.float32)
    return z_fine, w_fine, z_prop, w_prop


@pytest.mark.parametrize("seed", [0, 1])
def test_interlevel_loss_and_outer_mass_vs_jax(seed):
    z_fine, w_fine, z_prop, w_prop = _histograms(seed)
    np.testing.assert_allclose(
        tcrit._outer_mass(t(z_fine), t(z_prop), t(w_prop[:, :-1])).numpy(),
        np.asarray(jcrit._outer_mass(z_fine, z_prop, w_prop[:, :-1])),
        rtol=1e-5, atol=1e-6)   # f32 cumsum order; an index off by one
                                # would move a mass by a whole bin (~0.1)
    wp = t(w_prop).requires_grad_(True)
    loss = tcrit.interlevel_loss(t(z_fine), t(w_fine), t(z_prop), wp)
    loss.backward()
    j_loss, j_grad = jax.value_and_grad(
        lambda w: jcrit.interlevel_loss(z_fine, w_fine, z_prop, w))(
        jnp.asarray(w_prop))
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=1e-6)
    np.testing.assert_allclose(wp.grad.numpy(), np.asarray(j_grad),
                               rtol=1e-5, atol=1e-7)


def test_psnr_and_subpixel_vs_jax():
    rng = np.random.RandomState(3)
    pred, target = rng.rand(40, 3).astype(np.float32), \
        rng.rand(40, 3).astype(np.float32)
    mask = rng.rand(40, 3) > 0.3
    np.testing.assert_allclose(float(tcrit.psnr(t(pred), t(target))),
                               float(jcrit.psnr(pred, target)), rtol=1e-6)
    np.testing.assert_allclose(
        float(tcrit.psnr(t(pred), t(target), torch.from_numpy(mask))),
        float(jcrit.psnr(pred, target, mask)), rtol=1e-6)
    np.testing.assert_allclose(tdownx.subpixel_mean(t(pred), 4).numpy(),
                               np.asarray(jdownx.subpixel_mean(pred, 4)),
                               rtol=1e-6)
    np.testing.assert_allclose(float(tdownx.subpixel_var(t(pred), 4)),
                               float(jdownx.subpixel_var(pred, 4)),
                               rtol=1e-5)


@pytest.mark.parametrize("policy", ["exp", "linear", "step"])
def test_lr_schedule_vs_jax(policy):
    opt = default_options("train", lr_policy=policy, n_epochs=12,
                          n_epochs_decay=5, lr_decay_epochs=3)
    jopt = j_default_options("train", lr_policy=policy, n_epochs=12,
                             n_epochs_decay=5, lr_decay_epochs=3)
    spe = 7
    port = make_lr_schedule(opt, spe)
    ref = make_jax_lr_schedule(jopt, spe)
    steps = range(0, spe * 13, 3)        # every epoch, through the decay
    got = np.array([port(s) for s in steps])
    want = np.array([float(ref(jnp.asarray(s))) for s in steps])
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert len(set(np.round(got, 12))) > 3      # the schedule moves


@pytest.mark.parametrize("clip", [0.0, 0.05, -0.01],
                         ids=["none", "norm", "value"])
def test_optimizer_step_vs_optax(clip):
    """Three steps of the port's Adam (+ clip) against optax's
    ``_make_tx`` chain on identical gradients."""
    extra = dict(grad_clip_val=abs(clip),
                 grad_clip_type="value" if clip < 0 else "norm",
                 lr=1e-2)
    jsys = j_create_model(j_default_options("train",
                                            **_kw("llff", "f32", **extra)))
    jstate = jsys.create_state(jax.random.PRNGKey(0), steps_per_epoch=1)
    tree = jax.tree_util.tree_map(np.array, jstate.params)
    system = create_model(default_options("train",
                                          **_kw("llff", "f32", **extra)),
                          device="cpu")
    state = system.create_state(0, steps_per_epoch=1)
    load_jax_params(state.params, tree)
    j_params, j_opt = tree, jsys.tx.init(tree)
    rng = np.random.RandomState(4)
    for step in range(3):
        grads = jax.tree_util.tree_map(
            lambda x: (rng.randn(*x.shape) * 0.01).astype(np.float32),
            j_params)
        updates, j_opt = jsys.tx.update(grads, j_opt, j_params)
        j_params = jax.tree_util.tree_map(np.asarray, optax.apply_updates(
            j_params, updates))
        grad_module = load_jax_params(system.init_params(0), grads)
        for p, g in zip(state.params.parameters(),
                        grad_module.parameters()):
            p.grad = g.detach().clone()
        system._clip_grads(state.params)
        state.optimizer.param_groups[0]["lr"] = system.lr_fn(state.step)
        state.optimizer.step()
        state.step += 1
    got = export_params(state.params)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(got),
                            jax.tree_util.tree_leaves(j_params)):
        # a few f32 ulps of parameters of order 1 (three updates)
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6,
                                   err_msg=str(path))


def test_export_params_round_trip():
    system = create_model(default_options("train", **_kw("llff", "f32")),
                          device="cpu")
    params = system.init_params(5)
    tree = export_params(params)
    assert tree["fine"]["params"]["xyz_encoding_5"]["kernel"].shape == \
        (319, 256)
    again = export_params(load_jax_params(system.init_params(6), tree))
    for a, b in zip(jax.tree_util.tree_leaves(tree),
                    jax.tree_util.tree_leaves(again)):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------
# the training buffer
# ---------------------------------------------------------------------

def _images(n, seed):
    w, h = HR_WH
    rng = np.random.RandomState(seed)
    return (rng.rand(n, h, w, 3) * 255).astype(np.uint8)


def test_train_buffer_matches_jax_data_helpers():
    views = LLFFDownXViews.spiral(FOCAL, HR_WH, 2, 3, radii=(0.2, 0.2, .05))
    imgs = _images(3, 0)
    train = LLFFDownXTrainViews(views.poses, imgs / 255.0, FOCAL, HR_WH, 2)
    buf = train.ray_buffer("cpu", include_var=False)
    keep = [i for i in range(3) if i != train.val_idx]
    assert train.val_idx == int(np.argmin(
        np.linalg.norm(views.poses[..., 3], axis=1)))
    w, h = HR_WH
    dirs = j_ray_dirs(h, w, FOCAL)
    ref = {k: [] for k in buf}
    for i in keep:
        ro, rd = j_rays_from_pose(dirs, views.poses[i])
        ro, rd = j_ndc(h, w, FOCAL, 1.0, ro.reshape(-1, 3),
                       rd.reshape(-1, 3))
        ref["origins"].append(j_group(ro.reshape(h, w, 3), 2))
        ref["directions"].append(j_group(rd.reshape(h, w, 3), 2))
        ref["near"].append(j_group(np.zeros((h, w, 1), np.float32), 2))
        ref["far"].append(j_group(np.ones((h, w, 1), np.float32), 2))
        lr = j_downscale(Image.fromarray(imgs[i]), 2, "avg")
        ref["rgbs"].append(lr.reshape(-1, 3))
        ref["rgbs_ori"].append(j_group(imgs[i] / np.float32(255.0), 2))
    for k, parts in ref.items():
        np.testing.assert_allclose(buf[k].numpy(), np.concatenate(parts),
                                   rtol=1e-5, atol=2e-6, err_msg=k)
    assert buf["origins"].shape == (2 * (w // 2) * (h // 2), 4, 3)
    assert len(train.ray_buffer("cpu")["rgbs"]) == 3 * (w // 2) * (h // 2)
    np.testing.assert_allclose(tviews.downscale_avg(imgs[0] / 255.0, 2),
                               j_downscale(Image.fromarray(imgs[0]), 2,
                                           "avg"), rtol=1e-6, atol=1e-7)
    with pytest.raises(NotImplementedError, match="lanc"):
        LLFFDownXTrainViews(views.poses, imgs / 255.0, FOCAL, HR_WH, 2,
                            ds_method="lanc").ray_buffer("cpu")


# ---------------------------------------------------------------------
# the slice as a whole
# ---------------------------------------------------------------------

def _batch(seed):
    """One whole 16x12 view's grouped rays (48 LR pixels, 192 HR rays)
    with random LR/HR colours."""
    views = LLFFDownXViews.spiral(FOCAL, HR_WH, 2, 3, radii=(0.2, 0.2, .05))
    imgs = _images(3, seed) / 255.0
    buf = LLFFDownXTrainViews(views.poses, imgs, FOCAL, HR_WH, 2
                              ).ray_buffer("cpu")
    n = (HR_WH[0] // 2) * (HR_WH[1] // 2)
    return {k: v[n:2 * n].numpy() for k, v in buf.items()}


def _jax_system(preset, precision, pallas, **extra):
    opt = j_default_options("train", **_kw(preset, precision, **extra),
                            **(PALLAS if pallas else {}))
    system = j_create_model(opt)
    state = system.create_state(jax.random.PRNGKey(0), steps_per_epoch=4)
    tree = jax.tree_util.tree_map(np.array, state.params)
    # a fresh init can put every density below 0 (an empty scene); a +3
    # sigma bias gives both sides a scene with content
    for net in tree.values():
        net["params"]["sigma"]["bias"] += 3.0
    return system, state, tree


def _jax_loss_and_grads(system, tree, batch):
    def loss_fn(params):
        return system._loss_fn(params, batch, jax.random.PRNGKey(1), 0)
    (loss, losses), grads = jax.value_and_grad(loss_fn, has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, tree))
    return float(loss), losses, jax.tree_util.tree_map(np.asarray, grads)


def _port_system(preset, precision, tree, **extra):
    system = create_model(default_options(
        "train", **_kw(preset, precision, **extra)), device="cpu")
    state = system.create_state(0, steps_per_epoch=4)
    load_jax_params(state.params, tree)
    return system, state


def _port_loss_and_grads(system, state, batch):
    loss, losses = system._loss_fn(state.params,
                                   {k: t(v) for k, v in batch.items()},
                                   None, 0)
    state.params.zero_grad(set_to_none=True)
    loss.backward()
    return loss.item(), losses, _grad_tree(state.params)


def _grad_tree(params):
    """The gradients in the JAX layout of ``export_params``."""
    return {key: {"params": {
        name: {"kernel": lin.weight.grad.numpy().T,
               "bias": lin.bias.grad.numpy()}
        for name, lin in module.named_children()
        if isinstance(lin, torch.nn.Linear)}}
        for key, module in params.items()}


def _rel_errs(got, ref):
    out = {}
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(ref),
                            jax.tree_util.tree_leaves(got)):
        a = np.asarray(a, np.float64)
        out[jax.tree_util.keystr(path)] = float(
            np.linalg.norm(np.asarray(b, np.float64) - a)
            / max(np.linalg.norm(a), 1e-12))
    return out


@pytest.mark.parametrize("pallas", [False, True], ids=["plain", "pallas"])
@pytest.mark.parametrize("preset", ["llff", "parity"])
def test_loss_fn_and_grads_match_jax_f32(preset, pallas,
                                         interpret_composite):
    batch = _batch(1)
    extra = dict(randomized=False, noise_std=0.0)
    jsys, _, tree = _jax_system(preset, "f32", pallas, **extra)
    j_loss, j_losses, j_grads = _jax_loss_and_grads(jsys, tree, batch)
    system, state = _port_system(preset, "f32", tree, **extra)
    loss, losses, grads = _port_loss_and_grads(system, state, batch)
    assert system.render_cfg.use_fused_mlp
    np.testing.assert_allclose(loss, j_loss, rtol=LOSS_RTOL)
    for k in j_losses:
        np.testing.assert_allclose(losses[k].item(), float(j_losses[k]),
                                   rtol=1e-4, err_msg=k)
    rel = _rel_errs(grads, j_grads)
    assert len(rel) == (48 if preset == "parity" else 32)
    assert max(rel.values()) < GRAD_REL, rel
    assert np.median(list(rel.values())) < GRAD_REL_MEDIAN, rel
    # a nonzero gradient reached every leaf
    for leaf in jax.tree_util.tree_leaves(grads):
        assert np.abs(leaf).max() > 0


def test_loss_fn_and_grads_match_jax_mixed():
    """Mixed precision: the port (kernel C/E's rule) against JAX's flax
    bf16 path, with the loose bars stated at the top."""
    batch = _batch(2)
    extra = dict(randomized=False, noise_std=0.0)
    jsys, _, tree = _jax_system("llff", "mixed", False, **extra)
    j_loss, _, j_grads = _jax_loss_and_grads(jsys, tree, batch)
    system, state = _port_system("llff", "mixed", tree, **extra)
    loss, _, grads = _port_loss_and_grads(system, state, batch)
    np.testing.assert_allclose(loss, j_loss, rtol=MIXED_LOSS_RTOL)
    rel = _rel_errs(grads, j_grads)
    assert max(rel.values()) < MIXED_GRAD_REL, rel


def test_train_step_matches_jax():
    """One ``train_step`` on the same batch. Adam's first update is
    lr * g / (|g| + eps), i.e. about lr * sign(g): where both sides'
    gradients are well away from zero the new parameters agree to f32
    rounding; where a gradient is within the two sides' difference of
    zero its sign may differ, so every parameter is held to 2 lr."""
    batch = _batch(3)
    extra = dict(randomized=False, noise_std=0.0)
    jsys, jstate, tree = _jax_system("llff", "f32", False, **extra)
    _, _, j_grads = _jax_loss_and_grads(jsys, tree, batch)
    jstate = jstate.replace(
        params=jax.tree_util.tree_map(jnp.asarray, tree),
        opt_state=jsys.tx.init(jax.tree_util.tree_map(jnp.asarray, tree)))
    jstate, _ = jsys.train_step(jstate, batch, jax.random.PRNGKey(2))
    j_new = jax.tree_util.tree_map(np.asarray, jstate.params)
    system, state = _port_system("llff", "f32", tree, **extra)
    state, losses = system.train_step(
        state, {k: t(v) for k, v in batch.items()})
    assert state.step == 1 and np.isfinite(float(losses["tot"]))
    lr = system.lr_fn(0)
    new = export_params(state.params)
    n_close = n_all = 0
    for a, b, g0, g in zip(jax.tree_util.tree_leaves(new),
                           jax.tree_util.tree_leaves(j_new),
                           jax.tree_util.tree_leaves(tree),
                           jax.tree_util.tree_leaves(j_grads)):
        diff = np.abs(a - b)
        assert diff.max() <= 2 * lr * (1 + 1e-5)
        # |g| well above Adam's eps (1e-8): the update is lr * sign(g)
        # to within 1e-3 of lr
        firm = np.abs(g) > max(1e-3 * np.abs(g).max(), 1e-5)
        np.testing.assert_allclose(a[firm], b[firm], rtol=0,
                                   atol=1e-6 + 1e-6 * np.abs(g0).max())
        n_close += int(firm.sum())
        n_all += g.size
    assert n_close > 0.5 * n_all


def test_training_loss_falls_on_cpu():
    """A few randomized steps of the tiny system from a teacher scene:
    the loss stays finite and falls."""
    system = create_model(default_options(
        "train", **_kw("llff", "f32", batch_size=32, include_var=True,
                       ds_method="avg")), device="cpu")
    teacher = system.init_params(1)
    with torch.no_grad():
        for net in teacher.values():
            net.sigma.bias += 3.0
    views = LLFFDownXTrainViews.rendered(system, teacher, FOCAL, HR_WH, 2, 3)
    assert views.images.std() > 0.01
    buf = views.ray_buffer("cpu")
    state = system.create_state(0, steps_per_epoch=8)
    gen = torch.Generator().manual_seed(0)
    tots = []
    for _ in range(12):
        state, losses = system.train_steps(state, buf, 1, gen)
        assert all(np.isfinite(float(v)) for v in losses.values())
        tots.append(float(losses["fine_mse"]))
    assert state.step == 12
    assert np.mean(tots[-3:]) < 0.7 * np.mean(tots[:2]), tots
    for group in state.optimizer.state.values():
        assert torch.isfinite(group["exp_avg"]).all()
        assert torch.isfinite(group["exp_avg_sq"]).all()
