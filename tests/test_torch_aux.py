"""The auxiliary training paths' pieces on the CPU, against the JAX
package: the TV and both depth Laplacians, ``gan_loss`` in its three
modes, the WGAN gradient penalty, the spectral-norm discriminator (logits,
the refreshed ``u`` and sigma, gradients), the VGG perceptual loss's five
taps and loss on the synthetic archive, the datasets' auxiliary buffers
and samplers, and the patches made on the device (``_patch_rays_at``).
Inputs are numpy draws from a seed fed to both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch's threads in a test worker)

from nerfsr_tpu.config import default_options as j_default_options
from nerfsr_tpu.data.llff_downx import LLFFDownXDataset as JDataset
from nerfsr_tpu.models import create_model as j_create_model
from nerfsr_tpu.models import criterions as jcrit
from nerfsr_tpu.models.networks import NLayerDiscriminator as JDisc

from nerfsr_torch.config import default_options
from nerfsr_torch.data.llff_downx import LLFFDownXDataset
from nerfsr_torch.models import create_model
from nerfsr_torch.models import criterions as crit
from nerfsr_torch.models.networks import NLayerDiscriminator
from nerfsr_torch.weights import export_discriminator, load_discriminator

# losses and logits: f32 sums in another order
LOSS_RTOL = 1e-5
# a gradient leaf: f32 convolutions' and sums' rounding, relative to the
# leaf's largest element
GRAD_REL = 1e-5
# VGG's gradient, norm-relative: the deepest tap (relu5_2, 2x2 at 32 px)
# has elements at relu's kink that one side rounds to 0 and the other to
# +1e-7, so the L1 term's sign there is 0 on one side and 1 on the other
# (measured: the sum of squares of that tap agrees to 2e-6, its L1 term
# to 2.5e-2, the whole loss's gradient to 1.4e-2)
VGG_GRAD_REL = 5e-2


def t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _close_grads(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    bar = GRAD_REL * np.abs(want).max() + 1e-9
    assert np.abs(got - want).max() <= bar, (what, np.abs(got - want).max(),
                                             bar)


# ---------------------------------------------------------------------
# the spatial losses
# ---------------------------------------------------------------------

@pytest.mark.parametrize("name", ["tv", "laplacian", "bilateral"])
def test_spatial_losses_and_gradients_match_jax(name):
    rng = np.random.RandomState(0)
    depth = rng.rand(2, 6, 7).astype(np.float32)
    rgb = rng.rand(2, 6, 7, 3).astype(np.float32)
    fns = {"tv": (lambda d, c: jcrit.tv_loss(c, 0.7),
                  lambda d, c: crit.tv_loss(c, 0.7)),
           "laplacian": (lambda d, c: jcrit.laplacian_loss(d),
                         lambda d, c: crit.laplacian_loss(d)),
           "bilateral": (lambda d, c: jcrit.bilateral_laplacian_loss(
               d, c, 0.3), lambda d, c: crit.bilateral_laplacian_loss(
               d, c, 0.3))}
    jfn, fn = fns[name]
    want, (gd, gc) = jax.value_and_grad(jfn, argnums=(0, 1))(
        jnp.asarray(depth), jnp.asarray(rgb))
    d, c = t(depth).requires_grad_(), t(rgb).requires_grad_()
    got = fn(d, c)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=LOSS_RTOL)
    for a, b, what in ((d.grad, gd, "depth"), (c.grad, gc, "rgb")):
        _close_grads(a if a is not None else np.zeros(b.shape), b, what)


@pytest.mark.parametrize("mode", ["vanilla", "lsgan", "wgangp"])
def test_gan_loss_matches_jax(mode):
    logits = np.random.RandomState(1).randn(3, 1, 1, 1).astype(np.float32)
    for real in (True, False):
        want, gw = jax.value_and_grad(
            lambda x: jcrit.gan_loss(x, real, mode))(jnp.asarray(logits))
        x = t(logits).requires_grad_()
        got = crit.gan_loss(x, real, mode)
        got.backward()
        np.testing.assert_allclose(got.item(), float(want), rtol=LOSS_RTOL,
                                   err_msg=f"{mode} real={real}")
        _close_grads(x.grad, gw, f"{mode} real={real}")
    np.testing.assert_allclose(
        crit.sigmoid_bce(t(logits), torch.full((3, 1, 1, 1), 0.3)).numpy(),
        jcrit.optax_sigmoid_bce(logits, 0.3), rtol=LOSS_RTOL)
    with pytest.raises(ValueError, match="unknown gan mode"):
        crit.gan_loss(t(logits), True, "hinge")


# ---------------------------------------------------------------------
# the discriminator
# ---------------------------------------------------------------------

def _discriminators(patch_len, ndf=8, seed=0):
    jd = JDisc(ndf=ndf, patch_len=patch_len)
    v = jax.jit(jd.init)(jax.random.PRNGKey(seed),
                         jnp.zeros((1, patch_len, patch_len, 3)))
    v = jax.tree_util.tree_map(np.asarray, v)
    net = load_discriminator(NLayerDiscriminator(ndf, patch_len), v)
    return jd, v, net


@pytest.mark.parametrize("patch_len", [32, 64])
def test_discriminator_matches_jax(patch_len):
    """Logits, the refreshed ``u`` and sigma (flax's ``update_stats``),
    the weight gradients through sigma, and the variables' round trip."""
    jd, v, net = _discriminators(patch_len)
    x = np.random.RandomState(2).rand(2, patch_len, patch_len, 3).astype(
        np.float32)
    ex = export_discriminator(net)
    assert jax.tree_util.tree_structure(ex) == \
        jax.tree_util.tree_structure(v)
    for a, b in zip(jax.tree_util.tree_leaves(ex),
                    jax.tree_util.tree_leaves(v)):
        np.testing.assert_array_equal(a, b)
    want = jax.jit(jd.apply)(v, jnp.asarray(x))
    got = net(t(x))
    assert got.shape == want.shape == (2, 1, 1, 1)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=LOSS_RTOL, atol=1e-6)

    def loss(p):
        return jnp.sum(jd.apply({"params": p,
                                 "batch_stats": v["batch_stats"]},
                                jnp.asarray(x)) ** 2)
    jgrads = jax.jit(jax.grad(loss))(v["params"])
    (got ** 2).sum().backward()
    for name, m in net.spectral_convs():
        _close_grads(m.weight.grad.numpy(),
                     np.asarray(jgrads[name]["kernel"]).transpose(3, 2, 0, 1),
                     name)

    _, mut = jax.jit(lambda v, x: jd.apply(v, x, update_stats=True,
                                           mutable=["batch_stats"]))(
        v, jnp.asarray(x))
    net.refresh_stats()
    for a, b in zip(jax.tree_util.tree_leaves(
            export_discriminator(net)["batch_stats"]),
            jax.tree_util.tree_leaves(mut["batch_stats"])):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="32 or 64"):
        NLayerDiscriminator(8, 48)


@pytest.mark.parametrize("use_grad", [False, True], ids=["rgb", "grad"])
def test_gradient_penalty_matches_jax(use_grad):
    """WGAN-GP on interpolates with one draw fed to both sides: the value
    and its gradient with respect to D's weights (a double backward)."""
    jd, v, net = _discriminators(32)
    system = create_model(default_options(
        "train", model="nerf_downX", dataset_mode="llff_downX",
        img_wh=(8, 8), D=2, W=32), device="cpu")
    jsys = j_create_model(j_default_options(
        "train", model="nerf_downX", dataset_mode="llff_downX",
        img_wh=(8, 8), D=2, W=32))
    rng = np.random.RandomState(3)
    real = rng.rand(1, 32, 32, 3).astype(np.float32)
    fake = rng.rand(1, 32, 32, 3).astype(np.float32)
    key = jax.random.PRNGKey(4)
    eps = np.asarray(jax.random.uniform(key, (1, 1, 1, 1)))

    def j_in(x):
        return jsys._img_grad_mag(x) if use_grad else x

    def jloss(p):
        return jcrit.wgan_gradient_penalty(
            lambda x: jd.apply({"params": p,
                                "batch_stats": v["batch_stats"]}, j_in(x)),
            key, jnp.asarray(real), jnp.asarray(fake))
    want, jgrads = jax.jit(jax.value_and_grad(jloss))(v["params"])

    def d_in(x):
        return system._img_grad_mag(x) if use_grad else x
    got = crit.wgan_gradient_penalty(lambda x: net(d_in(x)), t(real),
                                     t(fake), t(eps))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-4)
    for name, m in net.spectral_convs():
        _close_grads(m.weight.grad.numpy(),
                     np.asarray(jgrads[name]["kernel"]).transpose(3, 2, 0, 1),
                     name)


# ---------------------------------------------------------------------
# VGG
# ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def vgg_npz(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("vgg") / "vgg.npz")
    return crit.write_synthetic_vgg_npz(path, seed=0)


def test_synthetic_vgg_archive_is_the_jax_packages(vgg_npz, tmp_path):
    jpath = jcrit.write_synthetic_vgg_npz(str(tmp_path / "j.npz"), seed=0)
    a, b = np.load(vgg_npz), np.load(jpath)
    assert sorted(a.files) == sorted(b.files) and len(a.files) == 28
    for k in b.files:
        np.testing.assert_array_equal(a[k], b[k])


def test_vgg_taps_and_loss_match_jax(vgg_npz):
    """The five relu taps on 32x32 inputs in (-1, 1), the weighted L1
    loss, its gradient with respect to the prediction (none to the
    target); and the loss refuses to run without an archive."""
    rng = np.random.RandomState(5)
    pred = (rng.rand(2, 32, 32, 3) * 2 - 1).astype(np.float32)
    target = (rng.rand(2, 32, 32, 3) * 2 - 1).astype(np.float32)
    jvgg, vgg = jcrit.VGGPerceptualLoss(vgg_npz), crit.VGGPerceptualLoss(
        vgg_npz)
    jtaps = jvgg.features(jnp.asarray(pred))
    taps = vgg.features(t(pred))
    assert len(taps) == len(jtaps) == 5
    for i, (a, b) in enumerate(zip(taps, jtaps)):
        b = np.asarray(b).transpose(0, 3, 1, 2)
        assert a.shape == b.shape, i
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-4,
                                   atol=1e-5 * np.abs(b).max(),
                                   err_msg=f"tap {i}")
    want, jg = jax.value_and_grad(lambda p: jvgg(p, jnp.asarray(target)))(
        jnp.asarray(pred))
    p, tg = t(pred).requires_grad_(), t(target).requires_grad_()
    got = vgg(p, tg)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=LOSS_RTOL)
    jg = np.asarray(jg)
    assert np.linalg.norm(p.grad.numpy() - jg) <= \
        VGG_GRAD_REL * np.linalg.norm(jg)
    assert tg.grad is None
    with pytest.raises(FileNotFoundError, match="vgg_weights"):
        crit.VGGPerceptualLoss(None).features(t(pred))


# ---------------------------------------------------------------------
# the datasets' auxiliary buffers and the patches made on the device
# ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    import sys
    import pathlib
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
    from tools.make_synthetic_llff import make_llff_scene
    d = tmp_path_factory.mktemp("llff")
    make_llff_scene(str(d), hw=(24, 32), n_imgs=4)
    return str(d)


def _ds_opts(scene, **extra):
    kw = dict(model="nerf_downX", dataset_mode="llff_downX",
              dataset_root=scene, img_wh=(32, 24), downscale=2,
              fast_preset="llff", patch_len=16, reg_patch_len=3,
              ref_idx=1)
    kw.update(extra)
    return default_options("train", **kw), j_default_options("train", **kw)


def _same(got, want):
    assert set(got) == set(want)
    for k in want:
        if k.startswith("rgbs") or k == "real_idx":
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6,
                                       err_msg=k)


@pytest.mark.parametrize("option", ["ref", "all_ref"])
def test_aux_samplers_match_jax(scene, option):
    """``patch_buffer`` (inclusive bounds), ``gan_patch`` (the exclusive
    upper bound) from the same RandomState, and ``gan_raygen_buffers``;
    with ``--all_ref`` the real pixels are each view's own."""
    opt, jopt = _ds_opts(scene, all_ref=option == "all_ref",
                         include_var=option == "all_ref")
    ds, jds = LLFFDownXDataset(opt, "train"), JDataset(jopt, "train")
    assert ds._usable_views() == jds._usable_views()
    got = ds.patch_buffer(np.random.RandomState(7), 4)
    want = jds.patch_buffer(np.random.RandomState(7), 4)
    for a, b in zip(got, want):
        _same(a, b)
        assert a["origins"].shape == (9, 4, 3)
    rng, jrng = np.random.RandomState(8), np.random.RandomState(8)
    for _ in range(3):
        _same(ds.gan_patch(rng), jds.gan_patch(jrng))
    (bufs, geom), (jbufs, jgeom) = ds.gan_raygen_buffers(), \
        jds.gan_raygen_buffers()
    assert geom == jgeom
    _same(bufs, jbufs)


@pytest.fixture(scope="module")
def systems():
    kw = dict(model="nerf_downX", dataset_mode="llff_downX",
              img_wh=(32, 24), downscale=2, fast_preset="llff",
              patch_len=16, reg_patch_len=2, D=2, W=32)
    return (create_model(default_options("train", **kw), device="cpu"),
            j_create_model(j_default_options("train", **kw)))


@pytest.mark.parametrize("geom_kind", ["ndc", "world"])
def test_patches_made_on_the_device_match_jax(scene, systems, geom_kind):
    """``_gan_patch_at`` and the reg block's rays (``_reg_sample_rays``
    with injected draws) against JAX's ``_gan_patch_at`` and
    ``_patch_rays_at`` at the same view and LR position, and the draws'
    ranges: the GAN's exclusive upper bound, the reg block's
    inclusive one."""
    system, jsys = systems
    opt, jopt = _ds_opts(scene, spheric_poses=geom_kind == "world")
    bufs, geom = LLFFDownXDataset(opt, "train").gan_raygen_buffers()
    assert geom[0] == geom_kind
    dev = system.upload_gan_buffers(bufs)
    jbufs = {k: jnp.asarray(v) for k, v in bufs.items()}
    for view, r0, c0 in ((0, 0, 0), (2, 3, 7), (1, 4, 8)):
        draws = torch.tensor([view, r0, c0])
        rays, real = system._gan_sample_patch(dev, geom, None, draws)
        jrays, jreal = jsys._gan_patch_at(jbufs, geom, view, r0, c0)
        np.testing.assert_array_equal(real.numpy(), np.asarray(jreal))
        for a, b in zip(rays, jrays):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=1e-6)
        rays = system._reg_sample_rays(dev, geom, None, draws)
        jrays = jsys._patch_rays_at(jbufs, geom, view, r0 * 2, c0 * 2, 4)
        for a, b in zip(rays, jrays):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=1e-6)
    # the draws' ranges (12 x 16 LR): the GAN patch's 8 LR pixels with
    # the exclusive upper bound, the reg block's 2 with the inclusive one
    bounds = []
    real_draw = system._draw
    system._draw = lambda n, gen: (bounds.append(n), real_draw(n, gen))[1]
    try:
        system._gan_sample_patch(dev, geom, None)
        system._reg_sample_rays(dev, geom, None)
    finally:
        system._draw = real_draw
    assert bounds == [3, 12 - 8, 16 - 8, 3, 12 - 2 + 1, 16 - 2 + 1]
