"""The port's core math (``nerfsr_torch.core``) against the JAX package's
(``nerfsr_tpu.core``), on the same numpy inputs, in f32.

Random draws that JAX makes from a key are drawn here with the same key
and handed to the port explicitly, so randomized paths compare too.
Tolerance: f32 rounding (rtol 1e-5 / atol 1e-6 unless stated): both sides
run the same formulas, with reductions in a different order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch's threads in a test worker)

from nerfsr_tpu.core import encoding as jenc
from nerfsr_tpu.core import rays as jrays
from nerfsr_tpu.core import rendering as jrend
from nerfsr_tpu.core import sampling as jsamp

from nerfsr_torch.core import encoding as tenc
from nerfsr_torch.core import rays as trays
from nerfsr_torch.core import rendering as trend
from nerfsr_torch.core import sampling as tsamp

RTOL, ATOL = 1e-5, 1e-6
# inverse-CDF depths: a CDF rounding of ~1e-7 (another summation order)
# moves z by that over the local density, which sparse bins amplify
Z_ATOL = 1e-4


def close(got, ref, rtol=RTOL, atol=ATOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(ref), rtol=rtol, atol=atol)


def t(x):
    return torch.from_numpy(np.asarray(x, np.float32).copy())


def rays_np(n=12, seed=0):
    rng = np.random.RandomState(seed)
    o = (rng.randn(n, 3) * 0.1).astype(np.float32)
    d = rng.randn(n, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def hist_np(n=10, s=33, seed=0):
    """Sorted depths and non-negative weights with degenerate rows."""
    rng = np.random.RandomState(seed)
    z = np.sort(rng.rand(n, s).astype(np.float32), -1)
    w = rng.rand(n, s).astype(np.float32)
    w[0] = 0.0            # degenerate denominators everywhere
    w[1, 3:6] = 50.0      # concentrated mass
    return z, w


@pytest.mark.parametrize("num_freqs,identity,log_scale", [
    (10, True, True), (4, True, True), (6, False, True), (3, True, False),
    (0, True, True)])
def test_positional_encoding(num_freqs, identity, log_scale):
    x = np.random.RandomState(1).randn(5, 7, 3).astype(np.float32)
    ref = jenc.positional_encoding(jnp.asarray(x), num_freqs, identity,
                                   log_scale)
    got = tenc.positional_encoding(t(x), num_freqs, identity, log_scale)
    assert got.shape == ref.shape
    assert got.shape[-1] == tenc.posenc_channels(3, num_freqs, identity) \
        == jenc.posenc_channels(3, num_freqs, identity)
    close(got, ref)


@pytest.mark.parametrize("centers", [True, False])
def test_ray_directions_non_square(centers):
    ref = jrays.get_ray_directions(6, 10, 7.5, centers)
    got = trays.get_ray_directions(6, 10, 7.5, centers)
    assert got.shape == (6, 10, 3)
    close(got, ref)


def test_get_rays_ndc_and_make_rays():
    dirs = np.asarray(jrays.get_ray_directions(4, 6, 5.0))
    th = 0.3
    c2w = np.array([[np.cos(th), -np.sin(th), 0, 0.1],
                    [np.sin(th), np.cos(th), 0, -0.2],
                    [0, 0, 1, 0.5]], np.float32)
    jo, jd = jrays.get_rays(jnp.asarray(dirs), jnp.asarray(c2w))
    to, td = trays.get_rays(t(dirs), t(c2w))
    close(to, jo)
    close(td, jd)
    jno, jnd = jrays.ndc_rays(4, 6, 5.0, 1.0, jo, jd)
    tno, tnd = trays.ndc_rays(4, 6, 5.0, 1.0, to, td)
    close(tno, jno, atol=1e-5)
    close(tnd, jnd, atol=1e-5)
    jr = jrays.make_rays(jno, jnd, 0.0, 1.0, jd)
    tr = trays.make_rays(tno, tnd, 0.0, 1.0, td)
    for a, b in zip(tr, jr):
        assert tuple(a.shape) == tuple(b.shape)
        close(a, b, atol=1e-5)


@pytest.mark.parametrize("randomized,lindisp", [
    (False, False), (False, True), (True, False)])
def test_sample_along_rays(randomized, lindisp):
    o, d = rays_np()
    near, far = np.full((12, 1), 0.5, np.float32), np.full((12, 1), 4.0,
                                                           np.float32)
    key = jax.random.PRNGKey(3)
    jz, jp = jsamp.sample_along_rays(key, jnp.asarray(o), jnp.asarray(d),
                                     jnp.asarray(near), jnp.asarray(far),
                                     16, randomized, lindisp)
    # the jitter JAX draws inside, drawn here from the same key
    u = t(jax.random.uniform(key, (12, 16))) if randomized else None
    tz, tp = tsamp.sample_along_rays(t(o), t(d), t(near), t(far), 16,
                                     randomized, lindisp, u=u)
    close(tz, jz)
    close(tp, jp)


def test_invert_cdf_plain():
    z, w = hist_np()
    bins = 0.5 * (z[:, :-1] + z[:, 1:])
    inner = w[:, 1:-1]
    u = np.random.RandomState(2).rand(10, 20).astype(np.float32)
    u[2, :3] = [0.0, 1.0, 0.5]
    ref = jsamp._invert_cdf(jnp.asarray(bins), jnp.asarray(inner),
                            jnp.asarray(u))
    got = tsamp._invert_cdf(t(bins), t(inner), t(u))
    close(got, ref, atol=Z_ATOL)


@pytest.mark.parametrize("randomized", [False, True])
def test_sample_pdf_and_stratified(randomized):
    z, w = hist_np(seed=4)
    bins = 0.5 * (z[:, :-1] + z[:, 1:])
    inner = w[:, 1:-1]
    key = jax.random.PRNGKey(5)
    ref = jsamp.sample_pdf(key, jnp.asarray(bins), jnp.asarray(inner), 8,
                           randomized)
    u = t(jax.random.uniform(key, (10, 8))) if randomized else None
    close(tsamp.sample_pdf(t(bins), t(inner), 8, randomized, u=u), ref,
          atol=Z_ATOL)
    ref = jsamp.sample_pdf_stratified(key, jnp.asarray(bins),
                                      jnp.asarray(inner), 8, randomized)
    got = tsamp.sample_pdf_stratified(t(bins), t(inner), 8, randomized,
                                      jitter=u)
    close(got, ref, atol=Z_ATOL)
    assert bool((got[:, 1:] >= got[:, :-1]).all())   # sorted per ray


def test_resample_along_rays():
    o, d = rays_np(n=10)
    z, w = hist_np()
    jz, jp = jsamp.resample_along_rays(None, jnp.asarray(o), jnp.asarray(d),
                                       jnp.asarray(z), jnp.asarray(w), 12,
                                       False)
    tz, tp = tsamp.resample_along_rays(t(o), t(d), t(z), t(w), 12, False)
    assert tz.shape == (10, 33 + 12)
    close(tz, jz, atol=Z_ATOL)
    close(tp, jp, atol=Z_ATOL)


@pytest.mark.parametrize("kind", ["relu", "softplus"])
def test_sigma_activation(kind):
    x = np.linspace(-30, 30, 121).astype(np.float32)
    close(trend.sigma_activation(t(x), kind),
          jrend.sigma_activation(jnp.asarray(x), kind))
    with pytest.raises(ValueError):
        trend.sigma_activation(t(x), "tanh")


@pytest.mark.parametrize("white_bkgd", [False, True])
@pytest.mark.parametrize("act", ["relu", "softplus"])
def test_volumetric_rendering_plain(white_bkgd, act):
    rng = np.random.RandomState(6)
    rgb = rng.rand(9, 24, 3).astype(np.float32)
    sigma = (rng.randn(9, 24) * 2).astype(np.float32)
    z = np.sort(rng.rand(9, 24).astype(np.float32) * 4 + 1, -1)
    ref = jrend.volumetric_rendering(jnp.asarray(rgb), jnp.asarray(sigma),
                                     jnp.asarray(z), white_bkgd, act)
    got = trend.volumetric_rendering(t(rgb), t(sigma), t(z), white_bkgd, act)
    for g, r in zip(got, ref):
        close(g, r, rtol=2e-5, atol=1e-6)
    close(trend.compute_weights(t(sigma), t(z), act),
          jrend.compute_weights(jnp.asarray(sigma), jnp.asarray(z), act),
          rtol=2e-5, atol=1e-6)


def test_add_gaussian_noise():
    raw = np.random.RandomState(7).randn(4, 6).astype(np.float32)
    key = jax.random.PRNGKey(8)
    ref = jrend.add_gaussian_noise(key, jnp.asarray(raw), True, 0.5)
    noise = t(jax.random.normal(key, (4, 6)))
    close(trend.add_gaussian_noise(t(raw), True, 0.5, noise=noise), ref)
    # not randomized, or no noise: the input comes back untouched
    assert torch.equal(trend.add_gaussian_noise(t(raw), False, 0.5), t(raw))
    assert torch.equal(trend.add_gaussian_noise(t(raw), True, 0.0), t(raw))
    gen = torch.Generator().manual_seed(0)
    drawn = trend.add_gaussian_noise(t(raw), True, 0.5, generator=gen)
    assert drawn.shape == (4, 6) and not torch.equal(drawn, t(raw))
