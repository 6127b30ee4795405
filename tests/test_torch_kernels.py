"""The port's kernel wrappers on the CPU (where each takes its plain
version) against the JAX package's Pallas kernels, run in interpret mode
as ``tests/test_pallas.py`` runs them, and against their jnp counterparts.

The backward kernels' plain versions (D: ``composite_bwd_plain``, E:
``fused_mlp_bwd_plain``) are held against the JAX package's backward
kernels in interpret mode, its XLA backward and torch autograd.

Also checks what the CUDA kernels rely on and the CPU can reach: kernel
C's packed weight layout (walked here exactly as ``csrc/fused_mlp.cu``
walks it), that gradients flow through the wrappers' autograd Functions,
and that the CPU path launches nothing.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfsr_tpu.core.rendering import volumetric_rendering as j_composite
from nerfsr_tpu.core.sampling import _invert_cdf as j_invert_cdf
from nerfsr_tpu.ops.experimental.pallas_composite import (
    _run_bwd, pallas_volumetric_rendering)
from nerfsr_tpu.ops.experimental.pallas_sampling import (
    pallas_invert_cdf, pallas_sample_pdf_stratified)

from nerfsr_torch.core.rendering import volumetric_rendering as \
    plain_composite
from nerfsr_torch.kernels import COUNTS, reset_counts
from nerfsr_torch.kernels import composite as kcomposite
from nerfsr_torch.kernels import mlp as kmlp
from nerfsr_torch.kernels import sampling as ksampling

# inverse-CDF depths: a CDF rounding of ~1e-7 (another summation order)
# moves z by that over the local density, which sparse bins amplify
Z_ATOL = 1e-4
# composite: the bar of tests/test_pallas.py for the TPU kernel
COMPOSITE_TOL = dict(rtol=2e-4, atol=1e-5)
# fused MLP in f32: the bar of tests/test_pallas.py (same math, another
# matmul summation order)
MLP_F32_TOL = dict(rtol=1e-4, atol=1e-5)
# composite backward: the bar of tests/test_pallas.py for the TPU
# kernel's gradients is rtol 5e-3, atol 5e-5; the port holds a tighter
# one (seen: 1.9e-6 abs against the JAX kernel, 1.4e-6 against
# autograd, on gradients of order 1-100)
COMPOSITE_BWD_TOL = dict(rtol=1e-4, atol=1e-6)
# MLP backward in f32: the bar of tests/test_pallas.py for the v3
# kernel's weight gradients (sums over the points in another order;
# seen: 9.1e-6 abs against v3, 1.1e-5 against the XLA backward)
MLP_BWD_F32_TOL = dict(rtol=5e-3, atol=1e-4)


def t(x):
    return torch.from_numpy(np.asarray(x, np.float32).copy())


def hist(n, b, seed):
    rng = np.random.RandomState(seed)
    z = np.sort(rng.rand(n, b + 1).astype(np.float32), -1)
    bins = 0.5 * (z[:, :-1] + z[:, 1:])
    w = rng.rand(n, b - 1).astype(np.float32)
    w[0] = 0.0            # degenerate-denominator row
    w[1, :2] = 100.0      # concentrated mass
    return bins, w


@pytest.mark.parametrize("b,q", [(47, 24), (23, 16)])
def test_invert_cdf_vs_pallas_and_jnp(b, q):
    """The slice's two (B, Q) pairs."""
    bins, w = hist(16, b, seed=b)
    u = ((np.arange(q) + np.random.RandomState(q).rand(16, q)) / q
         ).astype(np.float32)
    reset_counts()
    got = ksampling.invert_cdf(t(bins), t(w), t(u)).numpy()
    assert COUNTS["invert_cdf"] == 0        # CPU: plain version, no launch
    pallas = pallas_invert_cdf(jnp.asarray(bins), jnp.asarray(w),
                               jnp.asarray(u), interpret=True)
    plain = j_invert_cdf(jnp.asarray(bins), jnp.asarray(w), jnp.asarray(u))
    np.testing.assert_allclose(got, np.asarray(pallas), atol=Z_ATOL)
    np.testing.assert_allclose(got, np.asarray(plain), atol=Z_ATOL)


def test_sample_pdf_stratified_wrapper_vs_pallas():
    bins, w = hist(24, 31, seed=3)
    ref = pallas_sample_pdf_stratified(None, jnp.asarray(bins),
                                       jnp.asarray(w), 24, False,
                                       interpret=True)
    got = ksampling.sample_pdf_stratified(t(bins), t(w), 24, False)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=Z_ATOL)
    # outputs are detached, as the JAX wrapper stop-gradients them
    wg = t(w).requires_grad_(True)
    assert not ksampling.sample_pdf_stratified(t(bins), wg, 8,
                                               False).requires_grad


@pytest.mark.parametrize("white_bkgd", [False, True])
@pytest.mark.parametrize("act", ["relu", "softplus"])
def test_composite_vs_pallas_and_jnp(white_bkgd, act):
    rng = np.random.RandomState(0)
    rgb = rng.rand(32, 16, 3).astype(np.float32)
    sigma = (rng.randn(32, 16) * 2).astype(np.float32)
    z = np.sort(rng.rand(32, 16).astype(np.float32), -1)
    got = kcomposite.volumetric_rendering(t(rgb), t(sigma), t(z),
                                          white_bkgd, act)
    pallas = pallas_volumetric_rendering(jnp.asarray(rgb),
                                         jnp.asarray(sigma), jnp.asarray(z),
                                         white_bkgd, act, True)
    plain = j_composite(jnp.asarray(rgb), jnp.asarray(sigma),
                        jnp.asarray(z), white_bkgd, act)
    for g, p, r in zip(got, pallas, plain):
        np.testing.assert_allclose(g.numpy(), np.asarray(p), **COMPOSITE_TOL)
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **COMPOSITE_TOL)


def test_composite_grad_guard():
    """Gradients flow through the wrapper (kernel D's plain version on
    the CPU) and equal autograd of the plain forward; an unknown
    activation still raises."""
    rgb = torch.rand(4, 8, 3, requires_grad=True)
    sigma = torch.randn(4, 8, requires_grad=True)
    z = torch.sort(torch.rand(4, 8), -1)[0].requires_grad_(True)
    reset_counts()
    out = kcomposite.volumetric_rendering(rgb, sigma, z, False)
    grads = torch.autograd.grad(_composite_loss(out), (rgb, sigma, z))
    ref = torch.autograd.grad(
        _composite_loss(plain_composite(rgb, sigma, z, False)),
        (rgb, sigma, z))
    for g, r in zip(grads, ref):
        torch.testing.assert_close(g, r, **COMPOSITE_BWD_TOL)
    assert COUNTS["composite_bwd"] == 0      # CPU: plain version
    assert out[0].shape == (4, 3)
    with pytest.raises(ValueError):
        kcomposite.volumetric_rendering(rgb, sigma.detach(), z, False,
                                        "tanh")


def _composite_loss(out):
    """A loss that gives every output a nonzero cotangent."""
    c, d, o, w = out
    return ((c ** 2).sum() + torch.sin(d).sum() + 0.3 * o.sum()
            + (w * torch.linspace(-1, 1, w.shape[-1])).sum())


def _cotangents(n, s, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, 3).astype(np.float32),
            rng.randn(n).astype(np.float32),
            rng.randn(n).astype(np.float32),
            rng.randn(n, s).astype(np.float32))


@pytest.mark.parametrize("white_bkgd", [False, True])
@pytest.mark.parametrize("act", ["relu", "softplus"])
def test_composite_bwd_vs_pallas_and_autograd(white_bkgd, act):
    """Kernel D's plain version against the JAX backward kernel
    (interpret mode) and against torch autograd of the plain forward,
    with nonzero gc, gd, go and gw."""
    rng = np.random.RandomState(1)
    n, s = 32, 16
    rgb = rng.rand(n, s, 3).astype(np.float32)
    sigma = (rng.randn(n, s) * 2).astype(np.float32)
    z = np.sort(rng.rand(n, s).astype(np.float32), -1)
    gc, gd, go, gw = _cotangents(n, s, 2)
    got = kcomposite.composite_bwd_plain(t(rgb), t(sigma), t(z), t(gc),
                                         t(gd), t(go), t(gw), white_bkgd,
                                         act)
    pallas = _run_bwd(*(jnp.asarray(x) for x in (rgb, sigma, z, gc, gd,
                                                  go, gw)),
                      act, white_bkgd, 8, True)
    rgb_t, sigma_t, z_t = (t(x).requires_grad_(True) for x in (rgb, sigma,
                                                                z))
    outs = plain_composite(rgb_t, sigma_t, z_t, white_bkgd, act)
    auto = torch.autograd.grad(outs, (rgb_t, sigma_t, z_t),
                               (t(gc), t(gd), t(go), t(gw)))
    for g, p, a in zip(got, pallas, auto):
        np.testing.assert_allclose(g.numpy(), np.asarray(p),
                                   **COMPOSITE_BWD_TOL)
        np.testing.assert_allclose(g.numpy(), a.numpy(),
                                   **COMPOSITE_BWD_TOL)


def _flax_mlp(dtype, seed=0):
    from nerfsr_tpu.models.mlp import VanillaMLP as JMLP
    from nerfsr_tpu.ops.experimental.pallas_mlp import flatten_params
    mlp = JMLP(compute_dtype=dtype)
    params = mlp.init(jax.random.PRNGKey(seed), jnp.zeros((1, 63)),
                      jnp.zeros((1, 27)))
    return mlp, params, flatten_params(params)


def _port_flat(jax_flat):
    """The JAX flat (kernel (in,out), bias (1,out)) tuple as torch."""
    return tuple(t(np.asarray(x)) for x in jax_flat)


def _points(n, seed):
    rng = np.random.RandomState(seed)
    pts = (rng.rand(n, 3) * 2 - 1).astype(np.float32)
    dirs = rng.randn(n, 3).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    return pts, dirs


def test_fused_mlp_f32_vs_pallas_and_flax():
    from nerfsr_tpu.core.encoding import positional_encoding
    from nerfsr_tpu.ops.experimental.pallas_mlp import fused_nerf_mlp
    mlp, params, jflat = _flax_mlp(jnp.float32)
    pts, dirs = _points(64, 1)
    with torch.no_grad():
        rgb, sigma = kmlp.fused_nerf_mlp(_port_flat(jflat), t(pts), t(dirs),
                                         torch.float32)
    p_rgb, p_sigma = fused_nerf_mlp(jflat, jnp.asarray(pts),
                                    jnp.asarray(dirs), jnp.float32, True)
    f_rgb, f_sigma = mlp.apply(params, positional_encoding(pts, 10),
                               positional_encoding(dirs, 4))
    for ref_rgb, ref_sigma in ((p_rgb, p_sigma), (f_rgb, f_sigma)):
        np.testing.assert_allclose(rgb.numpy(), np.asarray(ref_rgb),
                                   **MLP_F32_TOL)
        np.testing.assert_allclose(sigma.numpy(), np.asarray(ref_sigma),
                                   **MLP_F32_TOL)


def test_fused_mlp_mixed_vs_both_jax_paths():
    """Mixed precision has three numerics (module docstring of
    ``nerfsr_torch/kernels/mlp.py``): the port's rule is held against the
    JAX megakernel (bf16 activations x f32 weights) and flax Dense(bf16)
    (bf16 outputs and bias). Loose bar: bf16 keeps 8 mantissa bits, and
    each side rounds at other places through ~12 layers."""
    from nerfsr_tpu.core.encoding import positional_encoding
    from nerfsr_tpu.ops.experimental.pallas_mlp import fused_nerf_mlp
    mlp, params, jflat = _flax_mlp(jnp.bfloat16)
    pts, dirs = _points(64, 2)
    with torch.no_grad():
        rgb, sigma = kmlp.fused_nerf_mlp(_port_flat(jflat), t(pts), t(dirs),
                                         torch.bfloat16)
    p_rgb, p_sigma = fused_nerf_mlp(jflat, jnp.asarray(pts),
                                    jnp.asarray(dirs), jnp.bfloat16, True)
    f_rgb, f_sigma = mlp.apply(params, positional_encoding(pts, 10),
                               positional_encoding(dirs, 4))
    scale = float(np.abs(np.asarray(p_sigma)).max())
    for ref_rgb, ref_sigma in ((p_rgb, p_sigma), (f_rgb, f_sigma)):
        np.testing.assert_allclose(rgb.numpy(), np.asarray(ref_rgb,
                                                           np.float32),
                                   atol=2e-2)
        np.testing.assert_allclose(sigma.numpy(), np.asarray(ref_sigma,
                                                             np.float32),
                                   atol=5e-2 * scale)


def _forward_from_packed(w, b, x0, dmb):
    """Kernel C's pointer walk over the packed buffers (f32 mode), in
    numpy: trunk layers in order with the skip layer's x0 rows first,
    then fin, sigma, the direction layer (feat rows, then dmb rows) and
    rgb."""
    W, C_POS, C_DIR = kmlp.W, kmlp.C_POS, kmlp.C_DIR
    wo, bo = 0, 0

    def take(rows, cols):
        nonlocal wo
        m = w[wo:wo + rows * cols].reshape(rows, cols)
        wo += rows * cols
        return m

    def bias(n):
        nonlocal bo
        v = b[bo:bo + n]
        bo += n
        return v

    h = np.maximum(x0 @ take(C_POS, W) + bias(W), 0)
    for layer in range(1, kmlp.D):
        if layer == kmlp.SKIP:
            pre = x0 @ take(C_POS, W) + h @ take(W, W)
        else:
            pre = h @ take(W, W)
        h = np.maximum(pre + bias(W), 0)
    w_fin, b_fin = take(W, W), bias(W)
    sigma = h @ take(W, 1)[:, 0] + bias(1)[0]
    feat = h @ w_fin + b_fin
    g = np.maximum(feat @ take(W, kmlp.W_HALF)
                   + dmb @ take(C_DIR, kmlp.W_HALF) + bias(kmlp.W_HALF), 0)
    rgb = 1 / (1 + np.exp(-(g @ take(kmlp.W_HALF, 3) + bias(3))))
    assert wo == kmlp.N_WEIGHTS and bo == kmlp.N_BIASES
    return rgb, sigma


def test_packed_layout_matches_kernel_walk():
    _, _, jflat = _flax_mlp(jnp.float32, seed=1)
    flat = _port_flat(jflat)
    w, b = kmlp.pack_params(flat, torch.float32)
    assert w.shape == (593408,) and b.shape == (2436,)
    assert kmlp.pack_params(flat, torch.bfloat16)[0].dtype == torch.bfloat16
    pts, dirs = _points(32, 3)
    x0, dmb = kmlp.embed(t(pts), t(dirs))
    rgb, sigma = _forward_from_packed(w.double().numpy(),
                                      b.double().numpy(),
                                      x0.double().numpy(),
                                      dmb.double().numpy())
    with torch.no_grad():
        ref_rgb, ref_sigma = kmlp.fused_mlp_plain(flat, x0, dmb)
    np.testing.assert_allclose(rgb, ref_rgb.numpy(), **MLP_F32_TOL)
    np.testing.assert_allclose(sigma, ref_sigma.numpy(), **MLP_F32_TOL)


def test_fused_mlp_guards():
    """Gradients flow to the weights through the wrapper (kernel E's
    plain version on the CPU) and equal autograd of the plain forward;
    the points get none (the JAX contract); float16 still raises."""
    _, _, jflat = _flax_mlp(jnp.float32)
    flat = tuple(x.requires_grad_(True) for x in _port_flat(jflat))
    pts, dirs = _points(8, 4)
    pts_t = t(pts).requires_grad_(True)
    reset_counts()
    rgb, sigma = kmlp.fused_nerf_mlp(flat, pts_t, t(dirs))
    loss = (rgb ** 2).sum() + torch.tanh(sigma).sum()
    grads = torch.autograd.grad(loss, flat + (pts_t,), allow_unused=True)
    assert grads[-1] is None
    x0, dmb = kmlp.embed(t(pts), t(dirs))
    ref_rgb, ref_sigma = kmlp.fused_mlp_plain(flat, x0, dmb)
    ref = torch.autograd.grad((ref_rgb ** 2).sum()
                              + torch.tanh(ref_sigma).sum(), flat)
    for g, r in zip(grads, ref):
        torch.testing.assert_close(g, r, rtol=1e-4, atol=1e-6)
    assert COUNTS["fused_mlp_fwd"] == COUNTS["fused_mlp_bwd"] == 0
    with torch.no_grad():
        with pytest.raises(ValueError, match="bfloat16 or float32"):
            kmlp.fused_nerf_mlp(flat, t(pts), t(dirs), torch.float16)


def _mlp_bwd_inputs(n, seed):
    pts, dirs = _points(n, seed)
    rng = np.random.RandomState(seed + 100)
    return (pts, dirs, rng.randn(n, 3).astype(np.float32),
            rng.randn(n).astype(np.float32))


def test_fused_mlp_bwd_f32_vs_pallas_and_xla():
    """Kernel E's plain version in f32 at full width against the v3
    backward kernel (interpret mode) and the XLA backward."""
    from nerfsr_tpu.ops.experimental.pallas_mlp import _bwd, _bwd_xla
    _, _, jflat = _flax_mlp(jnp.float32, seed=2)
    pts, dirs, grgb, gsig = _mlp_bwd_inputs(64, 5)
    x0, dmb = kmlp.embed(t(pts), t(dirs))
    got = kmlp.fused_mlp_bwd_plain(_port_flat(jflat), x0, dmb, t(grgb),
                                   t(gsig), torch.float32)
    v3 = _bwd(jnp.asarray(pts), jnp.asarray(dirs), jflat,
              jnp.asarray(grgb), jnp.asarray(gsig)[:, None], jnp.float32,
              True)
    xla = _bwd_xla(jflat, jnp.asarray(pts), jnp.asarray(dirs),
                   jnp.asarray(grgb), jnp.asarray(gsig), jnp.float32)
    assert len(got) == len(v3) == 24
    for i, (g, a, b) in enumerate(zip(got, v3, xla)):
        np.testing.assert_allclose(g.numpy(), np.asarray(a),
                                   **MLP_BWD_F32_TOL, err_msg=str(i))
        np.testing.assert_allclose(g.numpy(), np.asarray(b),
                                   **MLP_BWD_F32_TOL, err_msg=str(i))


def test_fused_mlp_bwd_mixed_vs_pallas():
    """bf16: the port's rule against the v3 kernel in bf16, per leaf
    norm-relative. Loose bar: v3 recomputes with bf16 biases (the port
    keeps f32 biases, as its forward does) and forms its head gradients
    in bf16 arithmetic, so activations, masks and gradient roundings
    differ through ~12 layers (seen: 6.5e-3 at most)."""
    from nerfsr_tpu.ops.experimental.pallas_mlp import _bwd
    _, _, jflat = _flax_mlp(jnp.float32, seed=3)
    pts, dirs, grgb, gsig = _mlp_bwd_inputs(64, 6)
    x0, dmb = kmlp.embed(t(pts), t(dirs))
    got = kmlp.fused_mlp_bwd_plain(_port_flat(jflat), x0, dmb, t(grgb),
                                   t(gsig), torch.bfloat16)
    v3 = _bwd(jnp.asarray(pts), jnp.asarray(dirs),
              tuple(jnp.asarray(w, jnp.bfloat16) for w in jflat),
              jnp.asarray(grgb), jnp.asarray(gsig)[:, None], jnp.bfloat16,
              True)
    for i, (g, a) in enumerate(zip(got, v3)):
        a = np.asarray(a, np.float64)
        rel = np.linalg.norm(g.numpy() - a) / max(np.linalg.norm(a), 1e-30)
        assert rel < 2e-2, (i, rel)


def test_fused_mlp_bwd_plain_is_autograd_in_f32():
    """In f32 the plain backward is the exact gradient of the plain
    forward (same math in torch, two ways)."""
    _, _, jflat = _flax_mlp(jnp.float32, seed=4)
    flat = tuple(x.requires_grad_(True) for x in _port_flat(jflat))
    pts, dirs, grgb, gsig = _mlp_bwd_inputs(48, 7)
    x0, dmb = kmlp.embed(t(pts), t(dirs))
    rgb, sigma = kmlp.fused_mlp_plain(flat, x0, dmb)
    ref = torch.autograd.grad((rgb, sigma), flat, (t(grgb), t(gsig)))
    got = kmlp.fused_mlp_bwd_plain(flat, x0, dmb, t(grgb), t(gsig))
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, rtol=1e-4, atol=1e-6)
