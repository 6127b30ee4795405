"""The port's kernel wrappers on the CPU (where each takes its plain
version) against the JAX package's Pallas kernels, run in interpret mode
as ``tests/test_pallas.py`` runs them, and against their jnp counterparts.

The backward kernels' plain versions (D: ``composite_bwd_plain``, E:
``fused_mlp_bwd_plain``) are held against the JAX package's backward
kernels in interpret mode, its XLA backward and torch autograd.

Also checks what the CUDA kernels rely on and the CPU can reach: kernel
C's packed weight images (the f32 image walked here in
``csrc/mlp_tf32.cuh``'s chunk order as 3xTF32 products; the bf16 image
unpacked and walked in ``csrc/mlp_tc.cuh``'s), kernel E's bf16 image and
both routes' scratch layout, the packing cache, that gradients flow
through the wrappers' autograd Functions, and that the CPU path launches
nothing. ``tests/test_torch_mlp_tf32.py`` holds the f32 route's split,
images and products in more detail.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch's threads in a test worker)

from nerfsr_tpu.core.rendering import volumetric_rendering as j_composite
from nerfsr_tpu.core.sampling import _invert_cdf as j_invert_cdf
from nerfsr_tpu.ops.experimental.pallas_composite import (
    _run_bwd, pallas_volumetric_rendering)
from nerfsr_tpu.ops.experimental.pallas_sampling import (
    pallas_invert_cdf, pallas_sample_pdf_stratified)

from nerfsr_torch.core.rendering import compute_weights as plain_weights
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


@pytest.mark.parametrize("b,q", [(47, 24), (23, 16), (255, 192), (1024, 16)])
def test_invert_cdf_vs_pallas_and_jnp(b, q):
    """The slice's two (B, Q) pairs, and the wide route's: ``--n_prop 256
    --n_prop2 192``'s first resample (255 bins, 192 queries) and 1024
    bins."""
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


def _forward_from_tf32_image(img, b, heads, x0, dmb):
    """Kernel C's f32 walk over its image (csrc/mlp_tf32.cuh), in numpy:
    chunks of 16 reduction rows, each a big then a small image of B (N,
    16) in core-matrix order with the rows of every 8 in TF32_K_ORDER;
    each product sums its chunks in consumption order as 3xTF32 (A's next
    16 columns split into big and small); biases and heads in f32."""
    W = kmlp.W
    img = np.asarray(img, np.float64)
    inv = np.argsort(kmlp.TF32_K_ORDER)
    o = 0

    def chunk(n):
        nonlocal o
        parts = []
        for _ in range(2):
            c = img[o:o + n * 16].reshape(n // 8, 4, 8, 4)
            parts.append(c.transpose(0, 2, 1, 3).reshape(n, 2, 8)[..., inv]
                         .reshape(n, 16))
            o += n * 16
        return parts

    def split(a):
        big, small = kmlp.tf32_split(torch.from_numpy(a).float())
        return big.double().numpy(), small.double().numpy()

    def prod(a, n_out):
        acc = 0.0
        for k0 in range(0, a.shape[1], 16):
            bb, bs = chunk(n_out)
            ab, as_ = split(a[:, k0:k0 + 16])
            acc = acc + as_ @ bb.T + ab @ bs.T + ab @ bb.T
        return acc

    x = np.pad(x0, ((0, 0), (0, kmlp.TC_X0 - kmlp.C_POS)))
    d = np.pad(dmb, ((0, 0), (0, kmlp.TC_DMB - kmlp.C_DIR)))
    h = None
    for layer in range(kmlp.D):
        acc = prod(x, W) if layer in (0, kmlp.SKIP) else 0.0
        if layer > 0:
            acc = acc + prod(h, W)
        h = np.maximum(acc + b[layer * W:(layer + 1) * W], 0)
    bo = kmlp.D * W
    feat = prod(h, W) + b[bo:bo + W]
    sigma = h @ heads[:W] + b[bo + W]
    g = np.maximum(prod(feat, kmlp.W_HALF) + prod(d, kmlp.W_HALF)
                   + b[bo + W + 1:bo + W + 1 + kmlp.W_HALF], 0)
    rgb = 1 / (1 + np.exp(-(g @ heads[W:].reshape(kmlp.W_HALF, 3) + b[-3:])))
    assert o == img.size
    return rgb, sigma


# (N, K) of every chunk of the tensor-core weight images, in the order
# csrc/mlp_tc.cuh consumes them
_W, _H = kmlp.W, kmlp.W_HALF
TC_FWD_SHAPES = ([(_W, 64)] + [(_W, 64)] * 12 + [(_W, 64)] * 5
                 + [(_W, 64)] * 12 + [(_W, 64)] * 4 + [(_H, 64)] * 4
                 + [(_H, 32)])
TC_BWD_SHAPES = [(_W, 64)] * 34


def _unpack_tc_image(img, shapes):
    """Undo the core-matrix order of each chunk: -> B (N, K) per chunk,
    the kernel's view of its reduction rows."""
    img = np.asarray(img, np.float64)
    out, o = [], 0
    for n, k in shapes:
        c = img[o:o + n * k].reshape(n // 8, k // 8, 8, 8)
        out.append(c.transpose(0, 2, 1, 3).reshape(n, k))
        o += n * k
    assert o == img.size
    return out


def _bf16(x):
    return torch.from_numpy(np.asarray(x)).to(torch.bfloat16).double() \
        .numpy()


def _forward_from_tc_image(img, b, heads, x0, dmb):
    """Kernel C's bf16 walk over the tensor-core image, in numpy: each
    product sums its chunks (A's next K columns against a chunk's B) in
    consumption order; activations rounded to bf16, biases in f32, the
    heads from the f32 head buffer."""
    chunks = iter(_unpack_tc_image(img, TC_FWD_SHAPES))
    W = kmlp.W

    def prod(a, n_chunks):
        acc, k0 = 0.0, 0
        for _ in range(n_chunks):
            bm = next(chunks)
            acc = acc + a[:, k0:k0 + bm.shape[1]] @ bm.T
            k0 += bm.shape[1]
        assert k0 == a.shape[1]
        return acc

    x = np.pad(_bf16(x0), ((0, 0), (0, kmlp.TC_X0 - kmlp.C_POS)))
    d = np.pad(_bf16(dmb), ((0, 0), (0, kmlp.TC_DMB - kmlp.C_DIR)))
    h = None
    for layer in range(kmlp.D):
        acc = prod(x, 1) if layer in (0, kmlp.SKIP) else 0.0
        if layer > 0:
            acc = acc + prod(h, 4)
        h = _bf16(np.maximum(acc + b[layer * W:(layer + 1) * W], 0))
    o = kmlp.D * W
    feat = _bf16(prod(h, 4) + b[o:o + W])
    sigma = h @ heads[:W] + b[o + W]
    g = _bf16(np.maximum(prod(feat, 4) + prod(d, 1)
                         + b[o + W + 1:o + W + 1 + kmlp.W_HALF], 0))
    pre = g @ heads[W:].reshape(kmlp.W_HALF, 3) + b[-3:]
    assert next(chunks, None) is None
    return 1 / (1 + np.exp(-pre)), sigma


def test_packed_layout_matches_kernel_walk():
    """The f32 kernel's weight image and the bf16 kernel's, each walked
    in numpy as its kernel walks it, against the plain forward; the bf16
    image unpacks to every layer's bf16 kernel exactly, padding rows
    zero."""
    _, _, jflat = _flax_mlp(jnp.float32, seed=1)
    flat = _port_flat(jflat)
    w, b, f32_heads = kmlp.pack_tf32(flat)
    assert w.shape == (kmlp.TF32_FWD_IMAGE,) and b.shape == (2436,)
    pts, dirs = _points(32, 3)
    x0, dmb = kmlp.embed(t(pts), t(dirs))
    rgb, sigma = _forward_from_tf32_image(w.numpy(), b.double().numpy(),
                                          f32_heads.double().numpy(),
                                          x0.double().numpy(),
                                          dmb.double().numpy())
    with torch.no_grad():
        ref_rgb, ref_sigma = kmlp.fused_mlp_plain(flat, x0, dmb)
    np.testing.assert_allclose(rgb, ref_rgb.numpy(), **MLP_F32_TOL)
    np.testing.assert_allclose(sigma, ref_sigma.numpy(), **MLP_F32_TOL)

    img, tb, heads = kmlp.pack_tc(flat)
    assert img.dtype == torch.bfloat16 and img.shape == (kmlp.TC_FWD_IMAGE,)
    assert sum(n * k for n, k in TC_FWD_SHAPES) == kmlp.TC_FWD_IMAGE
    assert kmlp.TC_FWD_IMAGE * 2 == 1187840    # csrc/mlp_tc.cuh
    torch.testing.assert_close(tb, b, rtol=0, atol=0)
    kb = [_bf16(k.numpy()) for k in flat[0::2]]
    np.testing.assert_array_equal(heads.double().numpy(), np.concatenate(
        [kb[kmlp.D + 1].ravel(), kb[kmlp.D + 3].ravel()]))
    chunks = [c.T for c in _unpack_tc_image(img.float().numpy(),
                                            TC_FWD_SHAPES)]
    rebuilt, i = [], 0
    for layer in range(kmlp.D):
        parts = []
        if layer in (0, kmlp.SKIP):
            assert not chunks[i][kmlp.C_POS:].any()     # padding row
            parts.append(chunks[i][:kmlp.C_POS])
            i += 1
        if layer > 0:
            parts += chunks[i:i + 4]
            i += 4
        rebuilt.append(np.concatenate(parts))
    rebuilt.append(np.concatenate(chunks[i:i + 4]))
    assert not chunks[i + 8][kmlp.C_DIR:].any()
    rebuilt.append(np.concatenate(chunks[i + 4:i + 8]
                                  + [chunks[i + 8][:kmlp.C_DIR]]))
    for layer, got in zip(list(range(kmlp.D + 1)) + [kmlp.D + 2], rebuilt):
        np.testing.assert_array_equal(got, kb[layer], err_msg=str(layer))

    rgb, sigma = _forward_from_tc_image(img.float().numpy(),
                                        tb.double().numpy(),
                                        heads.double().numpy(),
                                        x0.numpy(), dmb.numpy())
    with torch.no_grad():
        ref_rgb, ref_sigma = kmlp.fused_mlp_plain(flat, x0, dmb,
                                                  torch.bfloat16)
    # the same bf16 rule in f64 vs f32 sums: rounding flips of single
    # activations, as TOL_MLP_BF16 in chip_smoke.py
    np.testing.assert_allclose(rgb, ref_rgb.numpy(), rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(sigma, ref_sigma.numpy(), rtol=2e-2,
                               atol=2e-2)


def test_tc_bwd_image_unpacks_to_kernels():
    """Kernel E's second image: chunk j of matrix m is W[h rows, 64 j:64
    (j + 1)] for the direction layer's feat rows, final, layers 7..1 (the
    skip layer's h rows), exactly, in bf16."""
    _, _, jflat = _flax_mlp(jnp.float32, seed=2)
    flat = _port_flat(jflat)
    img = kmlp.pack_tc_bwd(flat)
    assert img.dtype == torch.bfloat16 and img.shape == (kmlp.TC_BWD_IMAGE,)
    chunks = _unpack_tc_image(img.float().numpy(), TC_BWD_SHAPES)
    kb = [_bf16(k.numpy()) for k in flat[0::2]]
    mats = [kb[kmlp.D + 2][:kmlp.W], kb[kmlp.D]]
    mats += [kb[i][kmlp.C_POS:] if i == kmlp.SKIP else kb[i]
             for i in range(kmlp.D - 1, 0, -1)]
    i = 0
    for m in mats:
        n_chunks = m.shape[1] // 64
        np.testing.assert_array_equal(
            np.concatenate(chunks[i:i + n_chunks], axis=1), m)
        i += n_chunks
    assert i == len(chunks)


def test_tc_scratch_layout():
    """Kernel E's scratch rows (csrc/fused_mlp_bwd_tc.cu, and in f32
    csrc/fused_mlp_bwd_tf32.cu): every
    block 8-aligned (16-byte copies), the skip and direction inputs
    contiguous, the widths the wrapper allocates."""
    W, H = kmlp.W, kmlp.W_HALF
    act = [W, W, W, kmlp.TC_X0, W, W, W, W, W, W, kmlp.TC_DMB, H]
    grad = [W] * 8 + [W, H, 8]
    assert sum(act) == kmlp.TC_ACT_WIDTH == 2528
    assert sum(grad) == kmlp.TC_GRAD_WIDTH == 2440
    offs = np.cumsum([0] + act)
    assert all(o % 8 == 0 for o in offs) and all(o % 8 == 0 for o in
                                                  np.cumsum(grad))
    # [x0 | a3] starts at 3 W; [feat | dmb] right after a7
    assert offs[3] == 3 * W and offs[4] - offs[3] == kmlp.TC_X0
    assert offs[10] - offs[9] == W
    # the f32 route's scratch holds the same features, in f32
    assert (kmlp.F32_ACT_WIDTH, kmlp.F32_GRAD_WIDTH) == (2528, 2440)
    assert kmlp.TC_HEADS == W + 3 * H


def test_packed_cache_reuses_and_repacks():
    """The packed buffers are reused while the parameters are untouched
    (new views of the same tensors included) and rebuilt after an in-place
    update, such as an optimizer step."""
    from nerfsr_torch.models.mlp import VanillaMLP
    gen = torch.Generator().manual_seed(5)
    net = VanillaMLP().reset_parameters("kaiming", 0.02, gen)
    first = kmlp.packed(kmlp.flatten_params(net), "tc")
    again = kmlp.packed(kmlp.flatten_params(net), "tc")
    assert all(a is b for a, b in zip(first, again))
    opt = torch.optim.Adam(net.parameters(), lr=1e-2, foreach=True)
    for p in net.parameters():
        p.grad = torch.ones_like(p)
    opt.step()
    moved = kmlp.packed(kmlp.flatten_params(net), "tc")
    assert moved[0] is not first[0]
    assert not torch.equal(moved[0], first[0])
    torch.testing.assert_close(moved[0], kmlp.pack_tc(
        kmlp.flatten_params(net))[0], rtol=0, atol=0)
    with torch.no_grad():
        net.rgb.bias.copy_(torch.full((3,), 0.5))
    assert kmlp.packed(kmlp.flatten_params(net), "tc")[1][-1] == 0.5
    # each kind is its own entry
    assert kmlp.packed(kmlp.flatten_params(net), "tc_bwd").shape == \
        (kmlp.TC_BWD_IMAGE,)


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


# numpy models of the order in which kernels A (csrc/invert_cdf.cu) and B
# (csrc/composite.cu, forward) round: every f32 operation in the kernels'
# order, lanes along an axis. nvcc contracts a * b + c into one fused
# multiply-add; `_fma` rounds it once (through f64, where the product is
# exact).

F32 = np.float32


def _fma(a, b, c):
    return (np.float64(a) * np.float64(b) + np.float64(c)).astype(F32)


def _warp_invert_cdf(bins, w, u, eps=F32(1e-5)):
    """Kernel A's order for each ray on its register route (B <= 128; one
    warp of 32 lanes): lane l holds weights l, l + 32, ... plus eps and
    sums them serially; a shuffle-xor tree gives the total; pdf = weight /
    total; lane l then sums its contiguous run of ceil((B-1)/32) pdf
    values serially, the lane sums are scanned (Hillis-Steele, shuffle-up)
    and each CDF entry is the lane's exclusive prefix plus its run's
    partial sum; a binary search (searchsorted right), the clamps, the eps
    rule and the lerp. The wide routes' order is modelled in
    test_torch_invert_cdf_wide.py."""
    n, nb = bins.shape
    nw = nb - 1
    lane = np.arange(32)
    total = np.zeros((n, 32), F32)
    for k in range(-(-nw // 32)):
        i = lane + 32 * k
        vk = np.where(i < nw, w[:, np.minimum(i, nw - 1)] + eps, F32(0))
        total = total + vk
    for m in (16, 8, 4, 2, 1):
        total = total + total[:, lane ^ m]
    assert (total == total[:, :1]).all()     # every lane has the same bits
    pdf = (w + eps) / total[:, :1]
    assert nb <= 128
    run = -(-nw // 32)
    acc = np.zeros((n, 32), F32)
    pre = np.zeros((n, 32, run), F32)
    for j in range(run):
        i = lane * run + j
        acc = np.where(i < nw, acc + pdf[:, np.minimum(i, nw - 1)], acc)
        pre[:, :, j] = acc
    incl = acc
    d = 1
    while d < 32:
        y = incl[:, np.maximum(lane - d, 0)]
        incl = np.where(lane >= d, incl + y, incl)
        d *= 2
    excl = np.where(lane == 0, F32(0), incl[:, np.maximum(lane - 1, 0)])
    cdf = np.zeros((n, nb), F32)
    for j in range(run):
        i = lane * run + j
        ok = i < nw
        cdf[:, i[ok] + 1] = excl[:, ok] + pre[:, ok, j]
    lo = np.zeros(u.shape, np.int64)
    hi = np.full(u.shape, nb)
    while (lo < hi).any():
        mid = (lo + hi) >> 1
        le = np.take_along_axis(cdf, np.minimum(mid, nb - 1), -1) <= u
        act = lo < hi
        lo = np.where(act & le, mid + 1, lo)
        hi = np.where(act & ~le, mid, hi)
    below = np.maximum(lo - 1, 0)
    above = np.minimum(lo, nb - 1)
    cb, ca = (np.take_along_axis(cdf, x, -1) for x in (below, above))
    bb, ba = (np.take_along_axis(bins, x, -1) for x in (below, above))
    denom = ca - cb
    denom = np.where(denom < eps, F32(1), denom)
    return _fma((u - cb) / denom, ba - bb, bb), cdf


def _segmented_runs(sigma, z, activation):
    """The forward half kernels B and D share (``run_start``): a segment of
    `seg` lanes per ray (S rounded up to a power of two, at most 32), lane
    l taking samples l * per, ..., l * per + per - 1 (lanes along axis 1,
    a run's samples along axis 2); each sample's delta, activation,
    exp(-delta act) and alpha; each lane's product of (1 - alpha + 1e-10),
    a segmented Hillis-Steele product scan of the lane products, and the
    exclusive prefix as T before the lane's first sample."""
    n, s = sigma.shape
    seg = 1
    while seg < s and seg < 32:
        seg *= 2
    per = -(-s // seg)
    sl = np.arange(seg)
    idx = sl[:, None] * per + np.arange(per)[None, :]        # (seg, per)
    at = np.minimum(idx, s - 1)
    valid = idx < s
    inner = idx + 1 < s
    zi = z[:, at]
    znext = z[:, np.minimum(idx + 1, s - 1)]
    x = sigma[:, at]
    delta = np.where(inner, znext - zi, F32(1e10))
    if activation == "relu":
        act = np.maximum(x, F32(0))
    else:
        xm = x - F32(1)
        act = np.maximum(xm, F32(0)) + np.log1p(np.exp(-np.abs(xm)))
    oma = np.exp(-delta * act)
    alpha = F32(1) - oma
    factor = np.where(valid, (F32(1) - alpha) + F32(1e-10), F32(1))
    prod = np.ones((n, seg), F32)
    for j in range(per):
        prod = prod * factor[:, :, j]
    incl = prod
    k = 1
    while k < seg:
        y = incl[:, np.maximum(sl - k, 0)]
        incl = np.where(sl >= k, incl * y, incl)
        k *= 2
    trans = np.where(sl == 0, F32(1), incl[:, np.maximum(sl - 1, 0)])
    return SimpleNamespace(seg=seg, per=per, sl=sl, at=at, valid=valid,
                           inner=inner, zi=zi, x=x, delta=delta, act=act,
                           oma=oma, alpha=alpha, factor=factor, trans=trans)


def _segmented_composite(rgb, sigma, z, white_bkgd, activation):
    """Kernel B's order: the shared forward half (``_segmented_runs``),
    then a serial walk over each lane's run (w = alpha T, fused
    multiply-add sums, T *= factor) and a shuffle-xor tree over the
    segment's lanes."""
    n, s = sigma.shape
    f = _segmented_runs(sigma, z, activation)
    seg, per, sl, valid = f.seg, f.per, f.sl, f.valid
    cols = rgb[:, f.at]                                       # (n, seg, per, 3)
    trans = f.trans
    weights = np.zeros((n, seg, per), F32)
    c = np.zeros((n, seg, 3), F32)
    d = np.zeros((n, seg), F32)
    op = np.zeros((n, seg), F32)
    for j in range(per):
        ok = valid[None, :, j]
        wj = np.where(ok, f.alpha[:, :, j] * trans, F32(0))
        weights[:, :, j] = wj
        c = np.where(ok[..., None], _fma(wj[..., None], cols[:, :, j], c), c)
        d = np.where(ok, _fma(wj, f.zi[:, :, j], d), d)
        op = np.where(ok, op + wj, op)
        trans = trans * f.factor[:, :, j]
    m = seg // 2
    while m > 0:
        c = c + c[:, sl ^ m]
        d = d + d[:, sl ^ m]
        op = op + op[:, sl ^ m]
        m //= 2
    comp, depth, opacity = c[:, 0], d[:, 0], op[:, 0]
    if white_bkgd:
        comp = comp + (F32(1) - opacity[:, None])
    return comp, depth, opacity, weights.reshape(n, seg * per)[:, :s]


def _segmented_composite_bwd(rgb, sigma, z, gc, gd, go, gw_in, white_bkgd,
                             activation):
    """Kernel D's order: the forward half it shares with B
    (``_segmented_runs``); walk 1 sums each lane's gw_i w_i (fused
    multiply-adds); a segmented Hillis-Steele reverse scan (shuffle-down)
    of the lane sums gives the suffix of the later lanes' runs; walk 2 goes
    backward over each run carrying that suffix, with T_j by the forward
    product from the run's start, and writes grgb = w gc, gsigma and
    ddelta; gz_i = (w_i gd - ddelta_i) + ddelta_{i-1}, ddelta_{i-1} from
    the previous lane at a run's start. The contractions are the ones nvcc
    makes of the kernel's expressions (one rounding each, `_fma`)."""
    n, s = sigma.shape
    f = _segmented_runs(sigma, z, activation)
    seg, per, sl, valid = f.seg, f.per, f.sl, f.valid
    cols = rgb[:, f.at]                                       # (n, seg, per, 3)
    gwi = gw_in[:, f.at]
    gc0, gc1, gc2 = (gc[:, k, None, None] for k in range(3))
    gdr, gor = gd[:, None, None], go[:, None, None]
    if white_bkgd:
        gor = gor - ((gc0 + gc1) + gc2)
    # T_j and w_j in the forward walk's order: B's weights, bit for bit
    trans = np.zeros((n, seg, per), F32)
    t = f.trans
    for j in range(per):
        trans[:, :, j] = t
        t = t * f.factor[:, :, j]
    w = f.alpha * trans
    gw = _fma(gc2, cols[..., 2], _fma(gc1, cols[..., 1], gc0 * cols[..., 0]))
    gw = (_fma(gdr, f.zi, gw) + gor) + gwi
    # walk 1 and the segmented reverse scan
    run_sum = np.zeros((n, seg), F32)
    for j in range(per):
        run_sum = np.where(valid[:, j], _fma(gw[:, :, j], w[:, :, j],
                                             run_sum), run_sum)
    incl = run_sum
    k = 1
    while k < seg:
        y = incl[:, np.minimum(sl + k, seg - 1)]
        incl = np.where(sl + k < seg, incl + y, incl)
        k *= 2
    suffix = np.where(sl == seg - 1, F32(0),
                      incl[:, np.minimum(sl + 1, seg - 1)])
    # walk 2, backward over each run
    if activation == "relu":
        agrad = (f.x > 0).astype(F32)
    else:
        agrad = F32(1) / (F32(1) + np.exp(F32(1) - f.x))
    gsigma = np.zeros((n, seg, per), F32)
    gz = np.zeros((n, seg, per), F32)
    pending = np.zeros((n, seg), F32)
    gdelta_last = np.zeros((n, seg), F32)
    for j in reversed(range(per)):
        ok = valid[:, j]
        has_next = valid[:, j + 1] if j + 1 < per else np.zeros(seg, bool)
        ga = _fma(gw[:, :, j], trans[:, :, j],
                  -(suffix / (f.oma[:, :, j] + F32(1e-10))))
        suffix = np.where(ok, _fma(gw[:, :, j], w[:, :, j], suffix), suffix)
        gsigma[:, :, j] = ga * f.delta[:, :, j] * f.oma[:, :, j] *             agrad[:, :, j]
        gdelta = np.where(f.inner[:, j], ga * f.act[:, :, j] * f.oma[:, :, j],
                          F32(0))
        gdelta_last = np.where(ok & ~has_next, gdelta, gdelta_last)
        if j + 1 < per:
            gz[:, :, j + 1] = np.where(has_next, pending + gdelta,
                                       gz[:, :, j + 1])
        pending = np.where(ok, _fma(w[:, :, j], gdr[..., 0], -gdelta),
                           pending)
    before = gdelta_last[:, np.maximum(sl - 1, 0)]
    gz[:, :, 0] = np.where(sl == 0, pending, pending + before)
    grgb = w[..., None] * gc[:, None, None, :]
    return (grgb.reshape(n, seg * per, 3)[:, :s],
            gsigma.reshape(n, seg * per)[:, :s],
            gz.reshape(n, seg * per)[:, :s])


@pytest.mark.parametrize("b,q", [(2, 1), (23, 16), (47, 24), (128, 40)])
def test_warp_invert_cdf_order_vs_jax_and_plain(b, q):
    """Kernel A's order on its register route (warp-tree total,
    lane-blocked scan) against the JAX package's _invert_cdf and the
    port's plain version, at the bar the card holds the kernel to
    (Z_ATOL), with a degenerate (all-zero) row and a row of concentrated
    mass."""
    bins, w = hist(64, b, seed=100 + b)
    u = ((np.arange(q) + np.random.RandomState(q).rand(64, q)) / q
         ).astype(np.float32)
    got, _ = _warp_invert_cdf(bins, w, u)
    ref_jax = np.asarray(j_invert_cdf(jnp.asarray(bins), jnp.asarray(w),
                                      jnp.asarray(u)))
    ref_plain = ksampling.invert_cdf(t(bins), t(w), t(u)).numpy()
    np.testing.assert_allclose(got, ref_jax, rtol=0, atol=Z_ATOL)
    np.testing.assert_allclose(got, ref_plain, rtol=0, atol=Z_ATOL)


def test_warp_invert_cdf_order_pad0_empty_bins():
    """Rows as the annealed path makes them (pad 0, proposal weights with
    many empty bins, totals near 1). An empty bin's pdf is eps / total,
    within f32 rounding of the `denom < eps -> 1` threshold when the total
    is near 1, so another summation order can flip the rule there and
    move a query inside its bin, by up to the bin's width. On these 4096
    rays x 24 queries the two references (the JAX function and the port's
    plain version) already differ beyond Z_ATOL at 16 of 98,304 queries;
    the kernel's order differs from the plain version at 9 and from the
    JAX function at 19 (seen, this seed). The bar: every such query lies
    in an empty bin and moves by at most the bin's width, and there are
    no more of them than twice the references' own count."""
    rng = np.random.RandomState(7)
    n, s, q = 4096, 48, 24
    z = np.sort(rng.rand(n, s).astype(np.float32), -1)
    sigma = (rng.randn(n, s) * 30 - 15).astype(np.float32)
    w = plain_weights(t(sigma), t(z)).numpy()
    bins = 0.5 * (z[:, :-1] + z[:, 1:])
    w = w[:, 1:-1]                                       # pad 0
    u = ((np.arange(q) + 0.5) / q * np.ones((n, 1))).astype(np.float32)
    got, cdf = _warp_invert_cdf(bins, w, u)
    ref = ksampling.invert_cdf(t(bins), t(w), t(u)).numpy()
    ref_jax = np.asarray(j_invert_cdf(jnp.asarray(bins), jnp.asarray(w),
                                      jnp.asarray(u)))
    assert (w == 0).mean() > 0.3                          # many empty bins
    refs_moved = int((np.abs(ref - ref_jax) > Z_ATOL).sum())
    for other in (ref, ref_jax):
        moved = np.abs(got - other) > Z_ATOL
        assert moved.sum() <= 2 * max(refs_moved, 1), (moved.sum(),
                                                         refs_moved)
        rows, cols = np.nonzero(moved)
        k = (cdf[rows] <= u[rows, cols, None]).sum(-1)   # above index
        below, above = np.maximum(k - 1, 0), np.minimum(k, s - 2)
        assert (w[rows, np.minimum(below, s - 3)] == 0).all()
        width = bins[rows, above] - bins[rows, below]
        assert (np.abs(got - other)[moved] <= width + Z_ATOL).all()


def _composite_rays(n, s, seed):
    rng = np.random.RandomState(seed)
    return (rng.rand(n, s, 3).astype(np.float32),
            (rng.randn(n, s) * 2).astype(np.float32),
            np.sort(rng.rand(n, s).astype(np.float32), -1))


@pytest.mark.parametrize("white_bkgd", [False, True])
@pytest.mark.parametrize("act", ["relu", "softplus"])
@pytest.mark.parametrize("s", [2, 16, 33, 64, 128])
def test_segmented_composite_order_vs_jax_and_plain(s, act, white_bkgd):
    """Kernel B's order (one lane per sample up to 32, then consecutive
    runs; segmented product scan and shuffle reductions) against the JAX
    package's volumetric_rendering and the port's plain version at the
    bar the card holds the kernel to (COMPOSITE_TOL)."""
    rgb, sigma, z = _composite_rays(37, s, seed=s)
    got = _segmented_composite(rgb, sigma, z, white_bkgd, act)
    ref_jax = j_composite(jnp.asarray(rgb), jnp.asarray(sigma),
                          jnp.asarray(z), white_bkgd, act)
    ref_plain = kcomposite.composite_fwd(t(rgb), t(sigma), t(z), white_bkgd,
                                         act)
    for g, a, p in zip(got, ref_jax, ref_plain):
        np.testing.assert_allclose(g, np.asarray(a), **COMPOSITE_TOL)
        np.testing.assert_allclose(g, p.numpy(), **COMPOSITE_TOL)


@pytest.mark.parametrize("white_bkgd", [False, True])
@pytest.mark.parametrize("act", ["relu", "softplus"])
def test_segmented_composite_order_one_sample(act, white_bkgd):
    """S = 1: one lane a ray, 32 rays a warp. The single sample takes the
    1e10 terminal delta, so its weight is 1 - exp(-1e10 act(sigma)) and
    the ray's colour that weight times its rgb. The JAX package's
    compute_weights cuts the terminal from the (empty) inner deltas and
    returns no weights at S = 1, so the closed form stands in for it; the
    port's plain version keeps the terminal and is held as at every S."""
    rgb, sigma, z = _composite_rays(37, 1, seed=1)
    got = _segmented_composite(rgb, sigma, z, white_bkgd, act)
    ref_plain = kcomposite.composite_fwd(t(rgb), t(sigma), t(z), white_bkgd,
                                         act)
    sa = np.asarray(jax.nn.relu(sigma) if act == "relu"
                    else jax.nn.softplus(sigma - 1.0))
    w = 1.0 - np.exp(-1e10 * sa)
    comp = w * rgb[:, 0] + (1.0 - w if white_bkgd else 0.0)
    closed = (comp, w[:, 0] * z[:, 0], w[:, 0], w)
    for g, c, p in zip(got, closed, ref_plain):
        np.testing.assert_allclose(g, c, **COMPOSITE_TOL)
        np.testing.assert_allclose(g, p.numpy(), **COMPOSITE_TOL)


@pytest.mark.parametrize("white_bkgd", [False, True])
@pytest.mark.parametrize("act", ["relu", "softplus"])
@pytest.mark.parametrize("s", [1, 2, 16, 33, 64, 128])
def test_segmented_composite_bwd_order_vs_jax_and_plain(s, act, white_bkgd):
    """Kernel D's order (B's forward half, lane sums of gw w, a segmented
    reverse scan, a backward walk over each run) against the JAX package's
    backward kernel in interpret mode and the port's plain version, with
    every cotangent nonzero, at COMPOSITE_BWD_TOL. Its weights are B's
    order's weights to the bit (gc = (1, 1, 1), the rest zero). At S = 1
    the JAX composite cannot trace one sample (ROADMAP queue 3), so the
    plain version alone holds it there."""
    n = 40
    rgb, sigma, z = _composite_rays(n, s, seed=10 + s)
    gc, gd, go, gw = _cotangents(n, s, seed=20 + s)
    got = _segmented_composite_bwd(rgb, sigma, z, gc, gd, go, gw, white_bkgd,
                                   act)
    refs = [kcomposite.composite_bwd_plain(
        t(rgb), t(sigma), t(z), t(gc), t(gd), t(go), t(gw), white_bkgd, act)]
    if s > 1:
        refs.append(_run_bwd(*(jnp.asarray(x) for x in (rgb, sigma, z, gc, gd,
                                                         go, gw)),
                             act, white_bkgd, 8, True))
    for ref in refs:
        grgb, gsigma, gz = (np.asarray(r) for r in ref)
        np.testing.assert_allclose(got[0], grgb, **COMPOSITE_BWD_TOL)
        np.testing.assert_allclose(got[1], gsigma, **COMPOSITE_BWD_TOL)
        # gz_i = (w_i gd - ddelta_i) + ddelta_{i-1} sums terms as large as
        # the ray's largest |gz| (~20 at S = 128), which cancel where gz_i
        # is small; one f32 ulp of 16 is 1.9e-6, above the atol, so two
        # correct orders differ there by ulps of the terms (seen: 1.5 ulps
        # beyond the bar at S = 128, softplus). gz's atol adds 4 of them.
        ulp = np.spacing(np.abs(gz).max(-1, keepdims=True))
        assert (np.abs(got[2] - gz) <= COMPOSITE_BWD_TOL["atol"] + 4 * ulp
                + COMPOSITE_BWD_TOL["rtol"] * np.abs(gz)).all()
    ones, zero = np.ones((n, 3), F32), np.zeros(n, F32)
    grgb = _segmented_composite_bwd(rgb, sigma, z, ones, zero, zero,
                                    np.zeros((n, s), F32), white_bkgd, act)[0]
    weights = _segmented_composite(rgb, sigma, z, white_bkgd, act)[3]
    for k in range(3):
        np.testing.assert_array_equal(grgb[..., k], weights)
