"""The arithmetic of kernels C and E's f32 route (3xTF32 on the tensor
cores, ``csrc/mlp_tf32.cuh``) on the CPU, where the CUDA kernels cannot
run:

- the split: ``tf32_round`` is ``cvt.rna.tf32.f32`` (10 mantissa bits,
  ties away from zero), and big + small gives the f32 value back within
  2^-22 of it;
- an emulation of the kernels' products in plain torch (every product
  the kernels run on the tensor cores as the three tf32 products they
  issue, summed in f32: C's layers, E's input gradients and weight
  gradients; E's forward recompute, the heads, biases and sums of the
  points in f32 as the kernels do them) against the JAX
  package's f32 ``fused_nerf_mlp`` and its v3 backward kernel in
  interpret mode, at the bars the card holds the kernels to
  (``chip_smoke.py``: TOL_MLP_F32 for C, 1e-4 a leaf for E);
- the packing: the forward and backward images unpack (core matrices,
  the reduction order, big + small) to every layer's weights, and the
  forward image walked chunk by chunk as the kernel walks it gives the
  plain forward.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch's threads in a test worker)

from nerfsr_tpu.models.mlp import VanillaMLP as JMLP
from nerfsr_tpu.ops.experimental.pallas_mlp import (_bwd, flatten_params,
                                                    fused_nerf_mlp)

from nerfsr_torch.kernels import mlp as kmlp

# chip_smoke.py's bars for the f32 kernels: C (rtol, atol) and E, per leaf
# ||got - ref|| / ||ref||
TOL_MLP_F32 = dict(rtol=1e-4, atol=2e-5)
TOL_MLP_BWD_F32 = 1e-4
D, W, SKIP, C_POS = kmlp.D, kmlp.W, kmlp.SKIP, kmlp.C_POS


def t(x):
    return torch.from_numpy(np.asarray(x, np.float32).copy())


def _jax_case(n, seed):
    mlp = JMLP(compute_dtype=jnp.float32)
    params = mlp.init(jax.random.PRNGKey(seed), jnp.zeros((1, 63)),
                      jnp.zeros((1, 27)))
    jflat = flatten_params(params)
    rng = np.random.RandomState(seed + 10)
    pts = (rng.rand(n, 3) * 2 - 1).astype(np.float32)
    dirs = rng.randn(n, 3).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    grgb = rng.randn(n, 3).astype(np.float32)
    gsig = rng.randn(n).astype(np.float32)
    return jflat, pts, dirs, grgb, gsig


# ---------------------------------------------------------------- split

def test_tf32_round_is_cvt_rna():
    """Round to nearest on the 13 dropped bits, ties away from zero, in
    both signs; exact tf32 values stay; a carry moves to the next
    binade."""
    ulp = 2.0 ** -10
    x = torch.tensor([1 + ulp / 2, -(1 + ulp / 2), 1 + 1.5 * ulp,
                      1 + ulp / 2 - 2.0 ** -23, 1 + ulp, 2 - ulp / 2, 0.0,
                      -0.0, 3.0])
    want = [1 + ulp, -(1 + ulp), 1 + 2 * ulp, 1.0, 1 + ulp, 2.0, 0.0, 0.0,
            3.0]
    assert kmlp.tf32_round(x).tolist() == want


@pytest.mark.parametrize("scale", [1e-6, 1.0, 1e4])
def test_tf32_split_gives_f32_back(scale):
    """big and small are tf32 values (their low 13 bits zero), and big +
    small is within 2^-22 of the f32 value (relative)."""
    x = torch.from_numpy(np.random.RandomState(0).randn(100_000)
                         .astype(np.float32)) * scale
    big, small = kmlp.tf32_split(x)
    for part in (big, small):
        assert not (part.view(torch.int32) & 0x1FFF).any()
    err = (big.double() + small.double() - x.double()).abs()
    assert (err <= 2.0 ** -22 * x.double().abs()).all()
    assert (small.abs() <= 2.0 ** -11 * x.abs()).all()


# ---------------------------------------------------------------- emulation

def mm3(a, b):
    """a @ b as the kernels compute it: both split, small(a) big(b) +
    big(a) small(b) + big(a) big(b), in f32."""
    ab, as_ = kmlp.tf32_split(a)
    bb, bs = kmlp.tf32_split(b)
    return as_ @ bb + ab @ bs + ab @ bb


def forward_3x(flat, x0, dmb, mm=mm3):
    """Kernel C's f32 route: every layer's product as ``mm3`` (``mm``);
    biases, ReLU, the sigma and rgb heads in f32."""
    ws = [k.float() for k in flat[0::2]]
    bs = [b.float().reshape(-1) for b in flat[1::2]]
    h = None
    acts = []
    for i in range(D):
        if i == 0:
            pre = mm(x0, ws[0])
        elif i == SKIP:
            pre = mm(torch.cat([x0, h], -1), ws[i])
        else:
            pre = mm(h, ws[i])
        h = torch.relu(pre + bs[i])
        acts.append(h)
    w_fin, w_sig, w_dir, w_rgb = ws[D:]
    feat = mm(h, w_fin) + bs[D]
    sigma = h @ w_sig + bs[D + 1]
    g = torch.relu(mm(torch.cat([feat, dmb], -1), w_dir) + bs[D + 2])
    rgb = torch.sigmoid(g @ w_rgb + bs[D + 3])
    return rgb, sigma[:, 0], acts, feat, g


def backward_3x(flat, x0, dmb, grgb, gsig):
    """Kernel E's f32 route: the forward recompute in f32 (E1 sums it on
    SIMT FMAs, so its ReLU masks are f32's), the input gradients' and the
    weight gradients' products as ``mm3`` (the last over the points); the
    heads' gradients, the bias sums and sigma's weight gradient in f32.
    The flat gradient tuple in PARAM_NAMES order."""
    ws = [k.float() for k in flat[0::2]]
    rgb, _, acts, feat, g = forward_3x(flat, x0, dmb, torch.matmul)
    w_fin, w_sig, w_dir, w_rgb = ws[D:]
    gpre = grgb * rgb * (1 - rgb)
    gg = (gpre @ w_rgb.t()) * (g > 0)
    gfeat = mm3(gg, w_dir[:W].t())
    gs = gsig.reshape(-1, 1)
    dws, dbs = [None] * (D + 4), [None] * (D + 4)
    din = torch.cat([feat, dmb], -1)
    dws[D + 3], dbs[D + 3] = mm3(g.t(), gpre), gpre.sum(0)
    dws[D + 2], dbs[D + 2] = mm3(din.t(), gg), gg.sum(0)
    dws[D], dbs[D] = mm3(acts[-1].t(), gfeat), gfeat.sum(0)
    dws[D + 1], dbs[D + 1] = acts[-1].t() @ gs, gs.sum(0)
    gh = mm3(gfeat, w_fin.t()) + gs * w_sig.t()
    for i in range(D - 1, -1, -1):
        gh = gh * (acts[i] > 0)
        inp = x0 if i == 0 else torch.cat([x0, acts[i - 1]], -1) \
            if i == SKIP else acts[i - 1]
        dws[i], dbs[i] = mm3(inp.t(), gh), gh.sum(0)
        if i > 0:
            gh = mm3(gh, (ws[i][C_POS:] if i == SKIP else ws[i]).t())
    out = []
    for dw, db in zip(dws, dbs):
        out += [dw, db.reshape(1, -1)]
    return tuple(out)


@pytest.mark.parametrize("n,seed", [(64, 0), (200, 1), (37, 2)])
def test_forward_3x_holds_the_f32_bar_against_jax(n, seed):
    """The emulated kernel C against the JAX package's f32 fused MLP
    (Pallas kernel in interpret mode) at TOL_MLP_F32, and against the
    port's plain f32 forward at the same bar."""
    jflat, pts, dirs, _, _ = _jax_case(n, seed)
    flat = tuple(t(np.asarray(x)) for x in jflat)
    x0, dmb = kmlp.embed(t(pts), t(dirs))
    rgb, sigma, *_ = forward_3x(flat, x0, dmb)
    p_rgb, p_sigma = fused_nerf_mlp(jflat, jnp.asarray(pts),
                                    jnp.asarray(dirs), jnp.float32, True)
    np.testing.assert_allclose(rgb.numpy(), np.asarray(p_rgb), **TOL_MLP_F32)
    np.testing.assert_allclose(sigma.numpy(), np.asarray(p_sigma),
                               **TOL_MLP_F32)
    ref_rgb, ref_sigma = kmlp.fused_mlp_plain(flat, x0, dmb)
    torch.testing.assert_close(rgb, ref_rgb, **TOL_MLP_F32)
    torch.testing.assert_close(sigma, ref_sigma, **TOL_MLP_F32)


@pytest.mark.parametrize("n,seed", [(64, 3), (130, 4)])
def test_backward_3x_holds_the_f32_bar_against_jax(n, seed):
    """The emulated kernel E against the JAX package's v3 backward kernel
    (interpret mode, as tests/test_pallas.py runs it) and the port's
    plain f32 backward: every leaf within 1e-4 norm-relative."""
    jflat, pts, dirs, grgb, gsig = _jax_case(n, seed)
    flat = tuple(t(np.asarray(x)) for x in jflat)
    x0, dmb = kmlp.embed(t(pts), t(dirs))
    got = backward_3x(flat, x0, dmb, t(grgb), t(gsig))
    v3 = _bwd(jnp.asarray(pts), jnp.asarray(dirs), jflat, jnp.asarray(grgb),
              jnp.asarray(gsig)[:, None], jnp.float32, True)
    plain = kmlp.fused_mlp_bwd_plain(flat, x0, dmb, t(grgb), t(gsig))
    assert len(got) == len(v3) == len(plain) == 24
    for i, (g, a, b) in enumerate(zip(got, v3, plain)):
        for ref in (np.asarray(a, np.float64), b.double().numpy()):
            rel = np.linalg.norm(g.double().numpy() - ref) / max(
                np.linalg.norm(ref), 1e-30)
            assert rel < TOL_MLP_BWD_F32, (i, rel)


def test_3x_is_closer_to_f64_than_one_tf32_product():
    """What the split buys: one tf32 product misses the f64 product by
    ~1e-3 relative, 3xTF32 by the f32 rounding's order."""
    rng = np.random.RandomState(5)
    a = torch.from_numpy(rng.randn(64, 256).astype(np.float32))
    b = torch.from_numpy(rng.randn(256, 256).astype(np.float32))
    ref = a.double() @ b.double()
    scale = float(ref.abs().max())
    one = float((kmlp.tf32_round(a).double() @ kmlp.tf32_round(b).double()
                 - ref).abs().max()) / scale
    three = float((mm3(a, b).double() - ref).abs().max()) / scale
    f32 = float(((a @ b).double() - ref).abs().max()) / scale
    assert one > 1e-4 and three < 2e-6 and three < 10 * f32 + 1e-7


# ---------------------------------------------------------------- packing

_FWD_N = [W] * 136 + [kmlp.W_HALF] * 18


def _unpack_tf32_image(img, ns):
    """Undo each chunk's image (big then small; core matrices; the
    reduction order): -> [(big (N, 16), small (N, 16))] per chunk."""
    img = np.asarray(img, np.float64)
    inv = np.argsort(kmlp.TF32_K_ORDER)
    out, o = [], 0
    for n in ns:
        parts = []
        for _ in range(2):
            c = img[o:o + n * 16].reshape(n // 8, 4, 8, 4)
            c = c.transpose(0, 2, 1, 3).reshape(n, 2, 8)[..., inv]
            parts.append(c.reshape(n, 16))
            o += n * 16
        out.append(tuple(parts))
    assert o == img.size
    return out


def _check_split(big, small, w):
    np.testing.assert_array_equal(big, kmlp.tf32_round(t(w)).double()
                                  .numpy())
    assert (np.abs(big + small - w) <= 2.0 ** -22 * np.abs(w)).all()


def test_tf32_images_unpack_to_the_weights():
    """The forward image's chunks, in consumption order, rebuild every
    layer's kernel (x0 and dmb padding rows zero) and the backward
    image's rebuild W[h rows] of the direction layer, final and layers
    7..1: big = tf32(w) exactly, big + small = w within 2^-22."""
    jflat, *_ = _jax_case(4, 6)
    flat = tuple(t(np.asarray(x)) for x in jflat)
    kern = [k.double().numpy() for k in flat[0::2]]
    img, b, heads = kmlp.pack_tf32(flat)
    assert img.dtype == torch.float32 and img.shape == (kmlp.TF32_FWD_IMAGE,)
    assert 4 * kmlp.TF32_FWD_IMAGE == 4751360          # csrc/mlp_tf32.cuh
    np.testing.assert_array_equal(b.numpy(), torch.cat(
        [x.reshape(-1) for x in flat[1::2]]).numpy())
    np.testing.assert_array_equal(heads.numpy(), np.concatenate(
        [kern[D + 1].ravel(), kern[D + 3].ravel()]).astype(np.float32))
    chunks = _unpack_tf32_image(img.numpy(), _FWD_N)
    big = [c[0].T for c in chunks]
    small = [c[1].T for c in chunks]

    def rows(i, n):
        return (np.concatenate(big[i:i + n]), np.concatenate(small[i:i + n]))

    i = 0
    for layer in range(D + 1):
        parts = []
        if layer in (0, SKIP):
            bx, sx = rows(i, 4)
            assert not bx[C_POS:].any() and not sx[C_POS:].any()
            parts.append((bx[:C_POS], sx[:C_POS]))
            i += 4
        if layer > 0:
            parts.append(rows(i, 16))
            i += 16
        _check_split(np.concatenate([p[0] for p in parts]),
                     np.concatenate([p[1] for p in parts]), kern[layer])
    bf, sf = rows(i, 16)
    bd, sd = rows(i + 16, 2)
    assert not bd[kmlp.C_DIR:].any()
    _check_split(np.concatenate([bf, bd[:kmlp.C_DIR]]),
                 np.concatenate([sf, sd[:kmlp.C_DIR]]), kern[D + 2])
    assert i + 18 == len(chunks)

    img_b, w32 = kmlp.pack_tf32_bwd(flat)
    assert img_b.shape == (kmlp.TF32_BWD_IMAGE,)
    np.testing.assert_array_equal(w32.numpy(), torch.cat(
        [k.reshape(-1) for k in flat[0::2]]).numpy())
    chunks = _unpack_tf32_image(img_b.numpy(), [W] * 136)
    mats = [kern[D + 2][:W], kern[D]]
    mats += [kern[i][C_POS:] if i == SKIP else kern[i]
             for i in range(D - 1, 0, -1)]
    i = 0
    for m in mats:
        n = m.shape[1] // 16
        _check_split(np.concatenate([c[0] for c in chunks[i:i + n]], 1),
                     np.concatenate([c[1] for c in chunks[i:i + n]], 1), m)
        i += n
    assert i == len(chunks)


def test_tf32_image_walk_matches_the_plain_forward():
    """Kernel C's f32 walk over its image in numpy: each product sums its
    chunks (A's next 16 columns in the reduction order against a chunk's
    big and small images, as 3xTF32) in consumption order; against the
    plain f32 forward at TOL_MLP_F32."""
    jflat, pts, dirs, _, _ = _jax_case(48, 7)
    flat = tuple(t(np.asarray(x)) for x in jflat)
    img, b, heads = kmlp.pack_tf32(flat)
    chunks = iter(_unpack_tf32_image(img.numpy(), _FWD_N))
    x0, dmb = kmlp.embed(t(pts), t(dirs))
    b = b.double().numpy()
    heads = heads.double().numpy()

    def split(a):
        big, small = kmlp.tf32_split(torch.from_numpy(a).float())
        return big.double().numpy(), small.double().numpy()

    def prod(a, n):
        acc, k0 = 0.0, 0
        for _ in range(n):
            bb, bs = next(chunks)
            ab, as_ = split(a[:, k0:k0 + 16])
            acc = acc + as_ @ bb.T + ab @ bs.T + ab @ bb.T
            k0 += 16
        assert k0 == a.shape[1]
        return acc

    x = np.pad(x0.double().numpy(), ((0, 0), (0, 1)))
    d = np.pad(dmb.double().numpy(), ((0, 0), (0, 5)))
    h = None
    for layer in range(D):
        acc = prod(x, 4) if layer in (0, SKIP) else 0.0
        if layer > 0:
            acc = acc + prod(h, 16)
        h = np.maximum(acc + b[layer * W:(layer + 1) * W], 0)
    o = D * W
    feat = prod(h, 16) + b[o:o + W]
    sigma = h @ heads[:W] + b[o + W]
    g = np.maximum(prod(feat, 16) + prod(d, 2)
                   + b[o + W + 1:o + W + 1 + kmlp.W_HALF], 0)
    rgb = 1 / (1 + np.exp(-(g @ heads[W:].reshape(kmlp.W_HALF, 3) + b[-3:])))
    assert next(chunks, None) is None
    ref_rgb, ref_sigma = kmlp.fused_mlp_plain(flat, x0, dmb)
    np.testing.assert_allclose(rgb, ref_rgb.numpy(), **TOL_MLP_F32)
    np.testing.assert_allclose(sigma, ref_sigma.numpy(), **TOL_MLP_F32)


def test_tf32_packing_cache_and_guards():
    """The f32 images are cached like the bf16 ones (``packed`` kinds
    "tf32" and "tf32_bwd") and repacked after an in-place update; the
    probe refuses tensors on the CPU."""
    from nerfsr_torch.models.mlp import VanillaMLP
    gen = torch.Generator().manual_seed(8)
    net = VanillaMLP().reset_parameters("kaiming", 0.02, gen)
    first = kmlp.packed(kmlp.flatten_params(net), "tf32")
    assert all(a is b for a, b in zip(
        first, kmlp.packed(kmlp.flatten_params(net), "tf32")))
    assert kmlp.packed(kmlp.flatten_params(net), "tf32_bwd")[0].shape == \
        (kmlp.TF32_BWD_IMAGE,)
    with torch.no_grad():
        net.xyz_encoding_2.weight.mul_(2.0)
    moved = kmlp.packed(kmlp.flatten_params(net), "tf32")
    assert moved[0] is not first[0] and not torch.equal(moved[0], first[0])
    with pytest.raises(ValueError, match="CUDA tensor"):
        kmlp.tf32_probe(torch.zeros((64, 32)), torch.zeros((32, 256)), 0)
