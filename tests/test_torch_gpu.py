"""The port's CUDA kernels (A-F) against their plain PyTorch versions on
the card. Every test here needs an NVIDIA GPU and skips without one; the
file imports no JAX, so it also runs where only PyTorch is installed:

    python -m pytest tests/test_torch_gpu.py -q

Tolerances as in ``chip_smoke.py``, which holds the same kernels at the
serving path's full shapes.
"""

import pytest
import torch

from nerfsr_torch.core import encoding
from nerfsr_torch.core.rendering import volumetric_rendering as plain_comp
from nerfsr_torch.core.sampling import _invert_cdf, stratified_uniforms
from nerfsr_torch.kernels import COUNTS, LAUNCHES_PER_CALL, _lib, reset_counts
from nerfsr_torch.kernels import composite as kcomposite
from nerfsr_torch.kernels import mlp as kmlp
from nerfsr_torch.kernels import posenc as kposenc
from nerfsr_torch.kernels import sampling as ksampling
from nerfsr_torch.models.mlp import VanillaMLP
from nerfsr_torch.timing import floor_ms

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


# kernel A's bar (chip_smoke.py TOL_INVERT_CDF): the CDF's f32 rounding in
# another sum order, over the local density
Z_ATOL = 1e-4
# kernel B's bar (chip_smoke.py TOL_COMPOSITE): scanned vs serial products
COMPOSITE_TOL = dict(rtol=2e-4, atol=1e-5)
# kernel D's bar (chip_smoke.py TOL_COMPOSITE_BWD): scanned products and
# suffix sums against serial ones, on gradients of order 1-100
COMPOSITE_BWD_TOL = dict(rtol=1e-3, atol=1e-4)
RAGGED_N = 4097   # one ray past a multiple of every rays-a-block count


def _invert_cdf_rows(n, b, q, seed, dev):
    """Sorted bins, uniform weights with a degenerate (all-0) and a
    concentrated row, and uniform u (unsorted, anywhere in [0, 1))."""
    gen = torch.Generator().manual_seed(seed)
    z = torch.sort(torch.rand((n, b + 1), generator=gen), -1)[0]
    bins = 0.5 * (z[:, :-1] + z[:, 1:])
    w = torch.rand((n, b - 1), generator=gen)
    w[0] = 0.0
    w[1, :2] = 100.0
    u = torch.rand((n, q), generator=gen)
    return bins.to(dev), w.to(dev), u.to(dev)


@pytest.mark.parametrize("q", [1, 16, 24, 40])
@pytest.mark.parametrize("b", [2, 25, 47, 128])
def test_invert_cdf_kernel(dev, b, q):
    """Kernel A against its plain version at ragged N, bin counts from 2
    to 128 (the register route), queries fewer and more than a warp's
    lanes; two calls give the same bits."""
    bins, w, u = _invert_cdf_rows(RAGGED_N, b, q, 100 * b + q, dev)
    reset_counts()
    got = ksampling.invert_cdf(bins, w, u)
    again = ksampling.invert_cdf(bins, w, u)
    torch.cuda.synchronize()
    assert COUNTS["invert_cdf"] == 2
    torch.testing.assert_close(got, _invert_cdf(bins, w, u), rtol=0,
                               atol=Z_ATOL)
    assert torch.equal(got, again)


def test_invert_cdf_kernel_degenerate_rows(dev):
    """Rows of all-zero weights (the eps pad alone: a uniform pdf) and
    rows of all mass in one bin, with queries at the cell centres."""
    n, b, q = 64, 47, 24
    bins, w, _ = _invert_cdf_rows(n, b, q, 9, dev)
    w.zero_()
    w[n // 2:, 5] = 1.0
    u = stratified_uniforms(bins, q, False).contiguous()
    got = ksampling.invert_cdf(bins, w, u)
    torch.testing.assert_close(got, _invert_cdf(bins, w, u), rtol=0,
                               atol=Z_ATOL)


def test_invert_cdf_guards(dev):
    bins, w, u = _invert_cdf_rows(8, 24, 16, 0, dev)
    with pytest.raises(ValueError, match="contiguous"):
        ksampling.invert_cdf(bins, w, u.t().contiguous().t())
    with pytest.raises(ValueError, match="shape"):
        ksampling.invert_cdf(bins, w[:, 1:].contiguous(), u)
    with pytest.raises(TypeError, match="dtype"):
        ksampling.invert_cdf(bins, w.double(), u)
    with pytest.raises(ValueError, match="CUDA"):
        ksampling.invert_cdf(bins, w, u.cpu())
    one, wone, uone = _invert_cdf_rows(8, 1, 4, 0, dev)
    with pytest.raises(ValueError, match="bins"):
        ksampling.invert_cdf(one, wone, uone)
    # past the register route's 128 bins nothing is refused
    big, wbig, ubig = _invert_cdf_rows(8, 129, 4, 0, dev)
    torch.testing.assert_close(ksampling.invert_cdf(big, wbig, ubig),
                               _invert_cdf(big, wbig, ubig), rtol=0,
                               atol=Z_ATOL)


# the wide routes: the llff x2 step at --n_prop 256 --n_prop2 192 (255
# and 191 bins), 1024 and 4097 (the CDF in shared memory), 30,000 and
# 100,000 (past 16,384 bins: streamed, and past a block's shared memory
# even for the CDF alone), with the route the launcher takes at each
WIDE_BINS = [129, 191, 255, 1024, 4097, 30000, 100000]
WIDE_ROUTES = {b: "shared" if b <= 16384 else "streamed" for b in WIDE_BINS}


def _wide_n(b):
    return RAGGED_N if b < 30000 else 517


def _moved_queries(got, bins, w, u):
    """The queries of kernel A's output ``got`` past Z_ATOL from the plain
    version, checked to be what the `denom < eps -> 1` rule moves: each
    in a bin, or beside one, whose CDF step (the plain version's) is
    under 2 eps, within the two CDFs' rounding of the rule's threshold
    (the two CDFs may put a query near a bin's edge on either side), and
    each by at most those bins' width. Returns their count."""
    ref = _invert_cdf(bins, w, u)
    diff = (got - ref).abs()
    moved = diff > Z_ATOL
    if moved.any():
        rows, cols = moved.nonzero(as_tuple=True)
        pdf = (w[rows] + 1e-5) / (w[rows] + 1e-5).sum(-1, keepdim=True)
        cdf = torch.cat([torch.zeros_like(pdf[:, :1]), pdf.cumsum(-1)], -1)
        k = torch.searchsorted(cdf, u[rows, cols, None], right=True)
        near = (k - 1 + torch.arange(-1, 2, device=k.device)).clamp(
            0, bins.shape[1] - 2)                    # the bin and its two
        step = cdf.gather(1, near + 1) - cdf.gather(1, near)
        width = bins[rows][:, 1:].gather(1, near) - bins[rows].gather(1, near)
        assert (step.min(-1).values < 2e-5).all()
        assert (diff[moved] <= width.max(-1).values + Z_ATOL).all()
    return int(moved.sum())


@pytest.mark.parametrize("q", [16, 37])
@pytest.mark.parametrize("b", WIDE_BINS)
def test_invert_cdf_kernel_wide(dev, b, q):
    """Kernel A's wide route against its plain version at ragged N and Q,
    at the register route's bar: every query within Z_ATOL but those the
    `denom < eps -> 1` rule moves (counted and printed; each in a bin
    whose CDF step is within rounding of eps, by at most its width); two
    calls give the same bits."""
    n = _wide_n(b)
    bins, w, u = _invert_cdf_rows(n, b, q, 7 * b + q, dev)
    plan = ksampling.launch_plan(n, b)
    assert plan["route"] == WIDE_ROUTES[b]
    reset_counts()
    got = ksampling.invert_cdf(bins, w, u)
    again = ksampling.invert_cdf(bins, w, u)
    torch.cuda.synchronize()
    assert COUNTS["invert_cdf"] == 2
    assert torch.equal(got, again)
    moved = _moved_queries(got, bins, w, u)
    print(f"[kernel A wide] B={b} Q={q} N={n} {plan}: {moved} of "
          f"{got.numel()} queries moved past {Z_ATOL} by the eps rule")


@pytest.mark.parametrize("b", WIDE_BINS)
def test_invert_cdf_kernel_wide_ends(dev, b):
    """The wide routes at unsorted u with queries at 0, at the plain
    version's last CDF entry and the floats beside it, at 1, past 1 and
    below 0: each within the bar of the plain version but where the eps
    rule moves it (the ends take the clamps: bins[0] below 0, the last
    bin at and past the last entry); two calls give the same bits."""
    n, q = _wide_n(b), 37
    bins, w, u = _invert_cdf_rows(n, b, q, 11 * b, dev)
    wp = w + 1e-5
    last = (wp / wp.sum(-1, keepdim=True)).cumsum(-1)[:, -1]
    u[:, 0] = 0.0
    u[:, 1] = last
    u[:, 2] = torch.nextafter(last, torch.zeros_like(last))
    u[:, 3] = torch.nextafter(last, torch.ones_like(last) * 2)
    u[:, 4] = 1.0
    u[:, 5] = 1.5
    u[:, 6] = -0.25
    got = ksampling.invert_cdf(bins, w, u)
    again = ksampling.invert_cdf(bins, w, u)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    _moved_queries(got, bins, w, u)
    assert torch.equal(got[:, 6], bins[:, 0])
    assert torch.equal(got[:, 5], bins[:, -1])


@pytest.mark.parametrize("b", [30000, 100000])
def test_invert_cdf_kernel_allocates_only_z(dev, b):
    """A call on the streamed route allocates nothing but z: the peak of
    device memory rises by no more than z's bytes plus 1 MiB (the
    earlier workspace route took N (B + 32) floats a call past ~29 K
    bins)."""
    n, q = _wide_n(b), 24
    bins, w, u = _invert_cdf_rows(n, b, q, 5, dev)
    ksampling.invert_cdf(bins, w, u)            # the first call's set-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    z = ksampling.invert_cdf(bins, w, u)
    torch.cuda.synchronize()
    rise = torch.cuda.max_memory_allocated(dev) - base
    assert rise <= z.numel() * 4 + 2 ** 20, rise


@pytest.mark.parametrize("act", ["relu", "softplus"])
@pytest.mark.parametrize("white", [False, True])
@pytest.mark.parametrize("s", [1, 16, 33, 48, 64, 128])
def test_composite_kernel(dev, s, act, white):
    """Kernel B against its plain version at ragged N: a lane a sample
    (S <= 32, S = 1 included) and runs of consecutive samples a lane
    (S > 32, ragged S = 33 included, S = 48 of the Blender fast step);
    two calls give the same bits."""
    gen = torch.Generator().manual_seed(s)
    rgb = torch.rand((RAGGED_N, s, 3), generator=gen).to(dev)
    sigma = (torch.randn((RAGGED_N, s), generator=gen) * 2).to(dev)
    z = torch.sort(torch.rand((RAGGED_N, s), generator=gen), -1)[0].to(dev)
    reset_counts()
    got = kcomposite.volumetric_rendering(rgb, sigma, z, white, act)
    again = kcomposite.composite_fwd(rgb, sigma, z, white, act)
    torch.cuda.synchronize()
    assert COUNTS["composite_fwd"] == 2
    ref = plain_comp(rgb, sigma, z, white, act)
    for g, a, r in zip(got, again, ref):
        torch.testing.assert_close(g, r, **COMPOSITE_TOL)
        assert torch.equal(g, a)


def test_composite_guards(dev):
    rgb = torch.rand((8, 16, 3), device=dev)
    sigma = torch.randn((8, 16), device=dev)
    z = torch.sort(torch.rand((8, 16), device=dev), -1)[0]
    with pytest.raises(ValueError, match="contiguous"):
        kcomposite.composite_fwd(rgb, sigma, z.t().contiguous().t(), False)
    with pytest.raises(ValueError, match="shape"):
        kcomposite.composite_fwd(rgb[:, :15].contiguous(), sigma, z, False)
    with pytest.raises(TypeError, match="dtype"):
        kcomposite.composite_fwd(rgb, sigma.double(), z, False)
    with pytest.raises(ValueError, match="activation"):
        kcomposite.composite_fwd(rgb, sigma, z, False, "tanh")


def test_launch_floor(dev):
    """The empty kernel launches (on one block and on A's serving grid)
    and takes a positive time; a grid of no blocks is refused."""
    assert floor_ms() > 0 and floor_ms(512, 256) > 0
    with pytest.raises(RuntimeError, match="CUDA error"):
        _lib.check(_lib.lib().nerfsr_empty_kernel(
            0, 32, torch.cuda.current_stream().cuda_stream), "empty_kernel")


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
def test_fused_mlp_kernel(dev, dtype, tol):
    gen = torch.Generator().manual_seed(2)
    net = VanillaMLP().reset_parameters("kaiming", 0.02, gen).to(dev)
    pts = (torch.rand((1000, 3), generator=gen) * 2 - 1).to(dev)
    dirs = torch.nn.functional.normalize(
        torch.randn((1000, 3), generator=gen), dim=-1).to(dev)
    with torch.no_grad():
        flat = kmlp.flatten_params(net)
        x0, dmb = kmlp.embed(pts, dirs)
        rgb, sigma = kmlp.fused_mlp_fwd(flat, x0, dmb, dtype)
        ref_rgb, ref_sigma = kmlp.fused_mlp_plain(flat, x0, dmb, dtype)
    torch.testing.assert_close(rgb, ref_rgb, rtol=tol, atol=tol)
    torch.testing.assert_close(sigma, ref_sigma, rtol=tol, atol=tol)


@pytest.mark.parametrize("act", ["relu", "softplus"])
@pytest.mark.parametrize("white", [False, True])
@pytest.mark.parametrize("s", [1, 16, 33, 48, 64, 128])
def test_composite_bwd_kernel(dev, s, act, white):
    """Kernel D against its plain version at ragged N with every cotangent
    nonzero: a lane a sample (S <= 32, S = 1 included) and runs of
    consecutive samples a lane (S > 32, ragged S = 33 included, S = 48 of
    the Blender fast step); two calls
    give the same bits; with gc = (1, 1, 1) and the other cotangents zero,
    grgb is B's weights to the bit (B and D share one T/alpha helper); and
    through the autograd Function, B forward and D backward, one launch
    each."""
    gen = torch.Generator().manual_seed(3 + s)
    n = RAGGED_N
    rgb = torch.rand((n, s, 3), generator=gen).to(dev)
    sigma = (torch.randn((n, s), generator=gen) * 2).to(dev)
    z = torch.sort(torch.rand((n, s), generator=gen), -1)[0].to(dev)
    gc = torch.randn((n, 3), generator=gen).to(dev)
    gd, go = (torch.randn((n,), generator=gen).to(dev) for _ in range(2))
    gw = torch.randn((n, s), generator=gen).to(dev)
    reset_counts()
    got = kcomposite.composite_bwd(rgb, sigma, z, gc, gd, go, gw, white, act)
    again = kcomposite.composite_bwd(rgb, sigma, z, gc, gd, go, gw, white,
                                     act)
    torch.cuda.synchronize()
    assert COUNTS["composite_bwd"] == 2
    ref = kcomposite.composite_bwd_plain(rgb, sigma, z, gc, gd, go, gw,
                                         white, act)
    for g, a, r in zip(got, again, ref):
        torch.testing.assert_close(g, r, **COMPOSITE_BWD_TOL)
        assert torch.equal(g, a)

    zeros = torch.zeros_like(gd)
    grgb = kcomposite.composite_bwd(rgb, sigma, z, torch.ones_like(gc),
                                    zeros, zeros, torch.zeros_like(gw),
                                    white, act)[0]
    weights = kcomposite.composite_fwd(rgb, sigma, z, white, act)[3]
    for k in range(3):
        assert torch.equal(grgb[..., k], weights)

    sig = sigma.clone().requires_grad_(True)
    reset_counts()
    out = kcomposite.volumetric_rendering(rgb, sig, z, white, act)
    (out[0] * gc).sum().backward()
    assert COUNTS["composite_fwd"] == 1 and COUNTS["composite_bwd"] == 1
    ref_s = kcomposite.composite_bwd_plain(rgb, sigma, z, gc, zeros, zeros,
                                           torch.zeros_like(gw), white,
                                           act)[1]
    torch.testing.assert_close(sig.grad, ref_s, **COMPOSITE_BWD_TOL)


def _rel_errs(got, ref):
    return [float((g.double() - r.double()).norm()
                  / r.double().norm().clamp_min(1e-30))
            for g, r in zip(got, ref)]


@pytest.mark.parametrize("dtype,bar", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
def test_fused_mlp_bwd_kernel(dev, dtype, bar):
    """Kernel E against its plain version: every weight and bias gradient
    within a norm-relative bar (sums over the points in another order;
    in bf16 also rounding flips of single gradients, as chip_smoke.py
    states), and through the autograd Function."""
    gen = torch.Generator().manual_seed(4)
    net = VanillaMLP().reset_parameters("kaiming", 0.02, gen).to(dev)
    p = 1000
    pts = (torch.rand((p, 3), generator=gen) * 2 - 1).to(dev)
    dirs = torch.nn.functional.normalize(
        torch.randn((p, 3), generator=gen), dim=-1).to(dev)
    grgb = torch.randn((p, 3), generator=gen).to(dev)
    gsig = torch.randn((p,), generator=gen).to(dev)
    with torch.no_grad():
        flat = kmlp.flatten_params(net)
        x0, dmb = kmlp.embed(pts, dirs)
        reset_counts()
        got = kmlp.fused_mlp_bwd(flat, x0, dmb, grgb, gsig, dtype)
        torch.cuda.synchronize()
        assert COUNTS["fused_mlp_bwd"] == 1
        assert LAUNCHES_PER_CALL["fused_mlp_bwd"] == 3
        ref = kmlp.fused_mlp_bwd_plain(flat, x0, dmb, grgb, gsig, dtype)
    assert [tuple(g.shape) for g in got] == [tuple(r.shape) for r in ref]
    assert max(_rel_errs(got, ref)) < bar
    # again: the sums are in a fixed order, so the result is the same
    with torch.no_grad():
        again = kmlp.fused_mlp_bwd(flat, x0, dmb, grgb, gsig, dtype)
    assert all(torch.equal(a, g) for a, g in zip(again, got))
    flat = kmlp.flatten_params(net)
    rgb, sigma = kmlp.fused_mlp_fwd(flat, x0, dmb, dtype)
    ((rgb * grgb).sum() + (sigma * gsig).sum()).backward()
    assert COUNTS["fused_mlp_fwd"] == 1 and COUNTS["fused_mlp_bwd"] == 3
    assert torch.equal(net.rgb.weight.grad.t(), got[-2])
    assert torch.equal(net.xyz_encoding_1.bias.grad, got[1][0])


def test_tc_probe_one_layer(dev):
    """One 256 -> 256 product through the tensor-core tile (weight image,
    ring, descriptors, accumulator layout) against torch.matmul of the
    same bf16 operands in f32 (another f32 summation order)."""
    gen = torch.Generator().manual_seed(5)
    x = torch.randn((128, 256), generator=gen).to(torch.bfloat16).to(dev)
    w = (torch.randn((256, 256), generator=gen) / 16).to(dev)
    got = kmlp.tc_probe(x, w)
    ref = x.float() @ w.to(torch.bfloat16).float()
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("p", [1, 63, 127, 129, 1000])
def test_fused_mlp_tc_ragged(dev, p):
    """The bf16 tensor-core kernels C and E at ragged sizes against their
    plain versions; E gives the same bits twice. C's bar is
    test_fused_mlp_kernel's. E's is wider than test_fused_mlp_bwd_kernel's:
    over a few hundred points one row's cascade of bf16 rounding flips
    (chip_smoke.py, TOL_MLP_BWD) dominates a leaf (seen 2.2e-2 at P = 127
    on the H100, where the plain version was 4e-4 from the f64 rule)."""
    gen = torch.Generator().manual_seed(6)
    net = VanillaMLP().reset_parameters("kaiming", 0.02, gen).to(dev)
    pts = (torch.rand((p, 3), generator=gen) * 2 - 1).to(dev)
    dirs = torch.nn.functional.normalize(
        torch.randn((p, 3), generator=gen), dim=-1).to(dev)
    grgb = torch.randn((p, 3), generator=gen).to(dev)
    gsig = torch.randn((p,), generator=gen).to(dev)
    bf16 = torch.bfloat16
    with torch.no_grad():
        flat = kmlp.flatten_params(net)
        x0, dmb = kmlp.embed(pts, dirs)
        reset_counts()
        rgb, sigma = kmlp.fused_mlp_fwd(flat, x0, dmb, bf16)
        got = kmlp.fused_mlp_bwd(flat, x0, dmb, grgb, gsig, bf16)
        again = kmlp.fused_mlp_bwd(flat, x0, dmb, grgb, gsig, bf16)
        torch.cuda.synchronize()
        assert COUNTS["fused_mlp_fwd"] == 1 and COUNTS["fused_mlp_bwd"] == 2
        ref_rgb, ref_sigma = kmlp.fused_mlp_plain(flat, x0, dmb, bf16)
        ref = kmlp.fused_mlp_bwd_plain(flat, x0, dmb, grgb, gsig, bf16)
    torch.testing.assert_close(rgb, ref_rgb, rtol=2e-2, atol=2e-2)
    torch.testing.assert_close(sigma, ref_sigma, rtol=2e-2, atol=2e-2)
    assert max(_rel_errs(got, ref)) < 5e-2
    assert all(torch.equal(a, g) for a, g in zip(again, got))


# kernel C's f32 bar (chip_smoke.py TOL_MLP_F32) and kernel E's, a leaf
TOL_MLP_F32 = dict(rtol=1e-4, atol=2e-5)
TOL_MLP_BWD_F32 = 1e-4


def test_tf32_probe_layouts(dev):
    """The tf32 wgmma pieces (csrc/tf32_probe.cu) against host products:
    A and B from shared memory, A from registers in the kernels'
    placement and in the hardware's, exactly on small integers; 3xTF32
    within 1e-6 (of the largest value) of the f64 product; the tensor
    cores truncate the bits below tf32's (mode 4)."""
    gen = torch.Generator().manual_seed(7)
    a = torch.randint(-4, 5, (64, 32), generator=gen).float()
    b = torch.randint(-4, 5, (32, 256), generator=gen).float()
    for mode in (0, 1, 2):
        got = kmlp.tf32_probe(a.to(dev), b.to(dev), mode).cpu()
        assert torch.equal(got, a @ b), kmlp.TF32_PROBE_MODES[mode]
    a = torch.randn((64, 32), generator=gen)
    b = torch.randn((32, 256), generator=gen)
    ref = a.double() @ b.double()
    got = kmlp.tf32_probe(a.to(dev), b.to(dev), 3).cpu().double()
    assert float((got - ref).abs().max()) < 1e-6 * float(ref.abs().max())

    def trunc(x):
        return (x.view(torch.int32) & -0x2000).view(torch.float32).double()
    raw = kmlp.tf32_probe(a.to(dev), b.to(dev), 4).cpu().double()
    torch.testing.assert_close(raw, trunc(a) @ trunc(b), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("p", [1, 63, 127, 129, 1000, 32768 + 37, 65536])
def test_fused_mlp_tf32_shapes(dev, p):
    """The f32 route (3xTF32) of kernels C and E against their plain
    versions at ragged sizes and at the serving and step shapes (C at
    P = 65,536 serves a chunk, E at 32,768 + 37 a ragged step): C at
    TOL_MLP_F32, E at 1e-4 a leaf; E gives the same bits twice."""
    gen = torch.Generator().manual_seed(9)
    net = VanillaMLP().reset_parameters("kaiming", 0.02, gen).to(dev)
    pts = (torch.rand((p, 3), generator=gen) * 2 - 1).to(dev)
    dirs = torch.nn.functional.normalize(
        torch.randn((p, 3), generator=gen), dim=-1).to(dev)
    grgb = (torch.randn((p, 3), generator=gen) * 1e-3).to(dev)
    gsig = (torch.randn((p,), generator=gen) * 1e-3).to(dev)
    f32 = torch.float32
    with torch.no_grad():
        flat = kmlp.flatten_params(net)
        x0, dmb = kmlp.embed(pts, dirs)
        reset_counts()
        rgb, sigma = kmlp.fused_mlp_fwd(flat, x0, dmb, f32)
        ref_rgb, ref_sigma = kmlp.fused_mlp_plain(flat, x0, dmb, f32)
        torch.testing.assert_close(rgb, ref_rgb, **TOL_MLP_F32)
        torch.testing.assert_close(sigma, ref_sigma, **TOL_MLP_F32)
        if p > 40000:
            return
        got = kmlp.fused_mlp_bwd(flat, x0, dmb, grgb, gsig, f32)
        again = kmlp.fused_mlp_bwd(flat, x0, dmb, grgb, gsig, f32)
        torch.cuda.synchronize()
        assert COUNTS["fused_mlp_fwd"] == 1 and COUNTS["fused_mlp_bwd"] == 2
        ref = kmlp.fused_mlp_bwd_plain(flat, x0, dmb, grgb, gsig, f32)
    assert max(_rel_errs(got, ref)) < TOL_MLP_BWD_F32
    assert all(torch.equal(a, g) for a, g in zip(again, got))


# ---------------------------------------------------------------------
# the engine on the card
# ---------------------------------------------------------------------

def _engine_argv(scene, work, phase, *extra):
    argv = ["--name", "gpu", "--model", "nerf_downX",
            "--dataset_mode", "llff_downX", "--dataset_root", str(scene),
            "--fast_preset", "llff", "--precision", "mixed",
            "--img_wh", "64", "64", "--downscale", "2",
            "--checkpoints_dir", str(work / "ck")]
    if phase == "train":
        argv += ["--batch_size", "64", "--steps_per_epoch", "5",
                 "--scan_steps", "2", "--val_freq", "0",
                 "--summary_dir", str(work / "runs")]
    else:
        argv += ["--results_dir", str(work / "res")]
    return argv + list(extra)


def test_engine_round_trip(dev, tmp_path):
    """Two epochs, a resume to a third and a test render of a 64x64
    synthetic COLMAP scene through the engine; training launches all
    five kernels, the test render A, B and C."""
    import os

    import numpy as np

    from nerfsr_torch import engine
    from nerfsr_torch.config import parse_options
    from nerfsr_torch.data.llff import center_poses, spiral_path
    from nerfsr_torch.data.synthetic import write_llff_scene

    poses = center_poses(spiral_path(np.array([.2, .2, .05]), 3.5, 4))[0]
    rng = np.random.RandomState(0)
    imgs = (rng.rand(4, 64, 64, 3) * 255).astype(np.uint8)
    pts = rng.rand(300, 3) * [2.0, 2.0, 1.0] + [-1.0, -1.0, -4.0]
    scene = tmp_path / "scene"
    write_llff_scene(str(scene), poses, imgs, 52.0, pts)

    reset_counts()
    state = engine.train(parse_options(
        "train", _engine_argv(scene, tmp_path, "train", "--n_epochs", "2")))
    assert state.step == 10 and all(COUNTS[k] > 0 for k in COUNTS), COUNTS
    state = engine.train(parse_options(
        "train", _engine_argv(scene, tmp_path, "train", "--n_epochs", "3",
                              "--continue_train")))
    assert state.step == 15
    reset_counts()
    out = engine.test(parse_options(
        "test", _engine_argv(scene, tmp_path, "test", "--test_split",
                             "test_train", "--load_epoch", "3")))
    assert COUNTS["invert_cdf"] and COUNTS["composite_fwd"] and \
        COUNTS["fused_mlp_fwd"] and not COUNTS["composite_bwd"]
    names = set(os.listdir(out))
    assert {f"{i}-fine-ori.png" for i in range(4)} <= names
    assert {"fine.gif", "fine-ori.gif", "3-fine-depth-ori.npz"} <= names


def test_kernel_a_takes_any_bin_count_at_construction(dev):
    """NeRF-SR x2 at --n_prop 256 --n_prop2 192 (255 and 191 bins a ray,
    the wide route of kernel A) builds on the card and renders a 64x48
    view: two A launches a chunk, finite outputs of the view's shapes."""
    import numpy as np

    from nerfsr_torch.config import default_options
    from nerfsr_torch.data.views import LLFFDownXViews
    from nerfsr_torch.models import create_model

    wh = (64, 48)
    opt = default_options("test", model="nerf_downX",
                          dataset_mode="llff_downX", fast_preset="llff",
                          img_wh=wh, downscale=2, n_prop=256, n_prop2=192)
    system = create_model(opt, device=dev)
    params = system.init_params(seed=0)
    views = LLFFDownXViews.spiral(52.0, wh, 2, 1)
    n_chunks = -(-wh[0] * wh[1] // system._eval_chunk_size(wh[0] * wh[1]))
    reset_counts()
    out = next(iter(system.render_eval_many(params, views, [0],
                                            quantize_rgb=True)))
    torch.cuda.synchronize()
    assert COUNTS["invert_cdf"] == 2 * n_chunks
    assert out["fine_rgb_ori"].shape == (wh[0] * wh[1], 3)
    assert all(np.isfinite(np.asarray(v, np.float64)).all()
               for v in out.values())


def test_parity_step_through_the_engine(dev, tmp_path, monkeypatch):
    """Two vanilla NeRF steps on the parity schedule (64 + 64 samples,
    white background, world rays) through the engine from a 64x64 Blender
    scene written on the card, the first drawn from the train_crop
    warm-up: each step 2 B, 2 C, 2 D, 2 E, 4 F and no A, and each of the two
    networks (coarse, fine) packed once a step for C and once for E. The
    second step is the first of a graphed chunk (``--scan_steps`` 20):
    run eagerly, then captured, and the capture packs each network once
    more for each kernel, which the graph's replays then repeat inside
    it."""
    from nerfsr_torch import engine
    from nerfsr_torch.config import parse_options
    from nerfsr_torch.data.synthetic import write_blender_scene

    packs = []

    def counting(kind, real):
        def pack(params_flat):
            base = params_flat[0]._base
            net = id(params_flat[0] if base is None else base)
            packs.append((kind, net,
                          tuple(t._version for t in params_flat)))
            return real(params_flat)
        return pack

    for kind in ("pack_tc", "pack_tc_bwd"):
        monkeypatch.setattr(kmlp, kind, counting(kind, getattr(kmlp, kind)))
    scene = tmp_path / "blender"
    write_blender_scene(str(scene), hw=(64, 64), n_train=2, n_val=1,
                        n_test=1, device=dev)
    opt = parse_options("train", [
        "--name", "parity", "--model", "nerf", "--dataset_mode", "blender",
        "--dataset_root", str(scene), "--img_wh", "64", "64",
        "--N_coarse", "64", "--N_importance", "64", "--batch_size", "256",
        "--n_epochs", "1", "--steps_per_epoch", "2", "--val_freq", "0",
        "--val_epoch_freq", "0", "--vis_epoch_freq", "0",
        "--checkpoints_dir", str(tmp_path / "ck"),
        "--summary_dir", str(tmp_path / "runs")])
    reset_counts()
    state = engine.train(opt, warmup_mode="train_crop", warmup_iters=1)
    torch.cuda.synchronize()
    assert state.step == 2
    assert COUNTS == {"invert_cdf": 0, "composite_fwd": 4,
                      "fused_mlp_fwd": 4, "composite_bwd": 4,
                      "fused_mlp_bwd": 4, "posenc": 8}, COUNTS
    assert all(torch.isfinite(p).all() for p in state.params.parameters())
    # every pack is of another (kind, network, parameter state): a
    # network is packed once per kind in a step and in the capture, and
    # the optimizer's update between them makes each pack again
    assert len(set(packs)) == len(packs) == 12, packs
    for kind in ("pack_tc", "pack_tc_bwd"):
        nets = [net for k, net, _ in packs if k == kind]
        assert sorted(nets.count(n) for n in set(nets)) == [3, 3], packs


def _llff_x2_buffer(dev, hw):
    """NeRF-SR x2's training options (``--fast_preset llff``, mixed, the
    full-width MLP, 64 LR rays a step) and a ray buffer of 3 views that
    a teacher (seed 1, sigma biases +3) renders at ``hw``."""
    from nerfsr_torch.config import default_options
    from nerfsr_torch.data.views import LLFFDownXTrainViews
    from nerfsr_torch.models import create_model

    opt = default_options("train", model="nerf_downX",
                          dataset_mode="llff_downX", fast_preset="llff",
                          img_wh=hw, downscale=2, precision="mixed",
                          batch_size=64, include_var=True, ds_method="avg")
    teacher_sys = create_model(opt, device=dev)
    teacher = teacher_sys.init_params(seed=1)
    with torch.no_grad():
        for net in teacher.values():
            net.sigma.bias += 3.0
    return opt, LLFFDownXTrainViews.rendered(teacher_sys, teacher, 52.0,
                                             hw, 2, 3).ray_buffer(dev)


def test_graphed_chunk_and_eval_equal_the_eager_route(dev):
    """The twin of ``chip_smoke.py``'s graphs phase at 64x48: NeRF-SR x2
    (``--fast_preset llff``, mixed, the full-width MLP) trains a 6-step
    chunk through ``train_steps_scan`` (one eager step, the capture, five
    replays) and through the eager ``train_steps`` from the same seed:
    every parameter, moment and step count equal bit for bit, each route
    2 A, 1 B, 1 C, 1 D, 1 E and 4 F a step. Then each eval view, one replay,
    equals the chunk loop."""
    import numpy as np

    from nerfsr_torch.data.views import LLFFDownXViews
    from nerfsr_torch.models import create_model
    from nerfsr_torch.weights import param_leaves

    hw, steps = (64, 48), 6
    opt, buf = _llff_x2_buffer(dev, hw)
    per_step = {"invert_cdf": 2, "composite_fwd": 1, "fused_mlp_fwd": 1,
                "composite_bwd": 1, "fused_mlp_bwd": 1, "posenc": 4}
    states = {}
    for route in ("eager", "graphed"):
        system = create_model(opt, device=dev)
        state = system.create_state(seed=0, steps_per_epoch=4)
        run = system.train_steps if route == "eager" \
            else system.train_steps_scan
        reset_counts()
        state, _ = run(state, buf, steps,
                       torch.Generator(device=dev).manual_seed(3))
        torch.cuda.synchronize()
        assert COUNTS == {k: v * steps for k, v in per_step.items()}
        states[route] = state
    (graph,) = system.graphs.entries().values()
    assert graph.replays == steps - 1
    a, b = states["eager"], states["graphed"]
    assert a.step == b.step == int(b.step_t) == steps
    for (_, p, _), (_, q, _) in zip(param_leaves(a.params),
                                    param_leaves(b.params)):
        assert torch.equal(p, q)
        for key in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(a.optimizer.state[p][key],
                               b.optimizer.state[q][key])

    views = LLFFDownXViews.spiral(52.0, hw, 2, 3)
    renders = {}
    for route in ("eager", "graphed"):
        system = create_model(opt, device=dev)
        if route == "eager":
            system.graphs = None
        renders[route] = list(system.render_eval_many(b.params, views,
                                                      range(3)))
    (graph,) = system.graphs.entries().values()
    assert graph.replays == 2
    for x, y in zip(renders["eager"], renders["graphed"]):
        for k in x:
            assert np.array_equal(x[k], y[k]), k


def test_steady_chunk_spans_replays_and_no_capture(dev):
    """The port's spans around a graphed training chunk: the first chunk
    (the eager step and the capture, then replays) records one
    ``nerfsr.graph.capture``, whose seconds are the graph's
    ``capture_s``; a steady chunk under ``torch.profiler`` records no
    capture and exactly one ``nerfsr.graph.replay`` a step inside one
    ``nerfsr.train.chunk``, as ``Captured.replays`` counts; the spans
    add no device interval of their own."""
    from torch.profiler import ProfilerActivity, profile

    from nerfsr_torch import spans
    from nerfsr_torch.models import create_model

    opt, buf = _llff_x2_buffer(dev, (64, 48))
    system = create_model(opt, device=dev)
    state = system.create_state(seed=0, steps_per_epoch=4)
    gen = torch.Generator(device=dev).manual_seed(3)
    with spans.recording() as first:
        state, _ = system.train_steps_scan(state, buf, 3, gen)
    (graph,) = system.graphs.entries().values()
    assert first["nerfsr.graph.capture"]["count"] == 1
    assert first["nerfsr.graph.replay"]["count"] == graph.replays == 2
    assert graph.capture_s == first["nerfsr.graph.capture"]["seconds"] > 0
    n, replays = 5, graph.replays
    spans.reset()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        state, _ = system.train_steps_scan(state, buf, n, gen)
        torch.cuda.synchronize()
    got = spans.totals()
    spans.reset()
    assert "nerfsr.graph.capture" not in got
    assert got["nerfsr.train.chunk"]["count"] == 1
    assert got["nerfsr.graph.replay"]["count"] == n
    assert got["nerfsr.graph.replay"]["parent"] == "nerfsr.train.chunk"
    assert graph.replays - replays == n
    cuda = torch.autograd.DeviceType.CUDA
    assert not [e.name for e in prof.events() if e.device_type == cuda
                and not getattr(e, "is_user_annotation", False)
                and e.name.startswith("nerfsr.")]


# kernel F's cases: (C, F, identity, log scale) of the fine points
# (deg_pos 10), the directions (deg_dir 4), the proposal rounds (deg_prop
# 6), --no_xyz and --no_logscale
POSENC_CASES = [(3, 10, True, True), (3, 4, True, True), (3, 6, True, True),
                (3, 10, False, True), (3, 4, True, False)]


def _posenc_input(n, c, seed, dev):
    """Rows of coordinates in [-2, 2], with a few of every kind the
    range reduction treats apart: zeros of both signs, subnormals, and
    values whose top frequencies' angles pass 105,615 (sinf's slow
    path)."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.rand((n, c), generator=gen) * 4.0 - 2.0
    special = torch.tensor([0.0, -0.0, 1e-40, -3e-39, 1e-30, 700.0, -1234.5,
                            3.0e4, 1.5, -1.5, 2.0 ** -20, 255.75])
    flat = x.view(-1)
    k = min(flat.numel(), special.numel())
    flat[:k] = special[:k]
    return x.to(dev)


@pytest.mark.parametrize("repeat", [1, 16, 64])
@pytest.mark.parametrize("n", [1, 127, 4096, 65537])
@pytest.mark.parametrize("case", POSENC_CASES,
                         ids=["pos", "dir", "prop", "no_identity", "linear"])
def test_posenc_kernel_is_the_chain_bit_for_bit(dev, case, n, repeat):
    """Kernel F against ``core/encoding.py``'s chain on the card, to the
    bit: one launch a call, with ``repeat`` the chain of the repeated
    rows."""
    c, nf, ident, log = case
    x = _posenc_input(n, c, 1000 * nf + n, dev)
    reset_counts()
    got = kposenc.positional_encoding(x, nf, ident, log, repeat=repeat)
    torch.cuda.synchronize()
    assert COUNTS["posenc"] == 1
    rows = kposenc.repeat_rows(x, repeat) if repeat > 1 else x
    want = encoding.positional_encoding(rows, nf, ident, log)
    assert got.shape == want.shape
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("repeat", [1, 3])
@pytest.mark.parametrize("n", [1, 4097])
@pytest.mark.parametrize("case", [(2, 8, True, True), (5, 3, False, False),
                                  (3, 0, True, True)],
                         ids=["c2_f8", "c5_f3", "identity_only"])
def test_posenc_kernel_generic_route(dev, case, n, repeat):
    """Kernel F outside the three encodings it unrolls: channels and
    frequencies read at run time, and no frequencies (the identity
    alone), bit for bit the chain."""
    c, nf, ident, log = case
    x = _posenc_input(n, c, 7 * n + c, dev)
    got = kposenc.positional_encoding(x, nf, ident, log, repeat=repeat)
    rows = kposenc.repeat_rows(x, repeat) if repeat > 1 else x
    want = encoding.positional_encoding(rows, nf, ident, log)
    torch.cuda.synchronize()
    assert got.shape == want.shape
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("case", [(3, 64, True), (3, 0, False)],
                         ids=["tile_over_48k", "no_channels"])
def test_posenc_kernel_rejects_what_it_cannot_write(dev, case):
    """An encoding whose tile of output rows passes 48 KB of shared memory
    (387 channels out) and one with no channels at all raise, with no
    launch counted."""
    c, nf, ident = case
    x = _posenc_input(64, c, 3, dev)
    reset_counts()
    with pytest.raises(RuntimeError, match="posenc"):
        kposenc.positional_encoding(x, nf, ident)
    assert COUNTS["posenc"] == 0


def test_posenc_kernel_takes_strided_rows_and_leading_dims(dev):
    """A column slice of wider rows (the kernel reads its row stride) and
    (N, S, 3) points (the proposal rounds) give the chain's bits; a CUDA
    tensor that needs a gradient, and one in f64, raise."""
    wide = _posenc_input(3000, 11, 5, dev)
    x = wide[:, 4:7]
    assert x.stride() == (11, 1)
    reset_counts()
    assert torch.equal(kposenc.positional_encoding(x, 10),
                       encoding.positional_encoding(x, 10))
    pts = _posenc_input(4096 * 48, 3, 6, dev).reshape(4096, 48, 3)
    got = kposenc.positional_encoding(pts, 6)
    assert got.shape == (4096, 48, 39)
    assert torch.equal(got, encoding.positional_encoding(pts, 6))
    assert COUNTS["posenc"] == 2
    with pytest.raises(ValueError, match="gradient"):
        kposenc.positional_encoding(x.clone().requires_grad_(), 4)
    with pytest.raises(TypeError, match="float32"):
        kposenc.positional_encoding(x.double(), 4)
    assert COUNTS["posenc"] == 2


@pytest.mark.parametrize("log", [True, False])
def test_posenc_kernel_in_a_captured_graph(dev, log):
    """F captured in a CUDA graph: each replay on new inputs equals the
    eager kernel, bit for bit. The capture is made with the frequency
    table uncached (computed inside the graph, and left out of the
    cache, whose tensors live outside any graph's pool)."""
    x = _posenc_input(4096, 3, 7, dev)
    static = x.clone()
    eager = kposenc.positional_encoding(static, 4, log_scale=log,
                                        repeat=16)
    kposenc._FREQS.clear()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    reset_counts()
    with torch.cuda.stream(stream):
        with torch.cuda.graph(graph, stream=stream):
            out = kposenc.positional_encoding(static, 4, log_scale=log,
                                              repeat=16)
    torch.cuda.current_stream().wait_stream(stream)
    assert COUNTS["posenc"] == 1 and not kposenc._FREQS
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)
    for seed in (8, 9):
        static.copy_(_posenc_input(4096, 3, seed, dev))
        graph.replay()
        want = kposenc.positional_encoding(static, 4, log_scale=log,
                                           repeat=16)
        torch.cuda.synchronize()
        assert torch.equal(out, want)
        assert torch.equal(want, encoding.positional_encoding(
            kposenc.repeat_rows(static, 16), 4, log_scale=log))


def _chain_encoding(x, num_freqs, include_identity=True, log_scale=True,
                    repeat=1):
    """Kernel F's wrapper with the kernel taken out: the chain."""
    if repeat > 1:
        x = kposenc.repeat_rows(x, repeat)
    return encoding.positional_encoding(x, num_freqs, include_identity,
                                        log_scale)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_nerf_mlp_same_with_kernel_f_and_the_chain(dev, dtype,
                                                         monkeypatch):
    """Kernel C fed by F (directions by ``repeat``) and by the chain
    (directions copied to every sample) gives the same bits."""
    gen = torch.Generator().manual_seed(11)
    net = VanillaMLP().reset_parameters("kaiming", 0.02, gen).to(dev)
    n, s = 2048, 16
    pts = (torch.rand((n * s, 3), generator=gen) * 2 - 1).to(dev)
    dirs = torch.nn.functional.normalize(
        torch.randn((n, 3), generator=gen), dim=-1).to(dev)
    flat = kmlp.flatten_params(net)
    with torch.no_grad():
        reset_counts()
        got = kmlp.fused_nerf_mlp(flat, pts, dirs, dtype, repeat=s)
        assert COUNTS["posenc"] == 2
        monkeypatch.setattr(kposenc, "positional_encoding", _chain_encoding)
        want = kmlp.fused_nerf_mlp(flat, pts, dirs, dtype, repeat=s)
        assert COUNTS["posenc"] == 2
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("precision", ["mixed", "f32"])
def test_render_rays_fast_same_with_kernel_f_and_the_chain(dev, precision,
                                                          monkeypatch):
    """NeRF-SR x2's fast render (two proposal rounds, the fine level on
    kernels A, B and C) of a chunk of 4096 rays: every output the same
    bits with F and with the chain; F launched 4 times."""
    import numpy as np

    from nerfsr_torch.config import default_options
    from nerfsr_torch.core.rays import get_rays, make_rays, ndc_rays
    from nerfsr_torch.data.views import LLFFDownXViews
    from nerfsr_torch.models import create_model

    wh = (128, 96)
    opt = default_options("test", model="nerf_downX",
                          dataset_mode="llff_downX", fast_preset="llff",
                          img_wh=wh, downscale=2, precision=precision)
    system = create_model(opt, device=dev)
    assert system.render_cfg.fast_sampling and \
        system.render_cfg.use_fused_mlp
    params = system.init_params(seed=0)
    views = LLFFDownXViews.spiral(100.0, wh, 2, 1)
    spec = views.eval_raygen_spec(0)
    d = torch.from_numpy(views.eval_dirs()[:4096]).to(dev)
    c2w = torch.from_numpy(np.asarray(spec["c2w"], np.float32)).to(dev)
    _, hh, ww, focal, near, far = spec["geom"]
    ro, rd = ndc_rays(hh, ww, focal, 1.0, *get_rays(d, c2w))
    rays = make_rays(ro, rd, near, far, rd)
    with torch.no_grad():
        reset_counts()
        got = system.render(params, rays, randomized=False)
        assert COUNTS["posenc"] == 4
        monkeypatch.setattr(kposenc, "positional_encoding", _chain_encoding)
        want = system.render(params, rays, randomized=False)
    torch.cuda.synchronize()
    assert COUNTS["posenc"] == 4
    assert got.keys() == want.keys()
    for k in got:
        assert torch.equal(got[k], want[k]), k

