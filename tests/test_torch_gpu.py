"""The port's CUDA kernels (A-E) against their plain PyTorch versions on
the card. Every test here needs an NVIDIA GPU and skips without one; the
file imports no JAX, so it also runs where only PyTorch is installed:

    python -m pytest tests/test_torch_gpu.py -q

Tolerances as in ``chip_smoke.py``, which holds the same kernels at the
serving path's full shapes.
"""

import pytest
import torch

from nerfsr_torch.core.rendering import volumetric_rendering as plain_comp
from nerfsr_torch.core.sampling import _invert_cdf, stratified_uniforms
from nerfsr_torch.kernels import LAUNCHES_PER_CALL
from nerfsr_torch.kernels import COUNTS, reset_counts
from nerfsr_torch.kernels import composite as kcomposite
from nerfsr_torch.kernels import mlp as kmlp
from nerfsr_torch.kernels import sampling as ksampling
from nerfsr_torch.models.mlp import VanillaMLP

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def test_invert_cdf_kernel(dev):
    gen = torch.Generator().manual_seed(0)
    z = torch.sort(torch.rand((300, 48), generator=gen), -1)[0]
    bins = (0.5 * (z[:, :-1] + z[:, 1:])).to(dev)
    w = torch.rand((300, 46), generator=gen).to(dev)
    u = stratified_uniforms(bins, 24, False).contiguous()
    reset_counts()
    got = ksampling.invert_cdf(bins, w, u)
    torch.cuda.synchronize()
    assert COUNTS["invert_cdf"] == 1
    # CDF rounding over the local density (see chip_smoke.py)
    torch.testing.assert_close(got, _invert_cdf(bins, w, u), rtol=0,
                               atol=1e-4)
    with pytest.raises(ValueError, match="contiguous"):
        ksampling.invert_cdf(bins, w, u.t().contiguous().t())


@pytest.mark.parametrize("act", ["relu", "softplus"])
@pytest.mark.parametrize("white", [False, True])
def test_composite_kernel(dev, act, white):
    gen = torch.Generator().manual_seed(1)
    rgb = torch.rand((300, 16, 3), generator=gen).to(dev)
    sigma = (torch.randn((300, 16), generator=gen) * 2).to(dev)
    z = torch.sort(torch.rand((300, 16), generator=gen), -1)[0].to(dev)
    got = kcomposite.volumetric_rendering(rgb, sigma, z, white, act)
    ref = plain_comp(rgb, sigma, z, white, act)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, rtol=2e-4, atol=1e-5)


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
def test_composite_bwd_kernel(dev, act, white):
    """Kernel D against its plain version, with every cotangent nonzero,
    and through the autograd Function (B forward, D backward)."""
    gen = torch.Generator().manual_seed(3)
    n, s = 300, 16
    rgb = torch.rand((n, s, 3), generator=gen).to(dev)
    sigma = (torch.randn((n, s), generator=gen) * 2).to(dev)
    z = torch.sort(torch.rand((n, s), generator=gen), -1)[0].to(dev)
    gc = torch.randn((n, 3), generator=gen).to(dev)
    gd, go = (torch.randn((n,), generator=gen).to(dev) for _ in range(2))
    gw = torch.randn((n, s), generator=gen).to(dev)
    reset_counts()
    got = kcomposite.composite_bwd(rgb, sigma, z, gc, gd, go, gw, white, act)
    torch.cuda.synchronize()
    assert COUNTS["composite_bwd"] == 1
    ref = kcomposite.composite_bwd_plain(rgb, sigma, z, gc, gd, go, gw,
                                         white, act)
    for g, r in zip(got, ref):
        # serial vs scanned products and suffix sums (as chip_smoke.py)
        torch.testing.assert_close(g, r, rtol=1e-3, atol=1e-4)
    sig = sigma.clone().requires_grad_(True)
    out = kcomposite.volumetric_rendering(rgb, sig, z, white, act)
    (out[0] * gc).sum().backward()
    assert COUNTS["composite_fwd"] == 1 and COUNTS["composite_bwd"] == 2
    zeros = torch.zeros_like(gd)
    ref_s = kcomposite.composite_bwd_plain(rgb, sigma, z, gc, zeros, zeros,
                                           torch.zeros_like(gw), white,
                                           act)[1]
    torch.testing.assert_close(sig.grad, ref_s, rtol=1e-3, atol=1e-4)


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
