"""The refine cell, ``refine_unet.train``, on the CPU at a test's size
(``conftest.shrink``; the U-Net step also at 8 features, 3 downs, 8x8
patches):
the reference's augmented views and patch cut against the system's
loader and device sampler, the reference U-Net step against the
system's eager step, the frozen arithmetic against a count by hand, and
the new readers on made-up traces."""

import numpy as np
import pytest
import torch

from nerfbench import arith_refine, arith_tf32, refine_inputs, spec, trace
from nerfbench.drivers import chunk_seed, train_refine
from nerfbench.reference import refine as rref
from nerfbench.tests.conftest import shrink

CPU = torch.device("cpu")
REFINE = "refine_unet.train"
SEED = 2 ** 31 + 41


def _loaded(seed=SEED, **sizes):
    cell = shrink(spec.Cell(REFINE))
    cell.config.update(sizes)
    arch = train_refine.arch_of(cell.config)
    c2ws, imgs, sr = refine_inputs.views(cell, seed, CPU)
    opt, system, buffers, spe = train_refine.load_buffers(
        cell, seed, c2ws, imgs, sr, CPU)
    views = rref.Views(imgs[arch["ref_idx"]], sr, arch,
                       train_refine.system_seed(seed))
    return cell, arch, system, buffers, views


def test_the_views_are_the_loaders():
    """Every augmented view and its valid box, worked out by the
    reference, equal the stacks the system's loader uploads."""
    _, arch, _, buffers, views = _loaded()
    assert buffers["sr_imgs"].shape[0] == views.n == arch["aug_num"]
    for a in range(views.n):
        gt, sr, box = views[a]
        assert tuple(buffers["bboxes"][a].tolist()) == box
        for got, want in ((buffers["gt_imgs"][a], gt),
                          (buffers["sr_imgs"][a], sr)):
            assert torch.allclose(got, torch.from_numpy(want), rtol=0,
                                  atol=1e-6)
    assert 0 < box[0] or 0 < box[1]


def test_the_patches_are_the_samplers():
    """The batch the reference cuts from a step's draw equals the one the
    system's device sampler cuts from the same generator."""
    _, arch, system, buffers, views = _loaded()
    k = arch["num_ref_patches"]
    for step in range(3):
        gen = torch.Generator().manual_seed(chunk_seed(SEED, step))
        got = system.sample_patch_batch(buffers, gen)
        gen = torch.Generator().manual_seed(chunk_seed(SEED, step))
        u = torch.rand((arch["batch_size"], 4 + 2 * k), dtype=torch.float64,
                       generator=gen).numpy()
        sr, refs, gt = rref.patches(views, u, arch)
        for name, want in (("sr_patch", sr), ("ref_patches", refs),
                           ("gt_patch", gt)):
            assert torch.allclose(got[name], torch.from_numpy(want),
                                  rtol=0, atol=1e-6), name


@pytest.mark.parametrize("sizes", [
    {"num_downs": 3, "patch_len": 8, "batch_size": 4}, {}])
def test_the_unet_step_is_the_systems(sizes):
    """The reference U-Net's loss, every leaf's gradient, the running
    statistics and the state after 3 Adam steps equal the system's eager
    steps from the same leaves, on the same batches."""
    cell, arch, system, buffers, _ = _loaded(**sizes)
    wts, stats = refine_inputs.weights(SEED, arch, CPU)
    state = system.create_state(seed=0, steps_per_epoch=1000)
    train_refine.load_state(state.net, wts, stats)
    r_wts = {k: v.clone() for k, v in wts.items()}
    r_stats = {k: v.clone() for k, v in stats.items()}
    opt = rref.Adam(r_wts, arch["lr"], b1=arch["beta1"])
    k = arch["num_ref_patches"]
    for step in range(3):
        batch = system.sample_patch_batch(
            buffers, torch.Generator().manual_seed(step))
        state, losses = system.train_step(state, batch)
        grads = {n: p.grad for n, p in state.net.named_parameters()}

        leaves = {n: v.detach().requires_grad_(True)
                  for n, v in r_wts.items()}
        x = torch.cat([batch["sr_patch"]]
                      + [batch["ref_patches"][:, j] for j in range(k)], -1)
        out, r_stats = rref.unet(leaves, r_stats, x.permute(0, 3, 1, 2),
                                 arch, "f32")
        loss = torch.mean(torch.abs(out.permute(0, 2, 3, 1)
                                    - batch["gt_patch"]))
        r_grads = dict(zip(leaves, torch.autograd.grad(
            loss, list(leaves.values()))))
        opt.step(r_wts, r_grads)

        assert float(losses["tot"]) == pytest.approx(float(loss.detach()),
                                                     rel=1e-5)
        assert set(grads) == set(r_grads)
        for n, g in r_grads.items():
            scale = float(g.abs().max()) + 1e-12
            assert float((grads[n] - g).abs().max()) <= 1e-4 * scale, n
        for n, b in state.net.named_buffers():
            assert torch.allclose(b, r_stats[n], rtol=1e-5, atol=1e-6), n
    # after Adam's first steps an element whose gradient is near 0 may
    # move the other way on either side (round-off picks its sign): each
    # leaf's change is compared by its norm, as the harness's change_gap
    for n, p in state.net.named_parameters():
        moved = float((p.detach() - wts[n]).norm())
        want = float((r_wts[n] - wts[n]).norm())
        assert abs(moved - want) <= 3e-3 * want, n


@pytest.mark.parametrize("small", [False, True])
def test_the_leaves_are_the_systems(small):
    """The benchmark's leaves and statistics are the system's U-Net's,
    name for name and shape for shape."""
    from nerfsr_torch.models import create_model

    cell = spec.Cell(REFINE)
    if small:
        cell = shrink(cell)
    arch = train_refine.arch_of(cell.config)
    wts, stats = refine_inputs.weights(3, arch, CPU)
    net = create_model(train_refine.options(cell.config, "cpu"),
                       device="cpu").build_net(0)
    got = {k: tuple(v.shape) for k, v in net.state_dict().items()}
    assert got == {k: tuple(v.shape) for k, v in {**wts, **stats}.items()}


# the U-Net at the configuration's widths, counted by hand: a down's
# output pixels x in x out x 16, an up's input pixels x in x out x 16
HAND_MACS = {
    "down_0": 32 * 32 * 27 * 64 * 16, "down_1": 16 * 16 * 64 * 128 * 16,
    "down_2": 8 * 8 * 128 * 256 * 16, "down_3": 4 * 4 * 256 * 512 * 16,
    "down_4": 2 * 2 * 512 * 512 * 16, "down_5": 1 * 1 * 512 * 512 * 16,
    "up_0": 1 * 1 * 512 * 512 * 16, "up_1": 2 * 2 * 1024 * 512 * 16,
    "up_2": 4 * 4 * 1024 * 256 * 16, "up_3": 8 * 8 * 512 * 128 * 16,
    "up_4": 16 * 16 * 256 * 64 * 16, "up_5": 32 * 32 * 128 * 3 * 16}


def test_macs_equal_the_count_by_hand():
    arch = train_refine.arch_of(spec.Cell(REFINE).config)
    assert [n for n, *_ in arith_refine.layers(arch)] == list(HAND_MACS)
    total = sum(HAND_MACS.values())
    assert total == 395_313_152
    assert arith_refine.forward_macs_per_patch(arch) == total
    assert arith_refine.train_flops_per_patch(arch) == 2.0 * (
        3 * total - HAND_MACS["down_0"])


def test_macs_equal_the_systems_shapes():
    """The multiply-adds of each convolution, from the shapes of the
    system's own U-Net at the test's size run on one patch."""
    from nerfsr_torch.models import create_model

    cell = shrink(spec.Cell(REFINE))
    arch = train_refine.arch_of(cell.config)
    net = create_model(train_refine.options(cell.config, "cpu"),
                       device="cpu").build_net(0)
    counted = {}

    def hook(name):
        def count(mod, inp, out):
            x = inp[0]
            grid = x if isinstance(mod, torch.nn.ConvTranspose2d) else out
            counted[name] = grid.shape[2] * grid.shape[3] * x.shape[1] \
                * out.shape[1] * mod.kernel_size[0] * mod.kernel_size[1]
        return count
    for name, mod in net.named_children():
        if isinstance(mod, (torch.nn.Conv2d, torch.nn.ConvTranspose2d)):
            mod.register_forward_hook(hook(name))
    p = arch["patch_len"]
    net(torch.zeros((1, p, p, arch["input_nc"])))
    want = {n: (s_out * s_out if n.startswith("down") else s_in * s_in)
            * cin * cout * 16
            for n, cin, s_in, cout, s_out in arith_refine.layers(arch)}
    assert counted == want
    assert sum(want.values()) == arith_refine.forward_macs_per_patch(arch)


def _trace(kernels, units=10):
    device, t = [], 0.0
    for name, s in kernels.items():
        device.append((name, t, t + s * 1e6))
        t += s * 1e6
    return trace.Trace(device, [], (0.0, t), units)


def test_the_conv_roofline_reads_the_convolutions():
    m = spec.metric("refine_conv_roofline_pct.train")
    arch = train_refine.arch_of(spec.Cell(REFINE).config)
    tr = _trace({"sm90_xmma_fprop_implicit_gemm_f32f32_tf32f32_f32_nhwckrsc"
                 "_nhwc_tilesize64x64x32_warpgroupsize1x1x1_g1_execute"
                 "_segment_k_on_kernel__5x_cudnn": 3e-3,
                 "void cudnn::detail::dgrad2d_alg1_1<float, 0, 5, 6, 4, 3, "
                 "4, false, true>(int, int, int, float const*)": 4e-3,
                 "void cudnn::engines_precompiled::nchwToNhwcKernel<float, "
                 "float, float, false, true, (cudnnKernelDataType_t)0>()":
                 3e-3,
                 "void at::native::vectorized_elementwise_kernel<4>()":
                 50e-3, "memset32": 1e-3})
    ctx = {"kind": "train_refine", "arch": arch, "patches_per_unit": 32,
           "trace": tr}
    least = arith_refine.conv_least_s(arch, 32)
    assert m.read(ctx) == pytest.approx(100 * least / 1e-3)
    assert m.read(dict(ctx, kind="train")) is None
    assert m.read(dict(ctx, trace=_trace({"elementwise": 1e-3}))) is None


def test_the_refine_readers_read_only_the_refine_cells(monkeypatch):
    arch = train_refine.arch_of(spec.Cell(REFINE).config)
    tr = _trace({"a": 1e-3}, units=100)
    ctx = {"kind": "train_refine", "arch": arch, "patches_per_unit": 32,
           "units": 300, "window_s": 3.0, "trace": tr}
    mfu = spec.metric("refine_mfu_pct.train").read(ctx)
    assert mfu == pytest.approx(100 * 3200 * arith_refine
                                .train_flops_per_patch(arch) / 989e12)
    idle = spec.metric("refine_device_idle_pct.train")
    assert idle.read(ctx) == pytest.approx(0.0, abs=1e-9)
    from nerfsr_torch import spans
    monkeypatch.setattr(spans, "totals", lambda: {
        "nerfsr.train.chunk": {"seconds": 0.5}})
    host = spec.metric("refine_dispatch_host_ms.train")
    assert host.read(ctx) == pytest.approx(5.0)
    for name in ("refine_mfu_pct.train", "refine_device_idle_pct.train",
                 "refine_dispatch_host_ms.train",
                 "refine_conv_roofline_pct.train"):
        assert spec.metric(name).read(dict(ctx, kind="train")) is None
    for name in ("step_mfu_pct.train", "device_idle_pct.train",
                 "dispatch_host_ms.train"):
        assert spec.metric(name).read(ctx) is None


F32 = "x2_llff.train_f32"
TF32_KERNELS = {
    "(anonymous namespace)::fused_mlp_fwd_tf32_kernel(float const*)": 2e-3,
    "(anonymous namespace)::mlp_bwd_tile_tf32_kernel(float const*)": 4e-3,
    "(anonymous namespace)::mlp_bwd_wgrad_tf32_kernel(float const*)": 1e-3,
    "(anonymous namespace)::mlp_bwd_reduce_tf32_kernel(float const*)":
    1e-3}
BF16_KERNELS = {"(anonymous namespace)::fused_mlp_fwd_tc_kernel()": 1e-3,
                "(anonymous namespace)::mlp_bwd_tile_tc_kernel()": 1e-3,
                "(anonymous namespace)::mlp_bwd_reduce_kernel()": 1e-3}


@pytest.mark.parametrize("name,share", [
    ("mlp_fwd_tf32_roofline_pct.train", 2e-3),
    ("mlp_bwd_tf32_roofline_pct.train", 6e-3)])
def test_the_tf32_readers(name, share):
    from nerfbench.drivers import arch_of

    m = spec.metric(name)
    arch = arch_of(spec.Cell(F32).config)
    fn = arith_tf32.mlp_fwd_least_s if "fwd" in name \
        else arith_tf32.mlp_bwd_least_s
    least = fn(arch, 2048 * 64) + fn(arch, 2048 * 128)
    ctx = {"kind": "train", "arch": arch, "rays_per_unit": 2048}
    assert m.read(dict(ctx, trace=_trace(TF32_KERNELS))) == pytest.approx(
        100 * least / (share / 10))
    assert m.read(dict(ctx, trace=_trace(BF16_KERNELS))) is None
    assert m.read(dict(ctx, trace=None)) is None
    assert m.read(dict(ctx, kind="render",
                       trace=_trace(TF32_KERNELS))) is None
    for bf16 in ("mlp_bwd_roofline_pct.train",):
        assert spec.metric(bf16).read(dict(ctx, trace=_trace(
            TF32_KERNELS))) is None


@pytest.mark.parametrize("p", [32768, 131072, 262144])
def test_tf32_bounds_equal_chip_smokes(p):
    import sys
    sys.path.insert(0, str(spec.ROOT))
    import chip_smoke
    from nerfbench.drivers import arch_of

    arch = arch_of(spec.Cell(F32).config)
    assert arith_tf32.mlp_fwd_least_s(arch, p) * 1e3 == pytest.approx(
        chip_smoke.mlp_fwd_bound(p, "tf32")[1], rel=1e-12)
    assert arith_tf32.mlp_bwd_least_s(arch, p) * 1e3 == pytest.approx(
        chip_smoke.mlp_bwd_bound(p, "tf32")[1], rel=1e-12)


def test_the_bf16_control_rounds_to_bfloat16():
    from nerfbench.reference import nerf as ref

    x = torch.tensor([1.0 + 2 ** -9, 3.0, -1.0 - 2 ** -7])
    assert ref.bf16(x).tolist() == [1.0, 3.0, -1.0 - 2 ** -7]
    w = torch.randn(4, 3, generator=torch.Generator().manual_seed(1))
    b = torch.zeros(4)
    got = ref.linear(x[None], w, b, "bf16")
    want = ref.bf16(x[None]) @ ref.bf16(w).T
    assert torch.equal(got, want)
    assert np.isfinite(got.numpy()).all()
