"""The cell that follows the first four, ``x4_blender_fast.train``. It
resolves from its own files and entries appended to BENCHMARK.json, and
every file the first four cells read holds the bytes it held when their
limits were set, or the bytes of the change that last kept their
numbers (the shared chunk flow, the bf16 control: a test holds their
numbers and readings, ``test_nerfbench_seam.py``). The Blender
reference takes the rays and the LR truth the system's Blender loader
takes, and sees the white background (its agreement with the system,
and the faults that break it, are ``test_nerfbench_reference.py``'s,
over every cell). The two new readers on made-up traces, and kernel A's
least bytes against the system's own count."""

import hashlib
import json

import numpy as np
import pytest
import torch

from nerfbench import arith_sampling, scene360, spec, trace
from nerfbench.drivers import arch_of, program_options
from nerfbench.drivers import train_blender
from nerfbench.reference import blender as bref

CPU = torch.device("cpu")
BLENDER = "x4_blender_fast.train"
LATER = ["x2_llff.train_f32", "refine_unet.train"]
FIRST = ["x2_llff_fast.train", "x2_llff.train", "x2_llff_fast.render",
         "x2_llff.test"]
TRAIN_METRICS = {"step_mfu_pct.train", "mlp_bwd_roofline_pct.train",
                 "device_idle_pct.train", "dispatch_host_ms.train",
                 "invert_cdf_roofline_pct.train", "prop_mlp_share_pct.train"}

# sha256 (first 16 hex digits) of every file the first four cells read,
# as they stood when the cells' bounds and limits were set, or as the
# change that kept their numbers left them
READ_BY_FIRST = {
    "run.py": "d76064c3068e22d3",
    "spec.py": "3cd63af27135ddbb",
    "inputs.py": "98a310a53ee19354",
    "arith.py": "25b3b8cec527f515",
    "trace.py": "626ba3fb77181f24",
    "png.py": "05b3897ba0309375",
    "drivers/__init__.py": "fb971ba149f091dd",
    "drivers/train.py": "bd4896534b35b411",
    "drivers/chunks.py": "54fe0649f4748e4a",
    "drivers/render.py": "6ec6e8a23016bb54",
    "drivers/test.py": "e3bb56cb763a5de4",
    "reference/nerf.py": "998b73401a6a36b6",
    "reference/lanczos.py": "15e6d591c742f479",
    "configs/nerfsr_x2_llff_fast.json": "5453db1963eb99cf",
    "configs/nerfsr_x2_llff.json": "c233e7af25fa8303",
    "traffic/train_chunks.json": "f5b878f92cc1fc22",
    "traffic/render_views.json": "feb83b1c56f8cf15",
    "traffic/test_train_views.json": "ca083c820555e194",
    "limits/x2_llff_fast.train.json": "a545b19b9e607115",
    "limits/x2_llff.train.json": "30c59a5c2507736d",
    "limits/x2_llff_fast.render.json": "9e081dc2c18e5464",
    "limits/x2_llff.test.json": "6c84f60cf14afb41",
    "metrics/device_idle_pct.render.py": "fa78740114b3c15b",
    "metrics/device_idle_pct.test.py": "c511fcad3687c175",
    "metrics/device_idle_pct.train.py": "21ce2490a73e6604",
    "metrics/dispatch_host_ms.train.py": "aacc1f40f498be79",
    "metrics/eval_host_ms.render.py": "534075121095973a",
    "metrics/mlp_bwd_roofline_pct.train.py": "caa1d32ac0ee0df7",
    "metrics/mlp_fwd_roofline_pct.render.py": "68f665d1cbdd8426",
    "metrics/render_mfu_pct.render.py": "c1bfa909089b3694",
    "metrics/step_mfu_pct.train.py": "2dd8178131a545bf",
    "metrics/test_data_share_pct.test.py": "a0e0c05acb725b79",
    "metrics/test_encode_share_pct.test.py": "81320e494532686c",
    "metrics/test_setup_share_pct.test.py": "0c2517ce53aa6de0",
    "metrics/test_write_share_pct.test.py": "f17f008d99cfcb95",
    "metrics/test_writer_wait_share_pct.test.py": "257f9ea14cebe952",
}
BOUNDS = {"train_rays_per_s": 0.12, "render_image_ms": 0.15,
          "render_image_ms_p95": 0.15, "test_image_ms": 0.25,
          "setup_s": 0.25}


def test_added_cell_resolves():
    cell = spec.Cell(BLENDER)
    assert cell.chips == 1
    assert [m["name"] for m in cell.end_to_end] == ["train_rays_per_s",
                                                    "setup_s"]
    assert {m["name"] for m in cell.per_layer} == TRAIN_METRICS
    assert set(cell.limits) == {"grad_diff_body", "change_gap"}
    assert cell.traffic["chunk_steps"] == cell.config["options"][
        "scan_steps"] == 100
    assert cell.config["reduced"] == []
    assert cell.driver().run


def test_blender_options_are_the_scripts():
    config = spec.Cell(BLENDER).config
    opt = program_options(config, "train", "cpu")
    assert opt.dataset_mode == "blender_downX" and opt.white_bkgd
    assert (opt.img_wh, opt.downscale, opt.batch_size) == ([400, 400], 4,
                                                           128)
    assert (opt.n_prop, opt.n_prop2, opt.N_importance) == (96, 48, 48)
    assert (opt.prop_W, opt.prop_D, opt.noise_std) == (64, 4, 0.0)
    assert opt.prop_pad == 0.01 and opt.prop_pad_anneal == 0
    assert scene360.camera_angle_x(400, config["focal"]) == pytest.approx(
        0.6911112070083618, abs=1e-12)


def _short_sha(path):
    return hashlib.sha256(path.read_bytes()).hexdigest()[:16]


def test_the_first_four_cells_read_unedited_files():
    pkg = spec.ROOT / "nerfbench"
    got = {rel: _short_sha(pkg / rel) for rel in READ_BY_FIRST}
    assert got == READ_BY_FIRST
    for name in FIRST:
        cell = spec.Cell(name)
        for m in cell.end_to_end:
            assert m["bound"] == BOUNDS[m["name"]], m
    fast = {m["name"] for m in spec.Cell("x2_llff_fast.train").per_layer}
    assert fast == TRAIN_METRICS


def _blender_cell(views=4, hw=(32, 32)):
    cell = spec.Cell(BLENDER)
    cell.config.update(img_wh=list(hw)[::-1], batch_size=8, D=2, W=32,
                       n_prop=8, n_prop2=6, N_importance=8, prop_W=16,
                       prop_D=2, focal=40.0)
    cell.traffic["views"] = views
    cell.traffic["scene"]["samples"] = 32
    return cell


def test_blender_rows_are_the_loaders(tmp_path):
    """The reference's rays, bounds and LR truth for every row equal the
    buffer the system's Blender loader builds from the written scene."""
    from nerfsr_torch.data import create_dataset

    cell = _blender_cell(hw=(24, 32))
    config = cell.config
    c2ws, rgba, _ = train_blender.scene_inputs(cell, 3, CPU)
    scene360.write_scene(str(tmp_path), c2ws, rgba, config["focal"])
    opt = program_options(config, "train", "cpu", dataset_root=str(tmp_path))
    buf = create_dataset(opt, "train").ray_buffer()
    data = bref.TrainData(c2ws, rgba, config["focal"], config["downscale"],
                          config["near"], config["far"], CPU)
    o, d, near, far, lr = data.rows(torch.arange(len(data)))
    assert len(data) == len(buf["rgbs"])

    def flat(k):
        return torch.from_numpy(buf[k].reshape(-1, buf[k].shape[-1]))
    assert torch.equal(o, flat("origins"))
    assert torch.allclose(d, flat("directions"), rtol=0, atol=1e-6)
    assert torch.equal(near, flat("near")) and torch.equal(far, flat("far"))
    assert torch.allclose(lr, torch.from_numpy(buf["rgbs"]), rtol=0,
                          atol=1e-6)
    assert 0.05 < float((rgba[..., 3] == 0).mean()) < 0.95


def test_lr_truth_is_pils():
    Image = pytest.importorskip("PIL.Image")
    rng = np.random.default_rng(4)
    rgba = rng.integers(0, 256, (40, 48, 4), np.uint8)
    rgba[:10, :, 3] = 0
    rgba[10:20, :, 3] = 255
    small = np.asarray(Image.fromarray(rgba, "RGBA").resize(
        (12, 10), Image.LANCZOS)).astype(np.float32) / 255.0
    want = small[..., :3] * small[..., 3:] + (1.0 - small[..., 3:])
    assert np.array_equal(bref.lr_truth(rgba, 4), want)


def test_the_white_background_is_compared(monkeypatch):
    """A reference that composites over black in place of white fails the
    cell's limits: the weights leave space empty, so rays end short of
    full opacity and the white term moves the loss and its gradients."""
    cell = _blender_cell()
    arch = arch_of(cell.config)
    c2ws, rgba, wts = train_blender.scene_inputs(cell, 11, CPU)
    args = (wts, c2ws, rgba, arch, cell.config, 11, 10, 3, CPU)
    high = train_blender.reference_steps(*args)
    render = bref.render

    def over_black(*a, **k):
        rgb, out = render(*a, **k)
        return rgb - (1.0 - out["w"].sum(-1, keepdim=True)), out
    monkeypatch.setattr(bref, "render", over_black)
    low = train_blender.reference_steps(*args)
    got = train_blender.numbers(wts, *low, *high)
    assert any(got[k] > v for k, v in cell.limits.items()), got


def _trace(kernels, units=10):
    """A made-up reduced trace: {kernel name: device seconds}, end to
    end in the window."""
    device, t = [], 0.0
    for name, s in kernels.items():
        device.append((name, t, t + s * 1e6))
        t += s * 1e6
    return trace.Trace(device, [], (0.0, t), units)


def _ctx(name, tr):
    arch = arch_of(spec.Cell(name).config)
    return {"kind": "train", "arch": arch, "rays_per_unit": 2048,
            "trace": tr}


def test_invert_cdf_roofline_reads_every_route():
    m = spec.metric("invert_cdf_roofline_pct.train")
    tr = _trace({"(anonymous namespace)::invert_cdf_wide_kernel<1>(float "
                 "const*, float const*, float const*, float*, int, int, "
                 "int)": 60e-6,
                 "(anonymous namespace)::invert_cdf_kernel(float const*)":
                 20e-6,
                 "(anonymous namespace)::invert_cdf_stream_kernel<8>()":
                 20e-6,
                 "(anonymous namespace)::fused_mlp_fwd_tc_kernel()": 1e-3})
    ctx = _ctx("x2_llff_fast.train", tr)
    least = 4 * 2048 * ((46 + 48 + 47) + (22 + 32 + 23)) / 3.35e12
    assert m.read(ctx) == pytest.approx(100 * least / 10e-6)
    assert m.read(_ctx("x2_llff.train", tr)) is None
    assert m.read(dict(ctx, kind="render")) is None
    assert m.read(dict(ctx, trace=_trace({"other": 1e-3}))) is None
    assert m.read(dict(ctx, trace=None)) is None


def test_prop_mlp_share_reads_the_library_products():
    m = spec.metric("prop_mlp_share_pct.train")
    tr = _trace({"sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n": 2e-3,
                 "nvjet_tst_64x8_64x16_4x1_v_bz_TNT": 1e-3,
                 "void cutlass::Kernel2<cutlass_80_tensorop_bf16>(T1::Params)":
                 0.5e-3,
                 "void splitKreduce_kernel<32, 16, int, float>()": 0.5e-3,
                 "(anonymous namespace)::mlp_bwd_tile_tc_kernel()": 4e-3,
                 "void at::native::elementwise_kernel<128, 2>()": 2e-3})
    ctx = _ctx(BLENDER, tr)
    assert m.read(ctx) == pytest.approx(40.0)
    assert m.read(_ctx("x2_llff.train", tr)) is None
    assert m.read(dict(ctx, trace=_trace({"fused_mlp_fwd_tc_kernel":
                                          1e-3}))) is None
    assert m.read(dict(ctx, kind="test")) is None


@pytest.mark.parametrize("name,calls", [
    ("x2_llff_fast.train", [(47, 24), (23, 16)]),
    (BLENDER, [(95, 48), (47, 48)])])
def test_invert_cdf_bytes_at_most_the_systems(name, calls):
    """Kernel A's least bytes a call: the system's own count with min(B,
    2 Q) bins read a ray, and at most its count of every bin."""
    from nerfsr_torch.timing import invert_cdf_bytes

    arch = arch_of(spec.Cell(name).config)
    assert arith_sampling.invert_cdf_calls(arch) == calls
    n = 2048
    for b, q in calls:
        least = arith_sampling.invert_cdf_least_bytes(n, b, q)
        assert least == invert_cdf_bytes(n, b, q,
                                         bins_read=n * min(b, 2 * q))
        assert least <= invert_cdf_bytes(n, b, q)
    assert arith_sampling.invert_cdf_least_s(arch, n) == pytest.approx(
        sum(arith_sampling.invert_cdf_least_bytes(n, b, q)
            for b, q in calls) / 3.35e12)


def test_benchmark_entries_stay_in_the_contract():
    bench = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
    names = [w["name"] for w in bench["workloads"]]
    assert names[:4] == FIRST and names[4:] == [BLENDER] + LATER
    assert sum(w["chips"] == 4 for w in bench["workloads"]) == 0
    for w in bench["workloads"]:
        assert len(w["why"]) <= 200
    per_layer = {m["name"]: m for m in bench["per_layer"]}
    for name in ("invert_cdf_roofline_pct.train", "prop_mlp_share_pct.train"):
        assert per_layer[name]["workloads"] == ["x2_llff_fast.train",
                                                BLENDER]
        mod = spec.metric(name)
        assert isinstance(mod.PATTERNS, tuple) and mod.PATTERNS
