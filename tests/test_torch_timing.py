"""What the kernel-timing tools compute on the host: the compiler-report
reader that holds kernels A, B and D to no local memory, the inputs and
byte counts behind the bounds ``chip_smoke.py`` reports, and the build
digest that decides when the kernel library is rebuilt. No card needed.
"""

import shutil

import pytest
import torch
import torch_threads  # noqa: F401  (torch's threads in a test worker)

from nerfsr_torch.kernels import _lib
from nerfsr_torch.timing import (composite_bwd_bytes, composite_bwd_inputs,
                                 composite_fwd_bytes, composite_inputs,
                                 invert_cdf_bins_read, invert_cdf_bytes,
                                 invert_cdf_inputs, lane_grid, ptxas_report)

PTXAS_LOG = """== invert_cdf.cu
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_117invert_cdf_kernelEPKfS1_S1_Pfiii' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_117invert_cdf_kernelEPKfS1_S1_Pfiii
    512 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 31 registers, used 0 barriers, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_112empty_kernelEv' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_112empty_kernelEv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 4 registers, used 0 barriers, 352 bytes cmem[0]
== composite.cu
ptxas info    : Function properties for _ZN12_GLOBAL__N_120composite_fwd_kernelILb1ELb0EEEvPKfS2_S2_PfS3_S3_S3_iiii
    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 46 registers, used 0 barriers
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_120composite_bwd_kernelILb0ELb1EEEvPKfS2_S2_S2_S2_S2_S2_PfS3_S3_iiii' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_120composite_bwd_kernelILb0ELb1EEEvPKfS2_S2_S2_S2_S2_S2_PfS3_S3_iiii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 52 registers, used 0 barriers, 424 bytes cmem[0]
"""


def test_ptxas_report_reads_each_kernel():
    rep = ptxas_report(PTXAS_LOG, ("invert_cdf_kernel",
                                   "composite_fwd_kernel",
                                   "composite_bwd_kernel"))
    assert len(rep) == 3                        # the empty kernel left out
    by_kernel = {("A" if "invert_cdf" in k else
                  "B" if "composite_fwd" in k else "D"): v
                 for k, v in rep.items()}
    assert by_kernel == {
        "A": {"stack": 512, "spill_stores": 0, "spill_loads": 0,
              "registers": 31},
        "B": {"stack": 0, "spill_stores": 8, "spill_loads": 4,
              "registers": 46},
        "D": {"stack": 0, "spill_stores": 0, "spill_loads": 0,
              "registers": 52}}


def test_timing_inputs_and_bytes():
    """The inputs chip_smoke.py and the timing tool hold and time kernels
    A and B on, and the bytes their bounds count: every input read once,
    every output written once."""
    gen = torch.Generator().manual_seed(0)
    n, b, q = 16, 47, 24
    bins, w, u = invert_cdf_inputs(n, b, q, gen, torch.device("cpu"))
    assert bins.shape == (n, b) and w.shape == (n, b - 1)
    assert u.shape == (n, q) and u.is_contiguous()
    assert (bins.diff(dim=-1) >= 0).all()
    assert (w[0] == 0).all() and (w[1, :2] == 100).all()
    assert invert_cdf_bytes(n, b, q) == 4 * (bins.numel() + w.numel()
                                             + 2 * u.numel())
    s = 16
    rgb, sigma, z = composite_inputs(n, s, gen, torch.device("cpu"))
    assert rgb.shape == (n, s, 3) and sigma.shape == z.shape == (n, s)
    outputs = n * 3 + n + n + n * s             # comp, depth, opacity, w
    assert composite_fwd_bytes(n, s) == 4 * (rgb.numel() + sigma.numel()
                                             + z.numel() + outputs)


def test_invert_cdf_bins_read():
    """The bins the wide route's bound counts: per ray the distinct bins
    its queries land in (below and above the plain version's search), all
    of them when the queries cover every bin, at most 2 Q."""
    gen = torch.Generator().manual_seed(1)
    n, b, q = 8, 1024, 24
    bins, w, u = invert_cdf_inputs(n, b, q, gen, torch.device("cpu"))
    read = invert_cdf_bins_read(bins, w, u)
    assert n < read <= n * 2 * q
    assert invert_cdf_bytes(n, b, q, read) == 4 * (
        w.numel() + 2 * u.numel() + read)
    # two bins, every query between them: both read, every ray
    bins2 = torch.tensor([[0.0, 1.0]]).repeat(n, 1)
    w2 = torch.ones((n, 1))
    u2 = torch.full((n, q), 0.5)
    assert invert_cdf_bins_read(bins2, w2, u2) == 2 * n
    # one query a ray below every entry: bins[0] alone
    assert invert_cdf_bins_read(bins, w, torch.full((n, 1), -1.0)) == n


def test_tune_variants_set_the_constants():
    """Every variant ``python -m nerfsr_torch.tune_invert_cdf`` builds
    names constants of ``csrc/invert_cdf.cu`` and sets exactly those; a
    name that is not there is refused."""
    from nerfsr_torch import tune_invert_cdf as tune
    src = (_lib.CSRC / "invert_cdf.cu").read_text()
    assert tune.variant_source(src, tune.VARIANTS["source"]) == src
    for values in tune.VARIANTS.values():
        out = tune.variant_source(src, values)
        changed = [(a, b) for a, b in zip(src.splitlines(),
                                          out.splitlines()) if a != b]
        assert len(out.splitlines()) == len(src.splitlines())
        assert len(changed) == len(values)
        for name, value in values.items():
            assert f"constexpr int {name} = {value};" in out
    with pytest.raises(ValueError, match="kNoSuch"):
        tune.variant_source(src, {"kNoSuch": 1})


def test_composite_bwd_inputs_bytes_and_grid():
    """Kernel D's inputs (every cotangent nonzero), the bytes its bound
    counts (4N(11S + 5)) and the grid its launch floor is timed at (8
    warps a block, a segment of S lanes rounded up to a power of two, at
    most 32, a ray)."""
    gen = torch.Generator().manual_seed(0)
    n = 16
    for s in (1, 16, 33, 64, 128):
        args = composite_bwd_inputs(n, s, gen, torch.device("cpu"))
        assert [tuple(a.shape) for a in args] == [
            (n, s, 3), (n, s), (n, s), (n, 3), (n,), (n,), (n, s)]
        assert all((a != 0).all() for a in args[3:])
        outputs = n * s * 3 + n * s + n * s      # grgb, gsigma, gz
        assert composite_bwd_bytes(n, s) == 4 * (
            sum(a.numel() for a in args) + outputs)
    assert composite_bwd_bytes(2048, 16) == 4 * 2048 * (11 * 16 + 5)
    assert [lane_grid(2048, s) for s in (1, 2, 16, 33, 64, 128)] == [
        8, 16, 128, 256, 256, 256]
    assert lane_grid(4097, 16) == 257


def test_build_digest_follows_sources_and_headers(tmp_path):
    """The library's name hashes the sources it is built from and every
    header beside them, so an edit to either rebuilds it; another tree's
    kernels (the timing tool's other checkout) get their own digest."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_lib.CSRC, csrc)
    pair = ("invert_cdf.cu", "composite.cu")
    base = _lib._digest(csrc, pair)
    assert base == _lib._digest(_lib.CSRC, pair)
    assert base != _lib._digest(csrc, _lib.SOURCES)
    (csrc / "common.cuh").write_text((csrc / "common.cuh").read_text()
                                     + "\n// edited\n")
    assert _lib._digest(csrc, pair) != base
