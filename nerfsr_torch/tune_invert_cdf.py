"""Kernel A's cut-overs on the card: variants of the constants of
``csrc/invert_cdf.cu`` (warps a ray by bin count, where streaming starts,
the chunk, queries searched side by side, loads in flight), each built
into a library of its own, all timed in one process at the wide route's
shapes beside the plain version.

    python -m nerfsr_torch.tune_invert_cdf [--out FILE]

Each variant compiles in its own ``nvcc`` process, all started together
(~1 min), into ``nerfsr_torch/_build/``. For every shape it prints each
variant's device ms a call (``timing.time_ms``; the source as it stands
twice, first and last, for the spread), the route and warps a ray its
launcher takes, the largest difference from the plain version and
whether two calls gave the same bits, and each variant's compiler
figures (registers, stack, spills). It writes the same as one JSON
object to FILE when given. Needs a CUDA card and ``nvcc``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from nerfsr_torch.kernels import _lib
from nerfsr_torch.kernels.sampling import ROUTES

# name -> {constant of invert_cdf.cu: value}; "source" is the file as is
VARIANTS = {
    "source": {},
    "one_warp_to_512": {"kOneWarpBins": 512},
    "one_warp_to_2048": {"kOneWarpBins": 2048},
    "stream_from_8193": {"kEightWarpBins": 8192},
    "stream_from_32769": {"kEightWarpBins": 32768},
    "chunk_1024": {"kChunk": 1024},
    "chunk_4096": {"kChunk": 4096},
    "queries_1": {"kQU": 1},
    "queries_4": {"kQU": 4},
    "loads_4": {"kLoadU": 4},
    "loads_16": {"kLoadU": 16},
}
SHAPES = ((2048, 255, 192), (2048, 191, 16), (4096, 129, 24),
          (4096, 1024, 24), (4096, 2048, 24), (4096, 4097, 24),
          (4096, 16384, 24), (4096, 30000, 24), (1024, 100000, 24))
KERNELS = ("invert_cdf_kernel", "invert_cdf_wide_kernel",
           "invert_cdf_stream_kernel")


def variant_source(source: str, values: dict) -> str:
    """``source`` with each ``constexpr int NAME = V;`` of ``values`` set
    to its value; raises if a name is not there exactly once."""
    for name, value in values.items():
        pattern = rf"(constexpr int {name} = )\d+;"
        if len(re.findall(pattern, source)) != 1:
            raise ValueError(f"{name}: not one constant of that name")
        source = re.sub(pattern, rf"\g<1>{value};", source)
    return source


def build_variants(variants=VARIANTS):
    """{name: (library, compiler log)}, every variant built at once."""
    _lib.BUILD.mkdir(parents=True, exist_ok=True)
    root = Path(tempfile.mkdtemp(prefix="tune_", dir=_lib.BUILD))
    source = (_lib.CSRC / "invert_cdf.cu").read_text()
    header = (_lib.CSRC / "common.cuh").read_text()
    dirs = {}
    for name, values in variants.items():
        d = root / name
        d.mkdir()
        (d / "invert_cdf.cu").write_text(variant_source(source, values))
        (d / "common.cuh").write_text(header)
        dirs[name] = d

    def one(name):
        so = _lib.build(dirs[name], ("invert_cdf.cu",), f"tune_{name}")
        lib = _lib.bind(ctypes.CDLL(str(so)),
                        ("nerfsr_invert_cdf", "nerfsr_invert_cdf_route"))
        return name, (lib, _lib.build_log(so))
    with ThreadPoolExecutor(len(dirs)) as pool:
        return dict(pool.map(one, dirs))


def _plan(lib, n, b):
    out = (ctypes.c_int * 6)()
    _lib.check(lib.nerfsr_invert_cdf_route(n, b, out), "invert_cdf_route")
    return ROUTES[out[0]], out[4]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write the JSON result here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("nerfsr_torch.tune_invert_cdf needs a CUDA card")
    from nerfsr_torch.core.sampling import _invert_cdf
    from nerfsr_torch.timing import (invert_cdf_bins_read, invert_cdf_bytes,
                                     invert_cdf_inputs, ptxas_report,
                                     time_ms)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(card, flush=True)
    libs = build_variants()
    registers = {name: ptxas_report(log, KERNELS)
                 for name, (_, log) in libs.items()}
    for name, report in registers.items():
        for kernel, fig in report.items():
            print(f"[registers] {name} {kernel}: {fig}")
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(17)
    stream = torch.cuda.current_stream
    rows = []
    for n, b, q in SHAPES:
        bins, w, u = invert_cdf_inputs(n, b, q, gen, dev)
        ref = _invert_cdf(bins, w, u)
        row = {"n": n, "b": b, "q": q, "variants": {},
               "plain_ms": time_ms(lambda: _invert_cdf(bins, w, u)),
               "bound_ms": invert_cdf_bytes(
                   n, b, q, invert_cdf_bins_read(bins, w, u))
               / 3.35e12 * 1e3}
        for name in (*libs, "source"):
            lib = libs[name][0]

            def call():
                z = torch.empty_like(u)
                _lib.check(lib.nerfsr_invert_cdf(
                    bins.data_ptr(), w.data_ptr(), u.data_ptr(),
                    z.data_ptr(), n, b, q, stream().cuda_stream), name)
                return z
            got, again = call(), call()
            route, wpr = _plan(lib, n, b)
            entry = row["variants"].setdefault(name, {"ms": []})
            entry["ms"].append(time_ms(call))
            entry.update(route=route, warps_per_ray=wpr,
                         max_abs_err=float((got - ref).abs().max()),
                         same_bits=bool(torch.equal(got, again)))
        rows.append(row)
        print(f"N={n} B={b} Q={q}: plain {row['plain_ms']:.4f} ms, bound "
              f"{row['bound_ms']:.5f}", flush=True)
        for name, e in sorted(row["variants"].items(),
                              key=lambda kv: min(kv[1]["ms"])):
            print(f"    {name:22s} {' / '.join(f'{x:.4f}' for x in e['ms'])}"
                  f" ms ({e['route']}, {e['warps_per_ray']} warps a ray); "
                  f"max abs err {e['max_abs_err']:.2e}, same bits "
                  f"{e['same_bits']}", flush=True)
        del bins, w, u, ref
        torch.cuda.empty_cache()
    print(card)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "registers": registers, "rows": rows},
                      f)


if __name__ == "__main__":
    main()
