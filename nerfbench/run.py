"""Run one cell of the benchmark once and print its result line.

    python3 -m nerfbench.run --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

The cell, its configuration, traffic mix, limits and metrics are found
by name from ``BENCHMARK.json`` (``nerfbench/spec.py``); the traffic's
``kind`` picks the driver. Everything up to the window's start is
set-up (``setup_s``, from this process's start). With ``--trace 0`` the
line carries the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics, read from a traced stretch after the window. The
last line of standard output is one JSON object; the numbers compared
with the reference, each beside its limit, close standard error and the
line. A run needs the CUDA cards the cell asks for, and refuses to
report if JAX or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

from nerfbench import spec  # noqa: E402

BANNED = ("jax", "jaxlib", "flax", "nerfsr_tpu")
CACHE = spec.ROOT / ".nerfbench_cache"


def pin_caches():
    """Every compiler cache the run could fill, at fixed paths inside the
    checkout (the kernels themselves build into the system's
    ``nerfsr_torch/_build``)."""
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(CACHE / "cuda")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")


def banned_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(BANNED))


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             t_start: float = T_START) -> dict:
    """Drive the cell and build its result line (without the device's
    name, which ``main`` adds)."""
    res = cell.driver().run(cell, seed, seconds, trace, device)
    metrics = {}
    if trace:
        for m in cell.per_layer:
            v = spec.metric(m["name"], cell.root).read(res.ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        values = dict(res.end_to_end, setup_s=res.window_start - t_start)
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": float(values[m["name"]]),
                                  "unit": m["unit"]}
    line = {"correct": res.correct, "attempted": res.attempted,
            "failed": res.failed, "metrics": metrics,
            "device": {"platform": "gpu", "kind": None, "count": cell.chips,
                       "memory_peak_bytes": res.memory_peak_bytes}}
    tr = res.ctx.get("trace")
    if trace and tr is not None:
        line["device"].update(busy_s=tr.busy_s, window_s=tr.window_s)
        line["breakdown"] = tr.breakdown()
    line["checks"] = {name: {"value": v, "limit": lim}
                      for name, v, lim in res.checks if lim is not None}
    for name, v, lim in res.checks:
        if lim is None:
            print(f"[nerfbench] reading {name} {v!r} (not compared)",
                  file=sys.stderr)
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    pin_caches()
    cell = spec.Cell(args.workload)

    import torch
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell.chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"nerfbench: {cell.name} needs {cell.chips} CUDA card(s), "
              f"found {found}; it does not run on the CPU", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    line = run_cell(cell, args.seed, args.seconds, bool(args.trace), device)
    found = banned_modules()
    if found:
        print(f"nerfbench: {', '.join(found)} loaded in the measuring "
              "process", file=sys.stderr)
        return 3
    line["device"]["kind"] = torch.cuda.get_device_name(device)
    line["card"] = card()
    line["checks"] = line.pop("checks")
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
