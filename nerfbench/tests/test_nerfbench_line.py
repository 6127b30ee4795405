"""The result line has exactly the contract's keys, with the compared
numbers last; a run with no card fails by name and prints no line."""

import subprocess
import sys

import pytest
import torch

from nerfbench import run, spec
from nerfbench.tests.conftest import shrink

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("trace", [False, True])
def test_line_keys(trace):
    cell = shrink(spec.Cell("x2_llff_fast.render"))
    line = run.run_cell(cell, 5, 0.5, trace, torch.device("cpu"))
    want = KEYS + (["breakdown"] if trace else []) + ["checks"]
    assert list(line) == want
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"} | (
        {"busy_s", "window_s"} if trace else set())
    names = {m["name"] for m in (cell.per_layer if trace
                                 else cell.end_to_end)}
    assert set(line["metrics"]) <= names
    if not trace:
        assert set(line["metrics"]) == names
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}
    if trace:
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert all(len(v) <= 10 for v in line["breakdown"].values())


def test_no_card_fails_by_name():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, "-m", "nerfbench.run", "--workload",
         "x2_llff_fast.train", "--seed", "3000000000", "--seconds", "1",
         "--trace", "0"], cwd=spec.ROOT, capture_output=True, text=True,
        timeout=300)
    assert out.returncode != 0
    assert out.stdout == ""
    assert "x2_llff_fast.train needs 1 CUDA card" in out.stderr


def test_refuses_outside_a_checkout(tmp_path):
    """A directory with only BENCHMARK.json and nerfbench/ has no system
    to run: the run fails and prints no line."""
    import shutil
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.ROOT / "nerfbench", tmp_path / "nerfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "-m", "nerfbench.run", "--workload",
         "x2_llff_fast.train", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
        timeout=300)
    assert out.returncode != 0 and out.stdout == ""
