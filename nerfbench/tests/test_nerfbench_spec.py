"""BENCHMARK.json against the contract's shape, and every cell, metric
and file found by name; a new cell, mix, configuration and metric added
as files and entries alone."""

import hashlib
import json
import re
import shutil

import pytest

from nerfbench import spec

BENCH = spec.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["nerfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert not any(w.startswith("/") or ".." in w for w in BENCH["command"])


def test_names_units_and_bounds():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = [m["name"] for m in metrics] + CELLS + [
        c["name"] for c in BENCH["configs"]]
    assert len(set(names)) == len(names)
    for n in names:
        assert NAME.match(n), n
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for entry in BENCH["configs"] + BENCH["workloads"] + BENCH["per_layer"]:
        for key in ("why", "layer", "source"):
            text = entry.get(key, "x")
            assert 1 <= len(text) <= 200 and "\n" not in text \
                and "\t" not in text, (entry["name"], key)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("nerfbench/")
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
    assert len(json.dumps(BENCH)) < 64 * 1024
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert set(e2e) == {"train_rays_per_s", "train_patches_per_s",
                        "render_image_ms", "render_image_ms_p95",
                        "test_image_ms", "setup_s"}
    for m in e2e.values():
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert e2e["setup_s"]["bound"] == 0.25


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves(name):
    cell = spec.Cell(name)
    assert cell.chips == 1
    assert cell.driver().run
    reported = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in reported
        mod = spec.metric(m["name"])
        assert (mod.LAYER, mod.MOVES, mod.SOURCE, mod.UNIT, mod.BETTER) == (
            m["layer"], m["moves"], m["source"], m["unit"], m["better"])
    for key in cell.config["reduced"]:
        assert NAME.match(key)
    assert cell.limits


def _digest(root):
    return {p.relative_to(root).as_posix(): hashlib.sha256(
        p.read_bytes()).hexdigest() for p in root.rglob("*") if p.is_file()
        and "__pycache__" not in p.parts}


def test_added_by_files_alone(tmp_path):
    """A new configuration, mix, metric and cell: new files and new
    entries in BENCHMARK.json, no file of the benchmark edited."""
    pkg = tmp_path / "nerfbench"
    for d in ("configs", "traffic", "limits", "metrics", "drivers"):
        shutil.copytree(spec.ROOT / "nerfbench" / d, pkg / d,
                        ignore=shutil.ignore_patterns("__pycache__"))
    before = _digest(pkg)
    cfg = json.loads((pkg / "configs/nerfsr_x2_llff_fast.json").read_text())
    cfg["n_prop"], cfg["n_prop2"] = 256, 192
    (pkg / "configs/nerfsr_x2_llff_fast_bins256.json").write_text(
        json.dumps(cfg))
    traffic = json.loads((pkg / "traffic/train_chunks.json").read_text())
    traffic["chunk_steps"] = 40
    (pkg / "traffic/train_chunks40.json").write_text(json.dumps(traffic))
    (pkg / "limits/x2_llff_fast.train_bins256.json").write_text(
        (pkg / "limits/x2_llff_fast.train.json").read_text())
    (pkg / "metrics/prop_share_pct.train.py").write_text(
        'LAYER = "step"\nMOVES = "train_rays_per_s"\n'
        'SOURCE = "device_trace"\nUNIT = "%"\nBETTER = "lower"\n\n\n'
        "def read(ctx):\n    return None\n")
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({"name": "nerfsr_x2_llff_fast_bins256",
                             "source": "https://arxiv.org/abs/2112.01759",
                             "file": "nerfbench/configs/"
                                     "nerfsr_x2_llff_fast_bins256.json",
                             "reduced": [], "why": "wide kernel A"})
    bench["workloads"].append({"name": "x2_llff_fast.train_bins256",
                               "config": "nerfsr_x2_llff_fast_bins256",
                               "traffic": "train_chunks40", "chips": 1,
                               "why": "kernel A's wide route"})
    bench["end_to_end"][0]["workloads"].append("x2_llff_fast.train_bins256")
    bench["per_layer"].append({"name": "prop_share_pct.train", "unit": "%",
                               "better": "lower", "source": "device_trace",
                               "layer": "step", "moves": "train_rays_per_s"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = spec.Cell("x2_llff_fast.train_bins256", root=tmp_path)
    assert cell.config["n_prop"] == 256 and cell.traffic["chunk_steps"] == 40
    assert cell.kind == "train"
    names = {m["name"] for m in cell.per_layer}
    assert "prop_share_pct.train" in names
    assert spec.metric("prop_share_pct.train", tmp_path).read({}) is None
    # the old cells see the new metric too (it lists no workloads)
    old = spec.Cell("x2_llff_fast.train", root=tmp_path)
    assert "prop_share_pct.train" in {m["name"] for m in old.per_layer}
    after = _digest(pkg)
    assert {k: v for k, v in after.items() if k in before} == before
