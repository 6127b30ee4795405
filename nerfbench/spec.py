"""Everything a cell needs, found by name from ``BENCHMARK.json``.

A cell (``workloads``) names a configuration (``configs``, whose
``file`` holds it) and a traffic mix (``nerfbench/traffic/<name>.json``,
whose ``kind`` picks the driver ``nerfbench/drivers/<kind>.py``). Its
limits are ``nerfbench/limits/<cell>.json``. A per-layer metric is
``nerfbench/metrics/<name>.py``. A cell reports the end-to-end metrics
that list it under ``workloads``, or that list no ``workloads``, and the
per-layer metrics that list it, or that list none and move an
end-to-end metric it reports. So a later change adds a cell, a mix, a
configuration or a metric by adding files and entries, and edits none.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _by_name(entries, name, what):
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


class Cell:
    """One workload of ``BENCHMARK.json`` with its files loaded."""

    def __init__(self, name: str, bench: dict = None, root: Path = ROOT):
        bench = bench if bench is not None else benchmark(root)
        self.entry = _by_name(bench["workloads"], name, "workload")
        self.name = name
        self.chips = self.entry["chips"]
        cfg_entry = _by_name(bench["configs"], self.entry["config"],
                             "config")
        pkg = root / "nerfbench"
        self.root = root
        self.config = _load_json(root / cfg_entry["file"])
        self.traffic = _load_json(pkg / "traffic"
                                  / f"{self.entry['traffic']}.json")
        self.limits = _load_json(pkg / "limits" / f"{name}.json")
        self.end_to_end = [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        e2e = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in bench["per_layer"]
                          if (name in m["workloads"] if "workloads" in m
                              else m["moves"] in e2e)]

    @property
    def kind(self) -> str:
        return self.traffic["kind"]

    def driver(self):
        path = self.root / "nerfbench" / "drivers" / f"{self.kind}.py"
        if not path.exists():
            raise KeyError(f"no driver for traffic kind {self.kind!r}")
        return importlib.import_module(f"nerfbench.drivers.{self.kind}")


def metric(name: str, root: Path = ROOT):
    """The reader module of per-layer metric ``name``."""
    path = root / "nerfbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "nerfbench.metrics._" + name.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
