"""The training cells that stood before the shared chunk flow
(``drivers/chunks.py``) print the same compared numbers through it, and
the references' ``f32`` and ``fp8`` readings stand as they were, bit for
bit on the CPU: ``readings_before_the_seam.json`` holds every number the
parent tree's drivers and ``control.readings`` gave at the test's size
(``conftest.shrink``), as ``repr`` of each float."""

import json
from pathlib import Path

import pytest
import torch

from nerfbench import control, spec
from nerfbench.tests.conftest import shrink

CPU = torch.device("cpu")
BEFORE = json.loads((Path(__file__).parent
                     / "readings_before_the_seam.json").read_text())


@pytest.mark.parametrize("name", sorted(BEFORE["numbers"]))
def test_the_flow_gives_the_same_numbers(name):
    cell = shrink(spec.Cell(name))
    res = cell.driver().run(cell, BEFORE["seed_run"], 0.3, False, CPU)
    assert {k: repr(v) for k, v, _ in res.checks} == BEFORE["numbers"][name]
    assert sorted(res.ctx) == BEFORE["ctx"][name]
    assert list(res.end_to_end) == ["train_rays_per_s"]
    assert res.attempted % cell.traffic["chunk_steps"] == 0


@pytest.mark.parametrize("name", sorted(BEFORE["control"]))
def test_the_control_readings_stand(name):
    cell = shrink(spec.Cell(name))
    got = control.readings(cell, BEFORE["seed_control"], CPU)
    assert {r: {k: repr(v) for k, v in vals.items()}
            for r, vals in got.items()} == BEFORE["control"][name]
