"""On the card (``cuda``; skipped elsewhere): each cell at its own size
through a short window, correct, and its control failing its limits."""

import pytest

from nerfbench import control, run, spec

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_cell_on_the_card(name, card):
    cell = spec.Cell(name)
    line = run.run_cell(cell, 2 ** 31 + 901, 1.0, False, card)
    assert line["correct"], line["checks"]
    for reading, got in control.readings(cell, 2 ** 31 + 902,
                                         card).items():
        assert any(got[k] > v for k, v in cell.limits.items()
                   if k in got), (reading, got)
