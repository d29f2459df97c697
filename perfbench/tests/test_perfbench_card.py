"""On the card (``-m cuda``; skipped without one): each cell at a reduced
size through the whole harness, the CUDA kernels against the reference
on the card, a traced run's readings, and the control failing there too.

    python -m pytest -q -m cuda perfbench/tests/test_perfbench_card.py
"""
import io
import json

import pytest

from perfbench import cells, control, harness

SMALL = {"n": 4096, "k": 512, "T": 64, "warm_T": 4, "budget": 4,
         "lanes": 32, "check_lanes": 1 << 30}
CELLS = ("hemem-tune.nine", "arms-grid.nine", "arms-seeds.gups")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(card, cell):
    out, err = io.StringIO(), io.StringIO()
    rc = harness.run(cell, 2 ** 31 + 3, 0.0, True, 0.0, device=card,
                     shrink=SMALL, out=out, err=err)
    assert rc == 0, err.getvalue()
    line = json.loads(out.getvalue().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
    assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
    roof = [v["value"] for k, v in line["metrics"].items()
            if k.startswith("interval_kernels_roofline.")]
    assert roof and all(0 < v <= 105 for v in roof)
    r = control.readings(cell, 2 ** 31 + 5, card, SMALL)
    limits = cells.cell(cell, 1).traffic["limits"]
    assert any(r["control"][nm] > lim for nm, lim in limits.items())
