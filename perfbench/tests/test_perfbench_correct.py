"""The comparison that decides ``correct``, at a size a test run holds
(n = 256, T <= 32, on the CPU, where the program runs the plain
versions of its kernels):

  * every cell's run, program against the reference, reads no mismatch
    and no exec-time gap;
  * the control (the reference in bfloat16, put in the program's place)
    fails a limit of every cell;
  * a run whose timed path is broken underneath comes out not correct, for
    each fault a replay on one chip can have (``faults.py``: the migration
    step returning its state unchanged, half of the lanes left out, one
    lane's answer altered where it is produced).  (No cell spans chips,
    so none can leave out an exchange.)
"""
import io
import json

import pytest

from perfbench import cells, control, faults, harness

SHRINK = {"n": 256, "k": 32, "T": 32, "warm_T": 2, "budget": 2,
          "check_lanes": 1 << 30}
#: per cell: the GUPS trace's hot set moves every 6 intervals, so that the
#: seed lanes of a run this short take different paths
CELLS = {"hemem-tune.nine": SHRINK, "arms-grid.nine": SHRINK,
         "arms-seeds.gups": dict(SHRINK, T=24, lanes=4,
                                 trace={"shift_every": 6})}


def _run(cell, seed=11):
    """One run in this process, which may hold JAX for other test files
    (``test_nothing_the_benchmark_runs_loads_jax`` checks a fresh one)."""
    out, err = io.StringIO(), io.StringIO()
    rc = harness.run(cell, seed, 0.0, False, 0.0, device="cpu",
                     shrink=CELLS[cell], out=out, err=err, forbidden=())
    assert rc == 0, err.getvalue()
    return json.loads(out.getvalue().splitlines()[-1])


@pytest.mark.parametrize("cell", list(CELLS))
def test_program_matches_the_reference(cell):
    line = _run(cell)
    assert line["correct"] and line["failed"] == 0
    assert {k: v["value"] for k, v in line["checks"].items()} == {
        "mismatched_counts": 0, "exec_time_rel_gap": 0.0}
    assert list(line)[-1] == "checks"


@pytest.mark.parametrize("cell", list(CELLS))
def test_the_control_fails(cell):
    r = control.readings(cell, 7, "cpu", CELLS[cell])
    limits = cells.cell(cell, 7).traffic["limits"]
    assert all(r["program"][nm] <= lim for nm, lim in limits.items())
    assert any(r["control"][nm] > lim for nm, lim in limits.items())


@pytest.mark.parametrize("fault", list(faults.FAULTS))
@pytest.mark.parametrize("cell", list(CELLS))
def test_a_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    faults.FAULTS[fault](monkeypatch.setattr)
    assert not _run(cell)["correct"]
