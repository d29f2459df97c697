"""The benchmark's own arithmetic and bookkeeping, on the CPU: the rate
over passes, the least work of the interval functions, the device-trace
readings, finding cells and metrics by name (and adding a cell from files
alone), and that nothing the benchmark runs loads JAX or the JAX
package."""
import io
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from perfbench import cells, devtrace, harness, work

ROOT = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TINY = {"n": 256, "k": 32, "T": 24, "warm_T": 4, "budget": 2, "lanes": 4,
        "check_lanes": 1 << 30}


def _record(passes):
    cell = cells.Cell("c", {}, {}, 1, 0, device="cpu")
    rec = harness.Record(cell=cell, setup_s=3.5)
    rec.passes = [dict(p=i, t0=t0, t1=t1, lanes=lanes, T=T)
                  for i, (t0, t1, lanes, T) in enumerate(passes)]
    return rec


def test_rate_counts_every_pass_over_the_whole_window():
    rec = _record([(10.0, 12.0, 216, 256), (12.0, 14.5, 216, 256),
                   (14.5, 16.0, 216, 128)])
    rate = cells.load("metrics", "lane_intervals_per_s").read(rec)
    assert rate == pytest.approx(216 * (256 + 256 + 128) / 6.0)
    assert rec.intervals == 640
    assert cells.load("metrics", "setup_s").read(rec) == 3.5


def test_least_work_of_the_interval_functions():
    B, n = 3, 64
    row = torch.zeros(B, n)
    by, ops = work.ewma_update(row, row, row, torch.zeros(B, 4))
    assert (by, ops) == (24 * B * n + 16 * B, 9 * B * n)
    shared = torch.zeros(1, n).expand(B, n)
    assert work.topk_mask(shared, 5) == (4 * n + B * n, B * n)
    tier = torch.zeros(B, n, dtype=torch.int32)
    plan = torch.zeros(B, 12, dtype=torch.int32)
    caps = torch.zeros(B, 2, dtype=torch.int32)
    by, _ = work.tier_migrate(tier, plan, plan, caps)
    assert by == 8 * B * n + 4 * B * 24 + 4 * B * 2 + B * 24 + 8 * B
    lat = torch.zeros(B, 2)
    mig = torch.zeros(B, 1)
    oracle = torch.zeros(B, n, dtype=torch.bool)
    by, ops = work.interval_account(lat, lat, lat, torch.zeros(B), shared,
                                    tier, mig, mig, oracle, 5)
    assert by == 4 * n + 4 * B * n + B * n + 4 * B * 7 + 8 * B + 24 * B
    assert work.least_s(3.35e12, 0) == pytest.approx(1.0)
    assert work.least_s(0, 67e12) == pytest.approx(1.0)


def test_device_trace_readings():
    ev = [("a", 0, 10), ("void ns::b<int>(int)", 5, 20), ("a", 30, 40),
          ("Memcpy DtoH (Device -> Pageable)", 45, 50), ("a", 60, 70)]
    assert devtrace.busy_ns(ev) == 20 + 10 + 5 + 10
    gaps = dict(devtrace.idle_gaps(ev))
    assert sum(gaps.values()) == pytest.approx((10 + 5 + 10) / 1e9)
    assert gaps["after a / before Memcpy DtoH (Device -> Pageable)"] \
        == pytest.approx(5e-9)
    assert devtrace.kernel_base("void ns::b<int>(int)") == "b"
    assert devtrace.top_ops(ev, 1) == [["a", 30 / 1e9]]
    port = cells.load("metrics", "torch_ops_ms_per_interval").PORT_KERNELS
    for fn, kernels in work.FUNCTIONS.values():
        assert set(kernels) <= port


def test_device_time_metrics_split_the_kernels():
    """PyTorch's own kernels are those outside the frozen list of the
    program's; all device time keeps both, and copies, in view."""
    rec = _record([(0.0, 1.0, 4, 10)])
    rec.events = [("void at::native::f<float>(float)", 0, 4_000_000),
                  ("void topk_mask_kernel<256>(float*)", 4_000_000,
                   5_000_000),
                  ("Memcpy DtoH (Device -> Pageable)", 6_000_000, 8_000_000)]
    torch_ms = cells.load("metrics", "torch_ops_ms_per_interval.tune")
    assert torch_ms.read(rec) == pytest.approx(0.4)
    all_ms = cells.load("metrics", "device_ms_per_interval.seeds")
    assert all_ms.read(rec) == pytest.approx(0.7)


def test_benchmark_entries_are_found_by_name():
    bench = cells.benchmark()
    for cfg in bench["configs"]:
        assert NAME.match(cfg["name"]) and (ROOT / cfg["file"]).is_file()
        assert json.loads((ROOT / cfg["file"]).read_text())["name"] \
            == cfg["name"]
    for w in bench["workloads"]:
        assert NAME.match(w["name"]) and len(w["why"]) <= 200
        cell = cells.cell(w["name"], 1, bench)
        study = cells.load("studies", cell.traffic["study"])
        assert hasattr(study, "Study")
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert hasattr(cells.load("metrics", m["name"]), "read")
    for w in bench["workloads"]:
        e2e = {m["name"] for m in cells.metrics_of(bench, w["name"], False)}
        layer = cells.metrics_of(bench, w["name"], True)
        assert "setup_s" in e2e and len(e2e) >= 2 and layer
        assert all(m["moves"] in e2e for m in layer)
        assert len(layer) == len(bench["per_layer"]) // 2


def test_a_cell_is_added_by_files_alone(tmp_path, monkeypatch):
    """A new traffic file and a BENCHMARK entry make a new cell; no file of
    the benchmark is edited."""
    base = tmp_path / "perfbench"
    for sub in ("configs", "workloads", "studies", "metrics", "traffic"):
        shutil.copytree(ROOT / "perfbench" / sub, base / sub)
    traffic = json.loads((base / "workloads" / "hemem-tune.json").read_text())
    traffic.update(budget=3, defaults={"hot_threshold": 4,
                                       "cooling_threshold": 9,
                                       "migration_period": 2,
                                       "sample_period": 5000})
    (base / "workloads" / "hemem-tune-small.json").write_text(
        json.dumps(traffic))
    bench = cells.benchmark()
    bench["workloads"].append(dict(name="hemem-small.nine",
                                   config="pmem-large.nine",
                                   traffic="hemem-tune-small", chips=1,
                                   why="test"))
    rate = next(m for m in bench["end_to_end"]
                if m["name"] == "lane_intervals_per_s.tune")
    rate["workloads"].append("hemem-small.nine")
    monkeypatch.setattr(cells, "HERE", base)
    out, err = io.StringIO(), io.StringIO()
    rc = harness.run("hemem-small.nine", 5, 0.0, False, 0.0, device="cpu",
                     shrink=dict(TINY, budget=3), bench=bench, out=out,
                     err=err, forbidden=())
    line = json.loads(out.getvalue().splitlines()[-1])
    assert rc == 0 and line["correct"] and line["attempted"] == 27
    assert set(line["metrics"]) == {"lane_intervals_per_s.tune", "setup_s"}


_PROBE = """
import sys, io, time
sys.path[:0] = [{root!r}, {src!r}]
from perfbench import cells, control, harness
from perfbench.reference import arms, grid, hemem, replay, workloads
names = [m["name"] for m in cells.benchmark()["per_layer"]]
for nm in names:
    cells.load("metrics", nm)
ref_only = sorted(m for m in sys.modules if m.split(".")[0] == "repro_torch")
harness.run("arms-seeds.gups", 3, 0.0, True, time.time(), device="cpu",
            shrink={tiny!r}, out=io.StringIO(), err=io.StringIO())
bad = sorted({{m.split(".")[0] for m in sys.modules}}
             & {{"jax", "jaxlib", "flax", "repro"}})
print(ref_only, bad, "repro_torch" in sys.modules)
"""


def test_nothing_the_benchmark_runs_loads_jax(tmp_path):
    """In a fresh interpreter: the harness, the reference and every metric
    load nothing of the program until a run, and a run loads neither JAX
    nor the JAX package (top-level names compared whole: the port's name
    begins with the JAX package's)."""
    code = _PROBE.format(root=str(ROOT), src=str(ROOT / "src"), tiny=TINY)
    env = {"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=ROOT, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["[]", "[]", "True"]


def test_a_run_holding_jax_prints_no_result(monkeypatch):
    """A run whose process holds a module of the JAX package once its
    window has closed exits with another code and prints no result."""
    monkeypatch.setitem(sys.modules, "repro", sys.modules["perfbench"])
    out, err = io.StringIO(), io.StringIO()
    rc = harness.run("arms-seeds.gups", 3, 0.0, False, 0.0, device="cpu",
                     shrink=TINY, out=out, err=err)
    assert rc != 0 and out.getvalue() == ""
    assert "repro" in err.getvalue()


def test_a_module_loaded_after_the_window_is_caught(tmp_path, monkeypatch):
    """A metric module that loads a forbidden module when it reads, after
    the window and the reference, still keeps the result from print."""
    base = tmp_path / "perfbench"
    for sub in ("configs", "workloads", "studies", "metrics", "traffic"):
        shutil.copytree(ROOT / "perfbench" / sub, base / sub)
    (base / "metrics" / "loads_jax.py").write_text(
        "import sys, types\n\n\n"
        "def read(rec):\n"
        "    sys.modules['fake_jax_probe'] = types.ModuleType('fake')\n"
        "    return 1.0\n")
    bench = cells.benchmark()
    bench["end_to_end"].append(dict(name="loads_jax", unit="s",
                                    better="lower", bound=0.25,
                                    source="host_clock"))
    monkeypatch.setattr(cells, "HERE", base)
    out, err = io.StringIO(), io.StringIO()
    try:
        rc = harness.run("arms-seeds.gups", 3, 0.0, False, 0.0,
                         device="cpu", shrink=TINY, bench=bench, out=out,
                         err=err, forbidden=("fake_jax_probe",))
    finally:
        sys.modules.pop("fake_jax_probe", None)
    assert rc != 0 and out.getvalue() == ""
    assert "fake_jax_probe" in err.getvalue()
