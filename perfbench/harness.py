"""One run of one cell.

1. Set-up: the study of the cell's traffic makes its inputs from the
   seed, then runs one warm-up pass at the cell's lanes and a short T
   (``warm_T``), which loads the program's kernels (built into ``build/``
   on a checkout's first run) and touches every shape the window uses.
   ``setup_s`` runs from the process's start to here.
2. The window: passes back to back, pass ``p`` on its own sim seed, until
   ``seconds`` have passed; the pass running then is finished and
   counted.  With ``trace`` the window runs under ``torch.profiler``
   (device activity only) and every per-layer metric's ``instrument``,
   and lasts at most ``TRACE_WINDOW_S``: the profiler's processing after
   the window grows with the device activities it recorded (about 60 us
   each, hundreds an interval), and a traced run has to end within its
   time.
3. Once the window has closed: the device's memory peak is read; then
   the reference replays a sample of each pass's lanes, drawn from the
   seed, and the readings are held to the traffic's limits.
4. Last, with every metric and reference module loaded: no module of JAX
   or of the JAX package may be in the process, else the run prints no
   result.  The last line of standard output is the result; the numbers
   compared and their limits are also the last lines of standard error.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import sys
import time

import torch

from perfbench import cells, compare, devtrace

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
TRACE_WINDOW_S = 20.0


@dataclasses.dataclass
class Record:
    """What a window left for the metrics to read."""

    cell: cells.Cell
    setup_s: float = 0.0
    #: one dict a pass: p, t0, t1 (host clock), lanes, T
    passes: list = dataclasses.field(default_factory=list)
    #: device events of the traced window, ``devtrace.events_of``
    events: list | None = None
    #: readings the metrics' ``instrument`` hooks leave
    extra: dict = dataclasses.field(default_factory=dict)

    @property
    def window_s(self) -> float:
        return self.passes[-1]["t1"] - self.passes[0]["t0"]

    @property
    def intervals(self) -> int:
        return sum(p["T"] for p in self.passes)

    @property
    def lane_intervals(self) -> int:
        return sum(p["lanes"] * p["T"] for p in self.passes)


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def forbidden_modules(forbidden=FORBIDDEN) -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(forbidden))


def run(name: str, seed: int, seconds: float, trace: bool, t_start: float,
        device="cuda", shrink: dict | None = None, bench: dict | None = None,
        out=None, err=None, forbidden: tuple = FORBIDDEN) -> int:
    """Run cell ``name`` and print its result; -> the exit code.  A run
    whose process holds a module of ``forbidden`` when its result is due
    prints no result (a test in a process that loaded them for
    other tests passes ``()``)."""
    out = out or sys.stdout
    err = err or sys.stderr
    bench = bench if bench is not None else cells.benchmark()
    cell = cells.cell(name, seed, bench, device=device, shrink=shrink)
    on_card = torch.device(device).type == "cuda"
    if on_card and (not torch.cuda.is_available()
                    or torch.cuda.device_count() < cell.chips):
        print(f"cell {name} needs {cell.chips} CUDA device(s); "
              f"available: {torch.cuda.device_count()}", file=err)
        return 2
    s0 = time.time()
    study = cells.load("studies", cell.traffic["study"]).Study(cell)
    _sync(device)
    s1 = time.time()
    study.warm()
    _sync(device)
    rec = Record(cell=cell)
    rec.setup_s = time.time() - t_start
    print(f"set-up: {s0 - t_start:.2f} s to the study, inputs "
          f"{s1 - s0:.2f} s, warm-up pass {time.time() - s1:.2f} s", file=err)

    layer = [cells.load("metrics", m["name"])
             for m in cells.metrics_of(bench, name, True)] if trace else []
    if trace:
        seconds = min(seconds, TRACE_WINDOW_S)
    results = []
    pre_peak = torch.cuda.max_memory_allocated() if on_card else 0
    with contextlib.ExitStack() as stack:
        prof = None
        if trace and on_card:
            from torch.profiler import ProfilerActivity, profile
            prof = stack.enter_context(
                profile(activities=[ProfilerActivity.CUDA]))
        for mod in layer:
            if hasattr(mod, "instrument"):
                stack.enter_context(mod.instrument(rec))
        w0 = time.time()
        p = 0
        while True:
            t0 = time.time()
            results.append(study.run(p))
            _sync(device)
            t1 = time.time()
            rec.passes.append(dict(p=p, t0=t0, t1=t1, lanes=study.lanes,
                                   T=study.T))
            p += 1
            if t1 - w0 >= seconds:
                break
    if prof is not None:
        rec.events = devtrace.events_of(prof)
        del prof
    peak = max(pre_peak, torch.cuda.max_memory_allocated()) if on_card else 0

    metrics = {}
    for m in cells.metrics_of(bench, name, trace):
        value = cells.load("metrics", m["name"]).read(rec)
        if value is not None:
            metrics[m["name"]] = dict(value=value, unit=m["unit"])

    failed = sum(len(set(study.expected(r["p"])) - set(res))
                 for r, res in zip(rec.passes, results))
    got = {(r["p"], key): v for r, res in zip(rec.passes, results)
           for key, v in res.items()}
    del results
    if on_card:
        torch.cuda.empty_cache()
    c0 = time.time()
    samples = [(r["p"], i) for r in rec.passes
               for i in compare.sample(seed, r["p"], study.lanes,
                                       study.check_lanes)]
    read = compare.readings(got, study.reference(samples))
    limits = cell.traffic["limits"]
    checks = {nm: dict(value=read[nm], limit=limits[nm]) for nm in limits}
    correct = all(c["value"] <= c["limit"] for c in checks.values())

    dev = dict(platform="gpu" if on_card else "cpu",
               kind=torch.cuda.get_device_name(0) if on_card else "cpu",
               count=cell.chips, memory_peak_bytes=int(peak))
    line = dict(correct=correct, attempted=sum(r["lanes"] for r in rec.passes),
                failed=failed, metrics=metrics, device=dev)
    if trace and rec.events is not None:
        dev["busy_s"] = devtrace.busy_ns(rec.events) / 1e9
        dev["window_s"] = rec.window_s
        line["breakdown"] = dict(device_ops=devtrace.top_ops(rec.events),
                                 idle_gaps=devtrace.idle_gaps(rec.events))
    line["checks"] = checks
    print(f"set-up {rec.setup_s:.2f} s, window {rec.window_s:.2f} s, "
          f"reference {time.time() - c0:.2f} s; passes {len(rec.passes)}, "
          f"lanes checked {read['lanes_checked']} of {line['attempted']}",
          file=err)
    print("pass seconds: " + " ".join(f"{r['t1'] - r['t0']:.3f}"
                                      for r in rec.passes), file=err)
    for nm, c in checks.items():
        print(f"{nm} {c['value']} limit {c['limit']}", file=err)
    bad = forbidden_modules(forbidden)
    if bad:
        print(f"modules of JAX or of the JAX package loaded: {bad}", file=err)
        return 3
    err.flush()
    print(json.dumps(line), file=out)
    out.flush()
    return 0
