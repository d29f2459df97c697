"""Trace-derived workloads: capture real serving access streams, replay
them as simulator lanes, and fit WorkloadSpec knobs to them.

The port of ``repro/simulator/traces.py`` (a JAX-free module of the JAX
package; the port keeps its own copy).  Three pieces:

* ``TraceCapture`` / ``TraceWorkload`` -- accumulate per-step access
  vectors of a real run (attention mass per KV page, router load per
  expert, row touches per embedding block), grouped into policy
  intervals, into a replayable [T, n] trace.  Counts are f64 on the host
  and grouping is ``np.add.reduceat``, so a round trip conserves the
  total access count exactly.
* ``replay`` -- run the captured trace as a lane of ``experiment.sweep``'s
  trace-replay mode, under any registered policy family.
* ``fit_workload_spec`` -- a deterministic estimator mapping a captured
  stream onto WorkloadSpec knobs (hot fraction and weight from the mean
  access distribution, churn from hot-set overlap decay, duty cycle from
  busy/idle run lengths), on host numpy f64.  The fitted spec is
  fractional in n, so a trace captured over 8 KV pages scales to a
  4,096-page lane or a tuning study (``tuning.tune(workloads=[fit])``).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.simulator.workload_spec import (KIND_HOTSET, NEVER,
                                                 WorkloadSpec, _comp,
                                                 _from_comps, with_label)

__all__ = ["TraceWorkload", "TraceCapture", "capture_from_steps",
           "fit_workload_spec", "replay"]


@dataclasses.dataclass
class TraceWorkload:
    """A captured access stream: ``counts[t, p]`` accesses to page p in
    policy interval t.  f64 on host (exact-conservation contract)."""

    counts: np.ndarray
    label: str = "trace"
    meta: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        self.counts = np.asarray(self.counts, np.float64)
        if self.counts.ndim != 2:
            raise ValueError(f"trace must be [T, n], got "
                             f"{self.counts.shape}")

    @property
    def T(self) -> int:
        return self.counts.shape[0]

    @property
    def n(self) -> int:
        return self.counts.shape[1]

    def total(self) -> float:
        """Total access count (f64; the conservation invariant)."""
        return float(self.counts.sum())

    def save(self, path: str) -> None:
        np.savez(path, counts=self.counts, label=self.label)

    @classmethod
    def load(cls, path: str) -> "TraceWorkload":
        with np.load(path, allow_pickle=False) as z:
            return cls(counts=z["counts"], label=str(z["label"]))


@dataclasses.dataclass
class TraceCapture:
    """Streaming capture: ``add`` one per-step access vector at a time;
    ``finish`` groups ``group`` consecutive steps into one policy interval
    (summed — conservation is exact, f64 reduceat)."""

    n: int
    group: int = 1
    _rows: list = dataclasses.field(default_factory=list)

    def add(self, access) -> None:
        row = np.asarray(access, np.float64).reshape(-1)
        if row.shape[0] != self.n:
            raise ValueError(f"expected [{self.n}] access vector, got "
                             f"{row.shape}")
        self._rows.append(row)

    @property
    def steps(self) -> int:
        return len(self._rows)

    def finish(self, label: str = "trace", meta: dict | None = None,
               drop_partial: bool = False) -> TraceWorkload:
        if not self._rows:
            raise ValueError("empty capture")
        rows = np.stack(self._rows)                      # [steps, n] f64
        g = max(1, int(self.group))
        steps = rows.shape[0]
        if drop_partial:
            steps = (steps // g) * g
            rows = rows[:steps]
        if steps == 0:
            raise ValueError("capture shorter than one policy interval")
        counts = np.add.reduceat(rows, np.arange(0, steps, g), axis=0)
        return TraceWorkload(counts=counts, label=label,
                             meta=dict(meta or {}, steps=steps, group=g))


def capture_from_steps(steps, group: int = 1,
                       label: str = "trace") -> TraceWorkload:
    """One-shot capture of a stacked [steps, n] access array."""
    steps = np.asarray(steps, np.float64)
    cap = TraceCapture(n=steps.shape[1], group=group)
    for row in steps:
        cap.add(row)
    return cap.finish(label=label)


def replay(tw: TraceWorkload, policies, machines="pmem-large", k: int = 0,
           device=None, **kw):
    """Run the captured trace as a sweep lane (trace-replay mode): the
    workload axis collapses to this single trace.  ``device``: ``None``
    is the CUDA card."""
    from repro_torch.simulator import experiment
    k = k or max(1, tw.n // 4)
    return experiment.sweep(policies, trace=np.asarray(tw.counts,
                                                       np.float32),
                            machines=machines, k=k, device=device, **kw)


# ------------------------------------------------------------------ fitting
def _hot_stats(counts, hot_cover: float):
    """(hot_frac, hot_weight): smallest page fraction covering
    ``hot_cover`` of the mean access distribution."""
    n = counts.shape[1]
    p = counts.sum(0)
    tot = p.sum()
    if tot <= 0:
        return 1.0, 1.0
    p = np.sort(p / tot)[::-1]
    cum = np.cumsum(p)
    hot_k = int(np.argmax(cum >= hot_cover)) + 1
    return hot_k / n, float(cum[hot_k - 1])


def _churn(counts, hot_k: int):
    """Mean per-interval hot-set churn -> ``shift_every`` estimate.

    Windowed top-k sets; 1 - mean overlap between consecutive windows,
    normalized per interval.  A fully static hot set maps to NEVER."""
    T = counts.shape[0]
    W = max(1, T // 8)
    tops = []
    for s in range(0, T - W + 1, W):
        win = counts[s:s + W].sum(0)
        tops.append(set(np.argsort(-win, kind="stable")[:hot_k].tolist()))
    if len(tops) < 2:
        return NEVER
    overlaps = [len(a & b) / max(len(a), 1)
                for a, b in zip(tops[:-1], tops[1:])]
    churn_per_interval = (1.0 - float(np.mean(overlaps))) / W
    if churn_per_interval <= 1e-6:
        return NEVER
    return int(np.clip(round(1.0 / churn_per_interval), 1, NEVER))


def _duty(counts):
    """(period, duty, idle_scale) from the per-interval total series."""
    totals = counts.sum(1)
    peak = totals.max()
    if peak <= 0:
        return 1, 1.0, 1.0
    busy = totals > 0.05 * peak
    duty = float(busy.mean())
    if duty >= 1.0 - 1e-9:
        return 1, 1.0, 1.0
    # busy-run count -> period; idle_scale = idle-phase mean / busy mean
    starts = int(np.sum(busy[1:] & ~busy[:-1]) + int(busy[0]))
    period = max(2, int(round(len(totals) / max(starts, 1))))
    busy_mean = float(totals[busy].mean())
    idle_mean = float(totals[~busy].mean()) if (~busy).any() else 0.0
    return period, max(duty, 1.0 / period), \
        idle_mean / max(busy_mean, 1e-12)


def fit_workload_spec(tw: TraceWorkload, seed: int = 0,
                      hot_cover: float = 0.9) -> WorkloadSpec:
    """Fit a KIND_HOTSET WorkloadSpec to a captured trace.

    Pure function of (trace, seed) — bit-deterministic under a fixed seed
    (the CRN discipline), so fitted lanes pair exactly across sweep runs.
    """
    counts = np.asarray(tw.counts, np.float64)
    T, n = counts.shape
    hot_frac, hot_weight = _hot_stats(counts, hot_cover)
    hot_k = max(1, int(round(hot_frac * n)))
    shift_every = _churn(counts, hot_k)
    period, duty, idle_scale = _duty(counts)
    busy = counts.sum(1) > 0.05 * max(float(counts.sum(1).max()), 1e-12)
    work = float(counts.sum(1)[busy].mean()) if busy.any() \
        else float(counts.sum() / max(T, 1))
    spec = _from_comps([_comp(
        KIND_HOTSET, work=work, hot_frac=min(max(hot_frac, 1.0 / n), 1.0),
        hot_weight=min(max(hot_weight, 0.0), 1.0),
        shift_every=shift_every, period=period, duty=duty,
        idle_scale=min(max(idle_scale, 0.0), 1.0), seed=seed)])
    return with_label(spec, f"fit:{tw.label}")
