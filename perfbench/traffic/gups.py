"""GUPS-like access trace (HeMem's GUPS benchmark, SOSP 2021): uniform
accesses within a hot set of ``hot_frac * n`` pages carrying
``hot_weight`` of the ``work`` accesses of an interval, the rest uniform
over the other pages; the hot set moves to fresh pages every
``shift_every`` intervals.

``make`` draws it on ``device`` from ``seed`` with one ``torch.Generator``
there (a hot set is the head of a ``randperm``); the probabilities are
worked out in f64 and the counts rounded once to f32.  Returns f32
``[T, n]``.
"""
from __future__ import annotations

import torch


def make(params: dict, T: int, n: int, seed: int, device) -> torch.Tensor:
    hot_frac = float(params.get("hot_frac", 0.125))
    hot_weight = float(params.get("hot_weight", 0.9))
    every = int(params.get("shift_every", 150))
    work = float(params.get("work", 2.0e7))
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    kh = max(1, int(round(n * hot_frac)))
    trace = torch.empty((T, n), dtype=torch.float32, device=device)
    cold = (1.0 - hot_weight) / max(n - kh, 1)
    for t0 in range(0, T, every):
        probs = torch.full((n,), cold, dtype=torch.float64, device=device)
        hot = torch.randperm(n, generator=gen, device=device)[:kh]
        probs[hot] = hot_weight / kh
        trace[t0:t0 + every] = (work * probs).float()
    return trace
