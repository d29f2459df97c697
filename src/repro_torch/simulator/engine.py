"""Simulation results, the wasteful-migration window and the host oracle.

The JAX package's numpy reference engine (``engine.run``) is not ported
yet; the port's scan engine reports through the same ``SimResult`` and
scores recall against the same host-computed oracle masks.
"""
from __future__ import annotations

import dataclasses

import numpy as np

WASTE_WINDOW = 20  # intervals; promote->demote (or inverse) within = wasteful


@dataclasses.dataclass
class SimResult:
    name: str
    exec_time_s: float
    promotions: int
    demotions: int
    wasteful: int
    hot_recall: float            # mean fraction of oracle top-k held fast
    fast_hit_frac: float         # fraction of accesses served by fast tier
    # [T] per-interval series; None under the scan engine's streaming
    # reduction (reduce="stream"), which folds them into the summaries
    # below instead of materializing anything [T]-shaped.
    timeline_slow_bw: np.ndarray | None = None
    timeline_fast_hits: np.ndarray | None = None
    timeline_mode: np.ndarray | None = None  # ARMS mode (0 elsewhere)
    timeline_promotions: np.ndarray | None = None
    # streaming summaries (None under reduce="stack"; derive them from the
    # timelines there instead).
    mean_slow_bw: float | None = None
    mean_fast_hits: float | None = None
    mean_mode: float | None = None
    max_promotions_interval: int | None = None


def oracle_topk_masks(trace: np.ndarray, k: int) -> np.ndarray:
    """[T, n] bool mask of each interval's true top-k pages, vectorized.

    One partition over the whole trace instead of T per-interval ones.
    The tie rule is ``lax.top_k``'s — strictly-greater values first, then
    threshold-equal values by ascending page index — the same rule the
    interval-step ``topk_mask`` op follows.
    """
    trace = np.asarray(trace)
    n = trace.shape[1]
    assert 0 < k <= n
    kth = np.partition(trace, n - k, axis=1)[:, n - k, None]
    greater = trace > kth
    need = k - greater.sum(axis=1, keepdims=True, dtype=np.int32)
    eq = trace == kth
    # i32 cumsum: counts are bounded by n, and the default i64 temporary
    # would be 2x the trace's own footprint at bench scale
    return greater | (eq & (np.cumsum(eq, axis=1, dtype=np.int32) <= need))
