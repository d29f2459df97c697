"""The comparison that decides ``correct``.

A lane's answer is four numbers: promotions, demotions and wasteful moves
(integers, compared exactly) and the exec time (the f32 sum of the
interval walls, compared by its relative gap).  A lane the program did
not return counts as three mismatched integers.

``sample`` draws, from the run's seed and the pass, the lanes of a pass
that the reference replays.
"""
from __future__ import annotations

import numpy as np


def sample(seed: int, p: int, lanes: int, m: int) -> list:
    """``m`` of ``lanes`` lane indices (all of them when ``m >= lanes``),
    drawn from ``(seed, p)``, in ascending order."""
    if m >= lanes:
        return list(range(lanes))
    s = int(seed) % (1 << 64)
    rng = np.random.default_rng([s & 0xFFFFFFFF, s >> 32, p])
    return sorted(int(i) for i in rng.choice(lanes, size=m, replace=False))


def readings(got: dict, want: dict) -> dict:
    """``got``/``want``: ``(pass, lane key)`` -> (promotions, demotions,
    wasteful, exec_time_s).  -> the numbers the limits hold."""
    mismatched, gap = 0, 0.0
    for key, ref in want.items():
        out = got.get(key)
        if out is None:
            mismatched += 3
            continue
        mismatched += sum(int(int(a) != int(b))
                          for a, b in zip(out[:3], ref[:3]))
        gap = max(gap, abs(float(out[3]) - float(ref[3]))
                  / max(abs(float(ref[3])), 1e-30))
    return dict(mismatched_counts=mismatched, exec_time_rel_gap=gap,
                lanes_checked=len(want))


def lane_tuple(res) -> tuple:
    """A program ``SimResult``'s four compared numbers."""
    return (int(res.promotions), int(res.demotions), int(res.wasteful),
            float(res.exec_time_s))
