"""The seeded draw of a knob grid a tuning study scores.

``budget`` distinct grid points are drawn by index from ``numpy``'s
``default_rng(seed)`` (``choice`` without replacement on a grid of at
most ``max(4096, 4 budget)`` points, else rejection sampling of unique
indices) and decoded last knob fastest; the default point is always
scored, in front, replacing the last draw when the budget is full.
"""
from __future__ import annotations

import math

import numpy as np


def _decode(space: dict, keys: list, sizes: list, i: int) -> dict:
    vals, rem = {}, int(i)
    for nm, size in zip(reversed(keys), reversed(sizes)):
        vals[nm] = space[nm][rem % size]
        rem //= size
    return {nm: vals[nm] for nm in keys}


def draw(space: dict, defaults: dict, budget: int, seed: int) -> list:
    rng = np.random.default_rng(seed)
    keys = list(space)
    sizes = [len(space[nm]) for nm in keys]
    total = math.prod(sizes)
    m = max(1, min(budget, total))
    if total > max(4096, 4 * m):
        picks, seen = [], set()
        while len(picks) < m:
            i = int(rng.integers(total))
            if i not in seen:
                seen.add(i)
                picks.append(i)
    else:
        picks = [int(i) for i in rng.choice(total, size=m, replace=False)]
    configs = [_decode(space, keys, sizes, i) for i in picks]
    defaults = dict(defaults)
    if defaults not in configs:
        if len(configs) >= budget:
            configs = configs[:max(0, budget - 1)]
        configs.insert(0, defaults)
    return configs
