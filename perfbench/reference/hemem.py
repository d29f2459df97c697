"""HeMem (Raybuck et al., SOSP 2021) as a lane-batched plain-torch policy.

Per-page sample counts accumulate; when any page's count reaches
``cooling_threshold`` all counts halve.  A page is hot iff its count is at
least ``hot_threshold``.  Every ``migration_period`` intervals one pass
promotes up to 12 hot slow pages in the order they became hot, demoting
the coldest non-hot fast pages only to make room.  State is a dict of
lane-batched tensors; ``policy`` returns the new state and the plans
(i32 [B, 12], -1 padded).
"""
from __future__ import annotations

import torch

from perfbench.reference.numerics import count, ranked_top, scatter_set

LIMIT = 12       # serial migration: pages a pass
KNOBS = {"hot_threshold": torch.float32, "cooling_threshold": torch.float32,
         "migration_period": torch.int32, "sample_period": torch.float32}


def init(configs, n: int, k: int, machine, device):
    B = len(configs)
    st = {nm: torch.tensor([c[nm] for c in configs], dtype=dt, device=device)
          for nm, dt in KNOBS.items()}
    st.update(
        counts=torch.zeros((B, n), dtype=torch.float32, device=device),
        in_fast=torch.zeros((B, n), dtype=torch.bool, device=device),
        first_hot=torch.full((B, n), float("inf"), dtype=torch.float32,
                             device=device),
        t=torch.zeros((B,), dtype=torch.int32, device=device))
    return st


def sampling_period(st):
    return st["sample_period"].float()


def observe(st, observed):
    t = st["t"] + 1
    counts = st["counts"] + observed
    cool = counts.amax(dim=1) >= st["cooling_threshold"]
    counts = torch.where(cool[:, None], counts * 0.5, counts)
    hot = counts >= st["hot_threshold"][:, None]
    newly = hot & torch.isinf(st["first_hot"])
    first = torch.where(newly, t.float()[:, None], st["first_hot"])
    first = torch.where(hot, first, float("inf"))
    return dict(st, counts=counts, first_hot=first, t=t)


def fires(st):
    return (st["t"] % torch.clamp_min(st["migration_period"], 1)) == 0


def _take(key, mask, pad: int, limit):
    """First ``limit`` [B] (at most ``pad``) indices of each lane's mask by
    ascending key, ties by page index; -1 padded."""
    neg = torch.where(mask, -key.float(), float("-inf"))
    _, order = ranked_top(neg, pad)
    cnt = mask.sum(dim=1, dtype=torch.int32)[:, None]
    if limit is not None:
        cnt = torch.minimum(cnt, limit.reshape(-1, 1))
    cnt = torch.clamp_max(cnt, pad)
    keep = torch.arange(pad, dtype=torch.int32, device=key.device) < cnt
    return torch.where(keep, order, -1), cnt[:, 0]


def policy(st, slow_bw, app_bw, k: int):
    n = st["counts"].shape[1]
    pad = max(1, min(n, LIMIT))
    B = st["counts"].shape[0]
    hot = st["counts"] >= st["hot_threshold"][:, None]
    lim = torch.full((B,), LIMIT, dtype=torch.int32, device=hot.device)
    want, n_want = _take(st["first_hot"], hot & ~st["in_fast"], pad, lim)
    free = k - count(st["in_fast"])
    need = torch.clamp_min(n_want - free, 0)
    victims, n_vict = _take(st["counts"], st["in_fast"] & ~hot, pad, need)
    n_take = torch.minimum(n_want, free + n_vict)
    keep = torch.arange(pad, dtype=torch.int32, device=hot.device) \
        < n_take[:, None]
    promote = torch.where(keep, want, -1)
    in_fast = scatter_set(st["in_fast"], victims, False, victims >= 0)
    in_fast = scatter_set(in_fast, promote, True, promote >= 0)
    return dict(st, in_fast=in_fast), promote, victims
