"""The reference replay: lanes of one policy family over a two-tier
machine, interval by interval, in plain torch.

A lane starts with every page in the slow tier.  Each interval:

  1. the true counts of the interval (a synthesised row of the lane's
     workload, or a row of a materialised trace) are sampled into
     per-page counts with the lane's sampling period, from a uniform row
     that every lane shares (``"crn_prng"``: ``fold_in(noise_key, t)``) or
     that each lane draws from its own key chain (``"prng"``);
  2. the policy observes them; if it fires in any lane, its pass runs and
     the lanes that fire execute their plans: demotions out of the fast
     tier first, then promotions up to the fast tier's free room, in plan
     order;
  3. a move undone within 20 intervals is wasteful;
  4. the interval's wall time is the largest of the latency time
     ``(a_fast L_fast + a_slow L_slow) 1e-9 / mlp`` and each tier's
     bandwidth time (accesses of 64 bytes and the pages, of the
     configuration's ``page_bytes``, moved through it); the slow tier's
     share of accesses and the fast tier's bandwidth share (clamped to 1)
     are the policy's signals next interval.

The per-tier access sums are taken in f64 and rounded once to f32.
Returns per lane: exec time (the f32 sum of the walls), promotions,
demotions and wasteful moves.
"""
from __future__ import annotations

import numpy as np
import torch

from perfbench.reference import prng
from perfbench.reference.numerics import (count, poisson_from_uniform,
                                          scatter_set)

CACHELINE = 64
WASTE_WINDOW = 20


def machine(spec: dict, page_bytes: int, device):
    """Lane-shared f32 leaves of a two-tier machine from its published
    latencies (ns) and bandwidths (B/s), and its page size; the page copy
    times in f64, rounded once."""
    lat = np.asarray(spec["lat_ns"], np.float64)
    br = np.asarray(spec["bw_read"], np.float64)
    bw = np.asarray(spec["bw_write"], np.float64)
    page = int(page_bytes)
    promo = (page / br[1] + page / bw[0]) * 1e6
    demo = (page / br[0] + page / bw[1]) * 1e6
    t = lambda v: torch.tensor(np.float32(v), device=device)
    return dict(lat=[t(v) for v in lat], br=[t(v) for v in br],
                bw=[t(v) for v in bw], mlp=t(spec["mlp"]),
                promo_us=t(promo), demo_us=t(demo), page=page)


def account(m, true, tier, up, down):
    """Interval cost of [B, n] rows: (wall, slow_share, app_raw), each
    f32 [B]."""
    t64 = true.double()
    total = t64.sum(dim=1).float()
    a0 = torch.where(tier == 0, t64, 0.0).sum(dim=1).float()
    a1 = total - a0
    B = tier.shape[0]
    lane = lambda v: v.expand(B)
    t_lat = a0 * lane(m["lat"][0])
    t_lat = t_lat + a1 * lane(m["lat"][1])
    t_lat = t_lat * 1e-9 / lane(m["mlp"])
    page = m["page"]
    time0 = (a0 * CACHELINE + (up + down) * page) / lane(m["br"][0])
    time1 = ((a1 * CACHELINE + up * page) / lane(m["br"][1])
             + down * page / lane(m["bw"][1]))
    rest = torch.clamp_min(time1, 1e-12)
    wall = torch.maximum(torch.maximum(t_lat, time0), rest)
    slow_share = a1 / torch.clamp_min(a0 + a1, 1e-9)
    app_raw = time0 / torch.maximum(t_lat, rest)
    return wall, slow_share, app_raw


def migrate(tier, promote, demote, k: int):
    """Two-tier plans: demotions of fast pages, then promotions of slow
    pages up to the free room, in plan order."""
    src = tier.gather(1, torch.clamp_min(demote, 0).long())
    dexec = (demote >= 0) & (src < 1)
    tier = scatter_set(tier, demote, 1, dexec)
    p_src = tier.gather(1, torch.clamp_min(promote, 0).long())
    p_ok = (promote >= 0) & (p_src > 0)
    room = k - count(tier == 0)
    rank = torch.cumsum(p_ok.to(torch.int32), dim=1) - 1
    pexec = p_ok & (rank < room[:, None])
    tier = scatter_set(tier, promote, 0, pexec)
    return tier, pexec, dexec


class TraceRows:
    """Rows of a materialised trace [T, n], shared by every lane."""

    def __init__(self, trace, B: int):
        self.trace, self.B = trace, B
        self.T, self.n = trace.shape

    def row(self, t: int):
        return self.trace[t][None].expand(self.B, self.n)


class SynthRows:
    """Rows of a synthesised workload stack; ``widx`` (i64 [B]) gives each
    lane's workload."""

    def __init__(self, synth, widx):
        self.synth, self.widx = synth, widx
        self.T, self.n = synth.T, synth.n

    def row(self, t: int):
        return self.synth.row(t).index_select(0, self.widx)


def replay(family, configs, source, k: int, mach, sampling: str, noise,
           group=None, lowp: bool = False):
    """Replay ``len(configs)`` lanes of ``family`` (a module with ``init``,
    ``sampling_period``, ``observe``, ``fires`` and ``policy``) over
    ``source``.  ``noise``: ``"crn_prng"``, keys [G, 2] of G shared noise
    sources, lane ``b`` sampling from source ``group[b]``; ``"prng"``, one
    key a lane [B, 2].  ``lowp`` stores the true rows, the observed counts
    and the policy's f32 state in bfloat16 (the control).  -> dict of
    per-lane CPU tensors."""
    T, n = source.T, source.n
    B = len(configs)
    dev = mach["mlp"].device
    f32, i32 = torch.float32, torch.int32
    low = (lambda x: x.to(torch.bfloat16).float()) if lowp else (lambda x: x)
    st = family.init(configs, n, k, mach, dev)
    tier = torch.ones((B, n), dtype=i32, device=dev)
    promoted_at = torch.full((B, n), -(10 ** 9), dtype=i32, device=dev)
    demoted_at = torch.full((B, n), -(10 ** 9), dtype=i32, device=dev)
    slow_bw = torch.ones((B,), dtype=f32, device=dev)
    app_bw = torch.zeros((B,), dtype=f32, device=dev)
    exec_time = torch.zeros((B,), dtype=f32, device=dev)
    promotions = torch.zeros((B,), dtype=i32, device=dev)
    demotions = torch.zeros_like(promotions)
    wasteful = torch.zeros_like(promotions)
    subs = prng.subkey_chain(noise, T) if sampling == "prng" else None
    for t in range(T):
        true = low(source.row(t))
        if sampling == "prng":
            u = prng.uniform(subs[t], (n,))
        else:
            u = prng.uniform(prng.fold_in(noise, t), (n,)).index_select(
                0, group)
        period = family.sampling_period(st)[:, None]
        observed = low(poisson_from_uniform(u, true, period))
        st = family.observe(st, observed)
        do = family.fires(st)
        if bool(do.any()):
            st2, promote, demote = family.policy(st, slow_bw, app_bw, k)
            st = {key: (torch.where(do.reshape((-1,) + (1,) * (v.dim() - 1)),
                                    st2[key], v)
                        if isinstance(v, torch.Tensor) else v)
                  for key, v in st.items()}
            promote = torch.where(do[:, None], promote, -1)
            demote = torch.where(do[:, None], demote, -1)
            tier, pexec, dexec = migrate(tier, promote, demote, k)
            p_safe = torch.where(pexec, promote, 0).long()
            d_safe = torch.where(dexec, demote, 0).long()
            waste = (count(pexec & (t - demoted_at.gather(1, p_safe)
                                    <= WASTE_WINDOW))
                     + count(dexec & (t - promoted_at.gather(1, d_safe)
                                      <= WASTE_WINDOW)))
            promoted_at = scatter_set(promoted_at, promote, t, pexec)
            demoted_at = scatter_set(demoted_at, demote, t, dexec)
            n_up, n_down = count(pexec), count(dexec)
        else:
            n_up = n_down = waste = torch.zeros((B,), dtype=i32, device=dev)
        if lowp:
            st = {key: (low(v) if isinstance(v, torch.Tensor)
                        and v.dtype == f32 and v.dim() == 2 else v)
                  for key, v in st.items()}
        wall, slow_share, app_raw = account(mach, true, tier, n_up.float(),
                                            n_down.float())
        slow_bw = slow_share
        app_bw = torch.clamp_max(app_raw, 1.0)
        exec_time = low(exec_time + wall)
        promotions = promotions + n_up
        demotions = demotions + n_down
        wasteful = wasteful + waste
    return dict(exec_time=exec_time.cpu(), promotions=promotions.cpu(),
                demotions=demotions.cpu(), wasteful=wasteful.cpu())
