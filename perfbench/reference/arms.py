"""ARMS (the paper's §4-5) as a lane-batched plain-torch policy.

Each observed interval adds its samples to a buffer.  A policy pass runs
every 5 intervals in history mode and every interval in recency mode:

  1. a Page-Hinkley test on the slow tier's bandwidth share sets the mode
     (an alarm starts 20 intervals of recency, counted down only while the
     signal's short EWMA is within ``stabilize_eps`` of its long one);
  2. the buffer, divided by the cadence, updates two EWMAs a page and the
     score ``w_s * short + w_l * long`` (weights by mode), each rounded
     once as a fused multiply-add;
  3. the top-k pages by score are hot; ``hot_age`` counts consecutive
     passes hot;
  4. candidates are hot slow pages whose score did not fall and whose age
     is at least 2, hottest first; victims are non-hot fast pages,
     coldest first; the i-th candidate takes a free slot or the i-th
     victim if ``(p - q - noise_z sqrt(p + q)) * age * dL * scale`` beats
     the promotion (plus demotion) cost estimate;
  5. at most ``max(1, floor((1 - app_bw) * 64))`` accepted pairs migrate;
     the cost estimates take an EWMA step toward the machine's page copy
     times when any page moves.

A knob listed in ``swept`` is an f32 [B] tensor a lane; the others keep
their Python values, as the replay under test holds them.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from perfbench.reference.numerics import (count, fma, ranked_top,
                                          scatter_set, topk_mask)

_NEG = float(np.float32(-3.4e38))
HISTORY, RECENCY = 0, 1


@dataclasses.dataclass(frozen=True)
class Config:
    alpha_s: float = 0.7
    alpha_l: float = 0.1
    w_s_history: float = 0.2
    w_l_history: float = 0.8
    w_s_recency: float = 0.8
    w_l_recency: float = 0.2
    hot_age_min: int = 2
    pht_delta: float = 0.005
    pht_lambda: float = 0.10
    recency_ttl: int = 20
    stabilize_eps: float = 0.02
    bs_max: int = 64
    latency_fast_us: float = 0.08
    latency_slow_us: float = 0.25
    access_scale: float = 10_000.0
    noise_z: float = 0.25
    migrate_cost_alpha: float = 0.3
    init_promo_cost_us: float = 50.0
    init_demo_cost_us: float = 50.0


def _f32(v, device):
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=torch.float32)
    return torch.full((), float(v), dtype=torch.float32, device=device)


def _col(v):
    return v[:, None] if isinstance(v, torch.Tensor) else v


def init(configs, n: int, k: int, machine, device):
    """``configs``: one dict of knob overrides a lane (the same keys in
    every lane, possibly none)."""
    B = len(configs)
    names = sorted(configs[0])
    over = {nm: torch.tensor([float(c[nm]) for c in configs],
                             dtype=torch.float32, device=device)
            for nm in names}
    cfg = dataclasses.replace(Config(), **over)
    f = torch.zeros((B, n), dtype=torch.float32, device=device)
    z = torch.zeros((B,), dtype=torch.float32, device=device)
    zi = torch.zeros((B,), dtype=torch.int32, device=device)
    lane = lambda v: _f32(v, device).expand(B).clone()
    return dict(
        cfg=cfg, ewma_s=f, ewma_l=f.clone(), score=f.clone(),
        prev_score=f.clone(),
        hot_age=torch.zeros((B, n), dtype=torch.int32, device=device),
        in_fast=torch.zeros((B, n), dtype=torch.bool, device=device),
        mode=zi.clone(), ttl=zi.clone(), sig_s=z.clone(), sig_l=z.clone(),
        promo_cost=lane(cfg.init_promo_cost_us),
        demo_cost=lane(cfg.init_demo_cost_us),
        pht_n=zi.clone(), pht_mean=z.clone(), pht_m=z.clone(),
        pht_min=z.clone(), buf=f.clone(), t=zi.clone(),
        promo_us=machine["promo_us"].expand(B).clone(),
        demo_us=machine["demo_us"].expand(B).clone())


def _every(mode):
    return torch.where(mode == RECENCY, 1, 5).to(torch.int32)


def sampling_period(st):
    return torch.where(st["mode"] == RECENCY, 5000, 10000).to(
        torch.int32).float()


def observe(st, observed):
    return dict(st, buf=st["buf"] + observed, t=st["t"] + 1)


def fires(st):
    return (st["t"] % _every(st["mode"])) == 0


def _pass(st, counts, slow_bw, app_bw, k: int):
    cfg = st["cfg"]
    dev = counts.device
    # 1. Page-Hinkley test and mode
    x = slow_bw.float()
    sig_s = cfg.alpha_s * x + (1 - cfg.alpha_s) * st["sig_s"]
    sig_l = cfg.alpha_l * x + (1 - cfg.alpha_l) * st["sig_l"]
    stabilized = sig_s <= sig_l + cfg.stabilize_eps
    n_ = st["pht_n"] + 1
    mean = st["pht_mean"] + (x - st["pht_mean"]) / n_.float()
    m_t = st["pht_m"] + (x - mean - cfg.pht_delta)
    m_min = torch.minimum(st["pht_min"], m_t)
    alarm = (m_t - m_min) > cfg.pht_lambda
    ttl = torch.where(
        alarm, cfg.recency_ttl,
        torch.where(stabilized, torch.clamp_min(st["ttl"] - 1, 0),
                    torch.clamp_min(st["ttl"], 0))).to(torch.int32)
    mode = torch.where(ttl > 0, RECENCY, HISTORY).to(torch.int32)
    st = dict(st, pht_n=torch.where(alarm, 0, n_),
              pht_mean=torch.where(alarm, 0.0, mean),
              pht_m=torch.where(alarm, 0.0, m_t),
              pht_min=torch.where(alarm, 0.0, m_min),
              mode=mode, ttl=ttl, sig_s=sig_s, sig_l=sig_l)
    # 2. dual EWMA and score
    rec = mode == RECENCY
    sel = lambda a, b: torch.where(rec, _f32(a, dev), _f32(b, dev))
    B = counts.shape[0]
    params = torch.stack([_f32(v, dev).expand(B) for v in (
        cfg.alpha_s, cfg.alpha_l, sel(cfg.w_s_recency, cfg.w_s_history),
        sel(cfg.w_l_recency, cfg.w_l_history))], dim=1)
    a_s, a_l, w_s, w_l = (params[:, i:i + 1] for i in range(4))
    counts = counts.float()
    s = fma(a_s.expand_as(counts), counts, (1 - a_s) * st["ewma_s"])
    l_ = fma(a_l.expand_as(counts), counts, (1 - a_l) * st["ewma_l"])
    score = fma(w_s.expand_as(s), s, w_l * l_)
    st = dict(st, ewma_s=s, ewma_l=l_, prev_score=st["score"], score=score)
    # 3. top-k hot set and hot age
    hot = topk_mask(score, min(int(k), score.shape[-1]))
    st["hot_age"] = torch.where(hot, st["hot_age"] + 1, 0)
    # 4. candidates, victims, cost/benefit gate
    bs = min(cfg.bs_max, counts.shape[1])
    in_fast = st["in_fast"]
    is_cand = (hot & ~in_fast & (score >= st["prev_score"])
               & (st["hot_age"] >= cfg.hot_age_min))
    cval, cand = ranked_top(torch.where(is_cand, score, _NEG), bs)
    cand_ok = cval > _NEG
    vval, vict = ranked_top(torch.where(in_fast & ~hot, -score, _NEG), bs)
    vict_ok = vval > _NEG
    free = k - count(in_fast)
    j = torch.arange(bs, dtype=torch.int32, device=dev)[None]
    fs = free[:, None]
    uses_free = j < fs
    vpos = torch.clamp(j - fs, 0, bs - 1).long()
    victim = vict.gather(1, vpos)
    victim_ok = vict_ok.gather(1, vpos) & ~uses_free
    q = torch.where(uses_free, 0.0, score.gather(1, victim.long()))
    p = score.gather(1, cand.long())
    age = st["hot_age"].gather(1, cand.long()).float()
    noise = _col(cfg.noise_z) * torch.sqrt(torch.clamp_min(p + q, 0.0))
    gain = torch.clamp_min(p - q - noise, 0.0)
    dl = cfg.latency_slow_us - cfg.latency_fast_us
    benefit = gain * age * _col(dl) * _col(cfg.access_scale)
    cost = torch.where(uses_free, st["promo_cost"][:, None],
                       (st["promo_cost"] + st["demo_cost"])[:, None])
    ok = cand_ok & (uses_free | victim_ok) & (benefit > cost)
    dem = torch.where(uses_free, -1, victim)
    # 5. bandwidth-aware batch
    width = min(cfg.bs_max, cand.shape[1])
    bw_max = torch.ones_like(app_bw, dtype=torch.float32)
    frac = torch.clamp((bw_max - app_bw.float()) / bw_max, 0.0, 1.0)
    size = torch.clamp(torch.floor(frac * width).to(torch.int32), 1, width)
    rank = torch.cumsum(ok.to(torch.int32), dim=1) - 1
    valid = ok & (rank < size[:, None])
    promote = torch.where(valid, cand, -1)
    demote = torch.where(valid, dem, -1)
    in_fast = scatter_set(in_fast, demote, False, valid & (demote >= 0))
    in_fast = scatter_set(in_fast, promote, True, valid)
    st["in_fast"] = in_fast
    return st, promote, demote, valid


def policy(st, slow_bw, app_bw, k: int):
    counts = st["buf"] / _every(st["mode"]).float()[:, None]
    st, promote, demote, valid = _pass(st, counts, slow_bw, app_bw, k)
    cfg = st["cfg"]
    a = cfg.migrate_cost_alpha
    moved = count(valid) > 0
    fed_p = a * st["promo_us"].float() + (1 - a) * st["promo_cost"]
    fed_d = a * st["demo_us"].float() + (1 - a) * st["demo_cost"]
    st["promo_cost"] = torch.where(moved, fed_p, st["promo_cost"])
    st["demo_cost"] = torch.where(moved, fed_d, st["demo_cost"])
    st["buf"] = torch.zeros_like(st["buf"])
    promote = torch.where(valid, promote, -1).to(torch.int32)
    demote = torch.where(valid & (demote >= 0), demote, -1).to(torch.int32)
    return st, promote, demote
