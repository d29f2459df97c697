"""Wasteful-migration elimination (paper §4.3, Algorithm 2), lane-batched.

Multi-round promotion filtering: a page entering the top-k is only a
*candidate* once its score is non-decreasing and its hot age >= 2.

Cost/benefit gate: the i-th hottest candidate p is paired with the i-th
coldest fast-tier victim q (or with a free fast-tier slot) and promoted
only if ``B = (p_score - q_score) * p_hotage * dLatency > C = L_promo +
L_demo``, with L_promo / L_demo the fed-back migration-latency EWMAs.

Ranking: ``ranked_top`` stands in for the ordered ``lax.top_k`` — a
stable descending sort on the order key (``interval_step.ref.order_key``),
which gives ``lax.top_k``'s order exactly: larger first, +0.0 above -0.0,
lower index first among ties.  ``torch.topk`` and a sort on the f32
values both break ties differently.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.state import ARMSConfig, TieringState
from repro_torch.kernels.interval_step.ref import order_key

_NEG = float(np.float32(-3.4e38))


def _col(v):
    """A config value as a [B, 1] column (Python floats pass through)."""
    return v[:, None] if isinstance(v, torch.Tensor) else v


def ranked_top(x, k: int):
    """(values, indices) of the k largest entries of each f32 [B, n] row,
    in ``lax.top_k``'s order."""
    idx = torch.sort(order_key(x), dim=-1, descending=True,
                     stable=True).indices[:, :k]
    return x.gather(1, idx), idx.to(torch.int32)


def promotion_candidates(state: TieringState, hot_mask, cfg: ARMSConfig,
                         bs_max: int):
    """Top ``bs_max`` promotion candidates per lane, hottest first (Alg. 2
    lines 1-4).  Returns (idx i32 [B, bs], valid [B, bs])."""
    is_cand = (hot_mask & (~state.in_fast)
               & (state.score >= state.prev_score)
               & (state.hot_age >= cfg.hot_age_min))
    val, idx = ranked_top(torch.where(is_cand, state.score, _NEG), bs_max)
    return idx, val > _NEG


def demotion_victims(state: TieringState, hot_mask, bs_max: int):
    """Coldest fast-tier pages outside the top-k, coldest first."""
    is_victim = state.in_fast & (~hot_mask)
    val, idx = ranked_top(torch.where(is_victim, -state.score, _NEG), bs_max)
    return idx, val > _NEG


def cost_benefit_gate(state: TieringState, cand_idx, cand_valid, victim_idx,
                      victim_valid, free_slots, cfg: ARMSConfig):
    """Alg. 2 lines 5-10 over the candidate batch.  The first
    ``free_slots`` candidates of a lane use free fast-tier capacity (no
    demotion, q_score = 0, C = L_promo only); the rest pair with victims.
    Returns (promote_ok [B, bs], demote_idx i32 [B, bs]), -1 marking a
    free-slot promotion."""
    bs = cand_idx.shape[1]
    j = torch.arange(bs, dtype=torch.int32, device=cand_idx.device)[None]
    fs = free_slots[:, None]
    uses_free = j < fs
    vpos = torch.clamp(j - fs, 0, bs - 1).long()
    victim = victim_idx.gather(1, vpos)
    victim_ok = victim_valid.gather(1, vpos) & (~uses_free)

    q_score = torch.where(uses_free, 0.0, state.score.gather(1, victim.long()))
    p_score = state.score.gather(1, cand_idx.long())
    p_age = state.hot_age.gather(1, cand_idx.long()).float()

    # §4.3 sampling-noise immunity: a score difference below (a fraction
    # of) the Poisson noise floor sqrt(p+q) carries no real benefit.
    noise = _col(cfg.noise_z) * torch.sqrt(
        torch.clamp_min(p_score + q_score, 0.0))
    gain = torch.clamp_min(p_score - q_score - noise, 0.0)
    benefit = gain * p_age * _col(cfg.delta_latency) * _col(cfg.access_scale)
    cost = torch.where(uses_free, state.promo_cost[:, None],
                       (state.promo_cost + state.demo_cost)[:, None])
    ok = cand_valid & (uses_free | victim_ok) & (benefit > cost)
    demote = torch.where(uses_free, -1, victim)
    return ok, demote
