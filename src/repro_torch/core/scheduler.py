"""Bandwidth-aware batched migration scheduling (paper §4.4), lane-batched.

Candidates arrive hottest-first, so the hottest page migrates first (no
head-of-line blocking).  The batch size adapts to the application's
bandwidth headroom: ``BS = max(1, (BW_max - BW_app) / BW_max * BS_max)``.
"""
from __future__ import annotations

import torch

from repro_torch.core.state import ARMSConfig, MigrationPlan, TieringState
from repro_torch.utils.pytree import scatter_drop


def batch_size(bw_app, bw_max, bs_max: int):
    """The paper's BS formula per lane; clamped to [1, bs_max] (the
    consumer-side clamp of the raw utilization signal)."""
    frac = torch.clamp((bw_max - bw_app) / bw_max, 0.0, 1.0)
    bs = torch.floor(frac * bs_max).to(torch.int32)
    return torch.clamp(bs, 1, bs_max)


def pair_budgets(tier_util, bs_max: int):
    """Per-adjacent-pair migration budgets over an N-tier chain.

    ``tier_util`` f32 [B, R]: per-tier bandwidth utilization (raw ratios
    welcome, clipped here).  A pair's budget runs the BS formula against
    its more-saturated endpoint.  Returns i32 [B, R-1] in [1, bs_max]."""
    u = torch.maximum(tier_util[:, :-1], tier_util[:, 1:])
    frac = torch.clamp(1.0 - u, 0.0, 1.0)
    return torch.clamp(torch.floor(frac * bs_max).to(torch.int32), 1,
                       bs_max)


def build_plan(cand_idx, promote_ok, demote_idx, bw_app, cfg: ARMSConfig
               ) -> MigrationPlan:
    """Truncate the gated, priority-ordered candidate batch to BS entries
    (two-tier BS formula, BW_max = 1)."""
    width = min(cfg.bs_max, cand_idx.shape[1])
    bw_max = torch.ones_like(bw_app, dtype=torch.float32)
    bs = batch_size(bw_app.float(), bw_max, width)
    # rank accepted candidates by arrival (= hotness) order.
    rank = torch.cumsum(promote_ok.to(torch.int32), dim=1) - 1
    valid = promote_ok & (rank < bs[:, None])
    return MigrationPlan(
        promote=torch.where(valid, cand_idx, -1),
        demote=torch.where(valid, demote_idx, -1),
        valid=valid,
        count=valid.sum(dim=1, dtype=torch.int32),
        batch_size=bs)


def apply_plan(state: TieringState, plan: MigrationPlan) -> TieringState:
    """Update tier residency; the engine executes the same plan."""
    in_fast = scatter_drop(state.in_fast, plan.demote, False,
                           plan.valid & (plan.demote >= 0))
    in_fast = scatter_drop(in_fast, plan.promote, True, plan.valid)
    return state.replace(in_fast=in_fast)


def observe_migration_cost(state: TieringState, promo_us, demo_us,
                           cfg: ARMSConfig) -> TieringState:
    """Feed back measured per-page migration latencies (self-calibration)."""
    a = cfg.migrate_cost_alpha
    promo = a * promo_us.float() + (1 - a) * state.promo_cost
    demo = a * demo_us.float() + (1 - a) * state.demo_cost
    return state.replace(promo_cost=promo, demo_cost=demo)
