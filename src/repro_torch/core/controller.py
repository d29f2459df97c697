"""ARMS controller: one policy interval end-to-end (paper Fig. 6), over an
explicit lane axis.

``arms_step_impl(state, access_counts, slow_bw_frac, app_bw_frac, cfg=,
k=)`` -> (state, plan) for B lanes at once.  Per interval:
  1. PHT on slow-tier bandwidth -> history/recency mode (§4.2); recency
     mode doubles the sampling rate (``sampling_period``) and runs the
     policy 5x more often (``policy_every``).
  2. dual-EWMA score update (Alg. 1), mode-dependent weights.
  3. top-k ranking (k = fast-tier capacity) + hot-age update.
  4. multi-round filter + cost/benefit gate (Alg. 2).
  5. bandwidth-aware batched, priority-ordered migration plan (§4.4).
"""
from __future__ import annotations

import torch

from repro_torch.core import classifier, costbenefit, scheduler
from repro_torch.core.pht import pht_update
from repro_torch.core.state import (MODE_HISTORY, MODE_RECENCY, ARMSConfig,
                                    TieringState)

# §5: PEBS sampling period 10k default, 5k in recency mode.
SAMPLING_PERIOD_HISTORY = 10_000
SAMPLING_PERIOD_RECENCY = 5_000
# Mode-indexed sampling periods (index = MODE_HISTORY / MODE_RECENCY); the
# scan engine precomputes one CRN observation grid per entry.
MODE_SAMPLING_PERIODS = (SAMPLING_PERIOD_HISTORY, SAMPLING_PERIOD_RECENCY)
# §5: policy thread every 500ms steady, 100ms after a hot-set change.
POLICY_EVERY_HISTORY = 5
POLICY_EVERY_RECENCY = 1


def sampling_period(mode):
    return torch.where(mode == MODE_RECENCY, SAMPLING_PERIOD_RECENCY,
                       SAMPLING_PERIOD_HISTORY).to(torch.int32)


def policy_every(mode):
    return torch.where(mode == MODE_RECENCY, POLICY_EVERY_RECENCY,
                       POLICY_EVERY_HISTORY).to(torch.int32)


def arms_step_impl(state: TieringState, access_counts, slow_bw_frac,
                   app_bw_frac, *, cfg: ARMSConfig, k: int):
    """One ARMS policy interval for every lane.

    Args:
      state: TieringState over B lanes of n pages.
      access_counts: f32 [B, n] accesses observed this interval.
      slow_bw_frac: f32 [B] slow-tier bandwidth / its max (PHT input).
      app_bw_frac: f32 [B] application bandwidth / BW_max (BS throttle).
      cfg: ARMSConfig; a float field may be a f32 [B] tensor (sweep lane).
      k: fast-tier capacity in pages.

    Returns:
      (new_state, MigrationPlan)
    """
    # 1. change-point detection -> mode.  The TTL counts down only while
    # the slow-tier signal has stabilized (§4.2).
    x = slow_bw_frac.float()
    sig_s = cfg.alpha_s * x + (1 - cfg.alpha_s) * state.sig_ewma_s
    sig_l = cfg.alpha_l * x + (1 - cfg.alpha_l) * state.sig_ewma_l
    stabilized = sig_s <= sig_l + cfg.stabilize_eps
    pht, alarm, _ = pht_update(state.pht, x, cfg)
    ttl = torch.where(
        alarm, cfg.recency_ttl,
        torch.where(stabilized, torch.clamp_min(state.mode_ttl - 1, 0),
                    torch.clamp_min(state.mode_ttl, 0))).to(torch.int32)
    mode = torch.where(ttl > 0, MODE_RECENCY, MODE_HISTORY).to(torch.int32)
    state = state.replace(pht=pht, mode=mode, mode_ttl=ttl,
                          interval=state.interval + 1,
                          sig_ewma_s=sig_s, sig_ewma_l=sig_l)

    # 2. score update (Alg. 1).
    state = classifier.update_scores(state, access_counts, cfg, mode)

    # 3. top-k hot set + hot age.
    hot_mask = classifier.topk_hot_mask(state.score, k)
    state = classifier.update_hot_age(state, hot_mask)

    # 4. candidates, victims, cost/benefit gate (Alg. 2).
    bs_max = min(cfg.bs_max, access_counts.shape[1])
    cand_idx, cand_valid = costbenefit.promotion_candidates(
        state, hot_mask, cfg, bs_max)
    victim_idx, victim_valid = costbenefit.demotion_victims(
        state, hot_mask, bs_max)
    free_slots = k - state.in_fast.sum(dim=1, dtype=torch.int32)
    ok, demote_idx = costbenefit.cost_benefit_gate(
        state, cand_idx, cand_valid, victim_idx, victim_valid, free_slots,
        cfg)

    # 5. bandwidth-aware batch + priority order; apply residency update.
    plan = scheduler.build_plan(cand_idx, ok, demote_idx, app_bw_frac, cfg)
    return scheduler.apply_plan(state, plan), plan
