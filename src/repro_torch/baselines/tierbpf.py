"""TierBPF-style baseline — migration admission control on the
tier-native contract, lane-batched.

  * per-page EWMA hotness ranks pages against the capacity ladder;
  * ``admit_thresh`` gates promotions: a page below the bar stays put
    whatever its rank;
  * a regret estimate (EWMA of the share of last pass's up-moves whose
    target flipped back down) scales every pair budget by
    ``1 - thrash_gain * regret``, so sustained thrash throttles migration
    toward zero.
"""
from __future__ import annotations

import torch

from repro_torch.baselines.jenga import ewma
from repro_torch.baselines.protocol import (LegacyPolicyAdapter,
                                            TierNativeSpec, knob, lanes_of,
                                            rank_desc, rank_partition,
                                            tier_plan)
from repro_torch.core.scheduler import pair_budgets
from repro_torch.utils.pytree import tensor_dataclass

DEFAULTS = dict(alpha=0.5, admit_thresh=2.0, thrash_gain=2.0,
                regret_alpha=0.3, migration_period=2,
                sample_period=10_000.0)


@tensor_dataclass
class TierBPFState:
    ewma: torch.Tensor       # f32 [B, n]
    tier: torch.Tensor       # i32 [B, n] residency belief
    up_at: torch.Tensor      # i32 [B, n] pass index of the last up-move
    regret: torch.Tensor     # f32 [B] recent-promotion regret estimate
    passes: torch.Tensor     # i32 [B]
    t: torch.Tensor          # i32 [B]


@tensor_dataclass(meta=("bs_max",))
class TierBPFSpec(TierNativeSpec):
    alpha: torch.Tensor             # hotness EWMA weight
    admit_thresh: torch.Tensor      # min EWMA hotness to admit a promotion
    thrash_gain: torch.Tensor       # budget backoff per unit regret
    regret_alpha: torch.Tensor      # regret-estimate EWMA weight
    migration_period: torch.Tensor  # i32
    sample_period: torch.Tensor
    bs_max: int = 128

    name = "tierbpf"

    @classmethod
    def make(cls, alpha=None, admit_thresh=None, thrash_gain=None,
             regret_alpha=None, migration_period=None, sample_period=None,
             bs_max: int = 128) -> "TierBPFSpec":
        f32, i32 = torch.float32, torch.int32
        return cls(
            alpha=knob(alpha, "alpha", DEFAULTS, f32),
            admit_thresh=knob(admit_thresh, "admit_thresh", DEFAULTS, f32),
            thrash_gain=knob(thrash_gain, "thrash_gain", DEFAULTS, f32),
            regret_alpha=knob(regret_alpha, "regret_alpha", DEFAULTS, f32),
            migration_period=knob(migration_period, "migration_period",
                                  DEFAULTS, i32),
            sample_period=knob(sample_period, "sample_period", DEFAULTS, f32),
            bs_max=bs_max)

    def init(self, n_pages, k, machine):
        B, R, dev = lanes_of(machine)
        return TierBPFState(
            ewma=torch.zeros((B, n_pages), dtype=torch.float32, device=dev),
            tier=torch.full((B, n_pages), R - 1, dtype=torch.int32,
                            device=dev),
            up_at=torch.full((B, n_pages), -(10 ** 6), dtype=torch.int32,
                             device=dev),
            regret=torch.zeros((B,), dtype=torch.float32, device=dev),
            passes=torch.zeros((B,), dtype=torch.int32, device=dev),
            t=torch.zeros((B,), dtype=torch.int32, device=dev))

    def observe(self, state, observed):
        return state.replace(ewma=ewma(self.alpha, state.ewma, observed),
                             t=state.t + 1)

    def tier_policy(self, state, tier_util, slow_bw, app_bw, k, caps):
        f32 = torch.float32
        n = state.ewma.shape[1]
        p = state.passes + 1
        raw = rank_partition(rank_desc(state.ewma), caps)
        # regret: of the pages promoted LAST pass, how many does the
        # ranking already want back down?  EWMA-smoothed, it throttles the
        # budgets — the admission-control half of the policy.
        recent = state.up_at == (p - 1)[:, None]
        flip = (recent & (raw > state.tier)).sum(dim=1).to(f32)
        regret_now = flip / torch.clamp_min(recent.sum(dim=1).to(f32), 1.0)
        ra = torch.clamp(self.regret_alpha, 0.0, 1.0)
        regret = (1 - ra) * state.regret + ra * regret_now
        scale = torch.clamp(1.0 - self.thrash_gain * regret, 0.0, 1.0)
        budgets = pair_budgets(tier_util, self.bs_max)
        budgets = torch.clamp_min(torch.floor(
            budgets.to(f32) * scale[:, None]).to(torch.int32), 1)
        # admission gate: un-hot pages are never promoted, whatever their
        # rank says this pass.
        tgt = torch.where((raw < state.tier)
                          & (state.ewma < self.admit_thresh[:, None]),
                          state.tier, raw)
        pages, dst, tier = tier_plan(
            state.ewma, state.tier, tgt, caps, budgets,
            self.pad_demote(n, k), self.pad_promote(n, k))
        up_at = torch.where(tier < state.tier, p[:, None], state.up_at)
        return (state.replace(tier=tier, up_at=up_at, regret=regret,
                              passes=p), pages, dst)


class TierBPFPolicy(LegacyPolicyAdapter):
    """TierBPF for the numpy reference engine (functional spec inside)."""

    def __init__(self, alpha=None, admit_thresh=None, thrash_gain=None,
                 regret_alpha=None, migration_period=None,
                 sample_period=None):
        super().__init__(TierBPFSpec.make(
            alpha, admit_thresh, thrash_gain, regret_alpha,
            migration_period, sample_period))
