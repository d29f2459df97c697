"""Jenga-style baseline — thrash-free responsive tiering on the tier-native
contract, lane-batched.

  * responsiveness: per-page EWMA hotness with a fast ``alpha`` and a short
    ``migration_period``;
  * confirmation: a page moves only after its rank-partition target has
    been stable for ``confirm`` consecutive passes;
  * cooldown: a page that just moved is pinned for ``cooldown`` passes.

Per-pair budgets come from ``scheduler.pair_budgets``.
"""
from __future__ import annotations

import torch

from repro_torch.baselines.protocol import (LegacyPolicyAdapter,
                                            TierNativeSpec, knob, lanes_of,
                                            rank_desc, rank_partition,
                                            tier_plan)
from repro_torch.core.scheduler import pair_budgets
from repro_torch.kernels.interval_step.ref import fma
from repro_torch.utils.pytree import tensor_dataclass

DEFAULTS = dict(alpha=0.5, confirm=2, cooldown=3, migration_period=1,
                sample_period=10_000.0)


def ewma(a, ewma_row, observed):
    """``(1 - a) * ewma + a * observed`` with the rounding of the JAX
    engine's compiled code, which fuses the first product:
    ``fma(1 - a, ewma, a * observed)``; ``a`` per lane, clipped to
    [0, 1]."""
    a = torch.clamp(a, 0.0, 1.0)[:, None]
    return fma((1 - a).expand_as(ewma_row), ewma_row, a * observed)


@tensor_dataclass
class JengaState:
    ewma: torch.Tensor      # f32 [B, n] per-page hotness estimate
    tier: torch.Tensor      # i32 [B, n] residency belief
    streak: torch.Tensor    # i32 [B, n] consecutive passes, same target
    last_tgt: torch.Tensor  # i32 [B, n] previous pass's raw target
    moved_at: torch.Tensor  # i32 [B, n] pass index of the last move
    passes: torch.Tensor    # i32 [B] policy-pass counter
    t: torch.Tensor         # i32 [B] interval counter


@tensor_dataclass(meta=("bs_max",))
class JengaSpec(TierNativeSpec):
    alpha: torch.Tensor             # EWMA weight of the newest interval
    confirm: torch.Tensor           # i32 confirmation streak before a move
    cooldown: torch.Tensor          # i32 passes a moved page stays pinned
    migration_period: torch.Tensor  # i32
    sample_period: torch.Tensor
    bs_max: int = 128

    name = "jenga"

    @classmethod
    def make(cls, alpha=None, confirm=None, cooldown=None,
             migration_period=None, sample_period=None,
             bs_max: int = 128) -> "JengaSpec":
        f32, i32 = torch.float32, torch.int32
        return cls(
            alpha=knob(alpha, "alpha", DEFAULTS, f32),
            confirm=knob(confirm, "confirm", DEFAULTS, i32),
            cooldown=knob(cooldown, "cooldown", DEFAULTS, i32),
            migration_period=knob(migration_period, "migration_period",
                                  DEFAULTS, i32),
            sample_period=knob(sample_period, "sample_period", DEFAULTS, f32),
            bs_max=bs_max)

    def init(self, n_pages, k, machine):
        B, R, dev = lanes_of(machine)
        full = lambda v: torch.full((B, n_pages), v, dtype=torch.int32,
                                    device=dev)
        return JengaState(
            ewma=torch.zeros((B, n_pages), dtype=torch.float32, device=dev),
            tier=full(R - 1), streak=full(0), last_tgt=full(R - 1),
            moved_at=full(-(10 ** 6)),
            passes=torch.zeros((B,), dtype=torch.int32, device=dev),
            t=torch.zeros((B,), dtype=torch.int32, device=dev))

    def observe(self, state, observed):
        return state.replace(ewma=ewma(self.alpha, state.ewma, observed),
                             t=state.t + 1)

    def tier_policy(self, state, tier_util, slow_bw, app_bw, k, caps):
        n = state.ewma.shape[1]
        p = (state.passes + 1)[:, None]
        raw = rank_partition(rank_desc(state.ewma), caps)
        streak = torch.where(raw == state.last_tgt, state.streak + 1, 1)
        conf = torch.clamp_min(self.confirm.to(torch.int32), 1)[:, None]
        cool = torch.clamp_min(self.cooldown.to(torch.int32), 0)[:, None]
        eligible = (streak >= conf) & (p - state.moved_at > cool)
        tgt = torch.where(eligible, raw, state.tier)
        budgets = pair_budgets(tier_util, self.bs_max)
        pages, dst, tier = tier_plan(
            state.ewma, state.tier, tgt, caps, budgets,
            self.pad_demote(n, k), self.pad_promote(n, k))
        moved_at = torch.where(tier != state.tier, p, state.moved_at)
        return (state.replace(tier=tier, streak=streak, last_tgt=raw,
                              moved_at=moved_at, passes=p[:, 0]),
                pages, dst)


class JengaPolicy(LegacyPolicyAdapter):
    """Jenga for the numpy reference engine (functional spec inside)."""

    def __init__(self, alpha=None, confirm=None, cooldown=None,
                 migration_period=None, sample_period=None):
        super().__init__(JengaSpec.make(
            alpha, confirm, cooldown, migration_period, sample_period))
