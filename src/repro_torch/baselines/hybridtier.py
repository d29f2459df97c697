"""HybridTier-style baseline — lightweight frequency-based CXL tiering on
the tier-native contract (protocol docstring), lane-batched.

Decayed access-frequency counters are ranked and partitioned against the
per-tier capacity ladder; a frequency threshold gates entry to the fast
tier (no promotion on a single hot sample), cold pages sink to the bottom,
and per-pair budgets back off from whichever tier of a hop is the
bandwidth bottleneck (``scheduler.pair_budgets``).
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

DEFAULTS = dict(hot_thresh=6.0, warm_thresh=1.0, decay=0.7,
                migration_period=4, sample_period=10_000.0)


@tensor_dataclass
class HybridTierState:
    counts: torch.Tensor   # f32 [B, n] decayed access-frequency counters
    tier: torch.Tensor     # i32 [B, n] residency belief over the chain
    t: torch.Tensor        # i32 [B]


@tensor_dataclass(meta=("bs_max",))
class HybridTierSpec(TierNativeSpec):
    hot_thresh: torch.Tensor        # min frequency to enter the fast tier
    warm_thresh: torch.Tensor       # below this, sink to the bottom tier
    decay: torch.Tensor             # per-interval counter decay in (0, 1]
    migration_period: torch.Tensor  # i32 intervals between passes
    sample_period: torch.Tensor
    bs_max: int = 128

    name = "hybridtier"

    @classmethod
    def make(cls, hot_thresh=None, warm_thresh=None, decay=None,
             migration_period=None, sample_period=None,
             bs_max: int = 128) -> "HybridTierSpec":
        f32, i32 = torch.float32, torch.int32
        return cls(
            hot_thresh=knob(hot_thresh, "hot_thresh", DEFAULTS, f32),
            warm_thresh=knob(warm_thresh, "warm_thresh", DEFAULTS, f32),
            decay=knob(decay, "decay", DEFAULTS, f32),
            migration_period=knob(migration_period, "migration_period",
                                  DEFAULTS, i32),
            sample_period=knob(sample_period, "sample_period", DEFAULTS, f32),
            bs_max=bs_max)

    def init(self, n_pages, k, machine):
        B, R, dev = lanes_of(machine)
        return HybridTierState(
            counts=torch.zeros((B, n_pages), dtype=torch.float32, device=dev),
            tier=torch.full((B, n_pages), R - 1, dtype=torch.int32,
                            device=dev),
            t=torch.zeros((B,), dtype=torch.int32, device=dev))

    def observe(self, state, observed):
        # the JAX engine's compiled code fuses counts * decay + observed
        d = self.decay[:, None].expand_as(observed)
        return state.replace(counts=fma(state.counts, d, observed),
                             t=state.t + 1)

    def tier_policy(self, state, tier_util, slow_bw, app_bw, k, caps):
        n = state.counts.shape[1]
        R = caps.shape[1]
        tgt = rank_partition(rank_desc(state.counts), caps)
        # promotion gate: only frequency-hot pages may enter the fast tier
        # (a single hot sample is not enough — the HybridTier argument).
        tgt = torch.where((tgt == 0) & (state.tier > 0)
                          & (state.counts < self.hot_thresh[:, None]),
                          state.tier, tgt)
        # cold pages sink to the bottom regardless of rank.
        tgt = torch.where(state.counts < self.warm_thresh[:, None], R - 1,
                          tgt)
        budgets = pair_budgets(tier_util, self.bs_max)
        pages, dst, tier = tier_plan(
            state.counts, state.tier, tgt, caps, budgets,
            self.pad_demote(n, k), self.pad_promote(n, k))
        return state.replace(tier=tier), pages, dst


class HybridTierPolicy(LegacyPolicyAdapter):
    """HybridTier for the numpy reference engine (functional spec inside)."""

    def __init__(self, hot_thresh=None, warm_thresh=None, decay=None,
                 migration_period=None, sample_period=None):
        super().__init__(HybridTierSpec.make(
            hot_thresh, warm_thresh, decay, migration_period, sample_period))
