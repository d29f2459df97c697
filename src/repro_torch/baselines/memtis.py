"""Memtis baseline (Lee et al., SOSP'23) — dynamic hot threshold, static
cooling period, lane-batched.

Each adaptation interval Memtis picks the smallest count threshold whose
hot set fits the fast tier (histogram based); everything else stays
static.  The knob the paper blames (§7.1 "infrequent cooling") is the
cooling period of 2M PEBS samples, which at a 1/10k sampling rate spans
tens to hundreds of seconds.  Its policy pass runs every interval.
"""
from __future__ import annotations

import torch

from repro_torch.baselines.protocol import (LegacyPolicyAdapter, PolicySpec,
                                            capacity_victims, knob, lanes_of,
                                            ranked_take, scatter_set,
                                            truncate_ranked)
from repro_torch.utils.pytree import tensor_dataclass

DEFAULTS = dict(cooling_period_samples=2e6, adaptation_period=10)


@tensor_dataclass
class MemtisState:
    counts: torch.Tensor          # f32 [B, n]
    in_fast: torch.Tensor         # bool [B, n]
    samples_seen: torch.Tensor    # f32 [B], since the last cooling
    hot_threshold: torch.Tensor   # f32 [B], histogram-adapted
    t: torch.Tensor               # i32 [B]
    cooling_events: torch.Tensor  # i32 [B]


@tensor_dataclass(meta=("migration_limit",))
class MemtisSpec(PolicySpec):
    cooling_period_samples: torch.Tensor
    adaptation_period: torch.Tensor   # i32
    migration_limit: int = 12  # kmigrated-style serial migration

    name = "memtis"

    @classmethod
    def make(cls, cooling_period_samples=None, adaptation_period=None,
             migration_limit: int = 12) -> "MemtisSpec":
        return cls(
            cooling_period_samples=knob(cooling_period_samples,
                                        "cooling_period_samples", DEFAULTS,
                                        torch.float32),
            adaptation_period=knob(adaptation_period, "adaptation_period",
                                   DEFAULTS, torch.int32),
            migration_limit=migration_limit)

    def init(self, n_pages, k, machine):
        B, _, dev = lanes_of(machine)
        z = lambda dtype: torch.zeros((B,), dtype=dtype, device=dev)
        return MemtisState(
            counts=torch.zeros((B, n_pages), dtype=torch.float32, device=dev),
            in_fast=torch.zeros((B, n_pages), dtype=torch.bool, device=dev),
            samples_seen=z(torch.float32),
            hot_threshold=torch.ones((B,), dtype=torch.float32, device=dev),
            t=z(torch.int32), cooling_events=z(torch.int32))

    def observe(self, state, observed):
        counts = state.counts + observed
        # the counts are whole samples: their f32 sum is exact in any order
        samples = state.samples_seen + observed.sum(dim=1)
        # static-period cooling (the pathology the paper highlights).
        cool = samples >= self.cooling_period_samples
        counts = torch.where(cool[:, None], counts * 0.5, counts)
        samples = torch.where(cool, 0.0, samples)
        return state.replace(
            counts=counts, samples_seen=samples, t=state.t + 1,
            cooling_events=state.cooling_events + cool.to(torch.int32))

    def policy(self, state, slow_bw, app_bw, k):
        n = state.counts.shape[1]
        # histogram threshold: the smallest thr with |hot| <= k, the k-th
        # largest count (only its value is used, so the tie order of
        # torch.topk does not matter).
        adapt_every = torch.clamp_min(
            self.adaptation_period.to(torch.int32), 1)
        thr = torch.clamp_min(
            torch.topk(state.counts, k, dim=1).values[:, k - 1], 1.0)
        hot_threshold = torch.where((state.t % adapt_every) == 0, thr,
                                    state.hot_threshold)
        hot = state.counts >= hot_threshold[:, None]
        want, n_want = ranked_take(                    # hottest first
            -state.counts, hot & ~state.in_fast,
            self.pad_promote(n, k), self.migration_limit)
        victims, _, n_take = capacity_victims(
            state.in_fast, state.counts, state.in_fast & ~hot, n_want, k,
            self.pad_demote(n, k))
        promote = truncate_ranked(want, n_take)
        in_fast = scatter_set(state.in_fast, victims, False)
        in_fast = scatter_set(in_fast, promote, True)
        return (state.replace(in_fast=in_fast, hot_threshold=hot_threshold),
                promote, victims)


class MemtisPolicy(LegacyPolicyAdapter):
    """Memtis for the numpy reference engine (functional spec underneath)."""

    def __init__(self, cooling_period_samples: float = 2e6,
                 adaptation_period: int = 10):
        super().__init__(MemtisSpec.make(cooling_period_samples,
                                         adaptation_period))
