"""TPP baseline (Maruf et al., ASPLOS'23) — recency/fault-based promotion,
lane-batched.

TPP instruments slow-tier pages with NUMA hint faults: a page is promoted
once it has faulted ``promote_hits`` times.  Faults are cumulative (no
frequency history), so warm pages eventually cross the bar (paper §7.1).
Demotion takes from the tail of an approximated inactive LRU list, and a
watermark keeps a free-slot target.  Hint faults cost the application
latency on slow-tier accesses (``slow_access_extra_ns``), which the
engine charges.
"""
from __future__ import annotations

import torch

from repro_torch.baselines.protocol import (LegacyPolicyAdapter, PolicySpec,
                                            capacity_victims, knob, lanes_of,
                                            ranked_take, scatter_set,
                                            truncate_ranked)
from repro_torch.utils.pytree import scatter_drop, tensor_dataclass

DEFAULTS = dict(promote_hits=2.0, watermark=0.98)


@tensor_dataclass
class TPPState:
    in_fast: torch.Tensor      # bool [B, n]
    faults: torch.Tensor       # f32 [B, n] cumulative hint faults
    last_access: torch.Tensor  # i32 [B, n] last sampled access interval
    t: torch.Tensor            # i32 [B]


@tensor_dataclass(meta=("migration_limit",))
class TPPSpec(PolicySpec):
    promote_hits: torch.Tensor
    watermark: torch.Tensor
    migration_limit: int = 12

    name = "tpp"
    slow_access_extra_ns = 60.0   # NUMA hint fault + TLB shootdown, amortized

    @classmethod
    def make(cls, promote_hits=None, watermark=None,
             migration_limit: int = 12) -> "TPPSpec":
        f32 = torch.float32
        return cls(promote_hits=knob(promote_hits, "promote_hits", DEFAULTS,
                                     f32),
                   watermark=knob(watermark, "watermark", DEFAULTS, f32),
                   migration_limit=migration_limit)

    def pad_demote(self, n, k):
        # watermark demotions can exceed migration_limit; the victim count
        # is still bounded by the fast-tier population.
        return max(1, min(n, k))

    def init(self, n_pages, k, machine):
        B, _, dev = lanes_of(machine)
        return TPPState(
            in_fast=torch.zeros((B, n_pages), dtype=torch.bool, device=dev),
            faults=torch.zeros((B, n_pages), dtype=torch.float32, device=dev),
            last_access=torch.zeros((B, n_pages), dtype=torch.int32,
                                    device=dev),
            t=torch.zeros((B,), dtype=torch.int32, device=dev))

    def observe(self, state, observed):
        t = state.t + 1
        # hint faults only occur on slow-tier pages (fast pages are mapped).
        faults = state.faults + torch.where(
            state.in_fast, 0.0, torch.clamp_max(observed, 4.0))
        last_access = torch.where(observed > 0, t[:, None],
                                  state.last_access)
        return state.replace(faults=faults, last_access=last_access, t=t)

    def policy(self, state, slow_bw, app_bw, k):
        B, n = state.faults.shape
        eligible = ((state.faults >= self.promote_hits[:, None])
                    & ~state.in_fast)
        # fault-arrival order under sampling is effectively arbitrary: an
        # index rotation (clock) from a per-interval offset.
        start = (state.t * 97) % n
        clock = (torch.arange(n, dtype=torch.int32, device=start.device)
                 - start[:, None]) % n
        want, n_want = ranked_take(clock, eligible, self.pad_promote(n, k),
                                   self.migration_limit)
        # inactive-list approximation: pages without a recent sampled
        # access go first; the watermark keeps a free-slot target.
        free = k - state.in_fast.sum(dim=1, dtype=torch.int32)
        target_free = torch.floor((1.0 - self.watermark) * k).to(torch.int32)
        victims, _, n_take = capacity_victims(
            state.in_fast, state.last_access, state.in_fast, n_want, k,
            self.pad_demote(n, k), extra_need=target_free - free)
        promote = truncate_ranked(want, n_take)
        in_fast = scatter_set(state.in_fast, victims, False)
        in_fast = scatter_set(in_fast, promote, True)
        faults = scatter_drop(state.faults, promote, 0.0, promote >= 0)
        faults = scatter_drop(faults, victims, 0.0, victims >= 0)
        return state.replace(in_fast=in_fast, faults=faults), promote, victims


class TPPPolicy(LegacyPolicyAdapter):
    """TPP for the numpy reference engine (functional spec underneath)."""

    def __init__(self, promote_hits: float = 2.0, watermark: float = 0.98):
        super().__init__(TPPSpec.make(promote_hits, watermark))
