"""Static placements, lane-batched: the all-slow baseline (the paper's
Fig. 1 normalisation) and an oracle upper bound (true-count top-k,
instant migration)."""
from __future__ import annotations

import torch

from repro_torch.baselines.protocol import (LegacyPolicyAdapter, PolicySpec,
                                            lanes_of, ranked_take)
from repro_torch.kernels.interval_step import ops as interval_ops
from repro_torch.utils.pytree import tensor_dataclass


@tensor_dataclass
class StaticState:
    t: torch.Tensor           # i32 [B]


@tensor_dataclass
class AllSlowSpec(PolicySpec):
    name = "all-slow"

    def init(self, n_pages, k, machine):
        B, _, dev = lanes_of(machine)
        return StaticState(t=torch.zeros((B,), dtype=torch.int32,
                                         device=dev))

    def observe(self, state, observed):
        return state.replace(t=state.t + 1)

    def fires(self, state):
        return torch.zeros_like(state.t, dtype=torch.bool)

    def fire_period(self):
        return 0

    def pad_promote(self, n, k):
        return 1

    def pad_demote(self, n, k):
        return 1

    def policy(self, state, slow_bw, app_bw, k):
        empty = torch.full((state.t.shape[0], 1), -1, dtype=torch.int32,
                           device=state.t.device)
        return state, empty, empty


@tensor_dataclass
class OracleState:
    in_fast: torch.Tensor     # bool [B, n]
    last_obs: torch.Tensor    # f32 [B, n] this interval's TRUE counts
    t: torch.Tensor           # i32 [B]


@tensor_dataclass
class OracleSpec(PolicySpec):
    """Sees TRUE access counts and rebalances instantly — an upper bound on
    any sampling-based policy (migration traffic still charged)."""

    name = "oracle"
    wants_true_counts = True

    def pad_promote(self, n, k):
        return max(1, min(n, k))

    def pad_demote(self, n, k):
        return max(1, min(n, k))

    def init(self, n_pages, k, machine):
        B, _, dev = lanes_of(machine)
        return OracleState(
            in_fast=torch.zeros((B, n_pages), dtype=torch.bool, device=dev),
            last_obs=torch.zeros((B, n_pages), dtype=torch.float32,
                                 device=dev),
            t=torch.zeros((B,), dtype=torch.int32, device=dev))

    def observe(self, state, observed):
        return state.replace(last_obs=observed, t=state.t + 1)

    def policy(self, state, slow_bw, app_bw, k):
        B, n = state.last_obs.shape
        # lax.top_k's set, scattered into a mask: the top-k kernel's function
        target = interval_ops.topk_mask(state.last_obs.contiguous(), k)
        idx = torch.arange(n, dtype=torch.int32,
                           device=target.device).expand(B, n)
        promote, n_p = ranked_take(idx, target & ~state.in_fast,
                                   self.pad_promote(n, k))
        demote, _ = ranked_take(idx, ~target & state.in_fast,
                                self.pad_demote(n, k), n_p)
        return state.replace(in_fast=target), promote, demote


class AllSlowPolicy(LegacyPolicyAdapter):
    def __init__(self):
        super().__init__(AllSlowSpec())


class OraclePolicy(LegacyPolicyAdapter):
    def __init__(self):
        super().__init__(OracleSpec())
