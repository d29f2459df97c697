"""HeMem baseline (Raybuck et al., SOSP'21) — static-threshold tiering,
lane-batched.

  * per-page sample counts accumulate until a cooling event (any page's
    count reaching ``cooling_threshold`` halves all counts);
  * a page is hot iff its count >= ``hot_threshold`` (static);
  * a migration pass runs every ``migration_period`` intervals;
  * migration is serial and FIFO in hot-page discovery order (head-of-line
    blocking, paper §3.2);
  * cold pages are demoted only to make room.

The knobs of the paper's tuning study are leaves of ``HeMemSpec``, so a
tuning grid runs as lanes of one engine pass.
"""
from __future__ import annotations

import torch

from repro_torch.baselines.protocol import (LegacyPolicyAdapter, PolicySpec,
                                            capacity_victims, knob,
                                            knob_period, lanes_of, ranked_take,
                                            scatter_set, truncate_ranked)
from repro_torch.utils.pytree import tensor_dataclass

# Default knob values from the HeMem implementation (paper §2/§3.1).
DEFAULTS = dict(hot_threshold=8.0, cooling_threshold=18.0,
                migration_period=5, sample_period=10_000.0)


@tensor_dataclass
class HeMemState:
    counts: torch.Tensor         # f32 [B, n] cooled sample counts
    in_fast: torch.Tensor        # bool [B, n] policy's residency belief
    first_hot: torch.Tensor      # f32 [B, n] FIFO discovery order (inf:
                                 # not hot)
    t: torch.Tensor              # i32 [B] interval counter
    cooling_events: torch.Tensor  # i32 [B]


@tensor_dataclass(meta=("migration_limit",))
class HeMemSpec(PolicySpec):
    hot_threshold: torch.Tensor
    cooling_threshold: torch.Tensor
    migration_period: torch.Tensor    # i32
    sample_period: torch.Tensor
    migration_limit: int = 12  # serial: ~120 pages/s at 100 ms intervals

    name = "hemem"

    @classmethod
    def make(cls, hot_threshold=None, cooling_threshold=None,
             migration_period=None, sample_period=None,
             migration_limit: int = 12) -> "HeMemSpec":
        f32, i32 = torch.float32, torch.int32
        return cls(
            hot_threshold=knob(hot_threshold, "hot_threshold", DEFAULTS, f32),
            cooling_threshold=knob(cooling_threshold, "cooling_threshold",
                                   DEFAULTS, f32),
            migration_period=knob(migration_period, "migration_period",
                                  DEFAULTS, i32),
            sample_period=knob(sample_period, "sample_period", DEFAULTS, f32),
            migration_limit=migration_limit)

    def init(self, n_pages, k, machine):
        B, _, dev = lanes_of(machine)
        return HeMemState(
            counts=torch.zeros((B, n_pages), dtype=torch.float32, device=dev),
            in_fast=torch.zeros((B, n_pages), dtype=torch.bool, device=dev),
            first_hot=torch.full((B, n_pages), float("inf"),
                                 dtype=torch.float32, device=dev),
            t=torch.zeros((B,), dtype=torch.int32, device=dev),
            cooling_events=torch.zeros((B,), dtype=torch.int32, device=dev))

    def sampling_period(self, state):
        return self.sample_period.float()

    def min_sampling_period(self):
        return float(self.sample_period.min())

    def observe(self, state, observed):
        t = state.t + 1
        counts = state.counts + observed
        # cooling: triggered when any page reaches the cooling threshold.
        cool = counts.amax(dim=1) >= self.cooling_threshold
        counts = torch.where(cool[:, None], counts * 0.5, counts)
        hot = counts >= self.hot_threshold[:, None]
        newly_hot = hot & torch.isinf(state.first_hot)
        first_hot = torch.where(newly_hot, t.float()[:, None],
                                state.first_hot)
        first_hot = torch.where(hot, first_hot, float("inf"))
        return state.replace(
            counts=counts, first_hot=first_hot, t=t,
            cooling_events=state.cooling_events + cool.to(torch.int32))

    def fires(self, state):
        period = torch.clamp_min(self.migration_period.to(torch.int32), 1)
        return (state.t % period) == 0

    def fire_period(self):
        return knob_period(self.migration_period)

    def policy(self, state, slow_bw, app_bw, k):
        n = state.counts.shape[1]
        hot = state.counts >= self.hot_threshold[:, None]
        want, n_want = ranked_take(                        # FIFO order
            state.first_hot, hot & ~state.in_fast,
            self.pad_promote(n, k), self.migration_limit)
        # without enough cold victims, promotions stall (paper §3.2
        # "Inaccurate cooling threshold": no cold pages left in DRAM).
        victims, _, n_take = capacity_victims(
            state.in_fast, state.counts, state.in_fast & ~hot, n_want, k,
            self.pad_demote(n, k))
        promote = truncate_ranked(want, n_take)
        in_fast = scatter_set(state.in_fast, victims, False)
        in_fast = scatter_set(in_fast, promote, True)
        return state.replace(in_fast=in_fast), promote, victims


class HeMemPolicy(LegacyPolicyAdapter):
    """HeMem for the numpy reference engine (functional spec underneath).

    Subclasses may override the ``migration_limit`` class attribute; it is
    forwarded into the spec."""

    migration_limit = 12

    def __init__(self, hot_threshold=None, cooling_threshold=None,
                 migration_period=None, sample_period=None):
        super().__init__(HeMemSpec.make(
            hot_threshold, cooling_threshold, migration_period,
            sample_period, migration_limit=type(self).migration_limit))
