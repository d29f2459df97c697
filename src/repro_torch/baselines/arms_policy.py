"""ARMS as a simulator policy (the paper's system, §4-5), lane-batched.

``ARMSSpec`` is the functional-protocol spec: pure init/observe/fires/
policy over tensor-dataclass state, with the ARMSConfig float knobs under
sweep (``cfg_names``/``cfg_vals``) as leaves, so a tuning grid runs as
lanes of one engine pass.  ``ARMSServeSpec`` is ARMS as the serving
pools run it (``tiering/tiered_pool.py``).  The numpy engine's
``ARMSPolicy`` waits.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.baselines.protocol import PolicySpec
from repro_torch.core.controller import (MODE_SAMPLING_PERIODS,
                                         SAMPLING_PERIOD_RECENCY,
                                         arms_step_impl, policy_every,
                                         sampling_period)
from repro_torch.core.scheduler import observe_migration_cost
from repro_torch.core.state import (MODE_RECENCY, ARMSConfig, TieringState,
                                    init_state)
from repro_torch.utils.pytree import tensor_dataclass

# ARMSConfig float knobs that may be swept per lane.  Shape-determining
# ints (bs_max) stay static.
SWEEPABLE = frozenset({
    "alpha_s", "alpha_l", "w_s_history", "w_l_history", "w_s_recency",
    "w_l_recency", "pht_delta", "pht_lambda", "stabilize_eps", "noise_z",
    "latency_fast_us", "latency_slow_us", "access_scale",
    "migrate_cost_alpha", "init_promo_cost_us", "init_demo_cost_us",
})


@tensor_dataclass
class ARMSRunState:
    inner: TieringState
    buf: torch.Tensor       # f32 [B, n] counts accumulated since last run
    t: torch.Tensor         # i32 [B] simulator-interval counter
    promo_us: torch.Tensor  # f32 [B] per-page migration latencies for the
    demo_us: torch.Tensor   # §4.3 self-calibration feedback


@tensor_dataclass(meta=("cfg_names", "base_cfg"))
class ARMSSpec(PolicySpec):
    """``cfg_vals[..., i]`` overrides ARMSConfig field ``cfg_names[i]``.
    ``make`` gives one spec (``cfg_vals`` [m]); the engine works on lane
    stacks (``cfg_vals`` [B, m], ``utils.pytree.stack_specs``)."""

    cfg_vals: torch.Tensor = dataclasses.field(
        default_factory=lambda: torch.zeros((0,), dtype=torch.float32))
    cfg_names: tuple = ()
    base_cfg: ARMSConfig = ARMSConfig()

    name = "arms"
    #: mode-indexed sampling periods for precomputed CRN observation grids
    PRE_PERIODS = MODE_SAMPLING_PERIODS

    @classmethod
    def make(cls, overrides: dict | None = None,
             base_cfg: ARMSConfig | None = None) -> "ARMSSpec":
        overrides = overrides or {}
        bad = set(overrides) - SWEEPABLE
        if bad:
            raise ValueError(
                f"non-sweepable ARMSConfig fields {sorted(bad)}; sweepable: "
                f"{sorted(SWEEPABLE)}")
        names = tuple(sorted(overrides))
        vals = torch.tensor([float(overrides[nm]) for nm in names],
                            dtype=torch.float32)
        return cls(cfg_vals=vals, cfg_names=names,
                   base_cfg=base_cfg or ARMSConfig())

    def cfg(self) -> ARMSConfig:
        """The lanes' config: each swept field a f32 [B] tensor."""
        if not self.cfg_names:
            return self.base_cfg
        return dataclasses.replace(
            self.base_cfg,
            **{nm: self.cfg_vals[:, i] for i, nm in enumerate(self.cfg_names)})

    def pad_promote(self, n, k):
        return max(1, min(n, self.base_cfg.bs_max))

    pad_demote = pad_promote

    def init(self, n_pages, k, machine):
        """``machine``: lane-batched TieredMachineSpec ([B, R] leaves)."""
        B = machine.lat_ns.shape[0]
        dev = machine.lat_ns.device
        return ARMSRunState(
            inner=init_state(B, n_pages, self.cfg(), dev),
            buf=torch.zeros((B, n_pages), dtype=torch.float32, device=dev),
            t=torch.zeros((B,), dtype=torch.int32, device=dev),
            promo_us=machine.promo_path_us().float(),
            demo_us=machine.demo_path_us().float())

    def observe(self, state, observed):
        return state.replace(buf=state.buf + observed, t=state.t + 1)

    def fires(self, state):
        return (state.t % policy_every(state.inner.mode)) == 0

    def sampling_period(self, state):
        return sampling_period(state.inner.mode).float()

    def min_sampling_period(self):
        return float(SAMPLING_PERIOD_RECENCY)

    def mode_of(self, state):
        return state.inner.mode

    def obs_index(self, state):
        """Index into the PRE_PERIODS observation grids ("pre" sampling)."""
        return (state.inner.mode == MODE_RECENCY).to(torch.int32)

    def policy(self, state, slow_bw, app_bw, k):
        cfg = self.cfg()
        # normalize accumulated counts to per-interval rate so the EWMA
        # scale is mode-independent (500ms vs 100ms policy cadence, §5).
        every = policy_every(state.inner.mode).float()
        counts = state.buf / every[:, None]
        inner, plan = arms_step_impl(state.inner, counts, slow_bw, app_bw,
                                     cfg=cfg, k=k)
        # §4.3: self-calibrating migration-cost feedback, in the lanes that
        # migrate this pass.
        fed = observe_migration_cost(inner, state.promo_us, state.demo_us,
                                     cfg)
        moved = plan.count > 0
        inner = inner.replace(
            promo_cost=torch.where(moved, fed.promo_cost, inner.promo_cost),
            demo_cost=torch.where(moved, fed.demo_cost, inner.demo_cost))
        promote = torch.where(plan.valid, plan.promote, -1).to(torch.int32)
        demote = torch.where(plan.valid & (plan.demote >= 0), plan.demote,
                             -1).to(torch.int32)
        state = state.replace(inner=inner, buf=torch.zeros_like(state.buf))
        return state, promote, demote


@tensor_dataclass(meta=("cfg_names", "base_cfg", "pool_every"))
class ARMSServeSpec(ARMSSpec):
    """ARMS exactly as the serving layer runs it: RAW accumulated counts
    (no per-interval normalization), a FIXED ``pool_every`` cadence (not
    the mode-dependent 5/1 simulator cadence), and no §4.3 migration-cost
    feedback.  The port of ``repro/baselines/arms_policy.py``'s
    ``ARMSServeSpec``; a serving pool drives one lane (``B = 1``)."""

    pool_every: int = 8

    @classmethod
    def make_serving(cls, base_cfg: ARMSConfig,
                     pool_every: int) -> "ARMSServeSpec":
        return dataclasses.replace(cls.make(base_cfg=base_cfg),
                                   pool_every=int(pool_every))

    def fires(self, state):
        # observe() increments t first, so the first fire lands on
        # interval pool_every.
        return (state.t % self.pool_every) == 0

    def fires_at(self, t: int) -> bool:
        """``fires`` for a host-side count of observed intervals: the
        cadence is fixed, so the pool decides without a device sync."""
        return t % self.pool_every == 0

    def sampling_period(self, state):
        return torch.full_like(state.t, self.DEFAULT_SAMPLE_PERIOD,
                               dtype=torch.float32)

    def policy(self, state, slow_bw, app_bw, k):
        # raw counts, no normalization, no migration-cost feedback
        inner, plan = arms_step_impl(state.inner, state.buf, slow_bw,
                                     app_bw, cfg=self.cfg(), k=k)
        promote = torch.where(plan.valid, plan.promote, -1).to(torch.int32)
        demote = torch.where(plan.valid & (plan.demote >= 0), plan.demote,
                             -1).to(torch.int32)
        state = state.replace(inner=inner, buf=torch.zeros_like(state.buf))
        return state, promote, demote
