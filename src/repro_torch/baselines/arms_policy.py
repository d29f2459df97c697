"""ARMS as a simulator policy (the paper's system, §4-5), lane-batched.

``ARMSSpec`` is the functional-protocol spec: pure init/observe/fires/
policy over tensor-dataclass state, with the ARMSConfig float knobs under
sweep (``cfg_names``/``cfg_vals``) as leaves, so a tuning grid runs as
lanes of one engine pass.  ``ARMSServeSpec`` is ARMS as the serving
pools run it (``tiering/tiered_pool.py``).  ``ARMSPolicy`` is the
hand-tuned stateful wrapper for the numpy reference engine: ARMS's
sampling period and cadence follow its mode, so the generic
``LegacyPolicyAdapter`` would read them from the device every interval,
while this wrapper caches them on the host and refreshes them once a
policy pass (the mode changes only inside ``arms_step_impl``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.baselines.base import Policy
from repro_torch.baselines.protocol import PolicySpec
from repro_torch.core.controller import (MODE_SAMPLING_PERIODS,
                                         POLICY_EVERY_HISTORY,
                                         POLICY_EVERY_RECENCY,
                                         SAMPLING_PERIOD_HISTORY,
                                         SAMPLING_PERIOD_RECENCY,
                                         arms_step_impl, policy_every,
                                         sampling_period)
from repro_torch.core.scheduler import observe_migration_cost
from repro_torch.core.state import (MODE_HISTORY, MODE_RECENCY, ARMSConfig,
                                    TieringState, init_state)
from repro_torch.utils.device import f32_on, resolve_device
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
    dynamic_sampling_period = True
    has_mode = True
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

    def fire_period(self):
        return None     # 5 intervals in history mode, 1 in recency mode

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

    dynamic_sampling_period = False

    @classmethod
    def make_serving(cls, base_cfg: ARMSConfig,
                     pool_every: int) -> "ARMSServeSpec":
        return dataclasses.replace(cls.make(base_cfg=base_cfg),
                                   pool_every=int(pool_every))

    def fires(self, state):
        # observe() increments t first, so the first fire lands on
        # interval pool_every.
        return (state.t % self.pool_every) == 0

    def fire_period(self):
        return self.pool_every

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


class ARMSPolicy(Policy):
    """ARMS for the numpy reference engine: the controller on one lane of
    the device ``reset`` names, its cadence and sampling period cached on
    the host (module docstring)."""

    name = "arms"

    def __init__(self, cfg: ARMSConfig | None = None):
        self.base_cfg = cfg or ARMSConfig()

    @property
    def migration_limit(self):  # batched migrations: up to BS_max a pass
        return self.base_cfg.bs_max

    def reset(self, n_pages, k, machine, device=None):
        from repro_torch.simulator import machines
        machine = machines.get(machine)
        self.device = resolve_device(device)
        self.n, self.k = n_pages, k
        self.cfg = self.base_cfg
        self.state = init_state(1, n_pages, self.cfg, self.device)
        self.buf = torch.zeros((n_pages,), dtype=torch.float64,
                               device=self.device)
        self.t = 0
        # f32 path sums over the pairs, as ARMSSpec.init
        path = lambda pair_us: torch.full(
            (1,), float(np.sum(np.asarray(pair_us, np.float32))),
            dtype=torch.float32, device=self.device)
        self._promo_us = path(machine.promo_pair_us)
        self._demo_us = path(machine.demo_pair_us)
        self._set_mode(MODE_HISTORY)

    def _set_mode(self, mode: int):
        """Host-side cadence cache, refreshed once per policy invocation."""
        self._mode = int(mode)
        recency = self._mode == MODE_RECENCY
        self._every = POLICY_EVERY_RECENCY if recency else POLICY_EVERY_HISTORY
        self._period = float(SAMPLING_PERIOD_RECENCY if recency
                             else SAMPLING_PERIOD_HISTORY)

    def sampling_period(self):
        return self._period

    def step(self, observed, slow_bw_frac, app_bw_frac):
        self.t += 1
        self.buf += observed
        every = self._every
        if self.t % every:
            return np.empty(0, np.int64), np.empty(0, np.int64)

        # normalize accumulated counts to per-interval rate so the EWMA
        # scale is mode-independent (500ms vs 100ms policy cadence, §5):
        # f32 in, f32 divide, by a tensor (a Python divisor becomes a
        # multiply by its reciprocal on the card).
        counts = self.buf.float() / f32_on(every, self.device)
        f32 = lambda v: torch.full((1,), float(v), dtype=torch.float32,
                                   device=self.device)
        self.state, plan = arms_step_impl(
            self.state, counts[None], f32(slow_bw_frac), f32(app_bw_frac),
            cfg=self.cfg, k=self.k)
        self.buf.zero_()
        # one copy to the host: the plan and the new mode
        host = torch.cat([plan.promote[0], plan.demote[0],
                          plan.valid[0].to(torch.int32),
                          self.state.mode]).cpu().numpy().astype(np.int64)
        P = plan.promote.shape[1]
        valid = host[2 * P:3 * P].astype(bool)
        promote = host[:P][valid]
        demote = host[P:2 * P][valid]
        demote = demote[demote >= 0]
        if len(promote):   # §4.3: self-calibrating migration-cost feedback
            self.state = observe_migration_cost(
                self.state, self._promo_us, self._demo_us, self.cfg)
        self._set_mode(host[-1])
        return promote, demote

    @property
    def mode(self) -> int:
        return self._mode
