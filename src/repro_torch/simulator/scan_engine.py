"""Interval scan engine + lane-batched sweeps, in torch, for every policy
family of the functional protocol (baselines/protocol.py).

The port of ``repro/simulator/scan_engine.py`` for trace replay.  One
replay walks the trace interval by interval in a Python loop (JAX's
``lax.scan``); every carried array has an explicit leading lane axis
``[B, ...]`` (JAX's ``vmap``).  Per interval: PEBS sampling from a
common-random-number field (or the true counts, for specs that want
them), the policy's observe/fires, the policy pass with the migrations on
intervals where some lane fires, and the interval cost model with the
oracle recall.  The hot path goes through the interval-step ops
(kernels/interval_step): ARMS's EWMA score update and top-k hot mask and
the oracle's top-k target inside the policy, the hop-chain migration
executor on fire intervals and the accounting every interval.

Two routes.  Binary specs (ARMS, HeMem, Memtis, TPP, all-slow, oracle)
emit promote/demote plans executed by the ``tier_migrate`` op.
Tier-native specs (HybridTier, Jenga, TierBPF) take the tier-targeted
route: the carry also holds the last interval's per-tier utilization
(``simjax.tier_utilization_impl``), the policy emits ``(pages, dst)``
moves through ``tier_policy`` and ``simjax.apply_targeted_migrations``
executes them (plain torch, as it is plain XLA in JAX); up-moves count as
promotions, down-moves as demotions.  ``tier_shim`` sends a binary spec
down that route through the protocol's shim, bit for bit the hop-chain
route.  TPP's hint-fault overhead (``slow_access_extra_ns``) is added to
each interval's wall in JAX's f32 order.  ``mixed_observation`` specs (the
union fabric's ``UnionSpec``, one family a lane) read the per-lane hooks
instead: the oracle lanes observe true counts and the others the shared
sampled row, and each lane's overhead is its own.

Entry points:
  * ``simulate``             — one run of any spec, SimResult output;
  * ``arms_sim``             — ARMS replay of a trace;
  * ``sweep_policy_configs`` — one lane per config of one policy family,
    all lanes sharing one CRN field;
  * ``sweep_arms_configs``   — ARMS knob grid; the two mode-dependent
    observation grids are computed once and shared by all lanes;
  * ``sweep_seeds``          — one lane per PRNG seed (sampling-noise
    study: each lane's noise from its own key, split every interval);
  * ``simulate_workload`` / ``sweep_workloads`` / ``sweep_workload_configs``
    — the trace-SYNTHESIS path: the loop carries ``WorkloadSpec`` state
    (simulator/workload_spec.py) and synthesizes ``true = work * probs``
    plus the oracle top-k mask (the ``topk_mask`` op on [W, n]) on the
    device each interval; per-lane storage is O(n), nothing ``[T, n]``
    exists on host or device.

Sampling modes: ``"crn"`` (a [T, n] uniform field, transformed per
interval with each lane's period), ``"pre"`` (precomputed [T, P, n]
observation grids), ``"prng"`` (per-lane threefry keys split every
interval, each lane's row drawn from its subkey) and ``"crn_prng"`` (one
row an interval from ``fold_in(noise_key, t)``, shared by every lane:
the synthesis default).  The keys and rows are JAX's bits
(utils/prng.py).  Reductions: ``"stack"`` ([B, T] timelines) and
``"stream"`` (running sums, nothing [T]-shaped).

The any-lane fire gate is a host branch on the spec's ``fire_flags``
(``do.any()``; a union's one flag a member, so members with no firing
lane skip their pass): on intervals where no lane's policy is due, the
policy pass and the migration executor are skipped (in JAX an all-``-1``
plan would execute nothing, so the outputs are the same).  The workload
event gate is decided on the host from the specs' integer leaves, so an
interval still syncs once.  Final [B] results are formed on the CPU.

``experiment.sweep`` (through ``fabric.sim_trace``/``sim_synth``)
drives ``_simulate`` with ``_TraceRows``/``_SynthRows`` and records its
passes with ``_record_dispatch``; those underscore helpers are shared
with exactly those two modules.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from repro_torch.baselines.arms_policy import SWEEPABLE, ARMSSpec
from repro_torch.core.state import ARMSConfig
from repro_torch.kernels.interval_step import ops as interval_ops
from repro_torch.simulator import (machine_spec, machines, simjax,
                                   workload_spec)
from repro_torch.simulator.engine import SimResult, oracle_topk_masks
from repro_torch.simulator.sampling import (_NORMAL_SWITCH,
                                            pebs_sample_from_uniform,
                                            synth_uniform_row, uniform_field)
from repro_torch.utils import prng
from repro_torch.utils.device import resolve_device
from repro_torch.utils.pytree import (bwhere, lane_specs, stack_specs,
                                      take_lanes)

__all__ = [
    "SWEEPABLE", "simulate", "arms_sim", "sweep_policy_configs",
    "sweep_arms_configs", "sweep_seeds", "simulate_workload",
    "sweep_workloads", "sweep_workload_configs", "last_dispatch",
    "count_dispatches", "DispatchCounter",
]

#: Info about the most recent engine pass (lanes, sampling mode, T,
#: lane_intervals).
last_dispatch: dict = {}


class DispatchCounter:
    """Live tally handed out by ``count_dispatches``: ``count`` passes so
    far, ``records`` their ``_record_dispatch`` info dicts in order."""

    def __init__(self):
        self.count = 0
        self.records: list = []

    @property
    def last(self) -> dict:
        return self.records[-1] if self.records else {}


#: counters open via ``count_dispatches`` (nested regions each see every
#: pass issued inside them).
_active_counters: list = []


@contextlib.contextmanager
def count_dispatches():
    """Context-managed pass counter:

        with scan_engine.count_dispatches() as ctr:
            scan_engine.sweep_workloads(...)
        assert ctr.count == 1 and ctr.last["lanes"] == W
    """
    ctr = DispatchCounter()
    _active_counters.append(ctr)
    try:
        yield ctr
    finally:
        _active_counters.remove(ctr)


def _need_normal(trace, min_period: float) -> bool:
    """Host: can any page's sampling rate reach the normal-approx regime?"""
    return bool(np.max(trace) / float(min_period) >= _NORMAL_SWITCH)


def _mach_lanes(machine, B: int, n: int, k: int, device):
    """One machine broadcast to B lanes -> (mach [B, ...], caps i32 [B, R])."""
    mach, caps = machine_spec.lane_stack([machines.get(machine)], n, k,
                                         device)
    idx = torch.zeros((B,), dtype=torch.long, device=device)
    return take_lanes(mach, idx), caps.index_select(0, idx)


#: intervals per chunk of ``_precompute_observations``: the sampling is
#: elementwise, so the chunking bounds the temporaries and changes no value
_OBS_ROWS = 256


def _precompute_observations(trace, u, periods: tuple, need_normal: bool):
    """[T, P, n] observation grids for a shared CRN field, one per period,
    computed ``_OBS_ROWS`` intervals at a time."""
    T, n = trace.shape
    obs = torch.empty((T, len(periods), n), dtype=torch.float32,
                      device=trace.device)
    pers = [torch.tensor(float(p), dtype=torch.float32, device=trace.device)
            for p in periods]
    for lo in range(0, T, _OBS_ROWS):
        hi = min(T, lo + _OBS_ROWS)
        for j, p in enumerate(pers):
            obs[lo:hi, j] = pebs_sample_from_uniform(
                u[lo:hi], trace[lo:hi], p, need_normal=need_normal)
    return obs


class _TraceRows:
    """True counts and oracle masks of a materialized trace, one [n] row
    an interval, expanded to the B lanes."""

    def __init__(self, trace, oracle, B: int):
        self.trace, self.oracle, self.B = trace, oracle, B
        self.T, self.n = trace.shape

    def rows(self, t: int):
        shape = (self.B, self.n)
        return self.trace[t][None].expand(shape), \
            self.oracle[t][None].expand(shape)


class _SynthRows:
    """Trace synthesis: the [W]-lane workload stack's rows ``true = work *
    probs`` (``workload_spec.Synth``) and their top-k oracle masks (the
    ``topk_mask`` op), each workload row feeding ``rep`` consecutive
    lanes (lane ``w * rep + b``).  ``widx`` (i64 [B]) instead gives each
    lane's workload by its global index, for padded or sharded lanes
    (fabric.py): a row gather, the same values as the repeat."""

    def __init__(self, wl, T: int, n: int, k: int, wl_key, with_boost: bool,
                 rep: int, widx=None):
        self.syn = workload_spec.Synth(wl, n, wl_key, with_boost, T)
        self.T, self.n, self.k, self.rep, self.widx = T, n, k, rep, widx

    def rows(self, t: int):
        true_w = self.syn.row(t)                               # [W, n]
        orc_w = interval_ops.topk_mask(true_w, self.k)
        if self.widx is not None:
            return (true_w.index_select(0, self.widx),
                    orc_w.index_select(0, self.widx))
        if self.rep == 1:
            return true_w, orc_w
        return (true_w.repeat_interleave(self.rep, 0),
                orc_w.repeat_interleave(self.rep, 0))


#: elements of one chunk of PRNG noise rows drawn at once
_NOISE_CHUNK = 1 << 22


class _NoiseRows:
    """PRNG noise rows, drawn a chunk of intervals at a time (the same
    bits as one draw an interval, in fewer launches).  ``"crn_prng"``:
    ``key [2]``, row t is ``synth_uniform_row(key, t)``, shared by every
    lane, [1, n].  ``"prng"``: ``keys [B, 2]``, split every interval
    (``prng.split_chain``), row t is each lane's subkey's draw, [B, n]."""

    def __init__(self, key, n: int, T: int, per_lane: bool):
        if per_lane:
            subs = prng.split_chain(key, T)                  # [T, B, 2]
            self.draw = lambda lo, hi: prng.uniform(subs[lo:hi], (n,))
        else:
            ts = torch.arange(T, device=key.device)
            self.draw = lambda lo, hi: synth_uniform_row(
                key, ts[lo:hi], n)[:, None]
        self.chunk = max(1, _NOISE_CHUNK // (key.numel() // 2 * n))
        self.lo, self.rows = 0, None

    def row(self, t: int):
        if self.rows is None or not self.lo <= t < self.lo + len(self.rows):
            self.lo = t
            self.rows = self.draw(t, t + self.chunk)
        return self.rows[t - self.lo]


def _simulate(spec, source, k: int, mach, caps, sample, sampling: str,
              need_normal: bool, reduce: str = "stack",
              tier_shim: bool = False):
    """Batched replay on ``caps``' device; returns a dict of [B] CPU
    results (+ [B, T] timelines under ``reduce="stack"``).

    ``spec`` is lane-batched, ``mach`` a TieredMachineSpec with [B, R]
    leaves and ``caps`` its resolved i32 [B, R] capacities.  ``source``
    gives each interval's true counts and oracle masks, [B, n] each: a
    materialized trace (``_TraceRows``) or the synthesis path
    (``_SynthRows``).  ``sample`` is the [T, n] uniform field (``"crn"``),
    the [T, P, n] observation grids (``"pre"``), the per-lane keys [B, 2]
    (``"prng"``) or the shared noise key [2] (``"crn_prng"``).
    Tier-native specs, and binary ones under ``tier_shim``, take the
    tier-targeted route (module docstring).
    """
    if reduce not in ("stack", "stream") or sampling not in (
            "crn", "pre", "prng", "crn_prng"):
        raise ValueError(f"reduce={reduce!r} / sampling={sampling!r}")
    T, n = source.T, source.n
    B = caps.shape[0]
    dev = caps.device
    f32, i32 = torch.float32, torch.int32
    R = caps.shape[-1]
    cls = type(spec)
    tn = cls.tier_native or tier_shim
    noise = (_NoiseRows(sample, n, T, sampling == "prng")
             if sampling in ("prng", "crn_prng") else None)

    state = spec.init(n, k, mach)
    tier = torch.full((B, n), R - 1, dtype=i32, device=dev)  # all at bottom
    promoted_at = torch.full((B, n), -(10 ** 9), dtype=i32, device=dev)
    demoted_at = torch.full((B, n), -(10 ** 9), dtype=i32, device=dev)
    zf = lambda: torch.zeros((B,), dtype=f32, device=dev)
    zi = lambda: torch.zeros((B,), dtype=i32, device=dev)
    slow_bw = torch.ones((B,), dtype=f32, device=dev)  # all pages start slow
    app_bw = zf()
    tier_util = torch.zeros((B, R), dtype=f32, device=dev)
    exec_time, acc_fast_total, acc_total, recall_sum = zf(), zf(), zf(), zf()
    promotions, demotions, wasteful = zi(), zi(), zi()
    zpair = torch.zeros((B, R - 1), dtype=i32, device=dev)
    slow_sum, hits_sum, mode_sum, promos_max = zf(), zf(), zi(), zi()
    ys = {"slow": [], "hits": [], "mode": [], "promos": []}
    # the policy mechanism's overhead a slow access, in JAX's f32 order:
    # wall + acc_slow * f32(extra) * f32(1e-9) / mlp
    # (mixed_observation: each lane's own, 0.0 a no-op on the wall's bits)
    mixed = cls.mixed_observation
    if mixed:
        extra = spec.slow_extra_lane(B, dev)
        wants_true = spec.wants_true_lane(B, dev)[:, None]
    else:
        extra = (torch.full((), cls.slow_access_extra_ns, dtype=f32,
                            device=dev)
                 if cls.slow_access_extra_ns else None)
    nano = torch.full((), 1e-9, dtype=f32, device=dev)

    for t in range(T):
        true_b, orc_b = source.rows(t)
        if cls.wants_true_counts:
            observed = true_b
        elif sampling == "pre":
            observed = sample[t].index_select(0, spec.obs_index(state).long())
        else:
            u = sample[t][None] if noise is None else noise.row(t)
            period = spec.sampling_period(state)[:, None]
            observed = pebs_sample_from_uniform(
                u, true_b, period, need_normal=need_normal)
            if mixed:
                # oracle lanes read true counts, the others keep the
                # sampled row the whole batch shares
                observed = torch.where(wants_true, true_b, observed)
        state = spec.observe(state, observed)
        do = spec.fires(state)                                   # [B]
        # the interval's one host sync
        fire = bool(spec.fire_flags(do).any())

        if fire and tn:
            st2, pages, dst = spec.tier_policy(state, tier_util, slow_bw,
                                               app_bw, k, caps)
            state = bwhere(do, st2, state)
            pages = torch.where(do[:, None], pages, -1)
            tier, up_exec, down_exec, mig_up, mig_down = \
                simjax.apply_targeted_migrations(tier, pages, dst, caps)
            waste, promoted_at, demoted_at = simjax.wasteful_update(
                t, promoted_at, demoted_at, pages, pages, up_exec, down_exec)
            n_promo = up_exec.sum(dim=1, dtype=i32)
            n_demo = down_exec.sum(dim=1, dtype=i32)
        elif fire:
            st2, promote, demote = spec.policy(state, slow_bw, app_bw, k)
            # lanes whose policy is not due keep their state; their plans
            # are blanked so no migrations execute.
            state = bwhere(do, st2, state)
            promote = torch.where(do[:, None], promote, -1)
            demote = torch.where(do[:, None], demote, -1)
            tier, pexec, dexec, mig_up, mig_down = interval_ops.tier_migrate(
                tier, promote, demote, caps)
            waste, promoted_at, demoted_at = simjax.wasteful_update(
                t, promoted_at, demoted_at, promote, demote, pexec, dexec)
            n_promo = pexec.sum(dim=1, dtype=i32)
            n_demo = dexec.sum(dim=1, dtype=i32)
        else:
            n_promo, n_demo, waste = zi(), zi(), zi()
            mig_up = mig_down = zpair
        acc_fast, acc_slow, wall, slow_share, app_raw, recall = \
            interval_ops.interval_account(mach, true_b, tier, mig_up.float(),
                                          mig_down.float(), orc_b, k)
        if extra is not None:
            # TPP's NUMA hint faults are taken on slow-tier accesses
            wall = wall + acc_slow * extra * nano / mach.mlp
        if tn:
            tier_util = simjax.tier_utilization_impl(
                mach, true_b, tier, mig_up.float(), mig_down.float())

        slow_bw = slow_share
        # consumer-side clamp of the raw tier-0 utilization: the policy
        # sees a signal in [0, 1].
        app_bw = torch.clamp_max(app_raw, 1.0)
        exec_time = exec_time + wall
        promotions = promotions + n_promo
        demotions = demotions + n_demo
        wasteful = wasteful + waste
        acc_fast_total = acc_fast_total + acc_fast
        acc_total = acc_total + acc_fast + acc_slow
        recall_sum = recall_sum + recall
        hits_val = acc_fast / torch.clamp_min(acc_fast + acc_slow, 1e-9)
        mode = spec.mode_of(state)
        if reduce == "stream":
            slow_sum = slow_sum + slow_share
            hits_sum = hits_sum + hits_val
            mode_sum = mode_sum + mode
            promos_max = torch.maximum(promos_max, n_promo)
        else:
            for key, v in (("slow", slow_share), ("hits", hits_val),
                           ("mode", mode), ("promos", n_promo)):
                ys[key].append(v)

    out = dict(
        exec_time=exec_time.cpu(), promotions=promotions.cpu(),
        demotions=demotions.cpu(), wasteful=wasteful.cpu(),
        hot_recall=recall_sum.cpu() / T,
        fast_hit_frac=acc_fast_total.cpu()
        / torch.clamp_min(acc_total.cpu(), 1e-9))
    if reduce == "stream":
        out.update(
            mean_slow_bw=slow_sum.cpu() / T,
            mean_fast_hits=hits_sum.cpu() / T,
            mean_mode=mode_sum.cpu().float() / T,
            max_promotions_interval=promos_max.cpu())
    else:
        out.update({f"timeline_{nm}": torch.stack(ys[key], dim=1).cpu()
                    for nm, key in (("slow_bw", "slow"), ("fast_hits", "hits"),
                                    ("mode", "mode"),
                                    ("promotions", "promos"))})
    return out


def _to_result(out, lane: int, name: str) -> SimResult:
    lane_out = {key: v[lane] for key, v in out.items()}
    res = SimResult(
        name=name,
        exec_time_s=float(lane_out["exec_time"]),
        promotions=int(lane_out["promotions"]),
        demotions=int(lane_out["demotions"]),
        wasteful=int(lane_out["wasteful"]),
        hot_recall=float(lane_out["hot_recall"]),
        fast_hit_frac=float(lane_out["fast_hit_frac"]))
    if "timeline_slow_bw" in lane_out:       # reduce="stack"
        res.timeline_slow_bw = lane_out["timeline_slow_bw"].numpy() \
            .astype(np.float64)
        res.timeline_fast_hits = lane_out["timeline_fast_hits"].numpy() \
            .astype(np.float64)
        res.timeline_mode = lane_out["timeline_mode"].numpy().astype(np.int32)
        res.timeline_promotions = lane_out["timeline_promotions"].numpy() \
            .astype(np.int32)
    else:                                    # reduce="stream" summaries
        res.mean_slow_bw = float(lane_out["mean_slow_bw"])
        res.mean_fast_hits = float(lane_out["mean_fast_hits"])
        res.mean_mode = float(lane_out["mean_mode"])
        res.max_promotions_interval = int(
            lane_out["max_promotions_interval"])
    return res


def _record_dispatch(**info):
    info["lane_intervals"] = int(info["lanes"]) * int(info["T"])
    last_dispatch.clear()
    last_dispatch.update(info)
    for ctr in _active_counters:
        ctr.count += 1
        ctr.records.append(dict(info))


def _inputs(trace, k: int, sample_u, device):
    """Host trace -> (trace f32, oracle bool, uniform field f32 or None) on
    the device, plus the host trace."""
    trace = np.asarray(trace, np.float32)
    T, n = trace.shape
    if not 0 < k <= n:
        raise ValueError(f"k={k} must lie in 1..{n}")
    oracle = oracle_topk_masks(trace, k)
    to = lambda a: torch.from_numpy(np.require(a, requirements="CW")).to(
        device)
    u = None
    if sample_u is not None:
        sample_u = np.asarray(sample_u, np.float32)
        if sample_u.shape != (T, n):
            raise ValueError(f"sample_u {sample_u.shape} != trace {(T, n)}")
        u = to(sample_u)
    return to(trace), to(oracle), u, trace


def _seed_keys(seeds, device):
    """[B, 2] threefry keys, ``jax.random.PRNGKey(s)`` for each seed."""
    return torch.stack([prng.PRNGKey(int(s), device) for s in seeds])


# ------------------------------------------------------------- public API
def simulate(spec, trace, machine, k: int, seed: int = 0, sample_u=None,
             name: str | None = None, tier_shim: bool = False,
             device=None) -> SimResult:
    """Replay of ``trace`` [T, n] under any policy spec; ``machine`` is a
    registry name / MachineSpec / TieredMachineSpec.  ``sample_u`` [T, n]
    (``sampling.uniform_field``) selects CRN sampling; without it the PEBS
    noise is drawn from ``PRNGKey(seed)``, split every interval (JAX's
    default, bit for bit).  ``tier_shim=True`` sends a binary spec through
    the tier-targeted executor via the protocol's shim (bit for bit the
    hop-chain route)."""
    dev = resolve_device(device)
    trace_d, oracle, u, trace = _inputs(trace, k, sample_u, dev)
    T, n = trace.shape
    mach, caps = _mach_lanes(machine, 1, n, k, dev)
    sampling = "crn" if u is not None else "prng"
    sample = u if u is not None else _seed_keys([seed], dev)
    out = _simulate(lane_specs(spec, 1).to(dev),
                    _TraceRows(trace_d, oracle, 1), k, mach, caps, sample,
                    sampling,
                    _need_normal(trace, spec.min_sampling_period()),
                    tier_shim=tier_shim)
    _record_dispatch(lanes=1, sampling=sampling, policy=spec.name, T=T,
                     reduce="stack", device=str(dev))
    return _to_result(out, 0, name or spec.name)


def sweep_seeds(trace, machine, k: int, seeds, cfg: ARMSConfig | None = None,
                spec=None, device=None) -> list[SimResult]:
    """One lane per PRNG seed (``"prng"`` sampling): every seed's replay
    runs in lockstep in the lane axis.  Defaults to ARMS (``cfg``); pass
    any ``spec`` for a baseline."""
    if spec is None:
        spec = ARMSSpec.make(base_cfg=cfg)
    elif cfg is not None:
        raise ValueError("pass either cfg (ARMS) or spec, not both")
    seeds = list(seeds)
    if not seeds:
        raise ValueError("sweep_seeds needs at least one seed")
    dev = resolve_device(device)
    trace_d, oracle, _, trace = _inputs(trace, k, None, dev)
    T, n = trace.shape
    B = len(seeds)
    mach, caps = _mach_lanes(machine, B, n, k, dev)
    out = _simulate(lane_specs(spec, B).to(dev),
                    _TraceRows(trace_d, oracle, B), k, mach, caps,
                    _seed_keys(seeds, dev), "prng",
                    _need_normal(trace, spec.min_sampling_period()))
    _record_dispatch(lanes=B, sampling="prng", policy=spec.name, T=T,
                     reduce="stack", device=str(dev))
    return [_to_result(out, i, f"{spec.name}[seed={s}]")
            for i, s in enumerate(seeds)]


def sweep_policy_configs(spec_family, trace, machine, k: int, configs,
                         sim_seed: int = 0, sample_u=None, device=None
                         ) -> list[SimResult]:
    """Lane-batched sweep over one policy family's knob grid:
    ``spec_family`` maps a config dict to a spec (e.g. ``HeMemSpec.make``),
    one lane per config.  All lanes share ONE CRN field (``sample_u`` or
    ``uniform_field(T, n, seed=sim_seed)``), so config comparisons are
    paired."""
    configs = list(configs)
    if not configs:
        raise ValueError("sweep_policy_configs needs at least one config")
    specs = [spec_family(**cfg) for cfg in configs]
    dev = resolve_device(device)
    trace = np.asarray(trace, np.float32)
    T, n = trace.shape
    if sample_u is None:
        sample_u = uniform_field(T, n, seed=sim_seed)
    trace_d, oracle, u, trace = _inputs(trace, k, sample_u, dev)
    min_period = min(s.min_sampling_period() for s in specs)
    B = len(configs)
    mach, caps = _mach_lanes(machine, B, n, k, dev)
    out = _simulate(stack_specs(specs).to(dev),
                    _TraceRows(trace_d, oracle, B), k, mach, caps, u, "crn",
                    _need_normal(trace, min_period))
    _record_dispatch(lanes=B, sampling="crn", policy=specs[0].name, T=T,
                     reduce="stack", device=str(dev))
    return [_to_result(out, i, f"{specs[0].name}[{lbl}]")
            for i, lbl in enumerate(_cfg_labels(configs))]


def _cfg_labels(configs) -> list[str]:
    return [",".join(f"{nm}={v:.6g}" for nm, v in sorted(cfg.items()))
            for cfg in configs]


def arms_sim(trace, machine, k: int, cfg: ARMSConfig | None = None,
             seed: int = 0, sample_u=None, name: str = "arms",
             device=None) -> SimResult:
    """ARMS replay of ``trace``: CRN sampling with ``sample_u``, else PRNG
    sampling from ``PRNGKey(seed)``."""
    return simulate(ARMSSpec.make(base_cfg=cfg), trace, machine, k,
                    seed=seed, sample_u=sample_u, name=name, device=device)


def sweep_arms_configs(trace, machine, k: int, overrides: dict,
                       base_cfg: ARMSConfig | None = None, seed: int = 0,
                       sample_u=None, reduce: str = "stack", device=None
                       ) -> list[SimResult]:
    """Batched ARMS runs over a grid of float knob settings.

    ``overrides`` maps ARMSConfig float field names to equal-length value
    lists; row b of every list forms config b.  All configs share one CRN
    field (``sample_u`` or ``uniform_field(T, n, seed=seed)``), so the
    per-mode observation grids (``ARMSSpec.PRE_PERIODS``) are computed
    once and shared by every lane.  ``reduce="stream"`` drops the
    ``timeline_*`` stacks (the scalars are identical).
    """
    names = tuple(sorted(overrides))
    if not names:
        raise ValueError("overrides must name at least one ARMSConfig knob")
    B = len(overrides[names[0]])
    if B == 0 or any(len(overrides[nm]) != B for nm in names):
        raise ValueError(
            "override value lists must be non-empty and of equal length; "
            f"got {({nm: len(overrides[nm]) for nm in names})}")
    specs = [ARMSSpec.make({nm: overrides[nm][b] for nm in names},
                           base_cfg=base_cfg) for b in range(B)]
    dev = resolve_device(device)
    trace = np.asarray(trace, np.float32)
    T, n = trace.shape
    if sample_u is None:
        sample_u = uniform_field(T, n, seed=seed)
    trace_d, oracle, u, trace = _inputs(trace, k, sample_u, dev)
    need_normal = _need_normal(trace, specs[0].min_sampling_period())
    obs = _precompute_observations(trace_d, u, ARMSSpec.PRE_PERIODS,
                                   need_normal)
    del u
    mach, caps = _mach_lanes(machine, B, n, k, dev)
    out = _simulate(stack_specs(specs).to(dev),
                    _TraceRows(trace_d, oracle, B), k, mach, caps, obs, "pre",
                    need_normal, reduce=reduce)
    _record_dispatch(lanes=B, sampling="pre", policy="arms", T=T,
                     reduce=reduce, device=str(dev))
    labels = [",".join(f"{nm}={float(overrides[nm][b]):.4g}" for nm in names)
              for b in range(B)]
    return [_to_result(out, i, f"arms[{lbl}]")
            for i, lbl in enumerate(labels)]


# --------------------------------------------- trace synthesis (workloads)
def _stack_workloads(wl_specs, device):
    """Stack WorkloadSpecs into one [W]-lane spec (component-count padded)."""
    S = max(sp.n_components for sp in wl_specs)
    return stack_specs([workload_spec.pad_components(sp, S)
                        for sp in wl_specs]).to(device)


def _synth_need_normal(wl_specs, min_period: float) -> bool:
    """Host bound for synthesis: can any page's sampling rate reach the
    normal-approx regime?  From the specs' work bound (probs <= 1), so it
    may be conservatively True; the sampler's selected values are the same
    either way."""
    return max(sp.max_rate() for sp in wl_specs) / float(min_period) \
        >= _NORMAL_SWITCH


def _synth(spec, workloads, k: int, T: int, n: int, machine, rep: int,
           sim_seed: int, wl_seed: int, sample_u, min_period: float,
           device):
    """One synthesized pass: ``spec`` lane-batched over ``len(workloads) *
    rep`` lanes, workload ``w`` feeding lanes ``w * rep .. w * rep + rep
    - 1``.  Returns (out, sampling)."""
    if not 0 < k <= n:
        raise ValueError(f"k={k} must lie in 1..{n}")
    dev = resolve_device(device)
    B = len(workloads) * rep
    if sample_u is not None:
        sample_u = np.asarray(sample_u, np.float32)
        if sample_u.shape != (T, n):
            raise ValueError(f"sample_u {sample_u.shape} != {(T, n)}")
        sample, sampling = torch.from_numpy(
            np.require(sample_u, requirements="CW")).to(dev), "crn"
    else:
        sample, sampling = prng.PRNGKey(sim_seed, dev), "crn_prng"
    source = _SynthRows(_stack_workloads(workloads, dev), T, n, k,
                        prng.PRNGKey(wl_seed, dev),
                        any(w.has_boost() for w in workloads), rep)
    mach, caps = _mach_lanes(machine, B, n, k, dev)
    out = _simulate(spec.to(dev), source, k, mach, caps, sample, sampling,
                    _synth_need_normal(workloads, min_period))
    return out, sampling


def simulate_workload(spec, workload, machine, k: int, T: int, n: int,
                      sim_seed: int = 0, wl_seed: int = 0, sample_u=None,
                      name: str | None = None, device=None) -> SimResult:
    """Replay of a ``WorkloadSpec`` synthesized on the device under any
    policy: ``true = work * probs`` and the oracle mask each interval,
    nothing [T, n] anywhere.  Under the same seeds the run is bit for bit
    the replay of ``workload.materialize(T, n, wl_seed)`` with the
    ``sampling.synth_noise_field(T, n, sim_seed)`` CRN field (or with
    ``sample_u`` if given)."""
    out, sampling = _synth(lane_specs(spec, 1), [workload], k, T, n,
                           machine, 1, sim_seed, wl_seed, sample_u,
                           spec.min_sampling_period(), device)
    _record_dispatch(lanes=1, sampling=sampling, policy=spec.name,
                     synth=True, workloads=1, configs=1, T=T,
                     reduce="stack", device=str(resolve_device(device)))
    label = name or f"{spec.name}@{workload_spec.label_of(workload)}"
    return _to_result(out, 0, label)


def _wl_names(workloads, names):
    return list(names) if names is not None else [
        workload_spec.label_of(w, f"wl{i}") for i, w in enumerate(workloads)]


def sweep_workloads(workloads, machine, k: int, T: int, n: int,
                    cfg: ARMSConfig | None = None, spec=None,
                    sim_seed: int = 0, wl_seed: int = 0, names=None,
                    device=None) -> list[SimResult]:
    """One policy across W workload lanes in one pass.  Every lane
    synthesizes its own trace on the device and all lanes share the
    counter-based CRN rows, so workload comparisons are paired.  Defaults
    to ARMS (``cfg``); pass any policy ``spec`` for a baseline."""
    if spec is None:
        spec = ARMSSpec.make(base_cfg=cfg)
    elif cfg is not None:
        raise ValueError("pass either cfg (ARMS) or spec, not both")
    workloads = list(workloads)
    if not workloads:
        raise ValueError("sweep_workloads needs at least one workload")
    W = len(workloads)
    names = _wl_names(workloads, names)
    out, _ = _synth(lane_specs(spec, W), workloads, k, T, n, machine, 1,
                    sim_seed, wl_seed, None, spec.min_sampling_period(),
                    device)
    _record_dispatch(lanes=W, sampling="crn_prng", policy=spec.name,
                     synth=True, workloads=W, configs=1, T=T,
                     reduce="stack", device=str(resolve_device(device)))
    return [_to_result(out, i, f"{spec.name}@{nm}")
            for i, nm in enumerate(names)]


def sweep_workload_configs(spec_family, configs, workloads, machine, k: int,
                           T: int, n: int, sim_seed: int = 0,
                           wl_seed: int = 0, sample_u=None, names=None,
                           device=None) -> list[list[SimResult]]:
    """W workloads x B configs as one pass of W*B lanes: lane ``w * B + b``
    scores config ``b`` on workload ``w``; each workload is synthesized
    once an interval and feeds its B config lanes.  All lanes share the
    CRN rows (counter-based by default, or ``sample_u``).  Returns
    ``out[w][b]``."""
    configs = list(configs)
    workloads = list(workloads)
    if not configs or not workloads:
        raise ValueError("sweep_workload_configs needs >=1 config and "
                         ">=1 workload")
    W, B = len(workloads), len(configs)
    names = _wl_names(workloads, names)
    pol_specs = [spec_family(**cfg) for cfg in configs]
    lane_spec = stack_specs([pol_specs[b] for _ in range(W)
                             for b in range(B)])
    out, sampling = _synth(lane_spec, workloads, k, T, n, machine, B,
                           sim_seed, wl_seed, sample_u,
                           min(s.min_sampling_period() for s in pol_specs),
                           device)
    _record_dispatch(lanes=W * B, sampling=sampling,
                     policy=pol_specs[0].name, synth=True, workloads=W,
                     configs=B, T=T, reduce="stack",
                     device=str(resolve_device(device)))
    labels = _cfg_labels(configs)
    return [[_to_result(out, w * B + b,
                        f"{pol_specs[b].name}@{names[w]}[{labels[b]}]")
             for b in range(B)] for w in range(W)]
