"""Functional policy protocol, lane-batched: pure functions over tensor
dataclass state, with an explicit leading lane axis on every leaf.

    state = spec.init(n_pages, k, machine)       # machine: [B, R] leaves
    state = spec.observe(state, observed)        # cheap, every interval
    fire  = spec.fires(state)                    # bool [B]
    state, promote, demote = spec.policy(state, slow_bw, app_bw, k)
    state, promote, demote = spec.step(state, observed, slow_bw, app_bw, k)

Padded-index contract: ``promote``/``demote`` are fixed-shape i32
``[B, pad]`` arrays of widths ``spec.pad_promote(n, k)`` /
``spec.pad_demote(n, k)``; ``-1`` entries are padding, the others page
indices in priority order, unique within a lane.  The engine executes
demotions first, then promotions capped by free capacity
(``simjax.apply_tier_migrations``).

Tier-native contract: specs with ``tier_native`` implement ``tier_policy``
and see the whole tier chain,

    state, pages, dst = spec.tier_policy(
        state, tier_util, slow_bw, app_bw, k, caps)

with ``tier_util`` f32 [B, R] the last interval's per-tier utilization
(``simjax.tier_utilization_impl``) and ``caps`` i32 [B, R]; ``pages``/
``dst`` are ``pad_moves(n, k)``-wide tier-targeted moves (down-moves
first, then up-moves; ``simjax.DST_BELOW`` asks for the hop-chain
cascade), executed by ``simjax.apply_targeted_migrations``.  Per-pair
budgets come from ``scheduler.pair_budgets`` and are enforced policy-side
by ``tier_plan``/``pair_limit``, so the policy's residency belief stays
exact.  The base ``tier_policy`` is the binary shim: demotions with
``DST_BELOW``, then promotions with destination 0, which the targeted
executor runs bit for bit as the hop-chain route.

Ranking: ``ranked_take`` follows ``lax.top_k`` on ``where(mask, -key,
-inf)`` (larger first, +0.0 above -0.0, lower index first among ties)
through ``costbenefit.ranked_top``; ``rank_desc`` follows ``jnp.argsort``,
a stable sort whose comparator makes -0.0 equal to +0.0.

Per-lane hooks, read by the engine for ``mixed_observation`` specs (the
union fabric, simulator/fabric.py): ``wants_true_lane`` (bool [B]: the
lane observes true counts) and ``slow_extra_lane`` (f32 [B]: ns charged a
slow-tier access); their defaults read the class attributes.  The engine
reads ``fire_flags(do)`` on the host once an interval: the default is
``do.any()``, the union's one flag a member.  A caller that counts
observed intervals itself (the serving pool) reads ``fire_period()``
once instead: the cadence of ``fires`` where it is fixed, ``None`` where
it follows the run state.

``LegacyPolicyAdapter`` wraps a spec back into the stateful ``Policy``
interface (baselines/base.py), so the numpy reference engine
(``simulator/engine.py::run``) replays every policy with the decisions of
the scan engine.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.baselines.base import Policy
from repro_torch.core.costbenefit import ranked_top
from repro_torch.simulator.simjax import DST_BELOW
from repro_torch.utils.device import resolve_device
from repro_torch.utils.pytree import bwhere, lane_specs, scatter_drop

#: padding entry of the padded-index plans
SENTINEL = -1


# --------------------------------------------------------------- helpers
def _lane_col(v, B: int, device):
    """``None``, an int or an i32 [B] tensor as an i32 [B, 1] column (or
    ``None``)."""
    if v is None:
        return None
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=torch.int32).reshape(B, 1)
    return torch.full((B, 1), int(v), dtype=torch.int32, device=device)


def ranked_take(key, mask, pad: int, limit=None):
    """First ``limit`` indices of each lane's ``mask`` ordered by ``key``
    ascending (ties by ascending page index).  ``key`` [B, n] (cast to
    f32), ``mask`` bool [B, n], ``limit`` ``None``, an int or i32 [B].
    Returns a ``pad``-wide sentinel-padded i32 index array (the valid
    entries form a prefix) and the valid count i32 [B]."""
    B, n = key.shape
    pad = max(1, min(pad, n))
    neg = torch.where(mask, -key.float(), float("-inf"))
    _, order = ranked_top(neg, pad)
    count = mask.sum(dim=1, dtype=torch.int32)[:, None]
    lim = _lane_col(limit, B, key.device)
    if lim is not None:
        count = torch.minimum(count, lim)
    count = torch.clamp_max(count, pad)
    keep = torch.arange(pad, dtype=torch.int32, device=key.device) < count
    return torch.where(keep, order, SENTINEL), count[:, 0]


def truncate_ranked(idx, count):
    """Keep the first ``count`` [B] valid (prefix) entries of a ranked
    list."""
    keep = (torch.arange(idx.shape[1], dtype=torch.int32, device=idx.device)
            < count[:, None])
    return torch.where(keep, idx, SENTINEL)


def scatter_set(dst, idx, value: bool):
    """``dst[b, idx[b, i]] = value`` for the non-sentinel entries."""
    return scatter_drop(dst, idx, value, idx >= 0)


def lanes_of(machine):
    """(lanes B, tiers R, device) of a lane-batched machine."""
    return (machine.lat_ns.shape[0], machine.lat_ns.shape[-1],
            machine.lat_ns.device)


def knob(v, key: str, defaults: dict, dtype):
    """A spec knob as a 0-d tensor: ``v``, or the family's default."""
    return torch.tensor(defaults[key] if v is None else v, dtype=dtype)


def knob_period(period):
    """The fire period of a ``migration_period`` knob as ``fires`` uses it
    (at least 1), read on the host once; ``None`` if the lanes differ."""
    vals = set(torch.clamp_min(period.to(torch.int32), 1).reshape(-1)
               .tolist())
    return vals.pop() if len(vals) == 1 else None


# ---------------------------------------------------------------- protocol
class PolicySpec:
    """Base of the functional policy protocol (subclass + tensor_dataclass).

    Class attributes are static protocol metadata; dataclass fields are
    the knob leaves, lane-batched along axis 0."""

    name: str = "base"
    #: pages migrated per policy pass (serial kernel-thread migration vs
    #: batched); specs that keep it per spec hold it as a meta field.
    migration_limit: int = 10 ** 9
    #: observed counts are TRUE counts (oracle upper bound), not PEBS
    #: samples
    wants_true_counts: bool = False
    #: per-slow-access application overhead of the policy mechanism (TPP's
    #: NUMA hint faults), charged by the engine
    slow_access_extra_ns: float = 0.0
    #: whether the sampling period depends on runtime state (ARMS)
    dynamic_sampling_period: bool = False
    has_mode: bool = False
    #: specs that target tiers directly (``tier_policy``)
    tier_native: bool = False
    #: union specs mixing observation kinds per lane (the per-lane hooks)
    mixed_observation: bool = False

    DEFAULT_SAMPLE_PERIOD = 10_000.0

    # --- static shape contract -------------------------------------------
    def pad_promote(self, n: int, k: int) -> int:
        """Width of the padded ``promote`` plan."""
        return max(1, min(n, self.migration_limit))

    def pad_demote(self, n: int, k: int) -> int:
        """Width of the padded ``demote`` plan."""
        return max(1, min(n, self.migration_limit))

    def pad_moves(self, n: int, k: int) -> int:
        """Width of the tier-native ``pages``/``dst`` arrays (down-moves
        first, then up-moves)."""
        return self.pad_demote(n, k) + self.pad_promote(n, k)

    # --- pure functions over lane-batched state ---------------------------
    def init(self, n_pages: int, k: int, machine):
        raise NotImplementedError

    def observe(self, state, observed):
        """Cheap per-interval accumulation (counts, faults, buffers)."""
        return state

    def fires(self, state):
        """bool [B]: does the policy pass run this interval?"""
        return torch.ones_like(state.t, dtype=torch.bool)

    def fire_period(self):
        """The cadence of ``fires`` as the host reads it once: the pass
        runs on observed interval t iff ``t % period == 0`` (1: every
        interval, 0: never), or ``None`` where it follows the run state
        and the caller reads ``fires``.  A spec that overrides ``fires``
        overrides this too."""
        return 1

    def sampling_period(self, state):
        return torch.full_like(state.t, self.DEFAULT_SAMPLE_PERIOD,
                               dtype=torch.float32)

    def min_sampling_period(self) -> float:
        """Host-side lower bound on the sampling period."""
        return float(self.DEFAULT_SAMPLE_PERIOD)

    def mode_of(self, state):
        """Controller mode for the timeline (ARMS; 0 elsewhere)."""
        return torch.zeros_like(state.t, dtype=torch.int32)

    # --- per-lane hooks (``mixed_observation`` specs only) ---------------
    def wants_true_lane(self, B: int, device):
        """bool [B]: does each lane observe true counts (the oracle lanes
        of a union spec)?"""
        return torch.full((B,), bool(type(self).wants_true_counts),
                          dtype=torch.bool, device=device)

    def slow_extra_lane(self, B: int, device):
        """f32 [B]: each lane's overhead a slow-tier access, ns (the TPP
        lanes of a union spec); a 0.0 lane adds +0.0 to the wall, a no-op
        on its bits."""
        return torch.full((B,), type(self).slow_access_extra_ns,
                          dtype=torch.float32, device=device)

    def fire_flags(self, do):
        """bool [F] on the host, the engine's one sync an interval: any
        flag set runs the policy pass.  One flag, ``do.any()``."""
        return do.any().reshape(1).cpu()

    def policy(self, state, slow_bw, app_bw, k: int):
        """-> (state, promote, demote): the full policy pass."""
        raise NotImplementedError

    def step(self, state, observed, slow_bw, app_bw, k: int):
        """Reference composition: observe, then the policy pass in the
        lanes where it fires (the others keep their state and get blank
        plans)."""
        state = self.observe(state, observed)
        do = self.fires(state)
        st2, promote, demote = self.policy(state, slow_bw, app_bw, k)
        return (bwhere(do, st2, state),
                torch.where(do[:, None], promote, SENTINEL),
                torch.where(do[:, None], demote, SENTINEL))

    # --- tier-native contract --------------------------------------------
    def tier_policy(self, state, tier_util, slow_bw, app_bw, k: int, caps):
        """-> (state, pages, dst): tier-targeted moves.  The base version
        is the binary shim: demotions (dst ``DST_BELOW``, the hop-chain
        cascade) followed by promotions (dst 0)."""
        state, promote, demote = self.policy(state, slow_bw, app_bw, k)
        pages = torch.cat([demote, promote], dim=1)
        dst = torch.cat([torch.full_like(demote, DST_BELOW),
                         torch.zeros_like(promote)], dim=1)
        return state, pages, dst

    def step_tiers(self, state, observed, tier_util, slow_bw, app_bw,
                   k: int, caps):
        """Reference composition of the tier-native contract."""
        state = self.observe(state, observed)
        do = self.fires(state)
        st2, pages, dst = self.tier_policy(state, tier_util, slow_bw,
                                           app_bw, k, caps)
        return (bwhere(do, st2, state),
                torch.where(do[:, None], pages, SENTINEL),
                torch.where(do[:, None], dst, 0))


class TierNativeSpec(PolicySpec):
    """What the tier-native families (HybridTier, Jenga, TierBPF) share:
    ``2 * bs_max``-wide move pads (the per-pair budgets cap what a plan
    admits anyway), per-lane ``sample_period`` and ``migration_period``
    leaves."""

    tier_native = True

    def pad_promote(self, n: int, k: int) -> int:
        return max(1, min(n, 2 * self.bs_max))

    def pad_demote(self, n: int, k: int) -> int:
        return max(1, min(n, 2 * self.bs_max))

    def sampling_period(self, state):
        return self.sample_period.float()

    def min_sampling_period(self):
        return float(self.sample_period.min())

    def fires(self, state):
        period = torch.clamp_min(self.migration_period.to(torch.int32), 1)
        return (state.t % period) == 0

    def fire_period(self):
        return knob_period(self.migration_period)


def capacity_victims(in_fast, cold_key, cold_mask, n_want, k: int,
                     pad_d: int, extra_need=0):
    """Shared victim selection: free slots, then coldest-first demotions.

    Returns (victims, n_victims, n_take) where ``n_take`` [B] caps the
    promotion list at ``free + n_victims``."""
    free = k - in_fast.sum(dim=1, dtype=torch.int32)
    need = n_want - free
    need = (torch.maximum(need, extra_need)
            if isinstance(extra_need, torch.Tensor)
            else torch.clamp_min(need, extra_need))
    need = torch.clamp_min(need, 0)
    victims, n_vict = ranked_take(cold_key, cold_mask, pad_d, need)
    n_take = torch.minimum(n_want, free + n_vict)
    return victims, n_vict, n_take


# ------------------------------------------------ tier-native plan helpers
def rank_desc(score):
    """Dense 0-based rank of each page under DESCENDING score (rank 0 =
    hottest; ties, -0.0 and +0.0 included, by ascending page index).
    ``score`` f32 [B, n] -> i32 [B, n]."""
    neg = -score.float()
    neg = torch.where(neg == 0, 0.0, neg)   # -0.0 sorts as +0.0
    order = torch.sort(neg, dim=1, stable=True).indices
    ar = torch.arange(score.shape[1], dtype=torch.int32, device=score.device)
    return torch.zeros(score.shape, dtype=torch.int32,
                       device=score.device).scatter_(
        1, order, ar.expand(score.shape[0], -1))


def rank_partition(rank, caps):
    """Per-tier scores -> target placement: fill tiers shallowest-first by
    rank against the capacity ladder.  ``rank`` i32 [B, n], ``caps`` i32
    [B, R] -> i32 [B, n] target tiers."""
    cum = torch.cumsum(caps, dim=1)[:, :-1]                 # [B, R-1]
    return (rank[:, :, None] >= cum[:, None, :]).sum(
        dim=2, dtype=torch.int32)


def pair_limit(lo, hi, valid, budgets):
    """Per-pair budget filter over priority-ordered move lists [B, m]:
    entry i crosses pairs ``lo[i] <= j < hi[i]`` and survives iff for
    every crossed pair fewer than ``budgets[:, j]`` earlier valid entries
    cross it.  Returns the surviving-entry mask."""
    ok = valid
    for j in range(budgets.shape[1]):
        crosses = valid & (lo <= j) & (j < hi)
        rank = torch.cumsum(crosses.to(torch.int32), dim=1) - 1
        ok = ok & (~crosses | (rank < budgets[:, j:j + 1]))
    return ok


def _count(mask):
    return mask.sum(dim=1, dtype=torch.int32)


def tier_plan(score, cur, target, caps, budgets, pad_down: int,
              pad_up: int):
    """Feasible tier-targeted moves from a desired placement.

    ``score`` f32 [B, n], ``cur`` i32 [B, n] the residency belief,
    ``target`` i32 [B, n], ``caps`` i32 [B, R], ``budgets`` i32 [B, R-1].
    Returns (pages, dst, new_cur): ``pad_down + pad_up``-wide moves, down
    first (coldest first), then up (hottest first), which
    ``simjax.apply_targeted_migrations`` executes verbatim; ``new_cur``
    is the engine-side placement afterwards."""
    i32 = torch.int32
    R = caps.shape[1]
    target = torch.clamp(target, 0, R - 1)
    occ = torch.stack([_count(cur == r) for r in range(R)], dim=1)

    # down-moves: coldest first, budget-filtered, then capacity-admitted
    # bottom-up (deeper targets first; their departures free slots).
    d_pages, _ = ranked_take(score, target > cur, pad_down)
    d_valid = d_pages >= 0
    d_safe = torch.where(d_valid, d_pages, 0).long()
    d_cur = torch.where(d_valid, cur.gather(1, d_safe), 0)
    d_tgt = torch.where(d_valid, target.gather(1, d_safe), R - 1)
    d_ok = pair_limit(d_cur, d_tgt, d_valid, budgets)
    adm_d = torch.zeros_like(d_valid)
    for r in range(R - 1, 0, -1):
        dep = _count(adm_d & (d_cur == r))
        room = caps[:, r] - occ[:, r] + dep
        cand = d_ok & (d_tgt == r) & (~adm_d)
        rank = torch.cumsum(cand.to(i32), dim=1) - 1
        adm_d = adm_d | (cand & (rank < room[:, None]))
    d_pages = torch.where(adm_d, d_pages, SENTINEL)
    rem = torch.stack([budgets[:, j] - _count(adm_d & (d_cur <= j)
                                              & (j < d_tgt))
                       for j in range(R - 1)], dim=1)
    rem = torch.clamp_min(rem, 0)
    occ2 = occ + torch.stack([_count(adm_d & (d_tgt == r))
                              - _count(adm_d & (d_cur == r))
                              for r in range(R)], dim=1)

    # up-moves: hottest first, remaining budgets, capacity-admitted
    # shallowest destination first against the post-down occupancy.
    u_pages, _ = ranked_take(-score, target < cur, pad_up)
    u_valid = u_pages >= 0
    u_safe = torch.where(u_valid, u_pages, 0).long()
    u_cur = torch.where(u_valid, cur.gather(1, u_safe), 0)
    u_tgt = torch.where(u_valid, target.gather(1, u_safe), 0)
    u_ok = pair_limit(u_tgt, u_cur, u_valid, rem)
    adm_u = torch.zeros_like(u_valid)
    for r in range(R - 1):
        dep = _count(adm_u & (u_cur == r))
        room = caps[:, r] - occ2[:, r] + dep
        cand = u_ok & (u_tgt == r) & (~adm_u)
        rank = torch.cumsum(cand.to(i32), dim=1) - 1
        adm_u = adm_u | (cand & (rank < room[:, None]))
    u_pages = torch.where(adm_u, u_pages, SENTINEL)

    new_cur = scatter_drop(cur, d_pages, d_tgt, adm_d)
    new_cur = scatter_drop(new_cur, u_pages, u_tgt, adm_u)
    pages = torch.cat([d_pages, u_pages], dim=1)
    dst = torch.cat([d_tgt, u_tgt], dim=1)
    return pages, dst, new_cur


# ----------------------------------------------------------- legacy bridge
class LegacyPolicyAdapter(Policy):
    """A functional ``PolicySpec`` exposed as a stateful numpy-engine
    ``Policy``.

    The adapter holds one lane of the spec's state on the device
    ``reset`` names and runs an interval as ``step``/``step_tiers``
    compose it: observe, then the policy pass if ``fires``, with no jit.
    The fire flag is read on the host, so an interval whose pass is not
    due runs none (JAX's ``lax.cond``); the padded plans come back to the
    host with the sentinels dropped, order kept.  The decisions are
    therefore the scan engine's, the basis of the cross-engine
    equivalence tests.
    """

    def __init__(self, spec: PolicySpec):
        self.spec = spec
        self.name = spec.name
        self.slow_access_extra_ns = spec.slow_access_extra_ns

    def reset(self, n_pages, k, machine, device=None):
        from repro_torch.simulator import machine_spec, machines
        self.device = resolve_device(device)
        self.n, self.k = n_pages, k
        mach, _ = machine_spec.lane_stack([machines.get(machine)], n_pages,
                                          k, self.device)
        self.lane = lane_specs(self.spec, 1).to(self.device)
        self.state = self.lane.init(n_pages, k, mach)
        self._period = float(self.lane.sampling_period(self.state))

    def sampling_period(self):
        return self._period

    def wants_true_counts(self):
        return self.spec.wants_true_counts

    @property
    def mode(self) -> int:
        if not type(self.spec).has_mode:
            return 0
        return int(self.lane.mode_of(self.state))

    @property
    def tier_native(self) -> bool:
        return type(self.spec).tier_native

    def _f32(self, v):
        return torch.full((1,), float(v), dtype=torch.float32,
                          device=self.device)

    def _observe(self, observed) -> bool:
        """Observe the interval; -> whether the policy pass is due."""
        self.state = self.lane.observe(
            self.state, observed.to(self.device, torch.float32)[None])
        return bool(self.lane.fires(self.state))

    def _after(self, *plans):
        """Host copies of the pass's [1, m] plans, rereading the sampling
        period of a spec whose period follows its state."""
        if type(self.spec).dynamic_sampling_period:
            self._period = float(self.lane.sampling_period(self.state))
        return [p[0].cpu().numpy().astype(np.int64) for p in plans]

    def step(self, observed, slow_bw_frac, app_bw_frac):
        if not self._observe(observed):
            return np.empty(0, np.int64), np.empty(0, np.int64)
        self.state, promote, demote = self.lane.policy(
            self.state, self._f32(slow_bw_frac), self._f32(app_bw_frac),
            self.k)
        promote, demote = self._after(promote, demote)
        return promote[promote >= 0], demote[demote >= 0]

    def step_tiers(self, observed, slow_bw_frac, app_bw_frac, tier_util,
                   caps):
        """Tier-native interval: -> (pages, dst) aligned i64 arrays with
        the sentinels dropped (priority order kept).  ``tier_util`` [R]
        (host or device), ``caps`` the host's [R] capacities."""
        if not self._observe(observed):
            return np.empty(0, np.int64), np.empty(0, np.int64)
        tier_util = torch.as_tensor(tier_util).to(
            self.device, torch.float32).reshape(1, -1)
        caps = torch.as_tensor(np.asarray(caps, np.int32)).to(
            self.device).reshape(1, -1)
        self.state, pages, dst = self.lane.tier_policy(
            self.state, tier_util, self._f32(slow_bw_frac),
            self._f32(app_bw_frac), self.k, caps)
        pages, dst = self._after(pages, dst)
        keep = pages >= 0
        return pages[keep], dst[keep]
