"""Policy-generic tiered pool executor of the serving layer, in torch.

The port of ``repro/tiering/tiered_pool.py``.  A ``TieredPool`` carries
any registered policy family's spec and state (one lane) next to the
residency metadata of ``n`` pages, of which at most ``k`` live in the
fast tier, and one ``pool_step`` runs

    observe -> if fires: policy -> apply_padded_migrations -> data move

Binary families emit promote/demote plans; the tier-native families
(HybridTier, Jenga, TierBPF) see the two-tier chain through
``tier_policy`` (caps ``[k, n]``, the per-tier read-time shares as their
utilization) and their targeted moves collapse to promote (destination
0) and demote (any deeper destination) lists in priority order.

The data move goes through the ``migrate_fire`` op (the hand-written
CUDA kernel on the card): each moved buffer is ONE tensor ``[k + n, ...]``
holding the fast rows first and the slow rows (indexed by page id, the
home-slot invariant) after them, where the JAX package keeps two arrays
``(fast [k, ...], slow [n, ...])``; the op takes the two views of it.  A
fire is ONE launch over every buffer, of any row shape, driven by two
slot-indexed tables built on the device: the home row each fast slot is
copied back to (the demotions; all -1 with ``copy_back=False``) and the
home row copied into it (the promotions).  The kernel moves a slot's bytes
out before it moves them in, so a promotion may land in a slot that a
demotion of the same fire vacated.

The fire decision is the host's: ``init_pool`` reads the spec's
``fire_period`` once (ARMS's ``pool_every``, a family's
``migration_period``; every interval for Memtis, TPP and the oracle,
never for all-slow) and the pool counts observed intervals itself
(``t``), so it branches without a device sync.  A spec whose cadence
follows its state (``fire_period() is None``, e.g. the simulator's
``ARMSSpec``) has its ``fires`` flag read once a step instead.
Everything else, telemetry included, stays on the device until
``telemetry`` reads it once.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.baselines.arms_policy import ARMSServeSpec
from repro_torch.baselines.protocol import SENTINEL, PolicySpec, ranked_take
from repro_torch.core.state import ARMSConfig
from repro_torch.kernels.migrate import ops as migrate_ops
from repro_torch.simulator import machines, simjax
from repro_torch.simulator.machine_spec import TieredMachineSpec
from repro_torch.utils.device import f32_on, resolve_device
from repro_torch.utils.pytree import (lane_specs, scatter_drop,
                                      tensor_dataclass, tree_map)

DEFAULT_MACHINE = "hbm-pcie"
_EPS = 1e-12


def serving_policy(policy, arms_cfg: ARMSConfig | None = None,
                   pool_every: int = 8) -> PolicySpec:
    """Resolve a policy family name (or a spec instance) for serving.

    ``"arms"`` maps to ``ARMSServeSpec`` (raw counts, fixed cadence; see
    baselines/arms_policy.py) bound to the pool's ARMSConfig and cadence;
    every other name resolves through ``experiment.POLICY_REGISTRY``, so
    the serving layer takes exactly the simulator's policy families."""
    if isinstance(policy, PolicySpec):
        return policy
    name = str(policy).lower()
    if name == "arms":
        return ARMSServeSpec.make_serving(arms_cfg or ARMSConfig(),
                                          pool_every)
    from repro_torch.simulator.experiment import POLICY_REGISTRY
    if name not in POLICY_REGISTRY:
        raise ValueError(f"unknown policy {policy!r}; known: "
                         f"{sorted(POLICY_REGISTRY)}")
    return POLICY_REGISTRY[name]()


@tensor_dataclass
class PoolPlan:
    """One pool interval's migration outcome (padded-index contract) plus
    the step's access echo."""
    promote: torch.Tensor     # i32 [pad_p] sentinel-padded page ids
    demote: torch.Tensor      # i32 [pad_d]
    pexec: torch.Tensor       # bool masks of the EXECUTED entries
    dexec: torch.Tensor
    count: torch.Tensor       # i32 executed promotions
    access: torch.Tensor      # f32 [n] this step's access signal
    fast_share: torch.Tensor  # f32 access share served fast, post-policy


@tensor_dataclass(meta=("t", "period"))
class TieredPool:
    """Residency + policy + device-side telemetry for one tiered pool.

    Leaves are 0-d or ``[n]`` tensors, except the policy spec and state,
    whose leaves carry one lane (``[1, ...]``).  ``t`` counts observed
    intervals on the host; ``period`` is the spec's ``fire_period``."""
    spec: PolicySpec           # one lane
    state: object              # the spec's run state, one lane
    in_fast: torch.Tensor      # [n] bool residency
    slot: torch.Tensor         # [n] i32 slot within the page's tier pool
    counts: torch.Tensor       # [n] f32 access signal since last fire
    read_fast: torch.Tensor    # f32 bytes read per tier since last fire
    read_slow: torch.Tensor
    promoted_at: torch.Tensor  # [n] i32 WASTE_WINDOW bookkeeping
    demoted_at: torch.Tensor
    promos: torch.Tensor       # i32 executed migrations (cumulative)
    demos: torch.Tensor
    waste: torch.Tensor        # i32 wasteful migrations
    wall_s: torch.Tensor       # f32 modeled tiered serving time
    wall_flat_s: torch.Tensor  # f32 all-fast counterfactual
    mach: TieredMachineSpec    # 2-tier machine, f32 [R] leaves
    t: int = 0
    period: int | None = 1


def _machine32(machine, device) -> TieredMachineSpec:
    """A machine preset as f32 ``[R]`` tensor leaves on ``device``."""
    spec = machines.get(machine)
    return TieredMachineSpec(
        **{f.name: torch.from_numpy(
            np.asarray(getattr(spec, f.name), np.float32)).to(device)
           for f in dataclasses.fields(TieredMachineSpec)
           if f.name != "name"}, name=spec.name)


def init_pool(policy, n: int, k: int, machine=DEFAULT_MACHINE,
              arms_cfg: ARMSConfig | None = None, pool_every: int = 8,
              device=None) -> TieredPool:
    device = resolve_device(device)
    spec = lane_specs(serving_policy(policy, arms_cfg=arms_cfg,
                                     pool_every=pool_every), 1).to(device)
    mach = _machine32(machine, device)
    i32 = dict(dtype=torch.int32, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    zf = lambda: torch.zeros((), **f32)
    zi = lambda: torch.zeros((), **i32)
    return TieredPool(
        spec=spec,
        state=spec.init(n, k, tree_map(lambda x: x.unsqueeze(0), mach)),
        in_fast=torch.zeros((n,), dtype=torch.bool, device=device),
        slot=torch.arange(n, **i32),
        counts=torch.zeros((n,), **f32),
        read_fast=zf(), read_slow=zf(),
        promoted_at=torch.full((n,), -(10 ** 9), **i32),
        demoted_at=torch.full((n,), -(10 ** 9), **i32),
        promos=zi(), demos=zi(), waste=zi(),
        wall_s=zf(), wall_flat_s=zf(), mach=mach, t=0,
        period=spec.fire_period())


def serving_interval_outcome(mach, read_fast, read_slow, up_bytes=0.0,
                             down_bytes=0.0):
    """Two-tier bandwidth cost over raw byte volumes (f32): the byte
    mirror of ``simjax.tier_interval_outcome``'s bandwidth terms.  Returns
    ``(wall_s, app_bw_frac_raw)``; the ratio is unclamped."""
    br, bw = mach.bw_read, mach.bw_write
    t0 = (read_fast + up_bytes + down_bytes) / br[0]
    t1 = (read_slow + up_bytes) / br[1] + down_bytes / bw[1]
    wall = torch.clamp_min(torch.maximum(t0, t1), _EPS)
    app_raw = t0 / torch.clamp_min(t1, _EPS)
    return wall, app_raw


def pool_signals(pool: TieredPool):
    """(slow_bw_frac, app_bw_frac) over the since-last-fire window."""
    slow_bw = torch.where(pool.in_fast, 0.0, pool.counts).sum() \
        / torch.clamp_min(pool.counts.sum(), 1e-9)
    _, app_raw = serving_interval_outcome(pool.mach, pool.read_fast,
                                          pool.read_slow)
    return slow_bw, torch.clamp(app_raw, 0.0, 1.0)


def pool_tier_util(pool: TieredPool):
    """f32 [2] per-tier read-time share of the window wall: the serving
    mirror of ``simjax.tier_utilization_impl`` for tier-native specs."""
    br = pool.mach.bw_read
    t0 = pool.read_fast / br[0]
    t1 = pool.read_slow / br[1]
    wall = torch.clamp_min(torch.maximum(t0, t1), _EPS)
    return torch.stack([t0, t1]) / wall


def pool_fires(pool: TieredPool) -> bool:
    """Is the policy pass due on the pool's current interval?  From the
    host cadence, or (``period`` None) the spec's flag read once."""
    if pool.period is None:
        return bool(pool.spec.fires(pool.state))
    return pool.period > 0 and pool.t % pool.period == 0


def pool_observe(pool: TieredPool, access, read_fast=0.0,
                 read_slow=0.0) -> TieredPool:
    """Accumulate one serving interval's access signal + read volumes."""
    read_fast = f32_on(read_fast, pool.counts.device)
    read_slow = f32_on(read_slow, pool.counts.device)
    br = pool.mach.bw_read
    step_wall = torch.clamp_min(
        torch.maximum(read_fast / br[0], read_slow / br[1]), _EPS)
    return pool.replace(
        state=pool.spec.observe(pool.state, access[None]),
        counts=pool.counts + access,
        read_fast=pool.read_fast + read_fast,
        read_slow=pool.read_slow + read_slow,
        t=pool.t + 1,
        wall_s=pool.wall_s + step_wall,
        wall_flat_s=pool.wall_flat_s + (read_fast + read_slow) / br[0]
        + _EPS)


def _set(x, idx, val, valid):
    """``x[idx[i]] = val[i]`` where ``valid[i]`` for ``[n]`` rows."""
    return scatter_drop(x[None], idx[None], val if not isinstance(
        val, torch.Tensor) else val[None], valid[None])[0]


def _slot_table(k: int, slots, rows, ok):
    """i32 ``[k]``: ``rows[i]`` at fast slot ``slots[i]`` where ``ok[i]``,
    -1 elsewhere (executed moves have unique slots); no host sync."""
    tab = torch.full((k + 1,), SENTINEL, dtype=torch.int32,
                     device=rows.device)
    tab.index_put_((torch.where(ok, slots.clamp(0, k - 1), k).long(),),
                   torch.where(ok, rows, SENTINEL).to(torch.int32))
    return tab[:k]


def _skip_plan(n: int, pad_p: int, pad_d: int, device) -> PoolPlan:
    i32 = dict(dtype=torch.int32, device=device)
    return PoolPlan(
        promote=torch.full((pad_p,), SENTINEL, **i32),
        demote=torch.full((pad_d,), SENTINEL, **i32),
        pexec=torch.zeros((pad_p,), dtype=torch.bool, device=device),
        dexec=torch.zeros((pad_d,), dtype=torch.bool, device=device),
        count=torch.zeros((), **i32),
        access=torch.zeros((n,), dtype=torch.float32, device=device),
        fast_share=torch.zeros((), dtype=torch.float32, device=device))


def pool_fire(pool: TieredPool, *, k: int, bufs=(), copy_back: bool = True,
              page_bytes: float = 0.0):
    """If the policy fires: policy pass + residency executor + data
    movement.  ``bufs`` are tensors ``[k + n, ...]`` (fast rows first,
    then the home rows), moved in place.  ``copy_back=False`` models pools
    whose slow tier always holds the home copy, so demotion moves no data.
    Returns (pool, bufs, PoolPlan)."""
    spec = pool.spec
    n = pool.in_fast.shape[0]
    dev = pool.in_fast.device
    pad_p, pad_d = spec.pad_promote(n, k), spec.pad_demote(n, k)
    if not pool_fires(pool):
        return pool, bufs, _skip_plan(n, pad_p, pad_d, dev)
    i32 = torch.int32
    f32 = torch.float32

    slow_bw, app_bw = pool_signals(pool)
    if type(spec).tier_native:
        # the two-tier chain seen directly; the targeted moves collapse to
        # promote (dst 0) / demote (any deeper dst) lists, priority order
        caps = torch.full((1, 2), n, dtype=i32, device=dev)
        caps[:, 0] = k
        state, pages, dst = spec.tier_policy(
            pool.state, pool_tier_util(pool)[None], slow_bw[None],
            app_bw[None], k, caps)
        pm = pages.shape[1]
        pos = torch.arange(pm, dtype=f32, device=dev)[None]
        valid = pages >= 0

        def pick(mask, pad):
            at, _ = ranked_take(pos, mask, pad)
            return torch.where(at >= 0, pages.gather(
                1, at.clamp(0, pm - 1).long()), SENTINEL)[0]

        promote = pick(valid & (dst == 0), pad_p)
        demote = pick(valid & (dst != 0), pad_d)
    else:
        state, promote, demote = spec.policy(pool.state, slow_bw[None],
                                             app_bw[None], k)
        promote, demote = promote[0], demote[0]
    in_fast, pexec, dexec = simjax.apply_padded_migrations(
        pool.in_fast[None], promote[None], demote[None], k)
    in_fast, pexec, dexec = in_fast[0], pexec[0], dexec[0]

    # --- slot bookkeeping (demotions land on their home slot; executed
    # promotions fill free fast slots in ascending order) -----------------
    d_src = pool.slot[torch.where(dexec, demote, 0).long()]  # vacated slots
    slot = _set(pool.slot, demote, demote, dexec)
    in_fast_mid = _set(pool.in_fast, demote, False, dexec)
    occupied = torch.zeros((k + 1,), dtype=torch.bool, device=dev)
    occupied.index_fill_(0, torch.where(in_fast_mid, pool.slot, k).long(),
                         True)
    free_order = torch.argsort(occupied[:k].to(i32), stable=True).to(i32)
    p_rank = torch.cumsum(pexec.to(i32), dim=0) - 1
    p_dst = free_order[p_rank.clamp(0, k - 1).long()]
    slot = _set(slot, promote, p_dst, pexec)

    # --- data movement: one launch over every buffer; per fast slot the
    # demotion's copy-back (slot -> home row) before the promotion (home
    # row -> slot) ---------------------------------------------------------
    if bufs:
        out_row = _slot_table(k, d_src, demote, dexec) if copy_back \
            else torch.full((k,), SENTINEL, dtype=i32, device=dev)
        migrate_ops.migrate_fire(
            [b[:k] for b in bufs], [b[k:] for b in bufs], out_row,
            _slot_table(k, p_dst, promote, pexec))

    # --- telemetry (device-side; simulator semantics) --------------------
    n_up = pexec.sum(dtype=i32)
    n_down = dexec.sum(dtype=i32)
    waste_inc, promoted_at, demoted_at = simjax.wasteful_update(
        pool.t, pool.promoted_at[None], pool.demoted_at[None],
        promote[None], demote[None], pexec[None], dexec[None])
    up_b = n_up.to(f32) * page_bytes
    down_b = n_down.to(f32) * page_bytes if copy_back \
        else torch.zeros((), dtype=f32, device=dev)
    zero = torch.zeros((), dtype=f32, device=dev)
    mig_wall, _ = serving_interval_outcome(pool.mach, zero, zero, up_b,
                                           down_b)
    pool = pool.replace(
        state=state, in_fast=in_fast, slot=slot,
        counts=torch.zeros_like(pool.counts),
        read_fast=torch.zeros_like(pool.read_fast),
        read_slow=torch.zeros_like(pool.read_slow),
        promoted_at=promoted_at[0], demoted_at=demoted_at[0],
        promos=pool.promos + n_up, demos=pool.demos + n_down,
        waste=pool.waste + waste_inc[0],
        wall_s=pool.wall_s + torch.where(n_up + n_down > 0, mig_wall, 0.0))
    plan = PoolPlan(promote=promote, demote=demote, pexec=pexec, dexec=dexec,
                    count=n_up, access=torch.zeros((n,), dtype=f32,
                                                   device=dev),
                    fast_share=torch.zeros((), dtype=f32, device=dev))
    return pool, bufs, plan


def pool_step(pool: TieredPool, access, read_fast=0.0, read_slow=0.0, *,
              k: int, bufs=(), copy_back: bool = True,
              page_bytes: float = 0.0):
    """observe + (if it fires) policy/executor/data move.  Returns (pool,
    bufs, PoolPlan); the plan echoes the step's access signal and the
    post-policy fast-tier share of it."""
    access = access.float()
    pool = pool_observe(pool, access, read_fast, read_slow)
    pool, bufs, plan = pool_fire(pool, k=k, bufs=bufs, copy_back=copy_back,
                                 page_bytes=page_bytes)
    share = (access * pool.in_fast).sum() \
        / torch.clamp_min(access.sum(), 1e-9)
    return pool, bufs, plan.replace(access=access, fast_share=share)


def telemetry(pool: TieredPool) -> dict:
    """Host-side summary (the leaderboard's slowdown/thrash metrics): the
    one host sync of a serving run."""
    promos, demos = int(pool.promos), int(pool.demos)
    wall, flat = float(pool.wall_s), float(pool.wall_flat_s)
    return dict(
        promotions=promos, demotions=demos, wasteful=int(pool.waste),
        thrash=float(pool.waste) / max(promos + demos, 1),
        modeled_wall_s=wall, modeled_flat_s=flat,
        slowdown=wall / max(flat, _EPS),
        fast_resident=int(pool.in_fast.sum()))
