"""Engine-side bookkeeping of the scan engine, lane-batched in torch.

The port of ``repro/simulator/simjax.py``: the interval cost model
(``tier_access_split``, ``_tier_times``, ``tier_interval_outcome``,
``interval_accounting_impl``), the per-tier utilization signal of the
tier-native policies (``tier_utilization_impl``), the hop-chain migration
executor (``apply_tier_migrations``), the tier-targeted executor
(``apply_targeted_migrations``), the two-tier boolean executor of the
serving pools (``apply_padded_migrations``, ``apply_migrations``) and the
wasteful-migration accounting (``wasteful_update``).  Every function takes
an explicit lane axis: rows are ``[B, n]``, machine leaves ``[B, R]``,
per-lane scalars ``[B]``.  The cost model and the hop-chain executor are
the plain versions behind the ``interval_account`` and ``tier_migrate``
kernels; the targeted executor and the utilization signal are plain
torch, as they are plain XLA in the JAX package.

Placement is an i32 per-page tier index (0 = fastest).  Migrations are
adjacent-pair hop chains; the bottom tier's access count is the f32
remainder ``total - sum(upper)``; utilization ratios are returned raw
(> 1 == oversaturated) and clamped only by their consumers.

Sums: each per-tier access sum accumulates in f64 and rounds once to f32.
A f32 sum depends on its association order, which differs between CPU,
card and XLA; the f64 sum of f32 values of one row is exact whenever the
row's exponent spread leaves room (it does for every trace here), so its
f32 rounding is the same on every device.  Against the JAX package, whose
f32 sums are accumulated in XLA's order, the sums agree to about one ulp.
"""
from __future__ import annotations

import torch

from repro_torch.simulator.engine import WASTE_WINDOW
from repro_torch.simulator.machine import CACHELINE, PAGE_BYTES
from repro_torch.utils.pytree import scatter_drop

#: destination sentinel of tier-targeted moves: "the first tier below the
#: page's source with room", the hop-chain demotion cascade.  The binary
#: shim (``protocol.PolicySpec.tier_policy``) emits its demotions with it,
#: which makes the shim bit for bit the hop-chain route.
DST_BELOW = -2


def tier_access_split(true, tier, R: int):
    """Per-tier f32 access counts (list of R ``[B]``) + the f32 total.

    Tiers 0..R-2 are masked sums; the bottom tier is the sequential f32
    remainder ``total - sum(upper)``."""
    t64 = true.double()
    total = t64.sum(dim=1).float()
    accs = []
    rest = total
    for r in range(R - 1):
        a = torch.where(tier == r, t64, 0.0).sum(dim=1).float()
        accs.append(a)
        rest = rest - a
    accs.append(rest)
    return accs, total


def _tier_times(mach, acc, mig_up, mig_down):
    """Per-tier latency + bandwidth times, op for op the JAX expressions.

    Returns (t_lat [B], list of R per-tier bandwidth times [B])."""
    R = mach.lat_ns.shape[-1]
    lat, br, bw = mach.lat_ns, mach.bw_read, mach.bw_write

    t_lat = acc[0] * lat[:, 0]
    for r in range(1, R):
        t_lat = t_lat + acc[r] * lat[:, r]
    t_lat = t_lat * 1e-9 / mach.mlp

    # tier 0: one symmetric-bandwidth division.
    times = [(acc[0] * CACHELINE
              + (mig_up[:, 0] + mig_down[:, 0]) * PAGE_BYTES) / br[:, 0]]
    for r in range(1, R):
        rd = mig_up[:, r - 1]
        if r < R - 1:
            rd = rd + mig_down[:, r]
        wr = mig_down[:, r - 1]
        if r < R - 1:
            wr = wr + mig_up[:, r]
        times.append((acc[r] * CACHELINE + rd * PAGE_BYTES) / br[:, r]
                     + wr * PAGE_BYTES / bw[:, r])
    return t_lat, times


def tier_interval_outcome(mach, acc, mig_up, mig_down):
    """N-tier interval cost, f32.  Returns (wall_s, slow_share,
    app_bw_frac_raw, slow_bw_frac_raw), each [B]."""
    R = mach.lat_ns.shape[-1]
    t_lat, times = _tier_times(mach, acc, mig_up, mig_down)

    rest_max = times[1]
    for r in range(2, R):
        rest_max = torch.maximum(rest_max, times[r])
    wall = torch.maximum(torch.maximum(t_lat, times[0]),
                         torch.clamp_min(rest_max, 1e-12))

    rest_acc = acc[1]
    for r in range(2, R):
        rest_acc = rest_acc + acc[r]
    slow_share = rest_acc / torch.clamp_min(acc[0] + rest_acc, 1e-9)
    app_raw = times[0] / torch.maximum(t_lat,
                                       torch.clamp_min(rest_max, 1e-12))
    slow_raw = rest_max / torch.maximum(t_lat,
                                        torch.clamp_min(times[0], 1e-12))
    return wall, slow_share, app_raw, slow_raw


def interval_accounting_impl(mach, true_counts, tier, mig_up, mig_down):
    """Per-interval cost/accounting step.  Returns (acc_fast, acc_slow,
    wall_s, slow_share, app_bw_frac_raw), each f32 [B]; acc_fast/acc_slow
    aggregate tier 0 vs everything below."""
    R = mach.lat_ns.shape[-1]
    accs, _ = tier_access_split(true_counts, tier, R)
    wall, slow_share, app_raw, _ = tier_interval_outcome(
        mach, accs, mig_up.float(), mig_down.float())
    acc_slow = accs[1]
    for r in range(2, R):
        acc_slow = acc_slow + accs[r]
    return accs[0], acc_slow, wall, slow_share, app_raw


def tier_utilization_impl(mach, true_counts, tier, mig_up, mig_down):
    """Per-tier bandwidth utilization f32 [B, R]: each tier's bandwidth
    time over the interval's wall time, the tier-native policies' signal
    (``scheduler.pair_budgets``).  Neutral padded tiers (bw inf) report
    0.  The access sums round once from f64 (module docstring)."""
    R = mach.lat_ns.shape[-1]
    accs, _ = tier_access_split(true_counts, tier, R)
    t_lat, times = _tier_times(mach, accs, mig_up.float(), mig_down.float())
    stack = torch.stack(times, dim=1)
    wall = torch.clamp_min(torch.maximum(t_lat, stack.amax(dim=1)), 1e-12)
    return stack / wall[:, None]


# ------------------------------------------------------------- migrations
def _count(mask):
    return mask.sum(dim=1, dtype=torch.int32)


def apply_tier_migrations(tier, promote, demote, caps):
    """Adjacent-pair hop migrations over i32 tier rows, fixed shape.

    ``tier`` [B, n]; ``promote`` [B, P] / ``demote`` [B, D] follow the
    padded-index contract (``-1`` padding, valid entries unique page
    indices in priority order); ``caps`` i32 [B, R].  Demotions apply
    first: each valid entry (page not already in the bottom tier)
    cascades to the first tier below its source with room after all
    departures.  Promotions then move pages to tier 0, capped by its room
    after demotions.  Returns (tier, pexec, dexec, mig_up, mig_down): the
    new placement, executed masks aligned with the plans, and i32
    [B, R-1] counts of pages crossing each adjacent pair.
    """
    R = caps.shape[-1]
    i32 = torch.int32

    src = tier.gather(1, torch.clamp_min(demote, 0).long())
    dexec = (demote >= 0) & (src < R - 1)
    dest = torch.full_like(demote, R - 1)
    landed = torch.zeros_like(dexec)
    for r in range(1, R - 1):
        # occupancy after departures: every demoted page leaves its source
        # tier (it always lands somewhere below), freeing that slot.
        occ_r = _count(tier == r) - _count(dexec & (src == r))
        cand = dexec & (~landed) & (src < r)
        rank = torch.cumsum(cand.to(i32), dim=1) - 1
        land = cand & (rank < (caps[:, r] - occ_r)[:, None])
        dest = torch.where(land, r, dest)
        landed = landed | land
    tier = scatter_drop(tier, demote, dest, dexec)

    p_src = tier.gather(1, torch.clamp_min(promote, 0).long())
    p_ok = (promote >= 0) & (p_src > 0)
    room = caps[:, 0] - _count(tier == 0)
    rank = torch.cumsum(p_ok.to(i32), dim=1) - 1
    pexec = p_ok & (rank < room[:, None])
    tier = scatter_drop(tier, promote, 0, pexec)

    mig_up = torch.stack([_count(pexec & (p_src > j)) for j in range(R - 1)],
                         dim=1)
    mig_down = torch.stack([_count(dexec & (src <= j) & (dest > j))
                            for j in range(R - 1)], dim=1)
    return tier, pexec, dexec, mig_up, mig_down


def apply_targeted_migrations(tier, pages, dst, caps):
    """Tier-targeted migrations over lanes: each valid entry of ``pages``
    i32 [B, m] (``-1`` padded, priority order, unique per direction)
    requests a move to ``dst[b, i]``; ``DST_BELOW`` resolves to the first
    tier below the source with room (the hop-chain cascade).

    Down moves (resolved dst > src) run first, in priority order, each
    landing at the shallowest tier r >= its dst with room (the bottom
    always has room).  Up moves then run per destination tier, shallowest
    first, against the occupancy after the downs and the earlier ups; a
    request that does not fit its exact destination is dropped.  With the
    binary shim's plans every expression reduces to
    ``apply_tier_migrations``'s, so the results are bit for bit the same.
    Sentinel entries after a plan's real moves change nothing (invalid
    entries join neither phase, and the admission ranks count only
    candidates).  Returns (tier, up_exec, down_exec, mig_up, mig_down),
    the executed masks aligned with ``pages``."""
    R = caps.shape[-1]
    i32 = torch.int32
    valid = pages >= 0
    safe = torch.where(valid, pages, 0).long()
    src = tier.gather(1, safe)
    dst = torch.where(dst == DST_BELOW, src + 1, dst)
    dst = torch.clamp(dst, 0, R - 1)
    down = valid & (dst > src)           # src == R-1 can never move down

    dest = torch.full_like(pages, R - 1)
    landed = torch.zeros_like(down)
    for r in range(1, R - 1):
        # occupancy after departures: every down-mover leaves its source
        occ_r = _count(tier == r) - _count(down & (src == r))
        cand = down & (~landed) & (dst <= r)
        rank = torch.cumsum(cand.to(i32), dim=1) - 1
        land = cand & (rank < (caps[:, r] - occ_r)[:, None])
        dest = torch.where(land, r, dest)
        landed = landed | land
    tier = scatter_drop(tier, pages, dest, down)
    mig_down = torch.stack([_count(down & (src <= j) & (dest > j))
                            for j in range(R - 1)], dim=1)

    # up phase: destination tiers shallowest first; sources re-read from
    # the updated placement, so room freed by ups out of a tier is seen
    # by ups into it.
    up_exec = torch.zeros_like(down)
    up_from = torch.zeros_like(pages)
    for r in range(R - 1):
        u_src = tier.gather(1, safe)
        cand = valid & (~down) & (dst == r) & (u_src > r)
        room = caps[:, r] - _count(tier == r)
        rank = torch.cumsum(cand.to(i32), dim=1) - 1
        take = cand & (rank < room[:, None])
        up_from = torch.where(take, u_src, up_from)
        tier = scatter_drop(tier, pages, r, take)
        up_exec = up_exec | take
    mig_up = torch.stack([_count(up_exec & (up_from > j) & (dst <= j))
                          for j in range(R - 1)], dim=1)
    return tier, up_exec, down, mig_up, mig_down


def wasteful_update(t: int, promoted_at, demoted_at, promote, demote, pexec,
                    dexec):
    """WASTE_WINDOW accounting for one interval (t = 0-based engine index).

    Returns (wasteful_this_interval i32 [B], promoted_at, demoted_at)."""
    p_safe = torch.where(pexec, promote, 0).long()
    d_safe = torch.where(dexec, demote, 0).long()
    waste = (_count(pexec & (t - demoted_at.gather(1, p_safe) <= WASTE_WINDOW))
             + _count(dexec
                      & (t - promoted_at.gather(1, d_safe) <= WASTE_WINDOW)))
    promoted_at = scatter_drop(promoted_at, promote, t, pexec)
    demoted_at = scatter_drop(demoted_at, demote, t, dexec)
    return waste, promoted_at, demoted_at


def apply_padded_migrations(in_fast, promote, demote, k):
    """Two-tier boolean executor over lanes: ``in_fast`` bool ``[B, n]``,
    ``promote``/``demote`` i32 ``[B, P]``/``[B, D]`` under the
    padded-index contract (``-1`` padding, valid entries unique page
    indices in priority order), ``k`` the fast capacity.

    Demotions of pages in the fast tier apply first; then promotions of
    pages not (any longer) in the fast tier, in plan order, capped by the
    free capacity after demotions.  Returns ``(in_fast, pexec, dexec)``:
    the new residency and bool masks of the executed entries."""
    d_safe = torch.where(demote >= 0, demote, 0).long()
    dexec = (demote >= 0) & in_fast.gather(1, d_safe)
    in_fast = scatter_drop(in_fast, demote, False, dexec)
    p_safe = torch.where(promote >= 0, promote, 0).long()
    p_ok = (promote >= 0) & ~in_fast.gather(1, p_safe)
    room = k - _count(in_fast)[:, None]
    rank = torch.cumsum(p_ok.to(torch.int32), dim=1) - 1
    pexec = p_ok & (rank < room)
    in_fast = scatter_drop(in_fast, promote, True, pexec)
    return in_fast, pexec, dexec


def apply_migrations(in_fast, promote, demote, valid, k):
    """Joint-``valid``-mask form (ARMS ``MigrationPlan`` layout) of
    ``apply_padded_migrations``: entries with ``valid`` False are padding
    in both arrays."""
    return apply_padded_migrations(
        in_fast, torch.where(valid, promote, -1),
        torch.where(valid & (demote >= 0), demote, -1), k)
