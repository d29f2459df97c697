"""Tiered-memory simulation engine: the numpy reference engine.

Replays a workload trace (true per-interval access counts) against a policy
that only sees PEBS-sampled counts + bandwidth signals, enforces migration
capacity/validity, charges migration traffic to tier bandwidth, and scores
execution time, migration counts, wasteful migrations, and hot-set recall.
Every interval carries identical application work, so ``exec_time = sum
(interval wall times)`` (the paper's "execution time for fixed work").

Policies arrive as stateful ``Policy`` objects (``ARMSPolicy``, or
``protocol.LegacyPolicyAdapter`` around any functional spec) and
migrations are variable-length index lists.  The engine's bookkeeping is
numpy on the host (placement, ``promoted_at``/``demoted_at``, the
wasteful window, the timelines, recall against ``oracle_topk_masks``);
the policy and the common-random-number (CRN) calls run on ``device``.
Under a shared CRN field (``sample_u``) the sampler, the accounting (the
``interval_account`` op, the hand-written kernel on the card) and the
tier-native utilization are the very functions the scan engine
(scan_engine.py) calls, so the two engines agree on every count.

Placement is an i32 per-page TIER INDEX over an N-tier chain
(simulator/machine_spec.py): promotions move pages to tier 0 (capped by
its capacity), demotions cascade down to the first tier with room, and
each adjacent pair crossed charges its endpoints' bandwidth.
"""
from __future__ import annotations

import dataclasses

import numpy as np

WASTE_WINDOW = 20  # intervals; promote->demote (or inverse) within = wasteful


@dataclasses.dataclass
class SimResult:
    name: str
    exec_time_s: float
    promotions: int
    demotions: int
    wasteful: int
    hot_recall: float            # mean fraction of oracle top-k held fast
    fast_hit_frac: float         # fraction of accesses served by fast tier
    # [T] per-interval series; None under the scan engine's streaming
    # reduction (reduce="stream"), which folds them into the summaries
    # below instead of materializing anything [T]-shaped.
    timeline_slow_bw: np.ndarray | None = None
    timeline_fast_hits: np.ndarray | None = None
    timeline_mode: np.ndarray | None = None  # ARMS mode (0 elsewhere)
    timeline_promotions: np.ndarray | None = None
    # streaming summaries (None under reduce="stack"; derive them from the
    # timelines there instead).
    mean_slow_bw: float | None = None
    mean_fast_hits: float | None = None
    mean_mode: float | None = None
    max_promotions_interval: int | None = None


def oracle_topk_masks(trace: np.ndarray, k: int) -> np.ndarray:
    """[T, n] bool mask of each interval's true top-k pages, vectorized.

    One partition over the whole trace instead of T per-interval ones.
    The tie rule is ``lax.top_k``'s — strictly-greater values first, then
    threshold-equal values by ascending page index — the same rule the
    interval-step ``topk_mask`` op follows.
    """
    trace = np.asarray(trace)
    n = trace.shape[1]
    assert 0 < k <= n
    kth = np.partition(trace, n - k, axis=1)[:, n - k, None]
    greater = trace > kth
    need = k - greater.sum(axis=1, keepdims=True, dtype=np.int32)
    eq = trace == kth
    # i32 cumsum: counts are bounded by n, and the default i64 temporary
    # would be 2x the trace's own footprint at bench scale
    return greater | (eq & (np.cumsum(eq, axis=1, dtype=np.int32) <= need))


def apply_tier_migrations_np(tier, promote, demote, caps):
    """Numpy mirror of ``simjax.apply_tier_migrations`` (variable-length
    index lists instead of padded arrays; mutates ``tier`` in place).

    Returns (promote_exec, demote_exec, mig_up, mig_down): the executed
    page-index arrays (priority order preserved) and the i64 [R-1]
    adjacent-pair crossing counts.
    """
    R = len(caps)
    demote = np.asarray(demote, np.int64)
    promote = np.asarray(promote, np.int64)

    src = tier[demote]
    keep = src < R - 1
    demote, src = demote[keep], src[keep]
    dest = np.full(len(demote), R - 1, np.int64)
    occ = np.bincount(tier, minlength=R).astype(np.int64)
    occ -= np.bincount(src, minlength=R)          # departures free slots
    landed = np.zeros(len(demote), bool)
    for r in range(1, R - 1):
        cand = np.flatnonzero(~landed & (src < r))
        take = cand[:max(int(caps[r] - occ[r]), 0)]
        dest[take] = r
        landed[take] = True
        occ[r] += len(take)
    tier[demote] = dest
    mig_down = np.array([((src <= j) & (dest > j)).sum()
                         for j in range(R - 1)], np.int64)

    p_src = tier[promote]
    keep = p_src > 0
    promote, p_src = promote[keep], p_src[keep]
    room = max(int(caps[0]) - int((tier == 0).sum()), 0)
    promote, p_src = promote[:room], p_src[:room]
    tier[promote] = 0
    mig_up = np.array([(p_src > j).sum() for j in range(R - 1)], np.int64)
    return promote, demote, mig_up, mig_down


def apply_targeted_migrations_np(tier, pages, dst, caps):
    """Numpy mirror of ``simjax.apply_targeted_migrations`` (variable-length
    aligned ``pages``/``dst`` lists; mutates ``tier`` in place).

    Returns (up_exec, down_exec, mig_up, mig_down): executed up-/down-move
    page arrays (priority order preserved) and i64 [R-1] pair crossings.
    """
    from repro_torch.simulator.simjax import DST_BELOW

    R = len(caps)
    pages = np.asarray(pages, np.int64)
    dst = np.asarray(dst, np.int64)
    src = tier[pages]
    dst = np.where(dst == DST_BELOW, src + 1, dst)
    dst = np.clip(dst, 0, R - 1)

    down_m = dst > src
    d_pages, d_src, d_dst = pages[down_m], src[down_m], dst[down_m]
    dest = np.full(len(d_pages), R - 1, np.int64)
    landed = np.zeros(len(d_pages), bool)
    for r in range(1, R - 1):
        occ_r = int((tier == r).sum()) - int((d_src == r).sum())
        cand = np.flatnonzero(~landed & (d_dst <= r))
        take = cand[:max(int(caps[r]) - occ_r, 0)]
        dest[take] = r
        landed[take] = True
    tier[d_pages] = dest
    mig_down = np.array([((d_src <= j) & (dest > j)).sum()
                         for j in range(R - 1)], np.int64)

    u_pages, u_dst = pages[~down_m], dst[~down_m]
    taken = np.zeros(len(u_pages), bool)
    u_from = np.zeros(len(u_pages), np.int64)
    for r in range(R - 1):
        u_src = tier[u_pages] if len(u_pages) else u_pages
        cand = np.flatnonzero((u_dst == r) & (u_src > r))
        room = max(int(caps[r]) - int((tier == r).sum()), 0)
        take = cand[:room]
        u_from[take] = u_src[take]
        tier[u_pages[take]] = r
        taken[take] = True
    mig_up = np.array([(taken & (u_from > j) & (u_dst <= j)).sum()
                       for j in range(R - 1)], np.int64)
    return u_pages[taken], d_pages, mig_up, mig_down


def run(policy, trace: np.ndarray, machine, k: int, seed: int = 0,
        sample_u: np.ndarray | None = None, device=None) -> SimResult:
    """Replay ``trace`` [T, n] under ``policy`` (a ``base.Policy``) on
    ``device`` (``None``: the CUDA card).

    ``machine``: registry name, two-tier ``MachineSpec``, or
    ``TieredMachineSpec`` (resolved via ``machines.get``).

    ``sample_u``: optional [T, n] uniform field switching PEBS sampling (and
    the cost model) to the common-random-number path shared with the scan
    engine: both engines then see the same noise and interval arithmetic,
    which is what makes exact cross-engine equivalence testable.  Default
    (None) keeps numpy Poisson sampling from ``np.random.default_rng
    (seed)`` and the host's f64 cost model.
    """
    import torch

    from repro_torch.kernels.interval_step import ops as interval_ops
    from repro_torch.simulator import machine_spec, machines, simjax
    from repro_torch.simulator.sampling import (pebs_sample,
                                                pebs_sample_from_uniform)
    from repro_torch.utils.device import f32_on, resolve_device

    dev = resolve_device(device)
    machine = machines.get(machine)
    R = machine.n_tiers
    T, n = trace.shape
    assert 0 < k <= n
    caps = machine_spec.resolved_caps(machine, n, k)
    rng = np.random.default_rng(seed)
    policy.reset(n, k, machine, dev)
    oracle_mask = oracle_topk_masks(trace, k)
    to_dev = lambda a: torch.from_numpy(
        np.require(a, requirements="CW")).to(dev)
    # the trace's f32 rows on the device: the true counts of policies that
    # want them, and of the CRN sampler and accounting
    true_dev = to_dev(np.asarray(trace, np.float32))
    if sample_u is not None:
        assert sample_u.shape == (T, n)
        u_dev = to_dev(np.asarray(sample_u, np.float32))
        oracle_dev = to_dev(oracle_mask)
        # one f32 conversion of the machine leaves before the loop, one
        # lane: the scan engine's cost arithmetic
        mach_dev, _ = machine_spec.lane_stack([machine], n, k, dev)

    tier = np.full(n, R - 1, np.int32)    # everything starts at the bottom
    promoted_at = np.full(n, -(10 ** 9))
    demoted_at = np.full(n, -(10 ** 9))
    tier_native = bool(getattr(policy, "tier_native", False))
    tier_util = np.zeros(R)               # last interval's per-tier load

    slow_bw_frac = 1.0   # everything starts slow
    app_bw_frac = 0.0
    exec_time = 0.0
    promotions = demotions = wasteful = 0
    acc_fast_total = acc_total = 0.0
    recall_sum = 0.0
    tl_slow = np.zeros(T)
    tl_hits = np.zeros(T)
    tl_mode = np.zeros(T, np.int32)
    tl_promos = np.zeros(T, np.int32)

    for t in range(T):
        true = trace[t]
        if policy.wants_true_counts():
            observed = true_dev[t]
        elif sample_u is not None:
            observed = pebs_sample_from_uniform(
                u_dev[t], true_dev[t], f32_on(policy.sampling_period(), dev))
        else:
            observed = torch.from_numpy(pebs_sample(
                true, policy.sampling_period(), rng).astype(np.float32)).to(
                    dev)

        if tier_native:
            pages, dstv = policy.step_tiers(
                observed, slow_bw_frac, app_bw_frac, tier_util, caps)
            # tier-targeted execution: ups/downs share the binary path's
            # wasteful/counter accounting (an up-move IS a promotion).
            promote, demote, mig_up, mig_down = apply_targeted_migrations_np(
                tier, pages, dstv, caps)
        else:
            promote, demote = policy.step(observed, slow_bw_frac,
                                          app_bw_frac)
            # --- engine-side validation, capacity + hop-chain execution ---
            promote, demote, mig_up, mig_down = apply_tier_migrations_np(
                tier, promote, demote, caps)

        # --- wasteful-migration accounting ---
        wasteful += int((t - demoted_at[promote] <= WASTE_WINDOW).sum())
        wasteful += int((t - promoted_at[demote] <= WASTE_WINDOW).sum())
        promoted_at[promote] = t
        demoted_at[demote] = t
        promotions += len(promote)
        demotions += len(demote)
        tl_promos[t] = len(promote)

        # --- cost model ---
        if sample_u is not None:
            # CRN mode: the scan engine's f32 arithmetic (the same op)
            tier_dev = to_dev(tier)[None]
            up = torch.from_numpy(mig_up.astype(np.float32)).to(dev)[None]
            down = torch.from_numpy(mig_down.astype(np.float32)).to(dev)[None]
            acc = interval_ops.interval_account(
                mach_dev, true_dev[t][None], tier_dev, up, down,
                oracle_dev[t][None], k)
            acc_fast, acc_slow, wall, slow_share, app_raw = (
                float(v) for v in torch.cat(acc[:5]).cpu())
        else:
            in_fast = tier == 0
            acc_fast = float(true[in_fast].sum())
            accs = [acc_fast]
            rest = float(true.sum()) - acc_fast
            for r in range(1, R - 1):
                a = float(true[tier == r].sum())
                accs.append(a)
                rest -= a
            accs.append(rest)
            acc_slow = sum(accs[1:])
            wall, slow_share, app_raw, _ = machine_spec.interval_outcome_host(
                machine, accs, mig_up, mig_down)
        # policy-mechanism overhead charged to the application (e.g. TPP's
        # NUMA hint faults are taken on slow-tier accesses).
        extra_ns = getattr(policy, "slow_access_extra_ns", 0.0)
        if extra_ns:
            wall += acc_slow * extra_ns * 1e-9 / float(machine.mlp)
        exec_time += wall
        # The paper's PHT input is slow-tier bandwidth; when the slow tier
        # saturates, utilization pegs at 1 and carries no signal, so we feed
        # the underlying quantity PHT is meant to detect (§4.2: "more memory
        # references go to the slow tier"): the slow-access share.
        slow_bw_frac = slow_share
        # consumer-side clamp of the RAW utilization ratio: the policy
        # signal stays in [0,1].
        app_bw_frac = min(1.0, app_raw)
        if tier_native:
            if sample_u is not None:
                tier_util = simjax.tier_utilization_impl(
                    mach_dev, true_dev[t][None], tier_dev, up, down)[0]
            else:
                tier_util = machine_spec.tier_utilization_host(
                    machine, accs, mig_up, mig_down)

        acc_fast_total += acc_fast
        acc_total += acc_fast + acc_slow
        recall_sum += float((tier == 0)[oracle_mask[t]].sum()) / k
        tl_slow[t] = slow_bw_frac
        tl_hits[t] = acc_fast / max(acc_fast + acc_slow, 1e-9)
        tl_mode[t] = getattr(policy, "mode", 0)

    return SimResult(
        name=policy.name, exec_time_s=exec_time, promotions=promotions,
        demotions=demotions, wasteful=wasteful,
        hot_recall=recall_sum / T,
        fast_hit_frac=acc_fast_total / max(acc_total, 1e-9),
        timeline_slow_bw=tl_slow, timeline_fast_hits=tl_hits,
        timeline_mode=tl_mode, timeline_promotions=tl_promos)
