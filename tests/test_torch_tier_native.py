"""Port parity of the tier-native route against the JAX package: the plan
helpers (``rank_desc``, ``rank_partition``, ``pair_limit``, ``tier_plan``,
``scheduler.pair_budgets``), the tier-targeted executor
(``simjax.apply_targeted_migrations``) and the utilization signal, one
policy pass of each tier-native family (HybridTier, Jenga, TierBPF), their
``sweep_policy_configs`` on 2- and 3-tier machines, and the binary shim.

Integer outputs exact throughout.  ``tier_utilization_impl`` divides
per-tier access sums that the JAX package accumulates in f32 and the port
rounds once from f64, so it is held within 1e-6 relative; the f64 host
mirror ``tier_utilization_host`` is exact.  Replays are held to the replay
contract (``_torch_cases.same_result``); the shim's replay equals the
hop-chain route's bit for bit, and JAX's shim under the contract.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cases import ranked_keys, same_result
from repro.baselines import arms_policy as jarms
from repro.baselines import hemem as jhemem
from repro.baselines import hybridtier as jhybrid
from repro.baselines import jenga as jjenga
from repro.baselines import memtis as jmemtis
from repro.baselines import protocol as jproto
from repro.baselines import static as jstatic
from repro.baselines import tierbpf as jtierbpf
from repro.baselines import tpp as jtpp
from repro.core import scheduler as jsched
from repro.simulator import machine_spec as jms
from repro.simulator import machines as jmachines
from repro.simulator import scan_engine as jscan
from repro.simulator import simjax as jsimjax
from repro.simulator import workloads
from repro.simulator.sampling import uniform_field
from repro_torch import convert
from repro_torch.baselines import (arms_policy, hemem, hybridtier, jenga,
                                   memtis, protocol, static, tierbpf, tpp)
from repro_torch.core import scheduler
from repro_torch.simulator import machine_spec, machines, simjax
from repro_torch.simulator import scan_engine as pscan
from repro_torch.utils.pytree import lane_specs

T, N, K = 96, 512, 64
MACHINES = ["pmem-large", "dram-cxl-pmem"]
TIER_FAMILIES = {
    "hybridtier": (jhybrid.HybridTierSpec.make, hybridtier.HybridTierSpec.make,
                   [dict(hot_thresh=2.0, decay=0.5),
                    dict(hot_thresh=6.0, decay=0.7, migration_period=1),
                    dict(hot_thresh=9.0, decay=0.9, warm_thresh=0.5)]),
    "jenga": (jjenga.JengaSpec.make, jenga.JengaSpec.make,
              [dict(alpha=0.3, confirm=1), dict(alpha=0.7, confirm=3),
               dict(alpha=0.9, confirm=2, cooldown=0)]),
    "tierbpf": (jtierbpf.TierBPFSpec.make, tierbpf.TierBPFSpec.make,
                [dict(admit_thresh=1.0, thrash_gain=0.5),
                 dict(admit_thresh=4.0, thrash_gain=4.0),
                 dict(admit_thresh=2.0, thrash_gain=1.0, migration_period=1)]),
}
BINARY_FAMILIES = {
    "arms": (jarms.ARMSSpec.make, arms_policy.ARMSSpec.make),
    "hemem": (jhemem.HeMemSpec.make, hemem.HeMemSpec.make),
    "memtis": (lambda: jmemtis.MemtisSpec.make(2e3, 2),
               lambda: memtis.MemtisSpec.make(2e3, 2)),
    "tpp": (jtpp.TPPSpec.make, tpp.TPPSpec.make),
    "all-slow": (jstatic.AllSlowSpec, static.AllSlowSpec),
    "oracle": (jstatic.OracleSpec, static.OracleSpec),
}


def _t(x):
    return torch.from_numpy(np.array(x))


def _trace(name):
    if name == "gups-shift":   # GUPS with its hot set relocating in T
        return workloads.gups(T, N, shift_every=24)
    return workloads.make(name, T=T, n=N)


def _caps(rng, R, n):
    return np.asarray([8] + [int(rng.integers(4, 16)) for _ in range(R - 2)]
                      + [n], np.int32)


# ------------------------------------------------------------- helpers
@pytest.mark.parametrize("R", [2, 3, 4])
def test_rank_helpers_match_jax(R):
    """``rank_desc`` (stable, -0.0 == +0.0) and ``rank_partition`` on rows
    with repeated values and both signed zeros."""
    rng = np.random.default_rng(R)
    B, n = 4, 48
    score = ranked_keys(rng, B, n)
    caps = np.stack([_caps(rng, R, n) for _ in range(B)])
    rank = protocol.rank_desc(_t(score))
    part = protocol.rank_partition(rank, _t(caps))
    for b in range(B):
        jr = jproto.rank_desc(jnp.asarray(score[b]))
        np.testing.assert_array_equal(rank[b].numpy(), np.asarray(jr))
        np.testing.assert_array_equal(
            part[b].numpy(),
            np.asarray(jproto.rank_partition(jr, jnp.asarray(caps[b]))))


@pytest.mark.parametrize("R", [2, 3, 4])
def test_pair_limit_and_budgets_match_jax(R):
    rng = np.random.default_rng(10 + R)
    B, m = 4, 40
    lo = rng.integers(0, R, (B, m)).astype(np.int32)
    hi = rng.integers(0, R, (B, m)).astype(np.int32)
    valid = rng.random((B, m)) < 0.8
    # utilizations on and past the budget formula's clip points, and raw
    # ratios above 1
    util = rng.choice(np.float32([0.0, 0.25, 0.5, 0.999, 1.0, 1.7]),
                      (B, R)).astype(np.float32)
    util[:, 0] = rng.random(B).astype(np.float32)
    bud = scheduler.pair_budgets(_t(util), 16)
    ok = protocol.pair_limit(_t(lo), _t(hi), _t(valid), bud)
    for b in range(B):
        jb = jsched.pair_budgets(jnp.asarray(util[b]), 16)
        np.testing.assert_array_equal(bud[b].numpy(), np.asarray(jb))
        np.testing.assert_array_equal(ok[b].numpy(), np.asarray(
            jproto.pair_limit(jnp.asarray(lo[b]), jnp.asarray(hi[b]),
                              jnp.asarray(valid[b]), jb)))


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("R", [2, 3, 4])
def test_tier_plan_matches_jax(R, seed):
    rng = np.random.default_rng(100 * R + seed)
    B, n = 3, 64
    score = ranked_keys(rng, B, n)
    caps = np.stack([_caps(rng, R, n) for _ in range(B)])
    cur = np.full((B, n), R - 1, np.int32)
    for b in range(B):   # a feasible residency belief
        perm = rng.permutation(n)
        at = 0
        for r in range(R - 1):
            fill = int(rng.integers(0, caps[b, r] + 1))
            cur[b, perm[at:at + fill]] = r
            at += fill
    target = rng.integers(0, R, (B, n)).astype(np.int32)
    budgets = rng.integers(1, 12, (B, R - 1)).astype(np.int32)
    got = protocol.tier_plan(_t(score), _t(cur), _t(target), _t(caps),
                             _t(budgets), 10, 7)
    for b in range(B):
        want = jproto.tier_plan(jnp.asarray(score[b]), jnp.asarray(cur[b]),
                                jnp.asarray(target[b]), jnp.asarray(caps[b]),
                                jnp.asarray(budgets[b]), 10, 7)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[b].numpy(), np.asarray(w))


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("R", [2, 3, 4])
def test_targeted_migrations_match_jax(R, seed):
    """Random plans with ``DST_BELOW`` entries, ups and downs, and five
    trailing sentinels (which must change nothing)."""
    rng = np.random.default_rng(1000 * R + seed)
    B, n, m = 4, 64, 24
    caps = np.stack([_caps(rng, R, n) for _ in range(B)])
    tier = rng.integers(0, R, (B, n)).astype(np.int32)
    for b in range(B):   # feasible starting occupancy
        for r in range(R - 1):
            tier[b, np.flatnonzero(tier[b] == r)[caps[b, r]:]] = R - 1
    pages = np.stack([rng.choice(n, m, replace=False)
                      for _ in range(B)]).astype(np.int32)
    dst = rng.integers(-2, R, (B, m)).astype(np.int32)
    pages = np.concatenate([pages, np.full((B, 5), -1, np.int32)], 1)
    dst = np.concatenate([dst, np.zeros((B, 5), np.int32)], 1)
    assert simjax.DST_BELOW == jsimjax.DST_BELOW == -2
    got = simjax.apply_targeted_migrations(_t(tier), _t(pages), _t(dst),
                                           _t(caps))
    short = simjax.apply_targeted_migrations(_t(tier), _t(pages[:, :m]),
                                             _t(dst[:, :m]), _t(caps))
    tier2, up, down, mig_up, mig_down = got
    # the trailing sentinels: the same moves, never executed
    np.testing.assert_array_equal(tier2.numpy(), short[0].numpy())
    np.testing.assert_array_equal(up[:, :m].numpy(), short[1].numpy())
    np.testing.assert_array_equal(down[:, :m].numpy(), short[2].numpy())
    assert not (up[:, m:] | down[:, m:]).any()
    np.testing.assert_array_equal(mig_up.numpy(), short[3].numpy())
    np.testing.assert_array_equal(mig_down.numpy(), short[4].numpy())
    for b in range(B):
        want = jsimjax.apply_targeted_migrations(
            jnp.asarray(tier[b]), jnp.asarray(pages[b]), jnp.asarray(dst[b]),
            jnp.asarray(caps[b]))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[b].numpy(), np.asarray(w))


@pytest.mark.parametrize("machine", MACHINES + ["hbm-pcie"])
def test_tier_utilization_matches_jax(machine):
    rng = np.random.default_rng(7)
    B, n, k = 3, 512, 64
    spec = machines.get(machine)
    R = spec.n_tiers
    pmach, _ = machine_spec.lane_stack([spec] * B, n, k, device="cpu")
    jmach, _ = jms.lane_stack([jmachines.get(machine)] * B, n, k)
    true = rng.gamma(1.5, 2.0, (B, n)).astype(np.float32)
    tier = rng.integers(0, R, (B, n)).astype(np.int32)
    up = rng.integers(0, 40, (B, R - 1)).astype(np.float32)
    down = rng.integers(0, 40, (B, R - 1)).astype(np.float32)
    got = simjax.tier_utilization_impl(pmach, _t(true), _t(tier), _t(up),
                                       _t(down))
    want = jax.jit(jax.vmap(jsimjax.tier_utilization_impl))(
        jmach, jnp.asarray(true), jnp.asarray(tier), jnp.asarray(up),
        jnp.asarray(down))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=0)
    acc = np.stack([true[0][tier[0] == r].sum(dtype=np.float64)
                    for r in range(R)])
    np.testing.assert_array_equal(
        machine_spec.tier_utilization_host(spec, acc, up[0], down[0]),
        jms.tier_utilization_host(jmachines.get(machine), acc, up[0],
                                  down[0]))


# ------------------------------------------------------- one policy pass
@pytest.mark.parametrize("machine", MACHINES)
@pytest.mark.parametrize("family", list(TIER_FAMILIES))
def test_tier_policy_pass_matches_jax(family, machine):
    """A JAX state after 9 jitted intervals, carried across: the next
    observe and tier policy pass give the same moves and state bit for
    bit, and so does the reference ``step_tiers``."""
    jmake, _, _ = TIER_FAMILIES[family]
    n, k = 256, 32
    rng = np.random.default_rng(9)
    jspec = jmake(migration_period=1)
    jmach = jmachines.get(machine)
    R = jmach.n_tiers
    caps = jnp.asarray(jms.resolved_caps(jmach, n, k))
    util = lambda: jnp.asarray(rng.random(R).astype(np.float32))
    obs_of = lambda t: jnp.asarray(
        (rng.poisson(0.4, n) + 4 * ((np.arange(n) + 5 * t) % n < n // 6))
        .astype(np.float32))
    step = jax.jit(lambda st, o, u: jspec.step_tiers(
        st, o, u, jnp.float32(0.6), jnp.float32(0.3), k, caps))
    st = jspec.init(n, k, jmach)
    for t in range(9):
        st, _, _ = step(st, obs_of(t), util())
    obs, tu = obs_of(9), util()
    jst = jax.jit(jspec.observe)(st, obs)
    jout = jax.jit(lambda s: jspec.tier_policy(
        s, tu, jnp.float32(0.6), jnp.float32(0.3), k, caps))(jst)

    spec = lane_specs(convert.policy_spec(jspec, device="cpu"), 1)
    pst = convert.policy_state(jax.tree_util.tree_map(np.asarray, st),
                               family, device="cpu")
    sl, ap, pcaps = torch.tensor([0.6]), torch.tensor([0.3]), _t(caps)[None]
    pout = spec.tier_policy(spec.observe(pst, _t(obs)[None]), _t(tu)[None],
                            sl, ap, k, pcaps)
    _same_pass(pout, jout)
    assert int((np.asarray(jout[1]) >= 0).sum()) > 0
    _same_pass(spec.step_tiers(pst, _t(obs)[None], _t(tu)[None], sl, ap, k,
                               pcaps), step(st, obs, tu))


def _same_pass(got, want):
    """(state, pages, dst) of one lane against JAX's, bit for bit."""
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g[0].numpy(), np.asarray(w))
    for f in dataclasses.fields(got[0]):
        np.testing.assert_array_equal(getattr(got[0], f.name)[0].numpy(),
                                      np.asarray(getattr(want[0], f.name)),
                                      err_msg=f.name)


# -------------------------------------------------- the whole replay
@pytest.mark.parametrize("machine", MACHINES)
@pytest.mark.parametrize("family", list(TIER_FAMILIES))
def test_tier_sweep_matches_jax(family, machine):
    jmake, pmake, grid = TIER_FAMILIES[family]
    for wl in ("gups-shift", "silo-tpcc"):
        trace = _trace(wl)
        u = uniform_field(T, N, seed=3)
        want = jscan.sweep_policy_configs(jmake, trace, machine, K, grid,
                                          sample_u=u)
        got = pscan.sweep_policy_configs(pmake, trace, machine, K, grid,
                                         sample_u=u, device="cpu")
        assert [r.name for r in got] == [r.name for r in want]
        for a, b in zip(want, got):
            same_result(a, b)
        assert sum(r.promotions for r in got) > 0


@pytest.mark.parametrize("machine", MACHINES)
@pytest.mark.parametrize("family", list(BINARY_FAMILIES))
def test_shim_equals_hop_chain(family, machine):
    """A binary spec through the tier-targeted executor equals the
    hop-chain route bit for bit, and JAX's shim under the contract."""
    jmake, pmake = BINARY_FAMILIES[family]
    trace = _trace("gups-shift")
    u = uniform_field(T, N, seed=123)
    base = pscan.simulate(pmake(), trace, machine, K, sample_u=u,
                          device="cpu")
    shim = pscan.simulate(pmake(), trace, machine, K, sample_u=u,
                          tier_shim=True, device="cpu")
    assert (base.promotions, base.demotions, base.wasteful) == \
        (shim.promotions, shim.demotions, shim.wasteful)
    assert base.exec_time_s == shim.exec_time_s
    assert base.hot_recall == shim.hot_recall
    assert base.fast_hit_frac == shim.fast_hit_frac
    for nm in ("promotions", "mode", "slow_bw", "fast_hits"):
        np.testing.assert_array_equal(getattr(base, f"timeline_{nm}"),
                                      getattr(shim, f"timeline_{nm}"))
    same_result(jscan.simulate(jmake(), trace, machine, K, sample_u=u,
                               tier_shim=True), shim)
    if family != "all-slow":
        assert base.promotions > 0
