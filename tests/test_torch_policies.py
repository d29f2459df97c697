"""Port parity of the binary policy families (HeMem, Memtis, TPP, all-slow,
oracle) and the protocol helpers they share, against the JAX package on
the same seeded numpy inputs.

  * helpers (``ranked_take``, ``truncate_ranked``, ``scatter_set``,
    ``capacity_victims``) on keys with repeated values and both signed
    zeros: exact;
  * one policy pass per family from a JAX state carried across with
    ``convert``: plans and new state exact;
  * ``sweep_policy_configs`` per family against JAX's on the same CRN
    field, on the 2-tier ``pmem-large`` and the 3-tier ``dram-cxl-pmem``,
    under the replay contract (``_torch_cases.same_result``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cases import ranked_keys, same_result
from repro.baselines import hemem as jhemem
from repro.baselines import memtis as jmemtis
from repro.baselines import protocol as jproto
from repro.baselines import static as jstatic
from repro.baselines import tpp as jtpp
from repro.simulator import machines as jmachines
from repro.simulator import scan_engine as jscan
from repro.simulator import workloads
from repro.simulator.sampling import uniform_field
from repro_torch import convert
from repro_torch.baselines import hemem, memtis, protocol, static, tpp
from repro_torch.simulator import machine_spec, machines
from repro_torch.simulator import scan_engine as pscan
from repro_torch.utils.pytree import lane_specs

T, N, K = 96, 512, 64
MACHINES = ["pmem-large", "dram-cxl-pmem"]
# family -> (JAX maker, port maker, a 3-lane knob grid)
FAMILIES = {
    "hemem": (jhemem.HeMemSpec.make, hemem.HeMemSpec.make,
              [dict(hot_threshold=4.0, migration_period=1),
               dict(hot_threshold=8.0, migration_period=2),
               dict(hot_threshold=16.0, cooling_threshold=40.0,
                    migration_period=5)]),
    "memtis": (jmemtis.MemtisSpec.make, memtis.MemtisSpec.make,
               [dict(cooling_period_samples=2e3, adaptation_period=2),
                dict(cooling_period_samples=5e4, adaptation_period=5),
                dict(cooling_period_samples=2e6, adaptation_period=10)]),
    "tpp": (jtpp.TPPSpec.make, tpp.TPPSpec.make,
            [dict(promote_hits=1.0, watermark=0.9),
             dict(promote_hits=2.0, watermark=0.98),
             dict(promote_hits=8.0, watermark=0.995)]),
    "oracle": (lambda: jstatic.OracleSpec(), lambda: static.OracleSpec(),
               [dict()]),
    "all-slow": (lambda: jstatic.AllSlowSpec(),
                 lambda: static.AllSlowSpec(), [dict()]),
}


def _t(x):
    return torch.from_numpy(np.array(x))


def _trace(name):
    if name == "gups-shift":   # GUPS with its hot set relocating in T
        return workloads.gups(T, N, shift_every=24)
    return workloads.make(name, T=T, n=N)


# ------------------------------------------------------------- helpers
@pytest.mark.parametrize("limit", [None, 3, "lanes"])
@pytest.mark.parametrize("pad", [1, 7, 40])
def test_ranked_take_matches_jax(pad, limit):
    rng = np.random.default_rng(pad)
    B, n = 4, 40
    key = ranked_keys(rng, B, n)
    mask = rng.random((B, n)) < 0.6
    lim = (rng.integers(0, n, B).astype(np.int32) if limit == "lanes"
           else limit)
    want = [jproto.ranked_take(jnp.asarray(key[b]), jnp.asarray(mask[b]),
                               pad, None if lim is None else
                               (lim[b] if limit == "lanes" else lim))
            for b in range(B)]
    got_idx, got_cnt = protocol.ranked_take(
        _t(key), _t(mask), pad, _t(lim) if limit == "lanes" else lim)
    np.testing.assert_array_equal(got_idx.numpy(),
                                  np.stack([np.asarray(w[0]) for w in want]))
    np.testing.assert_array_equal(got_cnt.numpy(),
                                  [int(w[1]) for w in want])
    kept = rng.integers(0, pad + 1, B).astype(np.int32)
    np.testing.assert_array_equal(
        protocol.truncate_ranked(got_idx, _t(kept)).numpy(),
        np.stack([np.asarray(jproto.truncate_ranked(w[0], kept[b]))
                  for b, w in enumerate(want)]))


@pytest.mark.parametrize("extra", [0, "lanes"])
def test_capacity_victims_and_scatter_set_match_jax(extra):
    rng = np.random.default_rng(11)
    B, n, k, pad = 5, 64, 16, 16
    in_fast = np.zeros((B, n), bool)
    for b in range(B):
        in_fast[b, rng.permutation(n)[:rng.integers(0, k + 1)]] = True
    cold = ranked_keys(rng, B, n)
    cold_mask = in_fast & (rng.random((B, n)) < 0.7)
    n_want = rng.integers(0, 12, B).astype(np.int32)
    ext = (rng.integers(-4, 6, B).astype(np.int32) if extra == "lanes"
           else extra)
    got = protocol.capacity_victims(
        _t(in_fast), _t(cold), _t(cold_mask), _t(n_want), k, pad,
        _t(ext) if extra == "lanes" else ext)
    for b in range(B):
        want = jproto.capacity_victims(
            jnp.asarray(in_fast[b]), jnp.asarray(cold[b]),
            jnp.asarray(cold_mask[b]), jnp.int32(n_want[b]), k, pad,
            ext[b] if extra == "lanes" else ext)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[b].numpy(), np.asarray(w))
        np.testing.assert_array_equal(
            protocol.scatter_set(_t(in_fast), got[0], False)[b].numpy(),
            np.asarray(jproto.scatter_set(jnp.asarray(in_fast[b]), want[0],
                                          False)))


# ------------------------------------------------------- one policy pass
def _observed(rng, n, t):
    obs = rng.poisson(0.4, n).astype(np.float32)
    hot = (np.arange(n) + 7 * t) % n < n // 8          # a drifting hot set
    obs[hot] += rng.poisson(4.0, hot.sum())
    return obs


@pytest.mark.parametrize("family", list(FAMILIES))
def test_policy_pass_matches_jax(family):
    """A JAX state after 9 jitted intervals, carried across: the next
    observe and policy pass give the same plans and state bit for bit,
    and so does the reference ``step`` (observe, then the pass where the
    policy fires)."""
    jmake, pmake, _ = FAMILIES[family]
    n, k = 256, 32
    rng = np.random.default_rng(5)
    jspec = jmake()
    jmach = jmachines.get("dram-cxl-pmem")
    step = jax.jit(lambda st, o: jspec.step(st, o, jnp.float32(0.6),
                                            jnp.float32(0.3), k))
    st = jspec.init(n, k, jmach)
    for t in range(9):
        st, _, _ = step(st, jnp.asarray(_observed(rng, n, t)))
    obs = _observed(rng, n, 9)
    jst = jax.jit(jspec.observe)(st, jnp.asarray(obs))
    jout = jax.jit(lambda s: jspec.policy(s, jnp.float32(0.6),
                                          jnp.float32(0.3), k))(jst)

    spec = lane_specs(convert.policy_spec(jspec, device="cpu"), 1)
    pst = convert.policy_state(jax.tree_util.tree_map(np.asarray, st),
                               family, device="cpu")
    sl, ap = torch.tensor([0.6]), torch.tensor([0.3])
    pout = spec.policy(spec.observe(pst, _t(obs)[None]), sl, ap, k)
    _same_pass(pout, jout)
    _same_pass(spec.step(pst, _t(obs)[None], sl, ap, k),
               step(st, jnp.asarray(obs)))


def _same_pass(got, want):
    """(state, plan, plan) of one lane against JAX's, bit for bit."""
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g[0].numpy(), np.asarray(w))
    for f in dataclasses.fields(got[0]):
        np.testing.assert_array_equal(getattr(got[0], f.name)[0].numpy(),
                                      np.asarray(getattr(want[0], f.name)),
                                      err_msg=f.name)


def test_convert_keeps_lanes_and_meta():
    jspec = jhemem.HeMemSpec.make(hot_threshold=5.0, migration_limit=7)
    spec = convert.policy_spec(jspec, device="cpu")
    assert spec.migration_limit == 7 and spec.pad_promote(100, 10) == 7
    assert spec.hot_threshold.dtype == torch.float32
    assert spec.migration_period.dtype == torch.int32
    jst = jax.vmap(lambda _: jspec.init(16, 4, None))(jnp.arange(3))
    st = convert.policy_state(jax.tree_util.tree_map(np.asarray, jst),
                              "hemem", device="cpu")
    assert st.counts.shape == (3, 16) and st.t.shape == (3,)


# -------------------------------------------------- the whole replay
@pytest.mark.parametrize("machine", MACHINES)
@pytest.mark.parametrize("family", list(FAMILIES))
def test_sweep_policy_configs_matches_jax(family, machine):
    jmake, pmake, grid = FAMILIES[family]
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
        assert pscan.last_dispatch["lane_intervals"] == len(grid) * T
        if family != "all-slow":
            assert sum(r.promotions for r in got) > 0


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    u = uniform_field(T, N)
    with pytest.raises(RuntimeError, match="CUDA"):
        pscan.simulate(tpp.TPPSpec.make(), _trace("gups"), "pmem-large", K,
                       sample_u=u)
    with pytest.raises(RuntimeError, match="CUDA"):
        pscan.sweep_policy_configs(hemem.HeMemSpec.make, _trace("gups"),
                                   "pmem-large", K, [dict()], sample_u=u)


def test_machine_lanes_are_shared():
    """The lane-batched port machine feeds each family's init."""
    mach, _ = machine_spec.lane_stack([machines.get("dram-cxl-pmem")] * 2,
                                      N, K, device="cpu")
    for _, pmake, _ in FAMILIES.values():
        st = pmake().init(N, K, mach)
        assert st.t.shape == (2,)
