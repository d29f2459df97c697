"""Port parity of the numpy reference engine (repro_torch/simulator/
engine.py::run, baselines/base.py, protocol.LegacyPolicyAdapter, the
family adapters and arms_policy.ARMSPolicy).

* ``engine.run`` of the port against JAX's for ARMSPolicy and the nine
  registry families (ARMS through the generic adapter), on gups and
  silo-tpcc, under CRN and numpy Poisson sampling: promotions, demotions,
  wasteful, ``timeline_promotions`` and ``timeline_mode`` exact;
  ``exec_time_s``, ``hot_recall`` and ``fast_hit_frac`` within 1e-4
  relative.  Binary families on ``pmem-large``, tier-native ones on the
  3-tier ``dram-cxl-pmem``.
* The port's numpy engine against the port's scan engine under one CRN
  field, every family (the JAX package's tests/test_scan_engine.py
  equivalence): the same checks.
* The two numpy executors against JAX's and against the port's padded
  executors (``simjax``) on random plans, exactly.
"""
import numpy as np
import pytest
import torch

from repro.baselines import arms_policy as JA
from repro.baselines import hemem as JH
from repro.baselines import hybridtier as JHT
from repro.baselines import jenga as JJ
from repro.baselines import memtis as JM
from repro.baselines import protocol as JP
from repro.baselines import static as JS
from repro.baselines import tierbpf as JTB
from repro.baselines import tpp as JT
from repro.simulator import engine as JE
from repro.simulator import workloads
from repro.simulator.sampling import uniform_field
from repro_torch.baselines import arms_policy as A
from repro_torch.baselines import hemem as H
from repro_torch.baselines import hybridtier as HT
from repro_torch.baselines import jenga as J
from repro_torch.baselines import memtis as M
from repro_torch.baselines import protocol as P
from repro_torch.baselines import static as S
from repro_torch.baselines import tierbpf as TB
from repro_torch.baselines import tpp as TP
from repro_torch.simulator import engine as E
from repro_torch.simulator import scan_engine, simjax

T, N, K = 96, 512, 64
BINARY, TIERED = "pmem-large", "dram-cxl-pmem"

# name -> (JAX policy, port policy, port spec for the scan engine, machine)
POLICIES = {
    "ARMSPolicy": (JA.ARMSPolicy, A.ARMSPolicy, A.ARMSSpec.make, BINARY),
    "arms": (lambda: JP.LegacyPolicyAdapter(JA.ARMSSpec.make()),
             lambda: P.LegacyPolicyAdapter(A.ARMSSpec.make()),
             A.ARMSSpec.make, BINARY),
    "hemem": (JH.HeMemPolicy, H.HeMemPolicy, H.HeMemSpec.make, BINARY),
    "memtis": (JM.MemtisPolicy, M.MemtisPolicy, M.MemtisSpec.make, BINARY),
    "tpp": (JT.TPPPolicy, TP.TPPPolicy, TP.TPPSpec.make, BINARY),
    "all-slow": (JS.AllSlowPolicy, S.AllSlowPolicy, S.AllSlowSpec, BINARY),
    "oracle": (JS.OraclePolicy, S.OraclePolicy, S.OracleSpec, BINARY),
    "hybridtier": (JHT.HybridTierPolicy, HT.HybridTierPolicy,
                   HT.HybridTierSpec.make, TIERED),
    "jenga": (JJ.JengaPolicy, J.JengaPolicy, J.JengaSpec.make, TIERED),
    "tierbpf": (JTB.TierBPFPolicy, TB.TierBPFPolicy, TB.TierBPFSpec.make,
                TIERED),
}

_TRACES = {}


def _trace(wl):
    if wl not in _TRACES:
        _TRACES[wl] = (workloads.make(wl, T=T, n=N),
                       uniform_field(T, N, seed=31))
    return _TRACES[wl]


def _same(got, want):
    for nm in ("promotions", "demotions", "wasteful"):
        assert getattr(got, nm) == getattr(want, nm), nm
    for nm in ("timeline_promotions", "timeline_mode"):
        np.testing.assert_array_equal(getattr(got, nm), getattr(want, nm),
                                      err_msg=nm)
    for nm in ("exec_time_s", "hot_recall", "fast_hit_frac"):
        np.testing.assert_allclose(getattr(got, nm), getattr(want, nm),
                                   rtol=1e-4, err_msg=nm)


@pytest.mark.parametrize("crn", [True, False], ids=["crn", "poisson"])
@pytest.mark.parametrize("wl", ["gups", "silo-tpcc"])
@pytest.mark.parametrize("name", list(POLICIES))
def test_run_matches_jax(name, wl, crn):
    jpol, pol, _, mach = POLICIES[name]
    trace, u = _trace(wl)
    su = u if crn else None
    want = JE.run(jpol(), trace, mach, K, seed=3, sample_u=su)
    got = E.run(pol(), trace, mach, K, seed=3, sample_u=su, device="cpu")
    assert got.name == want.name
    _same(got, want)
    np.testing.assert_allclose(got.timeline_slow_bw, want.timeline_slow_bw,
                               rtol=1e-4, atol=1e-7)


@pytest.mark.parametrize("wl", ["gups", "silo-tpcc"])
@pytest.mark.parametrize("name", list(POLICIES))
def test_numpy_engine_matches_scan_engine(name, wl):
    _, pol, make_spec, mach = POLICIES[name]
    trace, u = _trace(wl)
    ref = E.run(pol(), trace, mach, K, sample_u=u, device="cpu")
    out = scan_engine.simulate(make_spec(), trace, mach, K, sample_u=u,
                               device="cpu")
    _same(out, ref)


def test_adapter_matches_hand_tuned_arms_policy():
    """ARMSSpec through the generic adapter reproduces ARMSPolicy (same
    controller; the adapter reads the cadence from the device), on btree,
    where the hot set moves and ARMS enters recency mode."""
    trace, u = _trace("btree")
    a = E.run(A.ARMSPolicy(), trace, BINARY, K, sample_u=u, device="cpu")
    b = E.run(P.LegacyPolicyAdapter(A.ARMSSpec.make()), trace, BINARY, K,
              sample_u=u, device="cpu")
    _same(a, b)
    assert a.timeline_mode.any()


def test_run_defaults_to_the_card():
    trace, u = _trace("gups")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            E.run(A.ARMSPolicy(), trace, BINARY, K, sample_u=u)


def _random_plan(rng, n, R):
    tier = rng.integers(0, R, n).astype(np.int32)
    caps = np.append(rng.integers(n // (2 * R), n // R + 2, R - 1), n)
    perm = rng.permutation(n)
    npro = rng.integers(0, n // 3)
    nde = rng.integers(0, n // 3)
    return tier, perm[:npro], perm[npro:npro + nde], caps


def _pad(idx, width, fill=-1):
    out = np.full(width, fill, np.int32)
    out[:len(idx)] = idx
    return out


@pytest.mark.parametrize("R", [2, 3, 4])
@pytest.mark.parametrize("seed", range(4))
def test_tier_executor_matches_jax_and_padded(R, seed):
    rng = np.random.default_rng(seed * 10 + R)
    n = 96
    tier, promote, demote, caps = _random_plan(rng, n, R)
    jt, pt = tier.copy(), tier.copy()
    want = JE.apply_tier_migrations_np(jt, promote, demote, caps)
    got = E.apply_tier_migrations_np(pt, promote, demote, caps)
    np.testing.assert_array_equal(pt, jt)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    # the scan engine's padded executor lands every page in the same tier
    # and counts the same crossings
    t2, pexec, dexec, up, down = simjax.apply_tier_migrations(
        torch.from_numpy(tier)[None],
        torch.from_numpy(_pad(promote, n))[None],
        torch.from_numpy(_pad(demote, n))[None],
        torch.from_numpy(caps.astype(np.int32))[None])
    np.testing.assert_array_equal(t2[0].numpy(), jt)
    np.testing.assert_array_equal(up[0].numpy(), want[2])
    np.testing.assert_array_equal(down[0].numpy(), want[3])
    assert int(pexec.sum()) == len(want[0])
    assert int(dexec.sum()) == len(want[1])


@pytest.mark.parametrize("R", [2, 3, 4])
@pytest.mark.parametrize("seed", range(4))
def test_targeted_executor_matches_jax_and_padded(R, seed):
    rng = np.random.default_rng(seed * 10 + R + 100)
    n = 96
    tier, up_pages, down_pages, caps = _random_plan(rng, n, R)
    pages = np.concatenate([down_pages, up_pages])
    dst = np.concatenate([
        np.where(rng.random(len(down_pages)) < 0.3, simjax.DST_BELOW,
                 rng.integers(1, R, len(down_pages))),
        rng.integers(0, R - 1, len(up_pages))])
    jt, pt = tier.copy(), tier.copy()
    want = JE.apply_targeted_migrations_np(jt, pages, dst, caps)
    got = E.apply_targeted_migrations_np(pt, pages, dst, caps)
    np.testing.assert_array_equal(pt, jt)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    t2, up_exec, down_exec, up, down = simjax.apply_targeted_migrations(
        torch.from_numpy(tier)[None],
        torch.from_numpy(_pad(pages, n))[None],
        torch.from_numpy(_pad(dst, n, 0))[None],
        torch.from_numpy(caps.astype(np.int32))[None])
    np.testing.assert_array_equal(t2[0].numpy(), jt)
    np.testing.assert_array_equal(up[0].numpy(), want[2])
    np.testing.assert_array_equal(down[0].numpy(), want[3])
    assert int(up_exec.sum()) == len(want[0])
    assert int(down_exec.sum()) == len(want[1])


def test_pebs_sample_is_numpy_poisson():
    """The non-CRN sampler draws numpy's bits: the JAX package's calls in
    the same order from the same generator."""
    from repro.simulator.sampling import pebs_sample as jpebs
    from repro_torch.simulator.sampling import pebs_sample
    trace, _ = _trace("silo-tpcc")
    a, b = np.random.default_rng(5), np.random.default_rng(5)
    for t in range(4):
        np.testing.assert_array_equal(pebs_sample(trace[t], 5000.0, a),
                                      jpebs(trace[t], 5000.0, b))
