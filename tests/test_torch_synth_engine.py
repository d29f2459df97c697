"""Port parity of the trace-synthesis and PRNG-sampling paths of the scan
engine against the JAX engine: ``sweep_workloads`` (policy families on
both routes), ``sweep_workload_configs`` (``"crn_prng"`` and ``"crn"``),
``simulate_workload``, the scenario suite, ``sweep_seeds`` and
``simulate``/``arms_sim`` without a CRN field (``"prng"``).

Contract (DESIGN.md §2, PERF.md §2): promotions, demotions, wasteful and
the integer timelines exact; exec_time within 1e-4 relative; hot_recall
and fast_hit_frac within 1e-6; the slow-share timeline within 1e-5.  On
one device a synthesized run equals the replay of its materialized trace
with the synthesized noise rows, bit for bit."""
import numpy as np
import pytest

from repro.baselines.arms_policy import ARMSSpec as JARMS
from repro.baselines.hemem import HeMemSpec as JHeMem
from repro.baselines.jenga import JengaSpec as JJenga
from repro.baselines.static import OracleSpec as JOracle
from repro.baselines.tpp import TPPSpec as JTPP
from repro.simulator import sampling as jsampling
from repro.simulator import scan_engine as jscan
from repro.simulator import scenarios as jscen
from repro.simulator import workload_spec as jws
from repro_torch.baselines.arms_policy import ARMSSpec as PARMS
from repro_torch.baselines.hemem import HeMemSpec as PHeMem
from repro_torch.baselines.jenga import JengaSpec as PJenga
from repro_torch.baselines.static import OracleSpec as POracle
from repro_torch.baselines.tpp import TPPSpec as PTPP
from repro_torch.simulator import sampling as psampling
from repro_torch.simulator import scan_engine as pscan
from repro_torch.simulator import scenarios as pscen
from repro_torch.simulator import workload_spec as pws

T, N, K = 64, 256, 32
NAMES = list(jws.NAMED_WORKLOADS)
FAMILIES = {
    "arms": (lambda: JARMS.make(), lambda: PARMS.make(), "pmem-large"),
    "hemem": (lambda: JHeMem.make(), lambda: PHeMem.make(), "pmem-large"),
    "tpp": (lambda: JTPP.make(), lambda: PTPP.make(), "pmem-large"),
    "oracle": (JOracle, POracle, "pmem-large"),
    "jenga": (lambda: JJenga.make(), lambda: PJenga.make(),
              "dram-cxl-pmem"),
}
FEW = ["gups", "silo-tpcc", "gapbs-bc", "liblinear"]


def _same(a, b):
    assert a.name == b.name
    assert (a.promotions, a.demotions, a.wasteful) == \
        (b.promotions, b.demotions, b.wasteful), a.name
    np.testing.assert_allclose(a.exec_time_s, b.exec_time_s, rtol=1e-4)
    assert abs(a.hot_recall - b.hot_recall) <= 1e-6
    assert abs(a.fast_hit_frac - b.fast_hit_frac) <= 1e-6
    np.testing.assert_array_equal(a.timeline_mode, b.timeline_mode)
    np.testing.assert_array_equal(a.timeline_promotions,
                                  b.timeline_promotions)
    np.testing.assert_allclose(a.timeline_slow_bw, b.timeline_slow_bw,
                               rtol=1e-5, atol=0)


def _identical(a, b):
    for f in ("exec_time_s", "promotions", "demotions", "wasteful",
              "hot_recall", "fast_hit_frac"):
        assert getattr(a, f) == getattr(b, f), f
    for f in ("timeline_slow_bw", "timeline_fast_hits", "timeline_mode",
              "timeline_promotions"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_sweep_workloads_matches_jax(family):
    jspec, pspec, machine = FAMILIES[family]
    want = jscan.sweep_workloads([jws.named(nm, T=T) for nm in NAMES],
                                 machine, K, T, N, spec=jspec(), sim_seed=3,
                                 wl_seed=1)
    got = pscan.sweep_workloads([pws.named(nm, T=T) for nm in NAMES],
                                machine, K, T, N, spec=pspec(), sim_seed=3,
                                wl_seed=1, device="cpu")
    for a, b in zip(want, got, strict=True):
        _same(a, b)
    assert pscan.last_dispatch["lanes"] == len(NAMES)
    assert pscan.last_dispatch["sampling"] == "crn_prng"


@pytest.mark.parametrize("machine,crn", [("pmem-large", False),
                                         ("dram-cxl-pmem", True)])
def test_sweep_workload_configs_matches_jax(machine, crn):
    configs = [dict(alpha_s=0.5, noise_z=0.0), dict(alpha_s=0.8,
                                                    noise_z=0.5)]
    u = jsampling.uniform_field(T, N, seed=9) if crn else None
    want = jscan.sweep_workload_configs(
        lambda **kw: JARMS.make(kw), configs,
        [jws.named(nm, T=T) for nm in FEW], machine, K, T, N, sim_seed=2,
        wl_seed=7, sample_u=u)
    got = pscan.sweep_workload_configs(
        lambda **kw: PARMS.make(kw), configs,
        [pws.named(nm, T=T) for nm in FEW], machine, K, T, N, sim_seed=2,
        wl_seed=7, sample_u=u, device="cpu")
    assert len(got) == len(FEW) and all(len(r) == 2 for r in got)
    for rw, rg in zip(want, got):
        for a, b in zip(rw, rg, strict=True):
            _same(a, b)
    assert pscan.last_dispatch["lanes"] == 2 * len(FEW)
    assert pscan.last_dispatch["sampling"] == ("crn" if crn else "crn_prng")


def test_scenario_suite_and_simulate_workload_match_jax():
    n, k = 256, 32
    want = jscan.sweep_workloads(jscen.suite(n, k), "pmem-large", k, T, n,
                                 sim_seed=1)
    got = pscan.sweep_workloads(pscen.suite(n, k), "pmem-large", k, T, n,
                                sim_seed=1, device="cpu")
    for a, b in zip(want, got, strict=True):
        _same(a, b)
    mixed = jscen.serving_mix(n, k)
    a = jscan.simulate_workload(JHeMem.make(), mixed, "dram-cxl-pmem", k, T,
                                n, sim_seed=4, wl_seed=2)
    b = pscan.simulate_workload(PHeMem.make(), pscen.serving_mix(n, k),
                                "dram-cxl-pmem", k, T, n, sim_seed=4,
                                wl_seed=2, device="cpu")
    _same(a, b)


@pytest.mark.parametrize("family", ["arms", "hemem"])
def test_synthesized_equals_materialized_replay(family):
    """A synthesized run is bit for bit the replay of its materialized
    trace with the synthesized noise rows as the CRN field, and builds
    no [T, n] array."""
    _, pspec, machine = FAMILIES[family]
    wl = pws.named("gapbs-bc", T=T)
    before = pws.MATERIALIZE_CALLS
    syn = pscan.simulate_workload(pspec(), wl, machine, K, T, N,
                                  sim_seed=5, wl_seed=6, device="cpu")
    assert pws.MATERIALIZE_CALLS == before
    trace = wl.materialize(T, N, seed=6, device="cpu")
    u = psampling.synth_noise_field(T, N, seed=5, device="cpu")
    rep = pscan.simulate(pspec(), trace, machine, K, sample_u=u,
                         name=syn.name, device="cpu")
    _identical(syn, rep)
    np.testing.assert_array_equal(
        u.view(np.int32),
        jsampling.synth_noise_field(T, N, seed=5).view(np.int32))


def test_sweep_seeds_matches_jax():
    trace = jws.named("gups", T=T).materialize(T, N, 0)
    want = jscan.sweep_seeds(trace, "pmem-large", K, [0, 1, 7, 42])
    got = pscan.sweep_seeds(trace, "pmem-large", K, [0, 1, 7, 42],
                            device="cpu")
    for a, b in zip(want, got, strict=True):
        _same(a, b)
    want = jscan.sweep_seeds(trace, "dram-cxl-pmem", K, [3, 4],
                             spec=JTPP.make())
    got = pscan.sweep_seeds(trace, "dram-cxl-pmem", K, [3, 4],
                            spec=PTPP.make(), device="cpu")
    for a, b in zip(want, got, strict=True):
        _same(a, b)
    assert pscan.last_dispatch["sampling"] == "prng"
    with pytest.raises(ValueError):
        pscan.sweep_seeds(trace, "pmem-large", K, [], device="cpu")


def test_prng_sampling_matches_jax():
    """``arms_sim`` and ``simulate`` without ``sample_u`` draw the noise
    from ``PRNGKey(seed)`` as JAX does."""
    trace = jws.named("silo-tpcc", T=T).materialize(T, N, 0)
    _same(jscan.arms_sim(trace, "dram-cxl-pmem", K, seed=11),
          pscan.arms_sim(trace, "dram-cxl-pmem", K, seed=11, device="cpu"))
    _same(jscan.simulate(JHeMem.make(), trace, "pmem-large", K, seed=2),
          pscan.simulate(PHeMem.make(), trace, "pmem-large", K, seed=2,
                         device="cpu"))


def test_dispatch_counter():
    wls = [pws.named("gups", T=T), pws.named("xsbench", T=T)]
    with pscan.count_dispatches() as outer:
        pscan.sweep_workloads(wls, "pmem-large", K, 8, N, device="cpu")
        with pscan.count_dispatches() as inner:
            pscan.sweep_workloads(wls, "pmem-large", K, 8, N, device="cpu")
    assert (outer.count, inner.count) == (2, 1)
    assert inner.last["lanes"] == 2 and inner.last["synth"] is True
    assert outer.records[0]["lane_intervals"] == 16
