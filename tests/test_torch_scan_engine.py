"""Port parity of the interval scan engine, end to end: ``arms_sim`` with
a CRN field (``"crn"`` sampling), ``sweep_arms_configs`` (``"pre"``
sampling) in both reduce modes and ``sweep_policy_configs`` for the ARMS
family, against the JAX engine on the same traces from
``repro.simulator.workloads`` and the same uniform field, on the 2-tier
``pmem-large`` and the 3-tier ``dram-cxl-pmem``.

Contract (DESIGN.md §2): promotions, demotions, wasteful and the integer
timelines exact; exec_time within 1e-4 relative; hot_recall and
fast_hit_frac within 1e-6.  The per-interval slow share is a ratio of
access sums that JAX accumulates in f32 and the port rounds once from f64,
so its timeline is held within 1e-5."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.baselines.arms_policy import ARMSSpec as JSpec
from repro.simulator import scan_engine as jscan
from repro.simulator import workloads
from repro.simulator.sampling import uniform_field
from repro_torch.baselines.arms_policy import ARMSSpec as PSpec
from repro_torch.simulator import scan_engine as pscan

T, N, K = 96, 512, 64
MACHINES = ["pmem-large", "dram-cxl-pmem"]
GRID = dict(alpha_s=[0.5, 0.7, 0.9, 0.3], noise_z=[0.0, 0.25, 0.5, 1.0],
            pht_lambda=[0.05, 0.1, 0.2, 0.1])


def _trace(name):
    if name == "gups-shift":   # GUPS with its hot set relocating in T
        return workloads.gups(T, N, shift_every=24)
    return workloads.make(name, T=T, n=N)


def _same(a, b):
    assert (a.promotions, a.demotions, a.wasteful) == \
        (b.promotions, b.demotions, b.wasteful), (a.name, b.name)
    np.testing.assert_allclose(a.exec_time_s, b.exec_time_s, rtol=1e-4)
    assert abs(a.hot_recall - b.hot_recall) <= 1e-6
    assert abs(a.fast_hit_frac - b.fast_hit_frac) <= 1e-6
    if a.timeline_mode is not None:
        np.testing.assert_array_equal(a.timeline_mode, b.timeline_mode)
        np.testing.assert_array_equal(a.timeline_promotions,
                                      b.timeline_promotions)
        np.testing.assert_allclose(a.timeline_slow_bw, b.timeline_slow_bw,
                                   rtol=1e-5, atol=0)
    else:
        assert a.max_promotions_interval == b.max_promotions_interval
        np.testing.assert_allclose(a.mean_mode, b.mean_mode, rtol=1e-6)
        np.testing.assert_allclose(a.mean_slow_bw, b.mean_slow_bw,
                                   rtol=1e-5)


@pytest.mark.parametrize("machine", MACHINES)
@pytest.mark.parametrize("wl", ["gups", "gups-shift", "silo-tpcc"])
def test_arms_sim_matches_jax(wl, machine):
    trace = _trace(wl)
    u = uniform_field(T, N, seed=7)
    want = jscan.arms_sim(trace, machine, K, sample_u=u)
    got = pscan.arms_sim(trace, machine, K, sample_u=u, device="cpu")
    _same(want, got)
    assert got.promotions > 0


@pytest.mark.parametrize("machine", MACHINES)
@pytest.mark.parametrize("reduce", ["stack", "stream"])
@pytest.mark.parametrize("wl", ["gups", "gups-shift"])
def test_sweep_arms_configs_matches_jax(wl, machine, reduce):
    trace = _trace(wl)
    u = uniform_field(T, N, seed=3)
    want = jscan.sweep_arms_configs(trace, machine, K, GRID, sample_u=u,
                                    reduce=reduce)
    got = pscan.sweep_arms_configs(trace, machine, K, GRID, sample_u=u,
                                   reduce=reduce, device="cpu")
    assert [r.name for r in got] == [r.name for r in want]
    for a, b in zip(want, got):
        _same(a, b)
    assert pscan.last_dispatch["lane_intervals"] == len(got) * T


def test_sweep_policy_configs_arms_family():
    trace = _trace("silo-tpcc")
    configs = [dict(alpha_s=a, noise_z=z) for a, z in ((0.4, 0.0),
                                                        (0.7, 0.5))]
    want = jscan.sweep_policy_configs(lambda **kw: JSpec.make(kw), trace,
                                      "dram-cxl-pmem", K, configs,
                                      sim_seed=5)
    got = pscan.sweep_policy_configs(lambda **kw: PSpec.make(kw), trace,
                                     "dram-cxl-pmem", K, configs,
                                     sim_seed=5, device="cpu")
    assert [r.name for r in got] == [r.name for r in want]
    for a, b in zip(want, got):
        _same(a, b)


def test_stream_matches_stack():
    trace = _trace("gups-shift")
    u = uniform_field(T, N, seed=3)
    st = pscan.sweep_arms_configs(trace, "pmem-large", K, GRID, sample_u=u,
                                  device="cpu")
    sm = pscan.sweep_arms_configs(trace, "pmem-large", K, GRID, sample_u=u,
                                  reduce="stream", device="cpu")
    for a, b in zip(st, sm):
        assert (a.promotions, a.demotions, a.wasteful, a.exec_time_s) == \
            (b.promotions, b.demotions, b.wasteful, b.exec_time_s)
        assert b.max_promotions_interval == a.timeline_promotions.max()
        assert b.timeline_mode is None


def test_mixed_observation_route_equals_spec():
    """A spec on the engine's ``mixed_observation`` route (the union
    fabric's) reads the per-lane hooks, whose defaults are the class's:
    bit for bit the spec on its own route."""
    trace = _trace("gups")

    class MixedARMS(PSpec):
        mixed_observation = True
    u = uniform_field(T, N)
    a = pscan.simulate(MixedARMS.make(), trace, "dram-cxl-pmem", K,
                       sample_u=u, device="cpu")
    b = pscan.simulate(PSpec.make(), trace, "dram-cxl-pmem", K, sample_u=u,
                       device="cpu")
    assert a.promotions > 0
    for f in dataclasses.fields(a):
        assert np.array_equal(np.asarray(getattr(a, f.name)),
                              np.asarray(getattr(b, f.name))), f.name


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        pscan.arms_sim(_trace("gups"), "pmem-large", K,
                       sample_u=uniform_field(T, N))
