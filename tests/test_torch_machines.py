"""Port parity of the machine layer: Table-3 constants, every registry
preset's leaves, capacity resolution, lane stacking and the f64 host
cost model, against the JAX package on the same inputs."""
import dataclasses

import numpy as np
import pytest

from repro import roofline
from repro.simulator import machine as jmachine
from repro.simulator import machine_spec as jspec
from repro.simulator import machines as jmachines
from repro_torch.simulator import machine as pmachine
from repro_torch.simulator import machine_spec as pspec
from repro_torch.simulator import machines as pmachines

LEAVES = ("lat_ns", "bw_read", "bw_write", "capacity_pages", "mlp",
          "promo_pair_us", "demo_pair_us")


def test_constants_and_two_tier_model():
    assert (pmachine.CACHELINE, pmachine.PAGE_BYTES) == (
        jmachine.CACHELINE, jmachine.PAGE_BYTES)
    for name, m in jmachine.MACHINES.items():
        pm = pmachine.MACHINES[name]
        assert dataclasses.asdict(pm) == dataclasses.asdict(m)
        args = (3.1e6, 4.7e5, 12.0, 3.0)
        assert dataclasses.asdict(pmachine.interval_time(pm, *args)) == \
            dataclasses.asdict(jmachine.interval_time(m, *args))


@pytest.mark.parametrize("name", jmachines.names())
def test_preset_leaves_equal(name):
    assert pmachines.names() == jmachines.names()
    j, p = jmachines.get(name), pmachines.get(name)
    assert p.name == j.name and p.n_tiers == j.n_tiers
    for leaf in LEAVES:
        a, b = np.asarray(getattr(p, leaf)), np.asarray(getattr(j, leaf))
        assert a.dtype == b.dtype, leaf
        np.testing.assert_array_equal(a, b, err_msg=leaf)


def test_hbm_pcie_tier0_is_the_reference_value():
    assert pmachines.HBM_PCIE_TIER0_BW == roofline.HBM_BW


@pytest.mark.parametrize("n,k", [(64, 8), (1000, 125), (4096, 4000)])
def test_resolved_caps_and_lane_stack(n, k):
    machs = [jmachines.get(nm) for nm in jmachines.names()]
    for m in machs:
        np.testing.assert_array_equal(
            pspec.resolved_caps(pmachines.get(m.name), n, k),
            jspec.resolved_caps(m, n, k))
    jst, jcaps = jspec.lane_stack(machs, n, k)
    pst, pcaps = pspec.lane_stack([pmachines.get(m.name) for m in machs],
                                  n, k, device="cpu")
    np.testing.assert_array_equal(pcaps.numpy(), np.asarray(jcaps))
    for leaf in LEAVES:
        np.testing.assert_array_equal(getattr(pst, leaf).numpy(),
                                      np.asarray(getattr(jst, leaf)),
                                      err_msg=leaf)
    np.testing.assert_array_equal(pst.promo_path_us().numpy(),
                                  np.asarray(jst.promo_path_us()))
    np.testing.assert_array_equal(pst.demo_path_us().numpy(),
                                  np.asarray(jst.demo_path_us()))


@pytest.mark.parametrize("name", jmachines.names())
def test_interval_outcome_host_equal(name):
    rng = np.random.default_rng(len(name))
    j, p = jmachines.get(name), pmachines.get(name)
    R = j.n_tiers
    for _ in range(20):
        acc = rng.gamma(2.0, 1e6, R)
        up = rng.integers(0, 64, R - 1).astype(np.float64)
        down = rng.integers(0, 64, R - 1).astype(np.float64)
        assert pspec.interval_outcome_host(p, acc, up, down) == \
            jspec.interval_outcome_host(j, acc, up, down)
