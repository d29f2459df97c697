"""State carried across from the JAX package (repro_torch/convert.py): JAX
runs a few intervals, its state goes to the port as numpy leaves, and
both continue from there on the same inputs with the same plans."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.baselines.arms_policy import ARMSSpec as JSpec
from repro.core import controller as jctl
from repro.core.state import ARMSConfig as JConfig
from repro.core.state import init_state as jinit
from repro.simulator import scan_engine as jscan
from repro_torch import convert
from repro_torch.core import controller as pctl
from repro_torch.core.state import ARMSConfig as PConfig
from repro_torch.core.state import init_pht, init_state
from repro_torch.simulator import machine_spec, machines

N, K = 256, 32


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _inputs(seed, B, steps):
    rng = np.random.default_rng(seed)
    counts = np.empty((steps, B, N), np.float32)
    for t in range(steps):
        lam = np.full(N, 0.3)
        lam[np.random.default_rng(t // 6).permutation(N)[:K]] = 5.0
        counts[t] = rng.poisson(lam, (B, N))
    slow = rng.uniform(0, 0.2, (steps, B)).astype(np.float32)
    slow[12:15] += 0.7
    app = rng.uniform(0, 1, (steps, B)).astype(np.float32)
    return counts, slow, app


def _plans_equal(jplan, pplan):
    for nm in ("promote", "demote", "valid", "count", "batch_size"):
        np.testing.assert_array_equal(getattr(pplan, nm).numpy(),
                                      np.asarray(getattr(jplan, nm)),
                                      err_msg=nm)


def test_tiering_state_carried_across():
    cfg = JConfig(noise_z=0.1)
    counts, slow, app = _inputs(0, 1, 24)
    jstep = jax.jit(lambda st, c, s, a: jctl.arms_step_impl(
        st, c, s, a, cfg=cfg, k=K))
    jst = jinit(N, cfg)
    for t in range(10):
        jst, _ = jstep(jst, counts[t, 0], slow[t, 0], app[t, 0])
    pst = convert.tiering_state(_np(jst), device="cpu")
    pcfg = convert.arms_config(cfg)
    assert pst.ewma_s.shape == (1, N) and pst.mode.shape == (1,)
    moved = 0
    for t in range(10, 24):
        jst, jplan = jstep(jst, counts[t, 0], slow[t, 0], app[t, 0])
        pst, pplan = pctl.arms_step_impl(
            pst, torch.from_numpy(counts[t]), torch.from_numpy(slow[t]),
            torch.from_numpy(app[t]), cfg=pcfg, k=K)
        _plans_equal(jax.tree_util.tree_map(lambda x: x[None], jplan),
                     pplan)
        moved += int(pplan.count.sum())
    assert moved > 0


def test_arms_run_state_spec_and_machine_carried_across():
    """Lane-batched: a swept ARMSSpec, its ARMSRunState and a 3-tier
    machine stack go across, and ARMSSpec.policy continues in both."""
    B = 2
    jspec = jax.tree_util.tree_map(
        lambda *x: jnp.stack(x),
        *[JSpec.make(dict(alpha_s=a, pht_lambda=p))
          for a, p in ((0.6, 0.08), (0.8, 0.15))])
    jmach, _ = jscan._mach_lanes("dram-cxl-pmem", B, N, K)
    counts, slow, app = _inputs(4, B, 20)

    @jax.jit
    def jpass(sp, st, c, s, a):
        st = jax.vmap(JSpec.observe)(sp, st, c)
        st, pro, dem = jax.vmap(JSpec.policy, in_axes=(0, 0, 0, 0, None))(
            sp, st, s, a, K)
        return st, pro, dem

    jst = jax.vmap(lambda sp, mc: JSpec.init(sp, N, K, mc))(jspec, jmach)
    for t in range(8):
        jst, _, _ = jpass(jspec, jst, counts[t], slow[t], app[t])

    pspec = convert.arms_spec(_np(jspec), device="cpu")
    pst = convert.arms_run_state(_np(jst), device="cpu")
    pmach = convert.machine(_np(jmach), device="cpu")
    ref_mach, _ = machine_spec.lane_stack(
        [machines.get("dram-cxl-pmem")] * B, N, K, device="cpu")
    for f in ("lat_ns", "bw_read", "bw_write", "mlp", "promo_pair_us"):
        assert torch.equal(getattr(pmach, f), getattr(ref_mach, f))
    assert pspec.cfg_names == ("alpha_s", "pht_lambda")
    assert torch.equal(pst.promo_us, pmach.promo_path_us())
    for t in range(8, 20):
        jst, jpro, jdem = jpass(jspec, jst, counts[t], slow[t], app[t])
        pst = pspec.observe(pst, torch.from_numpy(counts[t]))
        pst, ppro, pdem = pspec.policy(pst, torch.from_numpy(slow[t]),
                                       torch.from_numpy(app[t]), K)
        np.testing.assert_array_equal(ppro.numpy(), np.asarray(jpro))
        np.testing.assert_array_equal(pdem.numpy(), np.asarray(jdem))
        np.testing.assert_array_equal(pst.inner.mode.numpy(),
                                      np.asarray(jst.inner.mode))
        np.testing.assert_allclose(pst.inner.promo_cost.numpy(),
                                   np.asarray(jst.inner.promo_cost),
                                   rtol=1e-6)


def _carried():
    """JAX state of every kind ``convert`` takes, lane-batched."""
    jspec = jax.tree_util.tree_map(lambda *x: jnp.stack(x),
                                   *[JSpec.make(dict(alpha_s=0.6))] * 2)
    jmach, _ = jscan._mach_lanes("pmem-large", 2, N, K)
    jst = jax.vmap(lambda sp, mc: JSpec.init(sp, N, K, mc))(jspec, jmach)
    return _np(jspec), _np(jst), _np(jmach)


@pytest.mark.parametrize("make", [
    lambda sp, st, mc: convert.arms_run_state(st),
    lambda sp, st, mc: convert.tiering_state(st.inner),
    lambda sp, st, mc: convert.pht_state(st.inner.pht, lanes=True),
    lambda sp, st, mc: convert.arms_spec(sp),
    lambda sp, st, mc: convert.machine(mc),
    lambda sp, st, mc: machine_spec.lane_stack(
        [machines.get("pmem-large")], N, K),
    lambda sp, st, mc: init_state(2, N, PConfig()),
    lambda sp, st, mc: init_pht(2),
], ids=["arms_run_state", "tiering_state", "pht_state", "arms_spec",
        "machine", "lane_stack", "init_state", "init_pht"])
def test_state_defaults_to_the_card(make):
    """Carried or fresh state lands on the CUDA card unless the caller
    asks for the CPU, so a continued run never drops to the plain
    versions unasked: without a card the default raises."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    sp, st, mc = _carried()
    with pytest.raises(RuntimeError, match="CUDA"):
        make(sp, st, mc)
