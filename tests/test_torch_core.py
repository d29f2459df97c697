"""Port parity of the ARMS core: ``arms_step_impl`` driven for 24
intervals by the same numpy-seeded counts and bandwidth signals in JAX
and in the port, with the default config and with per-lane swept configs
(f32 lane values where JAX's defaults are weakly typed Python floats).

JAX runs compiled, as its engine runs it.  Plans and the integer state
must be equal exactly, every interval.  The f32 state is held within
1e-6 relative: XLA's compiled CPU code fuses some products into FMAs,
where depends on its fusion decisions, and the port reproduces the one
that decides rankings (the per-page EWMA, interval_step ``ref.fma``) but
not every scalar one (ROADMAP queue 3).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.baselines.arms_policy import ARMSSpec as JSpec
from repro.core import controller as jctl
from repro.core import pht as jpht
from repro.core.state import ARMSConfig as JConfig
from repro.core.state import init_state as jinit
from repro_torch.baselines.arms_policy import ARMSSpec as PSpec
from repro_torch.core import controller as pctl
from repro_torch.core import pht as ppht
from repro_torch.core.state import ARMSConfig as PConfig
from repro_torch.core.state import init_pht, init_state
from repro_torch.utils.pytree import stack_specs

N, K, STEPS = 256, 32, 24
PLAN = ("promote", "demote", "valid", "count", "batch_size")
EXACT = ("hot_age", "in_fast", "mode", "mode_ttl", "interval")
F32 = ("ewma_s", "ewma_l", "score", "prev_score", "sig_ewma_s",
       "sig_ewma_l", "promo_cost", "demo_cost")


def _signals(seed, B):
    """Counts from a hot set that relocates, slow-tier signals with jumps
    (they trip the Page-Hinkley alarm), app signals in [0, 1.2]."""
    rng = np.random.default_rng(seed)
    counts = np.empty((STEPS, B, N), np.float32)
    for t in range(STEPS):
        hot = np.random.default_rng(seed + t // 8).permutation(N)[:K]
        lam = np.full(N, 0.2)
        lam[hot] = 6.0
        counts[t] = rng.poisson(lam, (B, N))
    slow = rng.uniform(0.0, 0.15, (STEPS, B)).astype(np.float32)
    slow[8:12] += 0.6
    slow[16:18] += 0.8
    app = rng.uniform(0.0, 1.2, (STEPS, B)).astype(np.float32)
    return counts, slow, app


def _check(jstate, jplan, pstate, pplan, t, lanes=True):
    for nm in PLAN:
        want = np.asarray(getattr(jplan, nm))
        np.testing.assert_array_equal(
            getattr(pplan, nm).numpy(), want if lanes else want[None],
            err_msg=f"plan.{nm} at interval {t}")
    for nm in EXACT + F32:
        want = np.asarray(getattr(jstate, nm))
        want = want if lanes else want[None]
        got = getattr(pstate, nm).numpy()
        if nm in EXACT:
            np.testing.assert_array_equal(got, want,
                                          err_msg=f"state.{nm} at {t}")
        else:
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=0,
                                       err_msg=f"state.{nm} at {t}")


def test_pht_update_equal():
    rng = np.random.default_rng(1)
    xs = rng.uniform(0, 1, 64).astype(np.float32)
    js, ps_ = jinit(4, JConfig()).pht, init_pht(1, device="cpu")
    for x in xs:
        js, ja, jstat = jpht.pht_update(js, jnp.float32(x), JConfig())
        ps_, pa, pstat = ppht.pht_update(ps_, torch.tensor([x]), PConfig())
        assert bool(pa[0]) == bool(ja)
        assert pstat.numpy()[0] == np.float32(jstat)


def test_arms_step_default_config():
    counts, slow, app = _signals(3, 1)

    jstep = jax.jit(lambda st, c, s, a: jctl.arms_step_impl(
        st, c, s, a, cfg=JConfig(), k=K))
    jst, pst = jinit(N, JConfig()), init_state(1, N, PConfig(), device="cpu")
    modes = set()
    for t in range(STEPS):
        jst, jplan = jstep(jst, counts[t, 0], slow[t, 0], app[t, 0])
        pst, pplan = pctl.arms_step_impl(
            pst, torch.from_numpy(counts[t]), torch.from_numpy(slow[t]),
            torch.from_numpy(app[t]), cfg=PConfig(), k=K)
        _check(jst, jplan, pst, pplan, t, lanes=False)
        modes.add(int(jst.mode))
    assert modes == {0, 1}, "the signals must exercise both modes"


@pytest.mark.parametrize("overrides", [
    dict(alpha_s=[0.5, 0.7, 0.9], noise_z=[0.0, 0.25, 1.0]),
    dict(pht_lambda=[0.05, 0.1, 0.3], w_s_recency=[0.8, 0.6, 0.9],
         migrate_cost_alpha=[0.3, 0.5, 0.1], latency_slow_us=[0.25, 0.5,
                                                              0.2])])
def test_arms_step_swept_lanes(overrides):
    B = 3
    names = sorted(overrides)
    rows = [{nm: overrides[nm][b] for nm in names} for b in range(B)]
    jspec = jax.tree_util.tree_map(lambda *x: jnp.stack(x),
                                   *[JSpec.make(r) for r in rows])
    pspec = stack_specs([PSpec.make(r) for r in rows])
    counts, slow, app = _signals(11, B)

    @jax.jit
    def jstep(sp, st, c, s, a):
        return jax.vmap(lambda sp_, st_, c_, s_, a_: jctl.arms_step_impl(
            st_, c_, s_, a_, cfg=sp_.cfg(), k=K))(sp, st, c, s, a)

    jst = jax.vmap(lambda sp: jinit(N, sp.cfg()))(jspec)
    pst = init_state(B, N, pspec.cfg(), device="cpu")
    moved = 0
    for t in range(STEPS):
        jst, jplan = jstep(jspec, jst, counts[t], slow[t], app[t])
        pst, pplan = pctl.arms_step_impl(
            pst, torch.from_numpy(counts[t]), torch.from_numpy(slow[t]),
            torch.from_numpy(app[t]), cfg=pspec.cfg(), k=K)
        _check(jst, jplan, pst, pplan, t)
        moved += int(pplan.count.sum())
    assert moved > 0, "the signals must drive migrations"


def test_config_fields_match():
    assert [f.name for f in dataclasses.fields(PConfig)] == \
        [f.name for f in dataclasses.fields(JConfig)]
    assert dataclasses.asdict(PConfig()) == dataclasses.asdict(JConfig())
