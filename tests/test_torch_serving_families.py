"""Every registry policy family through the port's serving stack
(repro_torch/tiering/tiered_pool.py, paged_kv.py, launch/serve.py).

* A pool of each family driven by a hot set that moves (``pool_step``
  with an injected access stream and random buffers, demotions copying
  back), from the same initial state as JAX's (``convert.tiered_pool``):
  padded plans, executed masks, residency, slots and telemetry counts
  exact, walls within 1e-6 relative, buffers exact.  The JAX package's
  tests/test_serving_protocol.py drives every family this way.
* The decode trace of tests/test_serving_protocol.py (page 8, 8 pages, 3
  fast, policy every 4 steps) under each family: JAX ``serve_decode_step``
  against the port's, the same checks, the pools within 1e-6.
* The host fire decision: each family's ``fire_period`` is its ``fires``
  cadence, read once (ARMS's ``pool_every``, a ``migration_period``,
  every interval, never).
* ``serve()`` under each family on the CPU; ``--policy`` takes exactly
  the registry; ``--capture`` against JAX's ``traces.capture_from_steps``
  over the same access rows, and the saved file.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cases import t as _t
from repro.simulator import traces as jtraces
from repro.simulator.experiment import POLICY_REGISTRY as JREGISTRY
from repro.tiering import paged_kv as JPK
from repro.tiering import tiered_pool as JTP
from repro_torch import convert
from repro_torch.launch import serve as S
from repro_torch.simulator import traces
from repro_torch.simulator.experiment import POLICY_REGISTRY
from repro_torch.tiering import paged_kv as PK
from repro_torch.tiering import tiered_pool as TP

FAMILIES = sorted(POLICY_REGISTRY)
CFG = dict(page_size=8, n_pages=8, fast_pages=3, policy_every=4)
B, KV, H, DH = 2, 2, 4, 16


def _np(obj):
    return jax.tree_util.tree_map(np.asarray, obj)


def _same_plan(jplan, plan, t):
    for nm in ("promote", "demote", "pexec", "dexec", "count"):
        np.testing.assert_array_equal(getattr(plan, nm).numpy(),
                                      np.asarray(getattr(jplan, nm)),
                                      err_msg=f"{nm}, t={t}")


def _same_pool(jpool, pool, t):
    got = convert.pool_leaves(pool)
    for nm in ("in_fast", "slot", "promoted_at", "demoted_at", "promos",
               "demos", "waste", "t"):
        np.testing.assert_array_equal(got[nm], np.asarray(getattr(jpool, nm)),
                                      err_msg=f"{nm}, t={t}")
    for nm in ("wall_s", "wall_flat_s", "counts", "read_fast", "read_slow"):
        np.testing.assert_allclose(got[nm], np.asarray(getattr(jpool, nm)),
                                   rtol=1e-6, err_msg=f"{nm}, t={t}")


def _same_telemetry(jpool, pool):
    want, got = JTP.telemetry(jpool), TP.telemetry(pool)
    for key in ("promotions", "demotions", "wasteful", "fast_resident"):
        assert got[key] == want[key], key
    for key in ("thrash", "modeled_wall_s", "modeled_flat_s", "slowdown"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-6)


def test_registry_equals_jax():
    assert FAMILIES == sorted(JREGISTRY)


@pytest.mark.parametrize("name", FAMILIES)
def test_pool_family_matches_jax(name):
    n, k, T = 16, 4, 64
    jpool = JTP.init_pool(name, n, k, pool_every=2)
    pool = convert.tiered_pool(_np(jpool), device="cpu")
    rng = np.random.default_rng(3)
    fast = rng.standard_normal((k, 3, 5)).astype(np.float32)
    slow = rng.standard_normal((n, 3, 5)).astype(np.float32)
    jbufs = ((jnp.asarray(fast), jnp.asarray(slow)),)
    bufs = (_t(np.concatenate([fast, slow])),)
    pb = 4096.0
    jstep = jax.jit(JTP.pool_step,
                    static_argnames=("k", "copy_back", "page_bytes"))
    for t in range(T):
        hot = (np.arange(5) + 5 * (t // 16)) % n
        access = rng.random(n).astype(np.float32) * 4.0
        access[hot] += 400.0
        rf, rs = (float(v) for v in rng.integers(1, 9, 2) * pb)
        jpool, jbufs, jplan = jstep(
            jpool, jnp.asarray(access), rf, rs, k=k, bufs=jbufs,
            copy_back=True, page_bytes=pb)
        pool, bufs, plan = TP.pool_step(pool, _t(access), rf, rs, k=k,
                                        bufs=bufs, copy_back=True,
                                        page_bytes=pb)
        _same_plan(jplan, plan, t)
        _same_pool(jpool, pool, t)
        (jf, js), = jbufs
        np.testing.assert_array_equal(bufs[0].numpy(),
                                      np.concatenate([jf, js]))
        np.testing.assert_allclose(float(plan.fast_share),
                                   float(jplan.fast_share), rtol=0,
                                   atol=1e-6)
    _same_telemetry(jpool, pool)
    tel = TP.telemetry(pool)
    assert (tel["promotions"] > 0) == (name != "all-slow")


@pytest.mark.parametrize("name", FAMILIES)
def test_decode_trace_matches_jax(name):
    jcfg, cfg = JPK.PagedKVConfig(**CFG), PK.PagedKVConfig(**CFG)
    jkv = JPK.init_paged_kv(jcfg, B, KV, DH, dtype=jnp.float32, policy=name)
    kv = convert.paged_kv(_np(jkv), device="cpu")
    rng = np.random.default_rng(7)
    for t in range(32):
        q, k_new, v_new = (rng.standard_normal(s).astype(np.float32)
                           for s in ((B, H, DH), (B, KV, DH), (B, KV, DH)))
        jout, jkv, jplan = JPK.serve_decode_step(
            jkv, jnp.asarray(q), jnp.asarray(k_new), jnp.asarray(v_new),
            jnp.int32(t), jcfg)
        out, kv, plan = PK.serve_decode_step(kv, _t(q), _t(k_new),
                                             _t(v_new), t, cfg)
        _same_plan(jplan, plan, t)
        _same_pool(jkv.pool, kv.pool, t)
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=1e-5,
                                   rtol=0)
        for nm in ("k_fast", "k_slow", "v_fast", "v_slow"):
            np.testing.assert_allclose(getattr(kv, nm).numpy(),
                                       np.asarray(getattr(jkv, nm)),
                                       rtol=0, atol=1e-6, err_msg=nm)
    _same_telemetry(jkv.pool, kv.pool)


@pytest.mark.parametrize("name,period", [
    ("arms", 3), ("hemem", 5), ("memtis", 1), ("tpp", 1), ("oracle", 1),
    ("all-slow", 0), ("hybridtier", 4), ("jenga", 1), ("tierbpf", 2)])
def test_fire_period_is_the_fires_cadence(name, period):
    pool = TP.init_pool(name, 8, 3, pool_every=3, device="cpu")
    assert pool.period == period
    access = torch.ones(8)
    for t in range(1, 13):
        pool = TP.pool_observe(pool, access)
        assert TP.pool_fires(pool) == bool(pool.spec.fires(pool.state)), t


def test_state_dependent_cadence_reads_the_flag():
    """A spec whose cadence follows its state (the simulator's ARMSSpec:
    every 5 intervals in history mode) has its flag read each step."""
    from repro_torch.baselines.arms_policy import ARMSSpec
    pool = TP.init_pool(ARMSSpec.make(), 8, 3, device="cpu")
    assert pool.period is None
    fired = []
    for t in range(10):
        pool, _, plan = TP.pool_step(pool, torch.arange(8.0), k=3)
        fired.append(TP.pool_fires(pool))
    assert fired == [t % 5 == 4 for t in range(10)]


@pytest.mark.parametrize("name", FAMILIES)
def test_serve_with_family(name):
    rep = S.serve("granite-8b", 12, 1, page_size=8, policy=name, quiet=True,
                  device="cpu")
    assert rep.policy == name and rep.fast_mass.shape == (12,)
    assert np.isfinite(rep.slowdown) and rep.slowdown > 0.0
    assert rep.trace is None


def test_policy_choices_equal_the_registry(monkeypatch):
    seen = []

    def fake_serve(arch, tokens, batch, **kw):
        seen.append(kw["policy"])
        return None

    monkeypatch.setattr(S, "serve", fake_serve)
    for name in FAMILIES:
        monkeypatch.setattr("sys.argv", ["serve", "--arch", "granite-8b",
                                         "--policy", name])
        S.main()
    assert seen == FAMILIES
    monkeypatch.setattr("sys.argv", ["serve", "--arch", "granite-8b",
                                     "--policy", "lru"])
    with pytest.raises(SystemExit):
        S.main()


def test_capture_matches_capture_from_steps(tmp_path, monkeypatch):
    T_, page = 16, 4
    rep = S.serve("granite-8b", T_, 2, page_size=page, policy="hemem",
                  capture=True, quiet=True, device="cpu", seed=2)
    # the same loop again, its access rows kept
    cfg, params, pk_cfg, kv, cache, draw = S.setup(
        "granite-8b", T_, 2, page_size=page, seed=2, policy="hemem",
        device="cpu")
    token = torch.zeros((2, 1), dtype=torch.int32)
    ewma = torch.zeros((pk_cfg.n_pages,))
    rows = []
    for t in range(T_):
        token, cache, kv, plan, ewma, _ = S.serve_token(
            params, cfg, pk_cfg, token, cache, kv, ewma, t, draw)
        rows.append(plan.access.numpy())
    want = jtraces.capture_from_steps(np.stack(rows),
                                      group=pk_cfg.policy_every,
                                      label="granite-8b-kv")
    assert (rep.trace.T, rep.trace.n) == (T_ // pk_cfg.policy_every,
                                          pk_cfg.n_pages)
    np.testing.assert_array_equal(rep.trace.counts, want.counts)
    assert rep.trace.label == want.label
    # --capture PATH writes it
    path = tmp_path / "kv.npz"
    monkeypatch.setattr(S, "serve", lambda *a, **kw: rep)
    monkeypatch.setattr("sys.argv", ["serve", "--arch", "granite-8b",
                                     "--capture", str(path)])
    S.main()
    back = traces.TraceWorkload.load(str(path))
    np.testing.assert_array_equal(back.counts, rep.trace.counts)
