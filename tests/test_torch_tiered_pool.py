"""Port parity of the serving pools (repro_torch/tiering/tiered_pool.py,
paged_kv.py) and of ``simjax.apply_padded_migrations``.

* The 48-step decode trace of tests/test_serving_protocol.py (page 8,
  8 pages, 3 fast, policy every 4 steps, B 2, KV 2, H 4, dh 16, seed 7):
  JAX ``serve_decode_step`` against the port's, from the same initial
  state (``convert.paged_kv``), at every step: padded plans, executed
  masks, residency and slots exact; the access signal and the pools
  within 1e-6; telemetry counts exact and walls within 1e-6 relative.
* A pool driven by a hot set that moves (``pool_step`` with an injected
  access stream and random pools), so demotions copy data back: the
  same checks, pools exact.
* ``apply_padded_migrations`` on random plans, exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cases import plans
from _torch_cases import t as _t
from repro.simulator import simjax as jsimjax
from repro.tiering import paged_kv as JPK
from repro.tiering import tiered_pool as JTP
from repro_torch import convert
from repro_torch.simulator import simjax
from repro_torch.tiering import paged_kv as PK
from repro_torch.tiering import tiered_pool as TP

CFG = dict(page_size=8, n_pages=8, fast_pages=3, policy_every=4)
B, KV, H, DH = 2, 2, 4, 16
CLOSE = dict(rtol=0, atol=1e-6)


def _same_plan(jplan, plan, t):
    for nm in ("promote", "demote", "pexec", "dexec", "count"):
        np.testing.assert_array_equal(getattr(plan, nm).numpy(),
                                      np.asarray(getattr(jplan, nm)),
                                      err_msg=f"{nm}, t={t}")


def _same_pool(jpool, pool, t):
    for nm in ("in_fast", "slot", "promoted_at", "demoted_at", "promos",
               "demos", "waste"):
        np.testing.assert_array_equal(getattr(pool, nm).numpy(),
                                      np.asarray(getattr(jpool, nm)),
                                      err_msg=f"{nm}, t={t}")
    assert pool.t == int(jpool.t)
    for nm in ("wall_s", "wall_flat_s"):
        np.testing.assert_allclose(float(getattr(pool, nm)),
                                   float(getattr(jpool, nm)), rtol=1e-6)


def _same_telemetry(jpool, pool):
    want, got = JTP.telemetry(jpool), TP.telemetry(pool)
    for key in ("promotions", "demotions", "wasteful", "fast_resident"):
        assert got[key] == want[key], key
    for key in ("thrash", "modeled_wall_s", "modeled_flat_s", "slowdown"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-6)


def test_decode_trace_matches_jax():
    jcfg, cfg = JPK.PagedKVConfig(**CFG), PK.PagedKVConfig(**CFG)
    jkv = JPK.init_paged_kv(jcfg, B, KV, DH, dtype=jnp.float32)
    kv = convert.paged_kv(jax.tree_util.tree_map(np.asarray, jkv),
                          device="cpu")
    rng = np.random.default_rng(7)
    fires = 0
    for t in range(48):
        q, k_new, v_new = (rng.standard_normal(s).astype(np.float32)
                           for s in ((B, H, DH), (B, KV, DH), (B, KV, DH)))
        jout, jkv, jplan = JPK.serve_decode_step(
            jkv, jnp.asarray(q), jnp.asarray(k_new), jnp.asarray(v_new),
            jnp.int32(t), jcfg)
        out, kv, plan = PK.serve_decode_step(kv, _t(q), _t(k_new),
                                             _t(v_new), t, cfg)
        _same_plan(jplan, plan, t)
        _same_pool(jkv.pool, kv.pool, t)
        np.testing.assert_allclose(plan.access.numpy(),
                                   np.asarray(jplan.access), **CLOSE)
        np.testing.assert_allclose(float(plan.fast_share),
                                   float(jplan.fast_share), **CLOSE)
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=1e-5,
                                   rtol=0)
        for nm in ("k_fast", "k_slow", "v_fast", "v_slow"):
            np.testing.assert_allclose(getattr(kv, nm).numpy(),
                                       np.asarray(getattr(jkv, nm)),
                                       err_msg=f"{nm}, t={t}", **CLOSE)
        fires += int(plan.count)
    assert fires > 0
    _same_telemetry(jkv.pool, kv.pool)


def test_moving_hot_set_demotes_and_copies_back():
    n, k, every, T = 16, 4, 4, 96
    jpool = JTP.init_pool("arms", n, k, pool_every=every)
    pool = convert.tiered_pool(jax.tree_util.tree_map(np.asarray, jpool),
                               device="cpu")
    rng = np.random.default_rng(3)
    fast = rng.standard_normal((k, 3, 5)).astype(np.float32)
    slow = rng.standard_normal((n, 3, 5)).astype(np.float32)
    jbufs = ((jnp.asarray(fast), jnp.asarray(slow)),)
    bufs = (_t(np.concatenate([fast, slow])),)
    pb = 4096.0
    jstep = jax.jit(JTP.pool_step,
                    static_argnames=("k", "copy_back", "page_bytes"))
    for t in range(T):
        hot = (np.arange(4) + 5 * (t // 24)) % n
        access = rng.random(n).astype(np.float32)
        access[hot] += 20.0
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
    _same_telemetry(jpool, pool)
    assert int(pool.promos) > k and int(pool.demos) > 0


@pytest.mark.parametrize("copy_back", [True, False], ids=["copy", "nocopy"])
def test_pool_fire_fused_matches_jax_split(copy_back):
    """Two buffers of other row shapes and dtypes (an expert's ``wi`` and
    ``wo``) moved by one fire each interval on the fused ``[k + n, ...]``
    layout, against JAX's split ``(fast, slow)`` arrays, exactly."""
    n, k, every, T = 13, 4, 3, 60
    jpool = JTP.init_pool("arms", n, k, pool_every=every)
    pool = convert.tiered_pool(jax.tree_util.tree_map(np.asarray, jpool),
                               device="cpu")
    rng = np.random.default_rng(23)
    split = [((rng.standard_normal((k, 2, 7)) * 9).astype(np.float32),
              (rng.standard_normal((n, 2, 7)) * 9).astype(np.float32)),
             (rng.integers(-99, 99, (k, 5)).astype(np.int32),
              rng.integers(-99, 99, (n, 5)).astype(np.int32))]
    jbufs = tuple((jnp.asarray(f), jnp.asarray(s)) for f, s in split)
    bufs = tuple(_t(np.concatenate([f, s])) for f, s in split)
    jstep = jax.jit(JTP.pool_step,
                    static_argnames=("k", "copy_back", "page_bytes"))
    for t in range(T):
        hot = (np.arange(3) + 4 * (t // 15)) % n
        access = rng.random(n).astype(np.float32)
        access[hot] += 20.0
        jpool, jbufs, jplan = jstep(jpool, jnp.asarray(access), 1.0, 1.0,
                                    k=k, bufs=jbufs, copy_back=copy_back,
                                    page_bytes=64.0)
        pool, bufs, plan = TP.pool_step(pool, _t(access), 1.0, 1.0, k=k,
                                        bufs=bufs, copy_back=copy_back,
                                        page_bytes=64.0)
        _same_plan(jplan, plan, t)
        for (jf, js), b in zip(jbufs, bufs):
            np.testing.assert_array_equal(b.numpy(), np.concatenate(
                [np.asarray(jf), np.asarray(js)]), err_msg=f"t={t}")
    assert int(pool.promos) > k and int(pool.demos) > 0


@pytest.mark.parametrize("n,k,P,D", [(8, 3, 8, 8), (37, 9, 12, 5),
                                     (64, 16, 64, 64)])
def test_apply_padded_migrations_matches_jax(n, k, P, D):
    rng = np.random.default_rng(n + k)
    Bl = 6
    in_fast = np.zeros((Bl, n), bool)
    for b in range(Bl):
        in_fast[b, rng.choice(n, rng.integers(0, k + 1), replace=False)] = True
    promote, demote = plans(rng, Bl, n, P, D)
    got = simjax.apply_padded_migrations(_t(in_fast), _t(promote),
                                         _t(demote), k)
    for b in range(Bl):
        want = jsimjax.apply_padded_migrations(
            jnp.asarray(in_fast[b]), jnp.asarray(promote[b]),
            jnp.asarray(demote[b]), k)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[b].numpy(), np.asarray(w))
    if P != D:
        return
    valid = promote >= 0
    got2 = simjax.apply_migrations(_t(in_fast), _t(np.maximum(promote, 0)),
                                   _t(demote), _t(valid), k)
    want2 = jsimjax.apply_migrations(
        jnp.asarray(in_fast[0]), jnp.asarray(np.maximum(promote[0], 0)),
        jnp.asarray(demote[0]), jnp.asarray(valid[0]), k)
    for g, w in zip(got2, want2):
        np.testing.assert_array_equal(g[0].numpy(), np.asarray(w))


def test_only_arms_serves():
    """``"arms"`` alone resolves to the serving spec (fixed cadence, read
    once on the host); the other names are the registry's families, and
    an unknown name raises."""
    spec = TP.serving_policy("ARMS", pool_every=4)
    assert type(spec).__name__ == "ARMSServeSpec"
    assert spec.pool_every == 4 and spec.fire_period() == 4
    pool = TP.init_pool("arms", 8, 3, pool_every=4, device="cpu")
    assert pool.period == 4 and type(pool.spec) is type(spec)
    for name in ("memtis", "hybridtier"):
        assert TP.serving_policy(name).name == name
        assert type(TP.init_pool(name, 8, 3, device="cpu").spec) \
            is not type(spec)
    with pytest.raises(ValueError, match="unknown policy"):
        TP.serving_policy("lru")


def test_write_token_keeps_streams_distinct():
    cfg = PK.PagedKVConfig(**CFG)
    kv = PK.init_paged_kv(cfg, B, KV, DH, dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(5)
    for t in range(cfg.page_size):
        kv = PK.write_token(kv, _t(rng.standard_normal((B, KV, DH))),
                            _t(rng.standard_normal((B, KV, DH))), t, cfg)
    assert kv.k_slow.any() and not torch.equal(kv.k_slow, kv.v_slow)
    assert not kv.k_fast.any()
