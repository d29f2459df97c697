"""Port parity of the rest of the tiering layer: sparse attention
(repro_torch/tiering/sparse_attention.py), the paged KV's gathered view
and ``with_residency``, the expert tier (expert_tiering.py) and the
embedding tier (embedding_tiering.py), against the JAX package on the
same numpy inputs.

* Sparse attention on the skewed decode of tests/test_sparse_attention.py
  (JAX's paged KV carried across with ``convert.paged_kv``), as it stands
  and with residency overridden: output and page mass within 1e-5, the
  attended fraction exact; the gathered view exact.  The module's quality
  claim on the port's own decode: the error within the skipped mass.
* The expert tier (tests/test_tiering.py's cases, and a moving Zipf-like
  router load under several families): residency, slots, plans and
  telemetry counts exact, the fused pools and ``effective_weights`` bit
  for bit JAX's (and the home slabs).
* The embedding tier (tests/test_tiering.py's case, and a moving hot
  range): embeddings bit for bit, the hit fraction, residency, slots and
  plans exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cases import t as _t
from repro.tiering import embedding_tiering as JET
from repro.tiering import expert_tiering as JXT
from repro.tiering import paged_kv as JPK
from repro.tiering.sparse_attention import \
    sparse_attention_step as jsparse_step
from repro_torch import convert
from repro_torch.tiering import embedding_tiering as ET
from repro_torch.tiering import expert_tiering as XT
from repro_torch.tiering import paged_kv as PK
from repro_torch.tiering.sparse_attention import sparse_attention_step

SP = dict(page_size=8, n_pages=8, fast_pages=4, policy_every=2)
B, KV, H, DH = 1, 2, 4, 16


def _np(obj):
    return jax.tree_util.tree_map(np.asarray, obj)


def _same_pool(jpool, pool, what):
    got = convert.pool_leaves(pool)
    for nm in ("in_fast", "slot", "promos", "demos", "waste", "t"):
        np.testing.assert_array_equal(got[nm], np.asarray(getattr(jpool, nm)),
                                      err_msg=f"{nm}, {what}")
    np.testing.assert_allclose(got["wall_s"], np.asarray(jpool.wall_s),
                               rtol=1e-6)


def _same_plan(jplan, plan, what):
    for nm in ("promote", "demote", "pexec", "dexec", "count"):
        np.testing.assert_array_equal(getattr(plan, nm).numpy(),
                                      np.asarray(getattr(jplan, nm)),
                                      err_msg=f"{nm}, {what}")


# ------------------------------------------------------- sparse attention
def _skewed_streams(steps, seed=0, hot_scale=6.0):
    """tests/test_sparse_attention.py's decode: pages 1-2 get loud keys."""
    rng = np.random.default_rng(seed)
    out = []
    for t in range(steps):
        q = rng.standard_normal((B, H, DH)).astype(np.float32)
        k_new = (rng.standard_normal((B, KV, DH)) * 0.3).astype(np.float32)
        if (t // SP["page_size"]) in (1, 2):
            k_new = k_new * np.float32(hot_scale)
        v_new = rng.standard_normal((B, KV, DH)).astype(np.float32)
        out.append((q, k_new, v_new))
    return out


def _jax_skewed(steps):
    cfg = JPK.PagedKVConfig(**SP)
    kv = JPK.init_paged_kv(cfg, B, KV, DH, dtype=jnp.float32)
    streams = _skewed_streams(steps)
    for t, (q, k_new, v_new) in enumerate(streams):
        _, kv, _ = JPK.serve_decode_step(kv, jnp.asarray(q),
                                         jnp.asarray(k_new),
                                         jnp.asarray(v_new), jnp.int32(t),
                                         cfg)
    return kv, streams[-1][0]


@pytest.mark.parametrize("steps,residency", [
    (64, "as is"), (64, "two fast"), (32, "none"), (29, "as is")])
def test_sparse_attention_matches_jax(steps, residency):
    jcfg, cfg = JPK.PagedKVConfig(**SP), PK.PagedKVConfig(**SP)
    jkv, q = _jax_skewed(steps)
    if residency == "two fast":
        jkv = JPK.with_residency(jkv, jkv.in_fast & (
            jnp.cumsum(jkv.in_fast.astype(jnp.int32)) <= 2))
    elif residency == "none":
        jkv = JPK.with_residency(jkv, jnp.zeros_like(jkv.in_fast))
    kv = convert.paged_kv(_np(jkv), device="cpu")
    pos = steps - 1
    jk, jv = JPK._gather_kv(jkv)
    k, v = PK.gather_kv(kv)
    np.testing.assert_array_equal(k.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    jout, jmass, jfrac = jsparse_step(jkv, jnp.asarray(q), jnp.int32(pos),
                                      jcfg)
    out, mass, frac = sparse_attention_step(kv, _t(q), pos, cfg)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(mass.numpy(), np.asarray(jmass), rtol=0,
                               atol=1e-5)
    assert frac.dtype == torch.float32
    assert float(frac) == float(jfrac)


def test_with_residency_matches_jax():
    jkv, _ = _jax_skewed(24)
    kv = convert.paged_kv(_np(jkv), device="cpu")
    mask = np.arange(SP["n_pages"]) % 3 == 0
    jk = JPK.with_residency(jkv, mask)
    pk = PK.with_residency(kv, mask)
    np.testing.assert_array_equal(pk.in_fast.numpy(), np.asarray(jk.in_fast))
    np.testing.assert_array_equal(pk.slot.numpy(), np.asarray(jk.slot))
    assert pk.in_fast.dtype == torch.bool
    assert not torch.equal(kv.in_fast, pk.in_fast)


def test_sparse_error_bounded_by_skipped_mass():
    """The module's quality claim on the port's own decode: the error is
    at most the skipped pages' attention mass (plus 0.05)."""
    cfg = PK.PagedKVConfig(**SP)
    kv = PK.init_paged_kv(cfg, B, KV, DH, dtype=torch.float32, device="cpu")
    steps = cfg.page_size * cfg.n_pages
    streams = _skewed_streams(steps)
    for t, (q, k_new, v_new) in enumerate(streams):
        _, kv, _ = PK.serve_decode_step(kv, _t(q), _t(k_new), _t(v_new), t,
                                        cfg)
    q = _t(streams[-1][0])
    full, mass = PK.paged_attention_step(kv, q, steps - 1, cfg)
    sparse, _, frac = sparse_attention_step(kv, q, steps - 1, cfg)
    attended = kv.in_fast.numpy().copy()
    attended[0] = True
    attended[-2:] = True
    skipped = float(mass.numpy()[~attended].sum()) / float(mass.sum())
    err = float((sparse - full).abs().max()) / float(full.abs().max())
    assert float(frac) < 1.0 and skipped < 0.5
    assert err <= skipped + 0.05, (err, skipped)


# ------------------------------------------------------------ expert tier
def _expert_pair(E, Kf, D, F, every, policy, seed):
    rng = np.random.default_rng(seed)
    wi = rng.standard_normal((E, D, 2 * F)).astype(np.float32)
    wo = rng.standard_normal((E, F, D)).astype(np.float32)
    jcfg = JXT.ExpertTierConfig(n_experts=E, fast_experts=Kf,
                                policy_every=every)
    cfg = XT.ExpertTierConfig(n_experts=E, fast_experts=Kf,
                              policy_every=every)
    jt = JXT.init_expert_tier(jcfg, jnp.asarray(wi), jnp.asarray(wo),
                              policy=policy)
    t = XT.init_expert_tier(cfg, _t(wi), _t(wo), policy=policy,
                            device="cpu")
    # the port's own init equals JAX's carried across
    c = convert.expert_tier(_np(jt), device="cpu")
    assert torch.equal(c.wi, t.wi) and torch.equal(c.wo, t.wo)
    _same_pool(jt.pool, t.pool, "init")
    return jcfg, cfg, jt, t, wi, wo


_jexpert_step = jax.jit(JXT.observe_and_policy, static_argnames=("cfg",))
_jlookup = jax.jit(JET.lookup, static_argnames=("cfg",))
_jembed_policy = jax.jit(JET.policy, static_argnames=("cfg",))


def _expert_steps(jcfg, cfg, jt, t, loads):
    for s, load in enumerate(loads):
        jt, jplan = _jexpert_step(jt, jnp.asarray(load), jcfg)
        t, plan = XT.observe_and_policy(t, _t(load), cfg)
        _same_plan(jplan, plan, f"step {s}")
        _same_pool(jt.pool, t.pool, f"step {s}")
    return jt, t


def _same_weights(jt, t, wi, wo):
    back = convert.expert_leaves(t)
    for nm in back:
        np.testing.assert_array_equal(back[nm], np.asarray(getattr(jt, nm)),
                                      err_msg=nm)
    jwi, jwo = JXT.effective_weights(jt)
    pwi, pwo = XT.effective_weights(t)
    np.testing.assert_array_equal(pwi.numpy(), np.asarray(jwi))
    np.testing.assert_array_equal(pwo.numpy(), np.asarray(jwo))
    np.testing.assert_array_equal(pwi.numpy(), wi)
    np.testing.assert_array_equal(pwo.numpy(), wo)


def test_expert_hot_experts_promoted_as_jax():
    jcfg, cfg, jt, t, wi, wo = _expert_pair(8, 3, 16, 8, 1, "arms", 0)
    load = np.array([100, 90, 80, 1, 1, 1, 1, 1], np.float32)
    jt, t = _expert_steps(jcfg, cfg, jt, t, [load] * 6)
    assert t.in_fast[:3].sum() == 3
    _same_weights(jt, t, wi, wo)


def test_expert_bursty_expert_filtered_as_jax():
    jcfg, cfg, jt, t, wi, wo = _expert_pair(8, 2, 4, 4, 1, "arms", 1)
    steady = np.array([50, 50, 0, 0, 0, 0, 0, 0], np.float32)
    burst = steady.copy()
    burst[7] = 500.0
    jt, t = _expert_steps(jcfg, cfg, jt, t,
                          [steady] * 5 + [burst] + [steady] * 4)
    assert not bool(t.in_fast[7])
    _same_weights(jt, t, wi, wo)


@pytest.mark.parametrize("policy", ["arms", "hemem", "memtis", "jenga",
                                    "tierbpf"])
def test_expert_zipf_load_matches_jax(policy):
    E, Kf = 24, 6
    jcfg, cfg, jt, t, wi, wo = _expert_pair(E, Kf, 8, 4, 4, policy, 2)
    rng = np.random.default_rng(3)
    p = 1.0 / np.arange(1, E + 1) ** 1.1
    loads = []
    for s in range(40):
        perm = np.roll(np.arange(E), 5 * (s // 16))
        picks = rng.choice(E, 256, p=p / p.sum())
        loads.append(np.bincount(perm[picks], minlength=E).astype(
            np.float32))
    jt, t = _expert_steps(jcfg, cfg, jt, t, loads)
    assert int(t.pool.promos) > 0
    _same_weights(jt, t, wi, wo)


# --------------------------------------------------------- embedding tier
def _embed_pair(V, D, rb, fb, every, policy, seed):
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((V, D)).astype(np.float32)
    jcfg = JET.EmbedTierConfig(vocab=V, row_block=rb, fast_blocks=fb,
                               policy_every=every)
    cfg = ET.EmbedTierConfig(vocab=V, row_block=rb, fast_blocks=fb,
                             policy_every=every)
    jt = JET.init_embed_tier(jcfg, jnp.asarray(table), policy=policy)
    t = ET.init_embed_tier(cfg, _t(table), policy=policy, device="cpu")
    assert torch.equal(convert.embed_tier(_np(jt), device="cpu").table,
                       t.table)
    return jcfg, cfg, jt, t, table


def _embed_steps(jcfg, cfg, jt, t, id_batches):
    hits = []
    for s, ids in enumerate(id_batches):
        jemb, jhits, jt = _jlookup(jt, jnp.asarray(ids), jcfg)
        emb, hit, t = ET.lookup(t, _t(ids), cfg)
        np.testing.assert_array_equal(emb.numpy(), np.asarray(jemb))
        assert float(hit) == float(jhits), s
        np.testing.assert_array_equal(t.pool.counts.numpy(),
                                      np.asarray(jt.pool.counts))
        jt, jplan = _jembed_policy(jt, jcfg)
        t, plan = ET.policy(t, cfg)
        _same_plan(jplan, plan, f"lookup {s}")
        _same_pool(jt.pool, t.pool, f"lookup {s}")
        hits.append(float(hit))
    return jt, t, hits


def test_embedding_zipf_hot_blocks_promoted_as_jax():
    jcfg, cfg, jt, t, table = _embed_pair(4096, 8, 256, 4, 1, "arms", 2)
    rng = np.random.default_rng(2)
    ids = rng.integers(0, 1024, (64,)).astype(np.int32)
    jt, t, hits = _embed_steps(jcfg, cfg, jt, t, [ids] * 7)
    assert hits[-1] == 1.0


@pytest.mark.parametrize("policy", ["arms", "tpp", "hybridtier"])
def test_embedding_moving_hot_range_matches_jax(policy):
    V = 2048
    jcfg, cfg, jt, t, table = _embed_pair(V, 4, 64, 6, 4, policy, 5)
    rng = np.random.default_rng(6)
    batches = []
    for s in range(48):
        base = 512 * (s // 16)
        hot = base + rng.integers(0, 384, (4, 24))
        cold = rng.integers(0, V, (4, 8))
        batches.append(np.concatenate([hot, cold], 1).astype(np.int32))
    jt, t, hits = _embed_steps(jcfg, cfg, jt, t, batches)
    assert int(t.pool.promos) > 0
