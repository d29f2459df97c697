"""The serving slice as a whole (repro_torch/launch/serve.py).

* Reduced granite-8b, batch 2, 24 tokens, pages of 8: the JAX serving
  loop (``decode_step``, greedy argmax, ``serve_decode_step``, the
  fast-mass EWMA) against the port's per-token function ``serve_token``,
  with the JAX weights carried across and the same numpy q/k/v streams
  injected on both sides: tokens, plans and residency exact, the
  fast-mass share within 1e-6.
* ``serve()`` on the CPU: report fields of the right shapes and the K and
  V slow pools diverge (the port of ``TestKVDivergence``); ``device=None``
  means the card and raises without one; an unknown policy and what is
  not ported (the rest of the model families) raise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.models import model as JM
from repro.tiering import paged_kv as JPK
from repro_torch import convert
from repro_torch.launch import serve as S

T, BATCH, PAGE = 24, 2, 8


def test_serve_loop_matches_jax():
    jcfg = jregistry.reduced(jregistry.get_arch("granite-8b"))
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    cfg, params, pk_cfg, kv, cache, _ = S.setup(
        "granite-8b", T, BATCH, page_size=PAGE, device="cpu",
        params=None if False else convert.model_params(
            jax.tree_util.tree_map(np.asarray, jp),
            jregistry.reduced(jregistry.get_arch("granite-8b")),
            device="cpu"))
    jpk = JPK.PagedKVConfig(page_size=pk_cfg.page_size,
                            n_pages=pk_cfg.n_pages,
                            fast_pages=pk_cfg.fast_pages,
                            policy_every=pk_cfg.policy_every)
    jkv = JPK.init_paged_kv(jpk, BATCH, jcfg.n_kv_heads, jcfg.head_dim,
                            dtype=jnp.float32)
    jcache = JM.init_cache(jcfg, BATCH, pk_cfg.n_pages * PAGE)
    rng = np.random.default_rng(11)
    H, KV, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    streams = [tuple(rng.standard_normal(s).astype(np.float32)
                     for s in ((BATCH, H, dh), (BATCH, KV, dh),
                               (BATCH, KV, dh))) for _ in range(T)]
    draw = lambda t: tuple(torch.from_numpy(x) for x in streams[t])

    jtok = jnp.zeros((BATCH, 1), jnp.int32)
    jewma = jnp.zeros((pk_cfg.n_pages,), jnp.float32)
    token = torch.zeros((BATCH, 1), dtype=torch.int32)
    ewma = torch.zeros((pk_cfg.n_pages,), dtype=torch.float32)
    promotions = 0
    for t in range(T):
        logits, jcache = JM.decode_step(jp, jtok, jcache, jnp.int32(t), jcfg)
        jtok = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
        _, jkv, jplan = JPK.serve_decode_step(
            jkv, *(jnp.asarray(x) for x in streams[t]), jnp.int32(t), jpk)
        jewma = 0.98 * jewma + jplan.access
        jshare = (jewma * jkv.pool.in_fast).sum() \
            / jnp.maximum(jewma.sum(), 1e-9)
        token, cache, kv, plan, ewma, share = S.serve_token(
            params, cfg, pk_cfg, token, cache, kv, ewma, t, draw)
        np.testing.assert_array_equal(token.numpy(), np.asarray(jtok))
        for nm in ("promote", "demote", "pexec", "dexec"):
            np.testing.assert_array_equal(getattr(plan, nm).numpy(),
                                          np.asarray(getattr(jplan, nm)),
                                          err_msg=f"{nm}, t={t}")
        np.testing.assert_array_equal(kv.in_fast.numpy(),
                                      np.asarray(jkv.pool.in_fast))
        np.testing.assert_array_equal(kv.slot.numpy(),
                                      np.asarray(jkv.pool.slot))
        np.testing.assert_allclose(float(share), float(jshare), rtol=0,
                                   atol=1e-6)
        promotions += int(plan.count)
    assert promotions > 0


def test_serve_report_and_kv_divergence():
    rep = S.serve("granite-8b", n_tokens=12, batch=1, page_size=8,
                  quiet=True, device="cpu")
    assert rep.policy == "arms" and rep.fast_mass.shape == (12,)
    assert np.isfinite(rep.fast_mass).all() and rep.slowdown > 0.0
    assert rep.promotions == rep.telemetry["promotions"] >= 1
    assert rep.tok_s > 0 and rep.init_s >= 0 and rep.trace is None
    ks, vs = rep.kv.k_slow, rep.kv.v_slow
    assert ks.any() and vs.any()
    assert not torch.equal(ks, vs), "K and V slow pools are identical"


def test_serve_defaults_to_the_card_and_rejects_what_is_not_ported():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            S.serve("granite-8b", n_tokens=4, batch=1, quiet=True)
    with pytest.raises(ValueError, match="unknown policy"):
        S.serve("granite-8b", 4, 1, policy="lru", device="cpu")
    for arch in ("deepseek-v2-236b", "whisper-small"):
        rep = S.serve(arch, 4, 1, device="cpu", quiet=True)
        assert np.isfinite(rep.fast_mass).all()
    with pytest.raises(SystemExit):
        S.serve("mamba2", 4, 1, device="cpu")
