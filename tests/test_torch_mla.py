"""Port parity of the MLA family (deepseek-v2-236b: the flash op widened
to unequal q/k and v widths, repro_torch/models/attention.py's MLA, the
MLA blocks, the moe-with-MLA entries of models/model.py, launch/train.py
and launch/serve.py, ``convert.decode_cache``).

* The plain flash version (the CPU side of the flash op) against JAX's
  ``xla_flash.flash_sdpa`` with a small block, at MLA's width pairs (32,
  16) and (192, 128), causal and not, in f32: within 2e-6 of the largest
  entry (the online softmax sums key blocks in another order).
* ``mla_full`` at S < 4,096 (JAX's naive branch, which the port runs
  through the flash op) within 1e-5 of the largest entry, its latent
  cache within 1e-6; ``mla_decode`` and ``mla_decode_flat`` token by
  token against JAX's, outputs within 1e-5 and caches within 1e-6.
* ``moe_apply`` at deepseek-v2's routing (top-6 of 160 experts, 2 shared)
  on reduced widths: routing, ``expert_load`` and the dropped copies
  exact, also with a zero router (every probability tied).
* Reduced deepseek-v2-236b in f32 (layer 0 dense, 2 MoE layers, 4 heads of
  q/k width 16 + 16 and v width 16, kv_lora 32, q_lora 48; top-2 of 8
  experts, 1 shared): the init tree equals JAX's at full width in bf16
  (the router f32), ``count_params`` JAX's 235,741,434,880 and, cut to
  layer 0 + one MoE layer, 5,358,679,040; forward and prefill logits
  within 2e-5, the aux loss within 1e-6 relative; loss within 1e-6
  relative and every gradient within 1e-5 of its leaf's largest, remat
  off and on; 20 greedy ``decode_step``s with tokens equal, logits within
  1e-5 and the caches within 2e-6 of their largest entry (the MoE layers'
  latent cache inherits layer 0's last-ulp differences through the
  absorbed attention's einsums: 1.42e-6 at worst); a JAX cache carried
  across mid-decode continues to the same tokens; two ``make_train_step``
  steps and both packages' ``train`` from one checkpoint as the other
  families'; ``launch.serve`` tiers it.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity as P
from repro.configs import registry as jregistry
from repro.launch import steps as jsteps
from repro.models import attention as JA
from repro.models import model as JM
from repro.models import moe as JMoE
from repro.models import xla_flash
from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.kernels.flash_attention import ref as fref
from repro_torch.launch import serve as S
from repro_torch.launch import steps
from repro_torch.models import attention as A
from repro_torch.models import model as M
from repro_torch.models import moe as MoE

ARCH = "deepseek-v2-236b"


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dq,dv", [(32, 16), (192, 128)])
def test_plain_flash_matches_xla_flash_sdpa(dq, dv, causal):
    rng = np.random.default_rng(dq + causal)
    B, S, H = 2, 48, 3
    q, k = (rng.standard_normal((B, S, H, dq)).astype(np.float32)
            for _ in range(2))
    v = rng.standard_normal((B, S, H, dv)).astype(np.float32)
    want = xla_flash.flash_sdpa(
        *(jnp.asarray(x).transpose(0, 2, 1, 3) for x in (q, k, v)),
        dq ** -0.5, causal=causal, block=16)
    got = fref.flash_attention_ref(*map(torch.from_numpy, (q, k, v)),
                                   causal=causal)
    assert got.shape == (B, S, H, dv)
    P.close(got, np.asarray(want).transpose(0, 2, 1, 3), 2e-6)
    assert torch.equal(fops.flash_attention(
        *map(torch.from_numpy, (q, k, v)), causal=causal), got)


def _attn_case(seed=0, S=24):
    jcfg, cfg = (r.reduced(r.get_arch(ARCH)) for r in (jregistry, registry))
    jp = JA.mla_init(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    p = convert.model_params(P.np_tree(jp), cfg, device="cpu")
    x = np.random.default_rng(seed).standard_normal(
        (2, S, cfg.d_model)).astype(np.float32)
    return jcfg, cfg, jp, p, x


@pytest.mark.parametrize("causal", [True, False])
def test_mla_full_matches_jax(causal):
    jcfg, cfg, jp, p, x = _attn_case()
    jout, jcache = JA.mla_full(jp, jnp.asarray(x), jcfg, causal=causal)
    out, cache = A.mla_full(p, torch.from_numpy(x), cfg, causal=causal)
    P.close(out, jout, 1e-5)
    P.close(cache.c_kv, jcache.c_kv, 1e-6)
    P.close(cache.k_rope, jcache.k_rope, 1e-6)


@pytest.mark.parametrize("flat", [False, True])
def test_mla_decode_matches_jax(flat):
    """Eight tokens through ``mla_decode`` (one layer's cache) or
    ``mla_decode_flat`` (layer 1 of a stacked cache of 2), each written
    in place, against JAX's under ``jit``."""
    jcfg, cfg, jp, p, x = _attn_case(1, S=8)
    R, rd, S_max = cfg.kv_lora_rank, cfg.rope_head_dim, 12
    if flat:
        jc = (jnp.zeros((2, 2, S_max, R)), jnp.zeros((2, 2, S_max, rd)))
        step = jax.jit(lambda c, r, xt, pos: JA.mla_decode_flat(
            jp, xt, c, r, 1, pos, jcfg))
        tc = (torch.zeros((2, 2, S_max, R)), torch.zeros((2, 2, S_max, rd)))
    else:
        jc = JA.MLACache(c_kv=jnp.zeros((2, S_max, R)),
                         k_rope=jnp.zeros((2, S_max, rd)))
        step = jax.jit(lambda c, xt, pos: JA.mla_decode(jp, xt, c, pos,
                                                        jcfg))
        tc = A.MLACache(c_kv=torch.zeros((2, S_max, R)),
                        k_rope=torch.zeros((2, S_max, rd)))
    for t in range(8):
        xt = x[:, t:t + 1]
        if flat:
            jout, *jc = step(*jc, jnp.asarray(xt), jnp.int32(t))
            out, *tc = A.mla_decode_flat(p, torch.from_numpy(xt), *tc, 1,
                                         t, cfg)
        else:
            jout, jc = step(jc, jnp.asarray(xt), jnp.int32(t))
            out, tc = A.mla_decode(p, torch.from_numpy(xt), tc, t, cfg)
        P.close(out, jout, 1e-5, f"t={t}")
    want = jc if flat else (jc.c_kv, jc.k_rope)
    got = tc if flat else (tc.c_kv, tc.k_rope)
    for g, w in zip(got, want):
        P.close(g, w, 1e-6)
    if flat:    # layer 0 of the stack untouched
        assert not got[0][0].any() and not got[1][0].any()


@pytest.mark.parametrize("zero_router", [False, True])
def test_routing_at_deepseeks_width_is_exact(zero_router):
    """Top-6 of 160 experts with 2 shared (deepseek-v2's routing) on
    d_model 64: the routing (``top_k``'s indices), ``expert_load`` and the
    dropped copies equal JAX's; ``y`` within 1e-5 of its largest entry."""
    over = dict(n_experts=160, experts_per_token=6, n_shared_experts=2,
                moe_d_ff=16)
    jcfg, cfg = (dataclasses.replace(r.reduced(r.get_arch(ARCH)), **over)
                 for r in (jregistry, registry))
    jp = JMoE.moe_init(jax.random.PRNGKey(3), jcfg, jnp.float32)
    if zero_router:
        jp["router"]["w"] = jnp.zeros_like(jp["router"]["w"])
    p = convert.model_params(P.np_tree(jp), cfg, device="cpu")
    x = np.random.default_rng(3).standard_normal((2, 40, 64)).astype(
        np.float32)
    jy, jaux, jload = JMoE.moe_apply(jp, jnp.asarray(x), jcfg)
    y, aux, load = MoE.moe_apply(p, torch.from_numpy(x), cfg)
    P.close(y, jy, 1e-5)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)
    np.testing.assert_array_equal(load.numpy(), np.asarray(jload))
    xf = x.reshape(-1, 64)
    _, jidx = jax.lax.top_k(jax.nn.softmax(jnp.asarray(xf)
                                           @ jp["router"]["w"], -1), 6)
    _, idx = MoE._top_k(torch.softmax(torch.from_numpy(xf)
                                      @ p["router"]["w"], -1), 6)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    T, C = xf.shape[0], MoE._capacity(xf.shape[0], cfg)
    assert C == JMoE._capacity(T, jcfg)
    drops = T * 6 - int(load.sum())
    assert drops == T * 6 - int(np.asarray(jload).sum())
    if zero_router:   # ties: every token to experts 0..5, C kept each
        assert (idx.numpy() == np.arange(6)).all() and drops > 0


def test_init_tree_and_counts_match_jax_at_full_width():
    jcfg, cfg = jregistry.get_arch(ARCH), registry.get_arch(ARCH)
    one = dataclasses.replace(cfg, n_layers=2)
    want = P.tree_spec(jax.eval_shape(lambda: JM.init_params(
        jax.random.PRNGKey(0), dataclasses.replace(jcfg, n_layers=2))))
    got = P.port_spec(M._moe_mla_init(torch.Generator(), one,
                                      torch.bfloat16, "meta"))
    assert got == want
    assert got[("moe_layers", "attn", "wkv_b", "w")] == ((1, 512, 32768),
                                                         "bfloat16")
    assert got[("moe_layers", "moe", "router", "w")] == ((1, 5120, 160),
                                                         "float32")
    assert got[("layer0", "mlp", "wi", "w")] == ((5120, 24576), "bfloat16")
    assert cfg.n_params == JM.count_params(jcfg) == 235_741_434_880
    assert one.n_params == 5_358_679_040


def test_forward_and_prefill_match_jax():
    jcfg, cfg, jp, params = P.setup(ARCH)
    jb, tb = P.batch(cfg, 2, 32)
    jlog, jaux = JM.forward(jp, jb, jcfg)
    logits, aux = M.forward(params, tb, cfg)
    P.close(logits, jlog, 2e-5)
    assert float(jaux) > 0.0
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)
    pre = steps.make_prefill_step(cfg)(params, tb)
    P.close(pre, jsteps.make_prefill_step(jcfg)(jp, jb), 2e-5)
    assert torch.equal(M.prefill(params, tb, cfg), pre)


@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_grads_match_jax(remat):
    jcfg, cfg, jp, params = P.setup(ARCH)
    jb, tb = P.batch(cfg, 2, 32)
    P.loss_and_grads(jcfg, cfg, jp, params, jb, tb, remat)


def test_decode_matches_jax():
    jcfg, cfg, jp, params = P.setup(ARCH)
    cache = P.greedy_decode(jcfg, cfg, jp, params, 2, 24, 20,
                            cache_tol=2e-6)
    assert cache.keys() == {"layer0", "moe"}
    assert cache["layer0"].c_kv.shape == (2, 24, 32)
    assert cache["moe"].k_rope.shape == (2, 2, 24, 16)


def test_a_jax_cache_continues_in_the_port():
    """Six JAX decode steps, the cache carried across with
    ``convert.decode_cache``, then six more on each side: equal tokens,
    logits within 1e-5."""
    jcfg, cfg, jp, params = P.setup(ARCH)
    jstep = jax.jit(lambda p, t, c, pos: JM.decode_step(p, t, c, pos, jcfg))
    jc = JM.init_cache(jcfg, 2, 16)
    jtok = jnp.asarray([[5], [9]], jnp.int32)
    for t in range(6):
        jlog, jc = jstep(jp, jtok, jc, jnp.int32(t))
        jtok = jnp.argmax(jlog[:, -1:], -1).astype(jnp.int32)
    cache = convert.decode_cache(P.np_tree(jc), device="cpu")
    assert isinstance(cache["moe"], A.MLACache)
    tok = torch.from_numpy(np.array(jtok))
    for t in range(6, 12):
        jlog, jc = jstep(jp, jtok, jc, jnp.int32(t))
        logits, cache = M.decode_step(params, tok, cache, t, cfg)
        P.close(logits, jlog, 1e-5, f"t={t}")
        jtok = jnp.argmax(jlog[:, -1:], -1).astype(jnp.int32)
        tok = logits[:, -1:].argmax(-1).to(torch.int32)
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))


@pytest.mark.parametrize("grad_accum,remat", [(1, False), (2, True)])
def test_train_step_matches_jax(grad_accum, remat):
    jcfg, cfg, jp, params = P.setup(ARCH)
    P.train_steps(jcfg, cfg, jp, params, lambda i: P.batch(cfg, 2, 32, i),
                  grad_accum, remat, noisy_share=0.05)


def test_train_loop_from_a_shared_step0_checkpoint(tmp_path):
    P.train_loops(ARCH, tmp_path)


def test_serve_tiers_the_family():
    """``launch.serve`` decodes the family with one attention layer's KV
    pages tiered by ARMS, as it serves a dense model."""
    rep = S.serve(ARCH, 12, 2, page_size=4, quiet=True, device="cpu")
    assert rep.fast_mass.shape == (12,) and np.isfinite(rep.fast_mass).all()
    assert np.isfinite(rep.slowdown) and rep.promotions >= 1
