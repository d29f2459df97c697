"""Port parity of the enc-dec family (whisper-small: the GELU MLP and the
sinusoidal positions of models/layers.py, ``gqa_cross``, the encoder and
decoder blocks, the enc-dec entries of models/model.py, the train
launcher's ``audio_embeds`` stub, launch/serve.py and
``convert.decode_cache``).

* ``gelu_mlp`` within 1e-6 of JAX's (``jax.nn.gelu``'s tanh form).
  ``sinusoidal_positions`` and ``sinusoidal_at`` within one ulp of the
  largest angle (``seq`` x 2^-23) of JAX's jitted tables at 16, 448 and
  1,500 positions: the port forms the angles as XLA's compiled program
  does and takes sin and cos in f64 rounded once; where XLA's f32 power
  rounds the other way (about 1.5 % of the elements) the angle is an ulp
  off (6.1e-5 at 1,500 positions).  ``sinusoidal_at`` is the table's row
  bit for bit.
* ``gqa_cross`` within 1e-5 of the largest entry; ``_encode`` (the
  encoder: non-causal flash attention without RoPE) within 1e-5.
* Reduced whisper-small in f32 (2 encoder and 2 decoder layers, d_model
  64, 4 heads of 16, 16 stub frames): the init tree equals JAX's at full
  width in bf16 and ``count_params`` JAX's 238,139,904; forward and
  prefill logits within 2e-5; loss within 1e-6 relative and every
  gradient within 1e-5 of its leaf's largest, remat off and on; 20 greedy
  ``decode_step``s with tokens equal, logits within 1e-5 and the caches
  within 1e-6; a JAX cache carried across mid-decode continues to the
  same tokens; two ``make_train_step`` steps (as the other families';
  up to 1 % of the elements have a first gradient that is nonzero and
  below 1e-6, 0.60 % at grad_accum 1: the attention projections', whose
  largest gradients are 1e-3 to 4e-3 at this size, where a dense stack
  has under 0.1 %) and both packages' ``train`` from one checkpoint (the
  launchers' zero stubs are the same f32 zeros at this config);
  ``launch.serve`` tiers it.
* The stub at a bf16 config (reduced whisper-small in bf16): the port's
  loss on ``train.stub_inputs`` (bf16 zeros) against JAX's ``loss_fn``
  fed the same bf16 zeros, within 2e-2 relative (bf16 rounding in
  another order on each side); JAX's own f32 stub does not trace there
  (ROADMAP queue 3), which the test also shows.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity as P
from repro.configs import registry as jregistry
from repro.launch import steps as jsteps
from repro.models import attention as JA
from repro.models import layers as JL
from repro.models import model as JM
from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.launch import serve as S
from repro_torch.launch import steps
from repro_torch.launch import train as T
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import model as M

ARCH = "whisper-small"


def _audio(cfg, B=2, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (B, cfg.enc_seq, cfg.d_model)).astype(np.float32)


def _batch(cfg, B, S, step=0, audio=None):
    jb, tb = P.batch(cfg, B, S, step)
    a = _audio(cfg, B, step) if audio is None else audio
    jb["audio_embeds"], tb["audio_embeds"] = jnp.asarray(a), \
        torch.from_numpy(a)
    return jb, tb


def test_gelu_mlp_matches_jax():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((4, 3, 64)) * 1.5).astype(np.float32)
    wi = (rng.standard_normal((64, 128)) / 8).astype(np.float32)
    wo = (rng.standard_normal((128, 64)) / 11).astype(np.float32)
    jp = {"wi": {"w": jnp.asarray(wi)}, "wo": {"w": jnp.asarray(wo)}}
    tp = {"wi": {"w": torch.from_numpy(wi)}, "wo": {"w": torch.from_numpy(wo)}}
    np.testing.assert_allclose(L.gelu_mlp(tp, torch.from_numpy(x)).numpy(),
                               np.asarray(JL.gelu_mlp(jp, jnp.asarray(x))),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("seq,d", [(16, 64), (448, 768), (1500, 768)])
def test_sinusoids_match_jax(seq, d):
    ulp = seq * 2.0 ** -23
    want = np.asarray(jax.jit(JL.sinusoidal_positions,
                              static_argnums=(0, 1))(seq, d))
    got = L.sinusoidal_positions(seq, d)
    assert got.dtype == torch.float32 and got.shape == (seq, d)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ulp)
    at = jax.jit(lambda p: JL.sinusoidal_at(p, d))
    for pos in (0, 1, seq // 2, seq - 1):
        row = L.sinusoidal_at(pos, d)
        assert torch.equal(row, got[pos])
        np.testing.assert_allclose(row.numpy(), np.asarray(at(
            jnp.int32(pos))), rtol=0, atol=ulp)


def _layer_case(seed=0):
    jcfg, cfg, jp, params = P.setup(ARCH)
    return jcfg, cfg, jp, params, _audio(cfg, 2, seed)


def test_cross_attention_and_encoder_match_jax():
    jcfg, cfg, jp, params, a = _layer_case()
    x = np.random.default_rng(1).standard_normal((2, 20, 64)).astype(
        np.float32)
    enc = JM._encode(jp, jnp.asarray(a), jcfg)
    got_enc = M._encode(params, torch.from_numpy(a), cfg)
    P.close(got_enc, enc, 1e-5)
    jl0 = jax.tree_util.tree_map(lambda t: t[0], jp["dec_layers"])
    tl0 = M._layer(params["dec_layers"], 0)
    jkv = JA.KVCache(k=jnp.asarray(enc[..., :64].reshape(2, 16, 4, 16)),
                     v=jnp.asarray(enc[..., :64].reshape(2, 16, 4, 16)) * 2)
    tkv = A.KVCache(k=torch.from_numpy(np.array(jkv.k)),
                    v=torch.from_numpy(np.array(jkv.v)))
    want = JA.gqa_cross(jl0["cross_attn"], jnp.asarray(x), jkv, jcfg)
    got = A.gqa_cross(tl0["cross_attn"], torch.from_numpy(x), tkv, cfg)
    P.close(got, want, 1e-5)


def test_init_tree_and_count_match_jax_at_full_width():
    jcfg, cfg = jregistry.get_arch(ARCH), registry.get_arch(ARCH)
    want = P.tree_spec(jax.eval_shape(lambda: JM.init_params(
        jax.random.PRNGKey(0), jcfg)))
    got = P.port_spec(M._encdec_init(torch.Generator(), cfg, torch.bfloat16,
                                     "meta"))
    assert got == want
    assert got[("dec_layers", "cross_attn", "wk", "w")] == ((12, 768, 768),
                                                            "bfloat16")
    assert got[("enc_layers", "mlp", "wi", "w")] == ((12, 768, 3072),
                                                     "bfloat16")
    assert cfg.n_params == JM.count_params(jcfg) == 238_139_904


def test_forward_and_prefill_match_jax():
    jcfg, cfg, jp, params = P.setup(ARCH)
    jb, tb = _batch(cfg, 2, 32)
    jlog, _ = JM.forward(jp, jb, jcfg)
    logits, aux = M.forward(params, tb, cfg)
    P.close(logits, jlog, 2e-5)
    assert float(aux) == 0.0
    pre = steps.make_prefill_step(cfg)(params, tb)
    P.close(pre, jsteps.make_prefill_step(jcfg)(jp, jb), 2e-5)
    assert torch.equal(M.prefill(params, tb, cfg), pre)


@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_grads_match_jax(remat):
    jcfg, cfg, jp, params = P.setup(ARCH)
    jb, tb = _batch(cfg, 2, 32)
    P.loss_and_grads(jcfg, cfg, jp, params, jb, tb, remat)


def test_decode_matches_jax():
    jcfg, cfg, jp, params = P.setup(ARCH)
    cache = P.greedy_decode(jcfg, cfg, jp, params, 2, 24, 20)
    assert cache.keys() == {"self", "cross"}
    assert cache["self"].k.shape == (2, 2, 24, 4, 16)
    assert cache["cross"].v.shape == (2, 2, 16, 4, 16)


def test_a_jax_cache_continues_in_the_port():
    """Six JAX decode steps with a cross cache filled from the encoder
    (``cross_kv`` of each layer), the cache carried across with
    ``convert.decode_cache``, then six more on each side: equal tokens,
    logits within 1e-5."""
    from repro.models import blocks as JB
    jcfg, cfg, jp, params = P.setup(ARCH)
    enc = JM._encode(jp, jnp.asarray(_audio(cfg)), jcfg)
    kvs = [JB.cross_kv(jax.tree_util.tree_map(lambda t: t[i],
                                              jp["dec_layers"]), enc, jcfg)
           for i in range(jcfg.n_layers)]
    jc = JM.init_cache(jcfg, 2, 16)
    jc["cross"] = JA.KVCache(k=jnp.stack([c.k for c in kvs]),
                             v=jnp.stack([c.v for c in kvs]))
    jstep = jax.jit(lambda p, t, c, pos: JM.decode_step(p, t, c, pos, jcfg))
    jtok = jnp.asarray([[5], [9]], jnp.int32)
    for t in range(6):
        jlog, jc = jstep(jp, jtok, jc, jnp.int32(t))
        jtok = jnp.argmax(jlog[:, -1:], -1).astype(jnp.int32)
    cache = convert.decode_cache(P.np_tree(jc), device="cpu")
    assert isinstance(cache["cross"], A.KVCache) and cache["cross"].k.any()
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
    P.train_steps(jcfg, cfg, jp, params,
                  lambda i: _batch(cfg, 2, 32, i), grad_accum, remat,
                  noisy_share=0.01)


def test_train_loop_from_a_shared_step0_checkpoint(tmp_path):
    P.train_loops(ARCH, tmp_path)


def test_bf16_stub_loss_matches_jax_fed_the_same_stub():
    jcfg, cfg, jp, params = P.setup(ARCH, "bfloat16")
    jb, tb = P.batch(cfg, 2, 32)
    stub = T.stub_inputs(cfg, 2, torch.device("cpu"))
    assert stub["audio_embeds"].dtype == torch.bfloat16
    assert stub["audio_embeds"].shape == (2, cfg.enc_seq, cfg.d_model)
    assert not stub["audio_embeds"].any()
    loss = M.loss_fn(params, {**tb, **stub}, cfg)
    jloss = jax.jit(lambda p, b: JM.loss_fn(p, b, jcfg))(
        jp, {**jb, "audio_embeds": jnp.zeros((2, cfg.enc_seq, cfg.d_model),
                                             jnp.bfloat16)})
    np.testing.assert_allclose(float(loss), float(jloss), rtol=2e-2)
    with pytest.raises(TypeError):   # JAX's own f32 stub does not trace
        jax.eval_shape(lambda p, b: JM.loss_fn(p, b, jcfg), jp, {
            **jb, "audio_embeds": jnp.zeros((2, cfg.enc_seq, cfg.d_model),
                                            jnp.float32)})


def test_serve_tiers_the_family():
    """``launch.serve`` decodes the family with one attention layer's KV
    pages tiered by ARMS, as it serves a dense model."""
    rep = S.serve(ARCH, 12, 2, page_size=4, quiet=True, device="cpu")
    assert rep.fast_mass.shape == (12,) and np.isfinite(rep.fast_mass).all()
    assert np.isfinite(rep.slowdown) and rep.promotions >= 1
