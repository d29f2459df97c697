"""Pre-norm residual blocks: dense (GQA), MoE (GQA or MLA), MLA + dense
(deepseek's layer 0), mamba, and whisper's encoder and decoder.

The port of ``repro/models/blocks.py``: ``dense_block_init``,
``dense_block_full`` (train, prefill), ``dense_block_decode`` (one
layer's cache), ``dense_block_decode_flat`` (the stacked cache),
``moe_block_init``/``moe_block_full``/``moe_block_decode_flat`` (MLA
attention where ``cfg.use_mla``),
``mla_dense_block_init``/``_full``/``_decode``,
``mamba_block_init``/``mamba_block_full``/``mamba_block_decode``, and
``encoder_block_init``/``_full``, ``decoder_block_init``/``_full``/
``_decode`` and ``cross_kv``.
"""
from __future__ import annotations

import functools

from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M
from repro_torch.models import moe as MoE


def dense_block_init(gen, cfg, dtype, device, lead: tuple = (),
                     d_ff: int | None = None) -> dict:
    """``d_ff`` defaults to ``cfg.d_ff`` (an MoE model's dense layers pass
    its ``dense_d_ff``)."""
    return {"ln1": L.rmsnorm_init(cfg.d_model, dtype, device, lead),
            "attn": A.gqa_init(gen, cfg, dtype, device, lead),
            "ln2": L.rmsnorm_init(cfg.d_model, dtype, device, lead),
            "mlp": L.swiglu_init(gen, cfg.d_model, d_ff or cfg.d_ff, dtype,
                                 device, lead)}


def dense_block_full(p, x, cfg, *, causal: bool = True, window: int = 0):
    """Full-sequence block.  Returns ``(x, KVCache)``."""
    h, kv = A.gqa_full(p["attn"], L.rmsnorm(p["ln1"], x, cfg.norm_eps), cfg,
                       causal=causal, window=window)
    x = x + h
    x = x + L.swiglu(p["mlp"], L.rmsnorm(p["ln2"], x, cfg.norm_eps))
    return x, kv


def dense_block_decode_flat(p, x, k_st, v_st, idx: int, pos: int, cfg, *,
                            window: int = 0):
    """Decode against the stacked ``[L, B, KV, S, dh]`` cache (in-place
    writes).  Returns ``(x, k_st, v_st)``."""
    h, k_st, v_st = A.gqa_decode_flat(
        p["attn"], L.rmsnorm(p["ln1"], x, cfg.norm_eps), k_st, v_st, idx,
        pos, cfg, window=window)
    x = x + h
    x = x + L.swiglu(p["mlp"], L.rmsnorm(p["ln2"], x, cfg.norm_eps))
    return x, k_st, v_st


def dense_block_decode(p, x, cache, pos: int, cfg, *, window: int = 0):
    """Decode against one layer's ``KVCache`` ``[B, S, KV, dh]`` (written
    in place).  Returns ``(x, cache)``."""
    h, cache = A.gqa_decode(p["attn"], L.rmsnorm(p["ln1"], x, cfg.norm_eps),
                            cache, pos, cfg, window=window)
    x = x + h
    x = x + L.swiglu(p["mlp"], L.rmsnorm(p["ln2"], x, cfg.norm_eps))
    return x, cache


# ---------------------------------------------------------------- MoE block
def moe_block_init(gen, cfg, dtype, device, lead: tuple = ()) -> dict:
    attn = A.mla_init if cfg.use_mla else A.gqa_init
    return {"ln1": L.rmsnorm_init(cfg.d_model, dtype, device, lead),
            "attn": attn(gen, cfg, dtype, device, lead),
            "ln2": L.rmsnorm_init(cfg.d_model, dtype, device, lead),
            "moe": MoE.moe_init(gen, cfg, dtype, device, lead)}


def _moe_ffn(p, x, cfg):
    """The MoE half of a block: ``(x + y, aux, expert_load)``."""
    y, aux, load = MoE.moe_apply(p["moe"],
                                 L.rmsnorm(p["ln2"], x, cfg.norm_eps), cfg)
    return x + y, aux, load


def moe_block_full(p, x, cfg, *, window: int = 0):
    """Full-sequence block.  Returns ``(x, KVCache or MLACache, aux,
    expert_load)``."""
    xn = L.rmsnorm(p["ln1"], x, cfg.norm_eps)
    if cfg.use_mla:
        h, kv = A.mla_full(p["attn"], xn, cfg)
    else:
        h, kv = A.gqa_full(p["attn"], xn, cfg, window=window)
    x, aux, load = _moe_ffn(p, x + h, cfg)
    return x, kv, aux, load


def moe_block_decode_flat(p, x, caches, idx: int, pos: int, cfg, *,
                          window: int = 0):
    """Decode against the stacked caches (in-place writes): ``(k_st,
    v_st)`` ``[L, B, KV, S, dh]``, or MLA's ``(c_st, r_st)`` ``[L, B, S,
    *]``.  Returns ``(x, caches, expert_load)``."""
    xn = L.rmsnorm(p["ln1"], x, cfg.norm_eps)
    decode = A.mla_decode_flat if cfg.use_mla else functools.partial(
        A.gqa_decode_flat, window=window)
    h, *caches = decode(p["attn"], xn, *caches, idx, pos, cfg)
    x, _, load = _moe_ffn(p, x + h, cfg)
    return x, tuple(caches), load


# ------------------------------------------ MLA + dense (deepseek's layer 0)
def mla_dense_block_init(gen, cfg, dtype, device, lead: tuple = ()) -> dict:
    return {"ln1": L.rmsnorm_init(cfg.d_model, dtype, device, lead),
            "attn": A.mla_init(gen, cfg, dtype, device, lead),
            "ln2": L.rmsnorm_init(cfg.d_model, dtype, device, lead),
            "mlp": L.swiglu_init(gen, cfg.d_model, cfg.dense_d_ff, dtype,
                                 device, lead)}


def mla_dense_block_full(p, x, cfg):
    """Full-sequence block.  Returns ``(x, MLACache)``."""
    h, kv = A.mla_full(p["attn"], L.rmsnorm(p["ln1"], x, cfg.norm_eps), cfg)
    x = x + h
    x = x + L.swiglu(p["mlp"], L.rmsnorm(p["ln2"], x, cfg.norm_eps))
    return x, kv


def mla_dense_block_decode(p, x, cache, pos: int, cfg):
    """Decode against one layer's ``MLACache`` (written in place).
    Returns ``(x, cache)``."""
    h, cache = A.mla_decode(p["attn"], L.rmsnorm(p["ln1"], x, cfg.norm_eps),
                            cache, pos, cfg)
    x = x + h
    x = x + L.swiglu(p["mlp"], L.rmsnorm(p["ln2"], x, cfg.norm_eps))
    return x, cache


# -------------------------------------------------------------- mamba block
def mamba_block_init(gen, cfg, dtype, device, lead: tuple = ()) -> dict:
    return {"ln": L.rmsnorm_init(cfg.d_model, dtype, device, lead),
            "mamba": M.mamba2_init(gen, cfg, dtype, device, lead)}


def mamba_block_full(p, x, cfg):
    """Full-sequence block.  Returns ``(x, MambaCache)``."""
    h, cache = M.mamba2_full(p["mamba"], L.rmsnorm(p["ln"], x, cfg.norm_eps),
                             cfg)
    return x + h, cache


def mamba_block_decode(p, x, cache, cfg):
    """One-token block against one layer's ``MambaCache``.  Returns
    ``(x, MambaCache)``."""
    h, cache = M.mamba2_decode(p["mamba"],
                               L.rmsnorm(p["ln"], x, cfg.norm_eps), cache,
                               cfg)
    return x + h, cache


# ------------------------------------------------- enc-dec blocks (whisper)
def encoder_block_init(gen, cfg, dtype, device, lead: tuple = ()) -> dict:
    return {"ln1": L.rmsnorm_init(cfg.d_model, dtype, device, lead),
            "attn": A.gqa_init(gen, cfg, dtype, device, lead),
            "ln2": L.rmsnorm_init(cfg.d_model, dtype, device, lead),
            "mlp": L.gelu_mlp_init(gen, cfg.d_model, cfg.d_ff, dtype, device,
                                   lead)}


def encoder_block_full(p, x, cfg):
    """Non-causal self attention without RoPE (the flash op), then the
    GELU MLP.  Returns x."""
    h, _ = A.gqa_full(p["attn"], L.rmsnorm(p["ln1"], x, cfg.norm_eps), cfg,
                      causal=False, rope=False)
    x = x + h
    return x + L.gelu_mlp(p["mlp"], L.rmsnorm(p["ln2"], x, cfg.norm_eps))


def decoder_block_init(gen, cfg, dtype, device, lead: tuple = ()) -> dict:
    return {"ln1": L.rmsnorm_init(cfg.d_model, dtype, device, lead),
            "self_attn": A.gqa_init(gen, cfg, dtype, device, lead),
            "ln_x": L.rmsnorm_init(cfg.d_model, dtype, device, lead),
            "cross_attn": A.gqa_init(gen, cfg, dtype, device, lead),
            "ln2": L.rmsnorm_init(cfg.d_model, dtype, device, lead),
            "mlp": L.gelu_mlp_init(gen, cfg.d_model, cfg.d_ff, dtype, device,
                                   lead)}


def cross_kv(p, enc_out, cfg):
    """One decoder layer's cross K/V ``[B, S_enc, KV, dh]`` from the
    encoder's output."""
    B, S, _ = enc_out.shape
    KV, dh = cfg.n_kv_heads, cfg.head_dim
    return A.KVCache(
        k=A.split_heads(L.linear(p["cross_attn"]["wk"], enc_out), KV, dh),
        v=A.split_heads(L.linear(p["cross_attn"]["wv"], enc_out), KV, dh))


def _decoder_tail(p, x, enc_kv, cfg):
    x = x + A.gqa_cross(p["cross_attn"],
                        L.rmsnorm(p["ln_x"], x, cfg.norm_eps), enc_kv, cfg)
    return x + L.gelu_mlp(p["mlp"], L.rmsnorm(p["ln2"], x, cfg.norm_eps))


def decoder_block_full(p, x, enc_kv, cfg):
    """Causal self attention without RoPE (the flash op), cross attention
    over ``enc_kv``, the GELU MLP.  Returns ``(x, KVCache)`` of the self
    attention."""
    h, self_kv = A.gqa_full(p["self_attn"],
                            L.rmsnorm(p["ln1"], x, cfg.norm_eps), cfg,
                            causal=True, rope=False)
    return _decoder_tail(p, x + h, enc_kv, cfg), self_kv


def decoder_block_decode(p, x, self_cache, enc_kv, pos: int, cfg):
    """One token against one layer's self cache ``[B, S, KV, dh]``
    (written in place) and its cross K/V.  Returns ``(x, self_cache)``."""
    h, self_cache = A.gqa_decode(
        p["self_attn"], L.rmsnorm(p["ln1"], x, cfg.norm_eps), self_cache,
        pos, cfg, rope=False)
    return _decoder_tail(p, x + h, enc_kv, cfg), self_cache
