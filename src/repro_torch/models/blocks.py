"""Pre-norm residual blocks: dense (GQA), MoE (GQA) and mamba.

The port of ``repro/models/blocks.py``'s ``dense_block_init``,
``dense_block_full`` (train, prefill), ``dense_block_decode`` (one
layer's cache), ``dense_block_decode_flat`` (the stacked cache),
``moe_block_init``/``moe_block_full``/``moe_block_decode_flat`` with GQA
attention, and ``mamba_block_init``/``mamba_block_full``/
``mamba_block_decode``; MLA and the enc-dec blocks wait for the rest of
the model families.
"""
from __future__ import annotations

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
    return {"ln1": L.rmsnorm_init(cfg.d_model, dtype, device, lead),
            "attn": A.gqa_init(gen, cfg, dtype, device, lead),
            "ln2": L.rmsnorm_init(cfg.d_model, dtype, device, lead),
            "moe": MoE.moe_init(gen, cfg, dtype, device, lead)}


def moe_block_full(p, x, cfg, *, window: int = 0):
    """Full-sequence block.  Returns ``(x, KVCache, aux, expert_load)``."""
    h, kv = A.gqa_full(p["attn"], L.rmsnorm(p["ln1"], x, cfg.norm_eps), cfg,
                       window=window)
    x = x + h
    y, aux, load = MoE.moe_apply(p["moe"],
                                 L.rmsnorm(p["ln2"], x, cfg.norm_eps), cfg)
    return x + y, kv, aux, load


def moe_block_decode_flat(p, x, caches, idx: int, pos: int, cfg, *,
                          window: int = 0):
    """Decode against the stacked ``[L, B, KV, S, dh]`` caches ``(k_st,
    v_st)`` (in-place writes).  Returns ``(x, caches, expert_load)``."""
    k_st, v_st = caches
    h, k_st, v_st = A.gqa_decode_flat(
        p["attn"], L.rmsnorm(p["ln1"], x, cfg.norm_eps), k_st, v_st, idx,
        pos, cfg, window=window)
    x = x + h
    y, _, load = MoE.moe_apply(p["moe"],
                               L.rmsnorm(p["ln2"], x, cfg.norm_eps), cfg)
    return x + y, (k_st, v_st), load


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
