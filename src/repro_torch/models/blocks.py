"""Pre-norm residual blocks: dense (GQA) and mamba.

The port of ``repro/models/blocks.py``'s ``dense_block_init``,
``dense_block_full`` (train, prefill), ``dense_block_decode_flat`` and
``mamba_block_init``/``mamba_block_full``/``mamba_block_decode``; the
other block families (MoE, enc-dec) wait for the rest of the model
families (ROADMAP queue 1).
"""
from __future__ import annotations

from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M


def dense_block_init(gen, cfg, dtype, device, lead: tuple = ()) -> dict:
    return {"ln1": L.rmsnorm_init(cfg.d_model, dtype, device, lead),
            "attn": A.gqa_init(gen, cfg, dtype, device, lead),
            "ln2": L.rmsnorm_init(cfg.d_model, dtype, device, lead),
            "mlp": L.swiglu_init(gen, cfg.d_model, cfg.d_ff, dtype, device,
                                 lead)}


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
