"""GQA attention (plain tensor functions).

The port of ``repro/models/attention.py``'s ``gqa_init``, ``gqa_qkv``,
``causal_mask``, ``_sdpa``, ``gqa_full``, ``gqa_decode``,
``gqa_decode_flat`` and ``KVCache``.  The full-sequence path (train,
prefill) runs every sequence length through
the flash attention op (``kernels/flash_attention``: the hand-written
kernels and their gradient on the card, the plain version on the CPU),
GQA native, where the JAX package takes its naive ``_sdpa`` below
4,096 tokens and ``xla_flash.flash_sdpa`` from there on; all three
compute the same function.  Decode takes either of the JAX package's
cache layouts: one layer's ``[B, S, KV, dh]`` (``gqa_decode``, the
hybrid family's shared block) or the stacked KV-major ``[L, B, KV, S,
dh]`` (``gqa_decode_flat``), each written in place at the token's slot;
scores and softmax run in f32 and the probabilities are cast to V's
dtype before the second product.  MLA and cross attention wait for the
rest of the model families.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models import layers as L
from repro_torch.utils.pytree import tensor_dataclass

NEG_INF = -1e30


@tensor_dataclass
class KVCache:
    """Stacked decode cache, ``k``/``v`` ``[L, B, KV, S, dh]``; from
    ``gqa_full``, one layer's ``[B, S, KV, dh]``."""
    k: torch.Tensor
    v: torch.Tensor


def causal_mask(sq: int, sk: int, q_offset, window: int = 0, device=None):
    """``[1, 1, sq, sk]`` bool; query i attends to key j <= i + q_offset
    (and j > i + q_offset - window)."""
    qi = torch.arange(sq, device=device)[:, None] + q_offset
    kj = torch.arange(sk, device=device)[None, :]
    m = kj <= qi
    if window:
        m &= kj > qi - window
    return m[None, None]


def _sdpa(q, k, v, mask, scale: float):
    """q ``[B, Sq, H, dh]``, k/v ``[B, Sk, KV, dh]``, mask ``[B, 1, Sq,
    Sk]`` bool (True keeps): scores in f32, probabilities cast to V's
    dtype."""
    B, Sq, H, dh = q.shape
    KV = k.shape[2]
    qg = q.reshape(B, Sq, KV, H // KV, dh)
    s = torch.einsum("bqkrd,bskd->bkrqs", qg, k).float() * scale
    s = torch.where(mask[:, :, None], s, NEG_INF)
    probs = torch.softmax(s, dim=-1).to(v.dtype)
    out = torch.einsum("bkrqs,bskd->bqkrd", probs, v)
    return out.reshape(B, Sq, H, dh)


def gqa_init(gen, cfg, dtype, device, lead: tuple = ()) -> dict:
    D, H, KV, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    kw = dict(dtype=dtype, device=device, lead=lead)
    p = {"wq": L.linear_init(gen, D, H * dh, **kw),
         "wk": L.linear_init(gen, D, KV * dh, **kw),
         "wv": L.linear_init(gen, D, KV * dh, **kw),
         "wo": L.linear_init(gen, H * dh, D, scale=0.5, **kw)}
    if cfg.qk_norm:
        p["q_norm"] = L.rmsnorm_init(dh, dtype, device, lead)
        p["k_norm"] = L.rmsnorm_init(dh, dtype, device, lead)
    return p


def gqa_qkv(p, x, positions, cfg, *, rope: bool = True):
    B, S, _ = x.shape
    H, KV, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = L.linear(p["wq"], x).reshape(B, S, H, dh)
    k = L.linear(p["wk"], x).reshape(B, S, KV, dh)
    v = L.linear(p["wv"], x).reshape(B, S, KV, dh)
    if cfg.qk_norm:
        q = L.rmsnorm(p["q_norm"], q, cfg.norm_eps)
        k = L.rmsnorm(p["k_norm"], k, cfg.norm_eps)
    if rope:
        q = L.apply_rope(q, positions, cfg.rope_theta, cfg.rope_pct)
        k = L.apply_rope(k, positions, cfg.rope_theta, cfg.rope_pct)
    return q, k, v


def gqa_full(p, x, cfg, *, causal: bool = True, rope: bool = True,
             window: int = 0):
    """Train/prefill: full-sequence attention.  Returns ``(out, KVCache)``
    with the cache's k/v ``[B, S, KV, dh]``.  As in the JAX package's
    naive branch, the window applies to causal attention only."""
    B, S, _ = x.shape
    positions = torch.arange(S, dtype=torch.int32,
                             device=x.device)[None].expand(B, S)
    q, k, v = gqa_qkv(p, x, positions, cfg, rope=rope)
    out = flash_ops.flash_attention(q, k, v, causal=causal,
                                    window=window if causal else 0)
    out = L.linear(p["wo"], out.reshape(B, S, -1))
    return out, KVCache(k=k, v=v)


def gqa_decode(p, x, cache: KVCache, pos: int, cfg, *, rope: bool = True,
               window: int = 0):
    """One-token decode against one layer's cache ``[B, S_max, KV, dh]``,
    written in place at the token's slot.  With ``window`` set and
    ``S_max <= window`` the cache is a ring buffer over the last
    ``S_max`` positions (RoPE is baked into K at write time, so slot
    order does not matter).  x ``[B, 1, D]``, ``pos`` a host int.
    Returns ``(out [B, 1, D], cache)``."""
    B = x.shape[0]
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q, k_new, v_new = gqa_qkv(p, x, positions, cfg, rope=rope)
    S_max = cache.k.shape[1]
    ring = bool(window) and S_max <= window
    slot = pos % S_max if ring else pos
    cache.k[:, slot] = k_new[:, 0]
    cache.v[:, slot] = v_new[:, 0]
    kj = torch.arange(S_max, device=x.device)
    mask = kj <= pos
    if window and not ring:
        mask &= kj > pos - window
    out = _sdpa(q, cache.k, cache.v, mask.expand(B, 1, 1, S_max),
                cfg.head_dim ** -0.5)
    return L.linear(p["wo"], out.reshape(B, 1, -1)), cache


def gqa_decode_flat(p, x, k_st, v_st, idx: int, pos: int, cfg, *,
                    window: int = 0):
    """One-token decode writing into the stacked cache in place.

    x ``[B, 1, D]``; ``k_st``/``v_st`` ``[L, B, KV, S, dh]``; ``idx`` the
    layer, ``pos`` the token position (host ints).  Returns
    ``(out, k_st, v_st)`` with the caches the same tensors."""
    B = x.shape[0]
    H, KV, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q, k_new, v_new = gqa_qkv(p, x, positions, cfg)     # [B, 1, H|KV, dh]
    S_max = k_st.shape[3]
    ring = bool(window) and S_max <= window
    slot = pos % S_max if ring else pos
    k_st[idx, :, :, slot] = k_new[:, 0]
    v_st[idx, :, :, slot] = v_new[:, 0]
    k_l, v_l = k_st[idx], v_st[idx]                     # [B, KV, S, dh]

    rep = H // KV
    qg = q.reshape(B, KV, rep, dh)
    s = torch.einsum("bkrd,bksd->bkrs", qg, k_l).float() * dh ** -0.5
    kj = torch.arange(S_max, device=x.device)
    mask = kj <= pos
    if window and not ring:
        mask &= kj > pos - window
    s = torch.where(mask, s, NEG_INF)
    probs = torch.softmax(s, dim=-1).to(v_l.dtype)
    out = torch.einsum("bkrs,bksd->bkrd", probs, v_l)
    out = L.linear(p["wo"], out.reshape(B, 1, H * dh))
    return out, k_st, v_st
