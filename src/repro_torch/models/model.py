"""Model assembly for decode: the dense family of ``repro/models/model.py``.

API (the JAX package's, dense family):
  init_params(cfg, gen=None, device=None)        -> params dict
  init_cache(cfg, bsz, s_max, device=None)       -> KVCache (zeros)
  decode_step(params, token, cache, pos, cfg)    -> (logits, cache)
  count_params(cfg)                              -> int

Params keep the JAX package's tree: ``embed``/``unembed``/``final_norm``
and ``layers``, whose leaves carry a leading ``[L]`` layer axis.  The JAX
package scans over that axis; here a Python loop indexes it (a view, no
copy) and every layer writes its token into the stacked cache in place.
The other families (moe, ssm, hybrid, encdec, vlm) and the full-sequence
forward, loss and prefill wait for ROADMAP queue 1 item 12.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.models import attention as A
from repro_torch.models import blocks as B
from repro_torch.models import layers as L
from repro_torch.utils.device import resolve_device


def _dense_only(cfg):
    if cfg.family != "dense":
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family is not ported yet "
            f"(ROADMAP queue 1 item 12); the port decodes dense models")


def _dense_init(gen, cfg, dtype, device):
    p = {"embed": L.embedding_init(gen, cfg.vocab_size, cfg.d_model, dtype,
                                   device),
         "layers": B.dense_block_init(gen, cfg, dtype, device,
                                      lead=(cfg.n_layers,)),
         "final_norm": L.rmsnorm_init(cfg.d_model, dtype, device)}
    if not cfg.tie_embeddings:
        p["unembed"] = L.embedding_init(gen, cfg.vocab_size, cfg.d_model,
                                        dtype, device)
    return p


def _logits(p, x, cfg):
    x = L.rmsnorm(p["final_norm"], x, cfg.norm_eps)
    return L.unembed(p.get("unembed", p["embed"]), x)


def _layer(tree, i: int):
    """Layer ``i`` of the stacked ``layers`` tree (views)."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def _flat_kv_zeros(cfg, bsz: int, s_max: int, layers: int, dtype, device):
    """Stacked decode cache, KV-major ``[L, B, KV, S, dh]``."""
    w = min(cfg.sliding_window, s_max) if cfg.sliding_window else s_max
    shape = (layers, bsz, cfg.n_kv_heads, w, cfg.head_dim)
    return A.KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                     v=torch.zeros(shape, dtype=dtype, device=device))


def _dense_decode(p, token, cache, pos: int, cfg):
    x = L.embed(p["embed"], token)
    for i in range(cfg.n_layers):
        x, _, _ = B.dense_block_decode_flat(
            _layer(p["layers"], i), x, cache.k, cache.v, i, pos, cfg,
            window=cfg.sliding_window)
    return _logits(p, x, cfg), cache


def init_params(cfg, gen: torch.Generator | None = None, device=None):
    """Random weights, drawn from ``gen`` (on its own device) and placed
    on ``device`` (``None``: the CUDA card).  ``gen`` defaults to a
    generator on ``device`` seeded 0."""
    _dense_only(cfg)
    device = resolve_device(device)
    if gen is None:
        gen = torch.Generator(device=device).manual_seed(0)
    return _dense_init(gen, cfg, L.dtype_of(cfg), device)


def init_cache(cfg, bsz: int, s_max: int, device=None):
    _dense_only(cfg)
    return _flat_kv_zeros(cfg, bsz, s_max, cfg.n_layers, L.dtype_of(cfg),
                          resolve_device(device))


def decode_step(params, token, cache, pos: int, cfg):
    """token: ``[B, 1]`` int; pos: host int.  -> (logits ``[B, 1, V]``,
    cache), the cache updated in place."""
    _dense_only(cfg)
    return _dense_decode(params, token, cache, pos, cfg)


@functools.lru_cache(maxsize=64)
def count_params(cfg) -> int:
    """Exact parameter count from the shapes (``meta`` tensors, nothing
    allocated or drawn)."""
    _dense_only(cfg)
    tree = _dense_init(torch.Generator(), cfg, L.dtype_of(cfg), "meta")

    def total(t):
        return sum(map(total, t.values())) if isinstance(t, dict) \
            else t.numel()

    return int(total(tree))
