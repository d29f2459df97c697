"""Model assembly: the dense family of ``repro/models/model.py``.

API (the JAX package's, dense family):
  init_params(cfg, gen=None, device=None)        -> params dict
  forward(params, batch, cfg, remat=False)       -> (logits, aux_loss)
  loss_fn(params, batch, cfg, remat=False)       -> scalar loss
  prefill(params, batch, cfg)                    -> logits
  init_cache(cfg, bsz, s_max, device=None)       -> KVCache (zeros)
  decode_step(params, token, cache, pos, cfg)    -> (logits, cache)
  count_params(cfg)                              -> int
``batch``: {"tokens": [B, S], "labels": [B, S]} int tensors.

Params keep the JAX package's tree: ``embed``/``unembed``/``final_norm``
and ``layers``, whose leaves carry a leading ``[L]`` layer axis.  The JAX
package scans over that axis.  Here decode indexes it layer by layer (a
view, no copy) and writes each token into the stacked cache in place; the
full-sequence forward takes every layer at once with ``torch.unbind``,
whose backward is one ``stack`` per leaf rather than a zero ``[L, ...]``
gradient per layer.  ``remat=True`` wraps each layer in
``torch.utils.checkpoint`` (non-reentrant), the counterpart of
``jax.checkpoint``.  The other families (moe, ssm, hybrid, encdec, vlm)
wait for ROADMAP queue 1 item 12.
"""
from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention as A
from repro_torch.models import blocks as B
from repro_torch.models import layers as L
from repro_torch.utils.device import resolve_device


def _dense_only(cfg):
    if cfg.family != "dense":
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family is not ported yet "
            f"(ROADMAP queue 1 item 12); the port runs dense models")


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


def _unstack(tree, n: int) -> list:
    """The stacked ``layers`` tree as ``n`` per-layer trees (views)."""
    if isinstance(tree, dict):
        subs = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: sub[i] for k, sub in subs.items()} for i in range(n)]
    return list(torch.unbind(tree, 0))


def _dense_block(h, p_l, cfg):
    return B.dense_block_full(p_l, h, cfg, window=cfg.sliding_window)[0]


def _dense_forward(p, batch, cfg, remat: bool = False):
    x = L.embed(p["embed"], batch["tokens"])
    for p_l in _unstack(p["layers"], cfg.n_layers):
        x = checkpoint(_dense_block, x, p_l, cfg, use_reentrant=False) \
            if remat else _dense_block(x, p_l, cfg)
    return _logits(p, x, cfg), torch.zeros((), dtype=torch.float32,
                                           device=x.device)


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


def forward(params, batch, cfg, remat: bool = False):
    """Full-sequence forward -> (logits ``[B, S, V]`` in the params'
    dtype, aux loss f32 0)."""
    _dense_only(cfg)
    return _dense_forward(params, batch, cfg, remat)


def loss_fn(params, batch, cfg, remat: bool = False):
    logits, aux = forward(params, batch, cfg, remat)
    return L.cross_entropy(logits, batch["labels"], cfg.vocab_size) + aux


def prefill(params, batch, cfg):
    """Full-sequence forward returning logits (the serving layer's paged
    KV wiring lives in ``tiering/``)."""
    return forward(params, batch, cfg)[0]


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
