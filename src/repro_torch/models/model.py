"""Model assembly: the dense and ssm families of ``repro/models/model.py``.

API (the JAX package's, dense and ssm families):
  init_params(cfg, gen=None, device=None)        -> params dict
  forward(params, batch, cfg, remat=False)       -> (logits, aux_loss)
  loss_fn(params, batch, cfg, remat=False)       -> scalar loss
  prefill(params, batch, cfg)                    -> logits
  init_cache(cfg, bsz, s_max, device=None)       -> KVCache | MambaCache
  decode_step(params, token, cache, pos, cfg)    -> (logits, cache)
  count_params(cfg)                              -> int
``batch``: {"tokens": [B, S], "labels": [B, S]} int tensors.

Params keep the JAX package's tree: ``embed``/``unembed``/``final_norm``
and ``layers``, whose leaves carry a leading ``[L]`` layer axis.  The JAX
package scans over that axis.  Here decode indexes it layer by layer (a
view, no copy) and writes each layer's new cache entries (a token's K/V,
or a mamba layer's conv window and state) into the stacked cache in
place; the full-sequence forward takes every layer at once with
``torch.unbind``, whose backward is one ``stack`` per leaf rather than a
zero ``[L, ...]`` gradient per layer.  ``remat=True`` wraps each layer in
``torch.utils.checkpoint`` (non-reentrant), the counterpart of
``jax.checkpoint``.  A family table like the JAX package's ``_FAMILY``
dispatches; the other families (moe, hybrid, encdec, vlm) raise
``NotImplementedError`` until the rest of the model families (ROADMAP
queue 1) ports them.
"""
from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention as A
from repro_torch.models import blocks as B
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M
from repro_torch.utils.device import resolve_device


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


def _stack_forward(p, batch, cfg, block, remat: bool):
    x = L.embed(p["embed"], batch["tokens"])
    for p_l in _unstack(p["layers"], cfg.n_layers):
        x = checkpoint(block, x, p_l, cfg, use_reentrant=False) \
            if remat else block(x, p_l, cfg)
    return _logits(p, x, cfg), torch.zeros((), dtype=torch.float32,
                                           device=x.device)


def _dense_forward(p, batch, cfg, remat: bool = False):
    return _stack_forward(p, batch, cfg, _dense_block, remat)


def _flat_kv_zeros(cfg, bsz: int, s_max: int, layers: int, dtype, device):
    """Stacked decode cache, KV-major ``[L, B, KV, S, dh]``."""
    w = min(cfg.sliding_window, s_max) if cfg.sliding_window else s_max
    shape = (layers, bsz, cfg.n_kv_heads, w, cfg.head_dim)
    return A.KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                     v=torch.zeros(shape, dtype=dtype, device=device))


def _dense_cache(cfg, bsz: int, s_max: int, dtype, device):
    return _flat_kv_zeros(cfg, bsz, s_max, cfg.n_layers, dtype, device)


def _dense_decode(p, token, cache, pos: int, cfg):
    x = L.embed(p["embed"], token)
    for i in range(cfg.n_layers):
        x, _, _ = B.dense_block_decode_flat(
            _layer(p["layers"], i), x, cache.k, cache.v, i, pos, cfg,
            window=cfg.sliding_window)
    return _logits(p, x, cfg), cache


# ==================================================================== SSM
def _ssm_init(gen, cfg, dtype, device):
    return {"embed": L.embedding_init(gen, cfg.vocab_size, cfg.d_model,
                                      dtype, device),
            "layers": B.mamba_block_init(gen, cfg, dtype, device,
                                         lead=(cfg.n_layers,)),
            "final_norm": L.rmsnorm_init(cfg.d_model, dtype, device),
            "unembed": L.embedding_init(gen, cfg.vocab_size, cfg.d_model,
                                        dtype, device)}


def _mamba_block(h, p_l, cfg):
    return B.mamba_block_full(p_l, h, cfg)[0]


def _ssm_forward(p, batch, cfg, remat: bool = False):
    return _stack_forward(p, batch, cfg, _mamba_block, remat)


def _ssm_cache(cfg, bsz: int, s_max: int, dtype, device):
    del s_max  # recurrent state: O(1) in sequence length
    L_, conv_dim = cfg.n_layers, cfg.d_inner + 2 * cfg.ssm_state
    return M.MambaCache(
        conv=torch.zeros((L_, bsz, cfg.conv_kernel - 1, conv_dim),
                         dtype=dtype, device=device),
        ssm=torch.zeros((L_, bsz, cfg.ssm_heads, cfg.ssm_head_dim,
                         cfg.ssm_state), dtype=dtype, device=device))


def _ssm_decode(p, token, cache, pos: int, cfg):
    del pos
    x = L.embed(p["embed"], token)
    for i in range(cfg.n_layers):
        x, new = B.mamba_block_decode(
            _layer(p["layers"], i), x,
            M.MambaCache(conv=cache.conv[i], ssm=cache.ssm[i]), cfg)
        cache.conv[i].copy_(new.conv)
        cache.ssm[i].copy_(new.ssm)
    return _logits(p, x, cfg), cache


# ================================================================ dispatch
_FAMILY = {
    "dense": (_dense_init, _dense_forward, _dense_cache, _dense_decode),
    "ssm": (_ssm_init, _ssm_forward, _ssm_cache, _ssm_decode),
}


def _family_fns(cfg):
    fns = _FAMILY.get(cfg.family)
    if fns is None:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family is not ported yet "
            f"(the rest of the model families, ROADMAP queue 1); the port "
            f"runs the dense and ssm families")
    return fns


def init_params(cfg, gen: torch.Generator | None = None, device=None):
    """Random weights, drawn from ``gen`` (on its own device) and placed
    on ``device`` (``None``: the CUDA card).  ``gen`` defaults to a
    generator on ``device`` seeded 0."""
    init = _family_fns(cfg)[0]
    device = resolve_device(device)
    if gen is None:
        gen = torch.Generator(device=device).manual_seed(0)
    return init(gen, cfg, L.dtype_of(cfg), device)


def forward(params, batch, cfg, remat: bool = False):
    """Full-sequence forward -> (logits ``[B, S, V]`` in the params'
    dtype, aux loss f32 0)."""
    return _family_fns(cfg)[1](params, batch, cfg, remat)


def loss_fn(params, batch, cfg, remat: bool = False):
    logits, aux = forward(params, batch, cfg, remat)
    return L.cross_entropy(logits, batch["labels"], cfg.vocab_size) + aux


def prefill(params, batch, cfg):
    """Full-sequence forward returning logits (the serving layer's paged
    KV wiring lives in ``tiering/``)."""
    return forward(params, batch, cfg)[0]


def init_cache(cfg, bsz: int, s_max: int, device=None):
    """The stacked decode cache, zeros: ``KVCache`` ``[L, B, KV, S, dh]``
    (dense) or ``MambaCache`` (ssm: ``[L, B, K-1, conv_dim]`` and
    ``[L, B, H, P, N]``, independent of ``s_max``)."""
    return _family_fns(cfg)[2](cfg, bsz, s_max, L.dtype_of(cfg),
                               resolve_device(device))


def decode_step(params, token, cache, pos: int, cfg):
    """token: ``[B, 1]`` int; pos: host int.  -> (logits ``[B, 1, V]``,
    cache), the cache updated in place."""
    return _family_fns(cfg)[3](params, token, cache, pos, cfg)


@functools.lru_cache(maxsize=64)
def count_params(cfg) -> int:
    """Exact parameter count from the shapes (``meta`` tensors, nothing
    allocated or drawn)."""
    tree = _family_fns(cfg)[0](torch.Generator(), cfg, L.dtype_of(cfg),
                               "meta")

    def total(t):
        return sum(map(total, t.values())) if isinstance(t, dict) \
            else t.numel()

    return int(total(tree))
