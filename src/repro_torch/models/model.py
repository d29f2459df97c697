"""Model assembly: every family of ``repro/models/model.py`` (dense, vlm,
ssm, hybrid, MoE with GQA or MLA, enc-dec).

API (the JAX package's):
  init_params(cfg, gen=None, device=None)        -> params dict
  forward(params, batch, cfg, remat=False, constrain=None)
                                                 -> (logits, aux_loss)
  loss_fn(params, batch, cfg, remat=False, constrain=None) -> scalar loss
  prefill(params, batch, cfg)                    -> logits
  init_cache(cfg, bsz, s_max, device=None)       -> the family's cache
  decode_step(params, token, cache, pos, cfg)    -> (logits, cache)
  count_params(cfg)                              -> int
  active_params(cfg)                             -> int
``batch``: {"tokens": [B, S], "labels": [B, S]} int tensors, plus a vlm's
``patch_embeds`` ``[B, n_patches, d_model]``, put before the tokens (its
labels are padded with -1 over the patches), or an enc-dec model's
``audio_embeds`` ``[B, enc_seq, d_model]`` (the encoder runs in their
dtype).

Params keep the JAX package's tree: ``embed``/``unembed``/``final_norm``
and the stacked layer trees, whose leaves carry leading layer axes:
``[L]`` for ``layers``, ``[n_super]`` for an MoE model's
``dense_layers``/``moe_layers``, ``[n_groups, group]`` for a hybrid's
``mamba_groups`` (and ``[tail]`` for its ``mamba_tail``), beside its one
``shared_attn`` block; an MLA model's ``layer0`` (unstacked) and
``[L - first_dense]`` ``moe_layers``; an enc-dec model's ``enc_layers``
``[n_enc_layers]`` and ``dec_layers`` ``[L]`` (its unembedding is the
embedding table).  The JAX package scans over those axes.  Here
decode indexes them layer by layer (a view, no copy) and writes each
layer's new cache entries (a token's K/V, or a mamba layer's conv window
and state) into the stacked cache in place; the full-sequence forward
takes every layer at once with ``torch.unbind`` (nested for the
hybrid's groups), whose backward is one ``stack`` per leaf rather than a
zero gradient of the whole stack per layer.  ``remat=True`` wraps each
layer (a hybrid's whole group with its shared block, an MoE model's
dense + MoE super-layer, an MLA model's MoE layers but not its layer 0,
an enc-dec model's decoder layers with their cross K/V but not the
encoder) in ``torch.utils.checkpoint`` (non-reentrant), the counterpart
of ``jax.checkpoint`` where the JAX package applies it.  A family table
like the JAX package's ``_FAMILY`` dispatches.
"""
from __future__ import annotations

import functools

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard
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
    """The stacked ``layers`` tree as ``n`` per-layer trees (views).  A
    DTensor leaf whose stack dim is sharded (a norm's ``[L, d]`` scale
    where the data axis divides L) is gathered over it first."""
    if isinstance(tree, dict):
        subs = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: sub[i] for k, sub in subs.items()} for i in range(n)]
    if isinstance(tree, DTensor) and Shard(0) in tree.placements:
        tree = tree.redistribute(tree.device_mesh, [
            Replicate() if p == Shard(0) else p for p in tree.placements])
    return list(torch.unbind(tree, 0))


def _dense_block(h, p_l, cfg):
    return B.dense_block_full(p_l, h, cfg, window=cfg.sliding_window)[0]


def _embed_inputs(p, batch, cfg):
    """Token embeddings; a vlm's ``patch_embeds``, cast to their dtype,
    go before them."""
    x = L.embed(p["embed"], batch["tokens"])
    if cfg.family == "vlm":
        x = torch.cat([batch["patch_embeds"].to(x.dtype), x], dim=1)
    return x


def _run(block, x, p_l, cfg, remat: bool):
    return checkpoint(block, x, p_l, cfg, use_reentrant=False) if remat \
        else block(x, p_l, cfg)


def _zero_aux(x):
    return torch.zeros((), dtype=torch.float32, device=x.device)


def _keep(x):
    return x


def _stack_forward(p, batch, cfg, block, remat: bool, constrain):
    c = constrain or _keep
    x = c(_embed_inputs(p, batch, cfg))
    for p_l in _unstack(p["layers"], cfg.n_layers):
        x = c(_run(block, x, p_l, cfg, remat))
    return _logits(p, x, cfg), _zero_aux(x)


def _dense_forward(p, batch, cfg, remat: bool = False, constrain=None):
    return _stack_forward(p, batch, cfg, _dense_block, remat, constrain)


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


# ==================================================================== MoE
# llama4-style: alternating dense / MoE super-layers.
def _moe_alt_init(gen, cfg, dtype, device):
    lead = (cfg.n_layers // 2,)
    return {"embed": L.embedding_init(gen, cfg.vocab_size, cfg.d_model,
                                      dtype, device),
            "dense_layers": B.dense_block_init(
                gen, cfg, dtype, device, lead,
                d_ff=cfg.dense_d_ff or cfg.d_ff),
            "moe_layers": B.moe_block_init(gen, cfg, dtype, device, lead),
            "final_norm": L.rmsnorm_init(cfg.d_model, dtype, device),
            "unembed": L.embedding_init(gen, cfg.vocab_size, cfg.d_model,
                                        dtype, device)}


def _moe_super(h, ps, cfg):
    """One dense + MoE super-layer -> ``(h, aux)``."""
    pd, pm = ps
    h = B.dense_block_full(pd, h, cfg, window=cfg.sliding_window)[0]
    h, _, aux, _ = B.moe_block_full(pm, h, cfg, window=cfg.sliding_window)
    return h, aux


def _moe_alt_forward(p, batch, cfg, remat: bool = False, constrain=None):
    c = constrain or _keep
    x = c(_embed_inputs(p, batch, cfg))
    aux = _zero_aux(x)
    n_super = cfg.n_layers // 2
    for ps in zip(_unstack(p["dense_layers"], n_super),
                  _unstack(p["moe_layers"], n_super)):
        x, aux_l = _run(_moe_super, x, ps, cfg, remat)
        x, aux = c(x), aux + aux_l
    return _logits(p, x, cfg), aux


def _moe_alt_cache(cfg, bsz: int, s_max: int, dtype, device):
    n_super = cfg.n_layers // 2
    return {nm: _flat_kv_zeros(cfg, bsz, s_max, n_super, dtype, device)
            for nm in ("dense", "moe")}


def _moe_alt_decode(p, token, cache, pos: int, cfg):
    x = L.embed(p["embed"], token)
    w, d, m = cfg.sliding_window, cache["dense"], cache["moe"]
    for i in range(cfg.n_layers // 2):
        x, _, _ = B.dense_block_decode_flat(
            _layer(p["dense_layers"], i), x, d.k, d.v, i, pos, cfg,
            window=w)
        x, _, _ = B.moe_block_decode_flat(
            _layer(p["moe_layers"], i), x, (m.k, m.v), i, pos, cfg,
            window=w)
    return _logits(p, x, cfg), cache


# deepseek-style: the first layer dense (MLA), the rest MoE (MLA).
def _moe_mla_init(gen, cfg, dtype, device):
    return {"embed": L.embedding_init(gen, cfg.vocab_size, cfg.d_model,
                                      dtype, device),
            "layer0": B.mla_dense_block_init(gen, cfg, dtype, device),
            "moe_layers": B.moe_block_init(
                gen, cfg, dtype, device,
                lead=(cfg.n_layers - cfg.first_dense,)),
            "final_norm": L.rmsnorm_init(cfg.d_model, dtype, device),
            "unembed": L.embedding_init(gen, cfg.vocab_size, cfg.d_model,
                                        dtype, device)}


def _moe_mla_layer(h, p_l, cfg):
    """One MoE (MLA) layer -> ``(h, aux)``."""
    h, _, aux, _ = B.moe_block_full(p_l, h, cfg)
    return h, aux


def _moe_mla_forward(p, batch, cfg, remat: bool = False, constrain=None):
    c = constrain or _keep
    x = c(L.embed(p["embed"], batch["tokens"]))
    x, _ = B.mla_dense_block_full(p["layer0"], x, cfg)   # not under remat
    x = c(x)
    aux = _zero_aux(x)
    n_moe = cfg.n_layers - cfg.first_dense
    for p_l in _unstack(p["moe_layers"], n_moe):
        x, aux_l = _run(_moe_mla_layer, x, p_l, cfg, remat)
        x, aux = c(x), aux + aux_l
    return _logits(p, x, cfg), aux


def _mla_zeros(cfg, bsz: int, s: int, lead: tuple, dtype, device):
    """Zero ``MLACache``: ``lead + [B, S, kv_lora]`` and ``lead + [B, S,
    rope_d]``."""
    return A.MLACache(
        c_kv=torch.zeros(lead + (bsz, s, cfg.kv_lora_rank), dtype=dtype,
                         device=device),
        k_rope=torch.zeros(lead + (bsz, s, cfg.rope_head_dim), dtype=dtype,
                           device=device))


def _moe_mla_cache(cfg, bsz: int, s_max: int, dtype, device):
    return {"layer0": _mla_zeros(cfg, bsz, s_max, (), dtype, device),
            "moe": _mla_zeros(cfg, bsz, s_max,
                              (cfg.n_layers - cfg.first_dense,), dtype,
                              device)}


def _moe_mla_decode(p, token, cache, pos: int, cfg):
    x = L.embed(p["embed"], token)
    x, _ = B.mla_dense_block_decode(p["layer0"], x, cache["layer0"], pos,
                                    cfg)
    m = cache["moe"]
    for i in range(cfg.n_layers - cfg.first_dense):
        x, _, _ = B.moe_block_decode_flat(_layer(p["moe_layers"], i), x,
                                          (m.c_kv, m.k_rope), i, pos, cfg)
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


def _ssm_forward(p, batch, cfg, remat: bool = False, constrain=None):
    return _stack_forward(p, batch, cfg, _mamba_block, remat, constrain)


def _mamba_zeros(cfg, bsz: int, lead: tuple, dtype, device):
    """Zero ``MambaCache`` with leaves ``lead + [B, K-1, conv_dim]`` and
    ``lead + [B, H, P, N]``."""
    conv_dim = cfg.d_inner + 2 * cfg.ssm_state
    return M.MambaCache(
        conv=torch.zeros(lead + (bsz, cfg.conv_kernel - 1, conv_dim),
                         dtype=dtype, device=device),
        ssm=torch.zeros(lead + (bsz, cfg.ssm_heads, cfg.ssm_head_dim,
                                cfg.ssm_state), dtype=dtype, device=device))


def _ssm_cache(cfg, bsz: int, s_max: int, dtype, device):
    del s_max  # recurrent state: O(1) in sequence length
    return _mamba_zeros(cfg, bsz, (cfg.n_layers,), dtype, device)


def _mamba_decode(p_stack, x, cache, n: int, cfg):
    """``n`` stacked mamba layers against their stacked ``MambaCache``
    (updated in place)."""
    for i in range(n):
        x, new = B.mamba_block_decode(
            _layer(p_stack, i), x,
            M.MambaCache(conv=cache.conv[i], ssm=cache.ssm[i]), cfg)
        A.write_at(cache.conv, (i,), new.conv)
        A.write_at(cache.ssm, (i,), new.ssm)
    return x


def _ssm_decode(p, token, cache, pos: int, cfg):
    del pos
    x = _mamba_decode(p["layers"], L.embed(p["embed"], token), cache,
                      cfg.n_layers, cfg)
    return _logits(p, x, cfg), cache


# ================================================================= hybrid
# zamba2-style: groups of mamba layers with ONE shared attention block
# (weights reused at every application) after each group, then a tail.
def _hybrid_dims(cfg):
    group = cfg.attn_every
    n_groups = cfg.n_layers // group
    return group, n_groups, cfg.n_layers - n_groups * group


def _hybrid_init(gen, cfg, dtype, device):
    group, n_groups, tail = _hybrid_dims(cfg)
    p = {"embed": L.embedding_init(gen, cfg.vocab_size, cfg.d_model, dtype,
                                   device),
         "mamba_groups": B.mamba_block_init(gen, cfg, dtype, device,
                                            lead=(n_groups, group)),
         "shared_attn": B.dense_block_init(gen, cfg, dtype, device),
         "final_norm": L.rmsnorm_init(cfg.d_model, dtype, device),
         "unembed": L.embedding_init(gen, cfg.vocab_size, cfg.d_model,
                                     dtype, device)}
    if tail:
        p["mamba_tail"] = B.mamba_block_init(gen, cfg, dtype, device,
                                             lead=(tail,))
    return p


def _hybrid_group(h, pg, cfg):
    """One group: its mamba layers, then the shared block (no window)."""
    p_g, shared = pg
    for p_l in _unstack(p_g, cfg.attn_every):
        h = _mamba_block(h, p_l, cfg)
    return B.dense_block_full(shared, h, cfg)[0]


def _hybrid_forward(p, batch, cfg, remat: bool = False, constrain=None):
    c = constrain or _keep
    x = c(_embed_inputs(p, batch, cfg))
    group, n_groups, tail = _hybrid_dims(cfg)
    for p_g in _unstack(p["mamba_groups"], n_groups):
        x = c(_run(_hybrid_group, x, (p_g, p["shared_attn"]), cfg, remat))
    if tail:    # not under remat, as in the JAX package
        for p_l in _unstack(p["mamba_tail"], tail):
            x = _mamba_block(x, p_l, cfg)
    return _logits(p, x, cfg), _zero_aux(x)


def _hybrid_cache(cfg, bsz: int, s_max: int, dtype, device):
    """``mamba_groups``: ``MambaCache`` with leaves ``[n_groups, group, B,
    ...]``; ``attn``: ``KVCache`` ``[n_groups, B, S, KV, dh]``;
    ``mamba_tail``: ``[tail, B, ...]``."""
    group, n_groups, tail = _hybrid_dims(cfg)
    c = {"mamba_groups": _mamba_zeros(cfg, bsz, (n_groups, group), dtype,
                                      device),
         "attn": A.KVCache(*(torch.zeros(
             (n_groups, bsz, s_max, cfg.n_kv_heads, cfg.head_dim),
             dtype=dtype, device=device) for _ in range(2)))}
    if tail:
        c["mamba_tail"] = _mamba_zeros(cfg, bsz, (tail,), dtype, device)
    return c


def _hybrid_decode(p, token, cache, pos: int, cfg):
    x = L.embed(p["embed"], token)
    group, n_groups, tail = _hybrid_dims(cfg)
    mg, kv = cache["mamba_groups"], cache["attn"]
    for g in range(n_groups):
        x = _mamba_decode(_layer(p["mamba_groups"], g), x,
                          M.MambaCache(conv=mg.conv[g], ssm=mg.ssm[g]),
                          group, cfg)
        x, _ = B.dense_block_decode(p["shared_attn"], x,
                                    A.KVCache(k=kv.k[g], v=kv.v[g]), pos,
                                    cfg)
    if tail:
        x = _mamba_decode(p["mamba_tail"], x, cache["mamba_tail"], tail,
                          cfg)
    return _logits(p, x, cfg), cache


# ================================================================= enc-dec
# whisper-style: an encoder over stubbed frame embeddings, a decoder with
# cross attention to it; sinusoidal positions on both sides, no RoPE.
def _encdec_init(gen, cfg, dtype, device):
    return {"embed": L.embedding_init(gen, cfg.vocab_size, cfg.d_model,
                                      dtype, device),
            "enc_layers": B.encoder_block_init(gen, cfg, dtype, device,
                                               lead=(cfg.n_enc_layers,)),
            "enc_norm": L.rmsnorm_init(cfg.d_model, dtype, device),
            "dec_layers": B.decoder_block_init(gen, cfg, dtype, device,
                                               lead=(cfg.n_layers,)),
            "final_norm": L.rmsnorm_init(cfg.d_model, dtype, device)}


def _encode(p, audio_embeds, cfg):
    """The encoder over ``audio_embeds`` ``[B, S_enc, D]``, in their dtype
    (not under remat, as in the JAX package)."""
    x = audio_embeds + L.sinusoidal_positions(
        audio_embeds.shape[1], cfg.d_model,
        audio_embeds.device).to(audio_embeds.dtype)[None]
    for p_l in _unstack(p["enc_layers"], cfg.n_enc_layers):
        x = B.encoder_block_full(p_l, x, cfg)
    return L.rmsnorm(p["enc_norm"], x, cfg.norm_eps)


def _decoder_layer(h, pe, cfg):
    """One decoder layer with its cross K/V from the encoder's output."""
    p_l, enc_out = pe
    return B.decoder_block_full(p_l, h, B.cross_kv(p_l, enc_out, cfg),
                                cfg)[0]


def _encdec_forward(p, batch, cfg, remat: bool = False, constrain=None):
    c = constrain or _keep
    enc_out = c(_encode(p, batch["audio_embeds"], cfg))
    S = batch["tokens"].shape[1]
    x = L.embed(p["embed"], batch["tokens"])
    x = c(x + L.sinusoidal_positions(S, cfg.d_model, x.device).to(
        x.dtype)[None])
    for p_l in _unstack(p["dec_layers"], cfg.n_layers):
        x = c(_run(_decoder_layer, x, (p_l, enc_out), cfg, remat))
    x = L.rmsnorm(p["final_norm"], x, cfg.norm_eps)
    return L.unembed(p["embed"], x), _zero_aux(x)


def _encdec_cache(cfg, bsz: int, s_max: int, dtype, device):
    """``self``: ``KVCache`` ``[L, B, S, KV, dh]``; ``cross``: ``KVCache``
    ``[L, B, enc_seq, KV, dh]``, zeros as the JAX package makes them."""
    def kv(s):
        return A.KVCache(*(torch.zeros(
            (cfg.n_layers, bsz, s, cfg.n_kv_heads, cfg.head_dim),
            dtype=dtype, device=device) for _ in range(2)))

    return {"self": kv(s_max), "cross": kv(cfg.enc_seq)}


def _encdec_decode(p, token, cache, pos: int, cfg):
    x = L.embed(p["embed"], token)
    x = x + L.sinusoidal_at(pos, cfg.d_model, x.device).to(x.dtype)
    sf, cr = cache["self"], cache["cross"]
    for i in range(cfg.n_layers):
        x, _ = B.decoder_block_decode(
            _layer(p["dec_layers"], i), x, A.KVCache(k=sf.k[i], v=sf.v[i]),
            A.KVCache(k=cr.k[i], v=cr.v[i]), pos, cfg)
    x = L.rmsnorm(p["final_norm"], x, cfg.norm_eps)
    return L.unembed(p["embed"], x), cache


# ================================================================ dispatch
_FAMILY = {
    "dense": (_dense_init, _dense_forward, _dense_cache, _dense_decode),
    "vlm": (_dense_init, _dense_forward, _dense_cache, _dense_decode),
    "ssm": (_ssm_init, _ssm_forward, _ssm_cache, _ssm_decode),
    "hybrid": (_hybrid_init, _hybrid_forward, _hybrid_cache,
               _hybrid_decode),
    "encdec": (_encdec_init, _encdec_forward, _encdec_cache,
               _encdec_decode),
}


def _family_fns(cfg):
    if cfg.family == "moe":
        if cfg.use_mla:
            return (_moe_mla_init, _moe_mla_forward, _moe_mla_cache,
                    _moe_mla_decode)
        return (_moe_alt_init, _moe_alt_forward, _moe_alt_cache,
                _moe_alt_decode)
    return _FAMILY[cfg.family]


def init_params(cfg, gen: torch.Generator | None = None, device=None):
    """Random weights, drawn from ``gen`` (on its own device) and placed
    on ``device`` (``None``: the CUDA card).  ``gen`` defaults to a
    generator on ``device`` seeded 0."""
    init = _family_fns(cfg)[0]
    device = resolve_device(device)
    if gen is None:
        gen = torch.Generator(device=device).manual_seed(0)
    return init(gen, cfg, L.dtype_of(cfg), device)


def forward(params, batch, cfg, remat: bool = False, constrain=None):
    """Full-sequence forward -> (logits ``[B, S, V]`` in the params'
    dtype, a vlm's ``S`` counting the patches; the f32 aux loss: the MoE
    load-balancing loss summed over super-layers, else 0).  ``constrain``
    (``launch.steps.make_activation_constraint``) is applied where the
    JAX package applies it: to the embedded inputs (an MLA model's after
    layer 0 too; an enc-dec model's encoder output and decoder inputs) and
    to each layer's output (a hybrid's each group's, not its tail's), here
    after the layer's remat, where JAX constrains inside it."""
    return _family_fns(cfg)[1](params, batch, cfg, remat, constrain)


def loss_fn(params, batch, cfg, remat: bool = False, constrain=None):
    logits, aux = forward(params, batch, cfg, remat, constrain)
    labels = batch["labels"]
    if cfg.family == "vlm":    # patch positions carry no labels
        pad = labels.new_full(batch["patch_embeds"].shape[:2], -1)
        labels = torch.cat([pad, labels], dim=1)
    return L.cross_entropy(logits, labels, cfg.vocab_size) + aux


def prefill(params, batch, cfg):
    """Full-sequence forward returning logits (the serving layer's paged
    KV wiring lives in ``tiering/``)."""
    return forward(params, batch, cfg)[0]


def init_cache(cfg, bsz: int, s_max: int, device=None):
    """The stacked decode cache, zeros: ``KVCache`` ``[L, B, KV, S, dh]``
    (dense, vlm; ``S`` the window where that is shorter), ``MambaCache``
    (ssm: ``[L, B, K-1, conv_dim]`` and ``[L, B, H, P, N]``, independent
    of ``s_max``), ``{"dense", "moe"}`` of ``[n_super, B, KV, S, dh]``
    (moe with GQA), ``{"layer0", "moe"}`` of ``MLACache`` (moe with MLA:
    ``[B, S, kv_lora]``/``[B, S, rope_d]``, the MoE layers' stacked),
    ``{"self", "cross"}`` of ``KVCache`` (enc-dec, ``_encdec_cache``) or
    the hybrid's ``{"mamba_groups", "attn", "mamba_tail"}``
    (``_hybrid_cache``)."""
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


def active_params(cfg) -> int:
    """Active parameters per token (MoE: routed experts count k-of-E)."""
    total = count_params(cfg)
    if cfg.family != "moe":
        return total
    # subtract inactive routed-expert weights
    F, D, E, k = cfg.moe_d_ff, cfg.d_model, cfg.n_experts, \
        cfg.experts_per_token
    n_moe_layers = (cfg.n_layers - cfg.first_dense if cfg.use_mla
                    else cfg.n_layers // 2)
    per_expert = 3 * D * F
    return total - n_moe_layers * per_expert * (E - k)
