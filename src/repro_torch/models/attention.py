"""GQA, cross and MLA attention (plain tensor functions).

The port of ``repro/models/attention.py``: ``gqa_init``, ``gqa_qkv``,
``causal_mask``, ``_sdpa``, ``gqa_full``, ``gqa_decode``,
``gqa_decode_flat``, ``gqa_cross`` and ``KVCache``; and DeepSeek-V2's
multi-head latent attention, ``mla_init``, ``MLACache``, ``_mla_q``,
``_mla_kv_a``, ``mla_full``, ``mla_decode`` and ``mla_decode_flat``.
The full-sequence paths (train, prefill) run every sequence length
through the flash attention op (``kernels/flash_attention``: the
hand-written kernels and their gradient on the card, the plain version
on the CPU), GQA native, where the JAX package takes its naive
``_sdpa`` (MLA: its naive scores) below 4,096 tokens and
``xla_flash.flash_sdpa`` from there on; all three compute the same
function.  MLA's q and k are ``nope + rope`` wide and its v ``v_head``
wide, a pair the flash op takes.  Decode takes either of the JAX
package's cache layouts: one layer's ``[B, S, KV, dh]`` (``gqa_decode``:
the hybrid family's shared block, the whisper decoder's self attention)
or the stacked KV-major ``[L, B, KV, S, dh]`` (``gqa_decode_flat``), each
written in place at the token's slot; MLA decodes against the latent
cache with the weights absorbed, in plain einsums as XLA computes it.
Scores and softmax run in f32 and the probabilities are cast to V's (or
x's) dtype before the second product.  Cross attention (whisper's
decoder over the encoder's K/V) is the plain ``_sdpa``, as in the JAX
package.
"""
from __future__ import annotations

import math

import torch
import torch.distributed._functional_collectives as funcol
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor._utils import \
    compute_local_shape_and_global_offset

from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models import layers as L
from repro_torch.utils.pytree import tensor_dataclass

NEG_INF = -1e30


def write_at(dst, index: tuple, value) -> None:
    """``dst[index] = value`` in place, ``index`` host ints and full
    slices (a decode step's cache entry).  On a DTensor ``dst`` (the
    serve step on a mesh) every device lays ``value`` out as ``dst``'s
    shard over the dims that are not indexed (a collective, so every
    device takes part), and only the device whose shard holds the entry
    writes it into its local tensor; a sequence sharded over the mesh is
    thus written where it lies, where DTensor would gather the whole
    cache to index it."""
    if not isinstance(dst, DTensor):
        dst[index] = value
        return
    mesh, pl = dst.device_mesh, dst.placements
    index = tuple(index) + (slice(None),) * (dst.ndim - len(index))
    fixed = [d for d, i in enumerate(index) if isinstance(i, int)]
    vpl = [Shard(p.dim - sum(f < p.dim for f in fixed))
           if isinstance(p, Shard) and p.dim not in fixed else Replicate()
           for p in pl]
    if not isinstance(value, DTensor):
        value = DTensor.from_local(value, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
    value = value.redistribute(mesh, vpl).to_local()
    shape, offset = compute_local_shape_and_global_offset(dst.shape, mesh,
                                                          pl)
    local = []
    for d, i in enumerate(index):
        if isinstance(i, int):
            if not offset[d] <= i < offset[d] + shape[d]:
                return                     # another device's entry
            i -= offset[d]
        local.append(i)
    with torch.no_grad():
        dst.to_local()[tuple(local)] = value


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


def split_heads(t, n: int, width: int):
    """``t`` ``[B, S, n * width]`` as ``[B, S, n, width]``.  A DTensor
    whose last dim is sharded over more devices than divide ``n`` is
    gathered over it first (DTensor cannot split it in place)."""
    if isinstance(t, DTensor):
        split = [i for i, p in enumerate(t.placements)
                 if isinstance(p, Shard) and p.dim == t.ndim - 1]
        if n % math.prod(t.device_mesh.shape[i] for i in split):
            t = t.redistribute(t.device_mesh, [
                Replicate() if i in split else p
                for i, p in enumerate(t.placements)])
    return t.reshape(t.shape[:-1] + (n, width))


def merge_heads(t):
    """``t`` ``[B, S, n, width]`` as ``[B, S, n * width]``.  On a DTensor
    the gradient comes back laid out as the forward's output (partial
    sums reduced): split again into heads, a width sharded over more
    devices than divide ``n`` would not split."""
    out = t.reshape(t.shape[:-2] + (-1,))
    if isinstance(out, DTensor):
        out = out.redistribute(out.device_mesh, L.settled(out))
    return out


class _CacheSplit:
    """Where one layer's DTensor decode cache lies on its mesh, for
    attention over it on each device's own shard (``of``): the mesh dims
    that split its sequence (``seq``), this device's slice of the
    sequence (``start``, ``length``) and the placements of a ``[B, ...]``
    activation whose batch lies as the cache's (``batch``).  A cache
    sharded in another dim (a head width, where the sequence is too
    short to split) is gathered over it (``cache``).  Where the sequence
    is split over more than one device the softmax and the product with
    V are finished across them (``softmax``, ``sum``, the flash-decoding
    split); where it is not, each device's attention is the plain one,
    bit for bit."""

    def __init__(self, cache, batch_dim: int, seq_dim: int):
        self.mesh = cache.device_mesh
        self.layout = [p if isinstance(p, Shard) and p.dim in (
            batch_dim, seq_dim) else Replicate() for p in cache.placements]
        shape, offset = compute_local_shape_and_global_offset(
            cache.shape, self.mesh, self.layout)
        self.seq = [i for i, p in enumerate(self.layout)
                    if isinstance(p, Shard) and p.dim == seq_dim]
        self.batch = [Shard(0) if isinstance(p, Shard) and p.dim ==
                      batch_dim else Replicate() for p in self.layout]
        self.start, self.length = offset[seq_dim], shape[seq_dim]
        self.split = math.prod(self.mesh.shape[i] for i in self.seq) > 1

    @staticmethod
    def of(cache, batch_dim: int, seq_dim: int):
        """The split of ``cache``, or None where it is not a DTensor."""
        if not isinstance(cache, DTensor):
            return None
        return _CacheSplit(cache, batch_dim, seq_dim)

    def cache(self, c):
        """This device's shard of a cache laid out as the one given."""
        if list(c.placements) != self.layout:
            c = c.redistribute(self.mesh, self.layout)
        return c.to_local()

    def local(self, x):
        """This device's rows of an activation ``[B, ...]``."""
        if not isinstance(x, DTensor):
            x = DTensor.from_local(x, self.mesh,
                                   [Replicate()] * self.mesh.ndim,
                                   run_check=False)
        return x.redistribute(self.mesh, self.batch).to_local()

    def keys(self, kj):
        """This device's slice of the key positions ``kj``."""
        return kj[self.start:self.start + self.length]

    def wrap(self, x):
        return DTensor.from_local(x, self.mesh, self.batch,
                                  run_check=False)

    def softmax(self, s):
        """Softmax over the last dim of ``s``, the local keys."""
        if not self.split:
            return torch.softmax(s, dim=-1)
        m = s.amax(dim=-1, keepdim=True)
        for d in self.seq:
            m = funcol.all_reduce(m, "max", (self.mesh, d))
        e = torch.exp(s - m)
        total = e.sum(dim=-1, keepdim=True)
        for d in self.seq:
            total = funcol.all_reduce(total, "sum", (self.mesh, d))
        return e / total

    def sum(self, x):
        """``x``, a product over the local keys, summed over all keys."""
        for d in self.seq if self.split else ():
            x = funcol.all_reduce(x, "sum", (self.mesh, d))
        return x


def _sdpa(q, k, v, mask, scale: float, split=None):
    """q ``[B, Sq, H, dh]``, k/v ``[B, Sk, KV, dh]``, mask ``[B, 1, Sq,
    Sk]`` bool (True keeps): scores in f32, probabilities cast to V's
    dtype.  ``split``: the keys are this device's shard of a cache
    (``_CacheSplit``)."""
    B, Sq, H, dh = q.shape
    KV = k.shape[2]
    qg = q.reshape(B, Sq, KV, H // KV, dh)
    s = torch.einsum("bqkrd,bskd->bkrqs", qg, k).float() * scale
    s = torch.where(mask[:, :, None], s, NEG_INF)
    probs = (split.softmax(s) if split else
             torch.softmax(s, dim=-1)).to(v.dtype)
    out = torch.einsum("bkrqs,bskd->bqkrd", probs, v)
    if split:
        out = split.sum(out)
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
    q = split_heads(L.linear(p["wq"], x), H, dh)
    k = split_heads(L.linear(p["wk"], x), KV, dh)
    v = split_heads(L.linear(p["wv"], x), KV, dh)
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
    out = L.linear(p["wo"], merge_heads(out))
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
    write_at(cache.k, (slice(None), slot), k_new[:, 0])
    write_at(cache.v, (slice(None), slot), v_new[:, 0])
    kj = torch.arange(S_max, device=x.device)
    split = _CacheSplit.of(cache.k, 0, 1)
    k, v = cache.k, cache.v
    if split:
        q, k, v, kj = split.local(q), split.cache(k), split.cache(v), \
            split.keys(kj)
    mask = kj <= pos
    if window and not ring:
        mask &= kj > pos - window
    out = _sdpa(q, k, v, mask.expand(q.shape[0], 1, 1, len(kj)),
                cfg.head_dim ** -0.5, split)
    if split:
        out = split.wrap(out)
    return L.linear(p["wo"], merge_heads(out)), cache


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
    write_at(k_st, (idx, slice(None), slice(None), slot), k_new[:, 0])
    write_at(v_st, (idx, slice(None), slice(None), slot), v_new[:, 0])
    k_l, v_l = k_st[idx], v_st[idx]                     # [B, KV, S, dh]

    kj = torch.arange(S_max, device=x.device)
    split = _CacheSplit.of(k_l, 0, 2)
    if split:
        q, k_l, v_l, kj = split.local(q), split.cache(k_l), \
            split.cache(v_l), split.keys(kj)
    qg = q.reshape(q.shape[0], KV, H // KV, dh)
    s = torch.einsum("bkrd,bksd->bkrs", qg, k_l).float() * dh ** -0.5
    mask = kj <= pos
    if window and not ring:
        mask &= kj > pos - window
    s = torch.where(mask, s, NEG_INF)
    probs = (split.softmax(s) if split else
             torch.softmax(s, dim=-1)).to(v_l.dtype)
    out = torch.einsum("bkrs,bksd->bkrd", probs, v_l)
    if split:
        out = split.wrap(split.sum(out))
    out = L.linear(p["wo"], out.reshape(B, 1, H * dh))
    return out, k_st, v_st


def _on_batch_shards(fn, *args):
    """``fn(*args)`` on each device's rows of the batch (cross attention
    on a mesh): the DTensors of ``args`` laid out with their first dim as
    the first one's batch lies (``Shard(0)`` on the mesh dims that split
    it, gathered over the rest), ``fn`` run on the local tensors,
    recorded by autograd as plain ops, and its output, batch first, a
    DTensor laid out so."""
    mesh = args[0].device_mesh
    rows = [Shard(0) if p == Shard(0) else Replicate()
            for p in args[0].placements]
    out = fn(*(a.redistribute(mesh, rows).to_local()
               if isinstance(a, DTensor) else a for a in args))
    return DTensor.from_local(out, mesh, rows, run_check=False)


def gqa_cross(p, x, enc_kv: KVCache, cfg):
    """Cross attention (the whisper decoder): q from x ``[B, S, D]``, K/V
    ``[B, Sk, KV, dh]`` precomputed from the encoder, no mask."""
    H, dh = cfg.n_heads, cfg.head_dim
    q = split_heads(L.linear(p["wq"], x), H, dh)

    def attend(q, k, v):
        mask = torch.ones((q.shape[0], 1, q.shape[1], k.shape[1]),
                          dtype=torch.bool, device=q.device)
        return _sdpa(q, k, v, mask, dh ** -0.5)

    args = (q, enc_kv.k, enc_kv.v)
    out = _on_batch_shards(attend, *args) if isinstance(q, DTensor) \
        else attend(*args)
    return L.linear(p["wo"], merge_heads(out))


# ---------------------------------------------------------------------- MLA
def mla_init(gen, cfg, dtype, device, lead: tuple = ()) -> dict:
    """DeepSeek-V2 multi-head latent attention (kv_lora compression): the
    JAX package's leaves and shapes."""
    D, H = cfg.d_model, cfg.n_heads
    nope, rope_d, vd = cfg.head_dim, cfg.rope_head_dim, cfg.v_head_dim
    R = cfg.kv_lora_rank
    kw = dict(dtype=dtype, device=device, lead=lead)
    p = {"wkv_a": L.linear_init(gen, D, R + rope_d, **kw),
         "kv_norm": L.rmsnorm_init(R, dtype, device, lead),
         "wkv_b": L.linear_init(gen, R, H * (nope + vd), **kw),
         "wo": L.linear_init(gen, H * vd, D, scale=0.5, **kw)}
    if cfg.q_lora_rank:
        p["wq_a"] = L.linear_init(gen, D, cfg.q_lora_rank, **kw)
        p["q_norm"] = L.rmsnorm_init(cfg.q_lora_rank, dtype, device, lead)
        p["wq_b"] = L.linear_init(gen, cfg.q_lora_rank,
                                  H * (nope + rope_d), **kw)
    else:
        p["wq"] = L.linear_init(gen, D, H * (nope + rope_d), **kw)
    return p


@tensor_dataclass
class MLACache:
    """Latent cache: the compressed ``c_kv`` ``[B, S, kv_lora]`` and the
    shared ``k_rope`` ``[B, S, rope_d]`` (stacked: ``[L, B, S, *]``)."""
    c_kv: torch.Tensor
    k_rope: torch.Tensor


def _mla_q(p, x, positions, cfg):
    """-> (q_nope ``[B, S, H, nope]``, q_rope ``[B, S, H, rope_d]``)."""
    B, S, _ = x.shape
    H, nope, rope_d = cfg.n_heads, cfg.head_dim, cfg.rope_head_dim
    if cfg.q_lora_rank:
        q = L.linear(p["wq_b"], L.rmsnorm(p["q_norm"],
                                          L.linear(p["wq_a"], x),
                                          cfg.norm_eps))
    else:
        q = L.linear(p["wq"], x)
    q = split_heads(q, H, nope + rope_d)
    return q[..., :nope], L.apply_rope(q[..., nope:], positions,
                                       cfg.rope_theta)


def _mla_kv_a(p, x, positions, cfg):
    """-> (c_kv ``[B, S, kv_lora]``, k_rope ``[B, S, rope_d]``: one head
    shared by every query head)."""
    kv = L.linear(p["wkv_a"], x)
    R = cfg.kv_lora_rank
    c_kv = L.rmsnorm(p["kv_norm"], kv[..., :R], cfg.norm_eps)
    k_rope = L.apply_rope(kv[..., R:][:, :, None, :], positions,
                          cfg.rope_theta)[:, :, 0]
    return c_kv, k_rope


def mla_full(p, x, cfg, *, causal: bool = True):
    """Train/prefill: K/V materialised per head from the latent.  The
    nope and rope parts of q and k are concatenated (k_rope broadcast to
    every head, as the JAX package does), so the scores are one product
    of width ``nope + rope_d`` scaled by its inverse square root, through
    the flash op with v ``v_head`` wide.  Returns ``(out, MLACache)``."""
    B, S, _ = x.shape
    H, nope, rope_d = cfg.n_heads, cfg.head_dim, cfg.rope_head_dim
    positions = torch.arange(S, dtype=torch.int32,
                             device=x.device)[None].expand(B, S)
    q_nope, q_rope = _mla_q(p, x, positions, cfg)
    c_kv, k_rope = _mla_kv_a(p, x, positions, cfg)
    kvb = split_heads(L.linear(p["wkv_b"], c_kv), H, cfg.head_dim
                      + cfg.v_head_dim)
    k_nope, v = kvb[..., :nope], kvb[..., nope:]
    q_cat = torch.cat([q_nope, q_rope], dim=-1)
    k_cat = torch.cat([k_nope, k_rope[:, :, None, :].expand(B, S, H, rope_d)],
                      dim=-1)
    out = flash_ops.flash_attention(q_cat, k_cat, v, causal=causal)
    out = L.linear(p["wo"], merge_heads(out))
    return out, MLACache(c_kv=c_kv, k_rope=k_rope)


def _mla_absorbed(p, x, q_nope, q_rope, c_kv, k_rope, pos: int, cfg):
    """One token's attention in the latent space: q_nope absorbed into
    ``wkv_b``'s key half, scores over the latent cache ``c_kv [B, S, R]``
    plus the rope part over ``k_rope [B, S, rope_d]``, positions past
    ``pos`` masked, the output read back through the value half."""
    B = x.shape[0]
    H, nope, rope_d = cfg.n_heads, cfg.head_dim, cfg.rope_head_dim
    R = cfg.kv_lora_rank
    wkv_b = p["wkv_b"]["w"].reshape(R, H, -1)
    w_k, w_v = wkv_b[..., :nope], wkv_b[..., nope:]
    q_lat = torch.einsum("bqhd,rhd->bqhr", q_nope, w_k)
    kj = torch.arange(c_kv.shape[1], device=x.device)
    split = _CacheSplit.of(c_kv, 0, 1)
    if split:
        q_lat, q_rope, c_kv, k_rope, kj = (
            split.local(q_lat), split.local(q_rope), split.cache(c_kv),
            split.cache(k_rope), split.keys(kj))
    scores = (torch.einsum("bqhr,bsr->bhqs", q_lat, c_kv)
              + torch.einsum("bqhd,bsd->bhqs", q_rope, k_rope))
    scores = scores.float() * (nope + rope_d) ** -0.5
    scores = torch.where(kj <= pos, scores, NEG_INF)
    probs = (split.softmax(scores) if split else
             torch.softmax(scores, dim=-1)).to(x.dtype)
    out_lat = torch.einsum("bhqs,bsr->bqhr", probs, c_kv)
    if split:
        out_lat = split.wrap(split.sum(out_lat))
    out = torch.einsum("bqhr,rhd->bqhd", out_lat, w_v)
    return L.linear(p["wo"], merge_heads(out))


def mla_decode(p, x, cache: MLACache, pos: int, cfg):
    """Decode with weight absorption against one layer's latent cache
    (``c_kv [B, S_max, R]``, ``k_rope [B, S_max, rope_d]``), written in
    place at ``pos`` (a host int).  Returns ``(out [B, 1, D], cache)``."""
    B = x.shape[0]
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q_nope, q_rope = _mla_q(p, x, positions, cfg)
    c_new, kr_new = _mla_kv_a(p, x, positions, cfg)
    write_at(cache.c_kv, (slice(None), pos), c_new[:, 0])
    write_at(cache.k_rope, (slice(None), pos), kr_new[:, 0])
    return _mla_absorbed(p, x, q_nope, q_rope, cache.c_kv, cache.k_rope,
                         pos, cfg), cache


def mla_decode_flat(p, x, c_st, r_st, idx: int, pos: int, cfg):
    """``mla_decode`` against the stacked latent caches ``c_st [L, B, S,
    R]`` and ``r_st [L, B, S, rope_d]``, layer ``idx`` written in place.
    Returns ``(out, c_st, r_st)``."""
    B = x.shape[0]
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q_nope, q_rope = _mla_q(p, x, positions, cfg)
    c_new, kr_new = _mla_kv_a(p, x, positions, cfg)
    write_at(c_st, (idx, slice(None), pos), c_new[:, 0])
    write_at(r_st, (idx, slice(None), pos), kr_new[:, 0])
    return _mla_absorbed(p, x, q_nope, q_rope, c_st[idx], r_st[idx], pos,
                         cfg), c_st, r_st
