"""Core neural layers (plain tensor functions over explicit param dicts).

The port of ``repro/models/layers.py``: RMSNorm, linear, RoPE, SwiGLU,
the GELU MLP, embeddings, the sinusoidal positions and the loss.
Params are nested dicts of tensors in the JAX package's layout (``x @
w`` with ``w`` ``[d_in, d_out]``), so ``convert.model_params`` carries a
JAX parameter tree across leaf by leaf.  Matmuls run in the config dtype
(bf16 at full width); normalization statistics, RoPE angles and the
softmax run in f32.  Inits draw from an explicit ``torch.Generator`` and
cannot reproduce ``jax.random``'s bits.
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor._utils import \
    compute_local_shape_and_global_offset

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def dtype_of(cfg) -> torch.dtype:
    return DTYPES[cfg.dtype]


def normal(shape, std: float, dtype, gen: torch.Generator, device):
    """f32 normal draws on the generator's device times ``std``, cast to
    ``dtype`` and moved to ``device``; a stacked ``[L, ...]`` leaf is drawn
    one layer at a time, so the f32 transient stays one layer's size."""
    out = torch.empty(shape, dtype=dtype, device=device)
    if out.device.type == "meta":    # shapes only (``count_params``)
        return out
    rows = out if len(shape) > 2 else out[None]
    for row in rows:
        row.copy_(torch.randn(row.shape, generator=gen, device=gen.device,
                              dtype=torch.float32) * std)
    return out


# ------------------------------------------------------------------ RMSNorm
def rmsnorm_init(d: int, dtype, device, lead: tuple = ()) -> dict:
    return {"scale": torch.ones(lead + (d,), dtype=dtype, device=device)}


def rmsnorm(p: dict, x, eps: float = 1e-5):
    h = x.float()
    h = h * torch.rsqrt((h * h).mean(dim=-1, keepdim=True) + eps)
    return (h * p["scale"].float()).to(x.dtype)


# ------------------------------------------------------------------- Linear
def linear_init(gen, d_in: int, d_out: int, dtype, device, scale: float = 1.0,
                lead: tuple = ()) -> dict:
    return {"w": normal(lead + (d_in, d_out), scale / d_in ** 0.5, dtype, gen,
                        device)}


def fsdp_gather(w, x):
    """A DTensor weight ``w`` gathered over the mesh dims that split
    ``x``'s batch (the FSDP factor of the sharding rules, JAX's 'data'),
    so that each device multiplies its own rows by the whole of its
    tensor-parallel shard, as GSPMD does; anything else as it is."""
    if not isinstance(w, DTensor) or not isinstance(x, DTensor):
        return w
    batch = [i for i, p in enumerate(x.placements) if p == Shard(0)]
    if not any(isinstance(w.placements[i], Shard) for i in batch):
        return w
    return w.redistribute(w.device_mesh, [
        Replicate() if i in batch else p for i, p in enumerate(w.placements)])


def linear(p: dict, x):
    return x @ fsdp_gather(p["w"], x)


# -------------------------------------------------------------------- RoPE
def rope_freqs(head_dim: int, theta: float, pct: float = 1.0):
    """Inverse frequencies (f32) for (partially) rotary embeddings, and
    the rotated width."""
    rot = int(head_dim * pct) // 2 * 2
    inv = 1.0 / (theta ** (torch.arange(0, rot, 2, dtype=torch.float32)
                           / rot))
    return inv, rot


@functools.lru_cache(maxsize=64)
def _rope_inv(head_dim: int, theta: float, pct: float, device):
    """``rope_freqs`` computed on the CPU (the same bits on every device)
    and copied to ``device`` once, not at every call."""
    inv, rot = rope_freqs(head_dim, theta, pct)
    return inv.to(device), rot


def apply_rope(x, positions, theta: float, pct: float = 1.0):
    """x: [B, S, H, hd]; positions: [B, S] (int).  Interleaved pairs
    (``x[..., 0::2]``, ``x[..., 1::2]``), angles in f32."""
    inv, rot = _rope_inv(x.shape[-1], theta, pct, x.device)
    ang = (positions[..., None].float() * inv).double()
    # f32 angles; sin and cos in f64 rounded once, so CPU and card agree
    sin = torch.sin(ang).float()[:, :, None, :]
    cos = torch.cos(ang).float()[:, :, None, :]
    xr = x[..., :rot].float()
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    out = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    out = out.reshape(x.shape[:-1] + (rot,))
    return torch.cat([out.to(x.dtype), x[..., rot:]], dim=-1)


# ------------------------------------------------------------------- SwiGLU
def swiglu_init(gen, d: int, f: int, dtype, device, lead: tuple = ()) -> dict:
    return {"wi": linear_init(gen, d, 2 * f, dtype, device, lead=lead),
            "wo": linear_init(gen, f, d, dtype, device, lead=lead)}


def swiglu(p: dict, x):
    gate, up = linear(p["wi"], x).chunk(2, dim=-1)
    return linear(p["wo"], F.silu(gate) * up)


# ------------------------------------------------------------- GELU MLP
def gelu_mlp_init(gen, d: int, f: int, dtype, device,
                  lead: tuple = ()) -> dict:
    return {"wi": linear_init(gen, d, f, dtype, device, lead=lead),
            "wo": linear_init(gen, f, d, dtype, device, lead=lead)}


def gelu_mlp(p: dict, x):
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return linear(p["wo"], F.gelu(linear(p["wi"], x), approximate="tanh"))


# -------------------------------------------------------------- Embeddings
def embedding_init(gen, vocab: int, d: int, dtype, device) -> dict:
    return {"table": normal((vocab, d), 0.02, dtype, gen, device)}


def embed(p: dict, ids):
    table = p["table"]
    if isinstance(table, DTensor):
        return _embed_on_mesh(table, ids)
    return table[ids]


def _embed_on_mesh(table, ids):
    """The lookup of each device's rows of ``ids`` in its vocab shard of
    the table, gathered over its width: rows of other shards read as
    zeros and the result is a partial sum over the vocab's mesh dims (a
    vocab-parallel lookup; the plain lookup where the vocab is not
    split, so a one-device mesh gives the plain bits).  The table's
    gradient is a partial sum over the mesh dims that split ``ids``.
    DTensor's own lookup backward (``index_put``) fails to propagate on
    some PyTorch releases."""
    mesh = table.device_mesh
    if not isinstance(ids, DTensor):
        ids = DTensor.from_local(ids, mesh, [Replicate()] * mesh.ndim,
                                 run_check=False)
    vocab = [i for i, p in enumerate(table.placements) if p == Shard(0)]
    layout = [Shard(0) if i in vocab else Replicate()
              for i in range(mesh.ndim)]
    local = table.redistribute(mesh, layout).to_local(grad_placements=[
        Shard(0) if i in vocab else
        Partial() if isinstance(p, Shard) else Replicate()
        for i, p in enumerate(ids.placements)])
    idx = ids.to_local()
    if math.prod(mesh.shape[i] for i in vocab) == 1:
        return DTensor.from_local(local[idx], mesh, ids.placements,
                                  run_check=False)
    start = compute_local_shape_and_global_offset(table.shape, mesh,
                                                  layout)[1][0]
    rel = idx - start
    hit = (rel >= 0) & (rel < local.shape[0])
    rows = torch.where(hit[..., None],
                       local[rel.clamp(0, local.shape[0] - 1)], 0)
    return DTensor.from_local(
        rows, mesh, [Partial() if i in vocab else p
                     for i, p in enumerate(ids.placements)],
        run_check=False)


def unembed(p: dict, x):
    return x @ fsdp_gather(p["table"], x).T


def _sinusoid_rows(positions, d: int):
    """``[len(positions), d]`` f32 on the CPU: the angles ``pos / 10_000
    ** (dim / d)`` in f32 as XLA's compiled program forms them (``pos``
    times the f32 reciprocal of the power, the power rounded once from
    f64), their sin at the even columns and cos at the odd ones taken in
    f64 and rounded once, as ``apply_rope`` takes RoPE's, so every device
    gets the same bits."""
    expo = torch.arange(0, d, 2, dtype=torch.float32) / d
    inv = 1.0 / (10_000.0 ** expo.double()).float()
    ang = (positions.float()[:, None] * inv).double()
    pe = torch.empty((len(positions), d), dtype=torch.float32)
    pe[:, 0::2] = torch.sin(ang).float()
    pe[:, 1::2] = torch.cos(ang).float()   # d is even for all our configs
    return pe


@functools.lru_cache(maxsize=16)
def _sinusoids(seq: int, d: int, device):
    return _sinusoid_rows(torch.arange(seq), d).to(device)


def sinusoidal_positions(seq: int, d: int, device=None):
    """``[seq, d]`` f32 sinusoidal position table (whisper's), computed on
    the CPU once per shape and copied to ``device``."""
    return _sinusoids(seq, d, torch.device(device or "cpu"))


def sinusoidal_at(pos: int, d: int, device=None):
    """The sinusoidal embedding ``[d]`` f32 of one position (a host int):
    ``sinusoidal_positions``' row ``pos``, bit for bit.  It reaches the
    card through pinned memory, so a decode step does not synchronise."""
    row = _sinusoid_rows(torch.tensor([pos]), d)[0]
    device = torch.device(device or "cpu")
    return row.pin_memory().to(device, non_blocking=True) \
        if device.type == "cuda" else row.to(device)


def settled(x) -> list:
    """A DTensor ``x``'s placements with every partial sum reduced
    (``Replicate``)."""
    return [Replicate() if p.is_partial() else p for p in x.placements]


def cross_entropy(logits, labels, vocab: int):
    """Mean token cross-entropy in f32; labels < 0 are masked out."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.clamp_min(0).long()[..., None])
    if isinstance(gold, DTensor):   # finish a vocab-sharded gather here
        gold = gold.redistribute(gold.device_mesh, settled(gold))
    gold = gold[..., 0]
    nll = logz - gold
    mask = (labels >= 0).float()
    return (nll * mask).sum() / mask.sum().clamp_min(1.0)
