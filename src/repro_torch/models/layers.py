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

import torch
import torch.nn.functional as F

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


def linear(p: dict, x):
    return x @ p["w"]


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
    return p["table"][ids]


def unembed(p: dict, x):
    return x @ p["table"].T


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
        if device.type == "cuda" else row


def cross_entropy(logits, labels, vocab: int):
    """Mean token cross-entropy in f32; labels < 0 are masked out."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.clamp_min(0).long()[..., None])[..., 0]
    nll = logz - gold
    mask = (labels >= 0).float()
    return (nll * mask).sum() / mask.sum().clamp_min(1.0)
