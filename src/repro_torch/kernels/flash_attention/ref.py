"""Plain PyTorch version of causal (optionally windowed) GQA attention.

The contract of the CUDA kernels (kernel.py) and what the op runs for
tensors on the CPU: the port of ``repro/kernels/flash_attention/ref.py``
op for op (scores in the inputs' dtype, then f32, scaled by dq^-0.5,
masked at -1e30, an f32 softmax cast to V's dtype before the second
product), with v as wide as q or, as MLA's is, narrower (JAX's
``xla_flash.flash_sdpa`` takes any v width).  Autograd through it gives
the plain gradient.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0):
    """q: ``[B, S, H, dq]``, k: ``[B, S, KV, dq]``, v: ``[B, S, KV, dv]``
    -> ``[B, S, H, dv]``; query head h reads KV head ``h // (H // KV)``,
    scores scaled by ``dq ** -0.5``."""
    return _attend(_scores(q, k, causal, window), v, q.shape[2])


def flash_attention_lse_ref(q, k, v, *, causal: bool = True,
                            window: int = 0):
    """``flash_attention_ref`` and the row log-sum-exp of the masked,
    scaled scores, ``[B, H, S]`` f32 (the kernels' ``lse``)."""
    s = _scores(q, k, causal, window)
    B, S, H, _ = q.shape
    return (_attend(s, v, H),
            torch.logsumexp(s, -1).reshape(B, H, S))


def _scores(q, k, causal: bool, window: int):
    """The masked, scaled f32 scores ``[B, KV, H // KV, S, S]``."""
    B, S, H, dh = q.shape
    KV = k.shape[2]
    qg = q.reshape(B, S, KV, H // KV, dh)
    s = torch.einsum("bqkrd,bskd->bkrqs", qg, k).float()
    s = s * dh ** -0.5
    qi = torch.arange(S, device=q.device)[:, None]
    kj = torch.arange(S, device=q.device)[None, :]
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kj <= qi
    if window:
        mask &= kj > qi - window
    return torch.where(mask, s, NEG_INF)


def _attend(s, v, H: int):
    """The softmax of the scores ``s``, cast to V's dtype, times V ->
    ``[B, S, H, dv]``."""
    B, S = v.shape[:2]
    p = torch.softmax(s, dim=-1).to(v.dtype)
    out = torch.einsum("bkrqs,bskd->bqkrd", p, v)
    return out.reshape(B, S, H, v.shape[-1])
