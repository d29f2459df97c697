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
    B, S, H, dh = q.shape
    KV, dv = k.shape[2], v.shape[-1]
    rep = H // KV
    qg = q.reshape(B, S, KV, rep, dh)
    s = torch.einsum("bqkrd,bskd->bkrqs", qg, k).float()
    s = s * dh ** -0.5
    qi = torch.arange(S, device=q.device)[:, None]
    kj = torch.arange(S, device=q.device)[None, :]
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kj <= qi
    if window:
        mask &= kj > qi - window
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    out = torch.einsum("bkrqs,bskd->bqkrd", p, v)
    return out.reshape(B, S, H, dv)
