"""Dispatch of flash attention with its gradient: the tensor's device
decides.

A CPU ``q`` goes to the plain version (ref.py), differentiated by
autograd; a CUDA ``q`` goes to the hand-written kernels (kernel.py) for
the forward and, through a ``torch.autograd.Function``, for the
backward, whose wrappers raise on anything the kernels cannot take.
There is no switch that pins the plain version on the card and no
fallback from a failed build or launch.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import kernel, ref


def _dense(x):
    """``x`` contiguous and, in bf16, on a 16-byte boundary (the kernels'
    TMA tiles need it): a copy where it is not."""
    x = x.contiguous()
    return x.clone() if x.dtype == torch.bfloat16 and x.data_ptr() % 16 \
        else x


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int):
        out, lse = kernel.flash_attention_fwd(q, k, v, causal=causal,
                                              window=window)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = kernel.flash_attention_bwd(
            q, k, v, out, lse, _dense(dout), causal=ctx.causal,
            window=ctx.window)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """Causal (optionally windowed) GQA attention
    (``ref.flash_attention_ref``): q ``[B, S, H, dq]``, k ``[B, S, KV,
    dq]``, v ``[B, S, KV, dv]`` -> ``[B, S, H, dv]`` in q's dtype; on the
    card ``(dq, dv)`` is one of ``kernel.HEAD_DIMS``."""
    if q.device.type == "cuda":
        return _FlashAttention.apply(_dense(q), _dense(k), _dense(v),
                                     causal, window)
    if q.device.type != "cpu":
        raise ValueError(f"flash_attention runs on cuda or cpu, not "
                         f"{q.device}")
    return ref.flash_attention_ref(q, k, v, causal=causal, window=window)
