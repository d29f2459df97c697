"""Dispatch of the Mamba2 SSD chunked scan with its gradient: the tensor's
device decides.

A CPU ``x`` goes to the plain version (ref.py), differentiated by
autograd; a CUDA ``x`` goes to the hand-written kernels (kernel.py) for
the forward and, through a ``torch.autograd.Function``, for the
backward, whose wrappers raise on anything the kernels cannot take.  The
backward takes the cotangents of both outputs (the final state's is
zero on the training path, which drops the cache).  There is no switch
that pins the plain version on the card and no fallback from a failed
build or launch.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.mamba_scan import kernel, ref


class _MambaScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, chunk: int):
        y, h_final = kernel.mamba_scan_fwd(x, dt, A, Bm, Cm, chunk=chunk)
        ctx.save_for_backward(x, dt, A, Bm, Cm)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)   # an unused output's is None
        return y, h_final

    @staticmethod
    def backward(ctx, dy, dh_final):
        x, dt, A, Bm, Cm = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(x)
        grads = kernel.mamba_scan_bwd(
            x, dt, A, Bm, Cm, dy.contiguous(),
            None if dh_final is None else dh_final.contiguous(),
            chunk=ctx.chunk)
        return grads + (None,)


def mamba_scan(x, dt, A, Bm, Cm, *, chunk: int):
    """The SSD chunked scan (``ref.mamba_scan_ref``): x ``[B, S, H, P]``
    (f32 or bf16), dt ``[B, S, H]``, A ``[H]`` (negative), Bm/Cm
    ``[B, S, N]``, all f32 but x, S a multiple of ``chunk`` ->
    ``(y [B, S, H, P]`` in x's dtype, ``h_final [B, H, P, N]`` f32)."""
    if x.device.type == "cuda":
        return _MambaScan.apply(x.contiguous(), dt.contiguous(),
                                A.contiguous(), Bm.contiguous(),
                                Cm.contiguous(), chunk)
    if x.device.type != "cpu":
        raise ValueError(f"mamba_scan runs on cuda or cpu, not {x.device}")
    return ref.mamba_scan_ref(x, dt, A, Bm, Cm, chunk)
