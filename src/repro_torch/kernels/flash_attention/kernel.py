"""Wrapper of the hand-written CUDA flash attention (csrc/).

Replaces the Pallas TPU kernel ``repro/kernels/flash_attention/kernel.py``
(``flash_attention_kernel``) and adds its gradient; the plain version is
ref.py.  q and k are ``dq`` wide, v (and the output) ``dv`` wide, in the
pairs of ``HEAD_DIMS``: as wide as each other, or MLA's (reduced, and
deepseek-v2's published widths); any other pair raises.  bf16 runs on the
tensor cores (wgmma, tiles by TMA, so each bf16 tensor must start on a
16-byte boundary), f32 on the CUDA cores.
``flash_attention_fwd`` launches the forward kernel and counts
``_backend.launches["flash_attention_fwd"]``; ``flash_attention_bwd``
launches the three backward kernels (Delta, dK/dV, dQ) and counts one
``flash_attention_bwd``.  The wrappers check devices, dtypes, shapes and
contiguity, allocate the outputs and scratch, launch on PyTorch's current
stream without synchronising, and raise if a launch returned an error.
The library is built at the first call, never at import.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import _backend

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: (dq, dv): the widths of q and k, and of v; both dtypes take every pair
HEAD_DIMS = frozenset({(16, 16), (64, 64), (128, 128), (32, 16), (192, 128)})

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "arms_flash_attention_fwd": [_P] * 5 + [_I] * 8 + [_F, _I, _P],
    "arms_flash_attention_bwd": [_P] * 10 + [_I] * 8 + [_F, _I, _P]}


def _check(name, q, k, v, **more):
    """Shapes ``(B, S, H, KV, dq, dv)`` after checking every tensor: q
    ``[B, S, H, dq]``, k ``[B, S, KV, dq]`` and v ``[B, S, KV, dv]`` of q's
    dtype, ``(dq, dv)`` in ``HEAD_DIMS``; those in ``more`` shaped like the
    output ``[B, S, H, dv]`` (``out``, ``dout``) or like ``lse``; all
    contiguous, on q's CUDA device."""
    B, S, H, dq = q.shape
    KV, dv = k.shape[2], v.shape[-1]
    if q.dtype not in DTYPES:
        raise TypeError(f"{name}: dtype {q.dtype}, expected f32 or bf16")
    if (dq, dv) not in HEAD_DIMS:
        raise ValueError(f"{name}: head widths (dq, dv) = ({dq}, {dv}) not "
                         f"in {sorted(HEAD_DIMS)}")
    if S < 1 or KV < 1 or H % KV or B * H > 65535:
        raise ValueError(f"{name}: B={B}, S={S}, H={H}, KV={KV} unsupported")
    want = {"q": (q, q.dtype, (B, S, H, dq)),
            "k": (k, q.dtype, (B, S, KV, dq)),
            "v": (v, q.dtype, (B, S, KV, dv))}
    for nm, t in more.items():
        want[nm] = (t, torch.float32, (B, H, S)) if nm == "lse" \
            else (t, q.dtype, (B, S, H, dv))
    for nm, (t, dt, shape) in want.items():
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"{name}: {nm} on {t.device}, expected "
                             f"{q.device} (a CUDA device)")
        if t.dtype != dt or tuple(t.shape) != shape:
            raise ValueError(f"{name}: {nm} is {t.dtype} {tuple(t.shape)}, "
                             f"expected {dt} {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {nm} must be contiguous")
        if t.dtype == torch.bfloat16 and t.data_ptr() % 16:
            raise ValueError(f"{name}: {nm} must start on a 16-byte "
                             f"boundary (TMA)")
    return B, S, H, KV, dq, dv


def _stream(dev):
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


def flash_attention_fwd(q, k, v, *, causal: bool = True, window: int = 0):
    """-> ``(out [B, S, H, dv]`` in q's dtype, ``lse [B, H, S]`` f32), the
    row log-sum-exp of the masked scores scaled by ``dq ** -0.5``."""
    B, S, H, KV, dq, dv = _check("flash_attention_fwd", q, k, v)
    out = torch.empty((B, S, H, dv), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    err = _backend.library(SOURCE, _SIGNATURES).arms_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), B, S, H, KV, dq, dv, int(causal), int(window),
        dq ** -0.5, DTYPES[q.dtype], _stream(q.device))
    if err != 0:
        raise RuntimeError(
            f"flash_attention forward launch failed: CUDA error {err}")
    _backend.launched("flash_attention_fwd")
    return out, lse


def flash_attention_bwd(q, k, v, out, lse, dout, *, causal: bool = True,
                        window: int = 0):
    """The gradient of ``flash_attention_fwd``'s ``out`` under the
    cotangent ``dout``: ``(dq, dk, dv)`` in the inputs' dtype, summed in
    f32, each element written once (repeatable bit for bit)."""
    B, S, H, KV, wq, wv = _check("flash_attention_bwd", q, k, v, out=out,
                                 lse=lse, dout=dout)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    err = _backend.library(SOURCE, _SIGNATURES).arms_flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), B, S, H, KV, wq, wv, int(causal),
        int(window), wq ** -0.5, DTYPES[q.dtype], _stream(q.device))
    if err != 0:
        raise RuntimeError(
            f"flash_attention backward launch failed: CUDA error {err}")
    _backend.launched("flash_attention_bwd")
    return dq, dk, dv
