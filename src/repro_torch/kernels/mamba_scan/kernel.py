"""Wrapper of the hand-written CUDA Mamba2 SSD chunked scan (csrc/).

Replaces the Pallas TPU kernel ``repro/kernels/mamba_scan/kernel.py``
(``mamba_scan_kernel``) and adds its gradient; the plain version is
ref.py.  ``mamba_scan_fwd`` launches the forward passes and counts one
``_backend.launches["mamba_scan_fwd"]``; ``mamba_scan_bwd`` launches the
backward passes (the forward's states recomputed, the chunk gradients,
the reductions over heads and chunks) and counts one ``mamba_scan_bwd``.
The wrappers check devices, dtypes, shapes, contiguity and the shared
memory a shape needs (the library reports it and the device's limit),
allocate the outputs and the f32 scratch, launch on PyTorch's current
stream without synchronising, and raise if a launch returned an error.
The library is built at the first call, never at import.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import _backend

SOURCE = Path(__file__).resolve().parent / "csrc" / "mamba_scan.cu"
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
BWD_FRAME = 64    # the backward's register tiles hold P and the chunk

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "arms_mamba_scan_fwd": [_P] * 10 + [_I] * 7 + [_P],
    "arms_mamba_scan_bwd": [_P] * 19 + [_I] * 7 + [_P],
    "arms_mamba_scan_smem": [_I] * 4 + [ctypes.POINTER(ctypes.c_longlong),
                                        ctypes.POINTER(_I)]}


def _lib():
    return _backend.library(SOURCE, _SIGNATURES)


def _check(name, x, dt, A, Bm, Cm, chunk: int, **more):
    """Shapes ``(B, S, H, P, N)`` after checking every tensor: x (and
    ``dy``) ``[B, S, H, P]`` f32 or bf16, dt ``[B, S, H]``, A ``[H]``,
    Bm/Cm ``[B, S, N]`` and ``dh_final`` ``[B, H, P, N]`` f32, contiguous,
    on x's CUDA device; S a positive multiple of ``chunk``; the shared
    memory of the largest pass within what the device allows a block."""
    if x.dim() != 4 or Bm.dim() != 3:
        raise ValueError(f"{name}: x {tuple(x.shape)} / Bm "
                         f"{tuple(Bm.shape)}, expected [B, S, H, P] / "
                         f"[B, S, N]")
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    if x.dtype not in DTYPES:
        raise TypeError(f"{name}: dtype {x.dtype}, expected f32 or bf16")
    if min(B, S, H, P, N, chunk) < 1 or S % chunk or H > 65535 \
            or B > 65535:
        raise ValueError(f"{name}: B={B}, S={S}, H={H}, P={P}, N={N}, "
                         f"chunk={chunk} unsupported (S must be a multiple "
                         f"of the chunk)")
    want = {"x": (x, x.dtype, (B, S, H, P)),
            "dt": (dt, torch.float32, (B, S, H)),
            "A": (A, torch.float32, (H,)),
            "Bm": (Bm, torch.float32, (B, S, N)),
            "Cm": (Cm, torch.float32, (B, S, N))}
    for nm, t in more.items():
        want[nm] = (t, x.dtype, (B, S, H, P)) if nm == "dy" \
            else (t, torch.float32, (B, H, P, N))
    for nm, (t, dtype, shape) in want.items():
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError(f"{name}: {nm} on {t.device}, expected "
                             f"{x.device} (a CUDA device)")
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name}: {nm} is {t.dtype} {tuple(t.shape)}, "
                             f"expected {dtype} {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {nm} must be contiguous")
    need, limit = ctypes.c_longlong(), _I()
    err = _lib().arms_mamba_scan_smem(P, N, chunk, x.device.index,
                                      ctypes.byref(need), ctypes.byref(limit))
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} reading the device's "
                           f"shared-memory limit")
    if need.value > limit.value:
        raise ValueError(f"{name}: P={P}, N={N}, chunk={chunk} need "
                         f"{need.value} bytes of shared memory, more than "
                         f"the {limit.value} a block may use")
    return B, S, H, P, N


def _stream(dev):
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


def _scratch(B, S, H, P, N, Q, dev):
    """cs ``[B, H, S]``, cb ``[B, S/Q, Q, Q]``, st ``[B, H, S/Q, P, N]``."""
    f = lambda *shape: torch.empty(shape, dtype=torch.float32, device=dev)
    return f(B, H, S), f(B, S // Q, Q, Q), f(B, H, S // Q, P, N)


def mamba_scan_fwd(x, dt, A, Bm, Cm, *, chunk: int):
    """-> ``(y [B, S, H, P]`` in x's dtype, ``h_final [B, H, P, N]``
    f32), ``ref.mamba_scan_ref``'s function."""
    B, S, H, P, N = _check("mamba_scan_fwd", x, dt, A, Bm, Cm, chunk)
    y = torch.empty_like(x)
    h_final = torch.empty((B, H, P, N), dtype=torch.float32, device=x.device)
    cs, cb, st = _scratch(B, S, H, P, N, chunk, x.device)
    err = _lib().arms_mamba_scan_fwd(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
        Cm.data_ptr(), y.data_ptr(), h_final.data_ptr(), cs.data_ptr(),
        cb.data_ptr(), st.data_ptr(), B, S, H, P, N, chunk,
        DTYPES[x.dtype], _stream(x.device))
    if err != 0:
        raise RuntimeError(
            f"mamba_scan forward launch failed: CUDA error {err}")
    _backend.launched("mamba_scan_fwd")
    return y, h_final


def mamba_scan_bwd(x, dt, A, Bm, Cm, dy, dh_final=None, *, chunk: int):
    """The gradient of ``mamba_scan_fwd`` under the cotangents ``dy`` (of
    y) and ``dh_final`` (of the final state; ``None``: zero) ->
    ``(dx, ddt, dA, dBm, dCm)``, dx in x's dtype, the rest f32; summed in
    f32, each element written once (repeatable bit for bit)."""
    more = {"dy": dy} if dh_final is None else {"dy": dy,
                                                "dh_final": dh_final}
    B, S, H, P, N = _check("mamba_scan_bwd", x, dt, A, Bm, Cm, chunk,
                           **more)
    if P > BWD_FRAME or chunk > BWD_FRAME:
        raise ValueError(f"mamba_scan_bwd: P={P}, chunk={chunk}: the "
                         f"backward takes P and chunk up to {BWD_FRAME}")
    dev, nc = x.device, S // chunk
    dx = torch.empty_like(x)
    ddt, dA = torch.empty_like(dt), torch.empty_like(A)
    dBm, dCm = torch.empty_like(Bm), torch.empty_like(Cm)
    cs, cb, st = _scratch(B, S, H, P, N, chunk, dev)
    du = torch.empty_like(st)
    dbp = torch.empty((B, H, S, N), dtype=torch.float32, device=dev)
    dcp = torch.empty_like(dbp)
    dap = torch.empty((B, H, nc), dtype=torch.float32, device=dev)
    err = _lib().arms_mamba_scan_bwd(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
        Cm.data_ptr(), dy.data_ptr(),
        None if dh_final is None else dh_final.data_ptr(), dx.data_ptr(),
        ddt.data_ptr(), dA.data_ptr(), dBm.data_ptr(), dCm.data_ptr(),
        cs.data_ptr(), cb.data_ptr(), st.data_ptr(), du.data_ptr(),
        dbp.data_ptr(), dcp.data_ptr(), dap.data_ptr(), B, S, H, P, N,
        chunk, DTYPES[x.dtype], _stream(dev))
    if err != 0:
        raise RuntimeError(
            f"mamba_scan backward launch failed: CUDA error {err}")
    _backend.launched("mamba_scan_bwd")
    return dx, ddt, dA, dBm, dCm
