"""Wrapper of the hand-written CUDA paged decode attention (csrc/).

Replaces the Pallas TPU kernel ``repro/kernels/paged_attention/kernel.py``
(``paged_attention_kernel``); its plain version is ref.py.  One call runs
the source's three kernels (per-page partials, combine, page mass) on
PyTorch's current stream without synchronising and counts one launch
(``_backend.launches["paged_attention"]``).  The wrapper checks devices,
dtypes, shapes and contiguity, allocates the output and the f32 scratch,
and raises if the launch returned an error.  The library is built at the
first call, never at import.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import _backend

SOURCE = Path(__file__).resolve().parent / "csrc" / "paged_attention.cu"
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
SMEM_BYTES = 48 * 1024   # static shared-memory limit of a block

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {"arms_paged_attention": [_P] * 11 + [_I] * 7 + [_F, _I, _P]}


def paged_attention(q, k_pages, v_pages, block_tables, seq_lens, *,
                    page_mass: bool = False):
    """See ``ref.paged_attention_ref``: q ``[B, H, dh]``, pools
    ``[P, page, KV, dh]`` of q's dtype, tables i32 ``[B, n_pp]``, lens i32
    ``[B]``, all contiguous on one CUDA device.  Table entries out of the
    pools' range are clamped into it."""
    B, H, dh = q.shape
    P, page, KV, dh_k = k_pages.shape
    n_pp = block_tables.shape[1]
    dev = q.device
    if q.dtype not in DTYPES:
        raise TypeError(f"paged_attention: dtype {q.dtype}, expected f32 "
                        f"or bf16")
    for nm, t, dt, shape in (
            ("q", q, q.dtype, (B, H, dh)),
            ("k_pages", k_pages, q.dtype, (P, page, KV, dh)),
            ("v_pages", v_pages, q.dtype, (P, page, KV, dh)),
            ("block_tables", block_tables, torch.int32, (B, n_pp)),
            ("seq_lens", seq_lens, torch.int32, (B,))):
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"paged_attention: {nm} on {t.device}, "
                             f"expected {dev}")
        if t.dtype != dt or tuple(t.shape) != shape:
            raise ValueError(f"paged_attention: {nm} is {t.dtype} "
                             f"{tuple(t.shape)}, expected {dt} {shape}")
        if not t.is_contiguous():
            raise ValueError(f"paged_attention: {nm} must be contiguous")
    if H % KV or n_pp < 1 or B * KV > 65535:
        raise ValueError(f"paged_attention: H={H}, KV={KV}, n_pp={n_pp}, "
                         f"B={B} unsupported")
    rep = H // KV
    if 4 * rep * (dh + page) > SMEM_BYTES or 4 * n_pp > SMEM_BYTES:
        raise ValueError("paged_attention: rep, head_dim, page or table "
                         "too large for one block's shared memory")
    f32 = dict(dtype=torch.float32, device=dev)
    out = torch.empty((B, H, dh), dtype=q.dtype, device=dev)
    m_buf = torch.empty((B, H, n_pp), **f32)
    l_buf = torch.empty((B, H, n_pp), **f32)
    acc = torch.empty((B, H, n_pp, dh), **f32)
    mass_h = torch.empty((B, H, n_pp), **f32) if page_mass else None
    mass = torch.empty((B, n_pp), **f32) if page_mass else None
    ptr = lambda t: None if t is None else t.data_ptr()
    err = _backend.library(SOURCE, _SIGNATURES).arms_paged_attention(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        block_tables.data_ptr(), seq_lens.data_ptr(), out.data_ptr(),
        m_buf.data_ptr(), l_buf.data_ptr(), acc.data_ptr(), ptr(mass_h),
        ptr(mass), P, B, H, KV, page, dh, n_pp, dh ** -0.5, DTYPES[q.dtype],
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if err != 0:
        raise RuntimeError(
            f"paged_attention kernel launch failed: CUDA error {err}")
    _backend.launched("paged_attention")
    return (out, mass) if page_mass else out
