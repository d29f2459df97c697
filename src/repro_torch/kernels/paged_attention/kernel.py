"""Wrapper of the hand-written CUDA paged decode attention (csrc/).

Replaces the Pallas TPU kernel ``repro/kernels/paged_attention/kernel.py``
(``paged_attention_kernel``); its plain version is ref.py.  One call runs
the source's decode kernel (each sequence and KV head on a thread-block
cluster) and, with ``page_mass``, its page-mass sum, on PyTorch's current
stream without synchronising, and counts one launch
(``_backend.launches["paged_attention"]``).  The wrapper checks devices,
dtypes, shapes and contiguity, allocates the output (and the per-head
page sums and the summed page mass), and raises if the launch returned an
error.  The
library is built at the first call, never at import.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import _backend

SOURCE = Path(__file__).resolve().parent / "csrc" / "paged_attention.cu"
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "arms_paged_attention": [_P] * 8 + [_I] * 7 + [_F, _I, _I, _P],
    "arms_paged_cluster": [_I] * 7 + [ctypes.POINTER(_I)],
}


def _lib():
    return _backend.library(SOURCE, _SIGNATURES)


def _shape(B, H, KV, page, dh, n_pp, dtype):
    return (B, H, KV, page, dh, n_pp, DTYPES[dtype])


def cluster_key(B, H, KV, page, dh, n_pp, dtype, device):
    """Key of a call's shape on one device in ``_backend.clusters``."""
    return _backend.cluster_key("arms_paged_cluster",
                                _shape(B, H, KV, page, dh, n_pp, dtype),
                                device)


def paged_cluster(B, H, KV, page, dh, n_pp, dtype, device) -> int:
    """CTAs a (sequence, KV head) spreads over on ``device``: the
    library's choice from the device's cluster occupancy, kept per
    shape; a shape whose CTA does not fit raises ValueError."""
    return _backend.cluster(_lib(), "arms_paged_cluster",
                            _shape(B, H, KV, page, dh, n_pp, dtype), device)


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
    if H % KV or n_pp < 1 or P < 1 or B * KV > 65535:
        raise ValueError(f"paged_attention: H={H}, KV={KV}, n_pp={n_pp}, "
                         f"P={P}, B={B} unsupported")
    cluster = paged_cluster(B, H, KV, page, dh, n_pp, q.dtype, dev)
    f32 = dict(dtype=torch.float32, device=dev)
    out = torch.empty((B, H, dh), dtype=q.dtype, device=dev)
    # per-head page sums and the maxima they are relative to; then the
    # per-head mass
    mass_h = torch.empty((2, B, n_pp, H), **f32) if page_mass else None
    mass = torch.empty((B, n_pp), **f32) if page_mass else None
    ptr = lambda t: None if t is None else t.data_ptr()
    err = _lib().arms_paged_attention(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        block_tables.data_ptr(), seq_lens.data_ptr(), out.data_ptr(),
        ptr(mass_h), ptr(mass), P, B, H, KV, page, dh, n_pp, dh ** -0.5,
        DTYPES[q.dtype], cluster,
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if err != 0:
        raise RuntimeError(
            f"paged_attention kernel launch failed: CUDA error {err}")
    _backend.launched("paged_attention")
    return (out, mass) if page_mass else out
