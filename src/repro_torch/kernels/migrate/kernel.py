"""Wrapper of the hand-written CUDA batched page migration (csrc/).

Replaces the Pallas TPU kernel ``repro/kernels/migrate/kernel.py``
(``migrate_kernel``); its plain version is ref.py.  The wrapper checks
devices, dtypes, shapes and contiguity and raises on anything the kernel
does not take, launches on PyTorch's current stream without
synchronising, raises if the launch returned an error, and then counts
the launch (``_backend.launches["migrate"]``).  ``M = 0`` launches
nothing and counts nothing.  The library is built at the first call,
never at import.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import _backend

SOURCE = Path(__file__).resolve().parent / "csrc" / "migrate.cu"
MAX_POOLS = 4
MAX_ENTRIES = 65535

_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_SIGNATURES = {"arms_migrate": [_P, _P, _I, _P, _P, _P, _I, _I64, _I, _I,
                                 _P]}


def migrate(srcs, dsts, src_idx, dst_idx, valid):
    """``dsts[p][dst_idx[i]] = srcs[p][src_idx[i]]`` where ``valid[i]``, for
    every pool pair p, in one launch; the destinations are updated in
    place.  Pools: contiguous CUDA tensors ``[P, ...]`` of one dtype and
    one row shape (a pool may be its own source); every source pool has
    the same row count, and every destination pool.  Entries with an
    index out of range are skipped like invalid ones."""
    srcs, dsts = list(srcs), list(dsts)
    if not 1 <= len(srcs) == len(dsts) <= MAX_POOLS:
        raise ValueError(f"migrate: 1..{MAX_POOLS} source/destination pairs")
    row = srcs[0].shape[1:]
    dev = srcs[0].device
    for t in srcs + dsts:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"migrate: pools must be on one CUDA device, "
                             f"got {t.device}")
        if t.dtype != srcs[0].dtype or t.shape[1:] != row:
            raise TypeError("migrate: pools differ in dtype or row shape")
        if not t.is_contiguous():
            raise ValueError("migrate: pools must be contiguous")
    if len({t.shape[0] for t in srcs}) > 1 \
            or len({t.shape[0] for t in dsts}) > 1:
        raise ValueError("migrate: source (or destination) pools differ in "
                         "row count")
    M = src_idx.shape[0]
    for nm, t, dt in (("src_idx", src_idx, torch.int32),
                      ("dst_idx", dst_idx, torch.int32),
                      ("valid", valid, torch.bool)):
        if t.device != dev or t.dtype != dt or tuple(t.shape) != (M,) \
                or not t.is_contiguous():
            raise ValueError(f"migrate: {nm} must be a contiguous {dt} "
                             f"[{M}] tensor on {dev}")
    if M > MAX_ENTRIES:
        raise ValueError(f"migrate: {M} entries > {MAX_ENTRIES}")
    if M == 0:
        return dsts
    row_bytes = srcs[0][0].numel() * srcs[0].element_size()
    ptrs = lambda ts: (ctypes.c_void_p * len(ts))(*(t.data_ptr() for t in ts))
    err = _backend.library(SOURCE, _SIGNATURES).arms_migrate(
        ptrs(srcs), ptrs(dsts), len(srcs), src_idx.data_ptr(),
        dst_idx.data_ptr(), valid.data_ptr(), M, row_bytes, srcs[0].shape[0],
        dsts[0].shape[0], ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if err != 0:
        raise RuntimeError(f"migrate kernel launch failed: CUDA error {err}")
    _backend.launched("migrate")
    return dsts
