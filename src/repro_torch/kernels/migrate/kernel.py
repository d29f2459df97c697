"""Wrapper of the hand-written CUDA migration fire (csrc/migrate.cu).

Replaces the Pallas TPU kernel ``repro/kernels/migrate/kernel.py``
(``migrate_kernel``); its plain version is ref.py.  The wrapper checks
devices, dtypes, shapes, contiguity and pinning and raises on anything
the kernel does not take, launches on PyTorch's current stream without
synchronising, raises if the launch returned an error, and then counts
the launch (``_backend.launches["migrate"]``).  An empty plan (``k = 0``)
launches nothing and counts nothing.  The library is built at the first
call, never at import.

A home pool in pinned host memory is read and written by the stream after
the call returns.  Outside graph capture the wrapper records that use with
PyTorch's caching host allocator, as a non-blocking ``copy_`` does, so
the pinned block is not handed out again before the stream is past the
fire even if the caller drops the home at once.  A captured fire holds
raw addresses: its homes must outlive every replay, as any graph's inputs.
"""
from __future__ import annotations

import ctypes
import math
from pathlib import Path

import torch

from repro_torch.kernels import _backend

SOURCE = Path(__file__).resolve().parent / "csrc" / "migrate.cu"
MAX_POOLS = 8

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"arms_migrate_fire": [_P, _P, _P, _P, _P, _I, _P, _P, _I, _P,
                                      _P]}


def _arr(ctype, values):
    return (ctype * len(values))(*values)


def migrate_fire(fasts, homes, out_row, in_row) -> bool:
    """One fire in one launch, in place, for every pool p and slot s < k:
    ``homes[p][out_row[s]] = fasts[p][s]``, then ``fasts[p][s] =
    homes[p][in_row[s]]``; an entry that is -1 or out of range moves
    nothing.  ``fasts[p]``: a contiguous CUDA tensor ``[k, ...]``;
    ``homes[p]``: a contiguous tensor ``[n_p, ...]`` of the same dtype and
    row shape on the same card or in pinned host memory; pools may differ
    in dtype and row shape.  ``out_row``/``in_row``: contiguous i32 ``[k]``
    on the card; the valid home rows of ``out_row`` and ``in_row`` must be
    disjoint.  -> whether it launched (not where ``k = 0``)."""
    fasts, homes = list(fasts), list(homes)
    if not 1 <= len(fasts) == len(homes) <= MAX_POOLS:
        raise ValueError(f"migrate_fire: 1..{MAX_POOLS} fast/home pairs")
    dev = fasts[0].device
    k = out_row.shape[0] if out_row.dim() == 1 else -1
    for f, h in zip(fasts, homes):
        if f.device.type != "cuda" or f.device != dev:
            raise ValueError(f"migrate_fire: fast pools must be on one CUDA "
                             f"device, got {f.device}")
        if h.device.type == "cpu":
            if not h.is_pinned():
                raise ValueError("migrate_fire: a home pool on the host "
                                 "must be in pinned memory")
        elif h.device != dev:
            raise ValueError(f"migrate_fire: home pool on {h.device}, fast "
                             f"pool on {dev}")
        if h.dtype != f.dtype or h.shape[1:] != f.shape[1:] or f.dim() < 1:
            raise TypeError("migrate_fire: a home pool differs from its fast "
                            "pool in dtype or row shape")
        if not (f.is_contiguous() and h.is_contiguous()):
            raise ValueError("migrate_fire: pools must be contiguous")
        if f.shape[0] != k:
            raise ValueError(f"migrate_fire: a fast pool has {f.shape[0]} "
                             f"rows, the tables {k} entries")
        if h.shape[0] >= 2 ** 31:
            raise ValueError("migrate_fire: more than 2^31 home rows")
    for nm, t in (("out_row", out_row), ("in_row", in_row)):
        if t.device != dev or t.dtype != torch.int32 \
                or tuple(t.shape) != (k,) or not t.is_contiguous():
            raise ValueError(f"migrate_fire: {nm} must be a contiguous "
                             f"int32 [{k}] tensor on {dev}")
    if k == 0:
        return False
    launched = ctypes.c_int()
    err = _backend.library(SOURCE, _SIGNATURES).arms_migrate_fire(
        _arr(_P, [f.data_ptr() for f in fasts]),
        _arr(_P, [h.data_ptr() for h in homes]),
        _arr(_I, [int(h.device.type == "cpu") for h in homes]),
        _arr(ctypes.c_int64, [math.prod(f.shape[1:]) * f.element_size()
                              for f in fasts]),
        _arr(_I, [h.shape[0] for h in homes]), len(fasts),
        out_row.data_ptr(), in_row.data_ptr(), k, ctypes.byref(launched),
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if err != 0:
        raise RuntimeError(f"migrate kernel launch failed: CUDA error {err}")
    if not launched.value:
        return False
    _backend.launched("migrate")
    if not torch.cuda.is_current_stream_capturing():
        for h in homes:
            if h.device.type == "cpu" and h.numel():
                # a non-blocking copy_ from pinned memory records an event
                # on the home's block with the caching host allocator
                torch.empty(1, dtype=h.dtype, device=dev).copy_(
                    h.view(-1)[:1], non_blocking=True)
    return True
