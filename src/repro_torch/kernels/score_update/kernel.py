"""Wrapper of the single-row score update on the card.

Replaces the Pallas TPU kernel ``repro/kernels/score_update/kernel.py``
(``score_update_kernel``).  Its function is one lane of the interval
step's dual EWMA, so it launches that hand-written kernel
(``arms_ewma_update`` of ``interval_step/csrc/interval_step.cu``) with one
lane: the rows viewed as ``[1, n]``, the parameters as ``[1, 4]``.  The
plain version is ``interval_step.ref.ewma_score_update_ref`` on the same
views.  The wrapper checks device, dtype, shape and contiguity, allocates
the outputs, launches on PyTorch's current stream without synchronising,
raises if the launch returned an error and then counts it
(``_backend.launches["score_update"]``).  The library is built at the
first call, never at import.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.interval_step import kernel as ikernel


def score_update(ewma_s, ewma_l, counts, params):
    """-> ``(ewma_s', ewma_l', score)`` f32 ``[n]`` on the card; rows f32
    ``[n]``, ``params`` f32 ``(4,)`` = (alpha_s, alpha_l, w_s, w_l)."""
    n = ewma_s.shape[0] if ewma_s.dim() == 1 else -1
    dev = ewma_s.device
    for nm, t, shape in (("ewma_s", ewma_s, (n,)), ("ewma_l", ewma_l, (n,)),
                         ("counts", counts, (n,)), ("params", params, (4,))):
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"score_update: {nm} on {t.device}, expected "
                             f"{dev} (a CUDA device)")
        if t.dtype != torch.float32:
            raise TypeError(f"score_update: {nm} is {t.dtype}, expected f32")
        if tuple(t.shape) != shape or n < 1:
            raise ValueError(f"score_update: {nm} has shape "
                             f"{tuple(t.shape)}, expected {shape}, n >= 1")
        if not t.is_contiguous():
            raise ValueError(f"score_update: {nm} must be contiguous")
    outs = [torch.empty_like(ewma_s) for _ in range(3)]
    err = ikernel._lib().arms_ewma_update(
        params.data_ptr(), ewma_s.data_ptr(), ewma_l.data_ptr(),
        counts.data_ptr(), *(o.data_ptr() for o in outs), 1, n,
        ikernel._stream(ewma_s))
    ikernel._done("score_update", err)
    return tuple(outs)
