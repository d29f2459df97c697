"""Plain PyTorch version of the batched page migration.

The contract of the CUDA kernel (kernel.py) and what the op runs for
tensors on the CPU: the port of ``repro/kernels/migrate/ref.py``.
"""
from __future__ import annotations

import torch


def migrate_ref(src_pool, dst_pool, src_idx, dst_idx, valid):
    """``dst_pool[dst_idx[i]] = src_pool[src_idx[i]]`` where ``valid[i]``,
    in place; returns ``dst_pool``.

    Pools ``[P, ...]`` of one dtype and row shape; ``src_idx``/``dst_idx``
    i32 ``[M]``, ``valid`` bool ``[M]``.  Invalid entries touch nothing
    (their indices may be -1), and so does an entry whose source or
    destination index is out of range.  Valid destination indices are
    unique; when ``src_pool is dst_pool`` every source row is read before
    any write.

    One ``index_select`` and one in-place ``index_copy_``, with no host
    sync (so it can be captured in a CUDA graph): invalid entries write
    row 0 with the value row 0 ends up with (a valid entry's row if one
    targets row 0, else row 0's own content), so duplicates agree.
    """
    if src_idx.shape[0] == 0:
        return dst_pool
    valid = valid.to(dst_pool.device) & (src_idx >= 0) \
        & (src_idx < src_pool.shape[0]) & (dst_idx >= 0) \
        & (dst_idx < dst_pool.shape[0])
    rows = src_pool.index_select(0, torch.where(valid, src_idx, 0).long())
    at = torch.where(valid, dst_idx, 0).long()
    hit0 = valid & (at == 0)
    row0 = torch.where(hit0.any(),
                       rows.index_select(0, hit0.int().argmax().view(1))[0],
                       dst_pool.index_select(0, at[:1] * 0)[0])
    keep = valid.view((-1,) + (1,) * (rows.dim() - 1))
    return dst_pool.index_copy_(0, at, torch.where(keep, rows, row0))
