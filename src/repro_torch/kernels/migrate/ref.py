"""Plain PyTorch version of the migration fire.

The contract of the CUDA kernel (kernel.py) and what the op runs for
tensors on the CPU.  ``migrate_ref`` is the port of
``repro/kernels/migrate/ref.py`` (one batch of row moves);
``migrate_fire_ref`` is a fire of the tiered pool built from two of them,
the demotions' copy-back first, as ``repro/tiering/tiered_pool.py``'s
``move`` does on its separate fast and slow arrays.
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


def migrate_fire_ref(fasts, homes, out_row, in_row):
    """For every pool p and slot s < k, in place: ``homes[p][out_row[s]] =
    fasts[p][s]``, then ``fasts[p][s] = homes[p][in_row[s]]``; an entry that
    is -1 or out of range moves nothing.  Pools and tables on one device
    (kernel.py's contract otherwise); no host sync."""
    k = out_row.shape[0]
    if k == 0:
        return
    slots = torch.arange(k, dtype=torch.int32, device=out_row.device)
    for fast, home in zip(fasts, homes):
        migrate_ref(fast, home, slots, out_row, out_row >= 0)
        migrate_ref(home, fast, in_row, slots, in_row >= 0)
