"""Dispatch of the batched page migration: the tensor's device decides.

A pool on the CPU goes to the plain version (ref.py); a CUDA pool goes to
the hand-written kernel (kernel.py), whose wrapper raises on anything it
cannot take.  There is no switch that pins the plain version on the card
and no fallback from a failed build or launch.
"""
from __future__ import annotations

from repro_torch.kernels.migrate import kernel, ref


def _on_card(t) -> bool:
    if t.device.type in ("cuda", "cpu"):
        return t.device.type == "cuda"
    raise ValueError(f"migrate runs on cuda or cpu, not {t.device}")


def migrate(src_pool, dst_pool, src_idx, dst_idx, valid):
    """``dst_pool[dst_idx[i]] = src_pool[src_idx[i]]`` where ``valid[i]``,
    in place (``migrate/ref.py::migrate_ref``); returns ``dst_pool``."""
    if _on_card(dst_pool):
        return kernel.migrate([src_pool], [dst_pool], src_idx, dst_idx,
                              valid)[0]
    return ref.migrate_ref(src_pool, dst_pool, src_idx, dst_idx, valid)


def migrate_rows(pools, src_idx, dst_idx, valid):
    """Move rows within each pool of ``pools`` (one launch for all):
    ``pool[dst_idx[i]] = pool[src_idx[i]]`` where ``valid[i]``.  The valid
    source and destination rows must be disjoint."""
    pools = tuple(pools)
    if _on_card(pools[0]):
        kernel.migrate(pools, pools, src_idx, dst_idx, valid)
    else:
        for p in pools:
            ref.migrate_ref(p, p, src_idx, dst_idx, valid)
    return pools
