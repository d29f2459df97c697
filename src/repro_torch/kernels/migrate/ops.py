"""Dispatch of the migration fire: the fast pool's device decides.

A fast pool on the CPU goes to the plain version (ref.py); a fast pool on
the card goes to the hand-written kernel (kernel.py), whatever its home
pool is (on the card, or pinned on the host), and the wrapper raises on
anything it cannot take.  There is no switch that pins the plain version
on the card and no fallback from a failed build or launch.
"""
from __future__ import annotations

from repro_torch.kernels.migrate import kernel, ref


def migrate_fire(fasts, homes, out_row, in_row) -> None:
    """One fire of the tiered pool, in place, for every pool p and fast
    slot s: ``homes[p][out_row[s]] = fasts[p][s]`` (the demotions'
    copy-back), then ``fasts[p][s] = homes[p][in_row[s]]`` (the
    promotions); -1 or out-of-range entries move nothing
    (``ref.migrate_fire_ref``).  On the card: one launch for every pool."""
    fasts, homes = list(fasts), list(homes)
    if not fasts:
        return
    dev = fasts[0].device
    if dev.type == "cuda":
        kernel.migrate_fire(fasts, homes, out_row, in_row)
        return
    if dev.type != "cpu":
        raise ValueError(f"migrate runs on cuda or cpu, not {dev}")
    for t in fasts + homes + [out_row, in_row]:
        if t.device.type != "cpu":
            raise ValueError(f"migrate_fire: a fast pool on the CPU beside "
                             f"a tensor on {t.device}")
    ref.migrate_fire_ref(fasts, homes, out_row, in_row)
