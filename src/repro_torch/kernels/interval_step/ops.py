"""Dispatch of the interval-step ops: the tensor's device decides.

A tensor on the CPU goes to the plain version (ref.py); a CUDA tensor
goes to the hand-written kernel (kernel.py), whose wrapper raises on
anything it cannot take.  There is no switch that pins the plain version
on the card and no fallback from a failed build or launch.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.interval_step import kernel, ref
from repro_torch.utils.device import f32_on


def _on_card(t) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"interval_step ops run on cuda or cpu, not {t.device}")


def topk_mask(x, k: int):
    """Exact top-k bool mask of f32 [B, n] rows (``lax.top_k`` tie rule)."""
    if _on_card(x):
        return kernel.topk_mask(x, k)
    return ref.topk_mask_ref(x, k)


def tier_migrate(tier, promote, demote, caps):
    """Lane-batched hop-chain migrations (``simjax.apply_tier_migrations``).

    Contract: valid (non ``-1``) entries within each lane's plan are
    unique page indices (the padded-index contract)."""
    if _on_card(tier):
        return kernel.tier_migrate(tier, promote, demote, caps)
    return ref.tier_migrate_ref(tier, promote, demote, caps)


def interval_account(mach, true, tier, mig_up, mig_down, oracle, k: int):
    """Interval accounting + oracle recall over lane-batched rows; ``mach``
    is a lane-batched TieredMachineSpec.  ``true``/``oracle`` may be one
    row expanded to every lane."""
    if _on_card(tier):
        return kernel.interval_account(
            mach.lat_ns, mach.bw_read, mach.bw_write, mach.mlp, true, tier,
            mig_up, mig_down, oracle, k)
    return ref.interval_account_ref(mach, true, tier, mig_up, mig_down,
                                    oracle, k)


def _ewma_params(alpha_s, alpha_l, w_s, w_l, B: int, device):
    """Per-lane f32 [B, 4] parameter block; each value a Python float or
    a [B] tensor."""
    return torch.stack(
        [f32_on(v, device).expand(B)
         for v in (alpha_s, alpha_l, w_s, w_l)], dim=1).contiguous()


def ewma_score_update(ewma_s, ewma_l, counts, *, alpha_s, alpha_l, w_s, w_l):
    """Lane-batched dual-EWMA + hotness score ([B, n] rows; params Python
    floats or [B] tensors)."""
    params = _ewma_params(alpha_s, alpha_l, w_s, w_l, ewma_s.shape[0],
                          ewma_s.device)
    if _on_card(ewma_s):
        return kernel.ewma_update(ewma_s, ewma_l, counts, params)
    return ref.ewma_score_update_ref(ewma_s, ewma_l, counts, params)
