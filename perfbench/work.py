"""The least work of the four interval-step functions, from their shapes,
and the card's published peaks.

Each function's work is what its inputs and outputs require: every input
byte read once and every output byte written once (a row shared by every
lane, stride 0, once), and the arithmetic each output element needs.  It
does not depend on how a kernel computes it, so a kernel that is fused,
split or replaced is judged against the same work.

Peaks: NVIDIA H100 SXM data sheet, at its 700 W limit: 3.35 TB/s of HBM3
and 67 TFLOP/s of f32 outside the tensor cores (the four functions are
f32 or integer work).
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


def rows(t) -> int:
    """Rows of a [B, n] operand that hold distinct data."""
    return 1 if t.dim() == 2 and t.shape[0] > 1 and t.stride(0) == 0 \
        else t.shape[0]


def ewma_update(ewma_s, ewma_l, counts, params):
    """Dual EWMA + score: three f32 [B, n] rows and a [B, 4] block in,
    three rows out; ``s = fma(a, c, (1-a) s)``, ``l`` alike, ``score =
    fma(w_s, s, w_l l)``: 9 operations an element."""
    B, n = ewma_s.shape
    return 6 * 4 * B * n + 4 * params.numel(), 9 * B * n


def topk_mask(x, k):
    """Top-k mask: an f32 [B, n] row in, a bool row out; one comparison
    an element against the k-th value."""
    B, n = x.shape
    return 4 * rows(x) * n + B * n, B * n


def tier_migrate(tier, promote, demote, caps):
    """Plans on i32 [B, n] tier rows: the row in and out, the plans, the
    capacities; executed masks [B, P + D] and i32 [B, R-1] counts out."""
    B, n = tier.shape
    P, D, R = promote.shape[1], demote.shape[1], caps.shape[-1]
    return (2 * 4 * B * n + 4 * B * (P + D) + 4 * B * R + B * (P + D)
            + 2 * 4 * B * (R - 1)), B * (P + D)


def interval_account(lat, br, bw, mlp, true, tier, mig_up, mig_down, oracle,
                     k):
    """Accounting: f32 true rows, i32 tier rows and bool oracle rows in
    (shared rows once), the machine leaves and migration counts, six f32
    [B] out; a comparison and two sums an element."""
    B, n = tier.shape
    R = lat.shape[-1]
    return (4 * rows(true) * n + 4 * B * n + rows(oracle) * n
            + 4 * B * (3 * R + 1) + 2 * 4 * B * (R - 1) + 6 * 4 * B), 3 * B * n


#: function -> (work from its arguments, its kernels' names)
FUNCTIONS = {
    "ewma_update": (ewma_update, ("ewma_update_kernel",)),
    "topk_mask": (topk_mask, ("topk_mask_kernel",)),
    "tier_migrate": (tier_migrate, ("tier_migrate_kernel",
                                    "tier_migrate_wide_kernel")),
    "interval_account": (interval_account, ("interval_account_kernel",)),
}


def least_s(bytes_: int, ops: int) -> float:
    return max(bytes_ / HBM_BYTES_PER_S, ops / F32_OPS_PER_S)
