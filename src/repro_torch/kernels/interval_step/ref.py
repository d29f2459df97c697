"""Plain PyTorch versions of the four interval-step kernels.

Each is the contract its CUDA kernel (kernel.py) is held to, and what the
ops run for tensors on the CPU:

  * ``topk_mask_ref`` — exact top-k mask by threshold bisection over the
    order key (32 count passes) with ``lax.top_k``'s tie rule: strictly
    greater first, then ascending index among threshold-equal values;
  * ``tier_migrate_ref`` — ``simjax.apply_tier_migrations``;
  * ``interval_account_ref`` — ``simjax.interval_accounting_impl`` plus
    the oracle recall ``count(tier == 0 & oracle) / k``;
  * ``ewma_score_update_ref`` — the dual EWMA + hotness score, with the
    FMA roundings of the JAX engine's compiled code (``fma``).
"""
from __future__ import annotations

import torch

from repro_torch.simulator import simjax


def order_key(x):
    """Order-preserving signed i32 key of f32: key(a) > key(b) iff a sorts
    above b under ``lax.top_k``'s total order on non-NaN inputs, where
    +0.0 ranks strictly above -0.0.  It is the JAX package's uint32 key
    (sign bit set: ``~u``, else ``u | 0x80000000``) with its top bit
    flipped, which torch can sort and compare as int32."""
    u = x.float().contiguous().view(torch.int32)
    return torch.where(u < 0, u ^ 0x7FFFFFFF, u)


def topk_mask_ref(x, k: int):
    """Exact top-k bool mask along the last axis of f32 ``[B, n]``."""
    n = x.shape[-1]
    if not 0 < k <= n:
        raise ValueError(f"topk_mask: k={k} outside 1..{n}")
    # bisect on the unsigned key (signed key + 2^31) in i64
    key = order_key(x).long() + (1 << 31)
    t = torch.zeros(x.shape[:-1] + (1,), dtype=torch.int64, device=x.device)
    for b in range(31, -1, -1):
        cand = t | (1 << b)
        cnt = (key >= cand).sum(dim=-1, keepdim=True)
        t = torch.where(cnt >= k, cand, t)
    greater = key > t
    eq = key == t
    need = k - greater.sum(dim=-1, keepdim=True)
    return greater | (eq & (torch.cumsum(eq.long(), dim=-1) <= need))


def tier_migrate_ref(tier, promote, demote, caps):
    """Lane-batched hop-chain migrations: tier [B, n] i32, promote [B, P]
    / demote [B, D] padded-index plans, caps [B, R] i32.  Returns (tier,
    pexec, dexec, mig_up, mig_down)."""
    return simjax.apply_tier_migrations(tier, promote, demote, caps)


def interval_account_ref(mach, true, tier, mig_up, mig_down, oracle, k: int):
    """Interval accounting + oracle recall.  ``mach`` a lane-batched
    TieredMachineSpec ([B, R] leaves); ``true`` f32 [B, n]; ``tier`` i32
    [B, n]; ``mig_up``/``mig_down`` f32 [B, R-1]; ``oracle`` bool [B, n].
    Returns (acc_fast, acc_slow, wall, slow_share, app_raw, recall), each
    f32 [B]."""
    acc_fast, acc_slow, wall, slow_share, app_raw = \
        simjax.interval_accounting_impl(mach, true, tier, mig_up, mig_down)
    hits = ((tier == 0) & oracle).sum(dim=1, dtype=torch.int32).float()
    # a tensor divisor: CUDA turns a scalar one into a reciprocal multiply
    recall = hits / torch.full_like(hits, k)
    return acc_fast, acc_slow, wall, slow_share, app_raw, recall


def fma(a, b, c):
    """f32 ``a*b + c`` rounded once, like C's ``fmaf``, on any device.

    ``a*b`` of two f32 values is exact in f64; the f64 sum is rounded to
    odd (TwoSum gives its error; an inexact even result steps one ulp
    toward the error), and rounding a round-to-odd f64 to f32 is then the
    correctly rounded f32 of the exact ``a*b + c``."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, float("inf"), float("-inf"))
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.float()


def ewma_score_update_ref(ewma_s, ewma_l, counts, params):
    """Dual EWMA + score over f32 [B, n] rows; ``params`` f32 [B, 4] holds
    each lane's (alpha_s, alpha_l, w_s, w_l).

    ``s' = fma(a_s, c, (1-a_s)*s)``, ``l'`` alike, ``score = fma(w_s, s',
    w_l*l')``: the roundings of the JAX engine, whose compiled (``jit``)
    CPU code fuses the first product of each ``x*y + z*w`` into an FMA.
    The scores feed an exact ranking, so one rounding more or less can
    move a page across the top-k boundary."""
    a_s, a_l, w_s, w_l = (params[:, i:i + 1] for i in range(4))
    s = fma(a_s.expand_as(counts), counts, (1 - a_s) * ewma_s)
    l = fma(a_l.expand_as(counts), counts, (1 - a_l) * ewma_l)
    return s, l, fma(w_s.expand_as(s), s, w_l * l)
