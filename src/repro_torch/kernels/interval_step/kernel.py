"""Wrappers of the hand-written CUDA interval-step kernels (csrc/).

One wrapper per kernel of ``csrc/interval_step.cu``; each replaces a
Pallas TPU kernel of ``repro/kernels/interval_step/kernel.py`` and has
its plain version in ref.py.  A wrapper checks device, dtype, shape and
contiguity and raises on anything its kernel does not take, allocates the
outputs, launches on PyTorch's current stream without synchronising,
raises if the launch returned an error, and then counts the launch
(``_backend.launches``).  The library is built at the first call, never
at import.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import _backend

SOURCE = Path(__file__).resolve().parent / "csrc" / "interval_step.cu"
MAX_TIERS = 8

_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_SIGNATURES = {
    "arms_ewma_update": [_P] * 7 + [_I, _I, _P],
    "arms_interval_account": [_P] * 5 + [_I64] + [_P] * 4 + [_I64, _P]
    + [_I] * 5 + [_P],
    "arms_account_cluster": [_I, _I, ctypes.POINTER(_I)],
    "arms_tier_migrate": [_P] * 9 + [_I] * 6 + [_P],
    "arms_migrate_cluster": [_I, _I, ctypes.POINTER(_I)],
    "arms_topk_mask": [_P, _P, _I, _I, _I, _I, _P],
    "arms_topk_cluster": [_I, _I, ctypes.POINTER(_I)],
}


def _lib():
    return _backend.library(SOURCE, _SIGNATURES)


def _stream(t):
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _check(name, t, dtype, shape=None, device=None):
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _row_stride(name, t, B, n):
    """Lane stride of a [B, n] row operand: n, or 0 for one row broadcast
    to every lane (``expand``); the page axis must be contiguous."""
    if tuple(t.shape) != (B, n):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {(B, n)}")
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if n > 1 and t.stride(1) != 1 or (B > 1 and t.stride(0) not in (0, n)):
        raise ValueError(f"{name}: needs unit page stride and lane stride "
                         f"0 or n, got {t.stride()}")
    return t.stride(0) if B > 1 else n


def _done(name, err):
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    _backend.launched(name)


def ewma_update(ewma_s, ewma_l, counts, params):
    """Dual EWMA + score on the card: rows f32 [B, n], ``params`` f32
    [B, 4] = (alpha_s, alpha_l, w_s, w_l) per lane."""
    B, n = ewma_s.shape
    dev = ewma_s.device
    for nm, t in (("ewma_s", ewma_s), ("ewma_l", ewma_l), ("counts", counts)):
        _check(nm, t, torch.float32, (B, n), dev)
    _check("params", params, torch.float32, (B, 4), dev)
    outs = [torch.empty_like(ewma_s) for _ in range(3)]
    err = _lib().arms_ewma_update(
        params.data_ptr(), ewma_s.data_ptr(), ewma_l.data_ptr(),
        counts.data_ptr(), *(o.data_ptr() for o in outs), B, n,
        _stream(ewma_s))
    _done("ewma_update", err)
    return tuple(outs)


def interval_account(lat, br, bw, mlp, true, tier, mig_up, mig_down, oracle,
                     k: int):
    """Interval accounting + recall on the card: lat/br/bw f32 [B, R], mlp
    f32 [B], true f32 [B, n] and oracle bool [B, n] (lane stride n or 0),
    tier i32 [B, n], mig_up/mig_down f32 [B, R-1].  Returns the six f32
    [B] outputs of ``ref.interval_account_ref``."""
    B, n = tier.shape
    R = lat.shape[-1]
    dev = tier.device
    if not 2 <= R <= MAX_TIERS:
        raise ValueError(
            f"interval_account: {R} tiers, supports 2..{MAX_TIERS}")
    if not 0 < k <= n:
        raise ValueError(f"interval_account: k={k} outside 1..{n}")
    for nm, t in (("lat", lat), ("bw_read", br), ("bw_write", bw)):
        _check(nm, t, torch.float32, (B, R), dev)
    _check("mlp", mlp, torch.float32, (B,), dev)
    _check("tier", tier, torch.int32, (B, n), dev)
    _check("mig_up", mig_up, torch.float32, (B, R - 1), dev)
    _check("mig_down", mig_down, torch.float32, (B, R - 1), dev)
    if true.dtype != torch.float32 or oracle.dtype != torch.bool:
        raise TypeError("interval_account: true must be f32, oracle bool")
    t_stride = _row_stride("true", true, B, n)
    o_stride = _row_stride("oracle", oracle, B, n)
    out = torch.empty((B, 6), dtype=torch.float32, device=dev)
    err = _lib().arms_interval_account(
        lat.data_ptr(), br.data_ptr(), bw.data_ptr(), mlp.data_ptr(),
        true.data_ptr(), t_stride, tier.data_ptr(), mig_up.data_ptr(),
        mig_down.data_ptr(), oracle.data_ptr(), o_stride, out.data_ptr(),
        B, n, R, k, account_cluster(B, n, dev), _stream(tier))
    _done("interval_account", err)
    return tuple(out[:, i] for i in range(6))


def tier_migrate(tier, promote, demote, caps):
    """Hop-chain migrations on the card: tier i32 [B, n], promote i32
    [B, P], demote i32 [B, D] (padded-index plans of any width, valid
    entries unique), caps i32 [B, R].  Returns (tier, pexec, dexec, mig_up,
    mig_down); the input row is not changed.  Plans of at most 1,024
    entries are staged in shared memory, wider ones streamed (csrc)."""
    B, n = tier.shape
    P, D, R = promote.shape[1], demote.shape[1], caps.shape[-1]
    dev = tier.device
    if not 2 <= R <= MAX_TIERS:
        raise ValueError(f"tier_migrate: {R} tiers, supports 2..{MAX_TIERS}")
    _check("tier", tier, torch.int32, (B, n), dev)
    _check("promote", promote, torch.int32, (B, P), dev)
    _check("demote", demote, torch.int32, (B, D), dev)
    _check("caps", caps, torch.int32, (B, R), dev)
    new_tier = torch.empty_like(tier)
    pexec = torch.empty((B, P), dtype=torch.bool, device=dev)
    dexec = torch.empty((B, D), dtype=torch.bool, device=dev)
    mig_up = torch.empty((B, R - 1), dtype=torch.int32, device=dev)
    mig_down = torch.empty((B, R - 1), dtype=torch.int32, device=dev)
    err = _lib().arms_tier_migrate(
        tier.data_ptr(), promote.data_ptr(), demote.data_ptr(),
        caps.data_ptr(), new_tier.data_ptr(), pexec.data_ptr(),
        dexec.data_ptr(), mig_up.data_ptr(), mig_down.data_ptr(), B, n, R,
        P, D, migrate_cluster(B, n, dev), _stream(tier))
    _done("tier_migrate", err)
    return new_tier, pexec, dexec, mig_up, mig_down


def cluster_key(kind: str, B: int, n: int, device) -> tuple:
    """Key of ``_backend.clusters`` for the ``kind`` kernel (``topk``,
    ``account`` or ``migrate``) at B lanes of n pages on ``device``."""
    return _backend.cluster_key(f"arms_{kind}_cluster", (B, n), device)


def _cluster(kind: str, B: int, n: int, device) -> int:
    return _backend.cluster(_lib(), f"arms_{kind}_cluster", (B, n), device)


def topk_cluster(B: int, n: int, device) -> int:
    """CTAs a row of the top-k kernel spreads over on ``device``."""
    return _cluster("topk", B, n, device)


def account_cluster(B: int, n: int, device) -> int:
    """CTAs a lane of the accounting kernel spreads over on ``device``."""
    return _cluster("account", B, n, device)


def migrate_cluster(B: int, n: int, device) -> int:
    """CTAs a lane of the migration kernel spreads over on ``device``."""
    return _cluster("migrate", B, n, device)


def topk_mask(x, k: int):
    """Exact top-k bool mask of f32 [B, n] rows on the card."""
    B, n = x.shape
    if not 0 < k <= n:
        raise ValueError(f"topk_mask: k={k} outside 1..{n}")
    _check("x", x, torch.float32, (B, n))
    mask = torch.empty((B, n), dtype=torch.bool, device=x.device)
    err = _lib().arms_topk_mask(x.data_ptr(), mask.data_ptr(), B, n, k,
                                topk_cluster(B, n, x.device), _stream(x))
    _done("topk_mask", err)
    return mask
