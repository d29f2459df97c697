"""Threshold-free hot/cold page classification (paper §4.1, Algorithm 1).

Two EWMAs per page, with the prose semantics of the paper
(``EWMA <- alpha * accesses + (1 - alpha) * EWMA``, so alpha_s = 0.7
reacts fast and alpha_l = 0.1 tracks the long horizon; DESIGN.md §1).
Pages are ranked by score and the top-k (k = fast-tier capacity) form
the hot set; ``hot_age`` counts consecutive intervals in the top-k.

Both hot paths go through the interval-step ops: the score update through
``ewma_score_update`` and the hot mask through ``topk_mask`` — the exact
``lax.top_k`` + scatter mask, without a sort.
"""
from __future__ import annotations

import torch

from repro_torch.core.state import MODE_RECENCY, ARMSConfig, TieringState
from repro_torch.kernels.interval_step import ops
from repro_torch.utils.device import f32_on


def _sel(pred, a, b):
    """``jnp.where(pred, a, b)`` for config values (floats or [B])."""
    return torch.where(pred, f32_on(a, pred.device), f32_on(b, pred.device))


def score_weights(cfg: ARMSConfig, mode):
    """(w_s, w_l) per lane; recency mode prioritizes the short EWMA."""
    recency = mode == MODE_RECENCY
    return (_sel(recency, cfg.w_s_recency, cfg.w_s_history),
            _sel(recency, cfg.w_l_recency, cfg.w_l_history))


def update_scores(state: TieringState, access_counts, cfg: ARMSConfig,
                  mode) -> TieringState:
    """Algorithm 1 lines 1-6: EWMA + hotness score update."""
    w_s, w_l = score_weights(cfg, mode)
    ewma_s, ewma_l, score = ops.ewma_score_update(
        state.ewma_s, state.ewma_l, access_counts.float(),
        alpha_s=cfg.alpha_s, alpha_l=cfg.alpha_l, w_s=w_s, w_l=w_l)
    return state.replace(ewma_s=ewma_s, ewma_l=ewma_l,
                         prev_score=state.score, score=score)


def topk_hot_mask(score, k: int):
    """Bool [B, n] mask of each lane's top-k pages by score (Algorithm 1
    lines 7-9); ties by ascending page index, as ``lax.top_k``."""
    return ops.topk_mask(score, min(int(k), score.shape[-1]))


def update_hot_age(state: TieringState, hot_mask) -> TieringState:
    """Algorithm 1 lines 10-12."""
    return state.replace(hot_age=torch.where(hot_mask, state.hot_age + 1, 0))
