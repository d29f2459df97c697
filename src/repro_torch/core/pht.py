"""Page-Hinkley change-point test (paper §4.2), lane-batched.

Sequential detection of an *increase* in the slow-tier bandwidth signal:

    m_t   = m_{t-1} + (x_t - mean_t - delta)
    PH_t  = m_t - min_{i<=t} m_i
    alarm = PH_t > lambda

On alarm the test resets, so a sustained shift produces one alarm.
"""
from __future__ import annotations

import torch

from repro_torch.core.state import ARMSConfig, PHTState


def pht_update(state: PHTState, x, cfg: ARMSConfig):
    """One PHT step over [B] lanes.  Returns (new_state, alarm, stat)."""
    x = x.float()
    n = state.n + 1
    mean = state.mean + (x - state.mean) / n.float()
    m_t = state.m_t + (x - mean - cfg.pht_delta)
    m_min = torch.minimum(state.m_min, m_t)
    stat = m_t - m_min
    alarm = stat > cfg.pht_lambda
    new = PHTState(
        n=torch.where(alarm, 0, n),
        mean=torch.where(alarm, 0.0, mean),
        m_t=torch.where(alarm, 0.0, m_t),
        m_min=torch.where(alarm, 0.0, m_min))
    return new, alarm, stat
