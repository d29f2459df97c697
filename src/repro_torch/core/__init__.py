"""ARMS core, lane-batched in torch: dual-EWMA hot/cold classification
(Alg. 1), Page-Hinkley change-point adaptation (§4.2), cost/benefit-gated
promotions (Alg. 2) and the bandwidth-aware batched migration scheduler
(§4.4)."""
from repro_torch.core.controller import (MODE_SAMPLING_PERIODS,
                                         arms_step_impl, policy_every,
                                         sampling_period)
from repro_torch.core.pht import pht_update
from repro_torch.core.state import (MODE_HISTORY, MODE_RECENCY, ARMSConfig,
                                    MigrationPlan, TieringState, init_state)

__all__ = [
    "ARMSConfig", "MigrationPlan", "TieringState", "arms_step_impl",
    "init_state", "pht_update", "MODE_HISTORY", "MODE_RECENCY",
    "MODE_SAMPLING_PERIODS", "sampling_period", "policy_every",
]
