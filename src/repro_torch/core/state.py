"""ARMS tiering state (paper §4, §5), lane-batched.

Per-page metadata: two EWMAs, the current and previous hotness scores,
the hot age and tier residency; controller state: the Page-Hinkley test
(§4.2), the history/recency mode and the EWMA-estimated migration costs
of the cost/benefit gate (§4.3).  Every leaf carries a leading lane axis:
per-page arrays are ``[B, n]``, controller scalars ``[B]``.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.utils.pytree import tensor_dataclass
from repro_torch.utils.device import f32_on, resolve_device

MODE_HISTORY = 0
MODE_RECENCY = 1


@dataclasses.dataclass(frozen=True)
class ARMSConfig:
    """ARMS internal parameters (paper §6 "ARMS internal knobs"); the
    published values.  A sweep lane replaces a float field by a f32 [B]
    tensor (``ARMSSpec.cfg``); the int fields stay Python ints."""

    alpha_s: float = 0.7        # short-term EWMA smoothing (fast; ~1s horizon)
    alpha_l: float = 0.1        # long-term EWMA smoothing (slow; ~10s horizon)
    w_s_history: float = 0.2    # score weights in history (steady) mode
    w_l_history: float = 0.8
    w_s_recency: float = 0.8    # score weights in recency mode (§4.2)
    w_l_recency: float = 0.2
    hot_age_min: int = 2        # multi-round promotion filter (§4.3)
    # Page-Hinkley test on normalized slow-tier bandwidth (§4.2).
    pht_delta: float = 0.005    # magnitude tolerance
    pht_lambda: float = 0.10    # alarm threshold
    recency_ttl: int = 20       # intervals to stay in recency mode after alarm
    # the TTL only counts down while the slow-tier signal is no longer
    # rising (its short EWMA within eps of its long EWMA).
    stabilize_eps: float = 0.02
    # Migration scheduler (§4.4).
    bs_max: int = 64            # max pages migrated per interval (BS_max)
    # Cost model (§4.3): latencies in microseconds (per page).
    latency_fast_us: float = 0.08   # 80 ns -> per-access; used as relative ΔL
    latency_slow_us: float = 0.25
    # Accesses represented by one observed count (PEBS 1-in-10,000, §4.1).
    access_scale: float = 10_000.0
    # z-score of the Poisson noise floor subtracted from the promotion
    # benefit (§4.3 sampling-noise immunity).
    noise_z: float = 0.25
    migrate_cost_alpha: float = 0.3  # EWMA for observed migration latencies
    init_promo_cost_us: float = 50.0  # prior for a 2MB-page-equivalent move
    init_demo_cost_us: float = 50.0
    # Kept for field parity with the JAX package's config; routes nothing
    # here: the score update always goes through the interval-step op.
    use_score_kernel: bool = True

    @property
    def delta_latency(self):
        return self.latency_slow_us - self.latency_fast_us


@tensor_dataclass
class PHTState:
    """Page-Hinkley test running state (increase detection), [B] leaves."""

    n: torch.Tensor          # i32 sample count
    mean: torch.Tensor       # f32 running mean of signal
    m_t: torch.Tensor        # f32 cumulative deviation
    m_min: torch.Tensor      # f32 running min of m_t


@tensor_dataclass
class TieringState:
    """Full ARMS state over B lanes."""

    # --- per-page arrays [B, n] ---
    ewma_s: torch.Tensor     # f32
    ewma_l: torch.Tensor     # f32
    score: torch.Tensor      # f32
    prev_score: torch.Tensor  # f32
    hot_age: torch.Tensor    # i32, consecutive intervals in top-k
    in_fast: torch.Tensor    # bool, tier residency (True = fast tier)
    # --- controller scalars [B] ---
    mode: torch.Tensor       # i32, MODE_HISTORY / MODE_RECENCY
    mode_ttl: torch.Tensor   # i32, remaining recency intervals
    interval: torch.Tensor   # i32, policy interval counter
    sig_ewma_s: torch.Tensor  # f32, short EWMA of the slow-tier signal
    sig_ewma_l: torch.Tensor  # f32, long EWMA of the slow-tier signal
    promo_cost: torch.Tensor  # f32 EWMA of observed per-page promotion cost
    demo_cost: torch.Tensor   # f32 EWMA of observed per-page demotion cost
    pht: PHTState


def lane_f32(v, B: int, device):
    """A config value (Python float or f32 [B] tensor) as f32 [B]."""
    return f32_on(v, device).expand(B).clone()


def init_pht(B: int, device=None) -> PHTState:
    device = resolve_device(device)
    z = torch.zeros((B,), dtype=torch.float32, device=device)
    return PHTState(n=torch.zeros((B,), dtype=torch.int32, device=device),
                    mean=z, m_t=z.clone(), m_min=z.clone())


def init_state(B: int, n_pages: int, cfg: ARMSConfig,
               device=None) -> TieringState:
    device = resolve_device(device)
    f = torch.zeros((B, n_pages), dtype=torch.float32, device=device)
    i = lambda: torch.zeros((B,), dtype=torch.int32, device=device)
    return TieringState(
        ewma_s=f, ewma_l=f.clone(), score=f.clone(), prev_score=f.clone(),
        hot_age=torch.zeros((B, n_pages), dtype=torch.int32, device=device),
        in_fast=torch.zeros((B, n_pages), dtype=torch.bool, device=device),
        mode=i() + MODE_HISTORY, mode_ttl=i(), interval=i(),
        sig_ewma_s=torch.zeros((B,), dtype=torch.float32, device=device),
        sig_ewma_l=torch.zeros((B,), dtype=torch.float32, device=device),
        promo_cost=lane_f32(cfg.init_promo_cost_us, B, device),
        demo_cost=lane_f32(cfg.init_demo_cost_us, B, device),
        pht=init_pht(B, device))


@tensor_dataclass
class MigrationPlan:
    """Fixed-shape migration plan emitted once per policy interval (§4.4).

    ``promote[b, i]`` / ``demote[b, i]`` pair lane b's i-th hottest
    accepted candidate with its victim; ``demote == -1`` means a free
    fast-tier slot was used.  Only entries with ``valid`` are executed;
    ``count = sum(valid)``.  Entries are hottest-first and ``count`` never
    exceeds the bandwidth-aware batch size."""

    promote: torch.Tensor    # i32 [B, bs_max]
    demote: torch.Tensor     # i32 [B, bs_max]
    valid: torch.Tensor      # bool [B, bs_max]
    count: torch.Tensor      # i32 [B]
    batch_size: torch.Tensor  # i32 [B], the BS the scheduler allowed
