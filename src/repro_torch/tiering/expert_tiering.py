"""Policy-tiered MoE expert weights, in torch.

The port of ``repro/tiering/expert_tiering.py``.  Pages = expert weight
slabs.  Access counts = router load (tokens dispatched per expert per
step), exact, not sampled.  The placement policy (default ARMS, any
``experiment.POLICY_REGISTRY`` family through the shared ``tiered_pool``
executor) keeps the hot experts' slabs resident in the fast pool of
``fast_experts`` slots and the long tail in the slow tier; hot-age
filtering suppresses thrash from bursty routing (the paper's one-hit
wonders, §4.3).

Layout: each weight is ONE tensor ``[Kf + E, ...]``, the Kf fast slots
first, then the home copy of every expert (the JAX package keeps
``wi_fast``/``wi_slow`` apart; those names are views here).  The home
copy is authoritative, so demotion is metadata-only (``copy_back=False``)
and a promotion copies the slab up through the ``migrate`` op (the
hand-written CUDA kernel on the card).  ``wi`` (``[D, 2F]``) and ``wo``
(``[F, D]``) differ in row shape, so a fire is one launch a weight.
The measured per-tier read volume, the bytes ``effective_weights`` pulls
from each tier for the experts actually dispatched, feeds the pool's
application-bandwidth signal.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.state import ARMSConfig
from repro_torch.tiering import tiered_pool as TP
from repro_torch.utils.device import resolve_device
from repro_torch.utils.pytree import tensor_dataclass


@dataclasses.dataclass(frozen=True)
class ExpertTierConfig:
    n_experts: int
    fast_experts: int
    policy_every: int = 4
    # dLatency: fetching an expert slab over PCIe (~25 GB/s) vs HBM — e.g.
    # a 47 MB deepseek expert: ~1.9 ms vs ~60 us; one "access" = one step's
    # dispatch to that expert.
    arms: ARMSConfig = ARMSConfig(access_scale=1.0, latency_fast_us=60.0,
                                  latency_slow_us=1900.0,
                                  init_promo_cost_us=200.0,
                                  init_demo_cost_us=200.0, bs_max=8)
    machine: str = TP.DEFAULT_MACHINE


@tensor_dataclass
class ExpertTier:
    wi: torch.Tensor         # [Kf + E, D, 2F]: fast slots, then home rows
    wo: torch.Tensor         # [Kf + E, F, D]
    pool: TP.TieredPool

    @property
    def fast_experts(self) -> int:
        return self.wi.shape[0] - self.pool.in_fast.shape[0]

    @property
    def wi_fast(self):
        return self.wi[:self.fast_experts]

    @property
    def wi_slow(self):
        return self.wi[self.fast_experts:]

    @property
    def wo_fast(self):
        return self.wo[:self.fast_experts]

    @property
    def wo_slow(self):
        return self.wo[self.fast_experts:]

    @property
    def in_fast(self):
        return self.pool.in_fast

    @property
    def slot(self):
        return self.pool.slot

    @property
    def counts(self):
        return self.pool.counts


def expert_slab_bytes(t: ExpertTier) -> float:
    """Bytes of one expert's (wi, wo) slab: the per-tier read-volume and
    migration-traffic unit."""
    return float(t.wi[0].numel() * t.wi.element_size()
                 + t.wo[0].numel() * t.wo.element_size())


def init_expert_tier(cfg: ExpertTierConfig, wi, wo, policy="arms",
                     device=None) -> ExpertTier:
    """``wi`` ``[E, D, 2F]`` and ``wo`` ``[E, F, D]``: the home copies,
    copied into the fused pools (the fast slots start zero)."""
    device = resolve_device(device)
    E, Kf = cfg.n_experts, cfg.fast_experts
    pool = TP.init_pool(policy, E, Kf, machine=cfg.machine,
                        arms_cfg=cfg.arms, pool_every=cfg.policy_every,
                        device=device)

    def fused(home):
        out = torch.zeros((Kf + E,) + tuple(home.shape[1:]),
                          dtype=home.dtype, device=device)
        out[Kf:].copy_(home)
        return out

    return ExpertTier(wi=fused(wi), wo=fused(wo), pool=pool)


def effective_weights(t: ExpertTier):
    """``[E, ...]`` copies: resident experts read the fast pool, the rest
    their home rows (the per-tier read split is the serving cost
    signal)."""
    Kf = t.fast_experts
    home = Kf + torch.arange(t.in_fast.shape[0], dtype=torch.int32,
                             device=t.wi.device)
    rows = torch.where(t.in_fast, t.slot.clamp(0, Kf - 1), home).long()
    return t.wi.index_select(0, rows), t.wo.index_select(0, rows)


def read_volumes(t: ExpertTier, expert_load):
    """(fast_bytes, slow_bytes) for one step: each DISPATCHED expert
    (load > 0) reads its slab once from its tier."""
    hit = expert_load > 0
    sb = expert_slab_bytes(t)
    fast = (hit & t.in_fast).sum().float() * sb
    slow = (hit & ~t.in_fast).sum().float() * sb
    return fast, slow


def observe_and_policy(t: ExpertTier, expert_load, cfg: ExpertTierConfig):
    """Accumulate router load; when the policy is due, run it and execute
    the plan through the shared pool executor (promotions copy slabs in
    place).  Returns (tier, PoolPlan)."""
    expert_load = expert_load.float()
    rf, rs = read_volumes(t, expert_load)
    pool, _, plan = TP.pool_step(
        t.pool, expert_load, rf, rs, k=cfg.fast_experts, bufs=(t.wi, t.wo),
        copy_back=False, page_bytes=expert_slab_bytes(t))
    return t.replace(pool=pool), plan
