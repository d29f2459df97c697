"""Policy-tiered embedding rows, in torch.

The port of ``repro/tiering/embedding_tiering.py``.  Pages = blocks of
vocabulary rows (``row_block`` rows).  Access counts = token frequency
histograms from the request stream, Zipfian in practice, so a small
fast-resident hot set serves almost all lookups (the 202k-row llama4
table at bf16 x 5120 is ~2 GB per replica).

Placement runs through the shared ``tiered_pool`` executor (any
``experiment.POLICY_REGISTRY`` family; default ARMS with the serving
semantics).  It is metadata-only: the home table is authoritative and
the fast tier a cache of blocks, so the pool moves no buffers
(``bufs=()``); residency prices lookups through the measured per-tier
read volumes (rows touched x row bytes, split by block tier).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.state import ARMSConfig
from repro_torch.tiering import tiered_pool as TP
from repro_torch.utils.device import f32_on, resolve_device
from repro_torch.utils.pytree import tensor_dataclass


@dataclasses.dataclass(frozen=True)
class EmbedTierConfig:
    vocab: int
    row_block: int = 256
    fast_blocks: int = 32
    policy_every: int = 16
    # dLatency: a 256-row block over PCIe (~2.6 MB at d=5120) ~100 us vs
    # ~3 us from HBM; one access = one token lookup in the block.
    arms: ARMSConfig = ARMSConfig(access_scale=1.0, latency_fast_us=3.0,
                                  latency_slow_us=100.0,
                                  init_promo_cost_us=20.0,
                                  init_demo_cost_us=20.0)
    machine: str = TP.DEFAULT_MACHINE

    @property
    def n_blocks(self) -> int:
        return -(-self.vocab // self.row_block)


@tensor_dataclass
class EmbedTier:
    table: torch.Tensor      # [V, D] home copy (slow tier)
    pool: TP.TieredPool

    @property
    def in_fast(self):
        return self.pool.in_fast

    @property
    def counts(self):
        return self.pool.counts


def block_bytes(t: EmbedTier, cfg: EmbedTierConfig) -> float:
    """Bytes of one row block: the migration-traffic unit."""
    return float(cfg.row_block * t.table.shape[1] * t.table.element_size())


def init_embed_tier(cfg: EmbedTierConfig, table, policy="arms",
                    device=None) -> EmbedTier:
    device = resolve_device(device)
    pool = TP.init_pool(policy, cfg.n_blocks, cfg.fast_blocks,
                        machine=cfg.machine, arms_cfg=cfg.arms,
                        pool_every=cfg.policy_every, device=device)
    return EmbedTier(table=table.to(device), pool=pool)


def lookup(t: EmbedTier, ids, cfg: EmbedTierConfig):
    """Embedding lookup + per-block access accounting.

    Returns (embeddings, fast_hit_fraction, new_tier)."""
    flat = ids.reshape(-1).long()
    emb = t.table.index_select(0, flat).reshape(
        tuple(ids.shape) + (t.table.shape[1],))
    blocks = flat // cfg.row_block
    # counts of ones: exact in f32 in any order (no host sync, unlike
    # bincount on the card)
    hist = torch.zeros((cfg.n_blocks,), dtype=torch.float32,
                       device=flat.device).index_add_(
        0, blocks, torch.ones(flat.shape, dtype=torch.float32,
                              device=flat.device))
    hits = t.in_fast[blocks].sum(dtype=torch.float32) \
        / f32_on(flat.numel(), flat.device)
    row_b = float(t.table.shape[1] * t.table.element_size())
    rf = (hist * t.in_fast).sum() * row_b
    rs = (hist * ~t.in_fast).sum() * row_b
    pool = TP.pool_observe(t.pool, hist, rf, rs)
    return emb, hits, t.replace(pool=pool)


def policy(t: EmbedTier, cfg: EmbedTierConfig):
    """Run the placement policy if due (``policy_every`` lookups since the
    last pass).  Metadata-only: no block copies (module docstring)."""
    pool, _, plan = TP.pool_fire(
        t.pool, k=cfg.fast_blocks, bufs=(), copy_back=False,
        page_bytes=block_bytes(t, cfg))
    return t.replace(pool=pool), plan
