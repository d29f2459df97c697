"""Policy-tiered paged KV cache of one attention layer, in torch.

The port of ``repro/tiering/paged_kv.py``.  The KV cache is split into
fixed-size token pages, each in the FAST pool (device memory) or the SLOW
pool (home slots, one per logical page); a page table maps each logical
page to (tier, slot).  Per decode step:

  1. the step's K/V are written at ``pos`` (``write_token``);
  2. attention runs over every logical page through the ``paged_attention``
     op (the hand-written CUDA kernels on the card), which also returns
     each page's attention mass, the access signal of the policy;
  3. the per-tier read volumes (every valid page read once from its tier)
     feed the pool's bandwidth signals;
  4. ``tiered_pool.pool_step`` observes, and when the placement policy
     is due (ANY family of ``experiment.POLICY_REGISTRY``, default ARMS
     every ``policy_every`` steps) runs it and migrates both pools through
     the ``migrate`` op.

Layout: K and V are each ONE tensor ``[Pf + n, page, B, KV, dh]``, fast
rows first, so the attention kernel reads a single pool through a block
table (``block_table``) and a migration is a row move within one tensor;
``k_fast``/``k_slow``/``v_fast``/``v_slow`` are views.  The batch sits
inside the page, as in the JAX package, and all sequences share one page
table and one ``pos``: attention folds the batch into the head axis
(``q [B, H, dh]`` -> ``[1, B*H, dh]``, pools viewed as
``[P, page, B*KV, dh]``, query head ``b*H + kv*rep + r`` -> KV head
``b*KV + kv``), with ``seq_lens = [pos + 1]`` since tokens ``<= pos`` are
valid.  K and V are updated in place.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.state import ARMSConfig
from repro_torch.kernels.paged_attention import ops as pa_ops
from repro_torch.tiering import tiered_pool as TP
from repro_torch.utils.device import resolve_device
from repro_torch.utils.pytree import tensor_dataclass


@dataclasses.dataclass(frozen=True)
class PagedKVConfig:
    page_size: int = 64
    n_pages: int = 64            # logical pages per sequence-group
    fast_pages: int = 16         # fast-pool capacity (k)
    policy_every: int = 8        # decode steps between policy invocations
    # dLatency: a KV page streamed over PCIe vs HBM; one access = one unit
    # of attention mass landing on the page in a decode step.
    arms: ARMSConfig = ARMSConfig(access_scale=1.0, latency_fast_us=1.0,
                                  latency_slow_us=30.0,
                                  init_promo_cost_us=5.0,
                                  init_demo_cost_us=5.0)
    machine: str = TP.DEFAULT_MACHINE


@tensor_dataclass
class PagedKV:
    """One layer's paged KV over a batch-shared page space."""
    k: torch.Tensor          # [Pf + n, page, B, KV, dh], fast rows first
    v: torch.Tensor
    pool: TP.TieredPool      # residency + policy state + telemetry

    @property
    def fast_pages(self) -> int:
        return self.k.shape[0] - self.pool.in_fast.shape[0]

    @property
    def k_fast(self):
        return self.k[:self.fast_pages]

    @property
    def k_slow(self):
        return self.k[self.fast_pages:]

    @property
    def v_fast(self):
        return self.v[:self.fast_pages]

    @property
    def v_slow(self):
        return self.v[self.fast_pages:]

    @property
    def in_fast(self):
        return self.pool.in_fast

    @property
    def slot(self):
        return self.pool.slot


def init_paged_kv(cfg: PagedKVConfig, bsz: int, kv_heads: int,
                  head_dim: int, dtype=torch.bfloat16, policy="arms",
                  device=None) -> PagedKV:
    device = resolve_device(device)
    page, n, pf = cfg.page_size, cfg.n_pages, cfg.fast_pages
    shape = (pf + n, page, bsz, kv_heads, head_dim)
    pool = TP.init_pool(policy, n, pf, machine=cfg.machine,
                        arms_cfg=cfg.arms, pool_every=cfg.policy_every,
                        device=device)
    return PagedKV(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device),
                   pool=pool)


def with_residency(kv: PagedKV, in_fast) -> PagedKV:
    """Override the residency mask (tests / sparse-attention what-ifs);
    slots, pools and policy state are left as they are."""
    return kv.replace(pool=kv.pool.replace(
        in_fast=torch.as_tensor(in_fast, dtype=torch.bool,
                                device=kv.k.device)))


def page_kv_bytes(kv: PagedKV) -> float:
    """Bytes one K+V page occupies: the unit of the per-tier read volumes
    and of migration traffic."""
    return float(2 * kv.k[0].numel() * kv.k.element_size())


def block_table(kv: PagedKV):
    """i32 ``[n]`` row of each logical page in the fused pools: its fast
    slot if resident, else ``Pf + `` its home slot."""
    pf = kv.fast_pages
    return torch.where(kv.in_fast, kv.slot.clamp(0, pf - 1),
                       pf + kv.slot).to(torch.int32)


def gather_kv(kv: PagedKV):
    """Logical ``[n_pages, page, B, KV, dh]`` views of K and V (copies):
    resident pages read their fast slot, the rest their home row."""
    n = kv.in_fast.shape[0]
    home = kv.fast_pages + torch.arange(n, dtype=torch.int32,
                                        device=kv.k.device)
    rows = torch.where(kv.in_fast, kv.slot.clamp(0, kv.fast_pages - 1),
                       home).long()
    return kv.k.index_select(0, rows), kv.v.index_select(0, rows)


def read_volumes(kv: PagedKV, pos: int, cfg: PagedKVConfig):
    """(fast_bytes, slow_bytes) one decode step reads: every valid page
    (holding tokens <= pos) once from its tier."""
    n_valid = min(pos // cfg.page_size + 1, cfg.n_pages)
    valid = torch.arange(cfg.n_pages, device=kv.k.device) < n_valid
    pb = page_kv_bytes(kv)
    fast = (valid & kv.in_fast).sum().float() * pb
    slow = (valid & ~kv.in_fast).sum().float() * pb
    return fast, slow


def write_token(kv: PagedKV, k_new, v_new, pos: int, cfg: PagedKVConfig):
    """Write this step's K/V (``[B, KV, dh]``) at logical position ``pos``
    of its page's current row, in place (no host sync)."""
    page_id, offset = divmod(pos, cfg.page_size)
    row = block_table(kv)[page_id]
    at = (row * cfg.page_size + offset).long().view(1)
    for pool, new in ((kv.k, k_new), (kv.v, v_new)):
        pool.view((-1,) + pool.shape[2:]).index_copy_(
            0, at, new.to(pool.dtype)[None])
    return kv


def paged_attention_step(kv: PagedKV, q, pos: int, cfg: PagedKVConfig):
    """Decode attention over the paged cache.

    q ``[B, H, dh]`` -> (out ``[B, H, dh]``, page attention mass ``[n]``:
    the softmax probabilities of each page's tokens summed over the batch
    and the heads)."""
    B, H, dh = q.shape
    P, page, _, KV, _ = kv.k.shape
    folded = lambda t: t.view(P, page, B * KV, dh)
    lens = torch.full((1,), pos + 1, dtype=torch.int32, device=q.device)
    out, mass = pa_ops.paged_attention(
        q.reshape(1, B * H, dh).contiguous(), folded(kv.k), folded(kv.v),
        block_table(kv)[None], lens, page_mass=True)
    return out.reshape(B, H, dh), mass[0]


def serve_decode_step(kv: PagedKV, q, k_new, v_new, pos: int,
                      cfg: PagedKVConfig):
    """Full tiered decode step for one attention layer: write -> attend ->
    pool_step (observe + periodic policy + migration).  Returns (out, kv,
    PoolPlan with count 0 when the policy did not fire)."""
    kv = write_token(kv, k_new, v_new, pos, cfg)
    out, mass = paged_attention_step(kv, q, pos, cfg)
    rf, rs = read_volumes(kv, pos, cfg)
    pool, _, plan = TP.pool_step(
        kv.pool, mass, rf, rs, k=cfg.fast_pages, bufs=(kv.k, kv.v),
        copy_back=True, page_bytes=page_kv_bytes(kv))
    return out, kv.replace(pool=pool), plan
