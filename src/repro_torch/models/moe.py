"""Mixture-of-Experts with capacity-based dispatch (plain tensor functions).

The port of ``repro/models/moe.py``: ``moe_init`` (the router stays f32
in a bf16 model), ``_capacity`` and ``moe_apply``.  Top-k routing over
f32 softmax probabilities with renormalised gates, slot-major priority
(every token's first choice before any token's second), a static
per-expert capacity whose overflow is dropped, optional shared experts,
the Switch load-balancing loss and the per-expert token counts that the
ARMS expert tier reads.  Expert weights are stacked ``[E, ...]``; the
expert products are batched matmuls, as the JAX package computes them
outside any kernel.  Ties in the routing go to the lower expert index,
as ``jax.lax.top_k`` breaks them.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.models import layers as L


def moe_init(gen, cfg, dtype, device, lead: tuple = ()) -> dict:
    D, E, Fd = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    std = 1.0 / D ** 0.5
    p = {"router": {"w": L.normal(lead + (D, E), std, torch.float32, gen,
                                  device)},
         "wi": L.normal(lead + (E, D, 2 * Fd), std, dtype, gen, device),
         "wo": L.normal(lead + (E, Fd, D), 1.0 / Fd ** 0.5, dtype, gen,
                        device)}
    if cfg.n_shared_experts:
        p["shared"] = L.swiglu_init(gen, D, cfg.n_shared_experts * Fd, dtype,
                                    device, lead)
    return p


def _capacity(tokens: int, cfg) -> int:
    cap = int(tokens * cfg.experts_per_token * cfg.capacity_factor
              / cfg.n_experts)
    return max(4, -(-cap // 4) * 4)   # round up to a multiple of 4


def _top_k(probs, k: int):
    """``jax.lax.top_k`` of ``probs`` ``[T, E]``: values and indices in
    descending order, ties to the lower index (``argmax`` returns the
    first maximum; a stable descending sort keeps index order among
    equals)."""
    if k == 1:
        idx = probs.argmax(dim=-1, keepdim=True)
        return probs.gather(-1, idx), idx
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def moe_apply(p, x, cfg):
    """x ``[B, S, D]`` -> ``(y [B, S, D], aux_loss f32, expert_load [E]
    f32)``: ``expert_load`` counts the token copies each expert kept."""
    if isinstance(x, DTensor):    # tokens over the batch's shards only
        x = x.redistribute(x.device_mesh, [
            pl if pl == Shard(0) else Replicate() for pl in x.placements])
    B, S, D = x.shape
    T = B * S
    E, k = cfg.n_experts, cfg.experts_per_token
    C = _capacity(T, cfg)
    xf = x.reshape(T, D)
    if isinstance(xf, DTensor):   # its gradient comes back in this layout
        xf = xf.redistribute(xf.device_mesh, xf.placements)

    probs = torch.softmax(xf.float() @ p["router"]["w"], dim=-1)  # [T, E]
    gate_vals, expert_idx = _top_k(probs, k)                      # [T, k]
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)

    # slot-major positions: copy (t, j) is preceded by every copy of an
    # earlier slot, and by the copies of slot j of earlier tokens
    onehot = F.one_hot(expert_idx, E)                             # [T, k, E]
    slot_major = onehot.transpose(0, 1).reshape(k * T, E)
    pos = (torch.cumsum(slot_major, dim=0) - slot_major).reshape(k, T, E)
    pos_tk = (pos.transpose(0, 1) * onehot).sum(-1)               # [T, k]
    keep = pos_tk < C

    gates = torch.where(keep, gate_vals, 0.0)
    # scatter dispatch: each kept copy to its (expert, slot) row, unique
    # among kept copies; a dropped copy (expert E) goes to a spare row
    e_idx = torch.where(keep, expert_idx, E)
    slot_idx = pos_tk.clamp(0, C - 1)
    xin = x.new_zeros(((E + 1) * C, D)).index_copy(
        0, (e_idx * C + slot_idx).reshape(-1),
        xf.repeat_interleave(k, dim=0))[:E * C].reshape(E, C, D)
    g, u = torch.bmm(xin, p["wi"]).chunk(2, dim=-1)
    yout = torch.bmm(F.silu(g) * u, p["wo"]).reshape(E * C, D)
    y = (yout[e_idx.clamp(0, E - 1) * C + slot_idx]               # [T, k, D]
         * gates[..., None].to(x.dtype)).sum(dim=1)

    if cfg.n_shared_experts:
        y = y + L.swiglu(p["shared"], xf)
    if isinstance(y, DTensor):    # the tokens laid out as x's again
        y = y.redistribute(y.device_mesh, L.settled(y))
        y = y.redistribute(y.device_mesh, xf.placements)

    # load-balance aux loss (Switch): E * sum_e f_e * p_e
    frac_tokens = F.one_hot(expert_idx[:, 0], E).float().mean(dim=0)
    aux = cfg.router_aux_coef * E * (frac_tokens * probs.mean(dim=0)).sum()
    expert_load = torch.zeros(E + 1, dtype=torch.float32, device=x.device) \
        .index_add(0, e_idx.reshape(-1), keep.float().reshape(-1))[:E]
    return y.reshape(B, S, D), aux, expert_load
