"""AdamW with decoupled weight decay, cosine LR schedule and global-norm
clipping, over the port's parameter trees.

The port of ``repro/optim/adamw.py`` formula for formula: the JAX code
defines this optimizer (its schedule, its clipping over the whole tree,
its f32 master copy), so it is not ``torch.optim.AdamW``.  State: the
step (i32), m and v in f32, and an f32 master copy of the params when
``master_fp32``; the schedule and the bias corrections are computed on
the params' device from the i32 step in f32, as JAX does, with no host
sync.  Leaves are walked in the JAX tree order (dict keys sorted), so the
f32 grad norm sums the leaves in the same order.  ``update`` works on the
stacked leaves in place under ``torch.no_grad()``: m, v, the master and
the params are overwritten and returned.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.utils.pytree import leaves, map_leaves


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    master_fp32: bool = True


@dataclasses.dataclass(frozen=True)
class AdamWState:
    step: torch.Tensor   # i32 scalar
    m: Any
    v: Any
    master: Any          # f32 master params, or {} without master_fp32


def init(params, cfg: AdamWConfig) -> AdamWState:
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
    master = (map_leaves(lambda p: p.float().clone(), params)
              if cfg.master_fp32 else {})
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32,
                         device=leaves(params)[0].device),
        m=map_leaves(zeros, params), v=map_leaves(zeros, params),
        master=master)


def schedule(step, cfg: AdamWConfig):
    """Learning rate at ``step`` (an i32 tensor), f32."""
    warm = torch.clamp_max(step / max(cfg.warmup_steps, 1), 1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def global_norm(tree):
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in leaves(tree)))


def _clip_scale(norm, max_norm):
    return torch.clamp_max(max_norm / torch.clamp_min(norm, 1e-9), 1.0)


def clip_by_global_norm(grads, max_norm):
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return map_leaves(lambda g: g.float() * scale, grads), norm


@torch.no_grad()
def update(grads, state: AdamWState, params, cfg: AdamWConfig):
    """-> (params, state, metrics), params and state updated in place.
    Each leaf's clipped f32 gradient is formed and used one leaf at a
    time (the values of ``clip_by_global_norm``), so the whole f32
    gradient tree is never held at once."""
    gnorm = global_norm(grads)
    scale = _clip_scale(gnorm, cfg.clip_norm)
    step = state.step + 1
    lr = schedule(step, cfg)
    b1, b2 = cfg.beta1, cfg.beta2
    bc1 = 1 - b1 ** step.float()
    bc2 = 1 - b2 ** step.float()
    base = state.master if cfg.master_fp32 else params
    for g, mm, vv, p, pb in zip(leaves(grads), leaves(state.m),
                                leaves(state.v), leaves(params),
                                leaves(base)):
        g = g.float() * scale
        mm.copy_(b1 * mm + (1 - b1) * g)
        vv.copy_(b2 * vv + (1 - b2) * g * g)
        del g
        u = (mm / bc1) / (torch.sqrt(vv / bc2) + cfg.eps)
        new = pb - lr * (u + cfg.weight_decay * pb.float())
        if cfg.master_fp32:
            pb.copy_(new)
        p.copy_(new)   # cast to the params' dtype
    new_state = AdamWState(step=step, m=state.m, v=state.v,
                           master=state.master)
    return params, new_state, {"grad_norm": gnorm, "lr": lr}
