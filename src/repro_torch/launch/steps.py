"""Step factories: train (gradient accumulation + AdamW), prefill, serve.

The port of ``repro/launch/steps.py``.  Gradients are taken with
``torch.autograd.grad`` with respect to detached aliases of the stacked
param leaves, so the caller's tensors stay plain tensors and AdamW
updates them in place.  With ``grad_accum > 1`` the leading axis of
every batch entry (a vlm's ``patch_embeds`` too) is cut into that many
micro-batches (a Python loop where JAX scans) and their gradients are
summed in f32, bounding live activation memory.  The activation-sharding
constraint and the mesh arguments belong to the launch layer, which is
not ported (the JAX-specific launch layer).
"""
from __future__ import annotations

import torch

from repro_torch.models import model as M
from repro_torch.optim import adamw
from repro_torch.utils.pytree import (flatten_with_path, leaves,
                                      map_leaves, unflatten)


def make_loss_and_grads(cfg, remat: bool = True):
    """-> ``loss_and_grads(params, batch) -> (loss, grads)``: the f32 loss
    (detached) and the gradient tree, each leaf in its param's dtype."""

    def loss_and_grads(params, batch):
        alias = [p.detach().requires_grad_() for _, p in
                 flatten_with_path(params)]
        loss = M.loss_fn(unflatten(params, alias), batch, cfg, remat=remat)
        grads = torch.autograd.grad(loss, alias)
        return loss.detach(), unflatten(params, list(grads))

    return loss_and_grads


def make_train_step(cfg, opt_cfg: adamw.AdamWConfig, grad_accum: int = 1,
                    remat: bool = True):
    """-> ``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``; params and state are updated in place.  The batch's
    leading dim must be divisible by ``grad_accum``."""
    loss_and_grads = make_loss_and_grads(cfg, remat)

    def train_step(params, opt_state, batch):
        if grad_accum == 1:
            loss, grads = loss_and_grads(params, batch)
        else:
            n = next(iter(batch.values())).shape[0] // grad_accum
            loss = torch.zeros((), dtype=torch.float32,
                               device=leaves(params)[0].device)
            grads = map_leaves(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            for i in range(grad_accum):
                micro = {k: v[i * n:(i + 1) * n] for k, v in batch.items()}
                l_i, g_i = loss_and_grads(params, micro)
                loss = loss + l_i
                for acc, g in zip(leaves(grads), leaves(g_i)):
                    acc.add_(g.float())
                del g_i
            loss = loss / grad_accum
            grads = map_leaves(lambda g: g / grad_accum, grads)
        params, opt_state, metrics = adamw.update(grads, opt_state, params,
                                                  opt_cfg)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return train_step


def make_prefill_step(cfg):
    def prefill_step(params, batch):
        with torch.no_grad():
            logits, _ = M.forward(params, batch, cfg)
        return logits

    return prefill_step


def make_serve_step(cfg, greedy: bool = True):
    """One decode step: embeds, L-layer stack against the KV/state cache,
    unembed, greedy next-token."""

    def serve_step(params, token, cache, pos: int):
        logits, cache = M.decode_step(params, token, cache, pos, cfg)
        if greedy:   # [B, 1] so the output feeds the next step's input
            return logits[:, -1:].argmax(dim=-1).to(torch.int32), cache
        return logits, cache

    return serve_step
