"""Step factories: train (gradient accumulation + AdamW), prefill, serve.

The port of ``repro/launch/steps.py``.  Gradients are taken with
``torch.autograd.grad`` with respect to detached aliases of the stacked
param leaves, so the caller's tensors stay plain tensors and AdamW
updates them in place.  With ``grad_accum > 1`` the leading axis of
every batch entry (a vlm's ``patch_embeds`` too) is cut into that many
micro-batches (a Python loop where JAX scans) and their gradients are
summed in f32, bounding live activation memory.

``mesh=`` (a ``DeviceMesh``, ``launch/mesh.py``) runs the train and
prefill steps on DTensors, as JAX's jit runs them under
``in_shardings``: the caller gives params (and optimizer state)
distributed by ``sharding.param_shardings``; a batch leaf that is a
plain tensor is distributed by ``sharding.batch_sharding``.  The step
enters ``act_sharding.use_mesh(mesh)`` and passes
``make_activation_constraint(mesh)`` to the model, and it runs under
DTensor's ``implicit_replication``, so a plain tensor that the model
makes (positions, masks, the optimizer's step) counts as replicated.
A micro-batch is each device's own slice of its shard of the batch (JAX
slices the global batch and reshards it): each is a partition of the
batch of the same size, and the same rows where the batch is not
sharded.  ``mesh=None`` is the plain step.  The serve step needs no
mesh argument, as in JAX: given DTensor params and cache it runs on them
(a cache entry is written by the device that holds it,
``attention.write_at``).
"""
from __future__ import annotations

import contextlib

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.launch import sharding
from repro_torch.launch.mesh import dp_axes
from repro_torch.models import model as M
from repro_torch.optim import adamw
from repro_torch.utils import act_sharding
from repro_torch.utils.pytree import (flatten_with_path, leaves,
                                      map_leaves, unflatten)


def make_activation_constraint(mesh):
    """Per-layer activation sharding pin: batch over the DP axes
    (``Shard(0)`` on each), replicated over the rest, JAX's ``P(dp,
    None, ...)``."""
    if mesh is None:
        return None
    dp = dp_axes(mesh)

    def constrain(x):
        spec = (dp,) + (None,) * (x.ndim - 1)
        return x.redistribute(mesh, sharding.placements(mesh, spec)) \
            if isinstance(x, DTensor) else x

    return constrain


@contextlib.contextmanager
def _on_mesh(mesh):
    """The mesh context of a step: ``use_mesh`` and implicit replication
    of plain tensors; nothing without a mesh."""
    if mesh is None:
        yield
        return
    with act_sharding.use_mesh(mesh), implicit_replication():
        yield


def _shard_batch(batch, mesh):
    """Plain tensor leaves of ``batch`` distributed by
    ``sharding.batch_sharding``; DTensors kept."""
    if mesh is None:
        return batch
    specs = sharding.batch_sharding(mesh, batch)
    return {k: v if isinstance(v, DTensor) else
            sharding.distribute_tree(v, specs[k], mesh)
            for k, v in batch.items()}


def _micro(v, i: int, k: int):
    """Micro-batch ``i`` of ``k`` of a batch leaf: a DTensor's from each
    device's own shard."""
    if isinstance(v, DTensor):
        loc = v.to_local()
        n = loc.shape[0] // k
        return DTensor.from_local(loc[i * n:(i + 1) * n], v.device_mesh,
                                  v.placements, run_check=False)
    n = v.shape[0] // k
    return v[i * n:(i + 1) * n]


def make_loss_and_grads(cfg, remat: bool = True, constrain=None):
    """-> ``loss_and_grads(params, batch) -> (loss, grads)``: the f32 loss
    (detached; a DTensor loss replicated) and the gradient tree, each
    leaf in its param's dtype."""

    def loss_and_grads(params, batch):
        alias = [p.detach().requires_grad_() for _, p in
                 flatten_with_path(params)]
        loss = M.loss_fn(unflatten(params, alias), batch, cfg, remat=remat,
                         constrain=constrain)
        if isinstance(loss, DTensor):
            loss = loss.redistribute(loss.device_mesh,
                                     [Replicate()] * loss.device_mesh.ndim)
        grads = torch.autograd.grad(loss, alias)
        return loss.detach(), unflatten(params, list(grads))

    return loss_and_grads


def make_train_step(cfg, opt_cfg: adamw.AdamWConfig, grad_accum: int = 1,
                    remat: bool = True, mesh=None):
    """-> ``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``; params and state are updated in place.  The batch's
    leading dim must be divisible by ``grad_accum``."""
    loss_and_grads = make_loss_and_grads(
        cfg, remat, make_activation_constraint(mesh))

    def train_step(params, opt_state, batch):
        with _on_mesh(mesh):
            batch = _shard_batch(batch, mesh)
            if grad_accum == 1:
                loss, grads = loss_and_grads(params, batch)
            else:
                loss = torch.zeros((), dtype=torch.float32,
                                   device=leaves(params)[0].device)
                grads = map_leaves(lambda p: torch.zeros_like(
                    p, dtype=torch.float32), params)
                for i in range(grad_accum):
                    micro = {k: _micro(v, i, grad_accum)
                             for k, v in batch.items()}
                    l_i, g_i = loss_and_grads(params, micro)
                    loss = loss + l_i
                    for acc, g in zip(leaves(grads), leaves(g_i)):
                        acc.add_(g.float())
                    del g_i
                loss = loss / grad_accum
                grads = map_leaves(lambda g: g / grad_accum, grads)
            params, opt_state, metrics = adamw.update(grads, opt_state,
                                                      params, opt_cfg)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return train_step


def make_prefill_step(cfg, mesh=None):
    constrain = make_activation_constraint(mesh)

    def prefill_step(params, batch):
        with torch.no_grad(), _on_mesh(mesh):
            logits, _ = M.forward(params, _shard_batch(batch, mesh), cfg,
                                  constrain=constrain)
        return logits

    return prefill_step


def make_serve_step(cfg, greedy: bool = True):
    """One decode step: embeds, L-layer stack against the KV/state cache,
    unembed, greedy next-token."""

    def serve_step(params, token, cache, pos: int):
        on_mesh = any(isinstance(t, DTensor) for t in leaves(cache))
        with implicit_replication() if on_mesh else contextlib.nullcontext():
            logits, cache = M.decode_step(params, token, cache, pos, cfg)
            if greedy:   # [B, 1] so the output feeds the next step's input
                last = logits[:, -1:]
                if isinstance(last, DTensor):   # the whole vocab a device
                    last = last.redistribute(last.device_mesh, [
                        p if isinstance(p, Shard) and p.dim < 2
                        else Replicate() for p in last.placements])
                return last.argmax(dim=-1).to(torch.int32), cache
        return logits, cache

    return serve_step
