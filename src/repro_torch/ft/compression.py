"""Gradient compression for cross-pod reduction with error feedback.

The port of ``repro/ft/compression.py`` over the port's parameter trees
(nested dicts of tensors, walked by ``utils.pytree``).  At 512+ chips the
pod-level all-reduce crosses the slow inter-pod links; compressing that
traffic 2x (bf16) or 4x (int8 with a per-tensor scale) with error
feedback keeps convergence intact: the residual carries the quantization
error into the next step.

Each function computes the JAX package's expression op for op, so the
results are its op-by-op bits: bf16 by round-to-nearest-even, the int8
round half to even (``torch.round``, as ``jnp.round``), the scale
``max(max |g'|, 1e-12) / 127`` in f32.  Under ``jit`` XLA fuses the
residual ``g' - q s`` into one multiply-add; there the residual differs
by at most half an ulp of ``max |g'|`` (``tests/test_torch_compression.py``).
"""
from __future__ import annotations

import torch

from repro_torch.utils.pytree import leaves, map_leaves, unflatten


def compress_bf16(grads):
    return map_leaves(lambda g: g.to(torch.bfloat16), grads)


def decompress_bf16(grads):
    return map_leaves(lambda g: g.float(), grads)


def init_error_feedback(grads_like):
    return map_leaves(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                            device=g.device), grads_like)


def _int8_one(g, e):
    g = g.float() + e
    # a tensor divisor: on the card PyTorch multiplies by the reciprocal of
    # a Python-number divisor, which rounds otherwise than the division
    s = torch.clamp_min(g.abs().max(), 1e-12) / torch.full(
        (), 127.0, device=g.device)
    q = torch.clamp(torch.round(g / s), -127, 127).to(torch.int8)
    return q, s, g - q.float() * s


def compress_int8(grads, ef):
    """-> ``(q_grads int8, scales f32 0-d, new_ef f32)``, each a tree like
    ``grads``: ``g' = g + ef``, ``q = round(g' / s)`` clipped to
    [-127, 127], ``ef' = g' - q s``."""
    qs, ss, es = zip(*(_int8_one(g, e) for g, e in
                       zip(leaves(grads), leaves(ef))))
    return (unflatten(grads, list(qs)), unflatten(grads, list(ss)),
            unflatten(grads, list(es)))


def decompress_int8(q_grads, scales):
    return map_leaves(lambda q, s: q.float() * s, q_grads, scales)
