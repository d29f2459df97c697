"""Dispatch of flash attention with its gradient.

A plain CPU tensor goes to the plain version (ref.py), differentiated by
autograd.  Any other tensor goes to the custom ops
``repro_torch::flash_attention_fwd`` and ``_bwd`` (the forward's
gradient is the backward op, ``register_autograd``), whose kernel the
tensor's device picks:
- on a CUDA tensor they launch the hand-written kernels (kernel.py),
  whose wrappers raise on anything the kernels cannot take;
- on a CPU tensor (a DTensor's local one) they run the plain version:
  the forward with its row log-sum-exp, the backward by autograd through
  it (``kernels/_plain.py``: it recomputes the forward, and gives the
  bits of autograd through the plain version);
- on a ``meta`` tensor (the dry run's shapes, ``launch/dryrun.py``)
  ``register_fake`` gives the outputs' shapes and dtypes;
- on a DTensor, on any of these devices, the sharding rules below run
  the op on each device's local tensors: the batch dim and the head dim
  are local to a device (K and V's heads split as q's, so each query
  head keeps its KV head), and the op never shards the sequence or the
  head width.
``flops_fwd``/``flops_bwd`` give the operations the kernels need (2 (dq
+ dv) a kept (query, key) pair forward, 6 dq + 4 dv backward), which
``roofline.analyze_step`` reads through ``torch.utils.flop_counter``.
There is no switch that pins the plain version on the card and no
fallback from a failed build or launch.
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import register_sharding
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import _plain
from repro_torch.kernels.flash_attention import kernel, ref


def _dense(x):
    """``x`` contiguous and, if it is a bf16 tensor on the card, on a
    16-byte boundary (the kernels' TMA tiles need it): a copy where it is
    not.  A DTensor's local tensor is aligned inside the op."""
    x = x.contiguous()
    aligned = isinstance(x, DTensor) or x.device.type != "cuda" \
        or x.dtype != torch.bfloat16 or x.data_ptr() % 16 == 0
    return x if aligned else x.clone()


@torch.library.custom_op("repro_torch::flash_attention_fwd", mutates_args=(),
                         device_types="cuda")
def _fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
         window: int) -> tuple[torch.Tensor, torch.Tensor]:
    return kernel.flash_attention_fwd(_dense(q), _dense(k), _dense(v),
                                      causal=causal, window=window)


@_fwd.register_kernel("cpu")
def _fwd_cpu(q, k, v, causal, window):
    out, lse = ref.flash_attention_lse_ref(q, k, v, causal=causal,
                                           window=window)
    return out.contiguous(), lse   # laid out as the kernel's


@_fwd.register_fake
def _fwd_fake(q, k, v, causal, window):
    B, S, H, _ = q.shape
    return (q.new_empty((B, S, H, v.shape[-1])),
            q.new_empty((B, H, S), dtype=torch.float32))


@torch.library.custom_op("repro_torch::flash_attention_bwd", mutates_args=(),
                         device_types="cuda")
def _bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor,
         causal: bool, window: int
         ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    return kernel.flash_attention_bwd(
        _dense(q), _dense(k), _dense(v), _dense(out), lse.contiguous(),
        _dense(dout), causal=causal, window=window)


@_bwd.register_kernel("cpu")
def _bwd_cpu(q, k, v, out, lse, dout, causal, window):
    return _plain.vjp(lambda q, k, v: (ref.flash_attention_ref(
        q, k, v, causal=causal, window=window),), (q, k, v), (dout,))


@_bwd.register_fake
def _bwd_fake(q, k, v, out, lse, dout, causal, window):
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


def _setup_context(ctx, inputs, output):
    q, k, v, causal, window = inputs
    out, lse = output
    ctx.save_for_backward(q, k, v, out, lse)
    ctx.causal, ctx.window = causal, window


def _backward(ctx, dout, dlse):
    q, k, v, out, lse = ctx.saved_tensors
    dq, dk, dv = _bwd(q, k, v, out, lse, _dense(dout), ctx.causal,
                      ctx.window)
    return dq, dk, dv, None, None


_fwd.register_autograd(_backward, setup_context=_setup_context)


def _heads_split(q, k) -> bool:
    """May the op run on a head shard: does every mesh dim split q's and
    k's heads evenly?  (A shard of the heads then holds whole groups.)"""
    sizes = q.mesh.shape
    return all(q.shape[2] % n == 0 and k.shape[2] % n == 0 for n in sizes)


@register_sharding(torch.ops.repro_torch.flash_attention_fwd.default)
def _fwd_sharding(q, k, v, causal, window):
    rules = [([Replicate(), Replicate()], [Replicate()] * 3 + [None, None]),
             ([Shard(0), Shard(0)], [Shard(0)] * 3 + [None, None])]
    if _heads_split(q, k):
        rules.append(([Shard(2), Shard(1)], [Shard(2)] * 3 + [None, None]))
    return rules


@register_sharding(torch.ops.repro_torch.flash_attention_bwd.default)
def _bwd_sharding(q, k, v, out, lse, dout, causal, window):
    rules = [([Replicate()] * 3, [Replicate()] * 6 + [None, None]),
             ([Shard(0)] * 3, [Shard(0)] * 6 + [None, None])]
    if _heads_split(q, k):
        rules.append(([Shard(2)] * 3, [Shard(2)] * 4 + [Shard(1), Shard(2)]
                      + [None, None]))
    return rules


def kept_pairs(S: int, causal: bool, window: int) -> int:
    """(query, key) pairs of one head that the mask keeps (ref.py's
    mask: key j <= i where causal, j > i - window where a window is
    set)."""
    if causal:
        if not window or window >= S:
            return S * (S + 1) // 2
        return window * (window + 1) // 2 + (S - window) * window
    cut = max(S - window, 0) if window else 0
    return S * S - cut * (cut + 1) // 2


def flops_fwd(B: int, S: int, H: int, dq: int, dv: int, causal: bool,
              window: int) -> int:
    return 2 * B * H * kept_pairs(S, causal, window) * (dq + dv)


def flops_bwd(B: int, S: int, H: int, dq: int, dv: int, causal: bool,
              window: int) -> int:
    return B * H * kept_pairs(S, causal, window) * (6 * dq + 4 * dv)


@register_flop_formula(torch.ops.repro_torch.flash_attention_fwd)
def _fwd_flops(q, k, v, causal, window, out_shape=None):
    B, S, H, dq = q
    return flops_fwd(B, S, H, dq, v[-1], causal, window)


@register_flop_formula(torch.ops.repro_torch.flash_attention_bwd)
def _bwd_flops(q, k, v, out, lse, dout, causal, window, out_shape=None):
    B, S, H, dq = q
    return flops_bwd(B, S, H, dq, v[-1], causal, window)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """Causal (optionally windowed) GQA attention
    (``ref.flash_attention_ref``): q ``[B, S, H, dq]``, k ``[B, S, KV,
    dq]``, v ``[B, S, KV, dv]`` -> ``[B, S, H, dv]`` in q's dtype; on the
    card ``(dq, dv)`` is one of ``kernel.HEAD_DIMS``."""
    if q.device.type not in ("cuda", "meta", "cpu"):
        raise ValueError(f"flash_attention runs on cuda, meta or cpu, not "
                         f"{q.device}")
    if q.device.type == "cpu" and not isinstance(q, DTensor):
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    return _fwd(_dense(q), _dense(k), _dense(v), causal, window)[0]
