"""Dispatch of the Mamba2 SSD chunked scan with its gradient.

A plain CPU tensor goes to the plain version (ref.py), differentiated by
autograd.  Any other tensor goes to the custom ops
``repro_torch::mamba_scan_fwd`` and ``_bwd`` (the forward's gradient is
the backward op, ``register_autograd``), whose kernel the tensor's
device picks:
- on a CUDA tensor they launch the hand-written kernels (kernel.py),
  whose wrappers raise on anything the kernels cannot take;
- on a CPU tensor (a DTensor's local one) they run the plain version,
  the backward by autograd through it (``kernels/_plain.py``: it
  recomputes the forward, and gives the bits of autograd through the
  plain version);
- on a ``meta`` tensor (the dry run's shapes, ``launch/dryrun.py``)
  ``register_fake`` gives the outputs' shapes and dtypes;
- on a DTensor, on any of these devices, the sharding rules below run
  the op on each device's local tensors: the batch dim, or the heads (x,
  dt, A and y, the final state; Bm and Cm are shared by the heads and
  replicated), are local to a device.  The backward's dA sums over the
  batch and dBm/dCm over the heads, so those come out as partial sums
  (``Partial``).
The backward takes the cotangents of both outputs (the final state's is
none on the training path, which drops the cache).  ``flops`` gives the
operations the kernels need (``chip_smoke.py``'s bound), which
``roofline.analyze_step`` reads through ``torch.utils.flop_counter``.
There is no switch that pins the plain version on the card and no
fallback from a failed build or launch.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import register_sharding
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import _plain
from repro_torch.kernels.mamba_scan import kernel, ref


@torch.library.custom_op("repro_torch::mamba_scan_fwd", mutates_args=(),
                         device_types="cuda")
def _fwd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
         Bm: torch.Tensor, Cm: torch.Tensor, chunk: int
         ) -> tuple[torch.Tensor, torch.Tensor]:
    return kernel.mamba_scan_fwd(x.contiguous(), dt.contiguous(),
                                 A.contiguous(), Bm.contiguous(),
                                 Cm.contiguous(), chunk=chunk)


@_fwd.register_kernel("cpu")
def _fwd_cpu(x, dt, A, Bm, Cm, chunk):
    y, h = ref.mamba_scan_ref(x, dt, A, Bm, Cm, chunk)
    return y.contiguous(), h.contiguous()   # laid out as the kernel's


@_fwd.register_fake
def _fwd_fake(x, dt, A, Bm, Cm, chunk):
    B, _, H, P = x.shape
    return (torch.empty_like(x),
            x.new_empty((B, H, P, Bm.shape[-1]), dtype=torch.float32))


@torch.library.custom_op("repro_torch::mamba_scan_bwd", mutates_args=(),
                         device_types="cuda")
def _bwd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
         Bm: torch.Tensor, Cm: torch.Tensor, dy: torch.Tensor,
         dh_final: Optional[torch.Tensor], chunk: int
         ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
                    torch.Tensor]:
    return kernel.mamba_scan_bwd(
        x.contiguous(), dt.contiguous(), A.contiguous(), Bm.contiguous(),
        Cm.contiguous(), dy.contiguous(),
        None if dh_final is None else dh_final.contiguous(), chunk=chunk)


@_bwd.register_kernel("cpu")
def _bwd_cpu(x, dt, A, Bm, Cm, dy, dh_final, chunk):
    return _plain.vjp(lambda *a: ref.mamba_scan_ref(*a, chunk),
                      (x, dt, A, Bm, Cm), (dy, dh_final))


@_bwd.register_fake
def _bwd_fake(x, dt, A, Bm, Cm, dy, dh_final, chunk):
    return tuple(torch.empty_like(t) for t in (x, dt, A, Bm, Cm))


def _setup_context(ctx, inputs, output):
    x, dt, A, Bm, Cm, chunk = inputs
    ctx.save_for_backward(x, dt, A, Bm, Cm)
    ctx.chunk = chunk
    ctx.set_materialize_grads(False)   # an unused output's is None


def _backward(ctx, dy, dh_final):
    x, dt, A, Bm, Cm = ctx.saved_tensors
    if dy is None:
        dy = torch.zeros_like(x)
    grads = _bwd(x, dt, A, Bm, Cm, dy, dh_final, ctx.chunk)
    return grads + (None,)


_fwd.register_autograd(_backward, setup_context=_setup_context)


def _heads_split(x) -> bool:
    """May the op run on a head shard: does every mesh dim split the
    heads evenly?"""
    return all(x.shape[2] % n == 0 for n in x.mesh.shape)


@register_sharding(torch.ops.repro_torch.mamba_scan_fwd.default)
def _fwd_sharding(x, dt, A, Bm, Cm, chunk):
    R = Replicate()
    rules = [([R, R], [R] * 5 + [None]),
             ([Shard(0), Shard(0)], [Shard(0), Shard(0), R, Shard(0),
                                     Shard(0), None])]
    if _heads_split(x):
        rules.append(([Shard(2), Shard(1)], [Shard(2), Shard(2), Shard(0),
                                             R, R, None]))
    return rules


@register_sharding(torch.ops.repro_torch.mamba_scan_bwd.default)
def _bwd_sharding(x, dt, A, Bm, Cm, dy, dh_final, chunk):
    R, S0 = Replicate(), Shard(0)
    dh = lambda p: None if dh_final is None else p
    rules = [([R] * 5, [R] * 6 + [dh(R), None]),
             ([S0, S0, Partial(), S0, S0],
              [S0, S0, R, S0, S0, S0, dh(S0), None])]
    if _heads_split(x):
        rules.append(([Shard(2), Shard(2), S0, Partial(), Partial()],
                      [Shard(2), Shard(2), S0, R, R, Shard(2),
                       dh(Shard(1)), None]))
    return rules


def flops(B: int, S: int, H: int, P: int, N: int, Q: int) -> tuple:
    """Operations (2 per multiply-add) the scan's forward and backward
    need: per (b, chunk) the lower triangle of C . B^T, shared by the
    heads; per head the lower triangle of the decay-masked product with
    x dt, the chunk state and the off-diagonal output (2 QPN each); the
    backward recomputes C . B^T and the states and adds the state
    gradient (2 QPN), the triangle's two gradients for x dt and the decay,
    those for B and C, and the state terms' gradients for B, C and x
    (3 QPN)."""
    nc, tri, qpn = S // Q, Q * (Q + 1) // 2, 2 * Q * P * N
    fwd = B * nc * (2 * tri * N + H * (2 * tri * P + 2 * qpn))
    bwd = B * nc * (2 * tri * N + H * (4 * tri * P + 4 * tri * N + 5 * qpn))
    return fwd, bwd


@register_flop_formula(torch.ops.repro_torch.mamba_scan_fwd)
def _fwd_flops(x, dt, A, Bm, Cm, chunk, out_shape=None):
    B, S, H, P = x
    return flops(B, S, H, P, Bm[-1], chunk)[0]


@register_flop_formula(torch.ops.repro_torch.mamba_scan_bwd)
def _bwd_flops(x, dt, A, Bm, Cm, dy, dh_final, chunk, out_shape=None):
    B, S, H, P = x
    return flops(B, S, H, P, Bm[-1], chunk)[1]


def mamba_scan(x, dt, A, Bm, Cm, *, chunk: int):
    """The SSD chunked scan (``ref.mamba_scan_ref``): x ``[B, S, H, P]``
    (f32 or bf16), dt ``[B, S, H]``, A ``[H]`` (negative), Bm/Cm
    ``[B, S, N]``, all f32 but x, S a multiple of ``chunk`` ->
    ``(y [B, S, H, P]`` in x's dtype, ``h_final [B, H, P, N]`` f32)."""
    if x.device.type not in ("cuda", "meta", "cpu"):
        raise ValueError(f"mamba_scan runs on cuda, meta or cpu, not "
                         f"{x.device}")
    if x.device.type == "cpu" and not isinstance(x, DTensor):
        return ref.mamba_scan_ref(x, dt, A, Bm, Cm, chunk)
    return _fwd(x.contiguous(), dt.contiguous(), A.contiguous(),
                Bm.contiguous(), Cm.contiguous(), chunk)
