"""Mamba2 (state-space duality / SSD) block — arXiv:2405.21060.

The port of ``repro/models/mamba2.py``: ``mamba2_init`` (the JAX tree,
shapes and dtypes: ``A_log``, ``dt_bias`` and ``D`` stay f32 in a bf16
model), ``MambaCache``, ``_split_proj``, ``_causal_conv`` (the K shifted
products summed in the JAX package's order), ``mamba2_full`` and
``mamba2_decode``.  The full-sequence path (train, prefill) runs the
chunked SSD scan through the ``mamba_scan`` op (``kernels/mamba_scan``:
the hand-written kernels and their gradient on the card, the plain
version on the CPU), where the JAX model calls ``ssd_chunked`` directly;
both compute the same function.  Decode is the exact SSM recurrence on
the ``[B, H, P, N]`` state plus a rolling conv window, in plain torch,
as the JAX package computes it outside any kernel; the state is kept in
the cache's dtype.  ``ssd_chunked`` and ``_segsum`` are re-exported from
the op's plain version (which cannot import this module: the model
imports the op).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.mamba_scan import ops as scan_ops
from repro_torch.kernels.mamba_scan.ref import segsum as _segsum  # noqa: F401
from repro_torch.kernels.mamba_scan.ref import ssd_chunked  # noqa: F401
from repro_torch.models import layers as L
from repro_torch.utils.pytree import tensor_dataclass


def _f32_rows(values, lead: tuple, device):
    """``values`` (an f32 ``[H]`` CPU tensor) repeated over ``lead``."""
    out = torch.empty(lead + values.shape, dtype=torch.float32,
                      device=device)
    if out.device.type != "meta":    # shapes only (``count_params``)
        out.copy_(values.expand(out.shape))
    return out


def mamba2_init(gen, cfg, dtype, device, lead: tuple = ()) -> dict:
    D, di = cfg.d_model, cfg.d_inner
    N, H, K = cfg.ssm_state, cfg.ssm_heads, cfg.conv_kernel
    G = 1
    conv_dim = di + 2 * G * N
    a_log = torch.log(torch.linspace(1.0, 16.0, H, dtype=torch.float32))
    return {
        "in_proj": L.linear_init(gen, D, 2 * di + 2 * G * N + H, dtype,
                                 device, lead=lead),
        "conv_w": L.normal(lead + (K, conv_dim), 1.0 / math.sqrt(K), dtype,
                           gen, device),
        "conv_b": torch.zeros(lead + (conv_dim,), dtype=dtype, device=device),
        "A_log": _f32_rows(a_log, lead, device),
        "dt_bias": _f32_rows(torch.zeros(H), lead, device),
        "D": _f32_rows(torch.ones(H), lead, device),
        "norm": L.rmsnorm_init(di, dtype, device, lead),
        "out_proj": L.linear_init(gen, di, D, dtype, device, scale=0.5,
                                  lead=lead),
    }


@tensor_dataclass
class MambaCache:
    """Decode state: ``conv`` ``[B, K-1, conv_dim]`` rolling conv window of
    the raw (pre-conv) inputs, ``ssm`` ``[B, H, P, N]`` recurrent state;
    stacked over layers, a leading ``[L]`` axis."""
    conv: torch.Tensor
    ssm: torch.Tensor


def _split_proj(zxbcdt, cfg):
    di, N = cfg.d_inner, cfg.ssm_state
    G = 1
    z = zxbcdt[..., :di]
    xBC = zxbcdt[..., di: di + di + 2 * G * N]
    dt = zxbcdt[..., di + di + 2 * G * N:]
    return z, xBC, dt


def _causal_conv(xBC, w, b):
    """Depthwise causal conv1d, kernel K. xBC: ``[B, S, Cd]``, w:
    ``[K, Cd]``; the shifted products summed in order, as JAX's ``sum``."""
    K, S = w.shape[0], xBC.shape[1]
    pad = F.pad(xBC, (0, 0, K - 1, 0))
    out = pad[:, 0:S] * w[0]
    for i in range(1, K):
        out = out + pad[:, i: i + S] * w[i]
    return F.silu(out + b)


def softplus(x):
    """``jax.nn.softplus``: ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, torch.zeros_like(x))


def mamba2_full(p, x, cfg):
    """Train/prefill. x: ``[B, S, D]`` -> (y ``[B, S, D]``, MambaCache)."""
    Bsz, S, _ = x.shape
    di, N, H, K = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.conv_kernel
    P = cfg.ssm_head_dim

    zxbcdt = L.linear(p["in_proj"], x)
    z, xBC_raw, dt = _split_proj(zxbcdt, cfg)
    xBC = _causal_conv(xBC_raw, p["conv_w"], p["conv_b"])
    xs = xBC[..., :di].reshape(Bsz, S, H, P)
    Bm = xBC[..., di: di + N]
    Cm = xBC[..., di + N:]

    dt = softplus(dt.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    # pad S to a chunk multiple; padded steps have dt = 0 (identity decay,
    # no input) so y[:S] and the final state are exact.
    Q = cfg.ssm_chunk
    S_pad = -(-S // Q) * Q
    if S_pad != S:
        xs_p = F.pad(xs, (0, 0, 0, 0, 0, S_pad - S))
        dt_p = F.pad(dt, (0, 0, 0, S_pad - S))
        Bm_p = F.pad(Bm, (0, 0, 0, S_pad - S))
        Cm_p = F.pad(Cm, (0, 0, 0, S_pad - S))
    else:
        xs_p, dt_p, Bm_p, Cm_p = xs, dt, Bm, Cm
    y, h_final = scan_ops.mamba_scan(xs_p.float(), dt_p, A, Bm_p.float(),
                                     Cm_p.float(), chunk=Q)
    y = y[:, :S]
    y = y + xs.float() * p["D"][None, None, :, None]
    y = y.reshape(Bsz, S, di).to(x.dtype)

    y = L.rmsnorm(p["norm"], y * F.silu(z), cfg.norm_eps)
    out = L.linear(p["out_proj"], y)
    # cache the raw (pre-conv) inputs so decode continues the conv window
    conv_cache = F.pad(xBC_raw, (0, 0, K - 1, 0))[:, -(K - 1):]
    return out, MambaCache(conv=conv_cache, ssm=h_final.to(x.dtype))


def mamba2_decode(p, x, cache: MambaCache, cfg):
    """One-token recurrent step. x: ``[B, 1, D]`` -> (y ``[B, 1, D]``,
    cache)."""
    Bsz = x.shape[0]
    di, N, H = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    P = cfg.ssm_head_dim

    zxbcdt = L.linear(p["in_proj"], x)[:, 0]             # [B, *]
    z, xBC_new, dt = _split_proj(zxbcdt, cfg)
    window = torch.cat([cache.conv, xBC_new[:, None, :]], dim=1)
    conv_out = F.silu((window * p["conv_w"][None]).sum(dim=1)
                      + p["conv_b"])
    xs = conv_out[..., :di].reshape(Bsz, H, P)
    Bm = conv_out[..., di: di + N]
    Cm = conv_out[..., di + N:]

    dt = softplus(dt.float() + p["dt_bias"])             # [B, H]
    A = -torch.exp(p["A_log"])
    dA = torch.exp(dt * A)                               # [B, H]
    h = cache.ssm.float()
    h = (h * dA[..., None, None]
         + torch.einsum("bh,bhp,bn->bhpn", dt, xs.float(), Bm.float()))
    y = torch.einsum("bhpn,bn->bhp", h, Cm.float())
    y = y + xs.float() * p["D"][None, :, None]
    y = y.reshape(Bsz, di).to(x.dtype)

    y = L.rmsnorm(p["norm"], y * F.silu(z), cfg.norm_eps)
    out = L.linear(p["out_proj"], y)[:, None, :]
    return out, MambaCache(conv=window[:, 1:], ssm=h.to(x.dtype))
