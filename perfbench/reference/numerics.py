"""Plain-torch arithmetic the reference replay is built from.

Every function rounds as the replay it checks is specified to round, so
that the reference gives the same f32 bits on the CPU and on the card:

  * ``fma`` -- f32 ``a*b + c`` rounded once (exact product in f64, the
    sum rounded to odd, then to f32);
  * ``exp64``/``log64``/``pow64`` -- computed in f64 and rounded once;
  * ``exp_cephes`` -- the f32 ``exp`` of a compiled XLA CPU program
    (Cephes' polynomial, every step an exact ``fma``);
  * ``xla_sum`` -- an f32 row sum in windows of 32, left to right;
  * ``order_key``/``topk_mask``/``ranked_top`` -- ``lax.top_k``'s total
    order and tie rule (larger first, +0.0 above -0.0, lower index first);
  * ``scatter_set`` -- ``x.at[where(valid, idx, n)].set(v, mode="drop")``;
  * ``ndtri``/``poisson_from_uniform`` -- the inverse-CDF PEBS sampler.

Divisors are tensors wherever the divisor is not a power of two: CUDA
turns a Python-scalar divisor into a multiply by its reciprocal.
"""
from __future__ import annotations

import numpy as np
import torch


def f32(v: float) -> float:
    """A Python float holding exactly the f32 rounding of ``v``."""
    return float(np.float32(v))


def const(v, like):
    """An f32 0-d tensor on ``like``'s device."""
    return torch.full((), f32(v), dtype=torch.float32, device=like.device)


def fma(a, b, c):
    """f32 ``a*b + c`` rounded once, on any device."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, float("inf"), float("-inf"))
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.float()


def exp64(x):
    return torch.exp(x.double()).float()


def log64(x):
    return torch.log(x.double()).float()


def pow64(x, y):
    return torch.pow(x.double(), y.double()).float()


_LOG2E = 1.44269504088896341
_LN2_HI, _LN2_LO = -0.693359375, 2.12194440e-4
_EXP_POLY = (1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3,
             4.1665795894e-2, 1.6666665459e-1, 5.0000001201e-1)


def exp_cephes(x):
    """f32 ``exp`` as XLA's CPU code computes it: ``x = m ln2 + r``,
    ``e^r`` by a degree-5 Horner chain of FMAs, times ``2^m``; inputs
    clamped to [-87, 88]."""
    x = torch.clamp(x, -87.0, 88.0)
    c = lambda v: torch.full_like(x, f32(v))
    m = torch.floor(fma(x, c(_LOG2E), c(0.5)))
    r = fma(m, c(_LN2_HI), x)
    r = fma(m, c(_LN2_LO), r)
    z = r * r
    y = c(_EXP_POLY[0])
    for p in _EXP_POLY[1:]:
        y = fma(y, r, c(p))
    y = fma(y, z, r) + 1.0
    scale = ((m.to(torch.int32) + 127) << 23).view(torch.float32)
    return y * scale


def seq_sum(x):
    """f32 sum over the last axis, left to right from zero."""
    acc = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    for j in range(x.shape[-1]):
        acc = acc + x[..., j]
    return acc


def xla_sum(x):
    """f32 sum over the last axis in XLA's CPU order: while more than 32
    remain, zero-pad evenly to a multiple of 32 and sum each window of 32
    left to right; then sum what is left the same way."""
    while x.shape[-1] > 32:
        n = x.shape[-1]
        m = -(-n // 32)
        pad = m * 32 - n
        if pad:
            x = torch.nn.functional.pad(x, (pad // 2, pad - pad // 2))
        x = seq_sum(x.reshape(x.shape[:-1] + (m, 32)))
    return seq_sum(x)


def order_key(x):
    """Signed i32 key of f32 ``x`` ordering as ``lax.top_k`` does."""
    u = x.float().contiguous().view(torch.int32)
    return torch.where(u < 0, u ^ 0x7FFFFFFF, u)


def topk_mask(x, k: int):
    """Exact top-k bool mask along the last axis of f32 ``[B, n]``, by a
    32-step bisection on the unsigned order key."""
    key = order_key(x).long() + (1 << 31)
    t = torch.zeros(x.shape[:-1] + (1,), dtype=torch.int64, device=x.device)
    for b in range(31, -1, -1):
        cand = t | (1 << b)
        cnt = (key >= cand).sum(dim=-1, keepdim=True)
        t = torch.where(cnt >= k, cand, t)
    greater = key > t
    eq = key == t
    need = k - greater.sum(dim=-1, keepdim=True)
    return greater | (eq & (torch.cumsum(eq.long(), dim=-1) <= need))


def ranked_top(x, k: int):
    """(values, i32 indices) of the k largest of each f32 [B, n] row, in
    ``lax.top_k``'s order."""
    idx = torch.sort(order_key(x), dim=-1, descending=True,
                     stable=True).indices[:, :k]
    return x.gather(1, idx), idx.to(torch.int32)


def scatter_set(x, idx, val, valid):
    """Per-lane ``x[b, idx[b, i]] = val`` where ``valid[b, i]``; ``val`` a
    Python scalar or a tensor shaped like ``idx``.  ``x`` is unchanged."""
    B, n = x.shape
    flat = torch.cat([x.reshape(-1), x.new_zeros((1,))])
    lane = torch.arange(0, B * n, n, device=x.device).unsqueeze(1)
    at = torch.where(valid, idx.long() + lane, B * n).reshape(-1)
    if isinstance(val, torch.Tensor):
        flat.scatter_(0, at, val.to(x.dtype).reshape(-1))
    else:
        flat.index_fill_(0, at, val)
    return flat[:B * n].view(B, n)


def count(mask):
    return mask.sum(dim=1, dtype=torch.int32)


# --------------------------------------------------- PEBS sampling (§4.1)
_POISSON_TERMS = 24
_NORMAL_SWITCH = 12.0
_P0 = (-5.99633501014107895267E1, 9.80010754185999661536E1,
       -5.66762857469070293439E1, 1.39312609387279679503E1,
       -1.23916583867381258016E0)
_Q0 = (1.0, 1.95448858338141759834E0, 4.67627912898881538453E0,
       8.63602421390890590575E1, -2.25462687854119370527E2,
       2.00260212380060660359E2, -8.20372256168333339912E1,
       1.59056225126211695515E1, -1.18331621121330003142E0)
_P1 = (4.05544892305962419923E0, 3.15251094599893866154E1,
       5.71628192246421288162E1, 4.40805073893200834700E1,
       1.46849561928858024014E1, 2.18663306850790267539E0,
       -1.40256079171354495875E-1, -3.50424626827848203418E-2,
       -8.57456785154685413611E-4)
_Q1 = (1.0, 1.57799883256466749731E1, 4.53907635128879210584E1,
       4.13172038254672030440E1, 1.50425385692907503408E1,
       2.50464946208309415979E0, -1.42182922854787788574E-1,
       -3.80806407691578277194E-2, -9.33259480895457427372E-4)
_P2 = (3.23774891776946035970E0, 6.91522889068984211695E0,
       3.93881025292474443415E0, 1.33303460815807542389E0,
       2.01485389549179081538E-1, 1.23716634817820021358E-2,
       3.01581553508235416007E-4, 2.65806974686737550832E-6,
       6.23974539184983293730E-9)
_Q2 = (1.0, 6.02427039364742014255E0, 3.67983563856160859403E0,
       1.37702099489081330271E0, 2.16236993594496635890E-1,
       1.34204006088543189037E-2, 3.28014464682127739104E-4,
       2.89247864745380683936E-6, 6.79019408009981274425E-9)


def _polyval(coeffs, x):
    y = torch.zeros_like(x)
    for c in coeffs:
        y = y * x + f32(c)
    return y


def ndtri(p):
    """Inverse normal CDF of f32 ``p`` (Cephes' piecewise rational
    approximation, as ``jax.scipy.special.ndtri``)."""
    half = torch.full_like(p, 0.5)
    mcp = torch.where(p > f32(-np.expm1(-2.0)), 1.0 - p, p)
    mcp = torch.where(mcp == 0.0, half, mcp)
    w = mcp - 0.5
    ww = w * w
    x_big = w + w * ww * (_polyval(_P0, ww) / _polyval(_Q0, ww))
    x_big = x_big * -f32(np.sqrt(2.0 * np.pi))
    z = torch.sqrt(f32(-2.0) * log64(mcp))
    first = z - log64(z) / z
    rz = 1 / z
    small = _polyval(_P2, rz) / _polyval(_Q2, rz) / z
    other = _polyval(_P1, rz) / _polyval(_Q1, rz) / z
    x = torch.where(mcp > f32(np.exp(-2.0)), x_big,
                    torch.where(z >= 8.0, first - small, first - other))
    x = torch.where(p > f32(1.0 - np.exp(-2.0)), x, -x)
    inf = torch.full_like(p, float("inf"))
    return torch.where(p == 0.0, -inf, torch.where(p == 1.0, inf, x))


def poisson_from_uniform(u, true_counts, period):
    """Per-page sample count ~ Poisson(true / period) from the uniform
    ``u``: the exact inverse CDF below rate 12 (24 terms), the rounded
    normal approximation above.  ``period`` a tensor."""
    u = u.float()
    lam = torch.clamp_min(true_counts.float(), 0.0) / period
    js = torch.arange(_POISSON_TERMS, dtype=torch.float32, device=lam.device)
    pmf = exp64(-lam)
    cdf = pmf
    out = (cdf < u).float()
    for j in range(1, _POISSON_TERMS):
        pmf = pmf * lam / js[j]
        cdf = cdf + pmf
        out = out + (cdf < u)
    z = ndtri(torch.clamp(u, f32(1e-7), f32(1.0 - 1e-7)))
    large = torch.clamp_min(torch.floor(lam + z * torch.sqrt(lam) + 0.5), 0.0)
    out = torch.where(lam < _NORMAL_SWITCH, out, large)
    return torch.where(lam <= 0.0, 0.0, out)
