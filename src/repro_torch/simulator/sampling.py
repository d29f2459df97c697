"""PEBS-style access sampling emulation (paper §2, §4.1).

Hardware event sampling observes roughly 1 in ``period`` accesses; over an
interval the per-page sample count is modeled as Poisson(true/period).
The numpy reference engine's default draws it with numpy's Poisson
sampler (``pebs_sample``: the JAX package's calls in the same order, so
the same ``np.random.Generator`` gives the same counts).  The CRN path
turns a shared uniform field u[t, page] (common random numbers) into
counts by the inverse-CDF transform ``pebs_sample_from_uniform`` — the
same transform, op for op, as the JAX package's, so both packages (and
both engines) observe the same counts from the same field.

Cross-device note: ``exp`` and ``log`` are evaluated in f64 and rounded
once to f32.  f32 ``exp``/``log`` differ in the last bit between PyTorch's
CPU and CUDA builds (and XLA's), and a last-bit change in a CDF term can
move a count by one; the f64 route gives the same f32 on both devices.
Every other op (``*``, ``/``, ``+``, ``sqrt``, ``floor``) is IEEE-exact on
both.  Divisors are tensors, never Python scalars: PyTorch's CUDA ``div``
turns a scalar divisor into a multiply by its reciprocal.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.utils import prng
from repro_torch.utils.device import resolve_device

_POISSON_TERMS = 24      # exact inverse-CDF terms; P(N >= 24 | lam < 12) ~ 1e-3
_NORMAL_SWITCH = 12.0    # above this rate use the normal approximation

# Cephes ndtri coefficients, as the JAX package's ``_ndtri`` holds them.
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


def _f32(v: float) -> float:
    """A Python float holding exactly the f32 rounding of ``v``."""
    return float(np.float32(v))


def _exp(x):
    return torch.exp(x.double()).float()


def _log(x):
    return torch.log(x.double()).float()


def _polyval(coeffs, x):
    """Horner from a zero start, like ``jnp.polyval``."""
    y = torch.zeros_like(x)
    for c in coeffs:
        y = y * x + _f32(c)
    return y


def ndtri(p):
    """Inverse normal CDF of f32 ``p``: the Cephes piecewise rational
    approximation, op for op as ``jax.scipy.special.ndtri`` computes it."""
    half = torch.full_like(p, 0.5)
    mcp = torch.where(p > _f32(-np.expm1(-2.0)), 1.0 - p, p)
    mcp = torch.where(mcp == 0.0, half, mcp)

    w = mcp - 0.5
    ww = w * w
    x_big = w + w * ww * (_polyval(_P0, ww) / _polyval(_Q0, ww))
    x_big = x_big * -_f32(np.sqrt(2.0 * np.pi))

    z = torch.sqrt(_f32(-2.0) * _log(mcp))
    first = z - _log(z) / z
    rz = 1 / z
    small = _polyval(_P2, rz) / _polyval(_Q2, rz) / z
    other = _polyval(_P1, rz) / _polyval(_Q1, rz) / z
    x = torch.where(mcp > _f32(np.exp(-2.0)), x_big,
                    torch.where(z >= 8.0, first - small, first - other))
    x = torch.where(p > _f32(1.0 - np.exp(-2.0)), x, -x)
    inf = torch.full_like(p, float("inf"))
    return torch.where(p == 0.0, -inf, torch.where(p == 1.0, inf, x))


def pebs_sample(true_counts: np.ndarray, period: float,
                rng: np.random.Generator) -> np.ndarray:
    """Observed per-page sample counts for one interval (numpy Poisson)."""
    lam = np.maximum(true_counts, 0.0) / float(period)
    return rng.poisson(lam).astype(np.float64)


def pebs_sample_from_uniform(u, true_counts, period, *,
                             need_normal: bool = True):
    """Poisson-from-uniform PEBS sample (CRN path); broadcasting shapes.

    ``u`` in [0,1) per page; small rates use the exact inverse CDF (pmf by
    the recurrence p_j = p_{j-1} * lam / j, unrolled — no cumsum), large
    rates the rounded normal approximation.  ``period`` is a tensor.
    ``need_normal=False`` drops the ndtri branch when no rate reaches
    ``_NORMAL_SWITCH`` (the selected values are identical either way).
    """
    u = u.float()
    lam = torch.clamp_min(true_counts.float(), 0.0) / period
    js = torch.arange(_POISSON_TERMS, dtype=torch.float32, device=lam.device)
    pmf = _exp(-lam)
    cdf = pmf
    out = (cdf < u).float()
    for j in range(1, _POISSON_TERMS):
        pmf = pmf * lam / js[j]
        cdf = cdf + pmf
        out = out + (cdf < u)
    if need_normal:
        z = ndtri(torch.clamp(u, _f32(1e-7), _f32(1.0 - 1e-7)))
        large = torch.clamp_min(
            torch.floor(lam + z * torch.sqrt(lam) + 0.5), 0.0)
        out = torch.where(lam < _NORMAL_SWITCH, out, large)
    return torch.where(lam <= 0.0, 0.0, out)


def uniform_field(T: int, n: int, seed: int = 0) -> np.ndarray:
    """Host-side CRN uniform noise field for a whole trace replay."""
    return np.random.default_rng(seed).random((T, n)).astype(np.float32)


# --------------------------------------------------------------------------
# Device-resident CRN rows for the trace-synthesis path: each interval
# draws ONE uniform row from a counter-based key (``fold_in`` by t, no
# consumed key chain), shared by every sweep lane, so config comparisons
# stay paired while per-lane storage stays O(n).  JAX's threefry
# (utils/prng.py), so the rows are the JAX package's bits.
# --------------------------------------------------------------------------

def synth_uniform_row(key, t, n: int):
    """[n] uniform row for interval ``t`` (shared across lanes); ``key`` an
    int64 ``[2]`` key (``prng.PRNGKey``).  An integer tensor ``t`` gives
    the rows of all its intervals at once, ``[len(t), n]``."""
    return prng.uniform(prng.fold_in(key, t), (n,))


def synth_noise_field(T: int, n: int, seed: int = 0,
                      device=None) -> np.ndarray:
    """Host [T, n] replica of the rows a synthesized run draws (tests and
    checks only: it is the O(T*n) array the synthesis path avoids)."""
    dev = resolve_device(device)
    return synth_uniform_row(prng.PRNGKey(seed, dev),
                             torch.arange(T, device=dev), n).cpu().numpy()
