"""Declarative workload protocol: batchable ``WorkloadSpec`` tensor
dataclasses (the port of ``repro/simulator/workload_spec.py``).

A workload is a ``WorkloadSpec`` whose *leaves* are the scenario knobs
(zipf exponent, hot fraction, drift rate, phase windows; f32/i32, with a
leading component axis ``[S]`` and optional lane axes before it) with
functions over a small ``WorkloadState``:

    state        = spec.init(n, key)
    state, probs = spec.step(state, t)     # [n] distribution, sums to 1
    work         = spec.work_of(state, t)  # true accesses this interval

The scan engine synthesizes ``true = work * probs`` on the device each
interval (scan_engine.py), so per-lane trace storage is O(n);
``spec.materialize(T, n, seed)`` runs the same functions and returns the
dense f32 ``[T, n]`` array a replay of a materialized trace reads.  On one
device the two are bit for bit the same rows.

The re-randomization events (hot-set relocation, zipf reshuffle,
frontier boosts) are factored out of the per-interval path:

    due   = spec.event_due(state, t)  # host bool, from the int leaves
    state = spec.event(state, t)      # fresh permutations where due
    probs = spec.probs_of(state, t)   # O(n), every interval

``event_due`` is a pure function of ``t`` and the integer leaves, so it
is decided on the host with no device read.  Event draws are keyed by
``(seed, tag, epoch)`` through JAX's threefry (``utils/prng.py``), so a
permutation here is bit for bit the JAX package's.

A spec is a stack of S components, each of a kind (zipf / hot-set /
xsbench / tpcc-window / zipf+boost) with its knobs, an activity window
``[t_start, t_end)``, a duty cycle and a mixture weight.  The interval
distribution is the rate-weighted mixture

    rate_c(t) = weight_c * active_c(t) * work_c * duty_c(t)
    probs(t)  = sum_c rate_c * p_c / sum_c rate_c,   work(t) = sum_c rate_c

and ``mix``, ``phases``, ``scale`` and ``drift`` compose scenarios.

f32 arithmetic.  Every product, quotient and sum rounds as in the JAX
package's compiled CPU program: sums over a row of n pages follow XLA's
CPU order (windows of 32 added left to right from zero, the window sums
again, ``_xla_sum``), and the mixture's ``sum_c rate_c * p_c`` fuses
each product into the running sum as XLA does (``fma``).  ``exp`` is
XLA's own polynomial, step for step (``_exp``).  ``pow`` is computed in
f64 and rounded once, the same f32 on the CPU and the card; XLA's f32
``pow`` (glibc's ``powf``) differs from that in the last bit of under
one element in a thousand, so a zipf row is within a few ulps of JAX's
(3 at n = 65,536; ROADMAP queue 3), while hot-set, xsbench and tpcc rows
are JAX's bits; XLA also rewrites ``pow(exp(a), w)`` as ``exp(a * w)``, and so
does tpcc here.  Divisors are tensors, never Python scalars (PyTorch's
CUDA ``div`` and ``__rtruediv__`` use a reciprocal).
"""
from __future__ import annotations

import zlib

import numpy as np
import torch

from repro_torch.kernels.interval_step.ref import fma
from repro_torch.utils import prng
from repro_torch.utils.device import resolve_device
from repro_torch.utils.pytree import tensor_dataclass, tree_map

DEFAULT_PAGES = 4096      # 8 GiB RSS at 2 MB pages
DEFAULT_WORK = 2.0e7      # true accesses per interval
NEVER = 1 << 30           # i32-safe "no event" period

KIND_ZIPF, KIND_HOTSET, KIND_XSBENCH, KIND_TPCC, KIND_ZIPF_BOOST = range(5)

#: module counter: every host materialization bumps it (a synthesized
#: sweep must leave it unchanged).
MATERIALIZE_CALLS = 0

_F32 = ("work", "weight", "s", "hot_frac", "hot_weight", "window_frac",
        "drift_pages", "boost_frac", "boost_gain", "duty", "idle_scale",
        "drift_rate")
_I32 = ("kind", "t_start", "t_end", "shift_every", "boost_every", "period",
        "phase_off", "seed")


@tensor_dataclass
class WorkloadState:
    rank: torch.Tensor      # i32 [..., S, n] zipf ranks / hot order
    rank2: torch.Tensor     # i32 [..., S, n] boost-set permutation (gapbs)
    base_key: torch.Tensor  # i64 [..., S, 2] event key (uint32 words)


def _xla_sum(x):
    """f32 sum over the last axis in XLA's CPU order: while more than 32
    remain, zero-pad evenly to a multiple of 32 and add each window of 32
    left to right from zero; then add what is left the same way."""
    while x.shape[-1] > 32:
        n = x.shape[-1]
        m = -(-n // 32)
        pad = m * 32 - n
        if pad:
            x = torch.nn.functional.pad(x, (pad // 2, pad - pad // 2))
        x = _seq_sum(x.reshape(x.shape[:-1] + (m, 32)))
    return _seq_sum(x)


def _seq_sum(x):
    acc = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    for j in range(x.shape[-1]):
        acc = acc + x[..., j]
    return acc


def _pow(x, y):
    return torch.pow(x.double(), y.double()).float()


#: XLA's f32 exp on the CPU: Cephes' polynomial with fused multiply-adds.
_LOG2E = 1.44269504088896341
_LN2_HI, _LN2_LO = -0.693359375, 2.12194440e-4
_EXP_POLY = (1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3,
             4.1665795894e-2, 1.6666665459e-1, 5.0000001201e-1)


def _exp(x):
    """f32 ``exp`` rounded as XLA's CPU code rounds it (the JAX package's
    compiled program): ``x = m ln2 + r`` with ``m = floor(x log2e +
    1/2)``, ``r`` in two FMA steps, ``e^r`` by a degree-5 Horner chain of
    FMAs, scaled by ``2^m``.  Every step is an IEEE f32 op or an exact
    ``fma``, so the CPU and the card agree.  Inputs are clamped to
    [-87, 88] (the tpcc window never leaves [-2, 0]; values outside it are
    masked)."""
    x = torch.clamp(x, -87.0, 88.0)
    c = lambda v: torch.full_like(x, float(np.float32(v)))
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


def _c(v, like):
    """An f32 constant on ``like``'s device (a tensor operand, so CUDA
    divides by it exactly)."""
    return torch.full((), float(np.float32(v)), dtype=torch.float32,
                      device=like.device)


def _mod(x, y):
    """``jnp.mod`` of floats: C ``fmod`` (exact), moved to the divisor's
    sign."""
    r = torch.fmod(x, y)
    return torch.where((r != 0) & ((r < 0) != (y < 0)), r + y, r)


def _drift_shift(drift_rate, tf, n: int):
    """Pages the whole distribution has drifted by at ``tf`` (i64 in
    ``[0, n)``): ``floor(drift_rate * t)`` as i32, mod n."""
    return torch.remainder(
        torch.floor(drift_rate * tf).to(torch.int32).long(), n)


def _tpcc_head(drift_pages, span, tf):
    """Offset of the tpcc window's head at ``tf``: ``floor(drift_pages *
    t) mod span`` in f32 (exact: an IEEE product, floor, fmod)."""
    return _mod(torch.floor(drift_pages * tf), span)


def _mixture(p, rate, tot, live, n: int):
    """The rate-weighted mixture ``sum_c rate_c * p_c / tot`` of the
    component rows ``p [..., S, n]`` under ``rate [..., S]`` and its sum
    ``tot [...]``, uniform where ``tot`` is 0.  Each product is fused
    into the running sum from zero (``fma``, as XLA fuses it), over the
    components ``live`` only: ``fma(0, p, acc)`` is ``acc``, so one whose
    rate is 0 in every lane is skipped, and the first product alone is
    ``fma(r, p, 0)``."""
    acc = None
    for c in live:
        r = rate[..., c, None]
        acc = p[..., c, :] * r if acc is None else fma(
            r.expand_as(acc), p[..., c, :], acc)
    if acc is None:
        acc = torch.zeros_like(p[..., 0, :])
    acc = acc / torch.clamp_min(tot, 1e-30)[..., None]
    return torch.where(tot[..., None] > 0.0, acc, _c(1.0 / n, acc))


def _tpcc_window(window_frac, nf):
    """(w, span) of the tpcc window: ``w`` pages, its head moving over
    ``span`` positions."""
    w = torch.clamp(torch.round(nf * window_frac), _c(1.0, nf), nf - 1.0)
    return w, torch.clamp_min(nf - w, 1.0)


def _tpcc_value(off, w, nf):
    """Unnormalized tpcc mass of a page ``off`` pages past the window's
    head: a floor of 0.05/n, plus a geometric ramp inside the window."""
    inwin = (off >= 0.0) & (off < w)
    a = _c(-2.0, nf) / w
    q = _exp(a)
    # XLA rewrites pow(exp(a), w) as exp(a * w)
    denom = torch.where(w > 1.0, (1.0 - _exp(a * w)) / (1.0 - q),
                        _c(1.0, nf))
    dec = _exp(-(w - 1.0 - off) / (w * 0.5))
    return _c(0.05, nf) / nf + torch.where(inwin, 0.95 * dec / denom,
                                           _c(0.0, nf))


class _Host:
    """Numpy copies of a spec's leaves, read once per call: the event
    schedule and the kinds present are host decisions."""

    def __init__(self, spec):
        for f in _F32 + _I32:
            setattr(self, f, getattr(spec, f).detach().cpu().numpy())

    def due(self, t: int):
        """(rank redraw, boost redraw) bool masks [..., S] at ``t``."""
        se = np.maximum(self.shift_every, 1)
        be = np.maximum(self.boost_every, 1)
        active = (t >= self.t_start) & (t < self.t_end) & (t > 0)
        return active & (t % se == 0), active & (t % be == 0)

    def kinds(self) -> tuple:
        return tuple(sorted({int(k) for k in self.kind.reshape(-1)}))


def _fresh(base_key, tag: int, epoch, n: int):
    """Permutations keyed ``fold_in(fold_in(bk, tag), epoch)``: ``base_key``
    [m, 2], ``epoch`` int or i64 [m] -> i32 [m, n]."""
    key = prng.fold_in(prng.fold_in(base_key, tag), epoch)
    return prng.permutation(key, n).to(torch.int32)


@tensor_dataclass
class WorkloadSpec:
    """Stack of S workload components; every field a batchable leaf."""

    kind: torch.Tensor          # i32 [S] component formula selector
    work: torch.Tensor          # f32 [S] true accesses/interval at full duty
    weight: torch.Tensor        # f32 [S] mixture weight
    t_start: torch.Tensor       # i32 [S] activity window [t_start, t_end)
    t_end: torch.Tensor         # i32 [S]
    s: torch.Tensor             # f32 [S] zipf exponent
    hot_frac: torch.Tensor      # f32 [S] hot-set fraction of n
    hot_weight: torch.Tensor    # f32 [S] access mass on the hot set
    shift_every: torch.Tensor   # i32 [S] rank-permutation redraw period
    window_frac: torch.Tensor   # f32 [S] tpcc sliding-window fraction
    drift_pages: torch.Tensor   # f32 [S] tpcc window drift (pages/interval)
    boost_every: torch.Tensor   # i32 [S] gapbs boost-set redraw period
    boost_frac: torch.Tensor    # f32 [S] gapbs boost-set fraction
    boost_gain: torch.Tensor    # f32 [S] gapbs boost mass (pre-normalize)
    period: torch.Tensor        # i32 [S] duty-cycle period (liblinear)
    duty: torch.Tensor          # f32 [S] busy fraction of the period
    phase_off: torch.Tensor     # i32 [S] duty-cycle phase offset (intervals)
    idle_scale: torch.Tensor    # f32 [S] work multiplier when idle
    drift_rate: torch.Tensor    # f32 [S] whole-distribution drift (combinator)
    seed: torch.Tensor          # i32 [S] per-component randomness seed

    # ---------------------------------------------------------------- init
    def init(self, n: int, key):
        """Fresh per-component state, draws keyed by (seed, epoch=0).
        ``key`` is one key ``[2]`` or one per lane ``[..., 2]``."""
        key = key.to(self.seed.device)
        bks = prng.fold_in(key.unsqueeze(-2), self.seed)     # [..., S, 2]
        flat = bks.reshape(-1, 2)
        shape = bks.shape[:-1] + (n,)
        return WorkloadState(rank=_fresh(flat, 1, 0, n).reshape(shape),
                             rank2=_fresh(flat, 2, 0, n).reshape(shape),
                             base_key=bks)

    # -------------------------------------------------------------- events
    def event_due(self, state, t: int, host: _Host | None = None) -> bool:
        """Does any ACTIVE component redraw a permutation at ``t``?  A host
        decision from the integer leaves (no device read)."""
        sd, bd = (host or _Host(self)).due(int(t))
        return bool(sd.any() or bd.any())

    def event(self, state, t: int, with_boost: bool = True,
              host: _Host | None = None):
        """Redraw the rank permutations of the due components, each keyed
        by its epoch; only those components are drawn (JAX draws all and
        keeps the due ones: the same result).  ``with_boost`` False skips
        the boost sets, which non-boost kinds never read."""
        host = host or _Host(self)
        t = int(t)
        n = state.rank.shape[-1]
        sd, bd = host.due(t)
        out = {}
        for name, due, tag, every in (
                ("rank", sd, 1, host.shift_every),
                ("rank2", bd if with_boost else None, 2, host.boost_every)):
            if due is None or not due.any():
                continue
            where = np.nonzero(due)
            epoch = t // np.maximum(every[where], 1)
            idx = tuple(torch.as_tensor(w, device=state.rank.device)
                        for w in where)
            fresh = _fresh(state.base_key[idx], tag,
                           torch.as_tensor(epoch.astype(np.int64),
                                           device=state.rank.device), n)
            cur = getattr(state, name).clone()
            cur[idx] = fresh
            out[name] = cur
        return state.replace(**out) if out else state

    # ------------------------------------------------------------- mixture
    def _rates(self, t: int):
        """f32 [..., S] per-component access rate this interval."""
        rate, _ = _host_rates(_Host(self), [t])
        return torch.from_numpy(rate[0]).to(self.kind.device)

    def _comp_probs(self, state, t: int, host: _Host | None = None):
        """f32 [..., S, n] per-component normalized access distributions.
        Only the kinds present are computed (JAX computes all five and
        selects: the same values)."""
        host = host or _Host(self)
        f32 = torch.float32
        rank = state.rank
        n = rank.shape[-1]
        dev = rank.device
        tf = _c(float(t), rank)
        nf = _c(float(n), rank)
        i = torch.arange(n, dtype=torch.int64, device=dev)
        shift = _drift_shift(self.drift_rate, tf, n)
        idx = torch.remainder(i - shift[..., None], n)       # [..., S, n]
        if np.any(host.drift_rate != 0):
            r = torch.gather(rank, -1, idx).to(f32)
            r2 = torch.gather(state.rank2, -1, idx).to(f32)
        else:
            r, r2 = rank.to(f32), state.rank2.to(f32)
        col = lambda x: x[..., None]
        one = _c(1.0, rank)
        clip_k = lambda frac: torch.clamp(torch.round(nf * col(frac)),
                                          one, nf)

        def zipf():
            return _pow(r + 1.0, -col(self.s))

        def hotset():
            kh = clip_k(self.hot_frac)
            return torch.where(
                r < kh, col(self.hot_weight) / kh,
                (1.0 - col(self.hot_weight)) / torch.clamp_min(nf - kh, 1.0))

        def xsb():
            kh = clip_k(self.hot_frac)
            half = _c(0.5, rank)
            return half / nf + torch.where(r < kh, half / kh,
                                           _c(0.0, rank))

        def tpcc():
            w, span = _tpcc_window(col(self.window_frac), nf)
            head = _tpcc_head(col(self.drift_pages), span, tf)
            return _tpcc_value(idx.to(f32) - head, w, nf)

        def boost():
            m = zipf()
            base = m / torch.clamp_min(_xla_sum(m), 1e-30)[..., None]
            nb = clip_k(self.boost_frac)
            return base + torch.where(r2 < nb, col(self.boost_gain) / nb,
                                      _c(0.0, rank))

        formulas = {KIND_ZIPF: zipf, KIND_HOTSET: hotset, KIND_XSBENCH: xsb,
                    KIND_TPCC: tpcc, KIND_ZIPF_BOOST: boost}
        kinds = host.kinds()
        p = formulas[kinds[0]]()
        for kd in kinds[1:]:
            p = torch.where(col(self.kind) == kd, formulas[kd](), p)
        return p / torch.clamp_min(_xla_sum(p), 1e-30)[..., None]

    def probs_of(self, state, t: int, host: _Host | None = None):
        """f32 [..., n] interval access distribution (sums to 1 to f32
        tolerance)."""
        p = self._comp_probs(state, t, host)                 # [..., S, n]
        rate = self._rates(t)                                # [..., S]
        return _mixture(p, rate, _seq_sum(rate), range(p.shape[-2]),
                        p.shape[-1])

    def work_of(self, state, t: int):
        """f32 [...]: true accesses carried by this interval."""
        return _seq_sum(self._rates(t))

    def step(self, state, t: int, host: _Host | None = None):
        """Reference composition: the event if due, then the probs."""
        host = host or _Host(self)
        if self.event_due(state, t, host):
            state = self.event(state, t, host=host)
        return state, self.probs_of(state, t, host)

    # --------------------------------------------------- host conveniences
    @property
    def n_components(self) -> int:
        return int(self.kind.shape[-1])

    def max_rate(self) -> float:
        """Host upper bound on any page's true per-interval count (probs
        <= 1; the duty multiplier can exceed 1 via idle_scale)."""
        h = _Host(self)
        rate = np.abs(h.work * h.weight) \
            * np.maximum(np.abs(h.idle_scale), 1.0)
        return float(np.sum(rate))

    def has_boost(self) -> bool:
        """Can any component ever redraw its boost set?  Lets the engines
        skip the second permutation draw."""
        return bool(np.any(_Host(self).boost_every < NEVER))

    def materialize(self, T: int, n: int, seed: int = 0,
                    device=None) -> np.ndarray:
        """Dense f32 ``[T, n]`` trace, from the very functions the scan
        engine synthesizes with (``Synth``): bit for bit its rows on the
        same device under the same ``seed``."""
        global MATERIALIZE_CALLS
        MATERIALIZE_CALLS += 1
        dev = resolve_device(device)
        syn = Synth(self.to(dev), n, prng.PRNGKey(seed, dev),
                    self.has_boost(), T)
        return torch.stack([syn.row(t) for t in range(T)]).cpu().numpy()


def _host_rates(h: _Host, ts):
    """Per-component access rates at the intervals ``ts``, computed on the
    host in f32 (``weight * active * work * duty multiplier``), and their
    sums over the components from zero (``work_of``): f32
    ``[len(ts), ..., S]`` and ``[len(ts), ...]``."""
    f32 = np.float32
    t = np.asarray(ts, np.int64).reshape((-1,) + (1,) * h.kind.ndim)
    active = ((t >= h.t_start) & (t < h.t_end)).astype(f32)
    per = np.maximum(h.period, 1)
    busy = ((t + h.phase_off) % per).astype(f32) < h.duty * per.astype(f32)
    m = np.where(busy, f32(1.0), h.idle_scale)
    rate = h.weight * active * h.work * m
    tot = np.zeros(rate.shape[:-1], f32)
    for c in range(rate.shape[-1]):
        tot = tot + rate[..., c]
    return rate, tot


class Synth:
    """Interval-by-interval synthesis of a (lane-batched) spec: ``row(t)``
    runs the event gate, the event on due intervals, the per-component
    distributions and the rate-weighted mixture, and returns ``true =
    work * probs`` [..., n] for ``t < T``.  ``materialize`` and the scan
    engine both read it, so their rows are the same bits.

    The result is bit for bit ``work_of(t) * probs_of(state, t)`` (the
    same helpers: ``_comp_probs``, ``_tpcc_head``, ``_drift_shift``,
    ``_mixture``), with less work an interval: the rates and their sums
    are computed once for every t (``_host_rates``); a component whose
    distribution does not move with t (no drift, not tpcc) is computed
    after each event and kept; a tpcc component's unnormalized row is a
    slice (a gather, under drift) of its mass tabulated once over every
    offset from the head; components of rate 0 in every lane are left out
    of the mixture.
    """

    def __init__(self, spec, n: int, key, with_boost: bool, T: int):
        self.spec, self.n, self.T, self.with_boost = spec, n, T, with_boost
        self.host = h = _Host(spec)
        self.lead = tuple(spec.kind.shape[:-1])
        S = spec.kind.shape[-1]
        W = int(np.prod(self.lead, dtype=np.int64))
        self.W, self.S = W, S
        dev = spec.kind.device
        self.state = spec.init(n, key)
        rate, tot = _host_rates(h, np.arange(T))
        self.rate_h = rate.reshape(T, W, S)
        self.rate = torch.from_numpy(self.rate_h).to(dev)
        self.tot = torch.from_numpy(tot.reshape(T, W)).to(dev)
        self.P = None                           # [W, S, n] component rows
        kind = h.kind.reshape(W, S)
        drift = h.drift_rate.reshape(W, S)
        flat = lambda x, at: x.reshape(W, S)[at]
        tp = np.nonzero(kind == KIND_TPCC)
        mv = np.nonzero((kind != KIND_TPCC) & (drift != 0))
        self.tp = tuple(torch.as_tensor(a, device=dev) for a in tp)
        self.mv = tuple(torch.as_tensor(a, device=dev) for a in mv)
        self.i = torch.arange(n, dtype=torch.int64, device=dev)
        if tp[0].size:
            nf = _c(float(n), spec.kind)
            w, span = _tpcc_window(flat(spec.window_frac, self.tp)[:, None],
                                   nf)
            off = torch.arange(-n, n, device=dev).to(torch.float32)
            self.table = _tpcc_value(off[None], w, nf)      # [m, 2n]
            # the head and the drift shift of every t at once: [T, m]
            tf = torch.arange(T, dtype=torch.float32, device=dev)[:, None]
            self.head = _tpcc_head(flat(spec.drift_pages, self.tp),
                                   span[:, 0], tf).long().cpu().numpy()
            self.tp_shift = _drift_shift(flat(spec.drift_rate, self.tp), tf,
                                         n).cpu().numpy()
        if mv[0].size:
            self.mv_spec = tree_map(lambda x: flat(x, self.mv), spec)
            self.mv_host = _Host(self.mv_spec)

    def _tpcc_rows(self, t: int):
        rows = []
        for j in range(self.table.shape[0]):
            head, shift = int(self.head[t, j]), int(self.tp_shift[t, j])
            if shift == 0:
                rows.append(self.table[j, self.n - head:2 * self.n - head])
            else:
                at = torch.remainder(self.i - shift, self.n) - head + self.n
                rows.append(self.table[j].index_select(0, at))
        u = torch.stack(rows)
        return u / torch.clamp_min(_xla_sum(u), 1e-30)[:, None]

    def _moving_rows(self, t: int):
        st = self.state
        sub = WorkloadState(
            rank=st.rank.reshape(self.W, self.S, -1)[self.mv],
            rank2=st.rank2.reshape(self.W, self.S, -1)[self.mv],
            base_key=st.base_key.reshape(self.W, self.S, 2)[self.mv])
        return self.mv_spec._comp_probs(sub, t, self.mv_host)

    def row(self, t: int):
        spec, host, n = self.spec, self.host, self.n
        if spec.event_due(self.state, t, host):
            self.state = spec.event(self.state, t, self.with_boost, host)
            self.P = None
        if self.P is None:
            self.P = spec._comp_probs(self.state, t, host).reshape(
                self.W, self.S, n)
        if self.tp[0].numel():
            self.P[self.tp] = self._tpcc_rows(t)
        if self.mv[0].numel():
            self.P[self.mv] = self._moving_rows(t)
        live = np.flatnonzero((self.rate_h[t] != 0).any(axis=0))
        probs = _mixture(self.P, self.rate[t], self.tot[t], live, n)
        return (self.tot[t][:, None] * probs).reshape(self.lead + (n,))


# --------------------------------------------------------------- builders
def _comp(kind, *, work=DEFAULT_WORK, weight=1.0, t_start=0, t_end=NEVER,
          s=0.0, hot_frac=0.0, hot_weight=0.0, shift_every=NEVER,
          window_frac=0.0, drift_pages=0.0, boost_every=NEVER,
          boost_frac=0.0, boost_gain=0.0, period=1, duty=1.0,
          phase_off=0, idle_scale=1.0, drift_rate=0.0, seed=0) -> dict:
    return dict(kind=kind, work=work, weight=weight, t_start=t_start,
                t_end=t_end, s=s, hot_frac=hot_frac, hot_weight=hot_weight,
                shift_every=max(1, int(shift_every)),
                window_frac=window_frac, drift_pages=drift_pages,
                boost_every=max(1, int(boost_every)), boost_frac=boost_frac,
                boost_gain=boost_gain, period=max(1, int(period)), duty=duty,
                phase_off=int(phase_off), idle_scale=idle_scale,
                drift_rate=drift_rate, seed=int(seed))


def _from_comps(comps: list[dict]) -> WorkloadSpec:
    cols = {}
    for f in _F32:
        cols[f] = torch.tensor(np.asarray([c[f] for c in comps], np.float32))
    for f in _I32:
        cols[f] = torch.tensor(np.asarray([c[f] for c in comps], np.int32))
    return WorkloadSpec(**cols)


def _to_comps(spec: WorkloadSpec) -> list[dict]:
    cols = vars(_Host(spec))
    S = cols["kind"].shape[0]
    return [{f: cols[f][c].item() for f in _F32 + _I32} for c in range(S)]


def with_label(spec: WorkloadSpec, label: str) -> WorkloadSpec:
    """Attach a display label (kept off the leaves; purely cosmetic)."""
    object.__setattr__(spec, "_label", label)
    return spec


def label_of(spec, default: str = "workload") -> str:
    return getattr(spec, "_label", default)


# ------------------------------------------------------- named workloads
def gups_spec(work=DEFAULT_WORK, seed=0, hot_frac=0.125, hot_weight=0.9,
              shift_every=150) -> WorkloadSpec:
    """Uniform accesses within a small hot set that relocates periodically."""
    return with_label(_from_comps([_comp(
        KIND_HOTSET, work=work, hot_frac=hot_frac, hot_weight=hot_weight,
        shift_every=shift_every, seed=seed)]), "gups")


def zipf_spec(s=0.99, work=DEFAULT_WORK, seed=1,
              shuffle_every=NEVER) -> WorkloadSpec:
    """Zipf distribution over a random permutation, optional reshuffles."""
    return with_label(_from_comps([_comp(
        KIND_ZIPF, work=work, s=s, shift_every=shuffle_every, seed=seed)]),
        "zipf")


def tpcc_spec(work=DEFAULT_WORK, seed=4, window_frac=0.15,
              drift_pages=2.0) -> WorkloadSpec:
    """"Latest" distribution: hot window slides as rows are inserted."""
    return with_label(_from_comps([_comp(
        KIND_TPCC, work=work, window_frac=window_frac,
        drift_pages=drift_pages, seed=seed)]), "silo-tpcc")


def xsbench_spec(work=DEFAULT_WORK, seed=5, hot_frac=0.02) -> WorkloadSpec:
    """Small very-hot lookup tables + uniform background over the RSS."""
    return with_label(_from_comps([_comp(
        KIND_XSBENCH, work=work, hot_frac=hot_frac, seed=seed)]), "xsbench")


def gapbs_spec(s=0.8, work=DEFAULT_WORK, seed=6, boost_every=40,
               boost_frac=0.05, boost_gain=0.3) -> WorkloadSpec:
    """Power-law degree distribution + periodic frontier boosts."""
    return with_label(_from_comps([_comp(
        KIND_ZIPF_BOOST, work=work, s=s, boost_every=boost_every,
        boost_frac=boost_frac, boost_gain=boost_gain, seed=seed)]), "gapbs")


def liblinear_spec(work=DEFAULT_WORK, seed=9, period=20, duty=0.5,
                   idle_scale=0.02) -> WorkloadSpec:
    """Periodic memory-intensive zipf sweeps alternating with near-idle
    compute phases (batched migration's best case, paper §7.2)."""
    return with_label(_from_comps([_comp(
        KIND_ZIPF, work=work, s=0.6, period=period, duty=duty,
        idle_scale=idle_scale, seed=seed)]), "liblinear")


def zipf_shuffled_spec(s=0.99, work=DEFAULT_WORK, seed=1,
                       shuffle_at=()) -> WorkloadSpec:
    """Zipf with ONE-SHOT reshuffles at the given times: each reshuffle
    switches to an independently-permuted zipf phase (``phases``)."""
    times = sorted({int(v) for v in shuffle_at})
    children = [zipf_spec(s=s, work=work, seed=seed + 7919 * i)
                for i in range(len(times) + 1)]
    if not times:
        return children[0]
    return with_label(phases(children, times), "zipf")


def btree_spec(T: int = 400, work=DEFAULT_WORK, seed=2) -> WorkloadSpec:
    """Zipf index lookups with one hot-set reshuffle at T // 2 (Fig. 9)."""
    return with_label(zipf_shuffled_spec(
        s=0.9, work=work, seed=seed, shuffle_at=(max(1, T // 2),)), "btree")


#: name -> spec constructor taking (T, work, seed).  ``T`` only matters for
#: btree's mid-run reshuffle (a hot-set change at T // 2).
_NAMED = {
    "gups": lambda T, work, seed: gups_spec(work=work, seed=seed),
    "btree": lambda T, work, seed: btree_spec(T, work=work, seed=seed),
    "silo-ycsb": lambda T, work, seed: zipf_spec(
        s=0.99, work=work, seed=seed),
    "silo-tpcc": lambda T, work, seed: tpcc_spec(work=work, seed=seed),
    "xsbench": lambda T, work, seed: xsbench_spec(work=work, seed=seed),
    "gapbs-bc": lambda T, work, seed: gapbs_spec(
        s=0.8, work=work, seed=seed, boost_every=40, boost_frac=0.05,
        boost_gain=0.3),
    "gapbs-pr": lambda T, work, seed: zipf_spec(
        s=0.7, work=work, seed=seed),
    "gapbs-cc": lambda T, work, seed: gapbs_spec(
        s=0.75, work=work, seed=seed, boost_every=100, boost_frac=0.1,
        boost_gain=0.2),
    "liblinear": lambda T, work, seed: liblinear_spec(work=work, seed=seed),
}

NAMED_WORKLOADS = tuple(sorted(_NAMED))


def named(name: str, T: int = 400, work: float = DEFAULT_WORK,
          seed: int | None = None, seed_offset: int = 0) -> WorkloadSpec:
    """Spec for a paper workload by name (seed: crc32 of the name mod
    1000, plus ``seed_offset``, unless an explicit ``seed`` is given)."""
    if name not in _NAMED:
        raise ValueError(f"unknown workload {name!r}; "
                         f"known: {sorted(_NAMED)}")
    if seed is None:
        seed = zlib.crc32(name.encode()) % 1000 + seed_offset
    return with_label(_NAMED[name](T, work, seed), name)


# ------------------------------------------------------------ combinators
def phases(specs: list[WorkloadSpec], boundaries: list[int],
           label: str | None = None) -> WorkloadSpec:
    """Piecewise scenario: ``specs[p]`` is active on ``[b_{p-1}, b_p)``;
    each child's own window is intersected with its phase window."""
    if len(boundaries) != len(specs) - 1:
        raise ValueError(f"phases wants len(boundaries) == len(specs) - 1; "
                         f"got {len(boundaries)} vs {len(specs)}")
    if any(b2 <= b1 for b1, b2 in zip(boundaries, boundaries[1:])):
        raise ValueError(f"boundaries must ascend; got {boundaries}")
    if boundaries and int(boundaries[0]) < 1:
        raise ValueError(f"first boundary must be >= 1; got {boundaries}")
    edges = [0] + [int(b) for b in boundaries] + [NEVER]
    comps = []
    for p, sp in enumerate(specs):
        for c in _to_comps(sp):
            c["t_start"] = max(c["t_start"], edges[p])
            c["t_end"] = min(c["t_end"], edges[p + 1])
            comps.append(c)
    return with_label(_from_comps(comps), label or "+".join(
        label_of(sp, f"p{i}") for i, sp in enumerate(specs)))


def mix(specs: list[WorkloadSpec], weights: list[float] | None = None,
        label: str | None = None) -> WorkloadSpec:
    """Rate-weighted mixture of the children; weights normalize to 1."""
    if weights is None:
        weights = [1.0] * len(specs)
    if len(weights) != len(specs):
        raise ValueError("mix wants one weight per spec")
    tot = float(sum(weights))
    if tot <= 0.0:
        raise ValueError("mix weights must sum > 0")
    comps = []
    for w, sp in zip(weights, specs):
        for c in _to_comps(sp):
            c["weight"] = c["weight"] * float(w) / tot
            comps.append(c)
    return with_label(_from_comps(comps), label or "mix(" + ",".join(
        label_of(sp, f"m{i}") for i, sp in enumerate(specs)) + ")")


def scale(spec: WorkloadSpec, work_mult: float) -> WorkloadSpec:
    """Scale a scenario's access intensity by ``work_mult``."""
    comps = _to_comps(spec)
    for c in comps:
        c["work"] *= float(work_mult)
    return with_label(_from_comps(comps),
                      f"{label_of(spec)}*{work_mult:g}")


def drift(spec: WorkloadSpec, pages_per_interval: float) -> WorkloadSpec:
    """March the whole access distribution forward by
    ``pages_per_interval`` pages per interval (mod n)."""
    comps = _to_comps(spec)
    for c in comps:
        c["drift_rate"] += float(pages_per_interval)
    return with_label(_from_comps(comps),
                      f"drift({label_of(spec)},{pages_per_interval:g})")


def pad_components(spec: WorkloadSpec, S: int) -> WorkloadSpec:
    """Extend to exactly ``S`` components with inert (never-active,
    zero-weight) filler so structurally different scenarios stack into one
    lane-batched sweep."""
    have = spec.n_components
    if have > S:
        raise ValueError(f"spec has {have} components > requested {S}")
    comps = _to_comps(spec)
    comps += [_comp(KIND_ZIPF, work=0.0, weight=0.0, t_end=0)
              for _ in range(S - have)]
    return with_label(_from_comps(comps), label_of(spec))
