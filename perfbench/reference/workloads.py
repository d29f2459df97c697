"""The paper's nine application analogues (Table 4), synthesised interval
by interval in plain torch.

Each workload is one or two components, each of a kind with its knobs:

  * zipf     -- p(rank) ~ (rank + 1)^-s over a random permutation;
  * hotset   -- ``hot_weight`` of the mass uniform over a hot set of
    ``hot_frac * n`` pages, the rest uniform; the hot set is redrawn
    every ``shift_every`` intervals (GUPS);
  * xsbench  -- half the mass uniform, half on ``hot_frac * n`` pages;
  * tpcc     -- a window of ``window_frac * n`` pages with a geometric
    ramp, its head moving ``drift_pages`` a interval, over a floor;
  * boost    -- zipf plus ``boost_gain`` on a boost set of ``boost_frac *
    n`` pages redrawn every ``boost_every`` intervals (GAPBS).

A component is active on ``[t_start, t_end)`` and carries ``work *
weight`` accesses a interval (``work``: the configuration's
``work_per_interval``), times ``idle_scale`` outside the busy share
``duty`` of its ``period``.  An interval's true counts are ``work(t) *
probs(t)``, the rate-weighted mixture of the component distributions.
Permutations are keyed ``fold_in(fold_in(fold_in(wl_key, seed), tag),
epoch)`` (tag 1 the rank, 2 the boost set).

The rounding follows the replay under test (``numerics``): row sums in
XLA's order, the mixture fused into its running sum, ``pow`` in f64, the
tpcc ramp's ``exp`` as XLA's polynomial.  Rows are [W, S, n] over the W
workloads and their S components; a workload with fewer components than
another is padded with an inert one that is never active.
"""
from __future__ import annotations

import zlib

import numpy as np
import torch

from perfbench.reference import prng
from perfbench.reference.numerics import (const, exp_cephes, fma, pow64,
                                          xla_sum)

NEVER = 1 << 30
ZIPF, HOTSET, XSBENCH, TPCC, BOOST = range(5)
FIELDS_F = ("work", "weight", "s", "hot_frac", "hot_weight", "window_frac",
            "drift_pages", "boost_frac", "boost_gain", "duty", "idle_scale")
FIELDS_I = ("kind", "t_start", "t_end", "shift_every", "boost_every",
            "period", "phase_off", "seed")


def _comp(kind, seed, **kw):
    c = dict(kind=kind, work=0.0, weight=1.0, t_start=0, t_end=NEVER,
             s=0.0, hot_frac=0.0, hot_weight=0.0, shift_every=NEVER,
             window_frac=0.0, drift_pages=0.0, boost_every=NEVER,
             boost_frac=0.0, boost_gain=0.0, period=1, duty=1.0,
             phase_off=0, idle_scale=1.0, seed=seed)
    c.update(kw)
    return c


def components(name: str, T: int, work: float) -> list:
    """The components of a named workload over a T-interval run, each
    carrying ``work`` accesses an interval."""
    return [dict(c, work=float(work)) for c in _named(name, T)]


def _named(name: str, T: int) -> list:
    """A named workload's components; the default seed is crc32 of the
    name mod 1000."""
    sd = zlib.crc32(name.encode()) % 1000
    if name == "gups":
        return [_comp(HOTSET, sd, hot_frac=0.125, hot_weight=0.9,
                      shift_every=150)]
    if name == "btree":      # zipf 0.9, a fresh permutation at T // 2
        mid = max(1, T // 2)
        return [_comp(ZIPF, sd, s=0.9, t_end=mid),
                _comp(ZIPF, sd + 7919, s=0.9, t_start=mid)]
    if name == "silo-ycsb":
        return [_comp(ZIPF, sd, s=0.99)]
    if name == "silo-tpcc":
        return [_comp(TPCC, sd, window_frac=0.15, drift_pages=2.0)]
    if name == "xsbench":
        return [_comp(XSBENCH, sd, hot_frac=0.02)]
    if name == "gapbs-bc":
        return [_comp(BOOST, sd, s=0.8, boost_every=40, boost_frac=0.05,
                      boost_gain=0.3)]
    if name == "gapbs-pr":
        return [_comp(ZIPF, sd, s=0.7)]
    if name == "gapbs-cc":
        return [_comp(BOOST, sd, s=0.75, boost_every=100, boost_frac=0.1,
                      boost_gain=0.2)]
    if name == "liblinear":
        return [_comp(ZIPF, sd, s=0.6, period=20, duty=0.5, idle_scale=0.02)]
    raise ValueError(f"unknown workload {name!r}")


def _stack(names, T, work):
    comps = [components(nm, T, work) for nm in names]
    S = max(len(c) for c in comps)
    for c in comps:
        c += [_comp(ZIPF, 0, work=0.0, weight=0.0, t_end=0)
              for _ in range(S - len(c))]
    cols = {f: np.array([[c[f] for c in cs] for cs in comps], np.float32)
            for f in FIELDS_F}
    cols.update({f: np.array([[c[f] for c in cs] for cs in comps], np.int64)
                 for f in FIELDS_I})
    return cols


def _rates(h, T: int):
    """f32 per-component rates [T, W, S] and their sums [T, W]."""
    t = np.arange(T, dtype=np.int64).reshape(T, 1, 1)
    active = ((t >= h["t_start"]) & (t < h["t_end"])).astype(np.float32)
    per = np.maximum(h["period"], 1)
    busy = ((t + h["phase_off"]) % per).astype(np.float32) \
        < h["duty"] * per.astype(np.float32)
    m = np.where(busy, np.float32(1.0), h["idle_scale"])
    rate = h["weight"] * active * h["work"] * m
    tot = np.zeros(rate.shape[:-1], np.float32)
    for c in range(rate.shape[-1]):
        tot = tot + rate[..., c]
    return rate, tot


def _tpcc_value(off, w, nf):
    inwin = (off >= 0.0) & (off < w)
    a = const(-2.0, nf) / w
    q = exp_cephes(a)
    denom = torch.where(w > 1.0, (1.0 - exp_cephes(a * w)) / (1.0 - q),
                        const(1.0, nf))
    dec = exp_cephes(-(w - 1.0 - off) / (w * 0.5))
    return const(0.05, nf) / nf + torch.where(inwin, 0.95 * dec / denom,
                                              const(0.0, nf))


def _tpcc_window(frac, nf):
    w = torch.clamp(torch.round(nf * frac), const(1.0, nf), nf - 1.0)
    return w, torch.clamp_min(nf - w, 1.0)


def _mod(x, y):
    r = torch.fmod(x, y)
    return torch.where((r != 0) & ((r < 0) != (y < 0)), r + y, r)


class Synth:
    """``row(t)`` -> f32 [W, n] true access counts of interval ``t``."""

    def __init__(self, names, T: int, n: int, wl_seed: int, work: float,
                 device):
        self.T, self.n, self.dev = T, n, device
        self.h = h = _stack(list(names), T, work)
        self.W, self.S = h["kind"].shape
        tf = lambda f: torch.from_numpy(h[f]).to(device)
        self.p = {f: tf(f) for f in FIELDS_F}
        self.kind = tf("kind")
        self.rate_h, tot = _rates(h, T)
        self.rate = torch.from_numpy(self.rate_h).to(device)
        self.tot = torch.from_numpy(tot).to(device)
        self.with_boost = bool(np.any(h["boost_every"] < NEVER))
        wk = prng.key(wl_seed, device)
        seeds = torch.from_numpy(h["seed"]).to(device)
        self.base = prng.fold_in(wk.expand(self.W, self.S, 2), seeds)
        flat = self.base.reshape(-1, 2)
        self.rank = self._fresh(flat, 1, 0).reshape(self.W, self.S, n)
        self.rank2 = self._fresh(flat, 2, 0).reshape(self.W, self.S, n)
        self.P = None
        self.nf = const(float(n), self.kind)
        tp = np.nonzero(h["kind"] == TPCC)
        self.tp = tuple(torch.as_tensor(a, device=device) for a in tp)
        if tp[0].size:
            w, span = _tpcc_window(self.p["window_frac"][self.tp][:, None],
                                   self.nf)
            off = torch.arange(-n, n, device=device).to(torch.float32)
            self.table = _tpcc_value(off[None], w, self.nf)
            tcol = torch.arange(T, dtype=torch.float32, device=device)[:, None]
            drift = self.p["drift_pages"][self.tp]
            self.head = _mod(torch.floor(drift * tcol),
                             span[:, 0]).long().cpu().numpy()

    def _fresh(self, base, tag, epoch):
        k = prng.fold_in(prng.fold_in(base, tag), epoch)
        return prng.permutation(k, self.n).to(torch.int32)

    def _due(self, t):
        h = self.h
        active = (t >= h["t_start"]) & (t < h["t_end"]) & (t > 0)
        return (active & (t % np.maximum(h["shift_every"], 1) == 0),
                active & (t % np.maximum(h["boost_every"], 1) == 0))

    def _event(self, t):
        sd, bd = self._due(t)
        for name, due, tag, every in (("rank", sd, 1, self.h["shift_every"]),
                                      ("rank2", bd if self.with_boost
                                       else None, 2, self.h["boost_every"])):
            if due is None or not due.any():
                continue
            where = np.nonzero(due)
            epoch = torch.as_tensor(
                (t // np.maximum(every[where], 1)).astype(np.int64),
                device=self.dev)
            idx = tuple(torch.as_tensor(w, device=self.dev) for w in where)
            cur = getattr(self, name).clone()
            cur[idx] = self._fresh(self.base[idx], tag, epoch)
            setattr(self, name, cur)

    def _comp_probs(self):
        f32 = torch.float32
        p, nf = self.p, self.nf
        r, r2 = self.rank.to(f32), self.rank2.to(f32)
        col = lambda x: x[..., None]
        one = const(1.0, nf)
        clip_k = lambda frac: torch.clamp(torch.round(nf * col(frac)), one, nf)

        def zipf():
            return pow64(r + 1.0, -col(p["s"]))

        def hotset():
            kh = clip_k(p["hot_frac"])
            return torch.where(
                r < kh, col(p["hot_weight"]) / kh,
                (1.0 - col(p["hot_weight"])) / torch.clamp_min(nf - kh, 1.0))

        def xsb():
            kh = clip_k(p["hot_frac"])
            half = const(0.5, nf)
            return half / nf + torch.where(r < kh, half / kh, const(0.0, nf))

        def tpcc():     # rows replaced from the table every interval
            return torch.ones_like(r)

        def boost():
            m = zipf()
            base = m / torch.clamp_min(xla_sum(m), 1e-30)[..., None]
            nb = clip_k(p["boost_frac"])
            return base + torch.where(r2 < nb, col(p["boost_gain"]) / nb,
                                      const(0.0, nf))

        formulas = {ZIPF: zipf, HOTSET: hotset, XSBENCH: xsb, TPCC: tpcc,
                    BOOST: boost}
        kinds = sorted({int(x) for x in self.h["kind"].reshape(-1)})
        out = formulas[kinds[0]]()
        for kd in kinds[1:]:
            out = torch.where(col(self.kind) == kd, formulas[kd](), out)
        return out / torch.clamp_min(xla_sum(out), 1e-30)[..., None]

    def row(self, t: int):
        sd, bd = self._due(t)
        if sd.any() or (self.with_boost and bd.any()):
            self._event(t)
            self.P = None
        if self.P is None:
            self.P = self._comp_probs()
        if self.tp[0].numel():
            rows = [self.table[j, self.n - int(hd):2 * self.n - int(hd)]
                    for j, hd in enumerate(self.head[t])]
            u = torch.stack(rows)
            self.P[self.tp] = u / torch.clamp_min(xla_sum(u), 1e-30)[:, None]
        live = np.flatnonzero((self.rate_h[t] != 0).any(axis=0))
        rate, tot = self.rate[t], self.tot[t]
        acc = None
        for c in live:
            r = rate[:, c, None]
            acc = self.P[:, c, :] * r if acc is None else fma(
                r.expand_as(acc), self.P[:, c, :], acc)
        if acc is None:
            acc = torch.zeros_like(self.P[:, 0, :])
        acc = acc / torch.clamp_min(tot, 1e-30)[:, None]
        probs = torch.where(tot[:, None] > 0.0, acc,
                            const(1.0 / self.n, acc))
        return tot[:, None] * probs
