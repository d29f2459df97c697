"""Adversarial thrashing scenarios: WorkloadSpec combinators sized
RELATIVE to the machine (the port of ``repro/simulator/scenarios.py``).

Every constructor takes the run geometry ``(n, k)`` — total pages and
fast-tier capacity (``machine_spec.resolved_caps`` pins tier-0 capacity
to ``k`` on every preset, so one scenario spec instantiates unchanged
across machines) — and returns a plain ``WorkloadSpec``.  The suite is
built to stress the failure modes a robustness leaderboard scores:

  * ``capacity_straddle`` — working sets at 0.9x / 1.0x / 1.1x the fast
    tier: just-fits rewards placement, just-misses punishes policies that
    keep migrating the overflow (the classic thrash inducer);
  * ``phase_flip`` — two antiphase hot sets alternating on a fast duty
    cycle: a responsive policy without thrash avoidance chases every
    flip (Jenga's motivating pathology);
  * ``drifting_hot`` — the hot set marches through the address space, so
    yesterday's placement decays at a constant rate;
  * ``duty_cycled_tenants`` — staggered tenants whose hot sets sum past
    fast-tier capacity: pressure arrives as a rotating schedule, not a
    steady state.

Degenerate knobs are clamped here (like the ``hot_frac=1.0`` clamps of
workload_spec.py): drift rates wrap mod n, flip periods floor at 2
intervals, and hot fractions never round below one page.
"""
from __future__ import annotations

from repro_torch.simulator.workload_spec import (DEFAULT_WORK, KIND_HOTSET,
                                                 WorkloadSpec, _comp,
                                                 _from_comps, _to_comps,
                                                 drift, with_label)

__all__ = ["capacity_straddle", "phase_flip", "drifting_hot",
           "duty_cycled_tenants", "serving_mix", "suite",
           "STRADDLE_RATIOS"]

STRADDLE_RATIOS = (0.9, 1.0, 1.1)


def _hot_frac(pages: float, n: int) -> float:
    """Hot-set fraction for ``pages`` hot pages, never rounding below one
    page."""
    return min(max(float(pages), 1.0), float(n)) / float(n)


def capacity_straddle(n: int, k: int, ratio: float,
                      work: float = DEFAULT_WORK, seed: int = 11,
                      shift_every: int = 200) -> WorkloadSpec:
    """Hot working set sized at ``ratio`` x fast-tier capacity."""
    spec = _from_comps([_comp(
        KIND_HOTSET, work=work, hot_frac=_hot_frac(ratio * k, n),
        hot_weight=0.95, shift_every=shift_every, seed=seed)])
    return with_label(spec, f"straddle-{ratio:g}x")


def phase_flip(n: int, k: int, period: int = 10,
               work: float = DEFAULT_WORK, seed: int = 23) -> WorkloadSpec:
    """Two antiphase hot sets flipping every ``period // 2`` intervals.

    Each set alone fits the fast tier, so an oracle simply holds the
    union's hottest half; a reactive policy re-migrates ~k pages every
    flip.  ``period`` floors at 2 (a zero-length flip window would
    silently degenerate to one always-on hot set).
    """
    period = max(int(period), 2)
    half = period // 2
    mk = lambda off, sd: _comp(
        KIND_HOTSET, work=work, hot_frac=_hot_frac(0.8 * k, n),
        hot_weight=0.95, period=period, duty=half / period, phase_off=off,
        idle_scale=0.02, seed=sd)
    spec = _from_comps([mk(0, seed), mk(period - half, seed + 1)])
    return with_label(spec, f"phase-flip-{period}")


def drifting_hot(n: int, k: int, rate: float = 2.0,
                 work: float = DEFAULT_WORK, seed: int = 31) -> WorkloadSpec:
    """Hot set marching ``rate`` pages/interval through the address space.

    ``rate`` wraps mod n (a drift of n pages/interval is a no-op; rates
    beyond n alias to their residue — the degenerate-knob clamp).
    """
    rate = float(rate) % float(n)
    base = _from_comps([_comp(
        KIND_HOTSET, work=work, hot_frac=_hot_frac(0.8 * k, n),
        hot_weight=0.95, seed=seed)])
    return with_label(drift(base, rate), f"drift-{rate:g}")


def duty_cycled_tenants(n: int, k: int, tenants: int = 3, period: int = 60,
                        work: float = DEFAULT_WORK,
                        seed: int = 41) -> WorkloadSpec:
    """Staggered tenants whose hot sets overflow the fast tier in
    aggregate: tenant ``i`` is busy for ``period // tenants`` intervals,
    offset so exactly one tenant is hot at a time — placement must follow
    the schedule, not a stationary distribution."""
    tenants = max(int(tenants), 2)
    period = max(int(period), tenants)
    slot = period // tenants
    comps = [_comp(
        KIND_HOTSET, work=work / tenants, hot_frac=_hot_frac(0.75 * k, n),
        hot_weight=0.9, period=period, duty=slot / period,
        phase_off=period - i * slot, idle_scale=0.05, seed=seed + i)
        for i in range(tenants)]
    return with_label(_from_comps(comps), f"tenants-{tenants}")


def serving_mix(n: int, k: int, tenants: int = 4, period: int = 48,
                specs: list[WorkloadSpec] | None = None,
                work: float = DEFAULT_WORK, seed: int = 53) -> WorkloadSpec:
    """Multi-tenant serving traffic: ``tenants`` request streams x
    staggered request phases.

    Each tenant's access shape comes from ``specs`` — typically specs
    fitted to traces captured from real serving runs; with ``specs=None``
    the defaults stand in for the fitted archetypes (chat-style
    concentrated KV reuse, wider churning RAG context, bursty MoE
    routing).  Tenants are duty-cycled onto staggered
    request phases (one tenant's burst at a time, ``duty_cycled_tenants``
    style) with per-tenant work scaled so aggregate load matches ``work``
    — pressure on the fast tier is a rotating schedule of heterogeneous
    hot sets, the serving-loop pathology the leaderboard scores.
    """
    tenants = max(int(tenants), 2)
    period = max(int(period), tenants)
    slot = period // tenants
    if specs is None:
        specs = [_from_comps([_comp(
            KIND_HOTSET, work=work,
            hot_frac=_hot_frac((0.5 + 0.25 * (i % 3)) * k, n),
            hot_weight=0.92, shift_every=80 + 40 * i, seed=seed + 7 * i)])
            for i in range(tenants)]
    comps = []
    for i in range(tenants):
        for c in _to_comps(specs[i % len(specs)]):
            c = dict(c, work=c["work"] / tenants, period=period,
                     duty=slot / period, phase_off=period - i * slot,
                     idle_scale=min(c.get("idle_scale", 1.0), 0.05),
                     seed=c["seed"] + 131 * i)
            comps.append(c)
    return with_label(_from_comps(comps), f"serving-mix-{tenants}")


def suite(n: int, k: int, work: float = DEFAULT_WORK) -> list[WorkloadSpec]:
    """The adversarial scenario suite for a run geometry — the workload
    axis of the robustness leaderboard."""
    return ([capacity_straddle(n, k, r, work=work)
             for r in STRADDLE_RATIOS]
            + [phase_flip(n, k, work=work),
               drifting_hot(n, k, work=work),
               duty_cycled_tenants(n, k, work=work),
               serving_mix(n, k, work=work)])
