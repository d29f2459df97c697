"""Adaptive search engine: grid, ASHA and cross-entropy tuning loops.

The port of ``repro/simulator/search.py``.  Every round of a strategy --
the one grid scoring, an elimination rung of successive halving, a redraw
generation of cross-entropy -- is one ``experiment.sweep`` pass per
policy family, with the round's config population on the policy axis and
every lane sharing the CRN noise, so elimination decisions are paired
comparisons (config differences are never confounded with noise).

Strategies (``run(family, strategy, ...)``):

  * ``"grid"`` -- exhaustive scoring of the sampled grid at the full
    horizon; the compute reference of the other two.
  * ``"asha"`` -- successive halving: round ``r`` of ``R`` scores the
    surviving population at horizon ``T_r = T_full * eta**(r - R)``
    (at least ``t_min``), keeps the top ``1/eta`` under a stable
    exec-time ranking (a fully tied rung eliminates nobody: a cut would
    be draw-order luck), and the last round scores the survivors at the
    full horizon.
  * ``"ce"`` -- cross-entropy: each round draws a population from a
    per-knob distribution (categorical over the grid values; a truncated
    normal for the knobs in ``CONTINUOUS_KNOBS``), scores it at the full
    horizon and refits the distribution to the elite.  Deterministic under
    ``search_seed`` (one ``default_rng([search_seed, group])`` stream a
    group; host numpy, so the draws are JAX's).

Every strategy returns a ``SearchResult`` with per-round records
(population, survivors, passes, lane-intervals), so strategies compare on
compute spent: ``lane_intervals`` sums ``lanes x horizon`` over rounds.

Rankings are the result, so ties matter: ``rank_rows`` is a stable sort
on ``exec_time_s`` and configs that make the same migrations score the
same bits (every lane's arithmetic is independent of its position and of
the lane count), so ties keep draw order as in JAX.

Lane modes: per machine (``machines=[...]``) or per workload
(``workloads=[...]`` with ``T``/``n``), each returning ``{label:
SearchResult}`` with one pass a round.  ``transfer_matrix`` tunes per
machine and cross-scores the tuned configs on every machine in one final
sweep.  ARMS keeps its ``"pre"`` path: trace-mode single-machine searches
over SWEEPABLE knobs go through ``scan_engine.sweep_arms_configs``
(observation grids computed once, shared by the config lanes) with the
streaming reduction.  In synthesis mode a short horizon scans the first
intervals of the workloads resolved at the full T, whose rows and
counter-based noise make it an exact prefix of the full run.

``tuning.tune`` and its ``tune_*`` views are thin views over ``run``.
Every entry point takes ``device`` (``None``: the CUDA card).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.baselines.arms_policy import SWEEPABLE, ARMSSpec
from repro_torch.simulator import experiment, scan_engine
from repro_torch.simulator import machines as machines_mod
from repro_torch.simulator.engine import SimResult

__all__ = [
    "CONTINUOUS_KNOBS", "RoundRecord", "SearchResult", "TransferMatrix",
    "rank_rows", "run", "transfer_matrix",
]

#: family -> knobs the cross-entropy strategy samples continuously (from a
#: truncated normal over the grid's [min, max]) instead of from the grid's
#: values.  The ARMS alphas are continuous controller gains; the other
#: families' listed knobs likewise.
CONTINUOUS_KNOBS = {
    "arms": frozenset({"alpha_s", "alpha_l"}),
    "hybridtier": frozenset({"decay"}),
    "jenga": frozenset({"alpha"}),
    "tierbpf": frozenset({"alpha", "admit_thresh", "thrash_gain",
                          "regret_alpha"}),
}

STRATEGIES = ("grid", "asha", "ce")


def _cfg_key(cfg: dict) -> tuple:
    return tuple(sorted(cfg.items()))


def rank_rows(rows):
    """Stable exec-time ranking of ``(config, SimResult)`` rows: rows with
    equal ``exec_time_s`` keep their draw order."""
    return sorted(rows, key=lambda cr: cr[1].exec_time_s)


@dataclasses.dataclass
class RoundRecord:
    """One search round: one pass per policy family."""

    index: int          #: 1-based round number
    horizon: int        #: intervals simulated this round (T_r)
    population: dict    #: group label -> configs entering the round
    survivors: dict     #: group label -> configs kept for the next round
    best_score: dict    #: group label -> best exec_time_s at this horizon
    lanes: int          #: lanes of this round's pass
    dispatches: int     #: passes this round (1 per family)
    lane_intervals: int  #: lanes * horizon -- the round's compute spend


@dataclasses.dataclass
class SearchResult:
    """Outcome of one strategy run (one per group in machine/workload
    modes).  ``rows`` is the final full-horizon ranking; ``rounds`` the
    per-round records, shared by every group of a grouped search."""

    family: str
    strategy: str
    best_config: dict
    best_result: SimResult
    rows: list
    rounds: list
    dispatches: int
    lane_intervals: int

    def curve(self):
        """[(cumulative lane-intervals, best exec_time_s at that round's
        horizon)]: the compute-vs-quality trajectory.  Scores of non-final
        ASHA rounds are at short horizons."""
        pts, cum = [], 0
        for rec in self.rounds:
            cum += rec.lane_intervals
            pts.append((cum, min(rec.best_score.values())))
        return pts


class _EvalCtx:
    """Shared evaluation state of one search: resolves the trace or the
    workload specs (at the full T) and the machines once, then scores a
    config population at any horizon as one pass per family."""

    def __init__(self, family, make, trace, machine, machines, workloads,
                 k, T, n, sim_seed, base_cfg, space, mesh=None, device=None):
        if machines is not None and workloads is not None:
            raise ValueError("machine-lane and workload-lane search modes "
                             "cannot be combined; pass one of them")
        self.family, self.make, self.k = family, make, k
        self.sim_seed, self.base_cfg = sim_seed, base_cfg
        self.mesh, self.device = mesh, device
        mach_in = list(machines) if machines is not None else [machine]
        self.machines = [machines_mod.get(m) for m in mach_in]
        self.wl_specs = None
        if workloads is not None:
            if trace is not None:
                raise ValueError("pass either trace or workloads, not both")
            if T is None or n is None:
                raise ValueError("workload-lane tuning needs T and n")
            self.trace = None
            self.wl_specs, names = experiment._resolve_workloads(
                list(workloads), T)
            self.T_full, self.n = int(T), int(n)
            self.group_axis = "workload"
            self.groups = experiment._dedup_labels(names)
        else:
            if trace is None:
                raise ValueError("need a trace or a workloads list")
            self.trace = np.asarray(trace)
            self.T_full, self.n = self.trace.shape
            if machines is not None:
                self.group_axis = "machine"
                self.groups = experiment._dedup_labels(
                    [m.name for m in self.machines])
            else:
                self.group_axis = None
                self.groups = [None]
        # ARMS's "pre" path: per-mode observation grids computed once from
        # the CRN field and shared by the config lanes.
        self.use_pre = (family == "arms" and self.trace is not None
                        and self.group_axis is None
                        and set(space) <= SWEEPABLE)

    def eval(self, configs, horizon: int):
        """Score ``configs`` at ``horizon`` -> (per-group result lists,
        lanes, passes, lane-intervals): one pass per policy family."""
        horizon = int(horizon)
        with scan_engine.count_dispatches() as ctr:
            if self.use_pre:
                # one machine, one family, no lane batch to shard
                overrides = {nm: [cfg[nm] for cfg in configs]
                             for nm in configs[0]}
                results = scan_engine.sweep_arms_configs(
                    self.trace[:horizon], self.machines[0], self.k,
                    overrides, base_cfg=self.base_cfg, seed=self.sim_seed,
                    reduce="stream", device=self.device)
                per_group = [results]
            else:
                specs = [self.make(**cfg) for cfg in configs]
                if self.group_axis == "workload":
                    res = experiment.sweep(
                        specs, workloads=self.wl_specs,
                        machines=[self.machines[0]], k=self.k, T=horizon,
                        n=self.n, sim_seed=self.sim_seed, mesh=self.mesh,
                        device=self.device)
                    per_group = [[res.at(policy=b, workload=g)
                                  for b in range(len(configs))]
                                 for g in range(len(self.groups))]
                else:
                    res = experiment.sweep(
                        specs, trace=self.trace[:horizon],
                        machines=self.machines, k=self.k,
                        sim_seed=self.sim_seed, mesh=self.mesh,
                        device=self.device)
                    per_group = [[res.at(policy=b, machine=g)
                                  for b in range(len(configs))]
                                 for g in range(len(self.groups))]
        lanes = ctr.last.get("lanes", len(configs))
        return per_group, lanes, ctr.count, lanes * horizon


def _union(pops):
    """Ordered-dedup union of all groups' populations -> (configs,
    key->index).  Each distinct config is scored once a round even when
    several groups keep it; duplicates within a population share a lane."""
    union, keyidx = [], {}
    for pop in pops.values():
        for cfg in pop:
            key = _cfg_key(cfg)
            if key not in keyidx:
                keyidx[key] = len(union)
                union.append(cfg)
    return union, keyidx


def _round_rows(pops, per_group, keyidx, groups):
    """Per-group ``(config, SimResult)`` rows in draw order."""
    return {g: [(cfg, per_group[gi][keyidx[_cfg_key(cfg)]])
                for cfg in pops[g]]
            for gi, g in enumerate(groups)}


def _grid(ctx, family, configs):
    """Exhaustive full-horizon scoring."""
    pops = {g: list(configs) for g in ctx.groups}
    union, keyidx = _union(pops)
    per_group, lanes, disp, li = ctx.eval(union, ctx.T_full)
    rows_g = _round_rows(pops, per_group, keyidx, ctx.groups)
    ranked = {g: rank_rows(rows_g[g]) for g in ctx.groups}
    rec = RoundRecord(1, ctx.T_full, pops,
                      {g: [c for c, _ in ranked[g]] for g in ctx.groups},
                      {g: ranked[g][0][1].exec_time_s for g in ctx.groups},
                      lanes, disp, li)
    return {g: SearchResult(family, "grid", ranked[g][0][0],
                            ranked[g][0][1], ranked[g], [rec], disp, li)
            for g in ctx.groups}


def _n_rounds(n0: int, eta: int, T_full: int, t_min: int,
              rounds) -> int:
    if rounds is not None:
        return max(1, int(rounds))
    if eta <= 1 or n0 <= eta or t_min >= T_full:
        return 1
    return max(1, math.ceil(math.log(n0) / math.log(eta)))


def _asha(ctx, family, configs, eta: int, rounds, t_min: int):
    """Successive halving: geometric horizon ladder, stable elimination;
    a fully tied rung eliminates nobody."""
    eta = max(1, int(eta))
    T_full = ctx.T_full
    R = _n_rounds(len(configs), eta, T_full, t_min, rounds)
    pops = {g: list(configs) for g in ctx.groups}
    recs, total_disp, total_li = [], 0, 0
    final_rows = {}
    for r in range(1, R + 1):
        if r == R:
            T_r = T_full
        else:
            T_r = min(T_full, max(int(t_min),
                                  math.ceil(T_full * eta ** (r - R))))
        union, keyidx = _union(pops)
        per_group, lanes, disp, li = ctx.eval(union, T_r)
        total_disp += disp
        total_li += li
        rows_g = _round_rows(pops, per_group, keyidx, ctx.groups)
        surv, best = {}, {}
        for g in ctx.groups:
            ranked = rank_rows(rows_g[g])
            best[g] = ranked[0][1].exec_time_s
            if r < R:
                if ranked[0][1].exec_time_s == ranked[-1][1].exec_time_s:
                    # zero-information rung (every lane scored the same
                    # bits): a cut would eliminate by draw order alone
                    surv[g] = list(pops[g])
                    continue
                keep = max(1, math.ceil(len(ranked) / eta))
                top = {_cfg_key(c) for c, _ in ranked[:keep]}
                # survivors keep draw order, so later rounds break ties as
                # the draw did
                surv[g] = [c for c in pops[g] if _cfg_key(c) in top]
            else:
                surv[g] = [c for c, _ in ranked]
                final_rows[g] = ranked
        recs.append(RoundRecord(r, T_r,
                                {g: list(pops[g]) for g in ctx.groups},
                                {g: list(surv[g]) for g in ctx.groups},
                                best, lanes, disp, li))
        pops = surv
    return {g: SearchResult(family, "asha", final_rows[g][0][0],
                            final_rows[g][0][1], final_rows[g], recs,
                            total_disp, total_li)
            for g in ctx.groups}


def _init_dists(space, cont):
    dists = {}
    for nm in sorted(space):
        vals = [float(v) for v in space[nm]]
        if nm in cont:
            lo, hi = min(vals), max(vals)
            dists[nm] = dict(kind="cont", lo=lo, hi=hi,
                             mu=float(np.mean(vals)),
                             sigma=max((hi - lo) / 2.0, 1e-6))
        else:
            dists[nm] = dict(kind="disc", vals=list(space[nm]),
                             p=np.full(len(vals), 1.0 / len(vals)))
    return dists


def _ce_draw(rng, dists, space):
    cfg = {}
    for nm in sorted(space):
        d = dists[nm]
        if d["kind"] == "disc":
            cfg[nm] = d["vals"][int(rng.choice(len(d["vals"]), p=d["p"]))]
        else:
            cfg[nm] = float(np.clip(rng.normal(d["mu"], d["sigma"]),
                                    d["lo"], d["hi"]))
    # knobs in the space's declaration order, like tuning._sample_grid
    return {nm: cfg[nm] for nm in space}


def _ce_refit(dists, elite, smoothing: float):
    for nm, d in dists.items():
        ev = [cfg[nm] for cfg, _ in elite]
        if d["kind"] == "disc":
            freq = np.array([float(sum(1 for v in ev if v == val))
                             for val in d["vals"]]) / len(ev)
            p = (1.0 - smoothing) * d["p"] + smoothing * freq
            d["p"] = p / p.sum()
        else:
            d["mu"] = (1.0 - smoothing) * d["mu"] \
                + smoothing * float(np.mean(ev))
            # the sigma floor keeps some exploration, so a degenerate
            # elite cannot freeze the distribution
            d["sigma"] = max((1.0 - smoothing) * d["sigma"]
                             + smoothing * float(np.std(ev)),
                             1e-3 * (d["hi"] - d["lo"]))


def _ce(ctx, family, space, defaults, budget: int, rounds: int,
        elite_frac: float, smoothing: float, search_seed: int):
    """Cross-entropy over the knob space: redraw from an elite-fit
    distribution each round, every round scored at the full horizon."""
    R = max(1, int(rounds))
    pop_n = max(2, math.ceil(budget / R))
    cont = CONTINUOUS_KNOBS.get(family, frozenset())
    dists = {g: _init_dists(space, cont) for g in ctx.groups}
    rngs = {g: np.random.default_rng([int(search_seed), gi])
            for gi, g in enumerate(ctx.groups)}
    seen = {g: {} for g in ctx.groups}   # cfg key -> (cfg, res), draw order
    recs, total_disp, total_li = [], 0, 0
    for r in range(1, R + 1):
        pops = {}
        for g in ctx.groups:
            draws = [dict(defaults)] if (r == 1 and defaults) else []
            while len(draws) < pop_n:
                draws.append(_ce_draw(rngs[g], dists[g], space))
            pops[g] = draws
        union, keyidx = _union(pops)
        per_group, lanes, disp, li = ctx.eval(union, ctx.T_full)
        total_disp += disp
        total_li += li
        rows_g = _round_rows(pops, per_group, keyidx, ctx.groups)
        surv, best = {}, {}
        for g in ctx.groups:
            ranked = rank_rows(rows_g[g])
            best[g] = ranked[0][1].exec_time_s
            elite = ranked[:max(1, int(len(ranked) * elite_frac))]
            surv[g] = [c for c, _ in elite]
            _ce_refit(dists[g], elite, smoothing)
            for cfg, res in rows_g[g]:
                seen[g].setdefault(_cfg_key(cfg), (cfg, res))
        recs.append(RoundRecord(r, ctx.T_full, pops, surv, best, lanes,
                                disp, li))
    out = {}
    for g in ctx.groups:
        # every round ran at the full horizon under the same CRN noise, so
        # rows of different rounds compare directly (a repeated draw
        # scores the same; the first is kept)
        rows = rank_rows(list(seen[g].values()))
        out[g] = SearchResult(family, "ce", rows[0][0], rows[0][1], rows,
                              recs, total_disp, total_li)
    return out


def run(family: str, strategy: str = "asha", *, trace=None,
        machine="pmem-large", machines=None, workloads=None, k: int,
        budget: int = 24, eta: int = 3, rounds=None, t_min: int = 16,
        ce_rounds: int = 4, elite_frac: float = 0.25,
        ce_smoothing: float = 0.7, search_seed: int = 0, sim_seed: int = 0,
        space: dict | None = None, defaults: dict | None = None,
        base_cfg=None, configs=None, T: int | None = None,
        n: int | None = None, mesh=None, device=None):
    """Run one search strategy for one policy family.

    Trace + single ``machine`` returns one ``SearchResult``;
    ``machines=[...]`` (machine-lane mode) or ``workloads=[...]`` with
    ``T``/``n`` (workload-lane mode) return ``{label: SearchResult}``,
    the groups sharing each round's pass.  ``configs`` replaces the seeded
    grid draw (grid/asha initial population; CE always redraws).

    ``budget`` is the population of grid/asha and the total draws of CE
    (``ce_rounds`` populations of ``ceil(budget / ce_rounds)``);
    ``eta``/``rounds``/``t_min`` shape the ASHA ladder (``eta=1`` is one
    full-horizon round: the grid, bit for bit).  ``mesh``: shards each
    round's pass over devices (``experiment.sweep``; results and logical
    lane-intervals the same at any mesh size).  ``device``: where
    the passes run (``None``: the CUDA card).
    """
    from repro_torch.simulator import tuning  # late: tuning wraps run()
    if strategy not in STRATEGIES:
        raise ValueError(f"unknown strategy {strategy!r}; "
                         f"known: {list(STRATEGIES)}")
    if family not in tuning.FAMILIES:
        raise ValueError(f"unknown family {family!r}; "
                         f"known: {sorted(tuning.FAMILIES)}")
    make, fam_space, fam_defaults = tuning.FAMILIES[family]
    space = dict(space if space is not None else fam_space)
    defaults = dict(defaults if defaults is not None else fam_defaults)
    if base_cfg is not None:
        if family != "arms":
            raise ValueError("base_cfg is an ARMS-only knob")
        make = lambda **cfg: ARMSSpec.make(cfg, base_cfg=base_cfg)  # noqa: E731
    if configs is None:
        configs = tuning._sample_grid(space, defaults, budget, search_seed)
    else:
        configs = [dict(c) for c in configs]
    ctx = _EvalCtx(family, make, trace, machine, machines, workloads, k,
                   T, n, sim_seed, base_cfg, space, mesh=mesh, device=device)
    if strategy == "grid":
        out = _grid(ctx, family, configs)
    elif strategy == "asha":
        out = _asha(ctx, family, configs, eta, rounds, t_min)
    else:
        out = _ce(ctx, family, space, defaults, budget,
                  ce_rounds if rounds is None else rounds, elite_frac,
                  ce_smoothing, search_seed)
    if ctx.group_axis is None:
        return out[None]
    return out


# ------------------------------------------------- machine-transfer matrix
@dataclasses.dataclass
class TransferMatrix:
    """"Tuned on machine A, deployed on machine B" robustness table.

    ``exec_time[a, b]``: exec time of the config tuned on machine ``a``
    deployed on machine ``b``; ``slowdown[a, b] = exec_time[a, b] /
    exec_time[b, b]`` (1.0 on the diagonal; > 1 is what a foreign tuning
    costs against tuning natively).
    """

    family: str
    machines: list
    tuned: dict                 #: machine label -> natively tuned config
    exec_time: np.ndarray       #: [A, B] deployed exec times (seconds)
    slowdown: np.ndarray        #: [A, B] vs the native-tuned diagonal
    search: dict                #: machine label -> SearchResult

    def rows(self):
        """JSON-friendly per-source rows."""
        out = []
        for a, src in enumerate(self.machines):
            out.append(dict(
                tuned_on=src, config=self.tuned[src],
                exec_time_s={b: round(float(self.exec_time[a, bi]), 6)
                             for bi, b in enumerate(self.machines)},
                slowdown={b: round(float(self.slowdown[a, bi]), 4)
                          for bi, b in enumerate(self.machines)}))
        return out


def transfer_matrix(family: str, trace, machines, k: int,
                    budget: int = 24, strategy: str = "asha",
                    search_seed: int = 0, sim_seed: int = 0, device=None,
                    **search_kw) -> TransferMatrix:
    """Tune per machine, then cross-score the tuned configs everywhere.

    Phase 1 is one machine-lane search (per-machine elimination, each
    round one pass of the union population x M machines); phase 2 scores
    the M tuned configs on all M machines in one final sweep (config axis
    x machine axis, shared CRN), so ``exec_time[b, b]`` is the native
    search's score and the off-diagonal cells are paired with it.
    """
    machines = list(machines)
    if len(machines) < 2:
        raise ValueError("a transfer matrix needs >= 2 machines")
    per = run(family, strategy, trace=trace, machines=machines, k=k,
              budget=budget, search_seed=search_seed, sim_seed=sim_seed,
              device=device, **search_kw)
    labels = list(per)
    from repro_torch.simulator import tuning  # late: tuning wraps run()
    make = tuning.FAMILIES[family][0]
    specs = [make(**per[g].best_config) for g in labels]
    res = experiment.sweep(specs, trace=np.asarray(trace),
                           machines=machines, k=k, sim_seed=sim_seed,
                           device=device)
    M = len(labels)
    exec_time = np.array([[res.at(policy=a, machine=b).exec_time_s
                           for b in range(M)] for a in range(M)])
    slowdown = exec_time / np.diag(exec_time)[None, :]
    return TransferMatrix(family, labels,
                          {g: per[g].best_config for g in labels},
                          exec_time, slowdown, per)
