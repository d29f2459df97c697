"""Port parity of the search engine (``search``) and its tuning views
(``tuning``) against the JAX package, on the cases of
``tests/test_search.py`` and the tuning calls of
``tests/test_machine_spec.py`` and ``tests/test_tier_native.py``.

Rankings are the result, so they are held equal, not close: the best
config, every row's config in rank order, every round's horizon,
population, survivors, lanes, passes and lane-intervals are JAX's.  Each
row's result is held under the replay contract (counts exact, exec_time
within 1e-4 relative, recall and hit fraction within 1e-6, streamed
means within 1e-5); a round's best score within 1e-4 relative.  The
grid draws (``_sample_grid``) and CE's draws are host numpy, equal to
JAX's bit for bit.  In synthesis mode a short horizon is the prefix of
the full run, bit for bit.
"""
import functools
import itertools

import numpy as np
import pytest

from repro.simulator import scan_engine as jscan
from repro.simulator import search as jsearch
from repro.simulator import tuning as jtuning
from repro.simulator import workloads as jworkloads
from repro.simulator.engine import SimResult
from repro.simulator.machine import PMEM_LARGE as J_PMEM_LARGE
from repro_torch.baselines.hybridtier import HybridTierSpec
from repro_torch.baselines.jenga import JengaSpec
from repro_torch.baselines.tierbpf import TierBPFSpec
from repro_torch.simulator import experiment as pexp
from repro_torch.simulator import scan_engine as pscan
from repro_torch.simulator import search as psearch
from repro_torch.simulator import tuning as ptuning
from repro_torch.simulator import workload_spec as pws
from repro_torch.simulator.machine import PMEM_LARGE as P_PMEM_LARGE

T, N, K = 80, 256, 32
LIBS = {"jax": (jsearch, jtuning, jscan), "port": (psearch, ptuning, pscan)}


@functools.lru_cache(maxsize=None)
def _trace(wl="gups"):
    return jworkloads.make(wl, T=T, n=N)


def _port_kw(lib, kw):
    return dict(kw, device="cpu") if lib == "port" else kw


@functools.lru_cache(maxsize=None)
def _run(lib, family, strategy, wl="gups", **kw):
    """``search.run`` on the named trace, with the pass records."""
    search, _, scan = LIBS[lib]
    kw = _port_kw(lib, kw)
    if kw.get("workloads") is None:
        kw["trace"] = _trace(wl)
    with scan.count_dispatches() as ctr:
        out = search.run(family, strategy, k=K, **kw)
    return out, ctr.count, dict(scan.last_dispatch)


def _same_row(a, b):
    assert a.name == b.name
    assert (a.promotions, a.demotions, a.wasteful) == \
        (b.promotions, b.demotions, b.wasteful), a.name
    np.testing.assert_allclose(a.exec_time_s, b.exec_time_s, rtol=1e-4)
    assert abs(a.hot_recall - b.hot_recall) <= 1e-6
    assert abs(a.fast_hit_frac - b.fast_hit_frac) <= 1e-6
    if b.mean_slow_bw is not None:
        assert a.mean_mode == b.mean_mode
        assert a.max_promotions_interval == b.max_promotions_interval
        np.testing.assert_allclose(a.mean_slow_bw, b.mean_slow_bw,
                                   rtol=1e-5)


def _same_search(p, j):
    """Port SearchResult ``p`` equal to JAX's ``j`` (module contract)."""
    assert (p.family, p.strategy) == (j.family, j.strategy)
    assert p.best_config == j.best_config
    assert [c for c, _ in p.rows] == [c for c, _ in j.rows]
    for (_, a), (_, b) in zip(p.rows, j.rows, strict=True):
        _same_row(a, b)
    _same_row(p.best_result, j.best_result)
    assert (p.dispatches, p.lane_intervals) == (j.dispatches,
                                                j.lane_intervals)
    assert len(p.rounds) == len(j.rounds)
    for rp, rj in zip(p.rounds, j.rounds):
        for f in ("index", "horizon", "population", "survivors", "lanes",
                  "dispatches", "lane_intervals"):
            assert getattr(rp, f) == getattr(rj, f), f
        assert rp.best_score.keys() == rj.best_score.keys()
        for g in rj.best_score:
            np.testing.assert_allclose(rp.best_score[g], rj.best_score[g],
                                       rtol=1e-4)
    cp, cj = p.curve(), j.curve()
    assert [x for x, _ in cp] == [x for x, _ in cj]


def _same_out(p, j):
    if isinstance(j, dict):
        assert list(p) == list(j)
        for g in j:
            _same_search(p[g], j[g])
    else:
        _same_search(p, j)


def _both(family, strategy, **kw):
    """(port result, JAX result, port pass count) of one search, held
    equal."""
    p, pc, _ = _run("port", family, strategy, **kw)
    j, jc, _ = _run("jax", family, strategy, **kw)
    _same_out(p, j)
    assert pc == jc
    return p, j, pc


def _res(t):
    return SimResult(name="x", exec_time_s=t, promotions=0, demotions=0,
                     wasteful=0, hot_recall=0.0, fast_hit_frac=0.0)


# ------------------------------------------------------------ _sample_grid
class TestSampleGrid:
    def test_budget_respected_with_default_inserted(self):
        for budget in (1, 3, 6, 24):
            cfgs = ptuning.sample_configs(budget)
            assert cfgs == jtuning.sample_configs(budget)
            assert len(cfgs) <= budget
            assert dict(ptuning.HEMEM_DEFAULTS) in cfgs

    def test_huge_space_not_materialized(self):
        space = {f"k{i}": list(range(32)) for i in range(8)}  # 32**8
        defaults = {f"k{i}": 0 for i in range(8)}
        cfgs = ptuning._sample_grid(space, defaults, 8, seed=1)
        assert cfgs == jtuning._sample_grid(space, defaults, 8, seed=1)
        assert len({tuple(sorted(c.items())) for c in cfgs}) == 8
        assert all(list(c) == list(space) for c in cfgs)

    def test_seeded_draw_deterministic(self):
        assert ptuning.sample_configs(8, seed=5) == \
            ptuning.sample_configs(8, seed=5)
        assert ptuning.sample_configs(12, seed=0) != \
            ptuning.sample_configs(12, seed=1)
        assert ptuning.sample_arms_configs(12, seed=3) == \
            jtuning.sample_arms_configs(12, seed=3)

    def test_decode_matches_product_order(self):
        space = dict(a=[1, 2, 3], b=[10, 20], c=[0.5, 0.7])
        grid = list(itertools.product(*space.values()))
        keys, sizes = list(space), [len(v) for v in space.values()]
        for i in range(len(grid)):
            assert ptuning._decode_grid_index(space, keys, sizes, i) == \
                dict(zip(keys, grid[i])) == \
                jtuning._decode_grid_index(space, keys, sizes, i)

    @pytest.mark.parametrize("family", sorted(jtuning.FAMILIES))
    def test_family_draws_equal_jax(self, family):
        """The seven families' spaces, defaults and seeded draws."""
        _, jspace, jdef = jtuning.FAMILIES[family]
        _, pspace, pdef = ptuning.FAMILIES[family]
        assert (pspace, pdef) == (jspace, jdef)
        for budget, seed in ((1, 0), (6, 2), (24, 0), (480, 7)):
            assert ptuning._sample_grid(pspace, pdef, budget, seed) == \
                jtuning._sample_grid(jspace, jdef, budget, seed)


# ------------------------------------------------------------------- ASHA
class TestASHA:
    def test_eta1_reproduces_grid_bitwise(self):
        kw = dict(budget=6, search_seed=2, sim_seed=9)
        a, _, _ = _both("hemem", "asha", eta=1, **kw)
        g, _, _ = _both("hemem", "grid", **kw)
        assert [c for c, _ in a.rows] == [c for c, _ in g.rows]
        for (_, ra), (_, rg) in zip(a.rows, g.rows):
            assert ra.exec_time_s == rg.exec_time_s      # bit for bit
        assert a.best_config == g.best_config
        assert len(a.rounds) == 1
        assert a.lane_intervals == g.lane_intervals

    def test_survivors_subset_of_population(self):
        sr, _, _ = _both("hemem", "asha", wl="silo-tpcc", budget=9, eta=3,
                         search_seed=1, sim_seed=0)
        assert len(sr.rounds) >= 2
        for rec in sr.rounds:
            pop = {psearch._cfg_key(c) for c in rec.population[None]}
            assert {psearch._cfg_key(c) for c in rec.survivors[None]} <= pop
        for prev, nxt in zip(sr.rounds, sr.rounds[1:]):
            assert nxt.population[None] == prev.survivors[None]
            assert len(nxt.population[None]) < len(prev.population[None])
        assert sr.rounds[-1].horizon == T
        assert all(r.horizon < T for r in sr.rounds[:-1])

    def test_zero_information_rung_eliminates_nobody(self):
        sr, _, _ = _both("memtis", "asha", budget=9, eta=3, search_seed=1,
                         sim_seed=0)
        assert len(sr.rounds) >= 2
        for rec in sr.rounds[:-1]:
            assert rec.survivors[None] == rec.population[None]
        g, _, _ = _both("memtis", "grid", budget=9, search_seed=1,
                        sim_seed=0)
        assert [c for c, _ in sr.rows] == [c for c, _ in g.rows]
        assert sr.lane_intervals > g.lane_intervals

    def test_one_dispatch_per_round(self):
        sr, _, passes = _both("hemem", "asha", budget=9, eta=3,
                              search_seed=0, sim_seed=0)
        assert all(rec.dispatches == 1 for rec in sr.rounds)
        assert sr.dispatches == len(sr.rounds) == passes
        assert sr.lane_intervals == sum(r.lanes * r.horizon
                                        for r in sr.rounds)

    def test_machine_lane_mode(self):
        machines = ("pmem-large", "numa")
        out, _, _ = _both("hemem", "asha", machines=machines, budget=6,
                          eta=3, search_seed=0, sim_seed=0)
        assert sorted(nm.lower() for nm in out) == sorted(machines)
        a, b = out["pmem-large"], out["NUMA"]
        assert a.rounds is b.rounds
        rec = a.rounds[0]
        union = {psearch._cfg_key(c)
                 for g in rec.population for c in rec.population[g]}
        assert rec.lanes == len(union) * len(machines)
        assert rec.dispatches == 1


# ---------------------------------------------------------- cross-entropy
class TestCE:
    def test_deterministic_under_search_seed(self):
        kw = dict(budget=8, ce_rounds=2, sim_seed=3)
        a, _, _ = _both("hemem", "ce", search_seed=7, **kw)
        b = psearch.run("hemem", "ce", trace=_trace(), k=K, search_seed=7,
                        device="cpu", **kw)
        _same_search(b, a)
        for (_, ra), (_, rb) in zip(a.rows, b.rows):
            assert ra.exec_time_s == rb.exec_time_s
        c, _, _ = _both("hemem", "ce", search_seed=8, **kw)
        assert [cf for cf, _ in a.rows] != [cf for cf, _ in c.rows]

    def test_one_dispatch_per_round_and_elite_shrinks(self):
        sr, _, _ = _both("hemem", "ce", budget=12, ce_rounds=3,
                         elite_frac=0.25, search_seed=0, sim_seed=0)
        assert len(sr.rounds) == 3
        assert all(rec.dispatches == 1 for rec in sr.rounds)
        for rec in sr.rounds:
            assert len(rec.survivors[None]) <= len(rec.population[None])
            assert rec.horizon == T
        assert sr.rounds[0].population[None][0] == ptuning.HEMEM_DEFAULTS

    def test_continuous_arms_alphas_leave_the_grid(self):
        sr, _, _ = _both("arms", "ce", budget=10, ce_rounds=2,
                         search_seed=0, sim_seed=0)
        assert _run("port", "arms", "ce", budget=10, ce_rounds=2,
                    search_seed=0, sim_seed=0)[2]["sampling"] == "pre"
        drawn = [c for c, _ in sr.rows if c != ptuning.ARMS_DEFAULTS]
        assert any(c["alpha_s"] not in ptuning.ARMS_SPACE["alpha_s"]
                   for c in drawn)
        lo, hi = min(ptuning.ARMS_SPACE["alpha_s"]), \
            max(ptuning.ARMS_SPACE["alpha_s"])
        assert all(lo <= c["alpha_s"] <= hi for c in drawn)
        assert all(c["noise_z"] in ptuning.ARMS_SPACE["noise_z"]
                   for c in drawn)


# ------------------------------------------------------- ranking stability
class TestRanking:
    def test_equal_scores_keep_draw_order(self):
        rows = [({"a": 1}, _res(2.0)), ({"a": 2}, _res(1.0)),
                ({"a": 3}, _res(1.0)), ({"a": 4}, _res(1.0))]
        ranked = psearch.rank_rows(rows)
        assert [c["a"] for c, _ in ranked] == [2, 3, 4, 1]
        assert [c for c, _ in ranked] == \
            [c for c, _ in jsearch.rank_rows(rows)]

    def test_duplicate_configs_share_a_lane_and_stay_adjacent(self):
        cfg_a = dict(ptuning.HEMEM_DEFAULTS)
        cfg_b = dict(cfg_a, hot_threshold=1)
        configs = (cfg_a, cfg_b, cfg_a)
        with pscan.count_dispatches() as ctr:
            sr = psearch.run("hemem", "grid", trace=_trace(), k=K,
                             configs=configs, sim_seed=0, device="cpu")
        assert ctr.count == 1 and ctr.last["lanes"] == 2
        _same_search(sr, jsearch.run("hemem", "grid", trace=_trace(), k=K,
                                     configs=configs, sim_seed=0))
        dup = [i for i, (c, _) in enumerate(sr.rows) if c == cfg_a]
        assert dup == [dup[0], dup[0] + 1]
        assert sr.rows[dup[0]][1].exec_time_s == \
            sr.rows[dup[1]][1].exec_time_s


# ------------------------------------------------------- tuning thin views
class TestTuneViews:
    @pytest.mark.parametrize("strategy", ["grid", "asha", "ce"])
    def test_strategy_views_keep_legacy_shape(self, strategy):
        p = ptuning.tune_hemem(_trace(), P_PMEM_LARGE, K, budget=6,
                               strategy=strategy, device="cpu")
        j = jtuning.tune_hemem(_trace(), J_PMEM_LARGE, K, budget=6,
                               strategy=strategy)
        best_cfg, best_res, rows = p
        assert best_cfg == j[0] and set(best_cfg) == set(ptuning.SPACE)
        assert [c for c, _ in rows] == [c for c, _ in j[2]]
        for (_, a), (_, b) in zip(rows, j[2]):
            _same_row(a, b)
        assert best_res.exec_time_s == min(r.exec_time_s for _, r in rows)

    def test_unknown_strategy_and_family_rejected(self):
        with pytest.raises(ValueError):
            ptuning.tune("hemem", _trace(), P_PMEM_LARGE, K, budget=2,
                         strategy="bayes", device="cpu")
        with pytest.raises(ValueError):
            psearch.run("nimble", "grid", trace=_trace(), k=K, device="cpu")
        with pytest.raises(ValueError):
            psearch.run("hemem", "grid", trace=_trace(), k=K,
                        base_cfg=object(), device="cpu")

    def test_machines_mode_returns_per_machine_tuples(self):
        kw = dict(budget=4, machines=["pmem-large", "numa"])
        p = ptuning.tune("hemem", _trace(), None, K, device="cpu", **kw)
        j = jtuning.tune("hemem", _trace(), None, K, **kw)
        assert sorted(p) == sorted(j) == ["NUMA", "pmem-large"]
        for nm, (best_cfg, best_res, rows) in p.items():
            assert best_cfg == j[nm][0]
            assert [c for c, _ in rows] == [c for c, _ in j[nm][2]]
            assert len(rows) <= 4

    def test_tune_arms_asha_keeps_pre_path(self):
        p = ptuning.tune_arms(_trace(), P_PMEM_LARGE, K, budget=6,
                              strategy="asha", device="cpu")
        assert pscan.last_dispatch["sampling"] == "pre"
        j = jtuning.tune_arms(_trace(), J_PMEM_LARGE, K, budget=6,
                              strategy="asha")
        assert p[0] == j[0] and set(p[0]) == set(ptuning.ARMS_SPACE)
        assert [c for c, _ in p[2]] == [c for c, _ in j[2]]
        assert p[1].exec_time_s == min(r.exec_time_s for _, r in p[2])

    def test_workload_lane_asha(self):
        out, _, d = _run("port", "hemem", "asha", budget=6,
                         workloads=("gups", "silo-tpcc"), T=T, n=N)
        _same_out(out, _run("jax", "hemem", "asha", budget=6,
                            workloads=("gups", "silo-tpcc"), T=T, n=N)[0])
        assert sorted(out) == ["gups", "silo-tpcc"]
        assert d["synth"] is True and d["workloads"] == 2


def test_synth_horizon_is_a_prefix_bit_for_bit():
    """A short horizon over specs resolved at the full T scans the first
    intervals of the full run: timelines equal bit for bit."""
    wls = [pws.named(nm, T=T) for nm in ("gups", "silo-tpcc", "gapbs-bc")]
    kw = dict(workloads=wls, k=K, n=N, timelines=True, device="cpu")
    specs = [ptuning.FAMILIES["hemem"][0](**c)
             for c in ptuning.sample_configs(4, seed=1)]
    full = pexp.sweep(specs, T=T, **kw)
    for h in (16, 27):
        short = pexp.sweep(specs, T=h, **kw)
        for (_, a), (_, b) in zip(short.items(), full.items()):
            for f in ("timeline_slow_bw", "timeline_fast_hits",
                      "timeline_mode", "timeline_promotions"):
                np.testing.assert_array_equal(getattr(a, f),
                                              getattr(b, f)[:h])
            assert a.promotions == int(b.timeline_promotions[:h].sum())


# -------------------------------------------------------- transfer matrix
class TestTransferMatrix:
    def test_native_tuning_is_optimal_under_shared_crn(self):
        machines = ["pmem-large", "numa", "cxl-1hop"]
        tm = psearch.transfer_matrix("hemem", _trace(), machines, K,
                                     budget=5, strategy="grid", device="cpu")
        jm = jsearch.transfer_matrix("hemem", _trace(), machines, K,
                                     budget=5, strategy="grid")
        assert tm.machines == jm.machines and tm.tuned == jm.tuned
        np.testing.assert_allclose(tm.exec_time, jm.exec_time, rtol=1e-4)
        np.testing.assert_allclose(tm.slowdown, jm.slowdown, rtol=2e-4)
        assert tm.slowdown.shape == (3, 3)
        assert np.allclose(np.diag(tm.slowdown), 1.0)
        assert (tm.slowdown >= 1.0 - 1e-12).all()
        rows = tm.rows()
        assert [r["tuned_on"] for r in rows] == tm.machines
        assert all(r["slowdown"][r["tuned_on"]] == 1.0 for r in rows)
        for g in jm.search:
            _same_search(tm.search[g], jm.search[g])

    def test_needs_two_machines(self):
        with pytest.raises(ValueError):
            psearch.transfer_matrix("hemem", _trace(), ["numa"], K,
                                    device="cpu")


# --------------------------------------- tuning calls of the other suites
def test_tune_by_machine_name():
    """tests/test_machine_spec.py::test_names_anywhere's tuning call."""
    trace = jworkloads.make("gups", T=40, n=64)
    p = ptuning.tune("hemem", trace, "pmem-large", 8, budget=2,
                     device="cpu")
    j = jtuning.tune("hemem", trace, "pmem-large", 8, budget=2)
    assert p[0] == j[0] and p[0]
    assert [c for c, _ in p[2]] == [c for c, _ in j[2]]


def test_asha_on_jenga():
    """tests/test_tier_native.py::TestSearchRouting on the tier-targeted
    route."""
    trace = jworkloads.make("gups", T=96, n=256)
    kw = dict(trace=trace, machine="pmem-large", k=32, budget=4, t_min=24)
    p = psearch.run("jenga", "asha", device="cpu", **kw)
    _same_search(p, jsearch.run("jenga", "asha", **kw))
    assert set(p.best_config) == {"alpha", "confirm", "cooldown",
                                  "migration_period"}
    assert all(r.dispatches == 1 for r in p.rounds)
    assert p.best_result.exec_time_s > 0
    for fam, cls in (("hybridtier", HybridTierSpec), ("jenga", JengaSpec),
                     ("tierbpf", TierBPFSpec)):
        make, space, defaults = ptuning.FAMILIES[fam]
        assert isinstance(make(**defaults), cls)
        assert set(defaults) <= set(space)
    assert psearch.CONTINUOUS_KNOBS == jsearch.CONTINUOUS_KNOBS
    assert psearch.STRATEGIES == jsearch.STRATEGIES
