"""Port parity of trace capture, fit and replay (``traces``) against the
JAX package, on the cases of ``tests/test_traces.py``.

Capture is host numpy f64 in both packages: counts, totals and metadata
equal bit for bit.  ``fit_workload_spec`` gives JAX's knobs exactly
(every component field of ``_to_comps``) and the same label.  ``replay``
is ``experiment.sweep``'s trace mode: every cell under the replay
contract against JAX's grouped sweep (counts exact, exec_time within
1e-4 relative, recall and hit fraction within 1e-6).
"""
import numpy as np
import pytest

from repro.simulator import traces as jtraces
from repro.simulator import workload_spec as jws
from repro_torch.simulator import traces as ptraces
from repro_torch.simulator import workload_spec as pws
from repro_torch.simulator.workload_spec import NEVER, _to_comps
from repro_torch.utils.pytree import leaves, treedef


def _integer_steps(S=40, n=8, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 50, (S, n)).astype(np.float64)


def _fit_equal(counts, **kw):
    """The port's fit of ``counts`` with JAX's knobs -> its component."""
    p = ptraces.fit_workload_spec(ptraces.TraceWorkload(counts), **kw)
    j = jtraces.fit_workload_spec(jtraces.TraceWorkload(counts), **kw)
    assert _to_comps(p) == jws._to_comps(j)
    assert pws.label_of(p, "") == jws.label_of(j, "")
    (c,) = _to_comps(p)
    return c


class TestCaptureConservation:
    def test_round_trip_conserves_counts_exactly(self):
        steps = _integer_steps()
        tw = ptraces.capture_from_steps(steps, group=4)
        assert tw.counts.shape == (10, 8)
        assert tw.total() == float(steps.sum())
        np.testing.assert_array_equal(tw.counts,
                                      steps.reshape(10, 4, 8).sum(axis=1))
        np.testing.assert_array_equal(
            tw.counts, jtraces.capture_from_steps(steps, group=4).counts)

    def test_streaming_capture_matches_one_shot(self):
        steps = _integer_steps(S=24, n=5, seed=3)
        cap = ptraces.TraceCapture(n=5, group=3)
        for row in steps:
            cap.add(row)
        assert cap.steps == 24
        tw = cap.finish(label="stream")
        np.testing.assert_array_equal(
            tw.counts, ptraces.capture_from_steps(steps, group=3).counts)
        assert tw.meta == dict(steps=24, group=3)

    def test_partial_interval_kept_and_conserved(self):
        steps = _integer_steps(S=10, n=4, seed=1)
        tw = ptraces.capture_from_steps(steps, group=4)   # 4+4+2
        assert tw.T == 3
        assert tw.total() == float(steps.sum())
        np.testing.assert_array_equal(tw.counts[2], steps[8:].sum(0))

    def test_drop_partial(self):
        steps = _integer_steps(S=10, n=4, seed=2)
        caps = [lib.TraceCapture(n=4, group=4) for lib in (ptraces, jtraces)]
        for cap in caps:
            for row in steps:
                cap.add(row)
        tw, jw = (cap.finish(drop_partial=True) for cap in caps)
        assert tw.T == 2 and tw.total() == float(steps[:8].sum())
        np.testing.assert_array_equal(tw.counts, jw.counts)
        assert tw.meta == jw.meta

    def test_save_load_round_trip(self, tmp_path):
        tw = ptraces.capture_from_steps(_integer_steps(), group=2,
                                        label="kv-l0")
        path = str(tmp_path / "trace.npz")
        tw.save(path)
        back = ptraces.TraceWorkload.load(path)
        np.testing.assert_array_equal(back.counts, tw.counts)
        assert back.label == "kv-l0"
        # the two packages read each other's files
        jback = jtraces.TraceWorkload.load(path)
        np.testing.assert_array_equal(jback.counts, tw.counts)

    def test_shape_validation(self):
        with pytest.raises(ValueError):
            ptraces.TraceWorkload(np.zeros(5))
        cap = ptraces.TraceCapture(n=4)
        with pytest.raises(ValueError):
            cap.add(np.zeros(3))
        with pytest.raises(ValueError):
            cap.finish()


class TestFitDeterminism:
    def test_fit_is_bit_deterministic_under_fixed_seed(self):
        tw = ptraces.capture_from_steps(_integer_steps(S=64, n=16, seed=9),
                                        group=2)
        a = ptraces.fit_workload_spec(tw, seed=3)
        b = ptraces.fit_workload_spec(tw, seed=3)
        la, lb = leaves(a), leaves(b)
        assert len(la) == len(lb)
        for x, y in zip(la, lb):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x.numpy(), y.numpy())
        assert treedef(a) == treedef(b)
        _fit_equal(tw.counts, seed=3)

    def test_fit_label_and_scale_independence(self):
        tw = ptraces.capture_from_steps(_integer_steps(), group=4,
                                        label="kv")
        spec = ptraces.fit_workload_spec(tw)
        assert pws.label_of(spec, "") == "fit:kv"
        _fit_equal(tw.counts)


class TestFitRecoversStructure:
    def test_static_hotset(self):
        T, n = 64, 32
        rng = np.random.default_rng(0)
        counts = rng.uniform(0.5, 1.5, (T, n))
        counts[:, :4] *= 150.0
        c = _fit_equal(counts)
        assert abs(c["hot_frac"] - 4 / 32) < 0.05
        assert c["hot_weight"] > 0.9
        assert c["shift_every"] == NEVER
        assert c["duty"] == 1.0

    def test_duty_cycle(self):
        T, n = 64, 16
        rng = np.random.default_rng(1)
        counts = rng.uniform(50, 60, (T, n))
        busy = (np.arange(T) % 8) < 4
        counts[~busy] *= 0.001
        c = _fit_equal(counts)
        assert abs(c["period"] - 8) <= 1
        assert abs(c["duty"] - 0.5) < 0.15
        assert c["idle_scale"] < 0.05

    def test_churning_hotset_fits_finite_shift(self):
        T, n = 96, 32
        rng = np.random.default_rng(2)
        counts = rng.uniform(0.5, 1.5, (T, n))
        for t in range(T):
            start = (4 * (t // 16)) % n
            counts[t, start:start + 4] *= 100.0
        c = _fit_equal(counts)
        assert c["shift_every"] < NEVER


class TestReplay:
    def test_trace_replays_as_sweep_lane(self):
        """The captured stream is an experiment lane, equal to JAX's."""
        steps = _integer_steps(S=48, n=16, seed=11)
        steps[:, :4] *= 40.0                       # plant a hot set
        tw = ptraces.capture_from_steps(steps, group=2, label="serve")
        pols = ["arms", "all-slow", "oracle"]
        res = ptraces.replay(tw, pols, k=4, dispatch="grouped", device="cpu")
        want = jtraces.replay(jtraces.capture_from_steps(
            steps, group=2, label="serve"), pols, k=4, dispatch="grouped")
        assert res.axes == want.axes
        assert res.axes["workload"] == ["trace"]
        for (_, a), (_, b) in zip(res.items(), want.items()):
            assert a.name == b.name
            assert (a.promotions, a.demotions, a.wasteful) == \
                (b.promotions, b.demotions, b.wasteful)
            np.testing.assert_allclose(a.exec_time_s, b.exec_time_s,
                                       rtol=1e-4)
            assert abs(a.hot_recall - b.hot_recall) <= 1e-6
            assert abs(a.fast_hit_frac - b.fast_hit_frac) <= 1e-6
        arms = res.at(policy="arms", workload="trace")
        allslow = res.at(policy="all-slow", workload="trace")
        oracle = res.at(policy="oracle", workload="trace")
        assert np.isfinite(arms.exec_time_s) and arms.exec_time_s > 0
        assert allslow.promotions == 0 and allslow.fast_hit_frac == 0.0
        assert arms.promotions > 0 and arms.fast_hit_frac > 0.0
        assert oracle.exec_time_s < allslow.exec_time_s

    def test_fitted_spec_runs_as_workload_lane(self):
        """A fitted spec is a synthesis lane of the tuning study."""
        from repro.simulator import experiment as jexp
        from repro_torch.simulator import experiment as pexp
        counts = _integer_steps(S=64, n=16, seed=5)
        counts[:, :3] *= 30.0
        kw = dict(k=32, T=48, n=128, sim_seed=1)
        p = pexp.sweep(["hemem"], workloads=[ptraces.fit_workload_spec(
            ptraces.TraceWorkload(counts, label="kv"))], device="cpu", **kw)
        j = jexp.sweep(["hemem"], workloads=[jtraces.fit_workload_spec(
            jtraces.TraceWorkload(counts, label="kv"))], **kw)
        assert p.axes == j.axes and p.axes["workload"] == ["fit:kv"]
        a, b = p.at(), j.at()
        assert (a.promotions, a.demotions, a.wasteful) == \
            (b.promotions, b.demotions, b.wasteful)
        np.testing.assert_allclose(a.exec_time_s, b.exec_time_s, rtol=1e-4)
