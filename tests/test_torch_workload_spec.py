"""Port parity of the workload protocol (``repro_torch.simulator.
workload_spec``, ``workloads`` and ``scenarios``) against the JAX package.

Contract:
  * permutations (initial ranks, event redraws) and event keys: exact;
  * materialized rows of the hot-set, xsbench and tpcc kinds, and of every
    scenario of ``scenarios.suite``: bit for bit JAX's;
  * rows with a zipf component (zipf, zipf+boost): within 4 ulps of
    JAX's at every element (XLA's f32 ``pow`` is glibc's ``powf``; the
    port rounds an f64 ``pow`` once, ROADMAP queue 3);
  * the port's synthesized rows (``Synth`` over a lane stack) equal its
    own ``materialize`` bit for bit;
  * the f32 steps the rows are built from, against XLA's compiled CPU
    code: row sums (``_xla_sum``) and ``exp`` bit for bit, XLA's rewrite
    of ``pow(exp(a), w)`` as ``exp(a * w)`` bit for bit, ``pow`` within
    1 ulp at under one element in a thousand;
  * every named workload's rows at the main path's width, n = 65,536
    (two shuffle rounds, three levels of 32-wide sums), as above.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.simulator import scenarios as jscen
from repro.simulator import workload_spec as jws
from repro.simulator import workloads as jwl
from repro_torch import convert
from repro_torch.simulator import scenarios as pscen
from repro_torch.simulator import workload_spec as pws
from repro_torch.simulator import workloads as pwl
from repro_torch.utils import prng
from repro_torch.utils.pytree import stack_specs

T, N, K = 64, 256, 32
NAMES = list(jws.NAMED_WORKLOADS)
#: kinds whose rows use pow
POW_KINDS = {jws.KIND_ZIPF, jws.KIND_ZIPF_BOOST}
ULPS = 4


def _ulps(a, b):
    ai = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    bi = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(ai - bi)


def _same_rows(want, got, kinds):
    assert want.shape == got.shape and got.dtype == np.float32
    if POW_KINDS & {int(k) for k in np.asarray(kinds).reshape(-1)}:
        assert _ulps(want, got).max() <= ULPS
    else:
        np.testing.assert_array_equal(want.view(np.int32),
                                      got.view(np.int32))


def _pair(name, **kw):
    return jws.named(name, T=T, **kw), pws.named(name, T=T, **kw)


@pytest.mark.parametrize("name", NAMES)
def test_named_materialize_matches_jax(name):
    js, ps = _pair(name)
    assert pws.label_of(ps) == jws.label_of(js) == name
    for f in pws._F32 + pws._I32:
        np.testing.assert_array_equal(np.asarray(getattr(js, f)),
                                      getattr(ps, f).numpy())
    _same_rows(js.materialize(T, N, 3), ps.materialize(T, N, 3,
                                                       device="cpu"), js.kind)


@pytest.mark.parametrize("name", ["gups", "gapbs-bc", "gapbs-cc"])
def test_init_and_event_permutations_exact(name):
    """Initial ranks, base keys and an event's redraws equal JAX's."""
    js, ps = _pair(name)
    n = 1024
    jst = js.init(n, jax.random.PRNGKey(5))
    pst = ps.init(n, prng.PRNGKey(5))
    np.testing.assert_array_equal(np.asarray(jst.rank), pst.rank.numpy())
    np.testing.assert_array_equal(np.asarray(jst.rank2), pst.rank2.numpy())
    np.testing.assert_array_equal(np.asarray(jst.base_key).astype(np.int64),
                                  pst.base_key.numpy())
    t = {"gups": 150, "gapbs-bc": 40, "gapbs-cc": 100}[name]
    assert bool(js.event_due(jst, jnp.int32(t))) and ps.event_due(pst, t)
    assert not ps.event_due(pst, t + 1)
    jev = jax.jit(type(js).event, static_argnums=(3,))(js, jst,
                                                       jnp.int32(t), True)
    pev = ps.event(pst, t)
    np.testing.assert_array_equal(np.asarray(jev.rank), pev.rank.numpy())
    np.testing.assert_array_equal(np.asarray(jev.rank2), pev.rank2.numpy())


def _composed(m):
    """One composed scenario through each package's combinators."""
    return m.scale(m.mix(
        [m.drift(m.named("xsbench"), 1.5),
         m.phases([m.named("gups"), m.named("silo-tpcc"),
                   m.named("gapbs-cc")], [20, 40])], [0.3, 0.7]), 1.5)


def test_combinators_match_jax():
    js, ps = _composed(jws), _composed(pws)
    assert pws.label_of(ps) == jws.label_of(js)
    _same_rows(js.materialize(T, N, 1), ps.materialize(T, N, 1,
                                                       device="cpu"), js.kind)
    # the JAX spec carried across (convert) gives the same rows
    cs = convert.workload_spec(js, device="cpu")
    assert pws.label_of(cs) == jws.label_of(js)
    np.testing.assert_array_equal(cs.materialize(T, N, 1, device="cpu"),
                                  ps.materialize(T, N, 1, device="cpu"))
    padded = pws.pad_components(ps, ps.n_components + 2)
    np.testing.assert_array_equal(padded.materialize(T, N, 1, device="cpu"),
                                  ps.materialize(T, N, 1, device="cpu"))
    with pytest.raises(ValueError):
        pws.phases([ps, ps], [0])
    with pytest.raises(ValueError):
        pws.mix([ps, ps], [1.0])


@pytest.mark.parametrize("geometry", [(256, 32), (1024, 128)])
def test_scenario_suite_matches_jax(geometry):
    n, k = geometry
    jsuite, psuite = jscen.suite(n, k), pscen.suite(n, k)
    assert [pws.label_of(s) for s in psuite] == \
        [jws.label_of(s) for s in jsuite]
    for js, ps in zip(jsuite, psuite):
        np.testing.assert_array_equal(
            js.materialize(T, n, 2).view(np.int32),
            ps.materialize(T, n, 2, device="cpu").view(np.int32))


def test_legacy_generators_match_jax():
    for name in ("gups", "silo-tpcc", "liblinear"):
        want = jwl.make(name, T=T, n=N)
        got = pwl.make(name, T=T, n=N, device="cpu")
        _same_rows(want, got, jwl.spec(name, T=T).kind)
    np.testing.assert_array_equal(
        jwl.gups(T, N, hot_frac=1.0),
        pwl.gups(T, N, hot_frac=1.0, device="cpu"))
    assert sorted(pwl.WORKLOADS) == sorted(jwl.WORKLOADS)


def test_convert_workload_state():
    js = jws.named("gapbs-bc")
    jst = js.init(N, jax.random.PRNGKey(2))
    pst = convert.workload_state(jax.tree_util.tree_map(np.asarray, jst),
                                 device="cpu")
    ref = pws.named("gapbs-bc").init(N, prng.PRNGKey(2))
    for f in ("rank", "rank2", "base_key"):
        assert torch.equal(getattr(pst, f), getattr(ref, f))


def test_synthesized_rows_equal_materialized():
    """A [W]-lane stack synthesized interval by interval gives each lane's
    own materialized rows, bit for bit (padding included)."""
    specs = [pws.named(nm, T=T) for nm in ("btree", "gapbs-bc",
                                           "silo-tpcc")] \
        + [pscen.suite(N, K)[-1]]
    S = max(s.n_components for s in specs)
    stack = stack_specs([pws.pad_components(s, S) for s in specs])
    syn = pws.Synth(stack, N, prng.PRNGKey(4),
                    any(s.has_boost() for s in specs), T)
    before = pws.MATERIALIZE_CALLS
    rows = torch.stack([syn.row(t) for t in range(T)], dim=1).numpy()
    assert pws.MATERIALIZE_CALLS == before
    for w, s in enumerate(specs):
        np.testing.assert_array_equal(
            rows[w], s.materialize(T, N, 4, device="cpu"))


def test_synth_equals_reference_composition():
    """``Synth`` (rows kept between events, tpcc tables, host rates, rate-0
    components skipped) gives the bits of the reference composition
    ``work_of(t) * step(state, t)`` of the spec's own methods."""
    specs = [_composed(pws), pws.drift(pws.named("silo-tpcc"), 3.0),
             pws.named("liblinear", T=T), pscen.drifting_hot(N, K),
             pscen.serving_mix(N, K)]
    for spec in specs:
        syn = pws.Synth(spec, N, prng.PRNGKey(8), spec.has_boost(), T)
        st = spec.init(N, prng.PRNGKey(8))
        for t in range(T):
            st, probs = spec.step(st, t)
            want = spec.work_of(st, t)[..., None] * probs
            assert torch.equal(syn.row(t), want), (pws.label_of(spec), t)


def test_host_conveniences():
    js, ps = _pair("gapbs-cc")
    assert ps.has_boost() and not pws.named("gups").has_boost()
    assert ps.max_rate() == pytest.approx(js.max_rate())
    assert ps.n_components == js.n_components == 1
    assert pws.named("gups").materialize(4, 8, device="cpu").dtype \
        == np.float32
    with pytest.raises(ValueError):
        pws.named("nope")


@pytest.mark.parametrize("n", [33, 1000, 4097, 65536])
def test_xla_sum_order(n):
    """``_xla_sum`` adds a row in XLA's CPU order: bit for bit ``jnp.sum``
    under ``jit``, uneven padding (4,097) and three levels of windows
    (65,536) included."""
    x = (np.random.default_rng(n).random((3, n)) ** 3).astype(np.float32)
    want = np.asarray(jax.jit(lambda a: a.sum(axis=1))(x))
    got = pws._xla_sum(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(want.view(np.int32), got.view(np.int32))


def test_exp_is_xlas():
    """``_exp`` is XLA's f32 ``exp`` bit for bit on 300,002 points (the
    tpcc window's range [-2, 0] densely, and beyond)."""
    x = np.concatenate([-np.linspace(0, 20, 200001),
                        np.linspace(-3, 3, 100001)]).astype(np.float32)
    want = np.asarray(jax.jit(jnp.exp)(x))
    got = pws._exp(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(want.view(np.int32), got.view(np.int32))


@pytest.mark.parametrize("n", [256, 1024, 4096, 65536])
def test_pow_of_exp_is_rewritten(n):
    """XLA computes the tpcc ramp's ``exp(a) ** w`` as ``exp(a * w)``;
    the port does too (``_tpcc_value``), at each width's window w."""
    w = np.float32(np.round(n * np.float32(0.15)))
    a = np.float32(-2.0) / w
    want = np.asarray(jax.jit(lambda a, w: jnp.exp(a) ** w)(a, w))
    got = pws._exp(torch.tensor(a * w)).numpy()
    assert want.view(np.int32) == got.view(np.int32)


@pytest.mark.parametrize("s", [0.99, 0.9, 0.8, 0.75, 0.7, 0.6])
def test_pow_within_one_ulp(s):
    """The zipf exponents of the named workloads over ranks r + 1 <
    65,537: the port's ``pow`` (f64 rounded once) is XLA's f32 ``pow``
    (glibc's ``powf``) but at under one element in a thousand, by 1 ulp
    (ROADMAP queue 3)."""
    r = np.arange(65536, dtype=np.float32) + 1
    want = np.asarray(jax.jit(lambda r, s: r ** -s)(r, np.float32(s)))
    got = pws._pow(torch.from_numpy(r), torch.tensor(-np.float32(s)))
    d = _ulps(want, got.numpy())
    assert d.max() <= 1 and (d > 0).sum() < r.size // 1000


@pytest.mark.parametrize("name", NAMES)
def test_named_rows_full_width(name):
    """n = 65,536 over 41 intervals (gapbs-bc's first boost redraw at 40):
    permutations of two shuffle rounds, sums of three levels."""
    js, ps = _pair(name)
    _same_rows(js.materialize(41, 65536, 3),
               ps.materialize(41, 65536, 3, device="cpu"), js.kind)
