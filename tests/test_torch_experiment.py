"""Port parity of ``experiment.sweep`` (and the plain path of
``fabric``) against the JAX package's ``sweep(dispatch="grouped")``.

Every cell under the replay contract: promotions, demotions, wasteful
(and integer timelines, or the streamed ``mean_mode`` and
``max_promotions_interval``) exact; exec_time within 1e-4 relative;
hot_recall and fast_hit_frac within 1e-6; the slow-share timeline or its
streamed mean within 1e-5.  Axes, labels, names and the dispatch records
exactly JAX's.  Both modes (trace replay and synthesis), a seeds axis in
both, mixed 2/3-tier machine panels, every family of both routes.
"""
import dataclasses

import numpy as np
import pytest

from _torch_cases import same_result
from repro.baselines.hemem import HeMemSpec as JHeMem
from repro.simulator import experiment as jexp
from repro.simulator import machines as jmachines
from repro.simulator import scan_engine as jscan
from repro.simulator import workload_spec as jws
from repro.simulator import workloads as jworkloads
from repro.simulator.sampling import uniform_field
from repro_torch.baselines.hemem import HeMemSpec as PHeMem
from repro_torch.simulator import experiment as pexp
from repro_torch.simulator import fabric
from repro_torch.simulator import machines as pmachines
from repro_torch.simulator import scan_engine as pscan
from repro_torch.simulator import workload_spec as pws
from repro_torch.utils.pytree import treedef

MACHS = ["pmem-large", "dram-cxl-pmem"]      # 2-tier and 3-tier
FAMILIES = ["arms", "hemem", "memtis", "tpp", "all-slow", "oracle",
            "hybridtier", "jenga", "tierbpf"]


def _trace(wl="gups", T=64, n=128):
    return jworkloads.make(wl, T=T, n=n)


def _cell(a, b):
    """Port cell ``a`` against JAX cell ``b`` (module contract)."""
    assert a.name == b.name
    if b.timeline_mode is not None:
        same_result(a, b)
        return
    assert a.timeline_mode is None
    assert (a.promotions, a.demotions, a.wasteful) == \
        (b.promotions, b.demotions, b.wasteful), a.name
    np.testing.assert_allclose(a.exec_time_s, b.exec_time_s, rtol=1e-4)
    assert abs(a.hot_recall - b.hot_recall) <= 1e-6
    assert abs(a.fast_hit_frac - b.fast_hit_frac) <= 1e-6
    assert a.mean_mode == b.mean_mode
    assert a.max_promotions_interval == b.max_promotions_interval
    np.testing.assert_allclose(a.mean_slow_bw, b.mean_slow_bw, rtol=1e-5)
    np.testing.assert_allclose(a.mean_fast_hits, b.mean_fast_hits,
                               rtol=1e-5)


def _same_sweep(got, want):
    assert got.axes == want.axes
    assert got.shape == want.shape
    for (cg, a), (cw, b) in zip(got.items(), want.items(), strict=True):
        assert cg == cw
        _cell(a, b)


def _both(jax_kw, port_kw=None, **kw):
    """(port sweep, JAX grouped sweep, port records, JAX records)."""
    with jscan.count_dispatches() as jc:
        want = jexp.sweep(dispatch="grouped", **jax_kw, **kw)
    with pscan.count_dispatches() as pc:
        got = pexp.sweep(dispatch="grouped", device="cpu",
                         **(port_kw or jax_kw), **kw)
    return got, want, pc, jc


def _same_records(pc, jc):
    """One pass per family group, each recording JAX's axis-product
    fields."""
    assert pc.count == jc.count
    keys = ("lanes", "sampling", "policy", "synth", "workloads", "configs",
            "machines", "seeds", "T", "axis_product", "reduce", "dispatch",
            "families", "lane_intervals")
    for p, j in zip(pc.records, jc.records):
        assert {k_: p[k_] for k_ in keys} == {k_: j[k_] for k_ in keys}


# (case id) -> (JAX kwargs, port kwargs or None for the same)
def _cases():
    u64 = uniform_field(64, 128, seed=7)
    tr = np.random.default_rng(0).gamma(1.5, 2.0, (64, 128)).astype(
        np.float32)
    gups96 = _trace("gups", 96, 256)
    return {
        # tests/test_machine_spec.py::test_axis_product_one_dispatch_per_family
        "synth_axis_product": (
            dict(policies=[JHeMem.make(), JHeMem.make(hot_threshold=4.0)],
                 workloads=["gups", "silo-tpcc"], machines=MACHS, k=16,
                 T=50, n=128),
            dict(policies=[PHeMem.make(), PHeMem.make(hot_threshold=4.0)],
                 workloads=["gups", "silo-tpcc"], machines=MACHS, k=16,
                 T=50, n=128)),
        # ::test_lane_equals_single_run: a spec and a name on one panel
        "synth_spec_workload": (
            dict(policies=[JHeMem.make()],
                 workloads=[jws.named("gups", T=50)],
                 machines=["pmem-large", "numa"], k=16, T=50, n=128,
                 sim_seed=2),
            dict(policies=[PHeMem.make()],
                 workloads=[pws.named("gups", T=50)],
                 machines=["pmem-large", "numa"], k=16, T=50, n=128,
                 sim_seed=2)),
        # ::test_seed_axis_varies_noise: "prng" over a synthesized source
        "synth_seeds": (
            dict(policies=["arms"], workloads=["silo-tpcc"],
                 machines=["pmem-large"], seeds=[0, 1, 2, 3], k=32, T=100,
                 n=256), None),
        # a seeds axis over a mixed 2/3-tier panel, two families
        "synth_seeds_mixed_tiers": (
            dict(policies=["hemem", "jenga"], workloads=["gups", "btree"],
                 machines=MACHS, seeds=[3, 5], k=16, T=48, n=128,
                 wl_seed=1), None),
        # ::test_trace_mode_matches_numpy
        "trace_crn": (
            dict(policies=[JHeMem.make()], trace=_trace("btree", 60, 128),
                 machines=["pmem-large"], k=16, sim_seed=4),
            dict(policies=[PHeMem.make()], trace=_trace("btree", 60, 128),
                 machines=["pmem-large"], k=16, sim_seed=4)),
        "trace_seeds_mixed_tiers": (
            dict(policies=["arms", "tpp"], trace=_trace("silo-tpcc", 64, 128),
                 machines=MACHS, seeds=[0, 1], k=16), None),
        # ::test_mixed_families_cover_grid, grouped
        "synth_mixed_families": (
            dict(policies=["hemem", "arms"], workloads=["gups"],
                 machines=["pmem-large"], k=16, T=40, n=128), None),
        # tests/test_interval_step.py:214-247: every family, both
        # machines, a CRN field, stacked timelines
        "trace_all_families": (
            dict(policies=FAMILIES, trace=tr, machines=MACHS, k=16,
                 sample_u=u64, timelines=True), None),
        "synth_timelines": (
            dict(policies=["arms", "hemem"], workloads=["gups"],
                 machines=MACHS, k=16, T=64, n=128, timelines=True), None),
        # tests/test_tier_native.py:255-279 (grouped)
        "tier_native_trace": (
            dict(policies=["hemem", "jenga"], trace=gups96, machines=MACHS,
                 k=32, sample_u=uniform_field(96, 256, seed=123)), None),
        "machine_specs": (
            dict(policies=["oracle"], trace=gups96,
                 machines=[jmachines.get("pmem-large"),
                           jmachines.get("cxl-1hop")], k=32),
            dict(policies=["oracle"], trace=gups96,
                 machines=[pmachines.get("pmem-large"),
                           pmachines.get("cxl-1hop")], k=32)),
        # duplicate labels on every axis
        "duplicate_labels": (
            dict(policies=["tpp", "tpp"], workloads=["gups", "gups"],
                 machines=["numa", "numa"], k=16, T=32, n=128), None),
    }


CASES = _cases()


@pytest.mark.parametrize("case", sorted(CASES))
def test_sweep_matches_jax_grouped(case):
    jax_kw, port_kw = CASES[case]
    got, want, pc, jc = _both(jax_kw, port_kw)
    _same_sweep(got, want)
    _same_records(pc, jc)
    if case == "synth_axis_product":
        d = pscan.last_dispatch
        assert pc.count == 1 and d["lanes"] == 8 and d["machines"] == 2
        assert d["synth"] is True and d["axis_product"] is True
        assert got.at(policy=1, workload="silo-tpcc",
                      machine="dram-cxl-pmem") is got.grid[
            ((1 * 2 + 1) * 2 + 1) * 1]
        assert len(list(got.items())) == 8
    if case == "synth_seeds":
        assert pc.last["sampling"] == "prng"
        assert len({got.at(seed=s).exec_time_s for s in range(4)}) > 1
    if case == "machine_specs":
        assert got.axes["machine"] == ["pmem-large", "cxl-1hop"]
    if case == "duplicate_labels":
        assert got.axes["policy"] == ["tpp#0", "tpp#1"]
        assert got.axes["workload"] == ["gups#0", "gups#1"]
        assert got.axes["machine"] == ["numa#0", "numa#1"]


def test_lane_equals_single_run():
    """A sweep lane is the single synthesized run, bit for bit."""
    wl = pws.named("gups", T=50)
    res = pexp.sweep([PHeMem.make()], workloads=[wl],
                     machines=["pmem-large", "numa"], k=16, T=50, n=128,
                     sim_seed=2, device="cpu")
    single = pscan.simulate_workload(PHeMem.make(), wl, "numa", 16, 50, 128,
                                     sim_seed=2, device="cpu")
    lane = res.at(machine="numa")
    assert (lane.promotions, lane.demotions, lane.wasteful,
            lane.exec_time_s) == (single.promotions, single.demotions,
                                  single.wasteful, single.exec_time_s)


def test_stream_equals_stack_scalars():
    trace = _trace("gups", 64, 128)
    u = uniform_field(64, 128, seed=2)
    kw = dict(trace=trace, k=16, sample_u=u, dispatch="grouped",
              device="cpu")
    stream = pexp.sweep(["arms", "tpp"], **kw)
    assert pscan.last_dispatch["reduce"] == "stream"
    stack = pexp.sweep(["arms", "tpp"], timelines=True, **kw)
    for p in ("arms", "tpp"):
        a, b = stream.at(policy=p), stack.at(policy=p)
        for f in ("exec_time_s", "promotions", "demotions", "wasteful",
                  "hot_recall", "fast_hit_frac"):
            assert getattr(a, f) == getattr(b, f)
        assert a.timeline_slow_bw is None and b.mean_slow_bw is None
        assert a.max_promotions_interval == int(b.timeline_promotions.max())


def test_result_addressing_matches_jax():
    """``at`` by label (any case) and by index, ``items`` order, and the
    index errors of ``SweepResult``."""
    kw = dict(workloads=["gups"], machines=["pmem-large", "numa"], k=8,
              T=30, n=64)
    want = jexp.sweep(["hemem"], **kw)
    got = pexp.sweep(["hemem"], device="cpu", **kw)
    assert got.axes == want.axes and got.shape == want.shape == (1, 1, 2, 1)
    assert got.at(machine="NUMA").name == want.at(machine="NUMA").name
    assert [c for c, _ in got.items()] == [c for c, _ in want.items()]
    for res in (got, want):
        with pytest.raises(IndexError):
            res.at(machine=-1)
        with pytest.raises(IndexError):
            res.at(machine=2)
        with pytest.raises(KeyError):
            res.at(machine="optane")


def test_label_helpers():
    assert pexp._dedup_labels(["a", "b", "a", "c"]) == \
        jexp._dedup_labels(["a", "b", "a", "c"]) == ["a#0", "b", "a#2", "c"]
    sp = pmachines.get("pmem-large")
    anon = dataclasses.replace(sp, name="")
    assert pexp._machine_labels([anon, "numa"], [anon, sp]) == ["m0", "numa"]
    assert sorted(pexp.POLICY_REGISTRY) == sorted(jexp.POLICY_REGISTRY)
    assert pexp.AXES == jexp.AXES
    for nm in pexp.POLICY_REGISTRY:
        assert pexp.policy_spec(nm).name == jexp.policy_spec(nm).name


def test_treedef_keys_on_class_and_meta():
    """Same-family specs with different meta land in different groups, as
    JAX's ``tree_structure`` puts them."""
    import jax
    j = [JHeMem.make(), JHeMem.make(hot_threshold=2.0),
         JHeMem.make(migration_limit=4)]
    p = [PHeMem.make(), PHeMem.make(hot_threshold=2.0),
         PHeMem.make(migration_limit=4)]
    js = [jax.tree_util.tree_structure(s) for s in j]
    ps = [treedef(s) for s in p]
    for a in range(3):
        for b in range(3):
            assert (js[a] == js[b]) == (ps[a] == ps[b])
    assert hash(ps[0]) == hash(ps[1])
    got, want, pc, jc = _both(
        dict(policies=j, workloads=["gups"], k=8, T=24, n=64),
        dict(policies=p, workloads=["gups"], k=8, T=24, n=64))
    assert pc.count == jc.count == 2
    _same_sweep(got, want)


@pytest.mark.parametrize("kw", [
    dict(policies=["hemem"], k=8),                          # no workload
    dict(policies=["hemem"], workloads=["gups"],
         trace=np.zeros((4, 8)), k=2, T=4, n=8),            # both
    dict(policies=["hemem"], workloads=["gups"], k=2),      # no T/n
    dict(policies=["nimble"], workloads=["gups"], k=2, T=4, n=8),
    dict(policies=[], workloads=["gups"], k=2, T=4, n=8),   # empty axis
    dict(policies=["hemem"], workloads=[], k=2, T=4, n=8),
    dict(policies=["hemem"], workloads=["gups"], seeds=[0, 1], k=2, T=4,
         n=8, sample_u=np.zeros((4, 8), np.float32)),       # crn + seeds
    dict(policies=["hemem"], workloads=["gups"], k=2, T=4, n=8,
         dispatch="fused"),
], ids=["no_source", "both_sources", "no_T_n", "unknown_policy",
        "empty_policies", "empty_workloads", "sample_u_with_seeds",
        "unknown_dispatch"])
def test_input_validation_as_jax(kw):
    with pytest.raises(ValueError):
        jexp.sweep(**kw)
    with pytest.raises(ValueError):
        pexp.sweep(device="cpu", **kw)


@pytest.mark.parametrize("kw", [
    dict(policies=["hemem", "arms"]),                        # mixed "auto"
    dict(policies=["hemem", "arms"], dispatch="union"),
    dict(policies=["hemem"], dispatch="union"),
    dict(policies=["hemem"], mesh=2),
    dict(policies=["hemem"], _pad_multiple=4),
], ids=["mixed_auto", "mixed_union", "single_union", "mesh", "pad"])
def test_union_fabric_and_sharding_spellings(kw):
    """The union fabric's and lane sharding's spellings: a mixed panel
    (``"auto"`` or ``"union"``) and a single family under ``"union"`` run
    as ONE union pass, bit for bit the grouped passes; ``mesh=2`` on one
    device raises ValueError, as in JAX; ``_pad_multiple=4`` is bit for
    bit the plain path, its record giving the padded lanes."""
    base = dict(workloads=["gups"], k=8, T=16, n=64, device="cpu")
    pols = kw.pop("policies")
    if "mesh" in kw:
        with pytest.raises(ValueError, match="device"):
            pexp.sweep(pols, **base, **kw)
        return
    with pscan.count_dispatches() as ctr:
        got = pexp.sweep(pols, **base, **kw)
    want = pexp.sweep(pols, dispatch="grouped", **base)
    assert ctr.count == 1
    if "_pad_multiple" in kw:
        assert ctr.last["dispatch"] == "grouped"
        assert (ctr.last["lanes"], ctr.last["padded_lanes"]) == (1, 4)
    else:
        assert ctr.last["dispatch"] == "union"
        assert ctr.last["families"] == len(pols)
    assert got.axes == want.axes
    for (_, a), (_, b) in zip(got.items(), want.items(), strict=True):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)


def test_plain_path_spellings_run():
    """``mesh="auto"`` on one device and a single-family ``"auto"`` are
    the plain path; the unfused interval path is refused with a reason."""
    assert fabric.resolve_mesh(None) is None
    assert fabric.resolve_mesh("auto") is None
    kw = dict(workloads=["gups"], k=8, T=16, n=64, device="cpu")
    a = pexp.sweep(["hemem"], mesh="auto", **kw)
    b = pexp.sweep(["hemem"], dispatch="grouped", **kw)
    assert a.at().exec_time_s == b.at().exec_time_s
    with pytest.raises(ValueError, match="one interval path"):
        pexp.sweep(["hemem"], use_interval_kernel=False, **kw)
    assert fabric.resolve_mesh(1, "cpu") == 1
