"""Port parity of the sweep fabric (``repro_torch.simulator.fabric``):
union dispatch and lane sharding on one device, at the gate scale of
tests/test_fabric.py (T 48, n 192, k 24; all nine families; the 2-tier
``pmem-large`` and the 3-tier ``dram-cxl-pmem``; synthesis and trace
mode; timelines on).

  * the port's union pass is bit for bit the port's grouped passes on
    every ``SimResult`` field, in one pass recorded as ``"union"``;
  * against JAX's union: counts and integer timelines exact, exec_time
    within 1e-4 relative (the replay contract, ``same_result``), and
    ``build_union``'s slot layout equal to JAX's;
  * ``"auto"`` unions a mixed panel and groups a single family; specs of
    one family with different meta are separate members;
  * a mesh of 1 and forced lane padding are bit for bit the plain path,
    the record giving the logical and the padded lanes; a mesh larger
    than the device count raises.

Meshes of 2 and 8 are tests/test_torch_fabric_mesh.py's.
"""
import dataclasses

import numpy as np
import pytest

from _torch_cases import same_result
from repro.simulator import experiment as jexp
from repro.simulator import fabric as jfabric
from repro.simulator import machine_spec as jms
from repro.simulator import machines as jmachines
from repro.simulator import workloads as jworkloads
from repro.simulator.sampling import uniform_field
from repro_torch.baselines.hemem import HeMemSpec
from repro_torch.simulator import experiment as pexp
from repro_torch.simulator import fabric
from repro_torch.simulator import machine_spec as pms
from repro_torch.simulator import machines as pmachines
from repro_torch.simulator import scan_engine as pscan
from repro_torch.simulator import search
from repro_torch.simulator.engine import SimResult

T, N, K = 48, 192, 24
ALL_FAMILIES = list(pexp.POLICY_REGISTRY)
MACHS = ["pmem-large", "dram-cxl-pmem"]
_FIELDS = [f.name for f in dataclasses.fields(SimResult) if f.name != "name"]


def assert_bitwise(ra, rb, tag=""):
    assert ra.axes == rb.axes
    assert len(ra.grid) == len(rb.grid)
    for (coords, a), (_, b) in zip(ra.items(), rb.items(), strict=True):
        assert a.name == b.name
        for f in _FIELDS:
            va, vb = getattr(a, f), getattr(b, f)
            if va is None and vb is None:
                continue
            assert np.array_equal(np.asarray(va), np.asarray(vb)), \
                f"{tag} {coords} {f}: {va} != {vb}"


def _kw(mode):
    if mode == "synth":
        return dict(workloads=["gups", "btree"], machines=MACHS, k=K, T=T,
                    n=N, timelines=True)
    return dict(trace=jworkloads.make("silo-tpcc", T=T, n=N),
                machines=MACHS, k=K, sample_u=uniform_field(T, N, seed=7),
                timelines=True)


@pytest.fixture(scope="module", params=["synth", "trace"])
def board(request):
    """(mode, kwargs, port union, its records, port grouped, JAX union)."""
    kw = _kw(request.param)
    with pscan.count_dispatches() as ctr:
        union = pexp.sweep(ALL_FAMILIES, dispatch="union", device="cpu",
                           **kw)
    grouped = pexp.sweep(ALL_FAMILIES, dispatch="grouped", device="cpu",
                         **kw)
    jax_union = jexp.sweep(ALL_FAMILIES, dispatch="union", **kw)
    return request.param, kw, union, ctr, grouped, jax_union


# ------------------------------------------------------- union dispatch
def test_union_bitwise_equals_grouped(board):
    """All nine families x 2-/3-tier, timelines on: the one union pass is
    bit for bit the nine grouped passes."""
    mode, _, union, ctr, grouped, _ = board
    assert ctr.count == 1
    assert ctr.last["dispatch"] == "union"
    assert ctr.last["families"] == len(ALL_FAMILIES)
    assert ctr.last["lanes"] == len(union.grid)
    assert_bitwise(union, grouped, mode)


def test_union_matches_jax_union(board):
    _, _, union, _, _, jax_union = board
    assert union.axes == jax_union.axes
    for (cu, a), (cj, b) in zip(union.items(), jax_union.items(),
                                strict=True):
        assert cu == cj and a.name == b.name
        same_result(a, b)


@pytest.mark.parametrize("machs", [MACHS, ["pmem-large"]],
                         ids=["mixed_tiers", "two_tier"])
def test_slot_layout_equals_jax(machs):
    """The slot layout (buckets by (shape, dtype), max multiplicity,
    sorted by (dtype, shape)) and every member's slot ids are JAX's; the
    union holds fewer slots than the members' leaves together."""
    jspecs = [jexp.policy_spec(p) for p in ALL_FAMILIES]
    jmach, _ = jms.lane_stack([jmachines.get(m) for m in machs], N, K)
    want = jfabric.build_union(jspecs, N, K, jmach)
    pspecs = [pexp.policy_spec(p) for p in ALL_FAMILIES]
    pmach, _ = pms.lane_stack([pmachines.get(m) for m in machs], N, K,
                              "cpu")
    got = fabric.build_union(pspecs, N, K, pmach)
    assert len(got) == len(want) == len(ALL_FAMILIES)
    assert got[0].slot_defs == want[0].slot_defs
    assert [(m.name, m.slot_ids, m.pad_mv) for m in got[0].members] == \
        [(m.name, m.slot_ids, m.pad_mv) for m in want[0].members]
    assert (got[0].pad_mv, got[0].min_period) == \
        (want[0].pad_mv, want[0].min_period)
    assert [int(u.fam) for u in got] == [int(u.fam) for u in want]
    assert [bool(u.wants_true) for u in got] == \
        [bool(u.wants_true) for u in want]
    assert [float(u.slow_extra) for u in got] == \
        [float(u.slow_extra) for u in want]
    members = got[0].members
    assert len(got[0].slot_defs) < sum(len(m.slot_ids) for m in members)
    for m in members:
        assert len(set(m.slot_ids)) == len(m.slot_ids)


def test_auto_unions_mixed_and_groups_single_family():
    kw = dict(workloads=["gups"], machines=["pmem-large"], k=K, T=T, n=N,
              device="cpu")
    with pscan.count_dispatches() as ctr:
        mixed = pexp.sweep(["hemem", "arms"], **kw)
    assert ctr.count == 1 and ctr.last["dispatch"] == "union"
    assert ctr.last["families"] == 2
    assert_bitwise(mixed, pexp.sweep(["hemem", "arms"], dispatch="grouped",
                                     **kw), "auto")
    with pscan.count_dispatches() as ctr:
        pexp.sweep([HeMemSpec.make(), HeMemSpec.make(hot_threshold=2.0)],
                   **kw)
    # one family (one treedef): the plain stacked path
    assert ctr.count == 1 and ctr.last["dispatch"] == "grouped"
    assert ctr.last["families"] == 1


def test_same_family_different_meta_get_separate_members():
    """Member identity keys on the spec treedef: two HeMems with
    different ``migration_limit`` meta are two members."""
    a, b = HeMemSpec.make(), HeMemSpec.make(migration_limit=4)
    kw = dict(workloads=["gups"], machines=["pmem-large"], k=K, T=T, n=N,
              device="cpu")
    with pscan.count_dispatches() as ctr:
        ru = pexp.sweep([a, b, "jenga"], dispatch="union", **kw)
    assert ctr.count == 1 and ctr.last["families"] == 3
    rg = pexp.sweep([a, b, "jenga"], dispatch="grouped", **kw)
    assert_bitwise(ru, rg, "meta-variant")


# ---------------------------------------------- sharding (one device)
def test_mesh1_and_padding_bitwise_equal_plain(board):
    """A forced mesh of 1, and lane padding to multiples the lane count is
    not one of (36 lanes synthesized, 18 traced; 5 and 8), are bit for bit
    the plain union pass; the padded lanes never reach the grid."""
    mode, kw, union, _, _, _ = board
    L = len(union.grid)
    with pscan.count_dispatches() as ctr:
        m1 = pexp.sweep(ALL_FAMILIES, mesh=1, device="cpu", **kw)
    assert ctr.last["mesh"] == 1 and ctr.last["padded_lanes"] == L
    assert_bitwise(union, m1, f"{mode} mesh=1")
    for mult in (5, 8):
        with pscan.count_dispatches() as ctr:
            padded = pexp.sweep(ALL_FAMILIES, mesh=1, _pad_multiple=mult,
                                device="cpu", **kw)
        assert ctr.last["lanes"] == L
        assert ctr.last["padded_lanes"] == -(-L // mult) * mult
        assert padded.shape == union.shape
        assert_bitwise(union, padded, f"{mode} pad_multiple={mult}")


def test_dispatch_record_reports_logical_and_padded_lanes():
    with pscan.count_dispatches() as ctr:
        pexp.sweep(["arms", "hemem"], workloads=["gups"], machines=MACHS,
                   k=K, T=T, n=N, mesh=1, _pad_multiple=3, device="cpu")
    assert ctr.last["lanes"] == 4                   # logical
    assert ctr.last["padded_lanes"] == 6            # ceil(4/3)*3
    assert ctr.last["mesh"] == 1
    assert ctr.last["lane_intervals"] == 4 * T


def test_search_mesh_is_bitwise_and_logical_lane_intervals():
    """``SearchResult.lane_intervals`` counts logical lanes, so the
    compute curves are the same at any mesh size."""
    trace = jworkloads.make("gups", T=T, n=N)
    plain = search.run("hemem", "asha", trace=trace, k=K, budget=6,
                       device="cpu")
    meshy = search.run("hemem", "asha", trace=trace, k=K, budget=6, mesh=1,
                       device="cpu")
    assert plain.best_config == meshy.best_config
    assert plain.lane_intervals == meshy.lane_intervals
    assert [r.lane_intervals for r in plain.rounds] == \
        [r.lane_intervals for r in meshy.rounds]
    assert [c for c, _ in plain.rows] == [c for c, _ in meshy.rows]
    assert [r.exec_time_s for _, r in plain.rows] == \
        [r.exec_time_s for _, r in meshy.rows]


def test_mesh_too_big_raises():
    assert fabric.resolve_mesh(None, "cpu") is None
    assert fabric.resolve_mesh("auto", "cpu") is None
    assert fabric.resolve_mesh(1, "cpu") == 1
    with pytest.raises(ValueError, match="device"):
        fabric.resolve_mesh(fabric.device_count("cpu") + 1, "cpu")
