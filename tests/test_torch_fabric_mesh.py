"""Meshes of more than one device for the port's sweep fabric (see
tests/test_torch_fabric.py), on the CPU.

``fabric.device_count`` is patched to 8, as tests/test_fabric_mesh.py
forces 8 host devices on JAX, and every shard then runs on the CPU, each
from its own host thread.  Mesh sizes 2 and 8 over a mixed-family 2/3-tier
panel of 20 lanes (a multiple of neither, so mesh 8 pads and drops) must be
bit for bit the unsharded sweep, in synthesis and trace mode, under the
default union dispatch, and ``"auto"`` takes all 8.
"""
import dataclasses

import numpy as np
import pytest

from repro.simulator import workloads as jworkloads
from repro.simulator.sampling import uniform_field
from repro_torch.simulator import experiment as pexp
from repro_torch.simulator import fabric
from repro_torch.simulator import scan_engine as pscan
from repro_torch.simulator.engine import SimResult

T, N, K = 32, 128, 16
POLS = ["arms", "hemem", "tpp", "oracle", "jenga"]
_FIELDS = [f.name for f in dataclasses.fields(SimResult) if f.name != "name"]


def check(ra, rb, tag):
    assert ra.axes == rb.axes, tag
    for (coords, a), (_, b) in zip(ra.items(), rb.items(), strict=True):
        for f in _FIELDS:
            va, vb = getattr(a, f), getattr(b, f)
            if va is None and vb is None:
                continue
            assert np.array_equal(np.asarray(va), np.asarray(vb)), \
                (tag, coords, f)


@pytest.fixture
def eight_devices(monkeypatch):
    monkeypatch.setattr(fabric, "device_count", lambda device=None: 8)


def test_synth_meshes_bitwise_equal_plain(eight_devices):
    kw = dict(workloads=["gups", "btree"],
              machines=["pmem-large", "dram-cxl-pmem"], k=K, T=T, n=N,
              timelines=True, device="cpu")
    base = pexp.sweep(POLS, **kw)
    for D in (2, 8):
        with pscan.count_dispatches() as ctr:
            res = pexp.sweep(POLS, mesh=D, **kw)
        assert ctr.count == 1 and ctr.last["mesh"] == D
        assert ctr.last["dispatch"] == "union"
        assert ctr.last["lanes"] == 20
        assert ctr.last["padded_lanes"] == -(-20 // D) * D
        check(base, res, f"synth mesh={D}")


def test_trace_meshes_bitwise_equal_plain(eight_devices):
    trace = jworkloads.make("silo-tpcc", T=T, n=N)
    kt = dict(trace=trace, machines=["pmem-large", "cxl-1hop"], k=K,
              sample_u=uniform_field(T, N, seed=3), device="cpu")
    bt = pexp.sweep(POLS, **kt)
    check(bt, pexp.sweep(POLS, mesh=8, **kt), "trace mesh=8")
    with pscan.count_dispatches() as ctr:
        auto = pexp.sweep(POLS, mesh="auto", **kt)
    assert ctr.last["mesh"] == 8 and ctr.last["padded_lanes"] == 16
    check(bt, auto, "trace mesh=auto")


def test_prng_seed_lanes_shard_bitwise(eight_devices):
    """Per-lane PRNG keys are sharded with their lanes (a seeds axis)."""
    kw = dict(workloads=["gups"], machines=["pmem-large", "dram-cxl-pmem"],
              seeds=[0, 1, 2], k=K, T=T, n=N, device="cpu")
    base = pexp.sweep(["hemem", "jenga"], **kw)
    check(base, pexp.sweep(["hemem", "jenga"], mesh=4, **kw), "prng mesh=4")
