"""The port's dry run (repro_torch/launch/dryrun.py), CI-scale.

Runs the port's dry-run CLI in a subprocess (its fake process group of
256 or 512 ranks stays out of this process) for the cell of JAX's
tests/test_dryrun_integration.py, stablelm-1.6b decode_32k, on both
production meshes, with that test's assertions on the record.  A
reduced SSM (mamba2-370m, prefill) and MoE (llama4-scout, train) cell
run in-process on a fake (2, 2) mesh: the scan counts through its
kernel op's formula.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch.configs import registry
from repro_torch.configs.base import ShapeConfig
from repro_torch.kernels.mamba_scan import ops as scan_ops
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as mesh_lib

ROOT = Path(__file__).resolve().parents[1]


def _check(rec, chips):
    assert rec["status"] == "ok"
    assert rec["chips"] == chips
    r = rec["roofline"]
    for term in ("compute_s", "memory_s", "collective_s"):
        assert r[term] >= 0.0
    assert r["dominant"] in ("compute", "memory", "collective")
    assert rec["model_flops"] > 0
    assert rec["collectives"]["_total"] >= 0
    assert rec["memory_analysis"]["temp_size_in_bytes"] > 0


@pytest.mark.parametrize("mesh", ["pod1", "pod2"])
def test_dryrun_cell_runs_and_reports(tmp_path, mesh):
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
           "--arch", "stablelm-1.6b", "--shape", "decode_32k",
           "--mesh", mesh, "--out", str(tmp_path)]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                         env=env)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-2000:]
    rec = json.loads(
        (tmp_path / f"stablelm-1.6b__decode_32k__{mesh}.json").read_text())
    _check(rec, 512 if mesh == "pod2" else 256)
    assert rec["mesh"] == ("2x16x16" if mesh == "pod2" else "16x16")


def test_skipped_cell_gives_jax_reason():
    rec = dryrun.lower_cell("granite-8b", "long_500k", False)
    assert rec["status"] == "skipped"
    assert rec["reason"] == ("pure full-attention arch: 500k decode "
                             "skipped (DESIGN.md §5)")


@pytest.fixture
def fake_mesh():
    mesh_lib.bring_up("fake", world_size=4)
    try:
        yield mesh_lib.make_mesh((2, 2), ("data", "model"))
    finally:
        mesh_lib.tear_down()


@pytest.mark.parametrize("arch,shape", [
    ("mamba2-370m", ShapeConfig("p", "prefill", 32, 4)),
    ("llama4-scout-17b-16e", ShapeConfig("t", "train", 32, 16))])
def test_reduced_cells_on_a_fake_mesh(arch, shape, fake_mesh):
    """The SSM's prefill counts each layer's scan on a device's shard by
    the kernels' formula (at least its batch half and its head half);
    the MoE's train step runs the dispatch forward and backward."""
    cfg = registry.reduced(registry.get_arch(arch))
    rec = dryrun.measure(cfg, shape, fake_mesh, 4)
    _check(rec, 4)
    if cfg.family == "ssm":
        fwd, _ = scan_ops.flops(2, 32, cfg.ssm_heads // 2, cfg.ssm_head_dim,
                                cfg.ssm_state, cfg.ssm_chunk)
        assert rec["cost_analysis"]["flops"] >= cfg.n_layers * fwd
