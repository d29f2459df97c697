"""The port's roofline (repro_torch/roofline.py) and the model's active
parameter count (repro_torch/models/model.py) against
repro/roofline.py and repro/models/model.py.

``active_params`` and ``model_flops`` equal JAX's exactly for every arch
and shape; ``RooflineTerms`` and ``roofline()`` give the terms of given
counts over the H100 SXM constants; ``analyze_step`` on JAX's
``TestRooflineParser`` program (one 8 x 8 x 8 product and an all-gather
of an f32 [8, 8] in a 5-trip loop) reads its 1,024 FLOP and 1,280
all-gather bytes, and on a fake (2, 2) mesh a product sharded 4 ways
counts a quarter of the global FLOP on a device, a kernel op its own
formula.
"""
import pytest
import torch
import torch.distributed._functional_collectives as funcol
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro import roofline as jroofline
from repro.configs import registry as jregistry
from repro.models import model as JM
from repro_torch import roofline
from repro_torch.configs import registry
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import model as M


@pytest.mark.parametrize("arch", sorted(registry.ARCHS))
def test_active_params_and_model_flops_match_jax(arch):
    jcfg, cfg = jregistry.get_arch(arch), registry.get_arch(arch)
    assert M.active_params(cfg) == JM.active_params(jcfg)
    for name in registry.SHAPES:
        assert roofline.model_flops(cfg, registry.get_shape(name)) == \
            jroofline.model_flops(jcfg, jregistry.get_shape(name))


def test_roofline_terms_on_given_counts():
    chips = 256
    t = roofline.roofline(
        {"flops": 2 * roofline.PEAK_FLOPS_BF16 * chips,
         "bytes accessed": 3 * roofline.HBM_BW * chips},
        0.5 * roofline.NET_BW * chips, chips)
    assert (t.compute_s, t.memory_s, t.collective_s) == \
        pytest.approx((2.0, 3.0, 0.5))
    assert t.dominant == "memory" and t.bound_s == pytest.approx(3.0)
    assert t.row()["dominant"] == "memory" and t.chips == chips
    assert roofline.roofline({}, 0.0, 1).flops == 0.0
    assert (roofline.PEAK_FLOPS_BF16, roofline.HBM_BW, roofline.NVLINK_BW,
            roofline.NET_BW) == (989e12, 3.35e12, 450e9, 50e9)
    assert roofline.RooflineTerms(1, 2, 3, 0, 0, 0, 1).dominant == \
        "collective"


@pytest.fixture
def fake_mesh():
    """A (2, 2) mesh over a fake process group of 4 ranks (this process
    rank 0), destroyed after the test."""
    mesh_lib.bring_up("fake", world_size=4)
    try:
        yield mesh_lib.make_mesh((2, 2), ("data", "model"))
    finally:
        mesh_lib.tear_down()


def test_analyze_step_reads_jax_parser_program(fake_mesh):
    group = (fake_mesh, 0)
    a = torch.empty(8, 8, device="meta")

    def step(a):
        d = a @ a
        for _ in range(5):
            d = d + funcol.all_gather_single(a[:4], 0, group)
        return d

    res = roofline.analyze_step(step, a)
    assert res["flops"] == 2 * 8 * 8 * 8
    assert res["collectives"]["all-gather"] == 8 * 8 * 4 * 5
    assert res["collectives"]["_total"] == 8 * 8 * 4 * 5
    assert res["bytes"] > 0


def test_sharded_product_counts_its_shard(fake_mesh):
    M_, K, N = 64, 256, 128
    x = DTensor.from_local(torch.empty(M_ // 2, K, device="meta"),
                           fake_mesh, [Shard(0), Replicate()],
                           run_check=False)
    w = DTensor.from_local(torch.empty(K, N // 2, device="meta"),
                           fake_mesh, [Replicate(), Shard(1)],
                           run_check=False)
    res = roofline.analyze_step(lambda: x @ w)
    assert res["flops"] == 2 * M_ * K * N / 4
    assert res["collectives"]["_total"] == 0
    q = DTensor.from_local(torch.empty(1, 64, 2, 16, device="meta"),
                           fake_mesh, [Shard(0), Shard(2)],
                           run_check=False)
    res = roofline.analyze_step(lambda: flash_ops.flash_attention(q, q, q))
    assert res["flops"] == flash_ops.flops_fwd(1, 64, 2, 16, 16, True, 0)
    with roofline.StepCounter() as c:
        y = x @ w
    assert c.peak_bytes == y.to_local().numel() * 4


@pytest.mark.parametrize("S,causal,window", [
    (7, True, 0), (64, True, 16), (16, True, 32), (9, False, 0),
    (33, False, 8)])
def test_kept_pairs_counts_the_mask(S, causal, window):
    i = torch.arange(S)[:, None]
    j = torch.arange(S)[None, :]
    keep = torch.ones(S, S, dtype=torch.bool)
    if causal:
        keep &= j <= i
    if window:
        keep &= j > i - window
    assert flash_ops.kept_pairs(S, causal, window) == int(keep.sum())
