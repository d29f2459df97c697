"""Port parity of the slow-tier realization modes
(repro_torch/tiering/host_offload.py against repro/tiering/host_offload.py).

On the CPU the port has no pinned host memory to offer (no CUDA device),
so ``memkind`` returns its input, as JAX's does where the memory kind is
missing.  JAX's is called with a one-device mesh: without one it raises
under this JAX (ROADMAP queue 3), where the port's works.  Values, dtype
and shape are held equal in both modes; ``buffer`` returns its input.
The card's side (a pinned host copy, a tensor back on the card) is
tests/test_torch_kernels_cuda.py's.  A mesh of more than one device is
a (2, 2) mesh over a fake process group of 4 ranks.
"""
import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from _torch_cases import t as _t
from repro.tiering import host_offload as JHO
from repro_torch.tiering import host_offload as HO

CASES = [((7, 3, 5), np.float32), ((4, 9), np.int32), ((2, 3, 8), np.float16)]


def _one_device_mesh():
    return Mesh(np.array(jax.devices()[:1]), ("x",))


@pytest.mark.parametrize("shape,dtype", CASES)
@pytest.mark.parametrize("mode", ["buffer", "memkind"])
def test_tiers_match_jax(mode, shape, dtype):
    x = (np.random.default_rng(sum(shape)).standard_normal(shape) * 50) \
        .astype(dtype)
    mesh = _one_device_mesh()
    for j_fn, fn in ((JHO.to_slow_tier, HO.to_slow_tier),
                     (JHO.to_fast_tier, HO.to_fast_tier)):
        want = np.asarray(j_fn(jax.numpy.asarray(x), mode, mesh=mesh))
        for m in (None, 1, mesh):
            got = fn(_t(x), mode, mesh=m)
            assert got.dtype == _t(x).dtype and tuple(got.shape) == shape
            np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("mode", ["buffer", "memkind"])
def test_returns_its_input_without_a_card(mode, monkeypatch):
    """``buffer`` always, and ``memkind`` without a CUDA device (JAX's
    ``buffer`` likewise returns its input)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert not HO.supports_memkind()
    x = torch.arange(12.0).view(3, 4)
    assert HO.to_slow_tier(x, mode) is x and HO.to_fast_tier(x, mode) is x
    j = jax.numpy.arange(12.0)
    if mode == "buffer":
        assert JHO.to_slow_tier(j, mode) is j


def test_supports_memkind_is_cuda_present(monkeypatch):
    for present in (False, True):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: present)
        assert HO.supports_memkind() is present


@pytest.fixture
def fake_mesh():
    """A (2, 2) mesh over a fake process group of 4 ranks (this process
    rank 0), destroyed after the test."""
    from repro_torch.launch import mesh as mesh_lib
    mesh_lib.bring_up("fake", world_size=4)
    try:
        yield mesh_lib.make_mesh((2, 2), ("data", "model"), "cpu")
    finally:
        mesh_lib.tear_down()


@pytest.mark.parametrize("fn", ["to_slow_tier", "to_fast_tier"])
def test_larger_mesh_and_unknown_mode_raise(fn, fake_mesh):
    """A mesh of more than one device gives the tensor replicated over
    it (JAX's ``NamedSharding(mesh, P())``), in ``buffer`` the input
    itself; a device count of more than one names no devices and raises,
    as does an unknown mode."""
    from torch.distributed.tensor import DTensor, Replicate
    x = torch.arange(12.0).view(3, 4)
    got = getattr(HO, fn)(x, "memkind", mesh=fake_mesh)
    assert isinstance(got, DTensor) and got.device_mesh is fake_mesh
    assert tuple(got.placements) == (Replicate(), Replicate())
    assert tuple(got.shape) == (3, 4)
    np.testing.assert_array_equal(got.to_local().numpy(), x.numpy())
    assert getattr(HO, fn)(x, "buffer", mesh=fake_mesh) is x
    with pytest.raises(ValueError, match="pass its DeviceMesh"):
        getattr(HO, fn)(x, "memkind", mesh=2)
    with pytest.raises(ValueError, match="unknown slow-tier mode"):
        getattr(HO, fn)(x, "pinned")
