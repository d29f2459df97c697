"""Port parity of the batched page migration (repro_torch/kernels/migrate).

The port's op on the CPU (its plain version) is held to the JAX package's
``migrate_ref`` and to the Pallas ``migrate_kernel`` run in interpret
mode, on the same numpy-seeded pools: exact equality, with odd page and
feature sizes, invalid entries (some with -1 indices), ``M = 0`` and the
serving layer's move within one tensor over disjoint rows.  The CUDA
kernel is held to the plain version on the card by
tests/test_torch_kernels_cuda.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cases import MIGRATE_SHAPES, migrate_pools_case
from _torch_cases import t as _t
from repro.kernels.migrate.kernel import migrate_kernel
from repro.kernels.migrate.ref import migrate_ref
from repro_torch.kernels.migrate import ops


def _jax_args(src, dst, si, di, va):
    """The TPU kernel reads slot 0 for invalid entries and needs indices
    in range there; the port takes -1."""
    clip = lambda i, P: jnp.asarray(np.where(va, i, np.clip(i, 0, P - 1)))
    return (jnp.asarray(src), jnp.asarray(dst), clip(si, src.shape[0]),
            clip(di, dst.shape[0]), jnp.asarray(va))


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
@pytest.mark.parametrize("shape", MIGRATE_SHAPES)
def test_migrate_matches_jax_ref_and_kernel(shape, dtype):
    case = migrate_pools_case(*shape, seed=sum(shape), dtype=dtype)
    src, dst, si, di, va = case
    want = np.asarray(migrate_ref(*_jax_args(*case)))
    interp = np.asarray(migrate_kernel(*_jax_args(*case), interpret=True))
    d = _t(dst)
    got = ops.migrate(_t(src), d, _t(si), _t(di), _t(va))
    assert got is d                       # in place
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), interp)


def test_migrate_no_entries_and_all_invalid():
    src, dst, si, di, va = migrate_pools_case(8, 8, 4, 4, 32, seed=3)
    d = _t(dst)
    e = torch.zeros((0,), dtype=torch.int32)
    ops.migrate(_t(src), d, e, e, e.bool())
    np.testing.assert_array_equal(d.numpy(), dst)
    ops.migrate(_t(src), d, _t(si), _t(di), torch.zeros(4, dtype=torch.bool))
    np.testing.assert_array_equal(d.numpy(), dst)
    want = migrate_ref(jnp.asarray(src), jnp.asarray(dst),
                       jnp.zeros(4, jnp.int32), jnp.zeros(4, jnp.int32),
                       jnp.zeros(4, bool))
    np.testing.assert_array_equal(d.numpy(), np.asarray(want))


def test_migrate_valid_entry_onto_row_zero():
    """Row 0 written by a valid entry while invalid entries are present."""
    rng = np.random.default_rng(5)
    src = rng.standard_normal((5, 3, 7)).astype(np.float32)
    dst = rng.standard_normal((6, 3, 7)).astype(np.float32)
    si = np.array([-1, 4, 2, -1], np.int32)
    di = np.array([-1, 0, 5, 3], np.int32)
    va = np.array([False, True, True, False])
    d = _t(dst)
    ops.migrate(_t(src), d, _t(si), _t(di), _t(va))
    want = migrate_ref(*_jax_args(src, dst, si, di, va))
    np.testing.assert_array_equal(d.numpy(), np.asarray(want))


def test_migrate_rows_same_tensor_disjoint():
    """The serving pools' move: fast rows first, home rows after, source
    and destination rows disjoint, K and V moved by one call; equal to
    the JAX reference run on separate source and destination copies."""
    rng = np.random.default_rng(9)
    k = rng.standard_normal((11, 4, 6)).astype(np.float32)
    v = rng.standard_normal((11, 4, 6)).astype(np.float32)
    si = np.array([0, 1, 2, -1], np.int32)          # fast slots
    di = np.array([3 + 5, 3 + 0, -1, 3 + 7], np.int32)  # home rows
    va = np.array([True, True, False, False])
    kt, vt = _t(k), _t(v)
    ops.migrate_rows((kt, vt), _t(si), _t(di), _t(va))
    for pool, got in ((k, kt), (v, vt)):
        want = migrate_ref(*_jax_args(pool.copy(), pool.copy(), si, di, va))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_migrate_skips_out_of_range_entries():
    """A valid entry whose source or destination is out of range is
    skipped like an invalid one: the same result as the JAX reference
    with those entries marked invalid."""
    src, dst, si, di, va = migrate_pools_case(9, 7, 5, 3, 5, seed=21)
    va[:] = True
    si[1], di[3] = 9, -2
    d = _t(dst)
    ops.migrate(_t(src), d, _t(si), _t(di), _t(va))
    keep = (si >= 0) & (si < 9) & (di >= 0) & (di < 7)
    assert not keep[1] and not keep[3]
    want = migrate_ref(*_jax_args(src, dst, si, di, keep))
    np.testing.assert_array_equal(d.numpy(), np.asarray(want))
