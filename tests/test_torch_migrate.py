"""Port parity of the migration fire (repro_torch/kernels/migrate).

The port's plain versions on the CPU are held to the JAX package, on the
same numpy-seeded pools, exactly:

* ``ref.migrate_ref`` (one batch of row moves) and the fire op fed the
  same moves as a slot table, against JAX's ``migrate_ref`` and the Pallas
  ``migrate_kernel`` run in interpret mode: odd page and feature sizes,
  invalid entries (some with -1 indices), empty batches, a valid entry onto
  row 0, out-of-range entries, and the serving layer's fused ``[k + n,
  ...]`` pools;
* ``ops.migrate_fire`` (``ref.migrate_fire_ref`` on the CPU) against the
  data move of JAX's ``tiered_pool.pool_fire`` (``move``: the demotions'
  copy-back, then the promotions, on separate fast and slow arrays), from
  the padded plan through the port's slot tables: f32 and i32, odd row
  sizes, ``copy_back`` on and off, every promotion into a slot a demotion
  of the same fire vacated, and pools of two row shapes in one fire.

The CUDA kernel is held to the plain version on the card by
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
from repro_torch.kernels.migrate import ops, ref
from repro_torch.tiering import tiered_pool as TP


def _jax_args(src, dst, si, di, va):
    """The TPU kernel reads slot 0 for invalid entries and needs indices
    in range there; the port takes -1."""
    clip = lambda i, P: jnp.asarray(np.where(va, i, np.clip(i, 0, P - 1)))
    return (jnp.asarray(src), jnp.asarray(dst), clip(si, src.shape[0]),
            clip(di, dst.shape[0]), jnp.asarray(va))


def _in_row(src, dst, si, di, va):
    """The moves ``dst[di] = src[si]`` as the fire's promotion table of a
    fast pool ``dst`` over a home pool ``src``: -1 where no valid entry in
    range lands."""
    tab = np.full(dst.shape[0], -1, np.int32)
    ok = va & (si >= 0) & (si < src.shape[0]) & (di >= 0) \
        & (di < dst.shape[0])
    tab[di[ok]] = si[ok]
    return tab


def _fire_moves(src, dst, si, di, va):
    """The fire op on the moves, as promotions: -> the fast pool."""
    d = _t(dst)
    none = torch.full((dst.shape[0],), -1, dtype=torch.int32)
    ops.migrate_fire([d], [_t(src)], none, _t(_in_row(src, dst, si, di, va)))
    return d.numpy()


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
@pytest.mark.parametrize("shape", MIGRATE_SHAPES)
def test_migrate_matches_jax_ref_and_kernel(shape, dtype):
    case = migrate_pools_case(*shape, seed=sum(shape), dtype=dtype)
    src, dst, si, di, va = case
    want = np.asarray(migrate_ref(*_jax_args(*case)))
    interp = np.asarray(migrate_kernel(*_jax_args(*case), interpret=True))
    d = _t(dst)
    got = ref.migrate_ref(_t(src), d, _t(si), _t(di), _t(va))
    assert got is d                       # in place
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), interp)
    np.testing.assert_array_equal(_fire_moves(*case), want)


def test_migrate_no_entries_and_all_invalid():
    src, dst, si, di, va = migrate_pools_case(8, 8, 4, 4, 32, seed=3)
    d = _t(dst)
    e = torch.zeros((0,), dtype=torch.int32)
    ref.migrate_ref(_t(src), d, e, e, e.bool())
    np.testing.assert_array_equal(d.numpy(), dst)
    ref.migrate_ref(_t(src), d, _t(si), _t(di),
                    torch.zeros(4, dtype=torch.bool))
    np.testing.assert_array_equal(d.numpy(), dst)
    want = migrate_ref(jnp.asarray(src), jnp.asarray(dst),
                       jnp.zeros(4, jnp.int32), jnp.zeros(4, jnp.int32),
                       jnp.zeros(4, bool))
    np.testing.assert_array_equal(d.numpy(), np.asarray(want))
    # the fire: an empty plan (k = 0), and tables of -1 only
    ops.migrate_fire([d[:0]], [_t(src)], e, e)
    minus = torch.full((8,), -1, dtype=torch.int32)
    ops.migrate_fire([d], [_t(src)], minus, minus)
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
    ref.migrate_ref(_t(src), d, _t(si), _t(di), _t(va))
    want = np.asarray(migrate_ref(*_jax_args(src, dst, si, di, va)))
    np.testing.assert_array_equal(d.numpy(), want)
    np.testing.assert_array_equal(_fire_moves(src, dst, si, di, va), want)


def test_migrate_rows_same_tensor_disjoint():
    """The serving pools' copy-back: fast rows first, home rows after, K
    and V moved by one fire over views of the fused tensors; equal to the
    JAX reference run on separate source and destination copies."""
    rng = np.random.default_rng(9)
    k = rng.standard_normal((11, 4, 6)).astype(np.float32)
    v = rng.standard_normal((11, 4, 6)).astype(np.float32)
    si = np.array([0, 1, 2, -1], np.int32)          # fast slots
    di = np.array([3 + 5, 3 + 0, -1, 3 + 7], np.int32)  # home rows
    va = np.array([True, True, False, False])
    out_row = np.array([5, 0, -1], np.int32)       # slot -> home row
    kt, vt = _t(k), _t(v)
    minus = torch.full((3,), -1, dtype=torch.int32)
    ops.migrate_fire((kt[:3], vt[:3]), (kt[3:], vt[3:]), _t(out_row), minus)
    for pool, got in ((k, kt), (v, vt)):
        want = migrate_ref(*_jax_args(pool.copy(), pool.copy(), si, di, va))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_migrate_skips_out_of_range_entries():
    """A valid entry whose source or destination is out of range is
    skipped like an invalid one: the same result as the JAX reference
    with those entries marked invalid; in the fire's tables, a home row
    past the pool moves nothing either way."""
    src, dst, si, di, va = migrate_pools_case(9, 7, 5, 3, 5, seed=21)
    va[:] = True
    si[1], di[3] = 9, -2
    d = _t(dst)
    ref.migrate_ref(_t(src), d, _t(si), _t(di), _t(va))
    keep = (si >= 0) & (si < 9) & (di >= 0) & (di < 7)
    assert not keep[1] and not keep[3]
    want = np.asarray(migrate_ref(*_jax_args(src, dst, si, di, keep)))
    np.testing.assert_array_equal(d.numpy(), want)
    np.testing.assert_array_equal(_fire_moves(src, dst, si, di, va), want)
    fast, home = _t(dst), _t(src)
    ops.migrate_fire([fast], [home], _t(np.array([9, 12, -3, 40, 9, 10, 11],
                                                  np.int32)),
                     _t(np.array([-5, 9, 99, -1, 10, 9, 2 ** 31 - 1],
                                 np.int32)))
    np.testing.assert_array_equal(fast.numpy(), dst)
    np.testing.assert_array_equal(home.numpy(), src)


# ------------------------------------------------ the fire against ``move``
def _plan(rng, k, n, vacated):
    """A padded plan in JAX's terms (``tiered_pool.pool_fire``):
    executed demotions of fast slots ``d_src`` to home rows ``demote`` and
    executed promotions of home rows ``promote`` (disjoint from
    ``demote``) into slots ``p_dst``, among sentinel and unexecuted
    entries.  ``vacated``: every promotion lands in a slot a demotion of
    the same fire vacates."""
    nd = int(rng.integers(1, k + 1))
    npr = int(rng.integers(1, nd + 1)) if vacated else int(rng.integers(1, k))
    pages = rng.permutation(n)
    d_src = rng.choice(k, nd, replace=False)
    p_dst = rng.choice(d_src, npr, replace=False) if vacated \
        else rng.choice(k, npr, replace=False)
    pad = lambda a, m, fill: np.concatenate(
        [a, np.full(m, fill, a.dtype)]).astype(np.int32)
    demote, promote = pages[:nd], pages[nd:nd + npr]
    # unexecuted entries: a sentinel, and a real page that must not move
    return dict(
        d_src=pad(d_src, 2, 0), demote=pad(demote, 2, -1),
        dexec=np.r_[np.ones(nd, bool), False, False],
        p_dst=pad(p_dst, 2, 0), promote=pad(promote, 2, pages[-1]),
        pexec=np.r_[np.ones(npr, bool), False, False])


def _jax_move(fast, slow, plan, copy_back):
    """``move`` of ``repro/tiering/tiered_pool.py::pool_fire``, verbatim
    but for its closure's names."""
    k = fast.shape[0]
    d_src, demote, dexec = (jnp.asarray(plan[x])
                            for x in ("d_src", "demote", "dexec"))
    p_dst, promote, pexec = (jnp.asarray(plan[x])
                             for x in ("p_dst", "promote", "pexec"))
    if copy_back:
        d_rows = fast[jnp.clip(d_src, 0, k - 1)]
        slow = slow.at[jnp.where(dexec, demote, slow.shape[0])].set(
            d_rows, mode="drop")
    p_rows = slow[jnp.clip(promote, 0, slow.shape[0] - 1)]
    fast = fast.at[jnp.where(pexec, p_dst, k)].set(p_rows, mode="drop")
    return np.asarray(fast), np.asarray(slow)


def _port_tables(k, plan, copy_back):
    """The slot tables ``pool_fire`` builds from the plan."""
    p = {nm: _t(a) for nm, a in plan.items()}
    out_row = TP._slot_table(k, p["d_src"], p["demote"], p["dexec"]) \
        if copy_back else torch.full((k,), -1, dtype=torch.int32)
    return out_row, TP._slot_table(k, p["p_dst"], p["promote"], p["pexec"])


# (k fast slots, n home rows, row shape): odd row sizes
FIRE_SHAPES = [(4, 9, (3, 5)), (8, 32, (4, 16)), (5, 7, (1, 7))]


@pytest.mark.parametrize("vacated", [False, True], ids=["free", "vacated"])
@pytest.mark.parametrize("copy_back", [True, False], ids=["copy", "nocopy"])
@pytest.mark.parametrize("shape", FIRE_SHAPES)
@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_fire_matches_jax_move(dtype, shape, copy_back, vacated):
    k, n, row = shape
    rng = np.random.default_rng(k * n + copy_back + 2 * vacated)
    fast = (rng.standard_normal((k,) + row) * 100).astype(dtype)
    slow = (rng.standard_normal((n,) + row) * 100).astype(dtype)
    plan = _plan(rng, k, n, vacated)
    want_f, want_s = _jax_move(jnp.asarray(fast), jnp.asarray(slow), plan,
                               copy_back)
    out_row, in_row = _port_tables(k, plan, copy_back)
    f, s = _t(fast), _t(slow)                       # separate arrays
    ref.migrate_fire_ref([f], [s], out_row, in_row)
    np.testing.assert_array_equal(f.numpy(), want_f)
    np.testing.assert_array_equal(s.numpy(), want_s)
    fused = _t(np.concatenate([fast, slow]))        # the serving layout
    ops.migrate_fire([fused[:k]], [fused[k:]], out_row, in_row)
    np.testing.assert_array_equal(fused.numpy(),
                                  np.concatenate([want_f, want_s]))
    if vacated:
        assert set(plan["p_dst"][plan["pexec"]]) \
            <= set(plan["d_src"][plan["dexec"]])


@pytest.mark.parametrize("copy_back", [True, False], ids=["copy", "nocopy"])
def test_fire_pools_of_two_row_shapes(copy_back):
    """An expert's ``wi`` and ``wo`` (two row shapes, one fire): each pool
    as JAX's ``move`` of it alone."""
    k, n = 4, 11
    rng = np.random.default_rng(17)
    rows = [((3, 10), np.float32), ((5, 3), np.int32)]
    plan = _plan(rng, k, n, True)
    out_row, in_row = _port_tables(k, plan, copy_back)
    pools = [(rng.standard_normal((k + n,) + r) * 50).astype(dt)
             for r, dt in rows]
    bufs = [_t(p) for p in pools]
    ops.migrate_fire([b[:k] for b in bufs], [b[k:] for b in bufs], out_row,
                     in_row)
    for p, b in zip(pools, bufs):
        wf, ws = _jax_move(jnp.asarray(p[:k]), jnp.asarray(p[k:]), plan,
                           copy_back)
        np.testing.assert_array_equal(b.numpy(), np.concatenate([wf, ws]))


def test_fire_op_refuses_mixed_devices_on_the_cpu():
    """A CPU fast pool runs the plain version, which takes tensors of one
    device only."""
    fast = torch.zeros((2, 3))
    home = torch.zeros((4, 3), device="meta")
    tab = torch.full((2,), -1, dtype=torch.int32)
    with pytest.raises(ValueError, match="beside"):
        ops.migrate_fire([fast], [home], tab, tab)
