"""Port parity of the interval-step ops (repro_torch/kernels/interval_step).

The plain torch versions (ref.py) are held to the JAX package's
references on the same numpy-seeded inputs, and one small case of each
Pallas kernel runs in interpret mode against the port: integer and bool
outputs exact, the EWMA bitwise, the accounting's f32 outputs within 1e-6
relative (its sums round from f64 in the port, XLA's f32 order in JAX).

The CUDA kernels are held to these plain versions on the card by
tests/test_torch_kernels_cuda.py.
"""
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.interval_step import kernel as jkernel
from repro.kernels.interval_step import ref as jref
from repro.simulator import scan_engine as jscan
from _torch_cases import account_case, migrate_case, migrate_edge_case
from _torch_cases import t as _t
from repro_torch.kernels.interval_step import ops, ref

ACC = dict(rtol=1e-6, atol=0)


def _account_case(B, n, machine, seed):
    """The shared accounting case plus the JAX package's machine lanes."""
    case = account_case(B, n, machine, seed)
    jmach, _ = jscan._mach_lanes(machine, B, n, case[-1])
    return (jmach,) + case


def _ewma_case(B, n, lane_params, seed):
    rng = np.random.default_rng(seed)
    s = rng.random((B, n)).astype(np.float32)
    l = rng.random((B, n)).astype(np.float32)
    c = rng.poisson(5, (B, n)).astype(np.float32)
    if lane_params:
        kw = {nm: rng.random(B).astype(np.float32)
              for nm in ("alpha_s", "alpha_l", "w_s", "w_l")}
    else:
        kw = dict(alpha_s=0.7, alpha_l=0.1, w_s=0.2, w_l=0.8)
    return s, l, c, kw


class TestTopkMask:
    @pytest.mark.parametrize("B,n,k", [(1, 7, 1), (3, 37, 5), (2, 37, 37),
                                       (2, 200, 64), (4, 513, 1),
                                       (2, 1024, 128)])
    def test_ref_matches_lax_topk(self, B, n, k):
        rng = np.random.default_rng(B * 1000 + n)
        x = (rng.integers(0, 5, (B, n)) * 0.25).astype(np.float32)
        want = jax.vmap(lambda r: jscan._topk_mask(r, k))(jnp.asarray(x))
        np.testing.assert_array_equal(
            ref.topk_mask_ref(_t(x), k).numpy(), np.asarray(want))
        np.testing.assert_array_equal(
            ops.topk_mask(_t(x), k).numpy(), np.asarray(want))

    def test_negative_and_signed_zero_ties(self):
        x = np.asarray([[-1.5, 0.0, -0.0, 2.0, -1.5, 0.0, -3.0]], np.float32)
        for k in range(1, 8):
            want = jax.vmap(lambda r: jscan._topk_mask(r, k))(jnp.asarray(x))
            np.testing.assert_array_equal(
                ref.topk_mask_ref(_t(x), k).numpy(), np.asarray(want))

    def test_pallas_interpret_case(self):
        rng = np.random.default_rng(3)
        x = (rng.integers(0, 4, (2, 200)) * 0.5).astype(np.float32)
        want = jkernel.topk_mask_kernel(jnp.asarray(x), 64, interpret=True)
        np.testing.assert_array_equal(
            ref.topk_mask_ref(_t(x), 64).numpy(), np.asarray(want))


class TestTierMigrate:
    @pytest.mark.parametrize("B,n,R,P,D",
                             [(2, 13, 2, 3, 4), (3, 29, 3, 5, 5),
                              (2, 10, 3, 1, 10), (1, 7, 2, 7, 7),
                              (4, 64, 4, 8, 8), (3, 1024, 3, 64, 64)])
    def test_ref_matches_jax(self, B, n, R, P, D):
        tier, promote, demote, caps = migrate_case(B, n, R, P, D,
                                                    B * 100 + n + R)
        want = jref.tier_migrate_ref(jnp.asarray(tier), jnp.asarray(promote),
                                     jnp.asarray(demote), jnp.asarray(caps))
        got = ops.tier_migrate(_t(tier), _t(promote), _t(demote), _t(caps))
        for g, w, nm in zip(got, want, ("tier", "pexec", "dexec", "up",
                                        "down")):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                          err_msg=nm)

    @pytest.mark.parametrize("kind", ["both", "tight", "invalid"])
    @pytest.mark.parametrize("B,n,R,P,D",
                             [(3, 29, 3, 5, 5), (2, 64, 8, 16, 16),
                              (2, 37, 4, 0, 6), (2, 37, 4, 6, 0),
                              (2, 5, 3, 0, 0)])
    def test_edges_match_jax(self, B, n, R, P, D, kind):
        """The edges the CUDA kernel is held to: pages in both plans, all
        eight tiers, room and slack at or below 0, zero-width and
        all-invalid plans."""
        case = migrate_edge_case(B, n, R, P, D, B + n + R + P, kind)
        want = jref.tier_migrate_ref(*map(jnp.asarray, case))
        got = ops.tier_migrate(*map(_t, case))
        for g, w, nm in zip(got, want, ("tier", "pexec", "dexec", "up",
                                        "down")):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                          err_msg=nm)

    @pytest.mark.parametrize("kind,shape", [("both", (2, 64, 8, 16, 16)),
                                            ("both", (2, 37, 4, 0, 6)),
                                            ("tight", (2, 37, 4, 6, 0))])
    def test_pallas_interpret_edges(self, kind, shape):
        case = migrate_edge_case(*shape, 5, kind)
        want = jkernel.tier_migrate_kernel(*map(jnp.asarray, case),
                                           interpret=True)
        got = ref.tier_migrate_ref(*map(_t, case))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))

    def test_pallas_interpret_case(self):
        tier, promote, demote, caps = migrate_case(3, 29, 3, 5, 5, 11)
        want = jkernel.tier_migrate_kernel(
            jnp.asarray(tier), jnp.asarray(promote), jnp.asarray(demote),
            jnp.asarray(caps), interpret=True)
        got = ref.tier_migrate_ref(_t(tier), _t(promote), _t(demote),
                                   _t(caps))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


class TestIntervalAccount:
    @pytest.mark.parametrize("machine", ["pmem-large", "dram-cxl-pmem"])
    @pytest.mark.parametrize("B,n", [(1, 7), (3, 130), (2, 1024)])
    def test_ref_matches_jax(self, B, n, machine):
        jmach, pmach, true, tier, up, down, oracle, k = _account_case(
            B, n, machine, n + B)
        want = jref.interval_account_ref(
            jmach, jnp.asarray(true), jnp.asarray(tier), jnp.asarray(up),
            jnp.asarray(down), jnp.asarray(oracle), k)
        got = ops.interval_account(pmach, _t(true), _t(tier), _t(up),
                                   _t(down), _t(oracle), k)
        for g, w in zip(got[:5], want[:5]):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **ACC)
        np.testing.assert_array_equal(got[5].numpy(), np.asarray(want[5]))

    def test_shared_row_lanes(self):
        """Trace mode hands one true/oracle row to every lane (stride 0)."""
        _, pmach, true, tier, up, down, oracle, k = _account_case(
            3, 130, "dram-cxl-pmem", 5)
        row, orow = _t(true[0]), _t(oracle[0])
        got = ops.interval_account(pmach, row[None].expand(3, 130), _t(tier),
                                   _t(up), _t(down),
                                   orow[None].expand(3, 130), k)
        want = ref.interval_account_ref(
            pmach, row[None].repeat(3, 1), _t(tier), _t(up), _t(down),
            orow[None].repeat(3, 1), k)
        for g, w in zip(got, want):
            assert torch.equal(g, w)

    def test_pallas_interpret_case(self):
        jmach, pmach, true, tier, up, down, oracle, k = _account_case(
            3, 130, "pmem-large", 1)
        want = jkernel.interval_account_kernel(
            jmach.lat_ns, jmach.bw_read, jmach.bw_write, jmach.mlp,
            jnp.asarray(true), jnp.asarray(tier), jnp.asarray(up),
            jnp.asarray(down), jnp.asarray(oracle), k, interpret=True)
        got = ref.interval_account_ref(pmach, _t(true), _t(tier), _t(up),
                                       _t(down), _t(oracle), k)
        for g, w in zip(got[:5], want[:5]):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **ACC)
        np.testing.assert_array_equal(got[5].numpy(), np.asarray(want[5]))


class TestEwmaUpdate:
    @pytest.mark.parametrize("B,n", [(1, 17), (3, 1000), (2, 129)])
    @pytest.mark.parametrize("lane_params", [False, True])
    def test_ref_matches_jax_bitwise(self, B, n, lane_params):
        """Against the reference as the JAX engine runs it: compiled."""
        s, l, c, kw = _ewma_case(B, n, lane_params, B + n)
        want = jax.jit(lambda *a: jref.ewma_score_update_ref(*a, **kw))(
            jnp.asarray(s), jnp.asarray(l), jnp.asarray(c))
        got = ops.ewma_score_update(
            _t(s), _t(l), _t(c),
            **{nm: (_t(v) if isinstance(v, np.ndarray) else v)
               for nm, v in kw.items()})
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))

    def test_pallas_interpret_case(self):
        """The interpret-mode Pallas kernel compiles its body with its own
        FMA placement, so it is only within an ulp of the reference the
        JAX engine runs on the CPU; the JAX package's own kernel test holds
        it to that reference within 1e-6, and so does this one."""
        s, l, c, kw = _ewma_case(3, 1000, True, 9)
        want = jkernel.ewma_update_kernel(
            jnp.asarray(s), jnp.asarray(l), jnp.asarray(c), interpret=True,
            **{nm: jnp.asarray(v) for nm, v in kw.items()})
        got = ops.ewma_score_update(_t(s), _t(l), _t(c),
                                    **{nm: _t(v) for nm, v in kw.items()})
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                       atol=1e-6)

    def test_fma_is_single_rounding(self):
        rng = np.random.default_rng(2)
        a, b, c = (rng.standard_normal(100000).astype(np.float32)
                   * np.float32(10.0) ** rng.integers(-8, 8, 100000)
                   for _ in range(3))
        got = ref.fma(_t(a), _t(b), _t(c)).numpy()
        exact = [float(np.float32(Fraction(float(x)) * Fraction(float(y))
                                  + Fraction(float(z))))
                 for x, y, z in zip(a[:2000], b[:2000], c[:2000])]
        np.testing.assert_array_equal(got[:2000], np.float32(exact))


def test_ops_refuse_other_devices():
    x = torch.zeros((1, 8), device="meta")
    with pytest.raises(ValueError):
        ops.topk_mask(x, 2)
