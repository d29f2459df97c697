"""Port parity of paged decode attention (repro_torch/kernels/
paged_attention) and of the serving layer's folded view of it.

* The port's op on the CPU (its plain version) against the JAX package's
  ``paged_attention_ref`` and the Pallas ``paged_attention_kernel`` in
  interpret mode, at the shapes of tests/test_kernels.py: f32 output
  within 1e-5 absolute (bf16 within the JAX test's 2e-2).
* ``paged_kv.paged_attention_step``, which folds the batch into the head
  axis over the fused fast/slow pools: its ``(out, mass)`` against the
  JAX layer's at several ``pos`` (0, mid-page, page ends), within 1e-5.

The CUDA kernels are held to the plain version on the card by
tests/test_torch_kernels_cuda.py.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cases import PAGED_EDGE_SHAPES, PAGED_SHAPES, paged_case
from _torch_cases import t as _t
from repro.kernels.paged_attention.kernel import paged_attention_kernel
from repro.kernels.paged_attention.ref import paged_attention_ref
from repro.tiering import paged_kv as JPK
from repro_torch import convert
from repro_torch.kernels.paged_attention import ops
from repro_torch.tiering import paged_kv as PK

F32 = dict(rtol=0, atol=1e-5)


@pytest.mark.parametrize("shape", PAGED_SHAPES)
def test_paged_attention_matches_jax(shape):
    case = paged_case(*shape, seed=sum(shape))
    jargs = [jnp.asarray(a) for a in case]
    want = np.asarray(paged_attention_ref(*jargs))
    interp = np.asarray(paged_attention_kernel(*jargs, interpret=True))
    out, mass = ops.paged_attention(*map(_t, case), page_mass=True)
    assert out.dtype == torch.float32 and mass.shape == case[3].shape
    np.testing.assert_allclose(out.numpy(), want, **F32)
    np.testing.assert_allclose(out.numpy(), interp, **F32)
    # every sequence's probabilities sum to 1 per head
    np.testing.assert_allclose(mass.sum(1).numpy(), shape[1], rtol=1e-6)
    assert torch.equal(ops.paged_attention(*map(_t, case)), out)


@pytest.mark.parametrize("shape,lens", [(s, None) for s in PAGED_EDGE_SHAPES]
                         + [((3, 16, 4, 32, 16, 9), [0, 17, 144])])
def test_paged_attention_edges_match_jax(shape, lens):
    """The shapes the CUDA kernel's edge cases run at, and sequences of
    different lengths (0: every token masked, the mean of V)."""
    case = paged_case(*shape, seed=sum(shape), lens=lens)
    want = np.asarray(paged_attention_ref(*map(jnp.asarray, case)))
    out, mass = ops.paged_attention(*map(_t, case), page_mass=True)
    np.testing.assert_allclose(out.numpy(), want, **F32)
    np.testing.assert_allclose(mass.sum(1).numpy(), shape[1], rtol=1e-6)
    for b, n in enumerate(case[4]):
        if n > 0:
            assert not mass[b, -(-int(n) // shape[4]):].any()


def test_paged_attention_clamps_out_of_range_entries():
    """Table entries past the pool are clamped into it, as the JAX
    reference's gather clamps them."""
    case = list(paged_case(2, 8, 4, 128, 16, 4, seed=3))
    case[3][0, 1] = case[1].shape[0] + 5
    case[3][1, 2] = case[1].shape[0]
    want = np.asarray(paged_attention_ref(*map(jnp.asarray, case)))
    np.testing.assert_allclose(ops.paged_attention(*map(_t, case)).numpy(),
                               want, **F32)


@pytest.mark.parametrize("shape", PAGED_SHAPES[:2])
def test_paged_attention_bf16_matches_jax(shape):
    case = paged_case(*shape, seed=sum(shape))
    bf = lambda a: jnp.asarray(a).astype(jnp.bfloat16) \
        if a.dtype == np.float32 else jnp.asarray(a)
    want = np.asarray(paged_attention_ref(*map(bf, case)), np.float32)
    tb = lambda a: _t(a).to(torch.bfloat16) if a.dtype == np.float32 \
        else _t(a)
    out = ops.paged_attention(*map(tb, case))
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), want, rtol=2e-2,
                               atol=2e-2)


CFG = dict(page_size=8, n_pages=6, fast_pages=2, policy_every=4)
B, KV, H, DH = 2, 2, 4, 16


def _paged_kv_pair(seed):
    """The same pools and residency on both sides: random K/V in every
    slot and pages 1 and 4 resident in fast slots 1 and 0."""
    jcfg = JPK.PagedKVConfig(**CFG)
    kv = JPK.init_paged_kv(jcfg, B, KV, DH, dtype=jnp.float32)
    rng = np.random.default_rng(seed)
    draw = lambda x: jnp.asarray(rng.standard_normal(x.shape), jnp.float32)
    in_fast = np.zeros(CFG["n_pages"], bool)
    in_fast[[1, 4]] = True
    slot = np.arange(CFG["n_pages"], dtype=np.int32)
    slot[[1, 4]] = [1, 0]
    pool = kv.pool.replace(in_fast=jnp.asarray(in_fast),
                           slot=jnp.asarray(slot))
    kv = dataclasses.replace(kv, k_fast=draw(kv.k_fast),
                             v_fast=draw(kv.v_fast),
                             k_slow=draw(kv.k_slow),
                             v_slow=draw(kv.v_slow), pool=pool)
    return jcfg, kv, convert.paged_kv(jax.tree_util.tree_map(np.asarray, kv),
                                      device="cpu")


@pytest.mark.parametrize("pos", [0, 3, 7, 8, 20, 47])
def test_folded_serve_layer_matches_jax(pos):
    jcfg, jkv, kv = _paged_kv_pair(pos)
    q = np.random.default_rng(100 + pos).standard_normal(
        (B, H, DH)).astype(np.float32)
    want_out, want_mass = JPK.paged_attention_step(jkv, jnp.asarray(q),
                                                   jnp.int32(pos), jcfg)
    out, mass = PK.paged_attention_step(kv, _t(q), pos,
                                        PK.PagedKVConfig(**CFG))
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), **F32)
    np.testing.assert_allclose(mass.numpy(), np.asarray(want_mass), **F32)
    # pages past pos carry exactly no mass
    assert not mass[pos // CFG["page_size"] + 1:].any()
