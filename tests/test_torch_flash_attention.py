"""Port parity of flash attention (repro_torch/kernels/flash_attention).

On the CPU the port's op is its plain version (``ref.py``) and its
gradient is autograd through it.  Each check holds it to the JAX
package on the same numpy inputs:

* against JAX ``flash_attention_ref`` and the Pallas
  ``flash_attention_kernel`` (interpret mode) at the shapes of
  ``tests/test_kernels.py``: causal and not, GQA rep 1/2/4, dh 64 and
  128, one windowed case; f32 within 2e-5, bf16 within 2e-2;
* against ``flash_attention_ref`` at the card tests' shapes
  (``FLASH_SHAPES``: odd S such as 40, dh 16, windows), f32 within 2e-5;
* gradients: ``torch.autograd.grad`` of the port's op against
  ``jax.vjp`` of ``flash_attention_ref`` under a random cotangent, dq/dk/
  dv within 1e-5 of each tensor's largest entry (f32).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cases import FLASH_SHAPES, flash_case
from repro.kernels.flash_attention.kernel import flash_attention_kernel
from repro.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.flash_attention import ops

TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _both(arrays, dtype):
    """The same values as JAX arrays and torch tensors of ``dtype``."""
    j = [jnp.asarray(a).astype(JDT[dtype]) for a in arrays]
    t = [torch.from_numpy(a).to(TDT[dtype]) for a in arrays]
    return j, t


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor)
                      else x.astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,S,H,KV,dh,bq,bk",
                         [(2, 128, 4, 2, 64, 64, 64),
                          (1, 256, 8, 8, 128, 128, 128),
                          (1, 64, 4, 1, 128, 32, 32)])
def test_op_matches_jax_ref_and_pallas(B, S, H, KV, dh, bq, bk, causal,
                                       dtype):
    q, k, v, _ = flash_case(B, S, H, KV, dh, S + H)
    (jq, jk, jv), (tq, tk, tv) = _both((q, k, v), dtype)
    got = ops.flash_attention(tq, tk, tv, causal=causal)
    assert got.dtype == TDT[dtype] and got.shape == (B, S, H, dh)
    want = flash_attention_ref(jq, jk, jv, causal=causal)
    np.testing.assert_allclose(_f32(got), _f32(want), **TOL[dtype])
    pallas = flash_attention_kernel(jq, jk, jv, causal=causal, bq=bq, bk=bk,
                                    interpret=True)
    np.testing.assert_allclose(_f32(got), _f32(pallas), **TOL[dtype])


def test_windowed_matches_jax_ref_and_pallas():
    q, k, v, _ = flash_case(1, 128, 4, 2, 64, 0)
    (jq, jk, jv), (tq, tk, tv) = _both((q, k, v), "float32")
    got = ops.flash_attention(tq, tk, tv, causal=True, window=32).numpy()
    for want in (flash_attention_ref(jq, jk, jv, causal=True, window=32),
                 flash_attention_kernel(jq, jk, jv, causal=True, window=32,
                                        bq=32, bk=32, interpret=True)):
        np.testing.assert_allclose(got, np.asarray(want), **TOL["float32"])


@pytest.mark.parametrize("shape", FLASH_SHAPES)
def test_odd_shapes_match_jax_ref(shape):
    B, S, H, KV, dh, causal, window = shape
    q, k, v, _ = flash_case(B, S, H, KV, dh, sum(shape))
    (jq, jk, jv), (tq, tk, tv) = _both((q, k, v), "float32")
    got = ops.flash_attention(tq, tk, tv, causal=causal, window=window)
    want = flash_attention_ref(jq, jk, jv, causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               **TOL["float32"])


@pytest.mark.parametrize("shape", FLASH_SHAPES)
def test_gradients_match_jax(shape):
    B, S, H, KV, dh, causal, window = shape
    q, k, v, do = flash_case(B, S, H, KV, dh, sum(shape) + 1)
    (jq, jk, jv, jdo), (tq, tk, tv, tdo) = _both((q, k, v, do), "float32")
    ref = lambda a, b, c: flash_attention_ref(a, b, c, causal=causal,
                                              window=window)
    want = jax.jit(lambda a, b, c, d: jax.vjp(ref, a, b, c)[1](d))(
        jq, jk, jv, jdo)
    leaves = [x.requires_grad_() for x in (tq, tk, tv)]
    got = torch.autograd.grad(
        ops.flash_attention(*leaves, causal=causal, window=window), leaves,
        tdo)
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-5 * max(np.abs(w).max(), 1e-30))


class _OnAnotherDevice:
    """Stands for a tensor on a device the op does not run on."""
    device = torch.device("xpu")


def test_op_rejects_other_devices():
    """A device other than cuda, meta (the dry run's shapes: the custom
    op's fake output) or cpu raises."""
    x = torch.zeros((1, 4, 2, 16), device="meta")
    out = ops.flash_attention(x, x, x)
    assert out.device.type == "meta" and tuple(out.shape) == (1, 4, 2, 16)
    other = _OnAnotherDevice()
    with pytest.raises(ValueError, match="cuda, meta or cpu"):
        ops.flash_attention(other, other, other)
