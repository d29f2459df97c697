"""Port parity of the Mamba2 SSD chunked scan (repro_torch/kernels/mamba_scan).

On the CPU the port's op is its plain version (``ref.py``) and its
gradient is autograd through it.  Each check holds it to the JAX
package on the same numpy inputs (``_torch_cases.mamba_case``: the
distributions of ``tests/test_kernels.py``), at the JAX test's shapes and
reduced mamba2-370m's (``MAMBA_SHAPES``):

* ``ssd_chunked`` against JAX's ``ssd_chunked``, with and without an
  initial state, and the op against the Pallas ``mamba_scan_kernel`` in
  interpret mode (f32, and bf16 x): the final state within 1e-4 and y
  within ``y_tol`` = 2e-5 + 4 ulp(max |cs|) (relative and absolute) in
  f32, 2e-2 with bf16 x (the tolerances of ``tests/test_kernels.py``,
  widened by the cumsum's rounding).  The chunk cumsums cs of dt * A
  reach |cs| = 70 at Q = 64 here; torch and XLA round them differently
  (7.6e-6 apart, one ulp; the port's is the nearer to an f64 cumsum),
  and ``exp`` turns that absolute error in a decay exponent into a
  relative error of every decay.  JAX's own kernel-vs-reference test
  shares XLA's cumsum and needs only 2e-5;
* gradients: ``torch.autograd.grad`` of the port's plain version against
  ``jax.vjp`` of ``ssd_chunked`` under seeded cotangents of y and of the
  final state, dx/ddt/dA/dBm/dCm each within 1e-4 of its largest entry
  (f32: the sums over heads, chunks and positions run in another order,
  dA over all B x S of them).  This pins the math the CUDA backward
  reproduces on the card (``tests/test_torch_kernels_cuda.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cases import MAMBA_SHAPES, mamba_case
from repro.kernels.mamba_scan.kernel import mamba_scan_kernel
from repro.models.mamba2 import ssd_chunked as jssd_chunked
from repro_torch.kernels.mamba_scan import ops, ref
from repro_torch.models import mamba2 as M


def _case(shape, seed_extra=0):
    B, S, H, P, N, Q = shape
    return mamba_case(B, S, H, P, N, sum(shape) + seed_extra), Q


def y_tol(dt, A, Q):
    """2e-5 plus 4 ulp of the largest chunk cumsum of dt * A (f32)."""
    B, S, H = dt.shape
    cs = np.cumsum((dt * A).reshape(B, S // Q, Q, H).astype(np.float64),
                   axis=2)
    return 2e-5 + 4 * float(np.spacing(np.float32(np.abs(cs).max())))


def test_cpu_cumsum_rounds_once():
    """PyTorch's CPU ``cumsum`` of f32 sums in f64 and rounds each result
    once (not a serial f32 sum); the CUDA kernel sums the chunk cumsum
    the same way, so its decays equal the plain version's on the CPU."""
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (4096, 64)).astype(np.float32) * 5)
    got = torch.cumsum(x, dim=-1)
    assert torch.equal(got, torch.cumsum(x.double(), dim=-1).float())
    serial = x.clone()
    for q in range(1, 64):
        serial[:, q] = serial[:, q - 1] + x[:, q]
    assert not torch.equal(got, serial)


def test_model_reexports_the_plain_version():
    assert M.ssd_chunked is ref.ssd_chunked and M._segsum is ref.segsum


@pytest.mark.parametrize("init", [False, True])
@pytest.mark.parametrize("shape", MAMBA_SHAPES)
def test_ssd_chunked_matches_jax(shape, init):
    (x, dt, A, Bm, Cm, _, h0), Q = _case(shape)
    kw = dict(init_state=0.5 * h0) if init else {}
    jy, jh = jssd_chunked(*(jnp.asarray(a) for a in (x, dt, A, Bm, Cm)), Q,
                          **{k: jnp.asarray(v) for k, v in kw.items()})
    y, h = ref.ssd_chunked(*(torch.from_numpy(a) for a in (x, dt, A, Bm,
                                                           Cm)), Q,
                           **{k: torch.from_numpy(v) for k, v in kw.items()})
    tol = y_tol(dt, A, Q)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=tol,
                               atol=tol)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", MAMBA_SHAPES)
def test_op_matches_pallas_interpret(shape, dtype):
    (x, dt, A, Bm, Cm, _, _), Q = _case(shape, 1)
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    jx = jnp.asarray(x).astype(jdt)
    jy, jh = mamba_scan_kernel(jx, *(jnp.asarray(a) for a in (dt, A, Bm,
                                                               Cm)),
                               chunk=Q, interpret=True)
    tx = torch.from_numpy(x).to(tdt)
    y, h = ops.mamba_scan(tx, *(torch.from_numpy(a) for a in (dt, A, Bm,
                                                               Cm)), chunk=Q)
    assert y.dtype == tdt and h.dtype == torch.float32
    tol = y_tol(dt, A, Q) if dtype == "float32" else 2e-2
    np.testing.assert_allclose(y.float().numpy(),
                               np.asarray(jy.astype(jnp.float32)), rtol=tol,
                               atol=tol)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("shape", MAMBA_SHAPES)
def test_gradients_match_jax(shape):
    (x, dt, A, Bm, Cm, dy, dh), Q = _case(shape, 2)
    ins = (x, dt, A, Bm, Cm)
    fn = lambda *a: jssd_chunked(*a, Q)
    want = jax.jit(lambda a, c: jax.vjp(fn, *a)[1](c))(
        tuple(jnp.asarray(v) for v in ins), (jnp.asarray(dy),
                                             jnp.asarray(dh)))
    leaves = [torch.from_numpy(v).requires_grad_() for v in ins]
    y, h = ops.mamba_scan(*leaves, chunk=Q)
    got = torch.autograd.grad((y, h), leaves, (torch.from_numpy(dy),
                                               torch.from_numpy(dh)))
    for nm, g, w in zip(("dx", "ddt", "dA", "dBm", "dCm"), got, want):
        w = np.asarray(w)
        assert g.shape == w.shape, nm
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max(), err_msg=nm)


def test_ssd_chunked_rejects_a_ragged_sequence():
    x, dt, A, Bm, Cm, _, _ = (torch.from_numpy(a)
                              for a in mamba_case(1, 12, 2, 4, 8, 0))
    with pytest.raises(ValueError, match="multiple"):
        ref.ssd_chunked(x, dt, A, Bm, Cm, 8)


class _OnAnotherDevice:
    """Stands for a tensor on a device the op does not run on."""
    device = torch.device("xpu")


def test_op_rejects_other_devices():
    """A device other than cuda, meta (the dry run's shapes: the custom
    op's fake outputs) or cpu raises."""
    x = torch.zeros((1, 8, 2, 4), device="meta")
    bc = torch.zeros((1, 8, 4), device="meta")
    y, h = ops.mamba_scan(x, x[..., 0], x[0, 0, :, 0], bc, bc, chunk=8)
    assert y.device.type == "meta" and tuple(y.shape) == (1, 8, 2, 4)
    assert h.dtype == torch.float32 and tuple(h.shape) == (1, 2, 4, 4)
    other = _OnAnotherDevice()
    with pytest.raises(ValueError, match="cuda, meta or cpu"):
        ops.mamba_scan(other, other, other, other, other, chunk=8)
