"""Port parity of the fused score update (repro_torch/kernels/score_update).

The same numpy-seeded rows go through the JAX package's Pallas kernel in
interpret mode, its jitted reference and the port's op on the CPU (the
plain version):

  * ``s'`` and ``l'`` equal the JAX kernel's bit for bit;
  * ``score`` equals the jitted ``score_update_ref`` (parameters as f32
    arrays, as the kernel takes them) bit for bit and is
    within 2 ulp of the JAX kernel's.  The interpret-mode kernel's score
    takes its ``s'`` from a second fusion that rounds ``(1-a)*s`` into
    the product with ``a*c`` instead (when the fold has more than one
    (8, 512) tile), so no fixed form reproduces it at every n
    (ROADMAP queue 3).

The CUDA kernel is held to the plain version on the card by
tests/test_torch_kernels_cuda.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cases import t as _t
from repro.kernels.score_update.kernel import score_update_kernel
from repro.kernels.score_update.ref import score_update_ref
from repro_torch.kernels.score_update import kernel, ops

PARAMS = [dict(alpha_s=0.7, alpha_l=0.1, w_s=0.2, w_l=0.8),
          dict(alpha_s=0.0, alpha_l=1.0, w_s=0.5, w_l=0.5),
          dict(alpha_s=1.0, alpha_l=0.0, w_s=0.9, w_l=0.1),
          dict(alpha_s=0.123, alpha_l=0.777, w_s=0.333, w_l=0.667)]
SCORE_ULP = 2


def _case(n, seed):
    """Rows over five decades and counts with zeros and bursts."""
    rng = np.random.default_rng(seed)
    decades = lambda: rng.choice([1e-3, 1.0, 1e2, 1e4], n).astype(np.float32)
    s = rng.random(n, dtype=np.float32) * decades()
    l = rng.random(n, dtype=np.float32) * decades()
    c = (rng.poisson(3, n) * rng.choice([0, 1, 1000], n)).astype(np.float32)
    return s, l, c


def _ulp_apart(a, b):
    """Largest distance in ulp between f32 arrays of one sign."""
    a, b = (np.asarray(x, np.float32).view(np.int32).astype(np.int64)
            for x in (a, b))
    return int(np.abs(a - b).max())


@pytest.mark.parametrize("n", [17, 4096, 10_000, 70_000])
@pytest.mark.parametrize("p", range(len(PARAMS)))
def test_op_matches_jax_kernel_and_reference(n, p):
    kw = PARAMS[p]
    s, l, c = _case(n, n + p)
    js, jl, jc = (jnp.asarray(x) for x in (s, l, c))
    want = score_update_kernel(js, jl, jc, interpret=True, **kw)
    # the parameters as f32 arrays, as the kernel takes them: a Python
    # float's ``1 - alpha`` would be computed in f64 before the cast
    jitted = jax.jit(lambda *a, **p: score_update_ref(*a, **p))(
        js, jl, jc, **{nm: jnp.float32(v) for nm, v in kw.items()})
    got = ops.score_update(_t(s), _t(l), _t(c), **kw)
    assert all(g.dtype == torch.float32 and g.shape == (n,) for g in got)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(jitted[2]))
    assert _ulp_apart(got[2].numpy(), want[2]) <= SCORE_ULP


def test_params_as_tensors_match_floats():
    s, l, c = _case(1000, 3)
    kw = PARAMS[3]
    want = ops.score_update(_t(s), _t(l), _t(c), **kw)
    got = ops.score_update(_t(s), _t(l), _t(c),
                           **{nm: torch.tensor(v) for nm, v in kw.items()})
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_other_devices_raise():
    meta = torch.empty(8, device="meta")
    with pytest.raises(ValueError):
        ops.score_update(meta, meta, meta, **PARAMS[0])
    cpu = torch.zeros(8)
    with pytest.raises(ValueError):   # the kernel takes CUDA tensors only
        kernel.score_update(cpu, cpu, cpu, torch.zeros(4))
