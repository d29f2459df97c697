"""Port parity of ``repro_torch/ft/compression.py`` against
``repro/ft/compression.py``.

On a tree of gradient-like leaves made with numpy (two shapes and
scales, a zero leaf) and on one train step's gradients of reduced
deepseek-v2-236b (f32, JAX's weights carried across):

* ``compress_bf16`` bit for bit JAX's cast (round to nearest even) and
  ``decompress_bf16`` its exact widening;
* ``compress_int8``: ``q``, the scale and the error feedback bit for bit
  JAX's op-by-op result (``torch.round`` rounds half to even, as
  ``jnp.round``; values on the .5 boundary are in the case), also over
  several steps with the feedback carried; against JAX under ``jit``,
  ``q`` and the scale bit for bit and the feedback within half an ulp of
  ``max |g'|`` (XLA fuses ``g' - q s`` into one multiply-add);
  ``decompress_int8`` bit for bit; ``init_error_feedback`` f32 zeros of
  each leaf's shape.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity as P
from repro.ft import compression as JC
from repro_torch.ft import compression as C
from repro_torch.launch import steps
from repro_torch.utils.pytree import flatten_with_path


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    a = (rng.standard_normal((33, 17)) * 1e-3).astype(np.float32)
    b = (rng.standard_normal((64,)) * 3).astype(np.float32)
    b[:5] = np.float32(127.0 * 3.5) / 127 * np.array([0.5, 1.5, 2.5, -2.5,
                                                      127.0])
    return {"a": a, "nested": {"b": b, "z": np.zeros((4, 3), np.float32)}}


def _port(tree):
    return jax.tree_util.tree_map(torch.from_numpy, tree)


def _equal(got, want):
    """Every leaf bit for bit (dtype and shape too)."""
    want = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    flat = {tuple(jax.tree_util.DictKey(k) for k in p): t
            for p, t in flatten_with_path(got)}
    assert flat.keys() == want.keys()
    for p, w in want.items():
        w = np.asarray(w)
        g = flat[p]
        if w.dtype.name == "bfloat16":
            assert g.dtype == torch.bfloat16
            g, w = g.float().numpy(), w.astype(np.float32)
        else:
            g = g.numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, p
        np.testing.assert_array_equal(g, w, err_msg=str(p))


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return tree.detach().numpy()


def _grad_tree():
    """One train step's gradients of reduced deepseek-v2-236b."""
    _, cfg, _, params = P.setup("deepseek-v2-236b")
    _, tb = P.batch(cfg, 2, 16)
    return _np(steps.make_loss_and_grads(cfg, remat=False)(params, tb)[1])


@pytest.mark.parametrize("which", ["numpy", "grads"])
def test_bf16_round_trip_is_jax_bits(which):
    tree = _tree() if which == "numpy" else _grad_tree()
    packed = C.compress_bf16(_port(tree))
    want = JC.compress_bf16(jax.tree_util.tree_map(jnp.asarray, tree))
    _equal(packed, want)
    _equal(C.decompress_bf16(packed), JC.decompress_bf16(want))


@pytest.mark.parametrize("which", ["numpy", "grads"])
def test_int8_with_error_feedback_is_jax_bits(which):
    tree = _tree() if which == "numpy" else _grad_tree()
    jt = jax.tree_util.tree_map(jnp.asarray, tree)
    ef, jef = C.init_error_feedback(_port(tree)), JC.init_error_feedback(jt)
    _equal(ef, jef)
    for step in range(3):
        g = jax.tree_util.tree_map(lambda x: x * (1.0 + step), tree)
        q, s, ef = C.compress_int8(_port(g), ef)
        jq, js, jef = JC.compress_int8(
            jax.tree_util.tree_map(jnp.asarray, g), jef)
        _equal(q, jq)
        _equal(s, js)
        _equal(ef, jef)
        _equal(C.decompress_int8(q, s), JC.decompress_int8(jq, js))


def test_int8_against_jit():
    tree = _tree(1)
    ef = jax.tree_util.tree_map(lambda x: (np.random.default_rng(2)
                                           .standard_normal(x.shape) * 1e-5)
                                .astype(np.float32), tree)
    q, s, e = C.compress_int8(_port(tree), _port(ef))
    jq, js, je = jax.jit(JC.compress_int8)(
        *(jax.tree_util.tree_map(jnp.asarray, t) for t in (tree, ef)))
    _equal(q, jq)
    _equal(s, js)
    for (path, got), g, f, want in zip(
            flatten_with_path(e), jax.tree_util.tree_leaves(tree),
            jax.tree_util.tree_leaves(ef), jax.tree_util.tree_leaves(je)):
        top = float(np.abs(g + f).max())
        half_ulp = np.spacing(np.float32(max(top, 1e-30))) / 2
        assert float(np.abs(got.numpy() - np.asarray(want)).max()) \
            <= half_ulp, path
