"""Port parity of the dry run's input stand-ins (repro_torch/launch/specs.py
against repro/launch/specs.py).

For every (arch x shape) cell that the JAX package marks applicable, the
port's ``input_specs`` (``meta`` tensors) have the shapes and dtypes of
JAX's ``ShapeDtypeStruct``s: the batch (a vlm's patch and an enc-dec
model's audio stubs among them), or the decode token, position and
cache, the cache compared leaf by leaf at ``convert.decode_cache``'s
layout (dict keys and the ``KVCache``/``MLACache``/``MambaCache`` field
names).  Each arch's params and AdamW state are compared the same way.
"""
import jax
import pytest
import torch

from repro.configs import registry as jregistry
from repro.launch import specs as jspecs
from repro.optim import adamw as jadamw
from repro_torch.configs import registry
from repro_torch.launch import specs
from repro_torch.optim import adamw
from repro_torch.utils.pytree import flatten_with_path

CELLS = [(a.name, s.name) for a, s, ok, _ in jregistry.all_cells() if ok]


def _jax(tree) -> dict:
    """{path: (shape, dtype name)}, the path in the port's strings."""
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {tuple(str(getattr(k, "key", getattr(k, "name", k)))
                  for k in path): (tuple(x.shape), str(x.dtype))
            for path, x in flat}


def _port(tree) -> dict:
    out = {}
    for path, t in flatten_with_path(tree):
        assert t.device.type == "meta", path
        out[tuple(path)] = (tuple(t.shape),
                            str(t.dtype).replace("torch.", ""))
    return out


def test_every_applicable_cell_is_compared():
    assert len(CELLS) == sum(
        ok for _, _, ok, _ in registry.all_cells()) >= 30


@pytest.mark.parametrize("arch,shape", CELLS)
def test_input_specs_match_jax(arch, shape):
    want = jspecs.input_specs(jregistry.get_arch(arch),
                              jregistry.get_shape(shape))
    got = specs.input_specs(registry.get_arch(arch),
                            registry.get_shape(shape))
    assert sorted(got) == sorted(want)
    assert _port(got) == _jax(want)


@pytest.mark.parametrize("arch", sorted(registry.ARCHS))
def test_param_and_opt_specs_match_jax(arch):
    jcfg, cfg = jregistry.get_arch(arch), registry.get_arch(arch)
    jp, p = jspecs.param_specs(jcfg), specs.param_specs(cfg)
    assert _port(p) == _jax(jp)
    jo = jspecs.opt_specs(jcfg, jadamw.AdamWConfig(), jp)
    o = specs.opt_specs(cfg, adamw.AdamWConfig(), p)
    assert _port(o) == _jax(jo)
    assert o.step.dtype == torch.int32 and o.step.shape == ()
