"""Port parity of the sharding rules (repro_torch/launch/sharding.py and
utils/act_sharding.py against repro/launch/sharding.py and
repro/utils/act_sharding.py).

For all ten archs at full width, on the production meshes (16, 16)
("data", "model") and (2, 16, 16) ("pod", "data", "model") as JAX
``AbstractMesh``es and the port's ``AbstractMesh``: the params' specs
(train and ``serve=True``), the decode caches' (decode_32k and, where
the arch takes it, long_500k) and the batches' (train_4k, prefill_32k)
equal JAX's ``PartitionSpec`` entries leaf for leaf, and each spec's
DTensor placements shard each named mesh dim on its tensor dim.  JAX's
three ``TestShardingRules`` cases run as port cases, and
``act_sharding``'s collapse rule is JAX's on the same entries and shapes.
"""
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding
from jax.sharding import PartitionSpec as P
from torch.distributed.tensor import Replicate, Shard

from repro.configs import registry as jregistry
from repro.configs.base import shape_applicable
from repro.launch import sharding as jsharding
from repro.launch import specs as jspecs
from repro.utils import act_sharding as jact
from repro_torch.configs import registry
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import sharding, specs
from repro_torch.utils import act_sharding
from repro_torch.utils.pytree import flatten_with_path

MESHES = {"pod1": ((16, 16), ("data", "model")),
          "pod2": ((2, 16, 16), ("pod", "data", "model"))}
ARCHS = sorted(registry.ARCHS)


def _meshes(name):
    shape, axes = MESHES[name]
    return AbstractMesh(shape, axes), mesh_lib.AbstractMesh(shape, axes)


def _jax_specs(tree) -> dict:
    """{path: PartitionSpec entries} of a tree of ``NamedSharding``s, the
    path in the port's strings (dict keys, field names, ``[i]``)."""
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, NamedSharding))[0]
    return {tuple(str(getattr(k, "key", getattr(k, "name", k)))
                  for k in path): tuple(s.spec) for path, s in flat}


def _port_specs(tree) -> dict:
    if isinstance(tree, sharding.Sharding):
        return {(): tree.spec}
    return {tuple(path): s.spec for path, s in flatten_with_path(tree)}


def _check_placements(tree, mesh) -> None:
    """Each spec's placements: ``Shard(d)`` on every mesh dim its entry
    at tensor dim d names, ``Replicate`` elsewhere."""
    names = mesh.mesh_dim_names
    items = [((), tree)] if isinstance(tree, sharding.Sharding) else \
        flatten_with_path(tree)
    for _, s in items:
        want = [Replicate()] * len(names)
        for d, e in enumerate(s.spec):
            for a in (() if e is None else e if isinstance(e, tuple)
                      else (e,)):
                want[names.index(a)] = Shard(d)
        assert list(s.placements) == want, s


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_jax(arch, mesh_name):
    jmesh, mesh = _meshes(mesh_name)
    jp = jspecs.param_specs(jregistry.get_arch(arch))
    p = specs.param_specs(registry.get_arch(arch))
    for serve in (False, True):
        want = _jax_specs(jsharding.param_shardings(jp, jmesh, serve=serve))
        got = sharding.param_shardings(p, mesh, serve=serve)
        assert _port_specs(got) == want, (arch, serve)
        _check_placements(got, mesh)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_and_batch_specs_match_jax(arch, mesh_name):
    jmesh, mesh = _meshes(mesh_name)
    jcfg, cfg = jregistry.get_arch(arch), registry.get_arch(arch)
    for shape_name in ("decode_32k", "long_500k"):
        shape = registry.get_shape(shape_name)
        if not shape_applicable(jcfg, jregistry.get_shape(shape_name))[0]:
            continue
        _, jcache, _ = jspecs.decode_specs(jcfg,
                                           jregistry.get_shape(shape_name))
        _, cache, _ = specs.decode_specs(cfg, shape)
        got = sharding.cache_sharding(mesh, cache)
        assert _port_specs(got) == _jax_specs(
            jsharding.cache_sharding(jmesh, jcache)), (arch, shape_name)
        _check_placements(got, mesh)
    for shape_name in ("train_4k", "prefill_32k"):
        jb = jspecs.batch_specs(jcfg, jregistry.get_shape(shape_name))
        b = specs.batch_specs(cfg, registry.get_shape(shape_name))
        got = sharding.batch_sharding(mesh, b)
        assert _port_specs(got) == _jax_specs(
            jsharding.batch_sharding(jmesh, jb)), (arch, shape_name)
        _check_placements(got, mesh)
    token, _, _ = specs.decode_specs(cfg, registry.get_shape("decode_32k"))
    jtoken, _, _ = jspecs.decode_specs(jcfg,
                                       jregistry.get_shape("decode_32k"))
    assert sharding.batch_sharding(mesh, token).spec == tuple(
        jsharding.batch_sharding(jmesh, jtoken).spec)


def _one():
    return mesh_lib.AbstractMesh((1, 1), ("data", "model"))


def _meta(*shape):
    return torch.empty(shape, device="meta")


def test_param_rules():
    """JAX's ``TestShardingRules.test_param_rules``."""
    tree = {"embed": {"table": _meta(1024, 64)},
            "layers": {"attn": {"wq": {"w": _meta(4, 64, 128)},
                                "wo": {"w": _meta(4, 128, 64)}}}}
    out = sharding.param_shardings(tree, _one())
    assert out["embed"]["table"].spec == tuple(P("model", "data"))
    assert out["layers"]["attn"]["wq"]["w"].spec == \
        tuple(P(None, "data", "model"))
    assert out["layers"]["attn"]["wo"]["w"].spec == \
        tuple(P(None, "model", "data"))  # row-parallel output proj


def test_serve_drops_fsdp_factor():
    """JAX's ``TestShardingRules.test_serve_drops_fsdp_factor``."""
    tree = {"mlp": {"wi": {"w": _meta(64, 128)}}}
    train = sharding.param_shardings(tree, _one())
    serve = sharding.param_shardings(tree, _one(), serve=True)
    assert train["mlp"]["wi"]["w"].spec == tuple(P("data", "model"))
    assert serve["mlp"]["wi"]["w"].spec == tuple(P(None, "model"))


def test_cache_never_shards_stack_dim():
    """JAX's ``TestShardingRules.test_cache_never_shards_stack_dim``."""
    out = sharding.cache_sharding(_one(), _meta(32, 16, 8, 256, 128))
    assert out.spec[0] is None   # layer-stack dim
    rep = sharding.replicated(_one())
    assert rep.spec == tuple(P()) and rep.placements == (Replicate(),) * 2


CONSTRAIN_CASES = [
    (("data", None, "model"), (32, 3, 64)),
    (("data", None, "model"), (8, 3, 64)),        # 8 < 16: collapses
    ((("pod", "data"), None), (64, 7)),           # pod absent on pod1
    ((None, "model"), (5, 24)),                   # 24 % 16: collapses
    ((("data", "model"), None), (512, 2)),
    (("model",), (16, 4, 4)),                     # shorter than the rank
]


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("entries,shape", CONSTRAIN_CASES)
def test_constrain_collapse_matches_jax(entries, shape, mesh_name):
    jmesh, mesh = _meshes(mesh_name)
    with jact.use_mesh(jmesh):
        jaxpr = jax.make_jaxpr(lambda x: jact.constrain(x, entries))(
            jnp.zeros(shape))
    spec = tuple(jaxpr.eqns[0].params["sharding"].spec)
    got = act_sharding.collapse(mesh, entries, shape)
    assert got + (None,) * (len(spec) - len(got)) == spec
    assert act_sharding.constrain("x", entries) == "x"   # outside a mesh
