"""Port parity of the dense decode stack (repro_torch/configs, models).

Reduced granite-8b in f32 with the JAX package's weights from
``PRNGKey(0)`` carried across (``convert.model_params``); each check
holds the port to the JAX function on the same inputs:

* the configs: every architecture resolves and its parameter count
  equals the JAX package's, every family (enc-dec and MLA included)
  initialises at its reduced size;
* ``rmsnorm``, ``apply_rope`` (several positions) and ``swiglu`` within
  1e-6 of the JAX functions run op by op;
* 16 ``decode_step``s: logits within 1e-5, the stacked cache within 1e-6
  of its largest entry (the second layer's K/V inherit the first layer's
  last-ulp differences from XLA's dot order and fusions), greedy tokens
  equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.models import layers as JL
from repro.models import model as JM
from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.utils.pytree import leaves

TOL = dict(rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", sorted(jregistry.ARCHS))
def test_configs_match_jax(name):
    cfg, jcfg = registry.get_arch(name), jregistry.get_arch(name)
    assert repr(cfg) == repr(jcfg)
    assert repr(registry.reduced(cfg)) == repr(jregistry.reduced(jcfg))
    assert cfg.n_params == jcfg.n_params
    small = registry.reduced(cfg)
    assert M.count_params(small) == sum(
        t.numel() for t in leaves(M.init_params(small, device="cpu")))


def test_aliases_resolve():
    for alias, name in jregistry.ALIASES.items():
        assert registry.get_arch(alias).name == name
    with pytest.raises(KeyError):
        registry.get_arch("no-such-arch")


def test_rmsnorm_and_swiglu_match_jax():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((4, 3, 64)) * 0.7).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    want = JL.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x))
    got = L.rmsnorm({"scale": torch.from_numpy(scale)}, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    wi = (rng.standard_normal((64, 256)) / 8).astype(np.float32)
    wo = (rng.standard_normal((128, 64)) / 11).astype(np.float32)
    jp = {"wi": {"w": jnp.asarray(wi)}, "wo": {"w": jnp.asarray(wo)}}
    tp = {"wi": {"w": torch.from_numpy(wi)}, "wo": {"w": torch.from_numpy(wo)}}
    np.testing.assert_allclose(L.swiglu(tp, torch.from_numpy(x)).numpy(),
                               np.asarray(JL.swiglu(jp, jnp.asarray(x))),
                               **TOL)


@pytest.mark.parametrize("pct", [1.0, 0.25])
@pytest.mark.parametrize("pos", [0, 1, 5, 15, 100, 511])
def test_apply_rope_matches_jax(pos, pct):
    rng = np.random.default_rng(pos)
    x = (rng.standard_normal((2, 3, 4, 16)) * 2).astype(np.float32)
    p = (pos + np.arange(3, dtype=np.int32))[None].repeat(2, 0)
    want = JL.apply_rope(jnp.asarray(x), jnp.asarray(p), 1e4, pct)
    got = L.apply_rope(torch.from_numpy(x), torch.from_numpy(p), 1e4, pct)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_decode_steps_match_jax():
    jcfg = jregistry.reduced(jregistry.get_arch("granite-8b"))
    cfg = registry.reduced(registry.get_arch("granite-8b"))
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    params = convert.model_params(jax.tree_util.tree_map(np.asarray, jp),
                                  cfg, device="cpu")
    jcache, cache = JM.init_cache(jcfg, 2, 32), M.init_cache(cfg, 2, 32,
                                                             device="cpu")
    jtok = jnp.asarray([[3], [7]], jnp.int32)
    tok = torch.tensor([[3], [7]], dtype=torch.int32)
    for t in range(16):
        jlog, jcache = JM.decode_step(jp, jtok, jcache, jnp.int32(t), jcfg)
        logits, cache = M.decode_step(params, tok, cache, t, cfg)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlog),
                                   rtol=0, atol=1e-5, err_msg=f"t={t}")
        for got, want in ((cache.k, jcache.k), (cache.v, jcache.v)):
            want = np.asarray(want)
            np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                       atol=1e-6 * np.abs(want).max())
        jtok = jnp.argmax(jlog[:, -1:], axis=-1).astype(jnp.int32)
        tok = logits[:, -1:].argmax(dim=-1).to(torch.int32)
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))


def test_params_shapes_and_init():
    cfg = registry.reduced(registry.get_arch("granite-8b"))
    jp = JM.init_params(jax.random.PRNGKey(0),
                        jregistry.reduced(jregistry.get_arch("granite-8b")))
    p = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    shapes = lambda t: {k: shapes(v) for k, v in t.items()} \
        if isinstance(t, dict) else tuple(t.shape)
    assert shapes(p) == jax.tree_util.tree_map(lambda a: tuple(a.shape), jp,
                                               is_leaf=lambda a: hasattr(
                                                   a, "shape"))
    # the same seed gives the same weights
    p2 = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert torch.equal(p["layers"]["attn"]["wq"]["w"],
                       p2["layers"]["attn"]["wq"]["w"])
    if not torch.cuda.is_available():   # the default device is the card
        with pytest.raises(RuntimeError, match="CUDA"):
            M.init_params(cfg)
