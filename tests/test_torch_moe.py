"""Port parity of the alternating-MoE family (llama4-scout:
repro_torch/models/moe.py, the MoE block, the moe entries of
models/model.py, launch/steps.py and launch/train.py).

``moe_apply`` at reduced llama4-scout's widths (d_model 64, 8 experts of
d_ff 64, capacity factor 1.25) on numpy-seeded inputs, with JAX's
weights carried across: k = 1 and 2, with and without the shared
expert, and a zero router (every probability 1/E: ties everywhere, so
``jax.lax.top_k``'s lower-index order sends every token to the same
experts, which overflow).  ``y`` within 1e-5 of its largest entry, the
aux loss within 1e-6 relative; the routing (``top_k``'s indices),
``expert_load`` and the dropped copies (T k less the kept) exact.
``_capacity`` equals JAX's.

The model, reduced llama4-scout in f32 (2 super-layers of a dense and an
MoE layer, windowed attention of 16, 4 query heads over 2 KV heads):

* the init tree's keys, shapes and dtypes equal JAX's at full width in
  bf16 (the router f32), and ``count_params`` is JAX's 59,450,168,320
  (4,460,487,680 for one super-layer); ``convert.model_params`` carries
  the f32 router of a bf16 tree;
* ``forward``/``prefill`` logits within 2e-5 of the largest and the aux
  loss (summed over super-layers) within 1e-6 relative; ``loss_fn``
  within 1e-6 relative and every gradient within 1e-5 of its leaf's
  largest entry, remat off and on;
* 20 greedy ``decode_step``s against JAX's into a cache of 16 slots (a
  ring buffer: the window), so the ring wraps: tokens equal, logits
  within 1e-5, the ``{"dense", "moe"}`` caches within 2e-6 of their
  largest entry (the second super-layer's K/V inherit the first MoE
  layer's last-ulp differences, XLA's expert products summing in
  another order than ``torch.bmm``: 1.13e-6 at worst, where a dense
  stack's stay within 1e-6);
* two ``make_train_step`` steps (grad_accum 1, remat off; grad_accum 2,
  remat on): loss and grad norm within 1e-5 relative, params within 1e-5
  of their largest entry, elements whose first gradient (the mean of the
  micro-batches', whose capacities differ from the whole batch's) is
  nonzero and below 1e-6 within 2 x the summed lr; up to 5 % of the
  elements are such (3.7 % at grad_accum 1: the weights of experts that
  few tokens reach), where a dense or mamba stack has under 0.1 %; both
  packages' ``train`` from one JAX step-0 checkpoint within 1e-5
  relative.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity as P
from repro.configs import registry as jregistry
from repro.launch import steps as jsteps
from repro.models import model as JM
from repro.models import moe as JMoE
from repro_torch.configs import registry
from repro_torch.launch import serve as S
from repro_torch.launch import steps
from repro_torch.models import model as M
from repro_torch.models import moe as MoE
from repro_torch.utils.pytree import flatten_with_path

ARCH = "llama4-scout"


def _moe_case(k, shared, zero_router, seed=0):
    """(jcfg, cfg, JAX's and the port's params of one MoE layer, x as
    both) at reduced llama4-scout's widths."""
    over = dict(experts_per_token=k, n_shared_experts=int(shared))
    jcfg, cfg = (dataclasses.replace(registry_.reduced(
        registry_.get_arch(ARCH)), **over)
        for registry_ in (jregistry, registry))
    jp = JMoE.moe_init(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    if zero_router:
        jp["router"]["w"] = jnp.zeros_like(jp["router"]["w"])
    params = {k_: (jax.tree_util.tree_map(lambda a: torch.from_numpy(
        np.array(a)), v)) for k_, v in jp.items()}
    x = np.random.default_rng(seed).standard_normal((2, 24, 64)).astype(
        np.float32)
    return jcfg, cfg, jp, params, x


@pytest.mark.parametrize("zero_router", [False, True])
@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("k", [1, 2])
def test_moe_apply_matches_jax(k, shared, zero_router):
    jcfg, cfg, jp, params, x = _moe_case(k, shared, zero_router)
    jy, jaux, jload = JMoE.moe_apply(jp, jnp.asarray(x), jcfg)
    y, aux, load = MoE.moe_apply(params, torch.from_numpy(x), cfg)
    P.close(y, jy, 1e-5)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)
    np.testing.assert_array_equal(load.numpy(), np.asarray(jload))
    # the routing: JAX's top_k of its own probabilities
    xf = x.reshape(-1, 64)
    jprobs = jax.nn.softmax(jnp.asarray(xf) @ jp["router"]["w"], axis=-1)
    _, jidx = jax.lax.top_k(jprobs, k)
    probs = torch.softmax(torch.from_numpy(xf) @ params["router"]["w"], -1)
    gates, idx = MoE._top_k(probs, k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    T, C = xf.shape[0], MoE._capacity(xf.shape[0], cfg)
    drops = T * k - int(load.sum())
    assert drops == T * k - int(np.asarray(jload).sum())
    if zero_router:   # ties: every token to experts 0..k-1, C kept each
        assert (idx.numpy() == np.arange(k)).all()
        np.testing.assert_array_equal(load.numpy()[:k], C)
        assert drops == T * k - k * C > 0
    else:
        assert bool((gates[:, :-1] >= gates[:, 1:]).all())


def test_capacity_matches_jax():
    for k in (1, 2):
        jcfg, cfg = (dataclasses.replace(r.reduced(r.get_arch(ARCH)),
                                         experts_per_token=k)
                     for r in (jregistry, registry))
        for tokens in (1, 2, 8, 23, 48, 64, 100, 8192):
            assert MoE._capacity(tokens, cfg) == JMoE._capacity(tokens, jcfg)
    full = registry.get_arch(ARCH)
    assert MoE._capacity(8192, full) == 640 and MoE._capacity(8, full) == 4


def test_init_tree_matches_jax_at_full_width():
    jcfg, cfg = jregistry.get_arch(ARCH), registry.get_arch(ARCH)
    want = P.tree_spec(jax.eval_shape(
        lambda: JM.init_params(jax.random.PRNGKey(0), jcfg)))
    got = P.port_spec(M._moe_alt_init(torch.Generator(), cfg,
                                      torch.bfloat16, "meta"))
    assert got == want
    assert got[("moe_layers", "moe", "router", "w")] == ((24, 5120, 16),
                                                         "float32")
    assert got[("dense_layers", "mlp", "wi", "w")] == ((24, 5120, 16384),
                                                       "bfloat16")
    assert cfg.n_params == JM.count_params(jcfg) == 59_450_168_320
    one = dataclasses.replace(cfg, n_layers=2)
    assert one.n_params == JM.count_params(
        dataclasses.replace(jcfg, n_layers=2)) == 4_460_487_680


def test_model_params_carries_the_f32_router_of_a_bf16_tree():
    jcfg, cfg, jp, params = P.setup(ARCH, "bfloat16")
    want = P.np_tree(jp)
    for path, t in flatten_with_path(params):
        w = want
        for k in path:
            w = w[k]
        assert t.dtype == (torch.float32 if "router" in path
                           else torch.bfloat16), path
        np.testing.assert_array_equal(t.float().numpy(),
                                      np.asarray(w, np.float32))


def test_forward_and_prefill_match_jax():
    jcfg, cfg, jp, params = P.setup(ARCH)
    jb, tb = P.batch(cfg, 2, 32)
    jlog, jaux = JM.forward(jp, jb, jcfg)
    logits, aux = M.forward(params, tb, cfg)
    P.close(logits, jlog, 2e-5)
    assert float(jaux) > 0.0
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)
    pre = steps.make_prefill_step(cfg)(params, tb)
    P.close(pre, jsteps.make_prefill_step(jcfg)(jp, jb), 2e-5)
    assert torch.equal(M.prefill(params, tb, cfg), pre)


@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_grads_match_jax(remat):
    jcfg, cfg, jp, params = P.setup(ARCH)
    jb, tb = P.batch(cfg, 2, 32)
    P.loss_and_grads(jcfg, cfg, jp, params, jb, tb, remat)


def test_decode_matches_jax_through_the_ring():
    jcfg, cfg, jp, params = P.setup(ARCH)
    cache = P.greedy_decode(jcfg, cfg, jp, params, 2, 24, 20, cache_tol=2e-6)
    assert cache.keys() == {"dense", "moe"}
    assert cache["moe"].k.shape == (2, 2, 2, 16, 16)


@pytest.mark.parametrize("grad_accum,remat", [(1, False), (2, True)])
def test_train_step_matches_jax(grad_accum, remat):
    jcfg, cfg, jp, params = P.setup(ARCH)
    P.train_steps(jcfg, cfg, jp, params, lambda i: P.batch(cfg, 2, 32, i),
                  grad_accum, remat, noisy_share=0.05)


def test_train_loop_from_a_shared_step0_checkpoint(tmp_path):
    P.train_loops(ARCH, tmp_path)


def test_serve_tiers_the_family():
    """``launch.serve`` decodes the family with one attention layer's KV
    pages tiered by ARMS, as it serves a dense model."""
    rep = S.serve(ARCH, 12, 2, page_size=4, quiet=True, device="cpu")
    assert rep.fast_mass.shape == (12,) and np.isfinite(rep.fast_mass).all()
    assert np.isfinite(rep.slowdown) and rep.promotions >= 1
