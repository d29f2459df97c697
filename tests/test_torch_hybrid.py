"""Port parity of the hybrid family (zamba2-1.2b: the hybrid entries of
repro_torch/models/model.py, ``dense_block_decode`` and ``gqa_decode``
of the shared block, launch/steps.py and launch/train.py).

Reduced zamba2-1.2b in f32 (5 layers: 2 groups of ``attn_every`` = 2
mamba layers, each followed by the ONE shared dense block, and a tail of
1; d_model 64, 4 heads of 16, N 16, chunk 64 over 32 tokens, so the scan
pads), with the JAX package's weights from ``PRNGKey(0)`` carried across
(``convert.model_params``); on the CPU the scan and the attention are the
ops' plain versions.  Each check holds the port to the JAX function on
the same inputs:

* the init tree's keys, shapes and dtypes equal JAX's at full width in
  bf16 (``mamba_groups`` ``[6, 6, ...]``, ``mamba_tail`` ``[2, ...]``,
  f32 ``A_log``/``D``/``dt_bias``), and ``count_params`` is JAX's
  1,170,473,856; ``convert.model_params`` carries the nested tree with
  its f32 leaves;
* the forward takes each layer of the nested stacks as a view;
* ``forward``/``prefill`` logits within 2e-5 of the largest; ``loss_fn``
  within 1e-6 relative and every gradient within 1e-5 of its leaf's
  largest entry (JAX's under ``jit``), remat off and on; the shared
  block's gradient is the sum over its groups on both sides, and the
  port's equals the sum of each application's own gradient;
* 16 greedy ``decode_step``s against JAX's from the zero caches: tokens
  equal, logits within 1e-5, every cache leaf (``mamba_groups`` ``[G,
  g, B, ...]``, ``attn`` ``[G, B, S, KV, dh]``, ``mamba_tail``) within
  2e-5 of its largest entry, the mamba decode's bound
  (``test_torch_ssm.py``): the recurrent state rounds differently from
  XLA's fused program from the first step (5.1e-6 at worst over the 16
  steps, ``mamba_tail/ssm``), and the shared block's K/V, behind mamba
  layers, inherit it (1.1e-6 where a dense stack's stay within 1e-6);
  the recurrent decode against the port's own forward within 5e-4;
* two ``make_train_step`` steps (grad_accum 1, remat off; grad_accum 2,
  remat on): loss and grad norm within 1e-5 relative, params within 1e-5
  of their largest entry plus 1e-2 of the summed lr (the SSD scan's
  cumsum, ROADMAP queue 3); both packages' ``train`` from one JAX step-0
  checkpoint within 1e-5 relative.
"""
import jax
import numpy as np
import pytest
import torch

import _torch_parity as P
from repro.configs import registry as jregistry
from repro.launch import steps as jsteps
from repro.models import model as JM
from repro_torch.configs import registry
from repro_torch.launch import serve as S
from repro_torch.launch import steps
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.utils.pytree import flatten_with_path, leaves, unflatten

ARCH = "zamba2-1.2b"


def _setup(dtype=None):
    return P.setup(ARCH, dtype)


def test_init_tree_matches_jax_at_full_width():
    jcfg, cfg = jregistry.get_arch(ARCH), registry.get_arch(ARCH)
    want = P.tree_spec(jax.eval_shape(
        lambda: JM.init_params(jax.random.PRNGKey(0), jcfg)))
    got = P.port_spec(M._hybrid_init(torch.Generator(), cfg, torch.bfloat16,
                                     "meta"))
    assert got == want
    assert M._hybrid_dims(cfg) == (6, 6, 2)
    assert got[("mamba_groups", "mamba", "A_log")] == ((6, 6, 64), "float32")
    assert got[("mamba_tail", "mamba", "in_proj", "w")][0][0] == 2
    assert got[("shared_attn", "attn", "wq", "w")] == ((2048, 2048),
                                                       "bfloat16")
    assert cfg.n_params == JM.count_params(jcfg) == 1_170_473_856


def test_model_params_carries_the_nested_tree():
    jcfg, cfg, jp, params = _setup("bfloat16")
    want = P.np_tree(jp)
    for path, t in flatten_with_path(params):
        w = want
        for k in path:
            w = w[k]
        assert t.dtype == (torch.float32 if path[-1] in ("A_log", "D",
                                                         "dt_bias")
                           else torch.bfloat16), path
        assert tuple(t.shape) == w.shape, path
        np.testing.assert_array_equal(t.float().numpy(),
                                      np.asarray(w, np.float32))
    assert params["mamba_groups"]["ln"]["scale"].shape == (2, 2, 64)
    assert params["mamba_tail"]["ln"]["scale"].shape == (1, 64)


def test_forward_takes_every_layer_as_a_view():
    """The nested ``[n_groups, group]`` axes reach each layer through
    ``_unstack``/``torch.unbind`` as views of the stacked leaves: no
    copy in the forward."""
    _, cfg, _, params = _setup()
    group, n_groups, tail = M._hybrid_dims(cfg)
    stacked = params["mamba_groups"]["mamba"]["in_proj"]["w"]
    base = stacked.untyped_storage().data_ptr()
    for g, p_g in enumerate(M._unstack(params["mamba_groups"], n_groups)):
        for i, p_l in enumerate(M._unstack(p_g, group)):
            w = p_l["mamba"]["in_proj"]["w"]
            assert w._base is not None
            assert w.untyped_storage().data_ptr() == base
            assert w.data_ptr() == stacked[g, i].data_ptr()


def test_forward_and_prefill_match_jax():
    jcfg, cfg, jp, params = _setup()
    jb, tb = P.batch(cfg, 2, 32)
    jlog, jaux = JM.forward(jp, jb, jcfg)
    logits, aux = M.forward(params, tb, cfg)
    P.close(logits, jlog, 2e-5)
    assert float(aux) == float(jaux) == 0.0
    pre = steps.make_prefill_step(cfg)(params, tb)
    P.close(pre, jsteps.make_prefill_step(jcfg)(jp, jb), 2e-5)
    assert torch.equal(M.prefill(params, tb, cfg), pre)


@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_grads_match_jax(remat):
    jcfg, cfg, jp, params = _setup()
    jb, tb = P.batch(cfg, 2, 32)
    P.loss_and_grads(jcfg, cfg, jp, params, jb, tb, remat)


def test_shared_block_gradient_sums_its_groups():
    """Each group's application of the shared block gets its own alias
    of the weights: every application's gradient is nonzero, and their
    sum is the gradient ``make_loss_and_grads`` gives the one block."""
    _, cfg, _, params = _setup()
    _, tb = P.batch(cfg, 2, 32)
    group, n_groups, tail = M._hybrid_dims(cfg)
    shared = params["shared_attn"]
    copies = [[t.detach().requires_grad_() for t in leaves(shared)]
              for _ in range(n_groups)]
    x = M._embed_inputs(params, tb, cfg)
    for p_g, c in zip(M._unstack(params["mamba_groups"], n_groups), copies):
        x = M._hybrid_group(x, (p_g, unflatten(shared, c)), cfg)
    for p_l in M._unstack(params["mamba_tail"], tail):
        x = M._mamba_block(x, p_l, cfg)
    loss = L.cross_entropy(M._logits(params, x, cfg), tb["labels"],
                           cfg.vocab_size)
    per = torch.autograd.grad(loss, sum(copies, []))
    n = len(copies[0])
    total = steps.make_loss_and_grads(cfg, remat=False)(params, tb)[1]
    for i, want in enumerate(leaves(total["shared_attn"])):
        parts = per[i::n]
        assert all(bool(g.abs().max() > 0) for g in parts)
        np.testing.assert_allclose(sum(parts).numpy(), want.numpy(),
                                   rtol=1e-5, atol=1e-6 * float(
                                       want.abs().max()))


def test_decode_matches_jax_from_the_zero_cache():
    jcfg, cfg, jp, params = _setup()
    cache = P.greedy_decode(jcfg, cfg, jp, params, 2, 16, 16, cache_tol=2e-5)
    assert cache["mamba_groups"].ssm.shape == (2, 2, 2, 4, 32, 16)
    assert cache["mamba_groups"].conv.shape == (2, 2, 2, 3, 160)
    assert cache["attn"].k.shape == (2, 2, 16, 4, 16)
    assert cache["mamba_tail"].ssm.shape == (1, 2, 4, 32, 16)
    greedy, _ = steps.make_serve_step(cfg)(
        params, torch.zeros((2, 1), dtype=torch.int32),
        M.init_cache(cfg, 2, 16, device="cpu"), 0)
    assert greedy.dtype == torch.int32 and greedy.shape == (2, 1)


def test_decode_matches_forward():
    """The port's recurrent decode (mamba state and the shared block's
    per-group KV cache) against its own full forward (the JAX test's
    check and tolerance, tests/test_models_smoke.py)."""
    _, cfg, _, params = _setup()
    tokens = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size_raw, (1, 8)).astype(np.int32))
    ref, _ = M.forward(params, {"tokens": tokens}, cfg)
    cache = M.init_cache(cfg, 1, 8, device="cpu")
    outs = []
    for t in range(8):
        logits, cache = M.decode_step(params, tokens[:, t: t + 1], cache, t,
                                      cfg)
        outs.append(logits[:, 0])
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), ref.numpy(),
                               rtol=5e-4, atol=5e-4)


@pytest.mark.parametrize("grad_accum,remat", [(1, False), (2, True)])
def test_train_step_matches_jax(grad_accum, remat):
    jcfg, cfg, jp, params = _setup()
    P.train_steps(jcfg, cfg, jp, params, lambda i: P.batch(cfg, 2, 32, i),
                  grad_accum, remat, slack=1e-2)


def test_train_loop_from_a_shared_step0_checkpoint(tmp_path):
    P.train_loops(ARCH, tmp_path)


def test_serve_tiers_the_family():
    """``launch.serve`` decodes the family with one attention layer's KV
    pages tiered by ARMS, as it serves a dense model."""
    rep = S.serve(ARCH, 12, 2, page_size=4, quiet=True, device="cpu")
    assert rep.fast_mass.shape == (12,) and np.isfinite(rep.fast_mass).all()
    assert np.isfinite(rep.slowdown) and rep.promotions >= 1
