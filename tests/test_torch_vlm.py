"""Port parity of the vlm family (llava-next-mistral-7b: ``patch_embeds``
before the tokens in the dense forward, the labels padded with -1 over
the patches in ``loss_fn``, the training launcher's zero patch stub).

Reduced llava-next-mistral-7b in f32 (2 layers, d_model 64, 4 query
heads of 16 over 2 KV heads, 8 patches), with the JAX package's weights
from ``PRNGKey(0)`` carried across (``convert.model_params``) and the
patch embeddings drawn with numpy from a seed.  Each check holds the
port to the JAX function on the same inputs:

* the init tree's keys, shapes and dtypes equal JAX's at full width, and
  ``count_params`` is JAX's 7,241,732,096;
* ``forward``/``prefill`` logits over patches and tokens (``[B, 8 + S,
  V]``) within 2e-5 of the largest, f32 patches cast to a bf16 model's
  dtype; ``loss_fn`` within 1e-6 relative and every gradient within 1e-5
  of its leaf's largest entry, remat off and on; the loss equals the
  cross-entropy of the token positions alone (the patches carry no
  labels) and does not move when only the patch positions' labels could;
* 16 greedy ``decode_step``s against JAX's (decode sees tokens only):
  tokens equal, logits within 1e-5, the cache within 1e-6 of its largest
  entry;
* two ``make_train_step`` steps with seeded patches (grad_accum 1 and 2:
  the micro-batches split ``patch_embeds`` too): loss and grad norm
  within 1e-5 relative, params within 1e-5 of their largest entry; both
  packages' ``train`` (each with its zero patch stub) from one JAX
  step-0 checkpoint within 1e-5 relative.
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
from repro_torch.launch import train as T
from repro_torch.models import layers as L
from repro_torch.models import model as M

ARCH = "llava-next-mistral-7b"


def _patches(cfg, B, seed=0):
    return (np.random.default_rng(seed).standard_normal(
        (B, cfg.n_patches, cfg.d_model)) * 0.5).astype(np.float32)


def _batch(cfg, B, S, step=0):
    return P.batch(cfg, B, S, step, patches=_patches(cfg, B, step))


def test_init_tree_matches_jax_at_full_width():
    jcfg, cfg = jregistry.get_arch(ARCH), registry.get_arch(ARCH)
    want = P.tree_spec(jax.eval_shape(
        lambda: JM.init_params(jax.random.PRNGKey(0), jcfg)))
    got = P.port_spec(M._dense_init(torch.Generator(), cfg, torch.bfloat16,
                                    "meta"))
    assert got == want
    assert got[("layers", "attn", "wk", "w")] == ((32, 4096, 1024),
                                                  "bfloat16")
    assert cfg.n_params == JM.count_params(jcfg) == 7_241_732_096


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_and_prefill_match_jax(dtype):
    jcfg, cfg, jp, params = P.setup(ARCH, dtype)
    jb, tb = _batch(cfg, 2, 32)
    jlog, jaux = JM.forward(jp, jb, jcfg)
    logits, aux = M.forward(params, tb, cfg)
    assert logits.shape == (2, 8 + 32, cfg.vocab_size)
    assert logits.dtype == L.dtype_of(cfg)
    # bf16: the logits' own rounding (2^-8) over a two-layer stack
    P.close(logits, jlog, 2e-5 if dtype == "float32" else 2e-2)
    assert float(aux) == float(jaux) == 0.0
    if dtype == "float32":
        pre = steps.make_prefill_step(cfg)(params, tb)
        P.close(pre, jsteps.make_prefill_step(jcfg)(jp, jb), 2e-5)
        assert torch.equal(M.prefill(params, tb, cfg), pre)


@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_grads_match_jax(remat):
    jcfg, cfg, jp, params = P.setup(ARCH)
    jb, tb = _batch(cfg, 2, 32)
    P.loss_and_grads(jcfg, cfg, jp, params, jb, tb, remat)


def test_patch_positions_carry_no_labels():
    jcfg, cfg, jp, params = P.setup(ARCH)
    jb, tb = _batch(cfg, 2, 32)
    logits, _ = M.forward(params, tb, cfg)
    want = L.cross_entropy(logits[:, cfg.n_patches:], tb["labels"],
                           cfg.vocab_size)
    loss = M.loss_fn(params, tb, cfg)
    assert float(loss) == float(want)
    np.testing.assert_allclose(float(loss), float(JM.loss_fn(jp, jb, jcfg)),
                               rtol=1e-6)
    # the labels are the tokens' alone: a batch whose labels are all
    # masked has loss 0 whatever the patches
    masked = dict(tb, labels=torch.full_like(tb["labels"], -1))
    assert float(M.loss_fn(params, masked, cfg)) == 0.0


def test_decode_matches_jax_from_the_zero_cache():
    jcfg, cfg, jp, params = P.setup(ARCH)
    cache = P.greedy_decode(jcfg, cfg, jp, params, 2, 16, 16)
    assert cache.k.shape == (2, 2, 2, 16, 16)


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_train_step_matches_jax(grad_accum):
    jcfg, cfg, jp, params = P.setup(ARCH)
    P.train_steps(jcfg, cfg, jp, params, lambda i: _batch(cfg, 2, 32, i),
                  grad_accum, remat=grad_accum == 2)


def test_train_stub_is_the_jax_launchers():
    """f32 zeros ``[batch, n_patches, d_model]``, as
    ``repro.launch.train`` makes them; no stub for a dense model."""
    cfg = registry.reduced(registry.get_arch(ARCH))
    stub = T.stub_inputs(cfg, 3, torch.device("cpu"))
    assert stub.keys() == {"patch_embeds"}
    assert stub["patch_embeds"].dtype == torch.float32
    assert stub["patch_embeds"].shape == (3, 8, 64)
    assert not stub["patch_embeds"].any()
    assert T.stub_inputs(registry.reduced(registry.get_arch("granite-8b")),
                         3, torch.device("cpu")) == {}


def test_train_loop_from_a_shared_step0_checkpoint(tmp_path):
    P.train_loops(ARCH, tmp_path)


def test_serve_tiers_the_family():
    """``launch.serve`` decodes the family with one attention layer's KV
    pages tiered by ARMS, as it serves a dense model."""
    rep = S.serve(ARCH, 12, 2, page_size=4, quiet=True, device="cpu")
    assert rep.fast_mass.shape == (12,) and np.isfinite(rep.fast_mass).all()
    assert np.isfinite(rep.slowdown) and rep.promotions >= 1
