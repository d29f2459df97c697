"""Port parity of the SSM family (repro_torch/models/mamba2.py, the mamba
block, the ssm entries of models/model.py, launch/steps.py and
launch/train.py for mamba2-370m).

Reduced mamba2-370m in f32 (4 layers, d_model 64, 4 heads of 32, N 16,
chunk 8), with the JAX package's weights from ``PRNGKey(0)`` carried
across (``convert.model_params``); on the CPU the scan is the op's plain
version.  Each check holds the port to the JAX function on the same
inputs:

* ``mamba2_init``'s tree, shapes and dtypes equal JAX's at full width in
  bf16 (``A_log``, ``D``, ``dt_bias`` f32) and the parameter count is
  JAX's 419,874,304; ``convert.model_params`` keeps those f32 leaves of a
  bf16 tree;
* ``mamba2_full`` (S = 32, and S = 30, which it pads to the chunk), the
  mamba block and ``mamba2_decode`` within 2e-5 of the largest entry
  (outputs, conv window and state);
* ``forward``/``prefill`` logits within 2e-5, ``loss_fn`` within 1e-6
  relative, every gradient within 1e-5 of its leaf's largest entry (the
  scan's cumsums round differently from XLA's: ``test_torch_mamba_scan``);
* ``make_serve_step`` from the zero cache: greedy tokens equal for 8
  steps, logits within 2e-5; the port's recurrent decode against its own
  full forward within 5e-4 (``tests/test_models_smoke.py``'s tolerance);
* ``make_train_step`` (grad_accum 1 and 2, remat on and off) for 3
  steps: loss and grad norm within 1e-5 relative, params within 1e-5 of
  their largest entry plus 1e-2 of the summed lr (elements with a first
  gradient below 1e-6 within 2 x the summed lr; see the test for why
  these differ from ``test_torch_train.py``); both packages' ``train``
  loops from one JAX step-0 checkpoint within 1e-5 relative;
* a bf16 model's tree with its f32 leaves round-trips through the JAX
  store's format both ways.
"""
import dataclasses
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import store as jstore
from repro.configs import registry as jregistry
from repro.launch import steps as jsteps
from repro.launch import train as jtrain
from repro.models import blocks as JB
from repro.models import mamba2 as JMb
from repro.models import model as JM
from repro.optim import adamw as jadamw
from repro_torch import convert
from repro_torch.checkpoint import store
from repro_torch.configs import registry
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.launch import steps
from repro_torch.launch import train as T
from repro_torch.models import blocks as Bk
from repro_torch.models import mamba2 as Mb
from repro_torch.models import model as M
from repro_torch.optim import adamw
from repro_torch.utils.pytree import flatten_with_path

ARCH = "mamba2-370m"


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _setup(dtype=None):
    jcfg = jregistry.reduced(jregistry.get_arch(ARCH))
    cfg = registry.reduced(registry.get_arch(ARCH))
    if dtype:
        jcfg = dataclasses.replace(jcfg, dtype=dtype)
        cfg = dataclasses.replace(cfg, dtype=dtype)
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, cfg, jp, convert.model_params(_np(jp), cfg, device="cpu")


def _batch(cfg, B, S, step=0):
    b = SyntheticLM(cfg.vocab_size_raw, S, B, seed=0).batch_at(step)
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(v) for k, v in b.items()})


def _jax_leaves(tree):
    """{path: numpy leaf} with the port's path strings."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = tuple(str(getattr(p, "key", getattr(p, "name", p)))
                    for p in path)
        out[key] = np.asarray(leaf, np.float32)
    return out


def _trees_close(got, want, tol, loose=None, loose_tol=None, slack=0.0):
    """Each leaf of the port tree ``got`` within ``tol`` of the largest
    entry of the JAX tree ``want``'s leaf at the same path, plus
    ``slack``; elements set in the bool tree ``loose`` within
    ``loose_tol`` instead."""
    want = _jax_leaves(want)
    loose = _jax_leaves(loose) if loose is not None else {}
    got = {p: t.detach().float().numpy() for p, t in flatten_with_path(got)}
    assert got.keys() == want.keys()
    for p, w in want.items():
        err = np.abs(got[p] - w)
        bad = err > tol * max(np.abs(w).max(), 1e-30) + slack
        if p in loose:
            assert (err[loose[p] > 0] <= loose_tol).all(), "/".join(p)
            bad &= loose[p] == 0
        assert not bad.any(), ("/".join(p), err[bad].max())


def _close(got, want, tol, msg=""):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.detach().float().numpy(), want, rtol=0,
                               atol=tol * np.abs(want).max(), err_msg=msg)


def _layer0(jp, params):
    return (jax.tree_util.tree_map(lambda a: a[0], jp["layers"]),
            M._layer(params["layers"], 0))


def test_init_tree_matches_jax_at_full_width():
    jcfg, cfg = jregistry.get_arch(ARCH), registry.get_arch(ARCH)
    shapes = jax.eval_shape(lambda: JM.init_params(jax.random.PRNGKey(0),
                                                   jcfg))
    want = {key: (tuple(a.shape), str(a.dtype)) for key, a in
            ((tuple(str(k.key) for k in path), a) for path, a in
             jax.tree_util.tree_flatten_with_path(shapes)[0])}
    tree = M._ssm_init(torch.Generator(), cfg, torch.bfloat16, "meta")
    got = {path: (tuple(t.shape), str(t.dtype)[6:])
           for path, t in flatten_with_path(tree)}
    assert got == want
    assert got[("layers", "mamba", "A_log")] == ((48, 32), "float32")
    assert cfg.n_params == JM.count_params(jcfg) == 419_874_304


def test_init_values_match_jax():
    jcfg, cfg, jp, _ = _setup()
    p = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    for nm in ("A_log", "D", "dt_bias", "conv_b"):
        np.testing.assert_allclose(p["layers"]["mamba"][nm].numpy(),
                                   np.asarray(jp["layers"]["mamba"][nm]),
                                   rtol=1e-6, err_msg=nm)


def test_model_params_keeps_the_f32_leaves_of_a_bf16_tree():
    jcfg, cfg, jp, params = _setup("bfloat16")
    f32 = {("layers", "mamba", nm) for nm in ("A_log", "D", "dt_bias")}
    want = _np(jp)
    for path, t in flatten_with_path(params):
        w = want
        for k in path:
            w = w[k]
        assert t.dtype == (torch.float32 if path in f32
                           else torch.bfloat16), path
        np.testing.assert_array_equal(t.float().numpy(),
                                      np.asarray(w, np.float32))


@pytest.mark.parametrize("S", [32, 30])
def test_mamba2_full_block_and_decode_match_jax(S):
    jcfg, cfg, jp, params = _setup()
    jl, pl = _layer0(jp, params)
    x = np.random.default_rng(S).standard_normal((2, S, 64)) \
        .astype(np.float32)
    jout, jcache = JMb.mamba2_full(jl["mamba"], jnp.asarray(x), jcfg)
    out, cache = Mb.mamba2_full(pl["mamba"], torch.from_numpy(x), cfg)
    _close(out, jout, 2e-5, "out")
    _close(cache.conv, jcache.conv, 2e-5, "conv")
    _close(cache.ssm, jcache.ssm, 2e-5, "ssm")
    jy, _ = JB.mamba_block_full(jl, jnp.asarray(x), jcfg)
    y, _ = Bk.mamba_block_full(pl, torch.from_numpy(x), cfg)
    _close(y, jy, 2e-5, "block")
    # one decode step continuing from the JAX cache
    x1 = np.random.default_rng(S + 1).standard_normal((2, 1, 64)) \
        .astype(np.float32)
    c0 = Mb.MambaCache(conv=torch.from_numpy(np.asarray(jcache.conv)),
                       ssm=torch.from_numpy(np.asarray(jcache.ssm)))
    jout, jc = JB.mamba_block_decode(jl, jnp.asarray(x1), jcache, jcfg)
    out, c = Bk.mamba_block_decode(pl, torch.from_numpy(x1), c0, cfg)
    _close(out, jout, 2e-5, "decode out")
    _close(c.conv, jc.conv, 2e-5, "decode conv")
    _close(c.ssm, jc.ssm, 2e-5, "decode ssm")


def test_forward_and_prefill_match_jax():
    jcfg, cfg, jp, params = _setup()
    jb, tb = _batch(cfg, 2, 32)
    jlog, jaux = JM.forward(jp, jb, jcfg)
    logits, aux = M.forward(params, tb, cfg)
    _close(logits, jlog, 2e-5)
    assert float(aux) == float(jaux) == 0.0
    pre = steps.make_prefill_step(cfg)(params, tb)
    _close(pre, jsteps.make_prefill_step(jcfg)(jp, jb), 2e-5)
    assert torch.equal(M.prefill(params, tb, cfg), pre)


def test_loss_and_grads_match_jax():
    jcfg, cfg, jp, params = _setup()
    jb, tb = _batch(cfg, 2, 32)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: JM.loss_fn(p, b, jcfg)))(jp, jb)
    loss, grads = steps.make_loss_and_grads(cfg, remat=False)(params, tb)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-6)
    _trees_close(grads, jgrads, 1e-5)


def test_serve_steps_match_jax_from_the_zero_cache():
    jcfg, cfg, jp, params = _setup()
    jcache, cache = JM.init_cache(jcfg, 2, 16), M.init_cache(cfg, 2, 16,
                                                             device="cpu")
    assert isinstance(cache, Mb.MambaCache)
    assert cache.conv.shape == (4, 2, 3, 160)
    assert cache.ssm.shape == (4, 2, 4, 32, 16)
    jstep = jax.jit(jsteps.make_serve_step(jcfg, greedy=False))
    step = steps.make_serve_step(cfg, greedy=False)
    jtok = jnp.asarray([[3], [7]], jnp.int32)
    tok = torch.tensor([[3], [7]], dtype=torch.int32)
    for t in range(8):
        jlog, jcache = jstep(jp, jtok, jcache, jnp.int32(t))
        logits, cache = step(params, tok, cache, t)
        _close(logits, jlog, 2e-5, f"t={t}")
        jtok = jnp.argmax(jlog[:, -1:], axis=-1).astype(jnp.int32)
        tok = logits[:, -1:].argmax(dim=-1).to(torch.int32)
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    _close(cache.ssm, jcache.ssm, 2e-5)
    greedy, _ = steps.make_serve_step(cfg)(params, tok, cache, 8)
    assert greedy.dtype == torch.int32 and greedy.shape == (2, 1)


def test_decode_matches_forward():
    """The port's recurrent decode against its own chunked full forward
    (the JAX test's check, tests/test_models_smoke.py)."""
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


@pytest.mark.parametrize("grad_accum,remat", [(1, False), (2, False),
                                              (1, True), (2, True)])
def test_train_step_matches_jax(grad_accum, remat):
    """Params as in ``test_torch_train.py`` (within 1e-5 of each leaf's
    largest entry; elements whose first gradient is nonzero but within
    f32 noise of AdamW's first normalised step g / (|g| + eps) within 2 x
    the summed lr), with two changes for the scan's noisier gradients.
    They agree with XLA's to about 1e-7 absolutely (1e-6 of each leaf's
    largest entry; 1e-4 allowed, ``test_torch_mamba_scan``: the cumsum's
    rounding through ``exp``), so the noisy set is |g| < 1e-6 (ten times
    that noise, where the dense stack's few 1e-9 gave 10 eps = 1e-7).
    And every element gets 1e-2 of the summed lr on top: AdamW divides
    each element's gradient by its own running RMS, so a step's error is
    the gradient's error relative to that element, times lr; an element
    whose gradient falls to 1e-3 of its leaf's largest at some step moves
    up to about 1e-3 lr away, and ``conv_b`` and ``dt_bias`` start at
    zero, so their largest entry is itself about lr."""
    jcfg, cfg, jp, params = _setup()
    kw = dict(total_steps=3, warmup_steps=1)
    jopt, opt = jadamw.AdamWConfig(**kw), adamw.AdamWConfig(**kw)
    jst, st = jadamw.init(jp, jopt), adamw.init(params, opt)
    g0 = jax.jit(jax.grad(lambda p, b: JM.loss_fn(p, b, jcfg)))(
        jp, _batch(cfg, 2, 32)[0])
    noisy = jax.tree_util.tree_map(
        lambda g: (jnp.abs(g) < 1e-6) & (g != 0), g0)
    n_noisy = sum(int(x.sum()) for x in jax.tree_util.tree_leaves(noisy))
    assert n_noisy <= 1e-3 * JM.count_params(jcfg)
    jstep = jax.jit(jsteps.make_train_step(jcfg, jopt, grad_accum=grad_accum,
                                           remat=remat))
    step = steps.make_train_step(cfg, opt, grad_accum=grad_accum,
                                 remat=remat)
    lr_sum = 0.0
    for i in range(3):
        jb, tb = _batch(cfg, 2, 32, step=i)
        jp, jst, jm = jstep(jp, jst, jb)
        params, st, m = step(params, st, tb)
        lr_sum += float(jm["lr"])
        for nm in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(m[nm]), float(jm[nm]),
                                       rtol=1e-5, err_msg=f"{nm} step {i}")
    _trees_close(params, jp, 1e-5, noisy, 2 * lr_sum, 1e-2 * lr_sum)
    _trees_close(st.master, jst.master, 1e-5, noisy, 2 * lr_sum,
                 1e-2 * lr_sum)


def test_train_loop_from_a_shared_step0_checkpoint(tmp_path):
    jcfg = jregistry.reduced(jregistry.get_arch(ARCH))
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    opt = jadamw.AdamWConfig(total_steps=4, warmup_steps=1)
    jstore.save((jp, jadamw.init(jp, opt)), tmp_path / "jax", step=0)
    shutil.copytree(tmp_path / "jax", tmp_path / "port")
    kw = dict(n_steps=4, batch=2, seq=32, restore=True)
    want = jtrain.train(ARCH, ckpt_dir=str(tmp_path / "jax"), **kw)
    got = T.train(ARCH, ckpt_dir=str(tmp_path / "port"), device="cpu", **kw)
    assert len(got) == len(want) == 4
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_bf16_tree_with_f32_leaves_round_trips_both_ways(tmp_path):
    """A bf16 mamba2 model's params and AdamW state: written by JAX and
    restored by the port, and the reverse, every leaf in its own dtype
    and bit for bit."""
    jcfg, cfg, jp, params = _setup("bfloat16")
    opt = adamw.AdamWConfig(total_steps=2, warmup_steps=1)
    jst = jadamw.init(jp, jadamw.AdamWConfig(total_steps=2, warmup_steps=1))
    jstore.save((jp, jst), tmp_path / "jax", step=3)
    like = (params, adamw.init(params, opt))
    (got_p, got_st), step = store.restore(like, tmp_path / "jax")
    assert step == 3
    for (path, g), (_, p) in zip(flatten_with_path(got_p),
                                 flatten_with_path(params)):
        assert g.dtype == p.dtype and torch.equal(g, p), path
    assert got_p["layers"]["mamba"]["A_log"].dtype == torch.float32
    assert got_p["layers"]["mamba"]["in_proj"]["w"].dtype == torch.bfloat16
    store.save(like, tmp_path / "port", step=5)
    (rp, rst), step = jstore.restore((jp, jst), tmp_path / "port")
    assert step == 5
    for a, b in zip(jax.tree_util.tree_leaves(rp),
                    jax.tree_util.tree_leaves(jp)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      np.asarray(b, np.float32))
    np.testing.assert_array_equal(
        np.asarray(rst.master["layers"]["mamba"]["in_proj"]["w"]),
        np.asarray(jst.master["layers"]["mamba"]["in_proj"]["w"]))


def test_train_entry_point_takes_the_ssm_family():
    losses = T.train(ARCH, 2, 2, 16, device="cpu", log_every=100)
    assert len(losses) == 2 and np.isfinite(losses).all()
    for arch in ("whisper-small", "deepseek-v2-236b"):
        more = T.train(arch, 1, 2, 8, device="cpu", log_every=100)
        assert len(more) == 1 and np.isfinite(more).all()
