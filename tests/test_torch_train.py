"""Port parity of the training slice (repro_torch/models full-sequence
path, optim/adamw.py, data/pipeline.py, launch/steps.py, launch/train.py).

Reduced stablelm-1.6b (MHA, partial rotary) and granite-8b (GQA rep 2)
in f32, with the JAX package's weights from ``PRNGKey(0)`` carried across
(``convert.model_params``); each check holds the port (on the CPU, the
plain versions) to the JAX function on the same inputs:

* ``gqa_full``, ``dense_block_full`` and ``forward``/``prefill`` logits
  within 1e-5 at S = 32 (JAX's naive ``_sdpa`` branch), and one
  ``gqa_full`` at S = 4,096 (JAX's ``xla_flash`` branch) within 1e-5;
* ``loss_fn`` within 1e-6 relative and every parameter's gradient within
  1e-5 of its largest entry;
* ``adamw.update`` on random trees (f32 and bf16 params, with and
  without the master copy) within 1e-6 of each leaf's largest entry
  (bf16 params within one bf16 rounding), ``schedule`` within 1e-7
  relative, and a JAX optimizer state carried across
  (``convert.adamw_state``) continues as the JAX run does;
* ``SyntheticLM`` batches equal JAX's exactly;
* ``make_train_step`` (grad_accum 1 and 2, remat on and off, against the
  jitted JAX step): 3 steps, loss and grad norm within 1e-5 relative,
  params within 1e-5 of their largest entry (elements whose first
  gradient is within f32 noise of AdamW's eps: within 2 x the summed lr,
  see the test);
* the loop: both packages' ``train`` restored from one JAX step-0
  checkpoint, 4 steps, losses within 1e-5 relative.

The JAX step runs under ``jit``, where XLA fuses multiply-adds (ROADMAP
queue 3), hence tolerances rather than bitwise equality.
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
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.launch import steps as jsteps
from repro.launch import train as jtrain
from repro.models import attention as JA
from repro.models import blocks as JB
from repro.models import model as JM
from repro.optim import adamw as jadamw
from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.data.pipeline import Prefetcher, SyntheticLM
from repro_torch.launch import steps
from repro_torch.launch import train as T
from repro_torch.models import attention as A
from repro_torch.models import blocks as Bk
from repro_torch.models import model as M
from repro_torch.optim import adamw
from repro_torch.utils.pytree import flatten_with_path

ARCHS = ["stablelm-1.6b", "granite-8b"]


def _setup(arch):
    jcfg = jregistry.reduced(jregistry.get_arch(arch))
    cfg = registry.reduced(registry.get_arch(arch))
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    params = convert.model_params(jax.tree_util.tree_map(np.asarray, jp),
                                  cfg, device="cpu")
    return jcfg, cfg, jp, params


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


def _trees_close(got, want, tol, loose=None, loose_tol=None):
    """Each leaf of the port tree ``got`` within ``tol`` of the largest
    entry of the JAX tree ``want``'s leaf at the same path; elements
    where the bool tree ``loose`` (JAX paths) is set within ``loose_tol``
    instead."""
    want = _jax_leaves(want)
    loose = _jax_leaves(loose) if loose is not None else {}
    got = {p: t.detach().float().numpy() for p, t in flatten_with_path(got)}
    assert got.keys() == want.keys()
    for p, w in want.items():
        err = np.abs(got[p] - w)
        bad = err > tol * max(np.abs(w).max(), 1e-30)
        if p in loose:
            assert (err[loose[p] > 0] <= loose_tol).all(), "/".join(p)
            bad &= loose[p] == 0
        assert not bad.any(), ("/".join(p), err[bad].max())


def _layer0(jp, params):
    return (jax.tree_util.tree_map(lambda a: a[0], jp["layers"]),
            M._layer(params["layers"], 0))


@pytest.mark.parametrize("arch", ARCHS)
def test_gqa_full_and_block_match_jax(arch):
    jcfg, cfg, jp, params = _setup(arch)
    jl, pl = _layer0(jp, params)
    x = np.random.default_rng(1).standard_normal((2, 32, 64)) \
        .astype(np.float32)
    jout, jkv = JA.gqa_full(jl["attn"], jnp.asarray(x), jcfg)
    out, kv = A.gqa_full(pl["attn"], torch.from_numpy(x), cfg)
    for g, w in ((out, jout), (kv.k, jkv.k), (kv.v, jkv.v)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-5)
    jy, _ = JB.dense_block_full(jl, jnp.asarray(x), jcfg)
    y, _ = Bk.dense_block_full(pl, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=0, atol=1e-5)


def test_gqa_full_at_4096_matches_jax_flash_branch():
    """S = 4,096: JAX takes ``xla_flash.flash_sdpa`` (blocks of 2,048);
    the port runs the same op as at every S."""
    jcfg, cfg, jp, params = _setup("granite-8b")
    jl, pl = _layer0(jp, params)
    x = np.random.default_rng(2).standard_normal((1, 4096, 64)) \
        .astype(np.float32)
    jout, _ = JA.gqa_full(jl["attn"], jnp.asarray(x), jcfg)
    out, _ = A.gqa_full(pl["attn"], torch.from_numpy(x), cfg)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=0,
                               atol=1e-5)


def test_causal_mask_matches_jax():
    for sq, sk, off, w in ((5, 5, 0, 0), (3, 9, 6, 0), (8, 8, 0, 3)):
        np.testing.assert_array_equal(
            A.causal_mask(sq, sk, off, w).numpy(),
            np.asarray(JA.causal_mask(sq, sk, off, w)))


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_prefill_match_jax(arch):
    jcfg, cfg, jp, params = _setup(arch)
    jb, tb = _batch(cfg, 2, 32)
    jlog, jaux = JM.forward(jp, jb, jcfg)
    logits, aux = M.forward(params, tb, cfg)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlog), rtol=0,
                               atol=1e-5)
    assert float(aux) == float(jaux) == 0.0
    pre = steps.make_prefill_step(cfg)(params, tb)
    np.testing.assert_allclose(
        pre.numpy(), np.asarray(jsteps.make_prefill_step(jcfg)(jp, jb)),
        rtol=0, atol=1e-5)
    assert torch.equal(M.prefill(params, tb, cfg), pre)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(arch):
    jcfg, cfg, jp, params = _setup(arch)
    jb, tb = _batch(cfg, 2, 32)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: JM.loss_fn(p, b, jcfg)))(jp, jb)
    loss, grads = steps.make_loss_and_grads(cfg, remat=False)(params, tb)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-6)
    assert float(M.loss_fn(params, tb, cfg)) == float(loss)
    _trees_close(grads, jgrads, 1e-5)


def _rand_tree(rng, dtype, scale=1.0):
    shapes = {"a": (8, 16), "b": {"c": (4,), "d": (3, 5)}, "e": (2, 3, 4)}

    def make(s):
        if isinstance(s, dict):
            return {k: make(v) for k, v in s.items()}
        return (rng.standard_normal(s) * scale).astype(np.float32)

    tree = make(shapes)
    to_j = lambda t: jax.tree_util.tree_map(
        lambda a: jnp.asarray(a).astype(dtype), t)
    to_t = lambda t: jax.tree_util.tree_map(
        lambda a: torch.from_numpy(np.array(
            jnp.asarray(a).astype(dtype), np.float32)).to(
                torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32),
        t)
    return to_j(tree), to_t(tree)


@pytest.mark.parametrize("master", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_jax(dtype, master):
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    rng = np.random.default_rng(3)
    cfg_kw = dict(warmup_steps=2, total_steps=5, master_fp32=master,
                  clip_norm=1.0)
    jcfg, cfg = jadamw.AdamWConfig(**cfg_kw), adamw.AdamWConfig(**cfg_kw)
    jp, tp = _rand_tree(rng, jdt)
    jst, st = jadamw.init(jp, jcfg), adamw.init(tp, cfg)
    for i in range(4):   # clipped (large) and unclipped (small) grads
        jg, tg = _rand_tree(rng, jdt, 0.01 if i % 2 else 1.0)
        jp, jst, jm = jadamw.update(jg, jst, jp, jcfg)
        tp, st, m = adamw.update(tg, st, tp, cfg)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(m["lr"]), float(jm["lr"]),
                                   rtol=1e-6)
        assert int(st.step) == int(jst.step) == i + 1
        for nm in ("m", "v", "master"):
            _trees_close(getattr(st, nm), getattr(jst, nm), 1e-6)
        ulp = 2.0 ** -7 if dtype == "bfloat16" else 1e-6
        _trees_close(tp, jp, ulp)


def test_clip_by_global_norm_matches_jax():
    jg, tg = _rand_tree(np.random.default_rng(4), jnp.float32)
    jc, jn = jadamw.clip_by_global_norm(jg, 1.0)
    c, n = adamw.clip_by_global_norm(tg, 1.0)
    np.testing.assert_allclose(float(n), float(jn), rtol=1e-6)
    _trees_close(c, jc, 1e-6)


@pytest.mark.parametrize("warm,total", [(100, 10_000), (1, 4), (2, 2)])
def test_schedule_matches_jax(warm, total):
    jcfg = jadamw.AdamWConfig(warmup_steps=warm, total_steps=total)
    cfg = adamw.AdamWConfig(warmup_steps=warm, total_steps=total)
    for s in (0, 1, 2, 3, 5, 50, 99, 100, 101, 4_000, 9_999, 10_000, 20_000):
        want = float(jadamw.schedule(jnp.int32(s), jcfg))
        got = adamw.schedule(torch.tensor(s, dtype=torch.int32), cfg)
        assert got.dtype == torch.float32
        assert abs(float(got) - want) <= 1e-7 * abs(want), (s, got, want)


def test_synthetic_batches_equal_jax():
    for vocab, seq, batch, seed in ((256, 32, 2, 0), (100352, 64, 3, 7)):
        j, t = JSyntheticLM(vocab, seq, batch, seed), \
            SyntheticLM(vocab, seq, batch, seed)
        for step in (0, 1, 5, 1000):
            a, b = j.batch_at(step), t.batch_at(step)
            for k in ("tokens", "labels"):
                assert a[k].dtype == b[k].dtype == np.int32
                np.testing.assert_array_equal(a[k], b[k])
    pre = Prefetcher(SyntheticLM(256, 8, 2), start_step=3)
    try:
        for i in (3, 4, 5):
            step, b = pre.next()
            assert step == i
            np.testing.assert_array_equal(
                b["tokens"], JSyntheticLM(256, 8, 2).batch_at(i)["tokens"])
    finally:
        pre.close()


@pytest.mark.parametrize("arch,grad_accum,remat", [
    ("stablelm-1.6b", 1, False), ("stablelm-1.6b", 2, False),
    ("stablelm-1.6b", 1, True), ("stablelm-1.6b", 2, True),
    ("granite-8b", 1, False), ("granite-8b", 2, True)])
def test_train_step_matches_jax(arch, grad_accum, remat):
    """Params within 1e-5 of each leaf's largest entry, except where the
    first step's gradient is nonzero and below 10 eps = 1e-7: there
    AdamW's first normalised step g / (|g| + eps) turns f32 summation
    noise in g (a few 1e-9 here, from another matmul order) into a step
    of up to lr, so those elements (at most 0.1 %) are held within 2 x
    the summed lr."""
    jcfg, cfg, jp, params = _setup(arch)
    kw = dict(total_steps=3, warmup_steps=1)
    jopt, opt = jadamw.AdamWConfig(**kw), adamw.AdamWConfig(**kw)
    jst, st = jadamw.init(jp, jopt), adamw.init(params, opt)
    g0 = jax.jit(jax.grad(lambda p, b: JM.loss_fn(p, b, jcfg)))(
        jp, _batch(cfg, 2, 32)[0])
    noisy = jax.tree_util.tree_map(
        lambda g: (jnp.abs(g) < 1e-7) & (g != 0), g0)
    n_noisy = sum(int(x.sum()) for x in jax.tree_util.tree_leaves(noisy))
    assert n_noisy <= 1e-3 * JM.count_params(jcfg)
    lr_sum = 0.0
    jstep = jax.jit(jsteps.make_train_step(jcfg, jopt, grad_accum=grad_accum,
                                           remat=remat))
    step = steps.make_train_step(cfg, opt, grad_accum=grad_accum,
                                 remat=remat)
    for i in range(3):
        jb, tb = _batch(cfg, 2, 32, step=i)
        jp, jst, jm = jstep(jp, jst, jb)
        params, st, m = step(params, st, tb)
        lr_sum += float(jm["lr"])
        for nm in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(m[nm]), float(jm[nm]),
                                       rtol=1e-5, err_msg=f"{nm} step {i}")
    _trees_close(params, jp, 1e-5, noisy, 2 * lr_sum)
    _trees_close(st.master, jst.master, 1e-5, noisy, 2 * lr_sum)


def test_adamw_state_continues_a_jax_run():
    """Two JAX steps, then the state crosses into the port: the third
    step agrees with JAX's third step."""
    jcfg, cfg, jp, _ = _setup("granite-8b")
    kw = dict(total_steps=3, warmup_steps=1)
    jopt, opt = jadamw.AdamWConfig(**kw), adamw.AdamWConfig(**kw)
    jst = jadamw.init(jp, jopt)
    jstep = jax.jit(jsteps.make_train_step(jcfg, jopt, remat=False))
    for i in range(2):
        jp, jst, _ = jstep(jp, jst, _batch(cfg, 2, 32, step=i)[0])
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)
    params = convert.model_params(np_tree(jp), cfg, device="cpu")
    st = convert.adamw_state(np_tree(jst), params, device="cpu")
    assert st.step.dtype == torch.int32 and int(st.step) == 2
    jb, tb = _batch(cfg, 2, 32, step=2)
    jp, jst, jm = jstep(jp, jst, jb)
    params, st, m = steps.make_train_step(cfg, opt, remat=False)(params, st,
                                                                 tb)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    _trees_close(params, jp, 1e-5)
    _trees_close(st.v, jst.v, 1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_loop_from_a_shared_step0_checkpoint(arch, tmp_path):
    """The JAX store writes (params, AdamW state) at step 0; both
    packages' ``train`` restore it from their own copy and run 4 steps on
    the same batches."""
    jcfg = jregistry.reduced(jregistry.get_arch(arch))
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    opt = jadamw.AdamWConfig(total_steps=4, warmup_steps=1)
    jstore.save((jp, jadamw.init(jp, opt)), tmp_path / "jax", step=0)
    shutil.copytree(tmp_path / "jax", tmp_path / "port")
    kw = dict(n_steps=4, batch=2, seq=32, restore=True)
    want = jtrain.train(arch, ckpt_dir=str(tmp_path / "jax"), **kw)
    got = T.train(arch, ckpt_dir=str(tmp_path / "port"), device="cpu", **kw)
    assert len(got) == len(want) == 4
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_entry_points_default_to_the_card_and_reject_other_families():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            T.train("stablelm-1.6b", 1, 2, 8)
    for arch in ("whisper-small", "deepseek-v2-236b"):
        losses = T.train(arch, 1, 2, 8, device="cpu", log_every=100)
        assert len(losses) == 1 and np.isfinite(losses).all()
    from repro_torch.tiering import host_offload as HO
    with pytest.raises(ValueError, match="pass its DeviceMesh"):
        HO.to_slow_tier(torch.zeros(2), "memkind", mesh=2)


def test_serve_step_matches_jax():
    jcfg, cfg, jp, params = _setup("granite-8b")
    jcache, cache = JM.init_cache(jcfg, 2, 16), M.init_cache(cfg, 2, 16,
                                                             device="cpu")
    jstep, step = jsteps.make_serve_step(jcfg), steps.make_serve_step(cfg)
    jtok = jnp.asarray([[3], [7]], jnp.int32)
    tok = torch.tensor([[3], [7]], dtype=torch.int32)
    for t in range(6):
        jtok, jcache = jstep(jp, jtok, jcache, jnp.int32(t))
        tok, cache = step(params, tok, cache, t)
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    logits, _ = steps.make_serve_step(cfg, greedy=False)(params, tok, cache,
                                                         6)
    assert logits.shape == (2, 1, cfg.vocab_size)
    assert dataclasses.is_dataclass(cache)
