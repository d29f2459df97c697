"""Helpers of the model-family parity tests (test_torch_hybrid.py,
test_torch_vlm.py, test_torch_moe.py): the JAX package's weights carried
into the port, the same batches on both sides, tree comparisons, and the
train-step and train-loop checks every family runs.  Imports JAX."""
import dataclasses
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.checkpoint import store as jstore
from repro.configs import registry as jregistry
from repro.launch import steps as jsteps
from repro.launch import train as jtrain
from repro.models import model as JM
from repro.optim import adamw as jadamw
from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.launch import steps
from repro_torch.launch import train as T
from repro_torch.models import model as M
from repro_torch.optim import adamw
from repro_torch.utils.pytree import flatten_with_path


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def setup(arch, dtype=None, **over):
    """(jcfg, cfg, JAX params from ``PRNGKey(0)``, the port's copy) of the
    reduced ``arch``, with ``dtype`` and ``over`` replaced."""
    jcfg = jregistry.reduced(jregistry.get_arch(arch))
    cfg = registry.reduced(registry.get_arch(arch))
    if dtype:
        over["dtype"] = dtype
    jcfg, cfg = (dataclasses.replace(c, **over) for c in (jcfg, cfg))
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, cfg, jp, convert.model_params(np_tree(jp), cfg,
                                               device="cpu")


def batch(cfg, B, S, step=0, patches=None):
    """The JAX package's synthetic batch ``step`` on both sides, with
    ``patches`` (a numpy array) as ``patch_embeds``."""
    b = SyntheticLM(cfg.vocab_size_raw, S, B, seed=0).batch_at(step)
    if patches is not None:
        b["patch_embeds"] = patches
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(v) for k, v in b.items()})


def jax_leaves(tree):
    """{path: numpy leaf} with the port's path strings."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = tuple(str(getattr(p, "key", getattr(p, "name", p)))
                    for p in path)
        out[key] = np.asarray(leaf, np.float32)
    return out


def tree_spec(tree) -> dict:
    """{path: (shape, dtype name)} of a JAX tree of shapes."""
    return {key: (tuple(a.shape), str(a.dtype)) for key, a in
            ((tuple(str(k.key) for k in path), a) for path, a in
             jax.tree_util.tree_flatten_with_path(tree)[0])}


def port_spec(tree) -> dict:
    return {path: (tuple(t.shape), str(t.dtype)[6:])
            for path, t in flatten_with_path(tree)}


def trees_close(got, want, tol, loose=None, loose_tol=None, slack=0.0):
    """Each leaf of the port tree ``got`` within ``tol`` of the largest
    entry of the JAX tree ``want``'s leaf at the same path, plus
    ``slack``; elements set in the bool tree ``loose`` within
    ``loose_tol`` instead."""
    want = jax_leaves(want)
    loose = jax_leaves(loose) if loose is not None else {}
    got = {p: t.detach().float().numpy() for p, t in flatten_with_path(got)}
    assert got.keys() == want.keys()
    for p, w in want.items():
        err = np.abs(got[p] - w)
        bad = err > tol * max(np.abs(w).max(), 1e-30) + slack
        if p in loose:
            assert (err[loose[p] > 0] <= loose_tol).all(), "/".join(p)
            bad &= loose[p] == 0
        assert not bad.any(), ("/".join(p), err[bad].max())


def close(got, want, tol, msg=""):
    """Within ``tol`` of ``want``'s largest entry."""
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.detach().float().numpy(), want, rtol=0,
                               atol=tol * np.abs(want).max(), err_msg=msg)


def loss_and_grads(jcfg, cfg, jp, params, jb, tb, remat):
    """Loss within 1e-6 relative and every gradient within 1e-5 of its
    leaf's largest entry, JAX's under ``jit``; -> the port's grads."""
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: JM.loss_fn(p, b, jcfg, remat=remat)))(jp, jb)
    loss, grads = steps.make_loss_and_grads(cfg, remat=remat)(params, tb)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-6)
    trees_close(grads, jgrads, 1e-5)
    return grads


def greedy_decode(jcfg, cfg, jp, params, B, s_max, steps_, cache_tol=1e-6):
    """``steps_`` greedy ``decode_step``s from the zero caches, JAX's
    under ``jit``: tokens equal at every step, logits within 1e-5 and,
    at the end, every cache leaf within ``cache_tol`` of its largest
    entry.  -> the port's final cache."""
    jcache = JM.init_cache(jcfg, B, s_max)
    cache = M.init_cache(cfg, B, s_max, device="cpu")
    jstep = jax.jit(lambda p, t, c, pos: JM.decode_step(p, t, c, pos, jcfg))
    jtok = jnp.asarray(np.arange(B).reshape(B, 1) * 7 + 3, jnp.int32)
    tok = torch.from_numpy(np.array(jtok))
    for t in range(steps_):
        jlog, jcache = jstep(jp, jtok, jcache, jnp.int32(t))
        logits, cache = M.decode_step(params, tok, cache, t, cfg)
        close(logits, jlog, 1e-5, f"logits t={t}")
        jtok = jnp.argmax(jlog[:, -1:], axis=-1).astype(jnp.int32)
        tok = logits[:, -1:].argmax(dim=-1).to(torch.int32)
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    want = jax_leaves(jcache)
    got = {p: t.float().numpy() for p, t in flatten_with_path(_plain(cache))}
    assert got.keys() == want.keys()
    for p, w in want.items():
        np.testing.assert_allclose(got[p], w, rtol=0,
                                   atol=cache_tol * np.abs(w).max(),
                                   err_msg="/".join(p))
    return cache


def _plain(cache):
    """A decode cache as nested dicts (a tensor dataclass's fields by
    name), the JAX tree's path strings."""
    if isinstance(cache, dict):
        return {k: _plain(v) for k, v in cache.items()}
    if dataclasses.is_dataclass(cache):
        return {f.name: getattr(cache, f.name)
                for f in dataclasses.fields(cache)}
    return cache


def train_steps(jcfg, cfg, jp, params, make_batch, grad_accum, remat,
                n=2, slack=0.0, noisy_share=1e-3):
    """``n`` steps of ``make_train_step`` against JAX's (jitted) on the
    batches ``make_batch(step)``: loss and grad norm within 1e-5
    relative; params and the f32 master within 1e-5 of each leaf's
    largest entry plus ``slack`` of the summed lr (elements whose first
    gradient is nonzero and below 1e-6 within 2 x the summed lr: AdamW's
    first normalised step g / (|g| + eps) turns f32 noise there into up
    to lr, ``test_torch_ssm.py``; at most ``noisy_share`` of the
    elements)."""
    kw = dict(total_steps=n, warmup_steps=1)
    jopt, opt = jadamw.AdamWConfig(**kw), adamw.AdamWConfig(**kw)
    jst, st = jadamw.init(jp, jopt), adamw.init(params, opt)
    # the first step's gradient as the step takes it: the mean of its
    # micro-batches' (an MoE layer's capacity follows the micro-batch)
    grad = jax.jit(jax.grad(lambda p, b: JM.loss_fn(p, b, jcfg)))
    jb0 = make_batch(0)[0]
    n_micro = next(iter(jb0.values())).shape[0] // grad_accum
    g0 = jax.tree_util.tree_map(lambda *g: sum(g) / grad_accum, *(
        grad(jp, {k: v[i * n_micro:(i + 1) * n_micro]
                  for k, v in jb0.items()}) for i in range(grad_accum)))
    noisy = jax.tree_util.tree_map(
        lambda g: (jnp.abs(g) < 1e-6) & (g != 0), g0)
    n_noisy = sum(int(x.sum()) for x in jax.tree_util.tree_leaves(noisy))
    assert n_noisy <= noisy_share * JM.count_params(jcfg)
    jstep = jax.jit(jsteps.make_train_step(jcfg, jopt, grad_accum=grad_accum,
                                           remat=remat))
    step = steps.make_train_step(cfg, opt, grad_accum=grad_accum,
                                 remat=remat)
    lr_sum = 0.0
    for i in range(n):
        jb, tb = make_batch(i)
        jp, jst, jm = jstep(jp, jst, jb)
        params, st, m = step(params, st, tb)
        lr_sum += float(jm["lr"])
        for nm in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(m[nm]), float(jm[nm]),
                                       rtol=1e-5, err_msg=f"{nm} step {i}")
    trees_close(params, jp, 1e-5, noisy, 2 * lr_sum, slack * lr_sum)
    trees_close(st.master, jst.master, 1e-5, noisy, 2 * lr_sum,
                slack * lr_sum)


def train_loops(arch, tmp_path, n_steps=3, batch_=2, seq=32):
    """Both packages' ``train`` restored from one JAX step-0 checkpoint
    (params and AdamW state), ``n_steps`` steps on the same batches:
    losses within 1e-5 relative."""
    jcfg = jregistry.reduced(jregistry.get_arch(arch))
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    opt = jadamw.AdamWConfig(total_steps=n_steps, warmup_steps=1)
    jstore.save((jp, jadamw.init(jp, opt)), tmp_path / "jax", step=0)
    shutil.copytree(tmp_path / "jax", tmp_path / "port")
    kw = dict(n_steps=n_steps, batch=batch_, seq=seq, restore=True,
              log_every=100)
    want = jtrain.train(arch, ckpt_dir=str(tmp_path / "jax"), **kw)
    got = T.train(arch, ckpt_dir=str(tmp_path / "port"), device="cpu", **kw)
    assert len(got) == len(want) == n_steps
    np.testing.assert_allclose(got, want, rtol=1e-5)
