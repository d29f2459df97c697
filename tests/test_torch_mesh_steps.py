"""The step factories on a mesh (repro_torch/launch/steps.py, mesh=).

A (1, 1) gloo mesh: for one reduced config of each family (dense, SSM,
hybrid, vlm, MoE, MLA, enc-dec), a train step, a prefill and greedy
decode steps on DTensors (params and optimizer state distributed by
``param_shardings``, the decode cache by ``cache_sharding``) give the
mesh-free steps' bits: loss, grad norm, every updated param, logits,
tokens and cache.  The mesh-free steps are held to JAX elsewhere
(tests/test_torch_train.py and the family files).

A (2, 2) mesh of 4 gloo ranks (``mp.spawn``, a ``FileStore`` in
``tmp_path``) runs reduced stablelm-1.6b (widths divisible by 2) with
its attention, MLP and embedding leaves sharded on both axes: one train
step's loss and grad norm within 1e-5 relative of the mesh-free step,
params within 1e-5 of each leaf's largest entry, prefill logits within
1e-5 of the largest; greedy decode into a cache whose sequence is split
over "model" (positions on both of its shards) with tokens equal and the
cache within 1e-5; and the flash and scan ops' sharding rules with real
values (batch over "data", heads over "model"), forward and backward,
within 1e-5 of the plain tensors, the scan's dA a partial sum.  As in tests/test_torch_train.py, elements whose
first gradient is nonzero and below 1e-7 (at most 0.1 %) are held within
2 x the step's lr instead: AdamW's first step g / (|g| + eps) turns the
f32 summation noise of another reduction order in g into a step of up
to lr there.
"""
import dataclasses
import json
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)

from repro_torch.configs import registry
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.mamba_scan import ops as scan_ops
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import sharding, steps
from repro_torch.models import model as M
from repro_torch.optim import adamw
from repro_torch.utils.pytree import flatten_with_path, leaves

#: each family's reduced config, cut to the fewest layers that keep its
#: structure (the hybrid: one group and a tail; the MoE: one dense + MoE
#: super-layer; MLA: layer 0 and one MoE layer)
FAMILIES = {"stablelm-1.6b": {}, "mamba2-370m": {"n_layers": 2},
            "zamba2-1.2b": {"n_layers": 3},
            "llava-next-mistral-7b": {"n_layers": 1},
            "llama4-scout-17b-16e": {"n_layers": 2},
            "deepseek-v2-236b": {"n_layers": 2},
            "whisper-small": {"n_layers": 1, "n_enc_layers": 1}}
B, S = 2, 8


def _cfg(arch):
    return dataclasses.replace(registry.reduced(registry.get_arch(arch)),
                               **FAMILIES.get(arch, {}))


def _batch(cfg, seed: int = 0) -> dict:
    b = {k: torch.from_numpy(v) for k, v in
         SyntheticLM(cfg.vocab_size_raw, S, B, seed=seed).batch_at(0)
         .items()}
    rng = np.random.default_rng(seed)
    if cfg.family == "vlm":
        b["patch_embeds"] = torch.from_numpy(rng.standard_normal(
            (B, cfg.n_patches, cfg.d_model), dtype=np.float32))
    if cfg.family == "encdec":
        b["audio_embeds"] = torch.from_numpy(rng.standard_normal(
            (B, cfg.enc_seq, cfg.d_model), dtype=np.float32))
    return b


def _params(cfg):
    return M.init_params(cfg, torch.Generator().manual_seed(0),
                         device="cpu")


def _plain(t):
    return t.full_tensor() if isinstance(t, DTensor) else t


@pytest.fixture(scope="module")
def one_mesh():
    """A (1, 1) ("data", "model") mesh over a one-rank gloo group,
    destroyed after this file's tests."""
    mesh_lib.bring_up("gloo")
    try:
        yield mesh_lib.make_mesh((1, 1), ("data", "model"))
    finally:
        mesh_lib.tear_down()


@pytest.mark.parametrize("arch", FAMILIES)
def test_one_device_mesh_steps_equal_mesh_free(arch, one_mesh):
    cfg = _cfg(arch)
    opt_cfg = adamw.AdamWConfig(warmup_steps=1)
    batch = _batch(cfg)

    params = _params(cfg)
    state = adamw.init(params, opt_cfg)
    _, _, want = steps.make_train_step(cfg, opt_cfg, remat=False)(
        params, state, batch)

    dparams = _params(cfg)
    dstate = adamw.init(dparams, opt_cfg)
    dparams = sharding.distribute_tree(
        dparams, sharding.param_shardings(dparams, one_mesh), one_mesh)
    dstate = sharding.distribute_tree(
        dstate, sharding.param_shardings(dstate, one_mesh), one_mesh)
    _, _, got = steps.make_train_step(cfg, opt_cfg, remat=False,
                                      mesh=one_mesh)(dparams, dstate, batch)
    for k in ("loss", "grad_norm"):
        assert torch.equal(_plain(got[k]), want[k]), k
    for (path, p), d in zip(flatten_with_path(params), leaves(dparams)):
        assert isinstance(d, DTensor)
        assert torch.equal(_plain(d), p), path

    prefill = {k: v for k, v in batch.items() if k != "labels"}
    want = steps.make_prefill_step(cfg)(params, prefill)
    got = steps.make_prefill_step(cfg, mesh=one_mesh)(dparams, prefill)
    assert isinstance(got, DTensor) and torch.equal(_plain(got), want)

    if cfg.family == "vlm":      # decode feeds tokens only
        return
    serve = steps.make_serve_step(cfg)
    cache = M.init_cache(cfg, B, S, device="cpu")
    dcache = sharding.distribute_tree(
        M.init_cache(cfg, B, S, device="cpu"),
        sharding.cache_sharding(one_mesh, cache), one_mesh)
    sparams = sharding.distribute_tree(
        params, sharding.param_shardings(params, one_mesh, serve=True),
        one_mesh)
    tok = dtok = batch["tokens"][:, :1]
    for pos in range(2):
        tok, cache = serve(params, tok, cache, pos)
        dtok, dcache = serve(sparams, dtok, dcache, pos)
        assert torch.equal(_plain(dtok), tok), pos
    for c, d in zip(leaves(cache), leaves(dcache)):
        assert torch.equal(_plain(d), c)


def _decode_on_mesh(cfg, params, batch, mesh, length: int = 32,
                    positions=range(14, 19)) -> dict:
    """Greedy decode at ``positions`` into an empty cache of ``length``
    entries, with serve-sharded params and a ``cache_sharding`` cache
    (its sequence, the largest dim, over "model": the tokens' entries
    land on both of its shards) against the mesh-free decode: tokens,
    and the cache's largest difference."""
    serve = steps.make_serve_step(cfg)
    cache = M.init_cache(cfg, B, length, device="cpu")
    dcache = sharding.distribute_tree(
        M.init_cache(cfg, B, length, device="cpu"),
        sharding.cache_sharding(mesh, cache), mesh)
    sparams = sharding.distribute_tree(
        params, sharding.param_shardings(params, mesh, serve=True), mesh)
    tok = dtok = batch["tokens"][:, :1]
    equal = []
    for pos in positions:
        tok, cache = serve(params, tok, cache, pos)
        dtok, dcache = serve(sparams, dtok, dcache, pos)
        equal.append(bool(torch.equal(_plain(dtok), tok)))
    return {"equal": equal,
            "cache_err": max(float((_plain(d) - c).abs().max())
                             for c, d in zip(leaves(cache), leaves(dcache))),
            "cache": [repr(p) for p in leaves(dcache)[0].placements],
            "wk": [repr(p) for p in
                   sparams["layers"]["attn"]["wk"]["w"].placements]}


def _ops_on_mesh(mesh) -> dict:
    """The flash and scan ops' sharding rules with real values: inputs
    split by batch over "data" and by heads over "model", forward and
    backward (the scan's dA, dBm and dCm come back as partial sums)
    against the plain tensors; the largest difference relative to each
    output's largest entry."""
    rng = np.random.default_rng(3)
    f32 = lambda *s: torch.from_numpy(rng.standard_normal(s, np.float32))
    bh = [Shard(0), Shard(2)]
    cases = {
        "flash": (flash_ops.flash_attention, dict(causal=True),
                  [(f32(2, 16, 4, 16), bh), (f32(2, 16, 2, 16), bh),
                   (f32(2, 16, 2, 16), bh)], 1),
        "scan": (scan_ops.mamba_scan, dict(chunk=8),
                 [(f32(2, 16, 4, 8), bh),
                  (torch.nn.functional.softplus(f32(2, 16, 4)), bh),
                  (-torch.rand(4, generator=torch.Generator()
                               .manual_seed(3)) - 0.5,
                   [Replicate(), Shard(0)]),
                  (f32(2, 16, 8), [Shard(0), Replicate()]),
                  (f32(2, 16, 8), [Shard(0), Replicate()])], 2)}
    err = {}
    for name, (fn, kw, args, n_out) in cases.items():
        plain = [a.clone().requires_grad_() for a, _ in args]
        dist = [distribute_tensor(a, mesh, pl).requires_grad_()
                for a, pl in args]
        want, got = fn(*plain, **kw), fn(*dist, **kw)
        want = want if n_out > 1 else (want,)
        got = got if n_out > 1 else (got,)
        cot = [f32(*w.shape) for w in want]
        wg = torch.autograd.grad(want, plain, cot)
        gg = torch.autograd.grad(got, dist, [
            distribute_tensor(c, mesh, g.placements)
            for c, g in zip(cot, got)])
        err[name] = max(float((_plain(g) - w).abs().max() / w.abs().max())
                        for g, w in zip(list(got) + list(gg),
                                        list(want) + list(wg)))
        err[name + "_placements"] = [repr(p) for p in gg[2].placements]
    return err


def _four_ranks(rank: int, store: str, out: str) -> None:
    """One rank of the (2, 2) run; rank 0 writes what it found."""
    torch.set_num_threads(1)
    mesh_lib.bring_up("gloo", world_size=4, rank=rank, store_path=store)
    try:
        mesh = mesh_lib.make_mesh((2, 2), ("data", "model"))
        cfg = _cfg("stablelm-1.6b")
        opt_cfg = adamw.AdamWConfig(warmup_steps=1)
        batch = _batch(cfg, seed=1)
        params = _params(cfg)
        _, _, want = steps.make_train_step(cfg, opt_cfg)(
            params, adamw.init(params, opt_cfg), batch)
        dparams = _params(cfg)
        dstate = adamw.init(dparams, opt_cfg)
        shard = sharding.param_shardings(dparams, mesh)
        dparams = sharding.distribute_tree(dparams, shard, mesh)
        dstate = sharding.distribute_tree(
            dstate, sharding.param_shardings(dstate, mesh), mesh)
        both = {k: tuple(v.placements) for k, v in (
            ("wq", dparams["layers"]["attn"]["wq"]["w"]),
            ("mlp_wi", dparams["layers"]["mlp"]["wi"]["w"]),
            ("table", dparams["embed"]["table"]))}
        _, _, got = steps.make_train_step(cfg, opt_cfg, mesh=mesh)(
            dparams, dstate, batch)
        rel = {k: float(abs(_plain(got[k]) - want[k]) / abs(want[k]))
               for k in ("loss", "grad_norm")}
        _, g0 = steps.make_loss_and_grads(cfg)(_params(cfg), batch)
        noisy = [(g.abs() < 1e-7) & (g != 0) for g in leaves(g0)]
        param_err, noisy_err = 0.0, 0.0
        for p, d, n in zip(leaves(params), leaves(dparams), noisy):
            err = (_plain(d) - p).abs()
            param_err = max(param_err, float(
                torch.where(n, 0.0, err).max() / p.abs().max()))
            noisy_err = max(noisy_err, float(torch.where(n, err, 0.0)
                                             .max()))
        prefill = {k: v for k, v in batch.items() if k != "labels"}
        w_logits = steps.make_prefill_step(cfg)(params, prefill)
        g_logits = _plain(steps.make_prefill_step(cfg, mesh=mesh)(
            dparams, prefill))
        logit_err = float((g_logits - w_logits).abs().max()
                          / w_logits.abs().max())
        decode = _decode_on_mesh(cfg, params, batch, mesh)
        ops_err = _ops_on_mesh(mesh)
        if rank == 0:
            with open(out, "w") as f:
                json.dump({"rel": rel, "param_err": param_err,
                           "noisy": sum(int(n.sum()) for n in noisy),
                           "n_params": M.count_params(cfg),
                           "noisy_err": noisy_err, "lr": float(want["lr"]),
                           "logit_err": logit_err, "decode": decode,
                           "ops_err": ops_err,
                           "placements": {k: [repr(p) for p in v]
                                          for k, v in both.items()}}, f)
    finally:
        mesh_lib.tear_down()


def test_two_by_two_mesh_matches_mesh_free(tmp_path):
    out = tmp_path / "result.json"
    ctx = mp.start_processes(_four_ranks, args=(str(tmp_path / "store"),
                                                str(out)),
                             nprocs=4, join=False, start_method="spawn")
    deadline = time.monotonic() + 180
    while not ctx.join(timeout=2):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail("the 4-rank run took more than 180 s")
    res = json.loads(out.read_text())
    for k, v in res["placements"].items():   # sharded on both axes
        assert all(p.startswith("Shard") for p in v), (k, v)
    assert res["placements"]["wq"] == [repr(Shard(1)), repr(Shard(2))]
    assert res["placements"]["table"] == [repr(Shard(1)), repr(Shard(0))]
    assert res["rel"]["loss"] <= 1e-5 and res["rel"]["grad_norm"] <= 1e-5
    assert res["param_err"] <= 1e-5
    assert res["noisy"] <= 1e-3 * res["n_params"]
    assert res["noisy_err"] <= 2 * res["lr"]
    assert res["logit_err"] <= 1e-5
    dec = res["decode"]   # the sequence split over "model", heads too
    assert dec["cache"] == [repr(Shard(1)), repr(Shard(3))]
    assert dec["wk"][1] == repr(Shard(2))
    assert all(dec["equal"]) and dec["cache_err"] <= 1e-5
    assert res["ops_err"]["flash"] <= 1e-5
    assert res["ops_err"]["scan"] <= 1e-5
    # dA: partial over the batch's "data", split over "model" as the heads
    assert res["ops_err"]["scan_placements"] == ["Partial(sum)",
                                                 repr(Shard(0))]
