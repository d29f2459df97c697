"""Port parity of checkpointing and fault tolerance
(repro_torch/checkpoint/store.py, ft/preemption.py, ft/stragglers.py).

* The JAX store's own cases, ported: exact round trip (f32, i32, bf16),
  CRC corruption detected, no ``.tmp`` visible, pruning, the async
  writer (which snapshots the tree, since the port updates it in place).
* The on-disk format is shared: the same ``(params, AdamW state)`` with
  bf16 params written by both packages gives the same manifest (keys,
  shapes, dtype names, CRC32s); a port checkpoint restores exactly in
  JAX's ``store.restore`` and a JAX checkpoint in the port's.
* Restart: 10 steps uninterrupted against a restart from the step-6
  checkpoint give the same losses bit for bit (the port of
  ``tests/test_checkpoint_ft.py::TestRestartContinuity``); a preemption
  signal checkpoints and stops both packages' launchers after the same
  step.
* ``StragglerMonitor`` and ``PreemptionGuard`` behave as the JAX
  package's on the same step times and signals.
"""
import dataclasses
import json
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import store as jstore
from repro.configs import registry as jregistry
from repro.ft.preemption import PreemptionGuard as JPreemptionGuard
from repro.ft.stragglers import StragglerMonitor as JStragglerMonitor
from repro.launch import train as jtrain
from repro.models import model as JM
from repro.optim import adamw as jadamw
from repro_torch import convert
from repro_torch.checkpoint import store
from repro_torch.configs import registry
from repro_torch.ft.preemption import PreemptionGuard
from repro_torch.ft.stragglers import StragglerMonitor
from repro_torch.launch import train as T
from repro_torch.optim import adamw
from repro_torch.utils.pytree import flatten_with_path, leaves, unflatten


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"a": torch.from_numpy(
                rng.standard_normal((8, 16)).astype(np.float32)),
            "nested": {"b": torch.from_numpy(
                           rng.integers(0, 9, (4,)).astype(np.int32)),
                       "c": torch.from_numpy(rng.standard_normal((3, 3))
                                             .astype(np.float32))
                       .to(torch.bfloat16)}}


def _equal_trees(a, b):
    fa, fb = flatten_with_path(a), flatten_with_path(b)
    assert [p for p, _ in fa] == [p for p, _ in fb]
    for (_, x), (_, y) in zip(fa, fb):
        assert x.dtype == y.dtype and torch.equal(x, y)


class TestCheckpoint:
    def test_roundtrip_exact(self, tmp_path):
        t = _tree()
        store.save(t, tmp_path, step=7)
        restored, step = store.restore(t, tmp_path)
        assert step == 7
        _equal_trees(t, restored)

    def test_corruption_detected(self, tmp_path):
        t = _tree()
        d = store.save(t, tmp_path, step=1)
        manifest = json.loads((d / "manifest.proc0.json").read_text())
        victim = d / manifest["leaves"][0]["file"]
        arr = np.load(victim)
        arr.flat[0] += 1
        np.save(victim, arr)
        with pytest.raises(IOError, match="crc"):
            store.restore(t, tmp_path)

    def test_atomicity_no_tmp_visible(self, tmp_path):
        store.save(_tree(), tmp_path, step=3)
        assert not list(tmp_path.glob("*.tmp"))
        assert store.latest_step(tmp_path) == 3

    def test_prune_keeps_last_k(self, tmp_path):
        t = _tree()
        for s in range(5):
            store.save(t, tmp_path, step=s, keep=2)
        steps = sorted(int(p.name.split("_")[1])
                       for p in tmp_path.glob("step_*"))
        assert steps == [3, 4]

    def test_async_checkpointer_snapshots(self, tmp_path):
        ck = store.AsyncCheckpointer(tmp_path)
        t = _tree()
        want = _tree()
        ck.save(t, 11)
        t["a"].add_(1.0)            # training goes on updating in place
        ck.wait()
        restored, step = store.restore(t, tmp_path)
        assert step == 11
        _equal_trees(want, restored)

    def test_shape_mismatch_raises(self, tmp_path):
        store.save(_tree(), tmp_path, step=0)
        bad = _tree()
        bad["a"] = torch.zeros((8, 15))
        with pytest.raises(ValueError, match="shape"):
            store.restore(bad, tmp_path)


def _bf16_state():
    """A bf16 reduced granite-8b's params and AdamW state after one
    update, in both packages (the same values)."""
    jcfg = dataclasses.replace(
        jregistry.reduced(jregistry.get_arch("granite-8b")),
        dtype="bfloat16")
    cfg = dataclasses.replace(
        registry.reduced(registry.get_arch("granite-8b")), dtype="bfloat16")
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    opt = jadamw.AdamWConfig()
    grads = jax.tree_util.tree_map(lambda p: jnp.full_like(p, 0.01), jp)
    jp, jst, _ = jax.jit(lambda g, st, p: jadamw.update(g, st, p, opt))(
        grads, jadamw.init(jp, opt), jp)
    as_np = lambda t: jax.tree_util.tree_map(np.asarray, t)
    params = convert.model_params(as_np(jp), cfg, device="cpu")
    st = convert.adamw_state(as_np(jst), params, device="cpu")
    return (jp, jst), (params, st)


def _same_as_jax(port_tree, jax_tree):
    flat = flatten_with_path(port_tree)
    jflat = jax.tree_util.tree_flatten_with_path(jax_tree)[0]
    assert len(flat) == len(jflat)
    for (path, t), (_, a) in zip(flat, jflat):
        a = np.asarray(a)
        assert str(a.dtype) == str(t.dtype).replace("torch.", ""), path
        np.testing.assert_array_equal(t.float().numpy(),
                                      a.astype(np.float32), err_msg=path)


def test_manifests_equal_between_packages(tmp_path):
    jtree, tree = _bf16_state()
    _same_as_jax(tree, jtree)
    mj = json.loads((jstore.save(jtree, tmp_path / "j", step=1)
                     / "manifest.proc0.json").read_text())
    mt = json.loads((store.save(tree, tmp_path / "t", step=1)
                     / "manifest.proc0.json").read_text())
    assert mt == mj
    keys = {leaf["key"]: leaf["dtype"] for leaf in mt["leaves"]}
    assert keys["[0]/embed/table"] == "bfloat16"
    assert keys["[1]/m/layers/attn/wq/w"] == "float32"
    assert keys["[1]/step"] == "int32"


def test_port_checkpoint_restores_in_jax(tmp_path):
    jtree, tree = _bf16_state()
    store.save(tree, tmp_path, step=4)
    like = jax.tree_util.tree_map(jnp.zeros_like, jtree)
    restored, step = jstore.restore(like, tmp_path)
    assert step == 4
    _same_as_jax(tree, restored)


def test_jax_checkpoint_restores_in_port(tmp_path):
    jtree, tree = _bf16_state()
    jstore.save(jtree, tmp_path, step=9)
    like = unflatten(tree, [torch.zeros_like(x) for x in leaves(tree)])
    restored, step = store.restore(like, tmp_path)
    assert step == 9
    _same_as_jax(restored, jtree)
    _equal_trees(restored, tree)


def test_training_resumes_bit_identically(tmp_path):
    """A run interrupted at step 6 and restarted matches the
    uninterrupted run exactly (params, optimizer state and data are all
    restart-safe)."""
    kw = dict(arch="stablelm-1.6b", batch=2, seq=32,
              ckpt_dir=str(tmp_path), ckpt_every=6, device="cpu")
    full = T.train(n_steps=10, **kw)
    resumed = T.train(n_steps=10, restore=True, **kw)
    assert len(resumed) == 4 and resumed == full[6:]


class _FiredGuard(PreemptionGuard):
    """A guard whose signal has arrived before the first step ends."""

    def __enter__(self):
        self.fire()
        return super().__enter__()


class _JFiredGuard(JPreemptionGuard):
    def __enter__(self):
        self.fire()
        return super().__enter__()


def test_preemption_checkpoints_and_stops_like_jax(tmp_path, monkeypatch):
    """Both launchers, restored from one JAX step-0 checkpoint, see the
    signal during the first step: each checkpoints step 1 and stops."""
    monkeypatch.setattr(T, "PreemptionGuard", _FiredGuard)
    monkeypatch.setattr(jtrain, "PreemptionGuard", _JFiredGuard)
    jcfg = jregistry.reduced(jregistry.get_arch("granite-8b"))
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    opt = jadamw.AdamWConfig(total_steps=5, warmup_steps=1)
    for d in ("t", "j"):
        jstore.save((jp, jadamw.init(jp, opt)), tmp_path / d, step=0)
    kw = dict(arch="granite-8b", n_steps=5, batch=2, seq=16, restore=True)
    got = T.train(ckpt_dir=str(tmp_path / "t"), device="cpu", **kw)
    want = jtrain.train(ckpt_dir=str(tmp_path / "j"), **kw)
    assert len(got) == len(want) == 1
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert store.latest_step(tmp_path / "t") == 1
    assert jstore.latest_step(tmp_path / "j") == 1


def test_preemption_guard_matches_jax():
    before = signal.getsignal(signal.SIGTERM)
    for cls in (PreemptionGuard, JPreemptionGuard):
        with cls() as g:
            assert not g.preempted
            os.kill(os.getpid(), signal.SIGTERM)
            assert g.preempted
        assert signal.getsignal(signal.SIGTERM) is before
        with cls() as g:
            g.fire()
            assert g.preempted


@pytest.mark.parametrize("seed,slow_host", [(0, 3), (1, None), (2, 0)])
def test_straggler_monitor_matches_jax(seed, slow_host):
    rng = np.random.default_rng(seed)
    mon, jmon = StragglerMonitor(n_hosts=8), JStragglerMonitor(n_hosts=8)
    flagged = 0
    for i in range(40):
        times = 1.0 + 0.05 * rng.standard_normal(8)
        if slow_host is not None and i >= 25:
            times[slow_host] = 2.5
        rep, jrep = mon.observe(times), jmon.observe(times)
        np.testing.assert_array_equal(rep.flagged, jrep.flagged)
        np.testing.assert_array_equal(rep.slowdown, jrep.slowdown)
        assert rep.fleet_alarm == jrep.fleet_alarm
        flagged += int(rep.flagged.any())
    assert (flagged > 0) == (slow_host is not None)
