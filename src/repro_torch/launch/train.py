"""End-to-end training launcher, in torch.

The port of ``repro/launch/train.py`` for every model family: config
registry, synthetic data pipeline with
prefetch, the train step (gradient accumulation + AdamW with an f32
master copy), async checkpointing with restart in the JAX store's
format, preemption handling (SIGTERM -> checkpoint -> clean exit) and
straggler monitoring (ARMS EWMA/PHT on per-host step times).  On the
card, every attention layer runs on the hand-written flash attention
kernels and every mamba layer's SSD scan on the hand-written
``mamba_scan`` kernels, forward and backward.

Reduced configs by default; ``--full`` runs the published widths and
depth.  Weights are random, drawn from a ``torch.Generator`` on the
device seeded by ``seed``; the batches are the JAX package's, bit for
bit.  Batches reach the card through pinned memory without a stream
sync, and the loss is read on the host once a step.  The front ends the
configs stub are zeros made on the device (``stub_inputs``): a vlm's
``patch_embeds`` in f32, as the JAX launcher makes them, and an enc-dec
model's ``audio_embeds`` in the model's dtype.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-1.6b \\
      --full --steps 6 --batch 2 --seq 4096
  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-370m \\
      --full --steps 6 --batch 2 --seq 4096
  PYTHONPATH=src python -m repro_torch.launch.train --arch zamba2-1.2b \\
      --full --steps 6 --batch 1 --seq 4096
  PYTHONPATH=src python -m repro_torch.launch.train --arch whisper-small \\
      --full --steps 6 --batch 2 --seq 448
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.checkpoint import store
from repro_torch.configs import registry
from repro_torch.data.pipeline import Prefetcher, SyntheticLM
from repro_torch.ft.preemption import PreemptionGuard
from repro_torch.ft.stragglers import StragglerMonitor
from repro_torch.launch import steps as steps_lib
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.optim import adamw
from repro_torch.utils.device import resolve_device


def setup(arch: str, n_steps: int, full: bool = False, seed: int = 0,
          device=None):
    """-> (cfg, opt_cfg, params, opt_state) of a fresh run on ``device``
    (``None``: the card)."""
    device = resolve_device(device)
    cfg = registry.get_arch(arch)
    if not full:
        cfg = registry.reduced(cfg)
    opt_cfg = adamw.AdamWConfig(total_steps=max(n_steps, 2),
                                warmup_steps=max(n_steps // 10, 1))
    gen = torch.Generator(device=device).manual_seed(seed)
    params = M.init_params(cfg, gen, device)
    return cfg, opt_cfg, params, adamw.init(params, opt_cfg)


def to_device(batch_np: dict, device) -> dict:
    """Host batch -> device tensors; to the card through pinned memory,
    so the copy does not synchronise the stream."""
    out = {}
    for k, v in batch_np.items():
        t = torch.from_numpy(v)
        out[k] = t.pin_memory().to(device, non_blocking=True) \
            if device.type == "cuda" else t
    return out


def stub_inputs(cfg, batch: int, device) -> dict:
    """The inputs of a front end the model stubs, zeros on ``device``: a
    vlm's ``patch_embeds`` ``[batch, n_patches, d_model]`` in f32, as the
    JAX launcher makes them (the model casts them to its dtype); an
    enc-dec model's ``audio_embeds`` ``[batch, enc_seq, d_model]`` in the
    model's dtype (``L.dtype_of(cfg)``).  The JAX launcher makes the
    latter f32 too: at an f32 config the two are the same stub, and at a
    bf16 one (whisper-small's) the JAX reference cannot trace its own f32
    stub (ROADMAP queue 3) and traces with this one, while in eager torch
    an f32 stub would run the encoder, and through the cross K/V the
    decoder, in f32.  None for the other families."""
    if cfg.family == "vlm":
        return {"patch_embeds": torch.zeros(
            (batch, cfg.n_patches, cfg.d_model), dtype=torch.float32,
            device=device)}
    if cfg.family == "encdec":
        return {"audio_embeds": torch.zeros(
            (batch, cfg.enc_seq, cfg.d_model), dtype=L.dtype_of(cfg),
            device=device)}
    return {}


def _n_hosts() -> int:
    dist = torch.distributed
    return dist.get_world_size() if dist.is_available() \
        and dist.is_initialized() else 1


def train(arch: str, n_steps: int, batch: int, seq: int, ckpt_dir=None,
          restore: bool = False, full: bool = False, grad_accum: int = 1,
          ckpt_every: int = 20, log_every: int = 5, seed: int = 0,
          device=None):
    """Train ``n_steps`` steps (from the latest checkpoint with
    ``restore``) and return the loss of each step run."""
    device = resolve_device(device)
    t0 = time.time()
    cfg, opt_cfg, params, opt_state = setup(arch, n_steps, full, seed,
                                            device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    print(f"[train] {cfg.name}: {cfg.n_params:,} params on {device}, "
          f"init {time.time() - t0:.3f}s", flush=True)
    start_step = 0
    ckpt = store.AsyncCheckpointer(ckpt_dir) if ckpt_dir else None
    if restore and ckpt_dir and store.latest_step(ckpt_dir) is not None:
        (params, opt_state), start_step = store.restore(
            (params, opt_state), ckpt_dir)
        print(f"[train] restored step {start_step}")

    data = SyntheticLM(cfg.vocab_size_raw, seq, batch, seed=seed)
    prefetch = Prefetcher(data, start_step=start_step)
    step_fn = steps_lib.make_train_step(cfg, opt_cfg, grad_accum=grad_accum,
                                        remat=False)
    n_hosts = _n_hosts()
    monitor = StragglerMonitor(n_hosts=n_hosts)

    losses = []
    try:
        with PreemptionGuard() as guard:
            for i in range(start_step, n_steps):
                step_t0 = time.time()
                step_idx, batch_np = prefetch.next()
                if step_idx != i:
                    raise RuntimeError(f"prefetch gave step {step_idx}, "
                                       f"expected {i}")
                params, opt_state, metrics = step_fn(
                    params, opt_state, {**to_device(batch_np, device),
                                        **stub_inputs(cfg, batch, device)})
                loss = float(metrics["loss"])
                losses.append(loss)
                dt = time.time() - step_t0
                rep = monitor.observe(np.full(n_hosts, dt))
                if rep.flagged.any():
                    print(f"[train] straggler hosts: "
                          f"{np.flatnonzero(rep.flagged).tolist()}")
                if i % log_every == 0:
                    tok_s = batch * seq / max(dt, 1e-9)
                    print(f"[train] step {i} loss={loss:.4f} "
                          f"gnorm={float(metrics['grad_norm']):.3f} "
                          f"{tok_s:,.0f} tok/s", flush=True)
                if ckpt and (i + 1) % ckpt_every == 0:
                    ckpt.save((params, opt_state), i + 1)
                if guard.preempted:
                    print("[train] preemption signal: checkpoint + exit")
                    if ckpt:
                        ckpt.save((params, opt_state), i + 1)
                    break
        if ckpt:
            ckpt.wait()
    finally:
        prefetch.close()
    return losses


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--restore", action="store_true")
    ap.add_argument("--full", action="store_true")
    args = ap.parse_args()
    losses = train(args.arch, args.steps, args.batch, args.seq,
                   ckpt_dir=args.ckpt_dir, restore=args.restore,
                   full=args.full, grad_accum=args.grad_accum)
    print(f"[train] final loss {losses[-1]:.4f} "
          f"(from {losses[0]:.4f} over {len(losses)} steps)")


if __name__ == "__main__":
    main()
