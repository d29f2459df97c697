#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port of ARMS on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Run from the repository root on a machine with a CUDA card and ``nvcc``.
It imports the port only (``src/repro_torch``), never JAX, and:

  1. builds the CUDA kernels from ``src/`` (one ``nvcc`` per source, all
     started together) and prints the card's name and power limit and
     the build time;
  2. kernel phase: holds each kernel against its plain PyTorch version on
     the card at the main path's shapes and times both on the device
     (CUDA graphs of repeated calls over inputs larger than L2, CUDA
     events), beside the least time the card could take for the same
     bytes and operations and, where one exists, a PyTorch library call
     computing the same function: the interval-step kernels at 16 lanes,
     n = 65,536 pages, k = 8,192, 2 and 3 tiers, 64-entry plans (the top-k
     mask, the migrations and the accounting also at ``arms_sim``'s one
     lane, and the top-k mask at the synthesis oracle's nine rows, lines
     of their own; the migrations also at TPP's plan widths,
     12 promotions and 8,192 demotions, and the oracle's, 8,192 each,
     lines of their own); the migration fire (one launch a fire) and
     paged attention at the serving paths' full-width shapes (fused K/V
     pools of 8 fast + 32 home pages of 4 tokens x 8 sequences x 8 KV
     heads x 128; a fire of 8 demotions + 8 promotions, every promotion
     into a slot the fire vacates, and one of 4 + 4 into other slots;
     attention at pos = 127 over 32 pages with 256 folded query heads;
     both held, not timed, at zamba2-1.2b's fold, 32 KV heads of 64, and
     at llama4-scout's, 40 query heads over 8 of 128, at
     deepseek-v2-236b's, 128 KV heads of 128, and at whisper-small's, 12
     KV heads of 64); the
     fire at deepseek-v2-236b's expert slab rows (``wi`` [5120, 3072]
     bf16, 31.5 MB a row, and ``wo`` [1536, 5120], 15.7 MB, in ONE
     launch), 8 promotions into fused [8 + 16]-row pools; the fire with
     its home pools pinned on the host (``host_offload.to_slow_tier(...,
     "memkind")``), at the serving fold and for 8 ``wi`` promotions from a
     16-row home, bound by the host link's rate (PCIe Gen5 x16, 64 GB/s
     each way) beside one ``copy_`` of the same bytes from pinned memory;
     the single-row fused score update at n = 2^20 and 2^24 pages (on no
     path of the main path: its launches here must be nonzero, its JSON
     row's are 0); flash attention forward and backward (bf16 on the
     tensor cores, f32 on the CUDA cores) at the training path's shape
     (B = 2, S = 4,096, 32 heads of 64, bf16, causal), at granite-8b's
     GQA heads (32 over 8, dh 128, S = 2,048), windowed (1,024), and in
     f32 (B = 1, S = 1,024, 8 heads over 2), forward and backward at
     deepseek-v2-236b's MLA prefill shape (B = 2, S = 4,096, 128 heads,
     q/k width 192, v width 128), and the forward alone at the prefill
     shapes of llava-next-mistral-7b (B = 2, S = 576 + 4,096, 32 heads
     over 8 of 128) and llama4-scout (B = 2, S = 4,096, 40 heads over 8 of
     128, window 8,192) and at whisper-small's encoder (B = 2, 1,500
     frames, 12 heads of 64, non-causal), each held to the plain version
     computed in f32 from the same inputs (the backward's lines also time
     SDPA's backward alone, its forward outside the timed region; SDPA
     under its fused backends only, and where none takes a row's shapes
     the line says so); the Mamba2 scan forward and backward in f32 at the training
     paths' shapes (B = 2, S = 4,096, chunk 64: mamba2-370m's 32 heads of
     64, N = 128, and zamba2-1.2b's 64 heads of 64, N = 64),
     with the device time of each pass of one forward and one backward by
     kernel name (``torch.profiler``), and at reduced mamba2-370m's, held
     to the plain version in f32; and the interval-step kernels at every
     cluster size their choosers pick for 1 to 216 lanes of 65,536 pages
     (the tuning study's widest pass; lines of their own, not timed),
     and timed at the study's 216 lanes (TPP's plans at its 144), and one
     lane of the accounting kernel embedded in batches of 1, 9, 21, 168
     and 216 lanes, bit for bit the same (2 and 3 tiers);
  3. main path, fifty-two paths, each with every launch count set to 0 just
     before it and read just after (each kernel of the path must have
     been launched, and ``migrate`` exactly once a fire of a tiered pool
     with buffers to move): ``sweep_arms_configs`` over a 16-lane
     ``alpha_s x noise_z`` grid on ``pmem-large`` at n = 65,536,
     k = 8,192, T = 1,024 (cut from 2,048) with the streaming
     reduction; ``arms_sim`` on the 3-tier ``dram-cxl-pmem`` at T = 512
     (cut from 1,024), on a GUPS-like trace made with numpy from
     ``--seed``; then the other policy families at the same width on the
     first T = 128 (cut from 256) intervals of that trace and CRN
     field: ``sweep_policy_configs`` over 16-lane knob grids of HeMem,
     Memtis and TPP on ``pmem-large`` (binary route: ``tier_migrate`` and
     ``interval_account``) and of Jenga and TierBPF (16 lanes) and
     HybridTier (12) on ``dram-cxl-pmem`` (tier-targeted route:
     ``interval_account``), each sweep's first 64 intervals also under
     ``torch.profiler`` (busy share), and one ``simulate`` lane each of
     ARMS, HeMem,
     Memtis, TPP, all-slow and the oracle at their defaults on
     ``pmem-large``, each exec time over all-slow's (the paper's Fig. 1
     normalisation), and of HybridTier, Jenga and TierBPF on
     ``dram-cxl-pmem``; then the numpy reference engine on the same trace
     and field: ``engine.run`` of ARMS's hand-tuned ``ARMSPolicy``, of
     ARMS through ``LegacyPolicyAdapter`` and of the other eight families
     through theirs (binary ones on ``pmem-large``, tier-native ones on
     ``dram-cxl-pmem``), each held to its family's scan lane (counts and
     both integer timelines equal, exec time within 1e-4 relative), with
     its intervals/s and host ms an interval; then the trace-synthesis
     path at the same width,
     T = 128 (cut from 1,024), the paper's nine workloads synthesized
     on the card:
     ``sweep_workload_configs`` of four ARMS configs over the nine (36
     lanes; its first 64 intervals under the profiler),
     ``sweep_workloads`` of the nine for ARMS, all-slow and the oracle at
     their defaults (each exec time over all-slow's, per workload; HeMem,
     Memtis and TPP at theirs are the tuning study's default rows), the
     adversarial scenario suite under
     ARMS (7 lanes) and ``sweep_seeds`` of ARMS over 16 seeds on the
     first 128 intervals of the trace (PRNG sampling), with the device
     time of each kind of threefry draw; then the paper's tuning study:
     ``tuning.tune`` of HeMem (24 configs), Memtis (20) and TPP (16) over
     the nine workloads at the same width and T, one pass of 9 x budget
     lanes each (the first 64 intervals of each under the profiler, the
     peak device memory), per workload the best tuned and default exec
     time over all-slow's and untuned ARMS over the best tuned; an ASHA
     search of HeMem's 24 over the nine, ARMS's CE search on the
     ``"pre"`` path and a HeMem transfer matrix over ``pmem-large`` and
     ``dram-cxl-pmem``, both on the trace's first 128 intervals; then the
     paper's robustness leaderboard (T = 128, cut from 1,024): ONE
     ``experiment.sweep`` of oracle,
     ARMS, HeMem, Memtis, TPP, HybridTier, Jenga and TierBPF over the
     seven scenarios of ``scenarios.suite`` on ``pmem-large``,
     ``cxl-1hop`` and ``dram-cxl-pmem`` at the same width (168 lanes),
     which must run as one union pass of the eight families, with its
     rate, peak device memory, the busy share of its first 64 intervals
     and each policy's worst and mean slowdown over the oracle and its
     thrash; every
     cluster configuration launched so far at 65,536 pages must be one the
     kernel phase held; then ``launch.serve.serve`` decoding 128 greedy
     tokens (cut from 512) at batch 8 of granite-8b at its full width and
     depth (36 layers, d_model 4,096, bf16, random weights from the seed,
     made once and passed to every serve run) with layer 0's KV pages
     (32 of 4 tokens, 8 fast) tiered by ARMS and ``capture=True`` (the
     trace held to the rows it served: one interval a 4 tokens, each
     holding 4 x batch x heads of attention mass); sparse attention on
     its final paged KV against full paged attention (every head's gap
     within twice its skipped mass times max |v|); ``serve`` of the other
     eight families the same way, each under PyTorch's sync debug mode (tok/s,
     promotions/demotions, thrash, modeled slowdown, host syncs); the
     expert tier of deepseek-v2-236b's 160 routed experts of one MoE
     layer (47.2 MB bf16 slabs, 32 fast, ARMS; 256 steps of top-6 router
     load over 8 x 512 tokens, Zipf(1.1) over a seeded permutation,
     numpy from the seed), its ``effective_weights`` bit for bit the home
     slabs, and the embedding tier of llama4-scout's table (202,048 x
     5,120 bf16, 790 blocks of 256 rows, 79 fast; 256 lookups of 8 x
     4,096 Zipf(1.1) ids), steps/s, lookups/s, hit fraction and peak
     memory; then ``launch.train.train``
     taking 6 AdamW steps of stablelm-1.6b at its full width and depth
     (24 layers, d_model 2,048, bf16, random weights from the seed) at
     batch 2 x 4,096 tokens (losses finite; the first batch's loss
     through the kernels within 1e-6 of the run's first loss and within
     1e-2 of the loss with the plain attention); ``torch.profiler``
     windows give the device busy share and device time by kernel (the
     twelve largest and each of the port's) of the sweep, of 16 serving
     tokens (with the device ms a token; 32 tokens under CUDA events
     before it) and of one training step, CUDA
     events split a serving token into model decode and tiered layer and
     a training step into forward, backward and optimizer; then the
     launch layer's mesh paths (``mesh_paths``) on a (1, 1) ("data",
     "model") DTensor mesh over a one-rank NCCL process group: the train
     phase's first two steps again with params and AdamW state
     distributed by ``param_shardings`` through ``make_train_step(...,
     mesh=mesh)``, each step's loss and grad norm within 1e-6 relative of
     the train phase's own and the params after them within 1e-6 of each
     leaf's largest entry (bit for bit expected), a ``make_prefill_step(
     ..., mesh=mesh)`` whose logits are within 1e-6 of the mesh-free
     prefill's, and 8 greedy tokens of granite-8b at full width (batch 8)
     through ``make_serve_step`` on DTensor params (``serve=True``) and
     cache (``cache_sharding``) equal to the mesh-free decode's, each way's
     tok/s printed; then
     mamba2-370m at its full width and depth (48 layers, d_model 1,024,
     bf16 with f32 ``A_log``/``D``/``dt_bias``, random weights from the
     seed): ``launch.train.train`` for 6 AdamW steps at batch 2 x 4,096
     (both scan kernels; the same loss checks against the plain scan, the
     same step split), ``make_prefill_step`` at batch 2 x 4,096 (the
     forward kernel) and ``make_serve_step`` decoding 128 greedy tokens at
     batch 8 from ``init_cache``; and, in f32, the prefill logits over 128
     tokens through the kernel against the recurrent decode's, token by
     token (within 1e-2 of the largest logit); then the other model
     families at full width (random weights from the seed):
     zamba2-1.2b (hybrid: 38 mamba layers, 6 groups of 6 each followed by
     ONE shared attention block, and a tail of 2; d_model 2,048, bf16)
     through ``launch.train.train`` for 6 AdamW steps at
     ``HYBRID_BATCH`` = 1 x 4,096 (both flash and both scan kernels; the same
     loss checks against the plain scan, the same step split), then
     ``make_prefill_step`` at batch 2 x 4,096 and the ARMS serve;
     llava-next-mistral-7b (vlm, 32 layers, d_model 4,096): prefill of 576
     patch embeddings drawn with numpy from the seed before 4,096 tokens
     at batch 2, and the ARMS serve; llama4-scout (MoE) at its published
     widths cut to one dense + MoE super-layer (``MOE_LAYERS`` = 2: 16
     experts top-1 and a shared expert, 40 query heads over 8, window
     8,192, vocab 202,048): the same prefill and serve;
     deepseek-v2-236b (MLA) at its published widths cut to its dense
     layer 0 + one MoE layer (``MLA_LAYERS`` = 2: 160 experts top-6 and 2
     shared, 128 heads, q/k 128 + 64, v 128, kv_lora 512): the same
     prefill and serve; whisper-small (enc-dec, 12 + 12 layers, d_model
     768) through ``launch.train.train`` for 6 AdamW steps at batch 2 x
     448 tokens beside 1,500 zero stub frames (both flash kernels), then
     the prefill over frames drawn with numpy from the seed and the serve;
     each serve at batch 8, 128 tokens, pages of 4 (granite-8b's), each
     prefill also under the profiler, each serve with its breakdown over
     8 + 8 tokens;
     the card's SM clock (``nvidia-smi``) is printed just before and just
     after each train and prefill phase;
  4. whole-path checks: the scan-engine entry points on the card and on
     the CPU at n = 4,096, T = 256, 4 lanes, on both machines (counts
     exact, exec_time within 1e-4 relative), for ARMS and for each other
     policy family (4 lanes of its grid, k = 1,536), and on the card
     ``tier_shim=True`` bit for bit the hop-chain route for the six binary
     families; ``engine.run`` of the ten reference-engine policies on the
     card and on the CPU at n = 4,096, T = 96 (counts and timelines
     exact); the threefry keys, splits, rows and permutations on the
     card and on the CPU (bit for bit, n up to 65,536), a synthesized
     4-workload x 2-config ARMS sweep at n = 4,096, T = 256 on both
     (counts exact, exec_time within 1e-4 relative), and on the card a
     synthesized run bit for bit the replay of its materialized trace with
     the synthesized noise rows; a grid, an ASHA and a CE search over three
     named workloads and a two-seed synthesized sweep over a mixed 2/3-tier
     panel (rankings, survivors and round records equal); the robustness
     board's union pass at full width and T = 256 bit for bit its grouped
     passes, at n = 4,096 card == CPU, and there padded to a multiple of
     5 lanes on a mesh of 1 bit for bit the plain pass; the serving loop
     at reduced granite-8b (48 tokens, batch 2, pages of 8) under each of
     the nine registry families on the card and on the CPU with the same
     weights and streams (plans, residency, slots and
     tokens exact; attention mass, fast-mass share and pools within 1e-5);
     three train steps of reduced stablelm-1.6b, granite-8b,
     mamba2-370m, zamba2-1.2b, llava-next-mistral-7b (its zero patch
     stub), llama4-scout, deepseek-v2-236b and whisper-small (its zero
     frame stub) (f32, batch 2, seq 40) on the card and on the CPU from
     the same weights (loss and grad norm within 1e-5 relative, params
     within 1e-5 of their largest entry, plus 1e-2 of the summed lr for
     mamba2-370m and 5e-2 for zamba2-1.2b and deepseek-v2-236b:
     ``TRAIN_CHECKS``), a restart from a checkpoint on the card
     against the uninterrupted run, 16 decode steps of reduced
     mamba2-370m, zamba2-1.2b, deepseek-v2-236b and whisper-small on the
     card and on the CPU (tokens exact), and gradient compression (bf16,
     and int8 with error feedback over 3 steps) of one train step's
     gradients of reduced deepseek-v2-236b bit for bit card == CPU;
  5. prints the ``kernels`` JSON line, the card line and, last, the
     ``{"ok": true, ...}`` line.

Any failed check raises, so the script exits non-zero and prints no
result line.  Without a CUDA card it exits non-zero at once.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import re
import subprocess
import sys
import time
import types
import warnings
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch
from torch.distributed.tensor import DTensor

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.kernels import _backend  # noqa: E402
from repro_torch.kernels.interval_step import kernel, ops, ref  # noqa: E402
from repro_torch.kernels.migrate import kernel as mkernel  # noqa: E402
from repro_torch.kernels.migrate import ref as mref  # noqa: E402
from repro_torch.kernels.paged_attention import (  # noqa: E402
    kernel as pkernel)
from repro_torch.kernels.paged_attention import ref as pref  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    kernel as fkernel)
from repro_torch.kernels.flash_attention import ops as fops  # noqa: E402
from repro_torch.kernels.flash_attention import ref as fref  # noqa: E402
from repro_torch.kernels.mamba_scan import kernel as skernel  # noqa: E402
from repro_torch.kernels.mamba_scan import ops as sops  # noqa: E402
from repro_torch.kernels.mamba_scan import ref as sref  # noqa: E402
from repro_torch.kernels.score_update import (  # noqa: E402
    kernel as ukernel)
from repro_torch.baselines import (hemem, hybridtier, jenga,  # noqa: E402
                                   memtis, protocol, static, tierbpf, tpp)
from repro_torch.baselines.arms_policy import (ARMSPolicy,  # noqa: E402
                                               ARMSSpec)
from repro_torch.configs import registry  # noqa: E402
from repro_torch.data.pipeline import SyntheticLM  # noqa: E402
from repro_torch.launch import serve, sharding, steps, train  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import mamba2 as Mb  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.layers import dtype_of  # noqa: E402
from repro_torch.ft import compression  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.simulator import (engine, experiment,  # noqa: E402
                                   machine_spec, machines, scan_engine,
                                   scenarios, search, tuning, workload_spec)
from repro_torch.tiering import embedding_tiering as ET  # noqa: E402
from repro_torch.tiering import expert_tiering as XT  # noqa: E402
from repro_torch.tiering import host_offload as HO  # noqa: E402
from repro_torch.tiering import paged_kv as PK  # noqa: E402
from repro_torch.tiering import tiered_pool as TP  # noqa: E402
from repro_torch.tiering.sparse_attention import (  # noqa: E402
    sparse_attention_step)
from repro_torch.simulator.engine import SimResult  # noqa: E402
from repro_torch.simulator.sampling import (  # noqa: E402
    synth_noise_field, uniform_field)
from repro_torch.utils import prng  # noqa: E402
from repro_torch.utils.pytree import (flatten_with_path, leaves,  # noqa: E402
                                      map_leaves)
from repro_torch.utils.pytree import take_lanes, unflatten  # noqa: E402

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
# the host link each way: PCIe Gen5 x16, 128 GB/s both ways (H100 SXM
# data sheet)
PCIE_BYTES_PER_S = 64e9
L2_BYTES = 50 * 2 ** 20        # H100 L2 cache
F32_OPS_PER_S = 67e12          # H100 SXM f32 outside the tensor cores
BF16_OPS_PER_S = 989e12        # H100 SXM bf16 tensor cores, dense
# T: the ARMS sweep's intervals, cut from 4,096 with the SSM decode's
# tokens (256 -> 128) to pay for the robustness board, then from 2,048
# with the serve breakdown's windows (64 + 32 -> 32 + 16 tokens) for the
# reference engine, the other families' serving and the tiers: under 700 s
B, N, K, T = 16, 65536, 8192, 1024
PLAN = 64                      # ARMSConfig.bs_max: promote/demote widths
# kernel -> (its CUDA source, the TPU kernel it replaces as file:line)
ROUTES = {
    "ewma_update": ("interval_step", "interval_step/kernel.py:332"),
    "topk_mask": ("interval_step", "interval_step/kernel.py:87"),
    "tier_migrate": ("interval_step", "interval_step/kernel.py:198"),
    "interval_account": ("interval_step", "interval_step/kernel.py:292"),
    "migrate": ("migrate", "migrate/kernel.py:38"),
    "paged_attention": ("paged_attention", "paged_attention/kernel.py:69"),
    "flash_attention_fwd": ("flash_attention", "flash_attention/kernel.py:73"),
    "flash_attention_bwd": ("flash_attention", "flash_attention/kernel.py:73"),
    "mamba_scan_fwd": ("mamba_scan", "mamba_scan/kernel.py:75"),
    "mamba_scan_bwd": ("mamba_scan", "mamba_scan/kernel.py:75"),
    "score_update": ("interval_step", "score_update/kernel.py:37"),
}
KERNELS = tuple(ROUTES)
BUILDS = (kernel.SOURCE, mkernel.SOURCE, pkernel.SOURCE, fkernel.SOURCE,
          skernel.SOURCE)


def card_line(query: str = "name,power.limit") -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def clocked(label: str, run, path_kernels):
    """``counted`` with the card's SM clock printed just before and just
    after the phase (a slow phase on a card whose clock fell says so)."""
    print(f"clock before {label}: sm {card_line('clocks.sm')}", flush=True)
    out = counted(label, run, path_kernels)
    print(f"clock after {label}: sm {card_line('clocks.sm')}", flush=True)
    return out


def cuda_ms(fn, sets, reps: int = 24) -> float:
    """Device time of one call.  ``reps`` calls, cycling through input
    ``sets`` whose bytes together exceed the L2 cache, are captured in a
    CUDA graph and replayed between CUDA events, so neither the host's
    launch overhead nor a warm L2 is counted; median of 5 replays."""
    fn(*sets[0])
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(*sets[0])
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(reps):
            fn(*sets[i % len(sets)])
    graph.replay()
    times = []
    for _ in range(5):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return float(np.median(times))


def copies(args, bytes_: int):
    """Input sets for ``cuda_ms``: ``args`` and clones of it, together at
    least twice the L2 cache; a row shared by all lanes (stride 0) stays
    shared in every clone."""
    def clone(a):
        if not isinstance(a, torch.Tensor):
            return a
        if a.dim() == 2 and a.stride(0) == 0:
            return a[0].clone()[None].expand(a.shape)
        return pinned_copy(a) if a.is_pinned() else a.clone()

    n = min(32, max(2, -(-2 * L2_BYTES // bytes_)))
    return [args] + [tuple(clone(a) for a in args) for _ in range(n - 1)]


def pinned_copy(x):
    """A copy of ``x`` in pinned host memory (``clone()`` of a pinned
    tensor is not pinned)."""
    out = torch.empty(x.shape, dtype=x.dtype, pin_memory=True).copy_(x)
    require(out.is_pinned(), "a pinned copy is not pinned")
    return out


def nbytes(*ts) -> int:
    """Bytes a function must move: each tensor once, a row shared by all
    lanes (stride 0) once."""
    total = 0
    for t in ts:
        rows = 1 if t.dim() == 2 and t.stride(0) == 0 else t.shape[0]
        total += rows * (t.numel() // max(t.shape[0], 1)) * t.element_size()
    return total


def bound(bytes_: int, ops: int, ops_per_s: float = F32_OPS_PER_S,
          bytes_per_s: float = HBM_BYTES_PER_S):
    t_bytes = bytes_ / bytes_per_s * 1e3
    t_ops = ops / ops_per_s * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def max_err(got, want) -> float:
    return max(float((g.double() - w.double()).abs().max())
               for g, w in zip(got, want))


#: the script's start (``time.time()`` at the build's start; ``stamp``)
T0 = [time.time()]


def stamp(label: str):
    """Print how far into the script a phase ended (its wall is the
    difference from the stamp before it)."""
    print(f"{label}: done at {time.time() - T0[0]:.1f}s", flush=True)


def require(cond: bool, what: str):
    if not cond:
        raise AssertionError(what)


# ------------------------------------------------------------ kernel phase
def make_entry(rows: dict):
    """-> ``entry``, which holds a kernel to its plain version, times both
    (and a library call) and keeps the first line of each kernel in
    ``rows`` (the JSON line's)."""

    def entry(name, shape, kern, plain, args, exact, bytes_, ops, lib=None,
              abs_tol=None, fresh=None, timed=True,
              bytes_per_s=HBM_BYTES_PER_S):
        """Not ``exact``: within 1e-6 relative, or with ``abs_tol``
        within it absolutely and relatively above 1.  ``fresh(args)``
        gives the inputs for each of kernel and plain where the function
        updates an input in place.  ``lib`` is a function of the same
        arguments or ``(function, prep)`` with ``prep(args)`` its
        arguments (made before timing).  ``timed=False`` holds the kernel
        to the plain version only (a cluster configuration's line).
        ``bytes_per_s``: the rate ``bytes_`` are bound by (the host link's
        for a pool in pinned host memory)."""
        as_tuple = lambda x: x if isinstance(x, tuple) else (x,)
        fresh = fresh or (lambda a: a)
        got, want = as_tuple(kern(*fresh(args))), as_tuple(plain(*fresh(args)))
        torch.cuda.synchronize()   # pinned outputs are written by the card
        err = max_err(got, want)
        if exact:
            require(err == 0.0, f"{name}: kernel differs from plain ({err})")
        else:
            floor, tol = (1e-30, 1e-6) if abs_tol is None else (1.0, abs_tol)
            rel = max(float(((g.double() - w.double()).abs()
                             / w.double().abs().clamp_min(floor)).max())
                      for g, w in zip(got, want))
            require(rel <= tol, f"{name}: error {rel} > {tol}")
        if not timed:
            print(f"kernel {name} ({shape}): max_abs_err={err} (held, not "
                  f"timed)", flush=True)
            return
        bms, by = bound(bytes_, ops, bytes_per_s=bytes_per_s)
        sets = copies(args, bytes_)
        ms, plain_ms = cuda_ms(kern, sets), cuda_ms(plain, sets)
        if lib is not None and not isinstance(lib, tuple):
            lib = (lib, lambda a: a)
        lib_ms = None if lib is None else cuda_ms(
            lib[0], [lib[1](a) for a in sets])
        print(f"kernel {name} ({shape}): max_abs_err={err} ms={ms:.5f} "
              f"plain_ms={plain_ms:.5f} library_ms={lib_ms} "
              f"bound_ms={bms:.5f}", flush=True)
        if name not in rows:   # the JSON line keeps the first (2-tier) shape
            src, tpu = ROUTES[name]
            rows[name] = dict(
                name=name, route="cuda",
                source=f"src/repro_torch/kernels/{src}/csrc/{src}.cu",
                replaces=f"src/repro/kernels/{tpu}", launches=0,
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, library_ms=lib_ms)

    return entry


def kernel_phase(dev, rng):
    rows = {}
    entry = make_entry(rows)
    f = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    # every lane count of the main path: the sweep's 16 lanes (the JSON
    # line's shape; also sweep_seeds'), arms_sim's one and the synthesis
    # paths' (each kernel picks its cluster size by lanes and pages)
    syn = syn_lanes()
    L = max((B,) + syn)
    # ewma_update: scores, per-lane params
    full = tuple(f(rng.random((L, N), dtype=np.float32)) for _ in range(3))
    full += (f(rng.random((L, 4), dtype=np.float32)),)
    for lanes in (B, 1) + syn:
        args = tuple(a[:lanes] for a in full)
        entry("ewma_update", f"B={lanes} n={N}", kernel.ewma_update,
              ref.ewma_score_update_ref, args, True,
              nbytes(*args) + 3 * 4 * lanes * N, 6 * lanes * N)
    del full

    # topk_mask: hotness scores with ties and signed zeros (at 9 and 7
    # lanes also the synthesis oracle's [W, n] workload rows)
    def library(x, k):
        m = torch.zeros(x.shape, dtype=torch.bool, device=dev)
        return m.scatter_(1, torch.topk(x, k, dim=1).indices, True)

    for lanes in (B, 1) + syn:
        x = f((rng.integers(-4, 2000, (lanes, N)) * 0.5).astype(np.float32))
        x[:, ::97] = -0.0
        entry("topk_mask", f"B={lanes} n={N} k={K}", kernel.topk_mask,
              ref.topk_mask_ref, (x, K), True, nbytes(x) + lanes * N,
              5 * lanes * N, library)

    for mname in ("pmem-large", "dram-cxl-pmem"):
        spec = machines.get(mname)
        R = spec.n_tiers
        # the sweeps' lanes; on the 3-tier machine arms_sim's single lane,
        # on the 2-tier one the synthesis paths' lanes
        lane_sets = (B, 1) if R == 3 else (B,) + syn
        _, caps = machine_spec.lane_stack([spec] * L, N, K, dev)
        # tier_migrate: plans honouring the unique-index contract
        tier = f(rng.integers(0, R, (L, N)).astype(np.int32))
        plans = np.full((2, L, PLAN), -1, np.int32)
        for b in range(L):
            perm = rng.permutation(N)[:2 * PLAN]
            plans[0, b] = perm[:PLAN]
            plans[1, b, :PLAN // 2] = perm[PLAN:PLAN + PLAN // 2]
        for lanes in lane_sets:
            args = tuple(a[:lanes] for a in (tier, f(plans[0]),
                                             f(plans[1]), caps))
            entry("tier_migrate", f"B={lanes} n={N} R={R} P=D={PLAN}",
                  kernel.tier_migrate, ref.tier_migrate_ref, args, True,
                  nbytes(*args) + nbytes(args[0]) + 2 * lanes * PLAN
                  + 8 * lanes * (R - 1), 4 * lanes * N)

        if R == 2:   # the sweeps' and the nine-workload family sweeps'
            for lanes in (B, syn[1]):
                wide_plan_rows(entry, f, rng, spec, lanes, dev)

        # interval_account, held to the plain version bit for bit (f64
        # sums rounded once, the same f32 epilogue): a materialized trace's
        # row shared by every lane (B 16 and 1), or a synthesized row a
        # lane (the synthesis paths)
        true = f((2e7 / N * rng.gamma(1.0, 1.0, N)).astype(np.float32))
        orc = ref.topk_mask_ref(true[None], K)[0]
        up = f(rng.integers(0, PLAN, (L, R - 1)).astype(np.float32))
        down = f(rng.integers(0, PLAN, (L, R - 1)).astype(np.float32))
        for lanes in lane_sets:
            m = machine_spec.lane_stack([spec] * lanes, N, K, dev)[0]
            if lanes in (B, 1):
                rows_, orcs = (x[None].expand(lanes, N) for x in (true, orc))
            else:
                rows_ = f((2e7 / N * rng.gamma(1.0, 1.0, (lanes, N)))
                          .astype(np.float32))
                orcs = ref.topk_mask_ref(rows_, K)
            args = (m, rows_, tier[:lanes], up[:lanes], down[:lanes], orcs,
                    K)
            entry("interval_account", f"B={lanes} n={N} R={R} k={K}",
                  ops.interval_account, ref.interval_account_ref, args, True,
                  nbytes(m.lat_ns, m.bw_read, m.bw_write, m.mlp, *args[1:6])
                  + 6 * lanes * 4, (2 * R + 1) * lanes * N)
    held = study_rows(entry, f, rng, dev, syn)
    account_lane_rows(f, rng, dev)
    serving_rows(entry, f, rng)
    slab_rows(entry, rng, dev)
    offload_rows(entry, rng, dev)
    score_rows(rows, entry, f, rng)
    flash_rows(rows, rng)
    mamba_rows(rows, rng)
    return rows, held


def syn_lanes() -> tuple:
    """Lane counts of the synthesis paths: the named sweep (configs x
    workloads), the nine-workload family sweeps and the scenario suite."""
    W = len(workload_spec.NAMED_WORKLOADS)
    return len(SYN_CONFIGS) * W, W, len(scenarios.suite(N, K))


# (label, P, D, valid promotions, valid demotions): TPP's plans (12
# promotions, demotions k wide) and the oracle's (both k wide), valid
# entries a prefix as the policies emit them
WIDE_PLANS = (("TPP", 12, K, 12, K // 4), ("oracle", K, K, K // 2, K // 2))


def wide_plan_rows(entry, f, rng, spec, lanes, dev, plans=WIDE_PLANS,
                   timed=True, tag=""):
    """``tier_migrate`` at the plan widths of TPP and the oracle (past the
    1,024 entries staged in shared memory), on a row whose tier 0 holds
    k - 1,024 pages, so that some promotions run."""
    _, caps = machine_spec.lane_stack([spec] * lanes, N, K, dev)
    R = spec.n_tiers
    for label, P, D, vp, vd in plans:
        tier = np.full((lanes, N), R - 1, np.int32)
        prom = np.full((lanes, P), -1, np.int32)
        dem = np.full((lanes, D), -1, np.int32)
        for b in range(lanes):
            perm = rng.permutation(N)
            tier[b, perm[:K - 1024]] = 0
            dem[b, :vd] = perm[:vd]                      # from tier 0
            prom[b, :vp] = perm[K:K + vp]                # from the bottom
        args = (f(tier), f(prom), f(dem), caps)
        entry("tier_migrate", f"B={lanes} n={N} R={R} P/D={P}/{D} "
              f"({label}){tag}", kernel.tier_migrate, ref.tier_migrate_ref,
              args, True, nbytes(*args) + nbytes(args[0]) + lanes * (P + D)
              + 8 * lanes * (R - 1), 4 * lanes * N, timed=timed)


# the interval-step kernels' cluster-size choosers, by the chooser's kind
CHOOSERS = {"topk": kernel.topk_cluster, "account": kernel.account_cluster,
            "migrate": kernel.migrate_cluster}
def topk_library(x, k):
    """``torch.topk`` + scatter: the library call of the top-k mask."""
    m = torch.zeros(x.shape, dtype=torch.bool, device=x.device)
    return m.scatter_(1, torch.topk(x, k, dim=1).indices, True)


def study_rows(entry, f, rng, dev, syn):
    """The interval-step kernels at every cluster configuration a lane
    count of the main path can select at N pages.  A kernel spreads a lane
    over a cluster whose size its chooser picks from the lane count (the
    most CTAs at which the card holds every lane's cluster at once), so
    the tuning study's 144-216 lanes and the search rungs' counts select
    sizes the lines above never held.  For each chooser, the smallest lane
    count of each size it picks over 1..``study_lanes()`` lanes is held to
    the plain version (not timed) unless a line above held that size; the
    migrations with ARMS's 64-entry plans (staged) and TPP's 12/8,192
    (streamed).  Then, timed, each of rows 1-4 at the study's widest lane
    count (HeMem's 216) and TPP's streamed plans at its 144.  -> the
    (chooser kind, cluster size) pairs held at N pages, which the main
    path's launches are checked against (``check_held_clusters``)."""
    Bmax = study_lanes()
    spec = machines.get("pmem-large")
    held = {(kind, choose(lanes, N, dev)) for kind, choose in CHOOSERS.items()
            for lanes in (B, 1) + syn}
    wide_held = {kernel.migrate_cluster(b, N, dev) for b in (B, syn[1])}
    reps = {kind: {} for kind in CHOOSERS}
    for lanes in range(1, Bmax + 1):
        for kind, choose in CHOOSERS.items():
            reps[kind].setdefault(choose(lanes, N, dev), lanes)
    print(f"kernel phase: cluster size -> fewest lanes picking it, at "
          f"n={N} over 1..{Bmax} lanes: {reps}", flush=True)

    def topk(lanes, tag, timed):
        x = f((rng.integers(-4, 2000, (lanes, N)) * 0.5).astype(np.float32))
        x[:, ::97] = -0.0
        entry("topk_mask", f"B={lanes} n={N} k={K}{tag}", kernel.topk_mask,
              ref.topk_mask_ref, (x, K), True, nbytes(x) + lanes * N,
              5 * lanes * N, topk_library, timed=timed)

    def account(lanes, tag, timed):
        # each lane its own synthesized row, as the study's lanes read them
        m = machine_spec.lane_stack([spec] * lanes, N, K, dev)[0]
        rows_ = f((2e7 / N * rng.gamma(1.0, 1.0, (lanes, N)))
                  .astype(np.float32))
        args = (m, rows_, f(rng.integers(0, 2, (lanes, N)).astype(np.int32)),
                f(rng.integers(0, PLAN, (lanes, 1)).astype(np.float32)),
                f(rng.integers(0, PLAN, (lanes, 1)).astype(np.float32)),
                ref.topk_mask_ref(rows_, K), K)
        entry("interval_account", f"B={lanes} n={N} R=2 k={K}{tag}",
              ops.interval_account, ref.interval_account_ref, args, True,
              nbytes(m.lat_ns, m.bw_read, m.bw_write, m.mlp, *args[1:6])
              + 6 * lanes * 4, 5 * lanes * N, timed=timed)

    def migrate(lanes, tag, timed):
        _, caps = machine_spec.lane_stack([spec] * lanes, N, K, dev)
        plans = np.full((2, lanes, PLAN), -1, np.int32)
        for b in range(lanes):
            perm = rng.permutation(N)[:2 * PLAN]
            plans[0, b] = perm[:PLAN]
            plans[1, b, :PLAN // 2] = perm[PLAN:PLAN + PLAN // 2]
        args = (f(rng.integers(0, 2, (lanes, N)).astype(np.int32)),
                f(plans[0]), f(plans[1]), caps)
        entry("tier_migrate", f"B={lanes} n={N} R=2 P=D={PLAN}{tag}",
              kernel.tier_migrate, ref.tier_migrate_ref, args, True,
              nbytes(*args) + nbytes(args[0]) + 2 * lanes * PLAN + 8 * lanes,
              4 * lanes * N, timed=timed)

    for kind, hold in (("topk", topk), ("account", account),
                       ("migrate", migrate)):
        for c, lanes in sorted(reps[kind].items()):
            tag = f" cluster={c}"
            if (kind, c) not in held:
                hold(lanes, tag, False)
                held.add((kind, c))
            if kind == "migrate" and c not in wide_held:
                wide_plan_rows(entry, f, rng, spec, lanes, dev,
                               WIDE_PLANS[:1], False, tag)
        study = lambda b: f" cluster={CHOOSERS[kind](b, N, dev)} (study)"
        hold(Bmax, study(Bmax), True)
    tpp_lanes = len(workload_spec.NAMED_WORKLOADS) * dict(TUNED)["tpp"]
    wide_plan_rows(entry, f, rng, spec, tpp_lanes, dev, WIDE_PLANS[:1], True,
                   f" cluster={kernel.migrate_cluster(tpp_lanes, N, dev)} "
                   f"(study)")
    full = tuple(f(rng.random((Bmax, N), dtype=np.float32))
                 for _ in range(3))
    args = full + (f(rng.random((Bmax, 4), dtype=np.float32)),)
    entry("ewma_update", f"B={Bmax} n={N} (study)", kernel.ewma_update,
          ref.ewma_score_update_ref, args, True,
          nbytes(*args) + 3 * 4 * Bmax * N, 6 * Bmax * N)
    torch.cuda.empty_cache()
    return held


# the lane counts a lane of the accounting kernel is held at: one lane, the
# nine-workload sweeps, a board family's grouped pass, the board and the
# study's widest pass
ACCOUNT_LANES = (1, 9, 21, 168, 216)


def account_lane_rows(f, rng, dev):
    """``interval_account``: one lane embedded in batches of 1, 9, 21, 168
    and 216 lanes (at the first, middle and last place; each batch at the
    cluster size its chooser picks), on 2- and 3-tier rows whose f64 sums
    are not exact (values over some 2^46), gives the same six f32 outputs
    bit for bit: each lane's row is summed in 16 fixed sub-slices, added
    in order.  The kernel's agreement with its plain version is the exact
    lines above."""
    Bmax = max(ACCOUNT_LANES)
    for mname in ("pmem-large", "dram-cxl-pmem"):
        spec = machines.get(mname)
        R = spec.n_tiers
        mach = machine_spec.lane_stack([spec] * Bmax, N, K, dev)[0]
        true = f(np.exp(rng.normal(0.0, 8.0, (Bmax, N))).astype(np.float32))
        args = (true, f(rng.integers(0, R, (Bmax, N)).astype(np.int32)),
                f(rng.integers(0, PLAN, (Bmax, R - 1)).astype(np.float32)),
                f(rng.integers(0, PLAN, (Bmax, R - 1)).astype(np.float32)),
                ref.topk_mask_ref(true, K))
        lane = 3
        others = [b for b in range(Bmax) if b != lane]

        def run(lanes, at):
            idx = others[:lanes - 1]
            idx = torch.tensor(idx[:at] + [lane] + idx[at:], device=dev)
            take = lambda x: x.index_select(0, idx).contiguous()
            out = ops.interval_account(take_lanes(mach, idx),
                                       *(take(a) for a in args), K)
            return torch.stack([o[at] for o in out]).cpu()

        want = run(1, 0)
        clusters = []
        for lanes in ACCOUNT_LANES:
            clusters.append(kernel.account_cluster(lanes, N, dev))
            for at in (0, lanes // 2, lanes - 1):
                got = run(lanes, at)
                require(torch.equal(got, want),
                        f"interval_account R={R}: lane bits at {lanes} "
                        f"lanes (place {at}) {got.tolist()} != "
                        f"{want.tolist()}")
        print(f"kernel interval_account lane bits (n={N} R={R} k={K}): one "
              f"lane equal bit for bit at {ACCOUNT_LANES} lanes (clusters "
              f"{clusters}), three places each", flush=True)


def check_held_clusters(label: str, held: set):
    """Every cluster configuration the interval-step kernels were launched
    at on N pages since ``main_path`` emptied ``_backend.clusters`` (a
    chooser fills it only where its kernel launches) is one the kernel
    phase held to the plain version (``held``, from ``study_rows``)."""
    kind = lambda fn: fn.removeprefix("arms_").removesuffix("_cluster")
    launched = [(kind(key[0]), key[1], c)
                for key, c in _backend.clusters.items()
                if kind(key[0]) in CHOOSERS and key[2] == N]
    require(launched, f"{label}: no interval-step launch at n={N}")
    seen = {(kd, c) for kd, _, c in launched}
    missing = sorted(seen - held)
    require(not missing, f"{label}: launched at cluster configurations the "
            f"kernel phase never held: {missing}")
    lanes = {kd: sorted(b for k2, b, _ in launched if k2 == kd)
             for kd in CHOOSERS}
    print(f"{label}: the interval-step kernels launched at n={N} on lanes "
          f"{lanes}, at cluster configurations {sorted(seen)}, each held "
          f"in the kernel phase", flush=True)


# score_update at benchmarks/framework.py's size and at framework scale
# ("millions of pages", score_update/kernel.py:3-5)
SCORE_PAGES = (2 ** 20, 2 ** 24)


def score_update_plain(ewma_s, ewma_l, counts, params):
    """The plain version: one lane of ``ewma_score_update_ref``."""
    return tuple(o[0] for o in ref.ewma_score_update_ref(
        ewma_s[None], ewma_l[None], counts[None], params[None]))


def score_rows(rows, entry, f, rng):
    """The single-row fused score update (one lane of the interval step's
    EWMA kernel), held to its plain version bit for bit in all three
    outputs.  It is on no path of the main path (the
    classifier runs ``ewma_update``), so its JSON row's ``launches`` is 0;
    its launches here, in the kernel phase, must be nonzero."""
    before = _backend.launches["score_update"]
    for n in SCORE_PAGES:
        args = (f(rng.random(n, dtype=np.float32) * 100),
                f(rng.random(n, dtype=np.float32) * 100),
                f(rng.poisson(3, n).astype(np.float32)),
                f(np.array([0.7, 0.1, 0.2, 0.8], np.float32)))
        entry("score_update", f"n={n}", ukernel.score_update,
              score_update_plain, args, True, 24 * n, 9 * n)
        del args
    launched = _backend.launches["score_update"] - before
    require(launched > 0, "score_update: no launch in the kernel phase")
    rows["score_update"]["kernel_phase_launches"] = launched
    print(f"kernel score_update: {launched} launches in the kernel phase, "
          f"on no path of the main path", flush=True)


# the serving paths at granite-8b's full width: 32 pages of 4 tokens (128
# tokens a run) x 8 sequences x 8 KV heads x 128 (f32, 128 KiB a page), 8
# of them fast
PF, NP, PG, SB, SH, SKV, DH = 8, 32, 4, 8, 32, 8, 128


def fire_tables(rng, fast: int, home: int, moves: int, vacate=True):
    """A fire's slot tables (i32 numpy): ``moves`` slots demoted to unique
    home rows and refilled by promotions of other unique home rows
    (``vacate``; else only the promotions, into ``moves`` slots), -1
    elsewhere; and the library yardstick's row moves within a fused
    ``[fast + home, ...]`` pool, demotions first."""
    rows = rng.permutation(home)
    slots = rng.permutation(fast)[:moves]
    out_row, in_row = np.full(fast, -1, np.int32), np.full(fast, -1, np.int32)
    if vacate:
        out_row[slots] = rows[moves:2 * moves]
    in_row[rng.permutation(slots)] = rows[:moves]
    d, p = np.flatnonzero(out_row >= 0), np.flatnonzero(in_row >= 0)
    lib = (d, fast + out_row[d], fast + in_row[p], p)
    return out_row, in_row, tuple(m.astype(np.int32) for m in lib)


def fire_kernel(*a):
    """The fire over fused pools ``a[:-6]`` (``[k + n, ...]``; ``k`` the
    tables' length) and tables ``a[-6:-4]``: one launch."""
    pools, (out_row, in_row) = a[:-6], a[-6:-4]
    k = out_row.shape[0]
    mkernel.migrate_fire([p[:k] for p in pools], [p[k:] for p in pools],
                         out_row, in_row)
    return pools


def fire_plain(*a):
    pools, (out_row, in_row) = a[:-6], a[-6:-4]
    k = out_row.shape[0]
    mref.migrate_fire_ref([p[:k] for p in pools], [p[k:] for p in pools],
                          out_row, in_row)
    return pools


def fire_library(*a):
    """``index_select`` + ``index_copy_`` of the same rows, a call a pool
    and direction."""
    pools, (d_src, d_dst, p_src, p_dst) = a[:-6], a[-4:]
    for src, dst in ((d_src, d_dst), (p_src, p_dst)):
        if src.numel():
            for pool in pools:
                pool.index_copy_(0, dst.long(), pool.index_select(
                    0, src.long()))
    return pools


# the serving fold's heads a sequence (query, KV) and head width: granite-8b's
# (timed; llava-next-mistral-7b's too), zamba2-1.2b's shared block,
# llama4-scout's, deepseek-v2-236b's (128 KV heads of 128: B x KV = 1,024)
# and whisper-small's (12 KV heads of 64, not a power of two) (held, not
# timed)
SERVE_SHAPES = (("granite-8b", SH, SKV, DH), ("zamba2-1.2b", 32, 32, 64),
                ("llama4-scout", 40, 8, 128),
                ("deepseek-v2-236b", 128, 128, 128),
                ("whisper-small", 12, 12, 64))


def serving_rows(entry, f, rng):
    for model, sh, skv, dh in SERVE_SHAPES:
        serving_shape_rows(entry, f, rng, sh, skv, dh,
                           timed=model == "granite-8b", model=model)


def serving_shape_rows(entry, f, rng, sh, skv, dh, timed, model):
    idx = lambda a: f(np.asarray(a, np.int32))
    pools = tuple(f(rng.standard_normal((PF + NP, PG, SB * skv * dh),
                                        dtype=np.float32)) for _ in (0, 1))
    row_bytes = PG * SB * skv * dh * 4
    fresh = lambda a: (a[0].clone(), a[1].clone()) + a[2:]
    # a fire: every fast slot demoted (slot -> home row) and refilled by a
    # promotion (home row -> the vacated slot), ONE launch over K and V;
    # then a fire of 4 demotions and 4 promotions into other slots
    for moves, vacated in ((PF, True), (PF // 2, False)):
        out_row, in_row, lib_idx = fire_tables(rng, PF, NP, moves)
        if not vacated:
            in_row = np.roll(in_row, 1)
            lib_idx = ()
        args = pools + tuple(idx(t) for t in (out_row, in_row)) + tuple(
            idx(t) for t in lib_idx or [[]] * 4)
        entry("migrate", f"{model}: pools 2 x [{PF + NP}, {PG}, "
              f"{SB * skv * dh}] f32, {moves} demotions + {moves} "
              f"promotions"
              + (", every promotion into a vacated slot" if vacated else ""),
              fire_kernel, fire_plain, args, True,
              2 * 2 * 2 * moves * row_bytes + 2 * PF * 4, 0, fire_library,
              fresh=fresh, timed=timed and vacated)

    # attention at pos = 127: 32 valid pages, 8 of them fast
    H, KV = SB * sh, SB * skv
    kp = pools[0].view(PF + NP, PG, KV, dh)
    vp = pools[1].view(PF + NP, PG, KV, dh)
    fast = rng.choice(NP, PF, replace=False)
    table = PF + np.arange(NP)
    table[fast] = np.arange(PF)
    q = f(rng.standard_normal((1, H, dh), dtype=np.float32))
    args = (q, kp, vp, idx(table[None]), idx([NP * PG]))

    def gathered(a):
        q, kp, vp, tab, _ = a
        g = lambda p: p[tab[0].long()].reshape(1, NP * PG, KV, dh) \
            .transpose(1, 2).contiguous()
        return q.view(1, H, 1, dh), g(kp), g(vp)

    def sdpa(q4, k4, v4):
        return torch.nn.functional.scaled_dot_product_attention(
            q4, k4, v4, enable_gqa=True)

    if timed:
        lib_err = float((sdpa(*gathered(args)).view(1, H, dh)
                         - pref.paged_attention_ref(*args)).abs().max())
        print(f"library scaled_dot_product_attention vs plain: max_abs_err="
              f"{lib_err}", flush=True)
    entry("paged_attention", f"{model}: q [1, {H}, {dh}], pools "
          f"[{PF + NP}, {PG}, {KV}, {dh}] f32, {NP} pages, pos {NP * PG - 1}",
          lambda *a: pkernel.paged_attention(*a, page_mass=True),
          lambda *a: pref.paged_attention_ref(*a, page_mass=True), args,
          False, nbytes(q) * 2 + 2 * NP * PG * KV * dh * 4 + 4 * NP + 4
          + 4 * NP, 4 * H * NP * PG * dh, (sdpa, gathered), abs_tol=1e-5,
          timed=timed)


# deepseek-v2-236b's routed experts at published widths (d_model 5,120,
# expert d_ff 1,536, bf16): a promotion copies a home slab into a fast
# slot of the fused pools, ONE launch for both weights (``wi`` rows
# [5120, 3072], 31.5 MB; ``wo`` rows [1536, 5120], 15.7 MB)
SLAB_FAST, SLAB_HOME, SLAB_MOVES = 8, 16, 8


def slab_shapes():
    cfg = registry.get_arch("deepseek-v2-236b")
    D, F = cfg.d_model, cfg.moe_d_ff
    return (("wi", (D, 2 * F)), ("wo", (F, D)))


def slab_rows(entry, rng, dev):
    g = torch.Generator(device=dev).manual_seed(int(rng.integers(1 << 30)))
    pools = tuple(torch.randn((SLAB_FAST + SLAB_HOME,) + row, generator=g,
                              device=dev, dtype=torch.bfloat16)
                  for _, row in slab_shapes())
    out_row, in_row, lib_idx = fire_tables(rng, SLAB_FAST, SLAB_HOME,
                                           SLAB_MOVES, vacate=False)
    idx = lambda a: torch.as_tensor(np.asarray(a, np.int32), device=dev)
    args = pools + (idx(out_row), idx(in_row)) + tuple(map(idx, lib_idx))
    row_bytes = [p[0].numel() * 2 for p in pools]
    entry("migrate", "expert slabs: " + ", ".join(
        f"{nm} pool [{SLAB_FAST + SLAB_HOME}, {row[0]}, {row[1]}] bf16 "
        f"({rb / 1e6:.1f} MB a row)" for (nm, row), rb in zip(
            slab_shapes(), row_bytes)) + f", {SLAB_MOVES} promotions, one "
        f"launch", fire_kernel, fire_plain, args, True,
        2 * SLAB_MOVES * sum(row_bytes) + 2 * SLAB_FAST * 4, 0, fire_library,
        fresh=lambda a: tuple(p.clone() for p in a[:2]) + a[2:])
    del pools, args
    torch.cuda.empty_cache()


def offload_rows(entry, rng, dev):
    """The fire with its home pools in pinned host memory
    (``host_offload.to_slow_tier(..., "memkind")``), over the host link:
    the serving fold's fire (K and V, every promotion into a vacated slot)
    and 8 promotions of ``wi`` slabs from a pinned home of 16 rows.  Bound:
    the bytes each way over the link's rate; yardstick: one ``copy_`` of
    the same bytes from pinned memory with ``non_blocking=True``."""
    require(HO.supports_memkind(), "host offload: no pinned host memory")
    idx = lambda a: torch.as_tensor(np.asarray(a, np.int32), device=dev)

    def kern(*a):
        n = len(a) // 2 - 1
        mkernel.migrate_fire(a[:n], a[n:2 * n], a[-2], a[-1])
        return a[:2 * n]

    def plain(*a):
        """The plain fire on the card over the home pools staged there and
        copied back."""
        n = len(a) // 2 - 1
        on_card = [h.to(dev, non_blocking=True) for h in a[n:2 * n]]
        mref.migrate_fire_ref(a[:n], on_card, a[-2], a[-1])
        for h, c in zip(a[n:2 * n], on_card):
            h.copy_(c, non_blocking=True)
        return a[:2 * n]

    def copy_engine(args, link_bytes):
        """One ``copy_`` of ``link_bytes`` from pinned memory to the card."""
        src = torch.empty(link_bytes, dtype=torch.uint8, pin_memory=True)
        return (src, torch.empty(link_bytes, dtype=torch.uint8, device=dev))

    g = torch.Generator(device=dev).manual_seed(int(rng.integers(1 << 30)))
    F_ = SB * SKV * DH
    cases = [("serving fold", [(PG, F_), (PG, F_)], torch.float32, PF, NP,
              PF, True)]
    cases += [("expert slabs: wi", [slab_shapes()[0][1]], torch.bfloat16,
               SLAB_FAST, SLAB_HOME, SLAB_MOVES, False)]
    for label, rows, dt, k, n, moves, vacate in cases:
        fasts = tuple(torch.randn((k,) + r, generator=g, device=dev).to(dt)
                      for r in rows)
        homes = tuple(HO.to_slow_tier(torch.randn(
            (n,) + r, generator=g, device=dev).to(dt), "memkind")
            for r in rows)
        require(all(h.is_pinned() and h.device.type == "cpu"
                    for h in homes), "host offload: a home is not pinned")
        out_row, in_row, _ = fire_tables(rng, k, n, moves, vacate)
        args = fasts + homes + (idx(out_row), idx(in_row))
        row_bytes = sum(f[0].numel() * f.element_size() for f in fasts)
        up = int((in_row >= 0).sum()) * row_bytes
        down = int((out_row >= 0).sum()) * row_bytes
        entry("migrate", f"host link: {label}, home pools "
              f"{[tuple(h.shape) for h in homes]} {str(dt)[6:]} pinned, "
              f"{down // row_bytes} demotions + {up // row_bytes} "
              f"promotions, one launch", kern, plain, args, True,
              max(up, down), 0, (lambda s, d: d.copy_(s, non_blocking=True),
                                 lambda a, b=up + down: copy_engine(a, b)),
              fresh=lambda a, m=len(fasts): tuple(
                  x.clone() for x in a[:m]) + tuple(
                  pinned_copy(x) for x in a[m:2 * m]) + a[2 * m:],
              bytes_per_s=PCIE_BYTES_PER_S)
        del fasts, homes, args
        torch.cuda.empty_cache()


# flash attention rows: (label, B, S, H, KV, dh, causal, window, dtype);
# (label, B, S, H, KV, dq, dv, causal, window, dtype, forward only): the
# first is the training path's shape and goes into the JSON line; the
# prefill and encoder rows run no backward on the main path
FLASH_ROWS = [
    ("train: stablelm-1.6b, zamba2-1.2b's shared block", 2, 4096, 32, 32, 64,
     64, True, 0, torch.bfloat16, False),
    ("GQA: granite-8b heads", 2, 2048, 32, 8, 128, 128, True, 0,
     torch.bfloat16, False),
    ("windowed", 2, 4096, 32, 32, 64, 64, True, 1024, torch.bfloat16, False),
    ("f32", 1, 1024, 8, 2, 64, 64, True, 0, torch.float32, False),
    ("prefill: llava-next-mistral-7b, 576 patches + 4,096 tokens", 2, 4672,
     32, 8, 128, 128, True, 0, torch.bfloat16, True),
    ("prefill: llama4-scout", 2, 4096, 40, 8, 128, 128, True, 8192,
     torch.bfloat16, True),
    ("prefill: deepseek-v2-236b MLA, q/k 128 + 64, v 128", 2, 4096, 128, 128,
     192, 128, True, 0, torch.bfloat16, False),
    ("encoder: whisper-small, 1,500 frames", 2, 1500, 12, 12, 64, 64, False,
     0, torch.bfloat16, True)]
# bf16 rows: the largest error of one output row over that row's norm
FLASH_ROW_REL = 1e-2
# a row's plain version and its f32 check run a group of heads at a time
# where the [B, H, S, S] f32 scores would pass this many bytes
PLAIN_SCORE_BYTES = 8 * 2 ** 30


def plain_flash_f32(q, k, v, do, causal, window, kv_chunk: int = 8):
    """The plain version's output and gradient (``do`` None: output only),
    in f32 from the given inputs, a group of ``kv_chunk`` KV heads (and
    their query heads) at a time so the [B, H, S, S] f32 intermediates
    stay a few GiB."""
    KV, rep = k.shape[2], q.shape[2] // k.shape[2]
    outs, grads = [], [[], [], []]
    for g0 in range(0, KV, kv_chunk):
        g1 = min(KV, g0 + kv_chunk)
        qs, ks, vs = (x.float().clone().requires_grad_(do is not None)
                      for x in (q[:, :, g0 * rep:g1 * rep], k[:, :, g0:g1],
                                v[:, :, g0:g1]))
        out = fref.flash_attention_ref(qs, ks, vs, causal=causal,
                                       window=window)
        if do is not None:
            for acc, gr in zip(grads, torch.autograd.grad(
                    out, (qs, ks, vs), do[:, :, g0 * rep:g1 * rep].float())):
                acc.append(gr)
        outs.append(out.detach())
        del out, qs, ks, vs
    return torch.cat(outs, 2), [torch.cat(g, 2) for g in grads if g]


def head_groups(q, k, S: int):
    """KV-head groups ``[(g0, g1)]`` that the plain version runs one at a
    time: all heads in one group unless the f32 scores would pass
    ``PLAIN_SCORE_BYTES``."""
    B_, H, KV = q.shape[0], q.shape[2], k.shape[2]
    n = max(1, -(-B_ * H * S * S * 4 // PLAIN_SCORE_BYTES))
    step = -(-KV // n)
    return [(g0, min(KV, g0 + step)) for g0 in range(0, KV, step)]


def sdpa_bwd_ms(sets, to_bhsd, lib_fwd, reps: int = 8) -> float:
    """Device time of ``scaled_dot_product_attention``'s backward alone:
    each input set's forward runs once, outside the timed region, and its
    graph is kept; CUDA events then time ``reps`` gradients cycling over
    the sets (the host queues them ahead of the card; median of 5)."""
    graphs = []
    for q, k, v, do, *_ in sets:
        q4, k4, v4, mask = to_bhsd(q, k, v)
        leaves_ = [x.detach().requires_grad_() for x in (q4, k4, v4)]
        graphs.append((lib_fwd(*leaves_, mask), leaves_,
                       do.transpose(1, 2)))
    grad = lambda g: torch.autograd.grad(g[0], g[1], g[2],
                                         retain_graph=True)
    for g in graphs:
        grad(g)
    times = []
    for _ in range(5):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for i in range(reps):
            grad(graphs[i % len(graphs)])
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    del graphs
    return float(np.median(times))


def library_ms(label: str, time_it):
    """``time_it()`` of a ``scaled_dot_product_attention`` timing under
    PyTorch's fused backends only (flash, memory-efficient, cuDNN; its
    math fallback would materialise the scores): None, said on a line of
    its own, where none of them takes the row's shapes."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    try:
        with sdpa_kernel([SDPBackend.FLASH_ATTENTION,
                          SDPBackend.EFFICIENT_ATTENTION,
                          SDPBackend.CUDNN_ATTENTION]):
            return time_it()
    except RuntimeError as e:
        print(f"library scaled_dot_product_attention ({label}): no fused "
              f"backend takes these shapes: {str(e).splitlines()[0]}",
              flush=True)
        return None


def flash_rows(rows, rng):
    """Kernel rows of flash attention, forward and backward apart.  The
    check is against the plain version computed in f32 from the same
    inputs: bf16 out within 2e-2 and gradients within 2e-2 of each
    tensor's largest entry, and each output row (over dv) within
    ``FLASH_ROW_REL`` of its own norm, so a fault confined to the long
    rows, whose outputs are small, shows; f32 within 2e-5 (out) and 1e-4
    (gradients) of the largest entry; two backward runs give the same
    bits.  A prefill or encoder row (``fwd_only``) holds and times the
    forward alone.  The bound takes the bf16 tensor-core rate for bf16
    rows and the f32 rate for f32 rows: 2 (dq + dv) operations a kept
    (query, key) pair forward, 6 dq + 4 dv backward.  Plain and library
    times: the plain version (a group of heads at a time where its scores
    would pass ``PLAIN_SCORE_BYTES``: deepseek-v2's row) and
    ``scaled_dot_product_attention`` on the same inputs, for the backward
    row their forward plus backward (a window no shorter than the
    sequence is SDPA's causal mask)."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for (label, B_, S, H, KV, dq, dv, causal, window, dt,
         fwd_only) in FLASH_ROWS:
        f = lambda shape: torch.from_numpy(rng.standard_normal(
            shape, dtype=np.float32)).to("cuda", dt)
        q, k, v, do = f((B_, S, H, dq)), f((B_, S, KV, dq)), \
            f((B_, S, KV, dv)), f((B_, S, H, dv))
        kw = dict(causal=causal, window=window)
        out, lse = fkernel.flash_attention_fwd(q, k, v, **kw)
        grads = () if fwd_only else fkernel.flash_attention_bwd(
            q, k, v, out, lse, do, **kw)
        w_out, w_grads = plain_flash_f32(q, k, v, None if fwd_only else do,
                                         causal, window)
        tol_out, tol_grad = (2e-2, 2e-2) if dt == torch.bfloat16 \
            else (2e-5, 1e-4)
        err_out = float((out.float() - w_out).abs().max())
        scale_out = 1.0 if dt == torch.bfloat16 \
            else float(w_out.abs().max())
        require(err_out <= tol_out * scale_out,
                f"flash_attention_fwd {label}: error {err_out}")
        if dt == torch.bfloat16:
            row_rel = float(((out.float() - w_out).norm(dim=-1)
                             / w_out.norm(dim=-1).clamp_min(1e-30)).max())
            print(f"flash_attention_fwd {label}: largest row error "
                  f"{row_rel:.5f} of the row's norm", flush=True)
            require(row_rel <= FLASH_ROW_REL, f"flash_attention_fwd {label}"
                    f": a row's error is {row_rel} of its norm")
        err_grad = 0.0
        for nm, g, w in zip(("dq", "dk", "dv"), grads, w_grads):
            e = float((g.float() - w).abs().max())
            top = float(w.abs().max())
            require(e <= tol_grad * top, f"flash_attention_bwd {label}: "
                    f"{nm} error {e} > {tol_grad} x {top}")
            err_grad = max(err_grad, e)
        again = () if fwd_only else fkernel.flash_attention_bwd(
            q, k, v, out, lse, do, **kw)
        require(all(torch.equal(a, b) for a, b in zip(grads, again)),
                f"flash_attention_bwd {label}: two runs differ")
        del w_out, w_grads, again

        def to_bhsd(q, k, v, *rest):
            mask = None
            if window and window < S:   # SDPA takes a window only as a mask
                mask = torch.ones((S, S), dtype=torch.bool,
                                  device="cuda").tril().triu(-(window - 1))
            return (q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                    mask) + rest

        def lib_fwd(q4, k4, v4, mask, *rest):
            return sdpa(q4, k4, v4, attn_mask=mask,
                        is_causal=causal and mask is None, enable_gqa=True)

        def lib_fwd_bwd(q4, k4, v4, mask, do):
            leaves_ = [x.detach().requires_grad_() for x in (q4, k4, v4)]
            o = lib_fwd(*leaves_, mask)
            return torch.autograd.grad(o, leaves_, do.transpose(1, 2))

        groups = head_groups(q, k, S)
        rep = H // KV

        def plain_fwd(q, k, v, do):
            return [fref.flash_attention_ref(
                q[:, :, g0 * rep:g1 * rep], k[:, :, g0:g1], v[:, :, g0:g1],
                **kw) for g0, g1 in groups]

        def plain_fwd_bwd(q, k, v, do):
            out = []
            for g0, g1 in groups:
                leaves_ = [x.detach().requires_grad_() for x in (
                    q[:, :, g0 * rep:g1 * rep], k[:, :, g0:g1],
                    v[:, :, g0:g1])]
                o = fref.flash_attention_ref(*leaves_, **kw)
                out.append(torch.autograd.grad(
                    o, leaves_, do[:, :, g0 * rep:g1 * rep]))
            return out

        el = q.element_size()
        qkv_bytes = (q.numel() + k.numel() + v.numel() + out.numel()) * el
        for name, kern, plain, lib, args, bytes_, ops, err in (
                ("flash_attention_fwd",
                 lambda q, k, v, do: fkernel.flash_attention_fwd(
                     q, k, v, **kw),
                 plain_fwd, lib_fwd, (q, k, v, do),
                 qkv_bytes + lse.numel() * 4,
                 fops.flops_fwd(B_, S, H, dq, dv, causal, window), err_out),
                ("flash_attention_bwd",
                 lambda q, k, v, do, o, l: fkernel.flash_attention_bwd(
                     q, k, v, o, l, do, **kw),
                 lambda q, k, v, do, o, l: plain_fwd_bwd(q, k, v, do),
                 lambda q4, k4, v4, mask, do, o, l: lib_fwd_bwd(
                     q4, k4, v4, mask, do),
                 (q, k, v, do, out, lse),
                 2 * qkv_bytes + lse.numel() * 4,
                 fops.flops_bwd(B_, S, H, dq, dv, causal, window),
                 err_grad))[:1 if fwd_only else 2]:
            bms, by = bound(bytes_, ops, BF16_OPS_PER_S
                            if dt == torch.bfloat16 else F32_OPS_PER_S)
            sets = copies(args, bytes_)
            ms = cuda_ms(kern, sets, reps=4)
            plain_ms = cuda_ms(plain, sets, reps=2)
            lib_ms = library_ms(label, lambda: cuda_ms(
                lib, [to_bhsd(*a) for a in sets], reps=4))
            bwd_only = "" if name == "flash_attention_fwd" or lib_ms is None \
                else (" library_bwd_only_ms=" + str(library_ms(
                    label, lambda: sdpa_bwd_ms(sets, to_bhsd, lib_fwd))))
            print(f"kernel {name} ({label}: B={B_} S={S} H={H} KV={KV} "
                  f"dq={dq} dv={dv} {str(dt)[6:]} causal={causal} "
                  f"window={window}): max_abs_err={err} ms={ms:.5f} "
                  f"plain_ms={plain_ms:.5f} library_ms={lib_ms}{bwd_only} "
                  f"bound_ms={bms:.5f} ({by})", flush=True)
            if name not in rows:
                rows[name] = dict(
                    name=name, route="cuda",
                    source="src/repro_torch/kernels/flash_attention/csrc/"
                           "flash_attention.cu",
                    replaces="src/repro/kernels/flash_attention/kernel.py:73",
                    launches=0, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                    bound_ms=bms, bound_by=by, library_ms=lib_ms)
        del q, k, v, do, out, lse, grads, sets
        torch.cuda.empty_cache()


# mamba scan rows: (label, (B, S, H, P, N, Q), dt and A as mamba2-370m's
# init gives them); the first is the training path's shape and goes into
# the JSON line
MAMBA_ROWS = [("train: mamba2-370m", (2, 4096, 32, 64, 128, 64), True),
              ("train: zamba2-1.2b", (2, 4096, 64, 64, 64, 64), True),
              ("reduced mamba2-370m", (2, 32, 4, 32, 16, 8), False)]


def cs_ulp(dt, A, Q: int) -> float:
    """One f32 ulp of the largest chunk cumsum of dt * A."""
    B_, S, H = dt.shape
    cs = torch.cumsum((dt * A).double().reshape(B_, S // Q, Q, H), dim=2)
    return float(np.spacing(np.float32(cs.abs().max().item())))


def scan_passes(ins, dy, Q: int, label: str, calls: int = 5):
    """Device time of each pass of one ``mamba_scan_fwd`` call (``ms_cb``,
    ``ms_states``, ``ms_scan``, ``ms_out``) and of one ``mamba_scan_bwd``
    call, by kernel name under ``torch.profiler`` (the mean over
    ``calls`` calls)."""
    from torch.profiler import ProfilerActivity, profile
    for name, run in (
            ("mamba_scan_fwd",
             lambda: skernel.mamba_scan_fwd(*ins, chunk=Q)),
            ("mamba_scan_bwd",
             lambda: skernel.mamba_scan_bwd(*ins, dy, chunk=Q))):
        run()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                run()
            torch.cuda.synchronize()
        passes = {e.key.split("(")[0].removeprefix("void "):
                  round(e.self_device_time_total / 1e3 / calls, 5)
                  for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and e.self_device_time_total > 0
                  and SCAN_KERNEL.match(e.key)}
        require(passes, f"{name}: the profiler saw no pass")
        print(f"{name} passes ({label}), device ms a call: "
              f"{json.dumps(passes)} sum={sum(passes.values()):.5f}",
              flush=True)


def mamba_rows(rows, rng):
    """Kernel rows of the Mamba2 scan, forward and backward apart, in f32,
    held to the plain version computed in f32 from the same inputs: y and
    h_final within 2e-5 + 4 ulp(max |cs|) of their largest entries, each
    gradient within 1e-4 + 8 ulp(max |cs|) of its largest entry (the card
    tests' tolerances: the kernel sums the chunk cumsum cs in f64 as the
    CPU does, the plain version on the card with ``torch.cumsum`` in f32,
    and ``exp`` turns that last-ulp difference into a relative error of
    every decay); two forward runs and two backward runs each give the
    same bits.  Plain times: the plain version, for the backward
    row its forward plus autograd backward.  No PyTorch call computes the
    scan, so the library time is null.  The bound takes the f32 rate."""
    for label, (B_, S, H, P, N_, Q), model_like in MAMBA_ROWS:
        f = lambda *shape: torch.from_numpy(rng.standard_normal(
            shape, dtype=np.float32)).to("cuda")
        x, Bm, Cm, dy = f(B_, S, H, P), f(B_, S, N_), f(B_, S, N_), \
            f(B_, S, H, P)
        if model_like:
            dt = torch.logaddexp(f(B_, S, H), torch.zeros((), device="cuda"))
            A = -torch.linspace(1.0, 16.0, H, device="cuda")
        else:
            dt = torch.from_numpy(rng.uniform(0.1, 0.9, (B_, S, H)).astype(
                np.float32)).to("cuda")
            A = -torch.from_numpy(rng.uniform(0.5, 2.0, (H,)).astype(
                np.float32)).to("cuda")
        ins = (x, dt, A, Bm, Cm)
        y, h = skernel.mamba_scan_fwd(*ins, chunk=Q)
        grads = skernel.mamba_scan_bwd(*ins, dy, chunk=Q)
        leaves_ = [a.clone().requires_grad_() for a in ins]
        wy, wh = sref.mamba_scan_ref(*leaves_, Q)
        w_grads = torch.autograd.grad(wy, leaves_, dy)
        ulp = cs_ulp(dt, A, Q)
        errs = {}
        for name, got, want, tol in (
                ("mamba_scan_fwd", (y, h), (wy.detach(), wh.detach()),
                 2e-5 + 4 * ulp),
                ("mamba_scan_bwd", grads, w_grads, 1e-4 + 8 * ulp)):
            for g, w in zip(got, want):
                e = float((g.double() - w.double()).abs().max())
                top = float(w.double().abs().max())
                require(e <= tol * top, f"{name} {label}: error {e} > {tol}"
                        f" x {top}")
            errs[name] = max_err(got, want)
        again = skernel.mamba_scan_bwd(*ins, dy, chunk=Q)
        require(all(torch.equal(a, b) for a, b in zip(grads, again)),
                f"mamba_scan_bwd {label}: two runs differ")
        again = skernel.mamba_scan_fwd(*ins, chunk=Q)
        require(torch.equal(y, again[0]) and torch.equal(h, again[1]),
                f"mamba_scan_fwd {label}: two runs differ")
        del wy, wh, w_grads, again, leaves_

        def plain_fwd_bwd(x, dt, A, Bm, Cm, dy):
            leaves_ = [a.detach().requires_grad_() for a in (x, dt, A, Bm,
                                                             Cm)]
            yy, _ = sref.mamba_scan_ref(*leaves_, Q)
            return torch.autograd.grad(yy, leaves_, dy)

        if model_like:
            scan_passes(ins, dy, Q, label)
        ops_f, ops_b = sops.flops(B_, S, H, P, N_, Q)
        for name, kern, plain, args, bytes_, ops in (
                ("mamba_scan_fwd",
                 lambda *a: skernel.mamba_scan_fwd(*a, chunk=Q),
                 lambda *a: sref.mamba_scan_ref(*a, Q), ins,
                 nbytes(*ins, y, h), ops_f),
                ("mamba_scan_bwd",
                 lambda *a: skernel.mamba_scan_bwd(*a, chunk=Q),
                 plain_fwd_bwd, ins + (dy,), nbytes(*ins, dy, *grads),
                 ops_b)):
            bms, by = bound(bytes_, ops)
            sets = copies(args, bytes_)
            ms = cuda_ms(kern, sets, reps=4)
            plain_ms = cuda_ms(plain, sets, reps=2)
            print(f"kernel {name} ({label}: B={B_} S={S} H={H} P={P} "
                  f"N={N_} Q={Q} f32; {ops / 1e9:.3f} GFLOP, "
                  f"{bytes_ / 1e6:.1f} MB): max_abs_err={errs[name]} "
                  f"ms={ms:.5f} plain_ms={plain_ms:.5f} library_ms=None "
                  f"bound_ms={bms:.5f} ({by}) max_cs_ulp={ulp}", flush=True)
            if name not in rows:
                rows[name] = dict(
                    name=name, route="cuda",
                    source="src/repro_torch/kernels/mamba_scan/csrc/"
                           "mamba_scan.cu",
                    replaces="src/repro/kernels/mamba_scan/kernel.py:75",
                    launches=0, max_abs_err=errs[name], ms=ms,
                    plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                    library_ms=None)
        del x, dt, A, Bm, Cm, dy, y, h, grads, sets
        torch.cuda.empty_cache()


# ---------------------------------------------------------------- main path
def gups_trace(T_: int, n: int, seed: int, hot_frac=0.125, hot_weight=0.9,
               shift_every=150, work=2.0e7) -> np.ndarray:
    """GUPS-like trace: uniform accesses within a hot set of
    ``hot_frac * n`` pages that relocates every ``shift_every`` intervals;
    ``true = work * probs`` (the parameters of ``gups_spec``)."""
    rng = np.random.default_rng(seed)
    kh = max(1, int(round(n * hot_frac)))
    trace = np.empty((T_, n), np.float32)
    for t0 in range(0, T_, shift_every):
        probs = np.full(n, (1.0 - hot_weight) / max(n - kh, 1))
        probs[rng.permutation(n)[:kh]] = hot_weight / kh
        trace[t0:t0 + shift_every] = (work * probs).astype(np.float32)
    return trace


GRID = dict(alpha_s=[0.5, 0.6, 0.7, 0.8] * 4,
            noise_z=[v for v in (0.0, 0.25, 0.5, 1.0) for _ in range(4)])


def summary(results):
    return dict(promotions=sum(r.promotions for r in results),
                demotions=sum(r.demotions for r in results),
                wasteful=sum(r.wasteful for r in results),
                exec_time_s=[r.exec_time_s for r in results])


SCAN_KERNELS = ("ewma_update", "topk_mask", "tier_migrate",
                "interval_account")
SERVE_KERNELS = ("ewma_update", "topk_mask", "migrate", "paged_attention")


#: fires of a tiered pool with buffers to move since ``counted`` last set
#: it to 0 (``count_fires``): each must be ONE ``migrate`` launch
FIRES = [0]


def count_fires():
    """Wrap ``tiered_pool.pool_fire`` (which ``pool_step`` calls through
    the module) so that each fire due with buffers to move adds one to
    FIRES."""
    fire = TP.pool_fire

    def counting(pool, *, k, bufs=(), **kw):
        if bufs and k > 0 and TP.pool_fires(pool):
            FIRES[0] += 1
        return fire(pool, k=k, bufs=bufs, **kw)

    TP.pool_fire = counting


def counted(label: str, run, path_kernels=SCAN_KERNELS):
    """Drive one path of the main path with every launch count (and
    FIRES) set to 0 just before it and read just after; each kernel of the
    path must have been launched, and ``migrate`` once a fire.  ->
    (result, wall seconds, launch counts of every kernel)."""
    torch.cuda.synchronize()
    _backend.reset_launches()
    FIRES[0] = 0
    t0 = time.time()
    out = run()
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = {nm: int(_backend.launches.get(nm, 0)) for nm in KERNELS}
    for nm in path_kernels:
        require(counts[nm] > 0, f"{nm} was not launched by {label}")
    require(counts["migrate"] == FIRES[0],
            f"{label}: {counts['migrate']} migrate launches for "
            f"{FIRES[0]} fires")
    if FIRES[0]:
        print(f"fires {label}: {FIRES[0]} fires, {counts['migrate']} "
              f"migrate launches (one a fire)", flush=True)
    return out, wall, counts


def main_path(seed: int, held: set):
    """-> {path: {kernel: launches}} for every path of the main path;
    ``held``: the cluster configurations the kernel phase held."""
    # from here the cache holds only the sizes the main path's launches
    # chose (``check_held_clusters``); the kernel phase's are dropped
    _backend.clusters.clear()
    t0 = time.time()
    trace = gups_trace(T, N, seed)
    u = uniform_field(T, N, seed=seed + 1)
    print(f"main path: trace + CRN field made in {time.time() - t0:.2f}s",
          flush=True)
    res, wall, sweep_counts = counted(
        "sweep_arms_configs", lambda: scan_engine.sweep_arms_configs(
            trace, "pmem-large", K, GRID, sample_u=u, reduce="stream"))
    s = summary(res)
    require(all(np.isfinite(s["exec_time_s"])) and s["promotions"] > 0,
            "sweep: non-finite exec_time or no promotions")
    print(f"main path sweep_arms_configs: lanes={B} T={T} n={N} k={K} "
          f"wall_s={wall:.3f} lane_intervals_per_s={B * T / wall:.1f} "
          f"promotions={s['promotions']} demotions={s['demotions']} "
          f"wasteful={s['wasteful']} launches={sweep_counts}", flush=True)

    T2 = 512   # cut from 1,024 with the ARMS serve (512 -> 128 tokens)
    r, wall2, sim_counts = counted(
        "arms_sim", lambda: scan_engine.arms_sim(
            trace[:T2], "dram-cxl-pmem", K, sample_u=u[:T2]))
    require(np.isfinite(r.exec_time_s) and r.promotions > 0,
            "arms_sim: non-finite exec_time or no promotions")
    print(f"main path arms_sim dram-cxl-pmem: T={T2} n={N} "
          f"wall_s={wall2:.3f} intervals_per_s={T2 / wall2:.1f} "
          f"promotions={r.promotions} demotions={r.demotions} "
          f"wasteful={r.wasteful} launches={sim_counts}", flush=True)
    # the sweep's first 256 intervals, set-up included (profiling slows
    # the host, so the busy share is a lower bound)
    profiled("profile sweep_arms_configs T=256",
             lambda: scan_engine.sweep_arms_configs(
                 trace[:256], "pmem-large", K, GRID, sample_u=u[:256],
                 reduce="stream"))
    stamp("main path sweep, arms_sim and profile")
    fams, defaults = policy_paths(trace[:T_POL], u[:T_POL])
    stamp("main path policy families")
    eng = engine_paths(trace[:T_POL], u[:T_POL], defaults)
    stamp("main path reference engine")
    synth, comparison = synth_paths(trace[:T_SYN], seed)
    stamp("main path synthesis")
    tuned = tuning_paths(trace[:T_POL], seed, comparison)
    stamp("main path tuning")
    board = board_paths(seed)
    stamp("main path board")
    check_held_clusters("main path", held)

    # granite-8b's weights at full width, made once from the seed (the
    # generator ``serve.setup`` would use) and passed to every serve run
    t0 = time.time()
    params = M.init_params(registry.get_arch("granite-8b"),
                           torch.Generator(device="cuda").manual_seed(seed),
                           "cuda")
    torch.cuda.synchronize()
    print(f"main path serve: granite-8b weights made in "
          f"{time.time() - t0:.3f}s", flush=True)
    (rep, syncs), wall3, serve_counts = counted("serve", lambda: synced(
        lambda: serve.serve(
            "granite-8b", n_tokens=SERVE_TOKENS, batch=SB, full=True,
            seed=seed, page_size=PG, capture=True, quiet=True,
            params=params)), SERVE_KERNELS)
    require(rep.fast_mass.shape == (SERVE_TOKENS,)
            and bool(np.isfinite(rep.fast_mass).all())
            and np.isfinite(rep.slowdown) and rep.promotions > 0,
            "serve: non-finite telemetry or no promotions")
    print(f"main path serve granite-8b full: tokens={SERVE_TOKENS} "
          f"batch={SB} pages={NP} of {PG} wall_s={wall3:.3f} "
          f"init_s={rep.init_s:.3f} "
          f"decode_s={SERVE_TOKENS * SB / rep.tok_s:.3f} "
          f"tok_s={rep.tok_s:.1f} promotions={rep.promotions} "
          f"demotions={rep.demotions} thrash={rep.thrash:.4f} "
          f"slowdown={rep.slowdown:.4f} fast_mass_end={rep.fast_mass[-1]:.4f} "
          f"host_syncs_run={syncs} launches={serve_counts}", flush=True)
    capture_check(rep)
    sparse_check(rep, seed)
    del rep
    families = serve_families(seed, params)
    serve_breakdown(seed, params)
    del params
    torch.cuda.empty_cache()
    stamp("main path serve")
    tiers = tier_paths(seed)
    stamp("main path expert and embedding tiers")

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    first, undo = recorded_train(MESH_STEPS)
    try:
        losses, wall4, train_counts = clocked("train", lambda: train.train(
            TRAIN_ARCH, TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ, full=True,
            seed=seed, log_every=1), TRAIN_KERNELS)
    finally:
        undo()
    require(len(losses) == TRAIN_STEPS and all(np.isfinite(losses)),
            f"train: losses {losses} not finite")
    tokens = TRAIN_STEPS * TRAIN_BATCH * TRAIN_SEQ
    clone_gib = sum(t.numel() * t.element_size()
                    for t in leaves(first["params"])) / 2 ** 30
    print(f"main path train {TRAIN_ARCH} full: steps={TRAIN_STEPS} "
          f"batch={TRAIN_BATCH} seq={TRAIN_SEQ} wall_s={wall4:.3f} "
          f"tok_s_overall={tokens / wall4:.1f} loss_first={losses[0]:.4f} "
          f"loss_last={losses[-1]:.4f} peak_device_memory_gib="
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} (with the "
          f"mesh check's clone of the params, {clone_gib:.2f}) "
          f"launches={train_counts}", flush=True)
    first["to_host"]()
    train_breakdown(TRAIN_ARCH, seed, losses[0], (attn, "flash_ops",
                    types.SimpleNamespace(
                        flash_attention=fref.flash_attention_ref)),
                    lambda k: k.startswith("void fa_"), "attention")
    stamp("main path train")
    meshed = mesh_paths(seed, first)
    del first
    torch.cuda.empty_cache()
    stamp("main path mesh_paths")

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    losses, wall5, ssm_counts = clocked("train_ssm", lambda: train.train(
        SSM_ARCH, TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ, full=True, seed=seed,
        log_every=1), SSM_KERNELS)
    require(len(losses) == TRAIN_STEPS and all(np.isfinite(losses)),
            f"train_ssm: losses {losses} not finite")
    print(f"main path train {SSM_ARCH} full: steps={TRAIN_STEPS} "
          f"batch={TRAIN_BATCH} seq={TRAIN_SEQ} wall_s={wall5:.3f} "
          f"tok_s_overall={tokens / wall5:.1f} loss_first={losses[0]:.4f} "
          f"loss_last={losses[-1]:.4f} peak_device_memory_gib="
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} "
          f"launches={ssm_counts}", flush=True)
    train_breakdown(SSM_ARCH, seed, losses[0], (Mb, "scan_ops",
                    types.SimpleNamespace(mamba_scan=plain_scan)),
                    lambda k: bool(SCAN_KERNEL.match(k)), "scan")
    stamp("main path train_ssm")
    torch.cuda.empty_cache()
    paths = ssm_paths(seed)
    ssm_consistency(seed)
    stamp("main path ssm prefill and decode")
    models = family_paths(seed)
    newer = mla_encdec_paths(seed)
    return {"sweep_arms_configs": sweep_counts, "arms_sim": sim_counts,
            **fams, **eng, **synth, **tuned, **board, "serve": serve_counts,
            **families, **tiers, "train": train_counts,
            **meshed, "train_ssm": ssm_counts, **paths, **models, **newer}


# the mesh paths: the train phase's first MESH_STEPS steps again on a
# (1, 1) mesh, and granite-8b's decode of MESH_TOKENS tokens at batch
# MESH_BATCH (a cache of MESH_SEQ positions) with and without the mesh
MESH_STEPS, MESH_TOKENS, MESH_BATCH, MESH_SEQ = 2, 8, 8, 64
MESH_DECODE_ARCH = "granite-8b"


def recorded_train(n: int):
    """Wrap ``steps.make_train_step`` (which ``train.train`` calls through
    the module) so the steps it makes record their first ``n`` calls'
    loss, grad norm and seconds, and the params after the ``n``-th,
    cloned on the card (``params``; ``to_host`` moves them to the host
    once the timed run is over) -> (the record, the undo).  The syncs
    around each step cost nothing more: ``train.train`` reads each
    step's loss on the host right after it."""
    rec = {"metrics": [], "params": None, "copy_s": 0.0}

    def to_host():
        t1 = time.time()
        rec["params"] = map_leaves(lambda t: t.to("cpu"), rec["params"])
        rec["copy_s"] = time.time() - t1

    rec["to_host"] = to_host
    make = steps.make_train_step

    def making(*a, **kw):
        step = make(*a, **kw)

        def recording(params, state, batch):
            torch.cuda.synchronize()
            t0 = time.time()
            params, state, m = step(params, state, batch)
            torch.cuda.synchronize()
            if len(rec["metrics"]) < n:
                rec["metrics"].append((float(m["loss"]),
                                       float(m["grad_norm"]),
                                       time.time() - t0))
                if len(rec["metrics"]) == n:
                    rec["params"] = map_leaves(
                        lambda t: t.detach().clone(), params)
            return params, state, m

        return recording

    steps.make_train_step = making
    return rec, lambda: setattr(steps, "make_train_step", make)


def plain(t):
    """A DTensor's whole value (this one card's), else ``t``."""
    return t.full_tensor() if isinstance(t, DTensor) else t


def mesh_paths(seed: int, first: dict) -> dict:
    """The launch layer on the card: a one-rank NCCL process group and a
    (1, 1) ("data", "model") mesh, destroyed at the end.
    - ``mesh_train``: the train phase's arch at full width, params and
      AdamW state from the same seed distributed by ``param_shardings``,
      ``MESH_STEPS`` steps of ``make_train_step(..., mesh=mesh)`` on the
      same batches: each step's loss and grad norm held to the train
      phase's own first steps (``recorded_train``) at 1e-6 relative, the
      params after them (``full_tensor()``) within 1e-6 of each leaf's
      largest entry of the train phase's (bit for bit expected);
    - ``mesh_prefill``: one ``make_prefill_step(..., mesh=mesh)`` on the
      first batch's tokens, logits within 1e-6 of the largest entry of the
      mesh-free prefill's from the same params;
    - ``mesh_serve``: ``MESH_TOKENS`` greedy tokens of
      ``MESH_DECODE_ARCH`` at full width through ``make_serve_step`` with
      params distributed by ``param_shardings(serve=True)`` and the cache
      by ``cache_sharding``, equal to the mesh-free decode's.
    Printed, not gated: each way's tok/s (DTensor's host overhead)."""
    dev = torch.device("cuda")
    mesh_lib.bring_up("nccl")
    try:
        mesh = mesh_lib.make_mesh((1, 1), ("data", "model"))
        cfg, opt_cfg, params, state = train.setup(TRAIN_ARCH, TRAIN_STEPS,
                                                  True, seed, dev)
        params = sharding.distribute_tree(
            params, sharding.param_shardings(params, mesh), mesh)
        state = sharding.distribute_tree(
            state, sharding.param_shardings(state, mesh), mesh)
        step = steps.make_train_step(cfg, opt_cfg, remat=False, mesh=mesh)
        data = SyntheticLM(cfg.vocab_size_raw, TRAIN_SEQ, TRAIN_BATCH,
                           seed=seed)
        batch_at = lambda i: {**train.to_device(data.batch_at(i), dev),
                              **train.stub_inputs(cfg, TRAIN_BATCH, dev)}
        got = []

        def run_train():
            nonlocal params, state
            for i in range(MESH_STEPS):
                batch = batch_at(i)
                torch.cuda.synchronize()
                t0 = time.time()
                params, state, m = step(params, state, batch)
                torch.cuda.synchronize()
                got.append((float(plain(m["loss"])),
                            float(plain(m["grad_norm"])), time.time() - t0))

        _, _, train_counts = counted("mesh_train", run_train, TRAIN_KERNELS)
        tokens = TRAIN_BATCH * TRAIN_SEQ
        for i, (g, w) in enumerate(zip(got, first["metrics"])):
            rel = [abs(a - b) / abs(b) for a, b in zip(g[:2], w[:2])]
            print(f"mesh_train {TRAIN_ARCH} full step {i}: loss {g[0]!r} "
                  f"vs {w[0]!r}, grad norm {g[1]!r} vs {w[1]!r} (rel "
                  f"{rel[0]:.3e}, {rel[1]:.3e}); tok/s {tokens / g[2]:.1f} "
                  f"on the mesh, {tokens / w[2]:.1f} without", flush=True)
            require(max(rel) <= 1e-6, f"mesh_train step {i}: loss / grad "
                    f"norm rel {rel}")
        worst, worst_at, n_diff = 0.0, "", 0
        for (path, w), d in zip(flatten_with_path(first["params"]),
                                leaves(params)):
            g, w = plain(d), w.to(dev)
            err = float((g.float() - w.float()).abs().max())
            top = float(w.float().abs().max())
            n_diff += int((g != w).sum())
            if err / max(top, 1e-30) >= worst:
                worst, worst_at = err / max(top, 1e-30), "/".join(path)
            require(err <= 1e-6 * top, f"mesh_train: params "
                    f"{'/'.join(path)} differ by {err} (largest {top})")
        print(f"mesh_train params after step {MESH_STEPS}: largest "
              f"difference {worst:.3e} of its leaf's largest entry "
              f"({worst_at}); {n_diff} elements differ; their copy to "
              f"the host after the train phase {first['copy_s']:.2f}s; "
              f"launches "
              f"{train_counts}", flush=True)

        batch = {"tokens": batch_at(0)["tokens"]}
        local = map_leaves(lambda t: t.to_local(), params)
        want = steps.make_prefill_step(cfg)(local, batch)
        logits, wall, prefill_counts = counted(
            "mesh_prefill", lambda: steps.make_prefill_step(
                cfg, mesh=mesh)(params, batch), ("flash_attention_fwd",))
        err = float((plain(logits).float() - want.float()).abs().max())
        top = float(want.float().abs().max())
        print(f"mesh_prefill {TRAIN_ARCH} full: logits within "
              f"{err / top:.3e} of the largest ({err} of {top}); "
              f"{tokens / wall:.1f} tok/s on the mesh; launches "
              f"{prefill_counts}", flush=True)
        require(err <= 1e-6 * top, f"mesh_prefill: logits error {err}")
        del params, state, local, logits, want
        torch.cuda.empty_cache()

        dcfg = registry.get_arch(MESH_DECODE_ARCH)
        dparams = M.init_params(
            dcfg, torch.Generator(device="cuda").manual_seed(seed), dev)
        serve_step = steps.make_serve_step(dcfg)

        def decode(p, cache):
            tok = torch.full((MESH_BATCH, 1), 3, dtype=torch.int32,
                             device=dev)
            out = []
            torch.cuda.synchronize()
            t0 = time.time()
            for pos in range(MESH_TOKENS):
                tok, cache = serve_step(p, tok, cache, pos)
                out.append(plain(tok))
            torch.cuda.synchronize()
            return torch.cat(out, 1).cpu(), time.time() - t0

        want, wall_free = decode(dparams, M.init_cache(
            dcfg, MESH_BATCH, MESH_SEQ, dev))
        cache = M.init_cache(dcfg, MESH_BATCH, MESH_SEQ, dev)
        sparams = sharding.distribute_tree(
            dparams, sharding.param_shardings(dparams, mesh, serve=True),
            mesh)
        cache = sharding.distribute_tree(
            cache, sharding.cache_sharding(mesh, cache), mesh)
        (got, wall_mesh), _, serve_counts = counted(
            "mesh_serve", lambda: decode(sparams, cache), ())
        n_tok = MESH_TOKENS * MESH_BATCH
        print(f"mesh_serve {MESH_DECODE_ARCH} full: {MESH_TOKENS} greedy "
              f"tokens at batch {MESH_BATCH}: tokens "
              f"{'equal' if torch.equal(got, want) else 'DIFFER'} "
              f"{got[0].tolist()}; tok/s {n_tok / wall_mesh:.1f} on the "
              f"mesh, {n_tok / wall_free:.1f} without; launches "
              f"{serve_counts}", flush=True)
        require(torch.equal(got, want), f"mesh_serve: tokens {got.tolist()}"
                f" vs {want.tolist()}")
        del dparams, sparams, cache
    finally:
        mesh_lib.tear_down()
    return {"mesh_train": train_counts, "mesh_prefill": prefill_counts,
            "mesh_serve": serve_counts}


# the other policy families: knob grids of 16 lanes (12 for HybridTier) on
# the binary route (2-tier pmem-large) and the tier-targeted route (3-tier
# dram-cxl-pmem), at T_POL intervals of the main path's trace and CRN field
T_POL = 128    # cut from 2,048, then from 1,024 (730 s with the build on
#                an H100), then from 512 for the robustness board (its
#                path and check about 170 s), then from 256 for the
#                reference engine, the other families' serving and the
#                tiers (736.7 s): the whole script under 700 s
T_PROF = 64    # intervals of each family, synthesis, tuning and board
#                profile window (128 to the same cut)
BINARY_KERNELS = ("tier_migrate", "interval_account")
TIER_KERNELS = ("interval_account",)
grid = lambda a, av, b, bv: [{a: x, b: y} for x in av for y in bv]
POLICY_SWEEPS = (
    ("hemem", "pmem-large", hemem.HeMemSpec.make,
     grid("hot_threshold", (4.0, 8.0, 16.0, 32.0),
          "migration_period", (1, 2, 5, 10))),
    ("memtis", "pmem-large", memtis.MemtisSpec.make,
     grid("cooling_period_samples", (2.5e5, 5e5, 1e6, 2e6),
          "adaptation_period", (2, 5, 10, 20))),
    ("tpp", "pmem-large", tpp.TPPSpec.make,
     grid("promote_hits", (1.0, 2.0, 4.0, 8.0),
          "watermark", (0.90, 0.95, 0.98, 0.995))),
    ("jenga", "dram-cxl-pmem", jenga.JengaSpec.make,
     grid("alpha", (0.3, 0.5, 0.7, 0.9), "confirm", (1, 2, 3, 4))),
    ("tierbpf", "dram-cxl-pmem", tierbpf.TierBPFSpec.make,
     grid("admit_thresh", (1.0, 2.0, 4.0, 8.0),
          "thrash_gain", (0.5, 1.0, 2.0, 4.0))),
    ("hybridtier", "dram-cxl-pmem", hybridtier.HybridTierSpec.make,
     grid("hot_thresh", (2.0, 4.0, 6.0, 9.0), "decay", (0.5, 0.7, 0.9))),
)
# the paper's comparison (Fig. 1): each family at its defaults, one lane
FAMILY_DEFAULTS = (("arms", ARMSSpec.make), ("hemem", hemem.HeMemSpec.make),
                   ("memtis", memtis.MemtisSpec.make),
                   ("tpp", tpp.TPPSpec.make),
                   ("all-slow", static.AllSlowSpec),
                   ("oracle", static.OracleSpec))


def policy_paths(trace, u) -> dict:
    """The other policy families at the main path's width: a knob-grid
    ``sweep_policy_configs`` of each, then the six binary families at
    their defaults (``simulate``), each exec time over all-slow's.
    -> ({path: launch counts}, {family: the default run})."""
    T_, n = trace.shape
    counts = {}
    for fam, mname, make, cfgs in POLICY_SWEEPS:
        tn = make().tier_native
        res, wall, counts[f"sweep_{fam}"] = counted(
            f"sweep_{fam}", lambda: scan_engine.sweep_policy_configs(
                make, trace, mname, K, cfgs, sample_u=u),
            TIER_KERNELS if tn else BINARY_KERNELS)
        s = summary(res)
        require(all(np.isfinite(s["exec_time_s"])) and s["promotions"] > 0,
                f"sweep {fam}: non-finite exec_time or no promotions")
        profiled(f"profile sweep_policy_configs {fam} T={T_PROF}",
                 lambda: scan_engine.sweep_policy_configs(
                     make, trace[:T_PROF], mname, K, cfgs,
                     sample_u=u[:T_PROF]), top=4)
        print(f"main path sweep_policy_configs {fam} {mname}: "
              f"lanes={len(cfgs)} T={T_} n={n} k={K} wall_s={wall:.3f} "
              f"lane_intervals_per_s={len(cfgs) * T_ / wall:.1f} "
              f"promotions={s['promotions']} demotions={s['demotions']} "
              f"wasteful={s['wasteful']} launches={counts[f'sweep_{fam}']}",
              flush=True)

    walls = {}

    def compare():
        out = {}
        for fam, make in FAMILY_DEFAULTS:
            t0 = time.time()
            out[fam] = scan_engine.simulate(make(), trace, "pmem-large", K,
                                            sample_u=u)
            walls[fam] = time.time() - t0
        return out

    res, wall, counts["families"] = counted(
        "families", compare, ("ewma_update", "topk_mask") + BINARY_KERNELS)
    base = res["all-slow"]
    require(base.promotions == base.demotions == 0,
            "all-slow migrated a page")
    for fam, r in res.items():
        require(np.isfinite(r.exec_time_s), f"{fam}: exec_time not finite")
        require(fam == "all-slow" or r.promotions > 0,
                f"{fam}: no promotion")
        print(f"main path families pmem-large {fam}: T={T_} n={n} k={K} "
              f"exec_time_s={r.exec_time_s:.6f} vs_all_slow="
              f"{r.exec_time_s / base.exec_time_s:.4f} "
              f"promotions={r.promotions} demotions={r.demotions} "
              f"wasteful={r.wasteful} hot_recall={r.hot_recall:.4f} "
              f"wall_s={walls[fam]:.3f} "
              f"intervals_per_s={T_ / walls[fam]:.1f}",
              flush=True)
    print(f"main path families: wall_s={wall:.3f} launches="
          f"{counts['families']}", flush=True)
    return counts, res


# the numpy reference engine at the main path's width: ARMS's hand-tuned
# wrapper, ARMS through the generic adapter and the other eight families
# through theirs, on the trace and CRN field of the family paths; each
# held to the scan engine's lane of its family on the same field
ENGINE_POLICIES = (
    ("ARMSPolicy", ARMSPolicy, "pmem-large", "arms"),
    ("arms-adapter", lambda: protocol.LegacyPolicyAdapter(ARMSSpec.make()),
     "pmem-large", "arms"),
    ("hemem", hemem.HeMemPolicy, "pmem-large", "hemem"),
    ("memtis", memtis.MemtisPolicy, "pmem-large", "memtis"),
    ("tpp", tpp.TPPPolicy, "pmem-large", "tpp"),
    ("all-slow", static.AllSlowPolicy, "pmem-large", "all-slow"),
    ("oracle", static.OraclePolicy, "pmem-large", "oracle"),
    ("hybridtier", hybridtier.HybridTierPolicy, "dram-cxl-pmem",
     "hybridtier"),
    ("jenga", jenga.JengaPolicy, "dram-cxl-pmem", "jenga"),
    ("tierbpf", tierbpf.TierBPFPolicy, "dram-cxl-pmem", "tierbpf"))
TIER_DEFAULTS = (("hybridtier", hybridtier.HybridTierSpec.make),
                 ("jenga", jenga.JengaSpec.make),
                 ("tierbpf", tierbpf.TierBPFSpec.make))
ENGINE_KERNELS = ("ewma_update", "topk_mask", "interval_account")


def engine_paths(trace, u, scan: dict) -> dict:
    """``engine.run`` of each of ``ENGINE_POLICIES`` (binary families on
    ``pmem-large``, tier-native ones on ``dram-cxl-pmem``), after the
    tier-native families' own scan lanes at their defaults on the same
    field (``scan`` holds the binary families' from ``policy_paths``).
    Gate: counts, ``timeline_promotions`` and ``timeline_mode`` equal to
    the scan lane's, exec time within 1e-4 relative; whether the slow-share
    timeline (the accounting op's output in both engines) is bit for bit
    the scan lane's is printed.  -> {path: launch counts}."""
    T_, n = trace.shape
    counts = {}
    tiered, wall, counts["families_tiered"] = counted(
        "families_tiered", lambda: {
            fam: scan_engine.simulate(make(), trace, "dram-cxl-pmem", K,
                                      sample_u=u)
            for fam, make in TIER_DEFAULTS}, TIER_KERNELS)
    require(all(np.isfinite(r.exec_time_s) for r in tiered.values())
            and sum(r.promotions for r in tiered.values()) > 0,
            "tier-native scan lanes: exec time not finite or no promotion")
    for fam, r in tiered.items():
        print(f"main path families dram-cxl-pmem {fam}: T={T_} n={n} k={K} "
              f"exec_time_s={r.exec_time_s:.6f} promotions={r.promotions} "
              f"demotions={r.demotions} wasteful={r.wasteful}", flush=True)
    print(f"main path families_tiered: wall_s={wall:.3f} launches="
          f"{counts['families_tiered']}", flush=True)
    scan = dict(scan, **tiered)
    walls = {}

    def run_all():
        out = {}
        for label, make, mname, _ in ENGINE_POLICIES:
            t0 = time.time()
            out[label] = engine.run(make(), trace, mname, K, sample_u=u)
            walls[label] = time.time() - t0
        return out

    res, wall, counts["engine"] = counted("engine", run_all, ENGINE_KERNELS)
    for label, _, mname, fam in ENGINE_POLICIES:
        a, b = res[label], scan[fam]
        require((a.promotions, a.demotions, a.wasteful)
                == (b.promotions, b.demotions, b.wasteful)
                and np.array_equal(a.timeline_promotions,
                                   b.timeline_promotions)
                and np.array_equal(a.timeline_mode, b.timeline_mode),
                f"engine {label}: counts {a.promotions}/{a.demotions}/"
                f"{a.wasteful} != scan {b.promotions}/{b.demotions}/"
                f"{b.wasteful} or timelines differ")
        rel = abs(a.exec_time_s - b.exec_time_s) / abs(b.exec_time_s)
        require(rel <= 1e-4, f"engine {label}: exec_time rel {rel}")
        print(f"main path engine {label} {mname}: T={T_} n={n} k={K} "
              f"wall_s={walls[label]:.3f} "
              f"intervals_per_s={T_ / walls[label]:.1f} "
              f"host_ms_per_interval={walls[label] * 1e3 / T_:.3f} "
              f"promotions={a.promotions} demotions={a.demotions} "
              f"wasteful={a.wasteful} exec_time_s={a.exec_time_s:.9f} "
              f"scan_exec_time_s={b.exec_time_s:.9f} exec_rel={rel:.3e} "
              f"slow_bw_timeline_bits_equal="
              f"{np.array_equal(a.timeline_slow_bw, b.timeline_slow_bw)} "
              f"hot_recall={a.hot_recall:.6f} scan_hot_recall="
              f"{b.hot_recall:.6f}", flush=True)
    print(f"main path engine: wall_s={wall:.3f} launches={counts['engine']}",
          flush=True)
    return counts


# the trace-synthesis path: the paper's nine workloads and the scenario
# suite synthesized on the card at the main path's width, T_SYN intervals
T_SYN = 128    # cut from 1,024, then 512, 384 (synthesis and tuning) for
#                the reference engine, the other families' serving and the
#                tiers, then from 256 for the hybrid, vlm and MoE model
#                families' paths
SYN_CONFIGS = [dict(alpha_s=a, noise_z=z) for a, z in ((0.5, 0.0), (0.7, 0.0),
                                                      (0.5, 0.5), (0.7, 0.5))]
SEEDS = 16     # lanes of sweep_seeds
T_REF = 128    # intervals of the synthesis-against-reference comparison


def synth_paths(trace, seed: int) -> dict:
    """The trace-synthesis entry points at n = 65,536, k = 8,192 on
    ``pmem-large``: ``sweep_workload_configs`` of four ARMS configs over
    the nine named workloads (36 lanes; its first 64 intervals also under
    the profiler), ``sweep_workloads`` of the nine for ARMS, all-slow and
    the oracle at their defaults (exec time over all-slow's per workload;
    the tuning study's workloads and noise), the
    scenario suite under ARMS, and ``sweep_seeds`` of ARMS over 16 seeds
    on the main path's trace (``"prng"`` sampling).  -> ({path: launch
    counts}, {family: the comparison's rows, one a named workload})."""
    T_, n = T_SYN, N
    named = [workload_spec.named(nm, T=T_)
             for nm in workload_spec.NAMED_WORKLOADS]
    counts = {}
    mats = workload_spec.MATERIALIZE_CALLS
    run = lambda T__: scan_engine.sweep_workload_configs(
        lambda **kw: ARMSSpec.make(kw), SYN_CONFIGS, named, "pmem-large", K,
        T__, n, sim_seed=seed, wl_seed=seed + 1)
    res, wall, counts["synth_named"] = counted("synth_named",
                                               lambda: run(T_))
    lanes = len(named) * len(SYN_CONFIGS)
    flat = [r for row in res for r in row]
    s = summary(flat)
    require(len(flat) == lanes and all(np.isfinite(s["exec_time_s"]))
            and all(r.promotions > 0 for r in flat),
            "synth_named: non-finite exec_time or a lane with no promotion")
    print(f"main path synth sweep_workload_configs arms pmem-large: "
          f"lanes={lanes} T={T_} n={n} k={K} wall_s={wall:.3f} "
          f"lane_intervals_per_s={lanes * T_ / wall:.1f} "
          f"promotions={s['promotions']} demotions={s['demotions']} "
          f"wasteful={s['wasteful']} launches={counts['synth_named']}",
          flush=True)
    profiled(f"profile synth sweep_workload_configs T={T_PROF}",
             lambda: run(T_PROF), top=16)
    synth_reference(named, seed)

    walls = {}

    def compare():
        # the families the tuning study tunes are not run here: the
        # default config is in each grid, and the study's default rows
        # are these runs' rows bit for bit (PERF.md §4)
        out = {}
        for fam, make in FAMILY_DEFAULTS:
            if fam in dict(TUNED):
                continue
            t0 = time.time()
            # the tuning study's workloads and noise (a search
            # synthesizes with wl_seed 0 and scores under sim_seed)
            out[fam] = scan_engine.sweep_workloads(
                named, "pmem-large", K, T_, n, spec=make(), sim_seed=seed,
                wl_seed=0)
            walls[fam] = time.time() - t0
        return out

    res, wall, counts["synth_families"] = counted(
        "synth_families", compare,
        ("ewma_update", "topk_mask") + BINARY_KERNELS)
    comparison = res
    base = res["all-slow"]
    for fam, rows in res.items():
        require(all(np.isfinite(r.exec_time_s) for r in rows),
                f"synth {fam}: exec_time not finite")
        require(fam != "all-slow" or all(r.promotions == 0 for r in rows),
                "synth all-slow migrated a page")
        ratios = " ".join(
            f"{nm}={r.exec_time_s / b.exec_time_s:.4f}"
            for nm, r, b in zip(workload_spec.NAMED_WORKLOADS, rows, base))
        print(f"main path synth families pmem-large {fam}: T={T_} n={n} "
              f"k={K} lanes={len(rows)} wall_s={walls[fam]:.3f} "
              f"lane_intervals_per_s={len(rows) * T_ / walls[fam]:.1f} "
              f"promotions={sum(r.promotions for r in rows)} "
              f"vs_all_slow {ratios}", flush=True)

    suite = scenarios.suite(n, K)
    res, wall, counts["synth_suite"] = counted(
        "synth_suite", lambda: scan_engine.sweep_workloads(
            suite, "pmem-large", K, T_, n, sim_seed=seed, wl_seed=seed + 1))
    require(len(res) == len(suite)
            and all(np.isfinite(r.exec_time_s) for r in res),
            "synth_suite: non-finite exec_time")
    print(f"main path synth scenario suite arms pmem-large: "
          f"lanes={len(res)} T={T_} n={n} k={K} wall_s={wall:.3f} "
          f"lane_intervals_per_s={len(res) * T_ / wall:.1f} "
          + " ".join(f"{r.name}={r.exec_time_s:.4f}/{r.promotions}"
                     for r in res) + f" launches={counts['synth_suite']}",
          flush=True)
    require(workload_spec.MATERIALIZE_CALLS == mats,
            "a synthesized sweep materialized a trace")

    seeds = list(range(seed, seed + SEEDS))
    res, wall, counts["sweep_seeds"] = counted(
        "sweep_seeds", lambda: scan_engine.sweep_seeds(
            trace, "pmem-large", K, seeds))
    s = summary(res)
    require(all(np.isfinite(s["exec_time_s"])) and s["promotions"] > 0,
            "sweep_seeds: non-finite exec_time or no promotions")
    spread = max(s["exec_time_s"]) - min(s["exec_time_s"])
    print(f"main path sweep_seeds arms pmem-large: lanes={SEEDS} T={T_} "
          f"n={n} k={K} wall_s={wall:.3f} lane_intervals_per_s="
          f"{SEEDS * T_ / wall:.1f} promotions={s['promotions']} "
          f"exec_time_spread_s={spread:.6f} "
          f"launches={counts['sweep_seeds']}", flush=True)
    prng_costs(n)
    return counts, comparison


def synth_reference(named, seed: int):
    """``workload_spec.Synth``, which the engine runs, against the
    reference composition of the spec's own methods (``work_of(t) *
    step(state, t)``), on the nine named workloads stacked as the engine
    stacks them, the first T_REF intervals at n = 65,536: every row bit
    for bit, and each one's wall (a warm-up of 4 intervals apart)."""
    dev = torch.device("cuda")
    stack = scan_engine._stack_workloads(named, dev)
    key = prng.PRNGKey(seed + 1, dev)
    boost = any(w.has_boost() for w in named)

    def synth(T_):
        syn = workload_spec.Synth(stack, N, key, boost, T_)
        return [syn.row(t) for t in range(T_)]

    def reference(T_):
        st, out = stack.init(N, key), []
        for t in range(T_):
            st, probs = stack.step(st, t)
            out.append(stack.work_of(st, t)[..., None] * probs)
        return out

    rows, walls = {}, {}
    for label, fn in (("synth", synth), ("reference", reference)):
        fn(4)
        torch.cuda.synchronize()
        t0 = time.time()
        rows[label] = fn(T_REF)
        torch.cuda.synchronize()
        walls[label] = time.time() - t0
    require(all(torch.equal(a, b) for a, b in zip(rows["synth"],
                                                  rows["reference"])),
            "synth: Synth's rows != the reference composition's")
    W = len(named)
    print(f"synth against reference: W={W} T={T_REF} n={N} rows bit for "
          f"bit; Synth wall_s={walls['synth']:.3f} lane_intervals_per_s="
          f"{W * T_REF / walls['synth']:.1f}; reference wall_s="
          f"{walls['reference']:.3f} lane_intervals_per_s="
          f"{W * T_REF / walls['reference']:.1f}", flush=True)


def prng_costs(n: int, reps: int = 20):
    """Device time and device kernels of one threefry draw of each kind
    the synthesis and PRNG paths make (plain torch, no kernel of its own):
    the shared ``"crn_prng"`` row, a 16-lane ``"prng"`` block with its key
    split, and an event's permutation of n pages.  ``device_ms`` sums the
    draw's kernels (``torch.profiler``); ``stream_ms`` is the mean CUDA
    event time of ``reps`` draws back to back (host launch gaps
    included)."""
    from torch.profiler import ProfilerActivity, profile
    dev = torch.device("cuda")
    key = prng.PRNGKey(7, dev)
    keys = torch.stack([prng.PRNGKey(s, dev) for s in range(SEEDS)])
    draws = {
        "crn_prng row [n]": lambda: prng.uniform(prng.fold_in(key, 5), (n,)),
        f"prng block [{SEEDS}, n] + split": lambda: prng.uniform(
            prng.split(keys)[:, 1], (n,)),
        "permutation [n]": lambda: prng.permutation(
            prng.fold_in(prng.fold_in(key, 1), 3), n),
    }
    for label, fn in draws.items():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and e.self_device_time_total > 0
                  and not e.key.startswith("Activity Buffer")]
        start, end = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        print(f"prng cost {label}: device_ms="
              f"{sum(e.self_device_time_total for e in events) / 1e3:.4f} "
              f"device_kernels={sum(e.count for e in events)} "
              f"stream_ms={start.elapsed_time(end) / reps:.4f}", flush=True)


TRAIN_ARCH, TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = "stablelm-1.6b", 6, 2, 4096
# the paper's tuning study (its Tuned-HeMem, -Memtis and -TPP): each
# family's knob grid over the nine named workloads at the comparison's
# width and T, one pass of 9 x budget lanes (Memtis' and TPP's whole
# grids, HeMem's 24 of 480, the JAX default budget)
TUNED = (("hemem", 24), ("memtis", 20), ("tpp", 16))
ASHA_BUDGET = 24   # the ASHA search: HeMem's grid draw, eta 3
CE_BUDGET, CE_ROUNDS = 12, 3   # ARMS's CE search on the "pre" path
TM_BUDGET = 8      # the transfer matrix's ASHA search a machine
TM_MACHINES = ["pmem-large", "dram-cxl-pmem"]


def study_lanes() -> int:
    """The widest lane count of the main path: the study's HeMem pass."""
    return len(workload_spec.NAMED_WORKLOADS) * max(b for _, b in TUNED)


def rounds_line(sr) -> str:
    return " ".join(f"r{r.index}:T={r.horizon},lanes={r.lanes},"
                    f"pop={sum(len(p) for p in r.population.values())},"
                    f"passes={r.dispatches}" for r in sr.rounds)


def tuning_paths(trace, seed: int, comparison) -> dict:
    """The paper's tuning study and each search strategy on the card, at
    n = 65,536, k = 8,192 on ``pmem-large``:

      * ``tuning.tune`` (grid) of HeMem (24 configs), Memtis (20) and TPP
        (16) over the nine named workloads at T = 1,024, sim_seed the
        comparison's: one pass of 9 x budget lanes each (its first 128
        intervals also under the profiler, and its peak device memory);
        per workload the best config, the best tuned and the default
        config's exec time over all-slow's (the default config's rows
        complete the comparison of the six families at their defaults)
        and ARMS untuned over the best tuned (the paper's "within 3 %");
      * ``search.run`` ASHA of HeMem's 24 over the nine, its rounds and
        lane-intervals against the grid's, and its best against the
        grid's;
      * ``search.run`` CE of ARMS on the main path's GUPS-like trace
        (``"pre"`` path) and ``search.transfer_matrix`` of HeMem over
        ``pmem-large`` and the 3-tier ``dram-cxl-pmem`` on it, at the
        family paths' T.

    -> {path: launch counts}."""
    named = list(workload_spec.NAMED_WORKLOADS)
    W = len(named)
    base = {nm: r for nm, r in zip(named, comparison["all-slow"])}
    arms = {nm: r for nm, r in zip(named, comparison["arms"])}
    counts, grids, table = {}, {}, dict(comparison)
    for fam, budget in TUNED:
        defaults = tuning.FAMILIES[fam][2]
        kw = dict(workloads=named, T=T_SYN, n=N, strategy="grid",
                  budget=budget, search_seed=seed, sim_seed=seed)

        def run(kw=kw, fam=fam):
            with scan_engine.count_dispatches() as ctr:
                out = tuning.tune(fam, None, "pmem-large", K, **kw)
            return out, ctr.records

        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        (out, recs), wall, counts[f"tune_{fam}"] = counted(
            f"tune_{fam}", run, BINARY_KERNELS)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        lanes = W * budget
        require(len(recs) == 1 and recs[0]["lanes"] == lanes
                and recs[0]["T"] == T_SYN,
                f"tune {fam}: passes {[(r['lanes'], r['T']) for r in recs]}"
                f", expected one of {lanes} lanes")
        grids[fam] = out
        print(f"main path tune {fam} pmem-large: lanes={lanes} T={T_SYN} "
              f"n={N} k={K} wall_s={wall:.3f} lane_intervals_per_s="
              f"{lanes * T_SYN / wall:.1f} peak_device_memory_gib="
              f"{peak:.2f} launches={counts[f'tune_{fam}']}", flush=True)
        for nm in named:
            best_cfg, best, rows = out[nm]
            require(len(rows) == budget and all(
                np.isfinite(r.exec_time_s) for _, r in rows),
                f"tune {fam} {nm}: {len(rows)} rows or an exec time not "
                f"finite")
            dflt = [r for c, r in rows if c == defaults]
            require(len(dflt) == 1, f"tune {fam} {nm}: the default config "
                    f"is not in the grid")
            table.setdefault(fam, []).append(dflt[0])
            ratio = arms[nm].exec_time_s / best.exec_time_s
            print(f"main path tune {fam} {nm}: best={best_cfg} "
                  f"best_vs_all_slow="
                  f"{best.exec_time_s / base[nm].exec_time_s:.4f} "
                  f"default_vs_all_slow="
                  f"{dflt[0].exec_time_s / base[nm].exec_time_s:.4f} "
                  f"arms_untuned_over_best_tuned={ratio:.4f} "
                  f"within_3pct={ratio <= 1.03}", flush=True)
        profiled(f"profile tune {fam} T={T_PROF}", lambda: tuning.tune(
            fam, None, "pmem-large", K, **dict(kw, T=T_PROF)), top=6)
        rows = table[fam]
        print(f"main path synth families pmem-large {fam} (the study's "
              f"default config): promotions="
              f"{sum(r.promotions for r in rows)} vs_all_slow " + " ".join(
                  f"{nm}={r.exec_time_s / base[nm].exec_time_s:.4f}"
                  for nm, r in zip(named, rows)), flush=True)
    for i, nm in enumerate(named):
        order = sorted((f for f, _ in FAMILY_DEFAULTS),
                       key=lambda f: table[f][i].exec_time_s)
        print(f"main path synth comparison {nm}: fastest first "
              f"{' < '.join(order)}", flush=True)

    def asha():
        return search.run("hemem", "asha", workloads=named, T=T_SYN, n=N,
                          machine="pmem-large", k=K, budget=ASHA_BUDGET,
                          search_seed=seed, sim_seed=seed)

    out, wall, counts["asha_hemem"] = counted("asha_hemem", asha,
                                              BINARY_KERNELS)
    sr = out[named[0]]
    grid_li = W * ASHA_BUDGET * T_SYN
    require(all(r.dispatches == 1 for r in sr.rounds)
            and sr.rounds[-1].horizon == T_SYN, "asha: rounds")
    better = sum(out[nm].best_result.exec_time_s
                 <= grids["hemem"][nm][1].exec_time_s for nm in named)
    print(f"main path asha hemem pmem-large: T={T_SYN} n={N} k={K} "
          f"wall_s={wall:.3f} rounds={len(sr.rounds)} [{rounds_line(sr)}] "
          f"lane_intervals={sr.lane_intervals} grid_lane_intervals={grid_li} "
          f"share={sr.lane_intervals / grid_li:.4f} "
          f"best_as_good_as_grid={better}/{W} "
          + " ".join(f"{nm}={out[nm].best_result.exec_time_s:.4f}/"
                     f"{grids['hemem'][nm][1].exec_time_s:.4f}"
                     for nm in named)
          + f" launches={counts['asha_hemem']}", flush=True)

    T_, n = trace.shape

    def ce():
        sr = search.run("arms", "ce", trace=trace, machine="pmem-large",
                        k=K, budget=CE_BUDGET, ce_rounds=CE_ROUNDS,
                        search_seed=seed, sim_seed=seed + 1)
        return sr, dict(scan_engine.last_dispatch)

    (sr, last), wall, counts["ce_arms"] = counted("ce_arms", ce)
    require(last["sampling"] == "pre" and len(sr.rounds) == CE_ROUNDS
            and all(r.dispatches == 1 for r in sr.rounds),
            f"ce arms: sampling {last['sampling']}, rounds "
            f"{rounds_line(sr)}")
    print(f"main path ce arms pmem-large pre: T={T_} n={n} k={K} "
          f"wall_s={wall:.3f} [{rounds_line(sr)}] lane_intervals="
          f"{sr.lane_intervals} best={sr.best_config} "
          f"best_exec_time_s={sr.best_result.exec_time_s:.6f} "
          f"launches={counts['ce_arms']}", flush=True)

    tm, wall, counts["transfer_hemem"] = counted(
        "transfer_hemem", lambda: search.transfer_matrix(
            "hemem", trace, TM_MACHINES, K, budget=TM_BUDGET,
            search_seed=seed, sim_seed=seed + 1), BINARY_KERNELS)
    require(np.allclose(np.diag(tm.slowdown), 1.0)
            and np.isfinite(tm.exec_time).all(), "transfer matrix")
    print(f"main path transfer_matrix hemem: T={T_} n={n} k={K} "
          f"wall_s={wall:.3f} " + " ".join(
              f"{r['tuned_on']}->{r['slowdown']}" for r in tm.rows())
          + f" tuned={tm.tuned} launches={counts['transfer_hemem']}",
          flush=True)
    return counts


# the paper's robustness leaderboard (benchmarks/bench_robustness.py's
# axes): every family of the suite x the adversarial scenarios x one machine
# of each tier topology, ONE experiment.sweep that the union fabric fuses
# into ONE pass
BOARD_POLICIES = ("oracle", "arms", "hemem", "memtis", "tpp", "hybridtier",
                  "jenga", "tierbpf")
BOARD_MACHINES = ("pmem-large", "cxl-1hop", "dram-cxl-pmem")
T_BOARD = 128   # cut from 1,024, then 512, 256, for the same paths
BOARD_KERNELS = ("ewma_update", "topk_mask", "interval_account")


def board_sweep(seed: int, T_: int, n: int = N, k: int = K, **kw):
    """The board's ``experiment.sweep`` (default dispatch unless ``kw``
    says otherwise), with its pass records."""
    with scan_engine.count_dispatches() as ctr:
        res = experiment.sweep(
            list(BOARD_POLICIES), workloads=scenarios.suite(n, k),
            machines=list(BOARD_MACHINES), k=k, T=T_, n=n, sim_seed=seed,
            wl_seed=seed, **kw)
    return res, ctr.records


def leaderboard(res) -> dict:
    """{policy: (worst slowdown, its cell, mean slowdown, worst thrash,
    mean thrash)}: each cell's exec time over the oracle's on the same
    cell, thrash the wasteful share of its migrations."""
    cells = [(w, m) for w in res.axes["workload"] for m in res.axes["machine"]]
    oracle = {c: res.at(policy="oracle", workload=c[0],
                        machine=c[1]).exec_time_s for c in cells}
    board = {}
    for p in BOARD_POLICIES:
        rows = []
        for c in cells:
            r = res.at(policy=p, workload=c[0], machine=c[1])
            rows.append((r.exec_time_s / oracle[c], f"{c[0]}@{c[1]}",
                         r.wasteful / max(r.promotions + r.demotions, 1)))
        worst = max(rows)
        board[p] = (worst[0], worst[1], sum(r[0] for r in rows) / len(rows),
                    max(r[2] for r in rows), sum(r[2] for r in rows)
                    / len(rows))
    return board


def board_paths(seed: int) -> dict:
    """The robustness leaderboard on the card: the eight families x the
    seven scenarios of ``scenarios.suite(65536, 8192)`` x ``pmem-large``,
    ``cxl-1hop`` and ``dram-cxl-pmem`` (2 and 3 tiers in one pass), T =
    1,024, ``sim_seed`` and ``wl_seed`` the seed: 168 lanes in ONE union
    pass (``dispatch="union"``, ``families=8``), its lane-intervals/s
    over its wall (set-up included), peak device memory, the busy share
    of its first 64 intervals and each policy's worst and mean slowdown
    over the oracle and its thrash.  -> {path: launch counts}."""
    lanes = len(BOARD_POLICIES) * len(scenarios.suite(N, K)) \
        * len(BOARD_MACHINES)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    (res, recs), wall, counts = counted(
        "board", lambda: board_sweep(seed, T_BOARD), BOARD_KERNELS)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    passes = [(r["dispatch"], r["families"], r["lanes"]) for r in recs]
    require(len(recs) == 1 and recs[0]["dispatch"] == "union"
            and recs[0]["families"] == len(BOARD_POLICIES)
            and recs[0]["lanes"] == lanes and recs[0]["T"] == T_BOARD,
            f"board: passes {passes}, expected one union pass of {lanes} "
            f"lanes")
    require(all(np.isfinite(r.exec_time_s) for _, r in res.items())
            and sum(r.promotions for _, r in res.items()) > 0,
            "board: an exec time not finite or no promotion")
    print(f"main path board: lanes={lanes} T={T_BOARD} n={N} k={K} "
          f"passes=1 dispatch=union families={recs[0]['families']} "
          f"wall_s={wall:.3f} lane_intervals_per_s="
          f"{lanes * T_BOARD / wall:.1f} peak_device_memory_gib={peak:.2f} "
          f"launches={counts}", flush=True)
    board = leaderboard(res)
    for p in sorted(board, key=lambda q: board[q][0]):
        worst, cell, mean, wthr, mthr = board[p]
        print(f"main path board {p}: worst_slowdown={worst:.4f} "
              f"worst_cell={cell} mean_slowdown={mean:.4f} "
              f"worst_thrash={wthr:.4f} mean_thrash={mthr:.4f}", flush=True)
    profiled(f"profile board T={T_PROF}",
             lambda: board_sweep(seed, T_PROF), top=8)
    return {"board": counts}


def board_check(seed: int):
    """The board's union pass held three ways: at full width (168 lanes,
    n = 65,536) for T = 256 against ``dispatch="grouped"`` (eight passes
    of 21 lanes) bit for bit on every field and timeline; at n = 4,096 (k
    = 512, T = 128) card == CPU (counts and integer timelines exact,
    exec_time within 1e-4 relative); and there a mesh of 1 with lanes
    padded to a multiple of 5 bit for bit the plain union pass."""
    fields = [fl.name for fl in dataclasses.fields(SimResult)
              if fl.name != "name"]

    def bitwise(ra, rb, what):
        require(ra.axes == rb.axes, f"{what}: axes differ")
        for (c, a), (_, b) in zip(ra.items(), rb.items()):
            for fl in fields:
                va, vb = getattr(a, fl), getattr(b, fl)
                require(np.array_equal(np.asarray(va), np.asarray(vb)),
                        f"{what} {c} {fl}: {va} != {vb}")

    walls = {}

    def timed(label, *args, **kw):
        torch.cuda.synchronize()
        t0 = time.time()
        out = board_sweep(seed, *args, **kw)
        torch.cuda.synchronize()
        walls[label] = time.time() - t0
        return out

    union, recs = timed("union", 256, timelines=True)
    require(len(recs) == 1 and recs[0]["dispatch"] == "union", "board union")
    grouped, grecs = timed("grouped", 256, timelines=True,
                           dispatch="grouped")
    require(len(grecs) == len(BOARD_POLICIES), "board grouped passes")
    bitwise(union, grouped, "board union vs grouped")
    print(f"board check: full width (lanes={recs[0]['lanes']} n={N} "
          f"T=256) union == grouped bit for bit on every field and "
          f"timeline; union wall_s={walls['union']:.3f}, grouped "
          f"({len(grecs)} passes) wall_s={walls['grouped']:.3f}",
          flush=True)
    del union, grouped
    torch.cuda.empty_cache()
    n, k, T_ = 4096, 512, 128
    runs = {dev: board_sweep(seed, T_, n, k, timelines=True, device=dev)[0]
            for dev in ("cuda", "cpu")}
    for (c, a), (_, b) in zip(runs["cuda"].items(), runs["cpu"].items()):
        same_runs(a, b, f"board {c}")
    padded, precs = board_sweep(seed, T_, n, k, timelines=True, mesh=1,
                                _pad_multiple=5)
    require(precs[0]["padded_lanes"] == 170 and precs[0]["mesh"] == 1,
            f"board padding: {precs[0]}")
    bitwise(padded, runs["cuda"], "board mesh=1 pad_multiple=5")
    promos = [r.promotions for _, r in runs["cuda"].items()]
    print(f"board check: n={n} T={T_} card == cpu over {len(promos)} lanes "
          f"(promotions {sum(promos)}); mesh=1 padded to 170 lanes bit "
          f"for bit the plain union pass", flush=True)


def search_check(seed: int, n: int = 4096, T_: int = 256, k: int = 512):
    """The search engine on the card against the CPU at n = 4,096, T =
    256 over three named workloads: a grid (HeMem, 8 configs), an ASHA
    (TPP, 9) and a CE search (Memtis, 9 draws in 3 rounds), their
    rankings, survivors, round records and pass counts equal, every row's
    counts exact and exec_time within 1e-4 relative; and a synthesized
    ``experiment.sweep`` over a mixed 2/3-tier machine panel with two
    seeds (``"prng"`` noise), HeMem and Jenga, every cell likewise."""
    wls = ["gups", "silo-tpcc", "gapbs-bc"]
    runs = {}
    for dev in ("cuda", "cpu"):
        kw = dict(workloads=wls, T=T_, n=n, k=k, search_seed=seed,
                  sim_seed=seed, device=dev)
        with scan_engine.count_dispatches() as ctr:
            runs[dev] = [
                search.run("hemem", "grid", budget=8, **kw),
                search.run("tpp", "asha", budget=9, **kw),
                search.run("memtis", "ce", budget=9, ce_rounds=3, **kw)]
        runs[dev].append(ctr.count)
    require(runs["cuda"][-1] == runs["cpu"][-1], "search: pass counts")
    for gpu, cpu in zip(runs["cuda"][:-1], runs["cpu"][:-1]):
        for g in wls:
            a, b = gpu[g], cpu[g]
            what = f"search {a.family} {a.strategy} {g}"
            require([c for c, _ in a.rows] == [c for c, _ in b.rows]
                    and a.best_config == b.best_config,
                    f"{what}: rankings differ")
            require(all((ra.index, ra.horizon, ra.population, ra.survivors,
                         ra.lanes, ra.dispatches, ra.lane_intervals)
                        == (rb.index, rb.horizon, rb.population,
                            rb.survivors, rb.lanes, rb.dispatches,
                            rb.lane_intervals)
                        for ra, rb in zip(a.rounds, b.rounds))
                    and len(a.rounds) == len(b.rounds),
                    f"{what}: round records differ")
            for (_, ra), (_, rb) in zip(a.rows, b.rows):
                same_runs(ra, rb, what, timelines=False)
    kw = dict(workloads=["gups", "silo-tpcc"], machines=TM_MACHINES,
              seeds=[seed, seed + 1], k=k, T=T_, n=n, dispatch="grouped")
    sweeps = [experiment.sweep(["hemem", "jenga"], device=dev, **kw)
              for dev in ("cuda", "cpu")]
    require(sweeps[0].axes == sweeps[1].axes, "sweep: axes differ")
    for (c, a), (_, b) in zip(sweeps[0].items(), sweeps[1].items()):
        same_runs(a, b, f"sweep {c}", timelines=False)
    promos = [r.promotions for _, r in sweeps[0].items()]
    require(len(set(promos)) > 1, f"sweep: every lane took one path "
            f"({promos})")
    bests = [r[wls[0]].best_config for r in runs["cuda"][:-1]]
    print(f"search check: card == cpu for grid/asha/ce over {wls} "
          f"(rankings, survivors, rounds equal; {runs['cuda'][-1]} passes), "
          f"best on {wls[0]} {bests}; a 2-seed mixed-tier synthesized sweep "
          f"(promotions {promos})", flush=True)


TRAIN_KERNELS = ("flash_attention_fwd", "flash_attention_bwd")
SSM_ARCH = "mamba2-370m"
SSM_KERNELS = ("mamba_scan_fwd", "mamba_scan_bwd")
DECODE_BATCH, DECODE_TOKENS = 8, 128
SCAN_KERNEL = re.compile(r"(void )?ms_[a-z_]+[<(]")


def plain_scan(x, dt, A, Bm, Cm, *, chunk):
    return sref.mamba_scan_ref(x, dt, A, Bm, Cm, chunk)


def train_breakdown(arch: str, seed: int, first_loss: float, swap,
                    is_kernel, what: str, batch_size: int = None):
    """The full-width model against its plain version, and where a
    training step's time goes.  With the train phase's weights (the same
    seed) and first batch, the loss through the kernels must equal that
    phase's first loss (1e-6 relative) and be within 1e-2 of the loss
    with the plain version of ``what`` (``swap``: the module attribute
    that holds the op, and a stand-in holding the plain version; for
    attention, bf16 scores rounded before the f32 softmax, the JAX
    reference's arithmetic).  Then, after one warm-up step, CUDA events
    split a step into forward (loss), backward (``autograd.grad``) and
    optimizer (``adamw.update``), and one step runs under
    ``torch.profiler`` for the busy share, the device time by kernel and
    the share of the kernels whose names ``is_kernel`` matches; there the
    raw reader every window uses (``device_totals``) must give
    ``key_averages``' device time and count for each name.  The batch is
    the train phase's (``batch_size``, TRAIN_BATCH by default)."""
    from torch.profiler import ProfilerActivity, profile
    dev = torch.device("cuda")
    cfg, opt_cfg, params, st = train.setup(arch, TRAIN_STEPS, full=True,
                                           seed=seed)
    data = SyntheticLM(cfg.vocab_size_raw, TRAIN_SEQ,
                       batch_size or TRAIN_BATCH, seed=seed)
    with torch.no_grad():
        batch = train.to_device(data.batch_at(0), dev)
        kernel_loss = float(M.loss_fn(params, batch, cfg))
        module, attr, plain = swap
        held = getattr(module, attr)
        setattr(module, attr, plain)
        try:
            plain_loss = float(M.loss_fn(params, batch, cfg))
        finally:
            setattr(module, attr, held)
        del batch
    rel = abs(kernel_loss - plain_loss) / abs(plain_loss)
    require(abs(kernel_loss - first_loss) <= 1e-6 * abs(first_loss)
            and rel <= 1e-2,
            f"train {arch}: first loss {first_loss}, recomputed "
            f"{kernel_loss}, plain {what} {plain_loss} (rel {rel})")
    print(f"train check {arch} full width: first-batch loss through the "
          f"kernels {kernel_loss} (the train phase's first: {first_loss}), "
          f"with the plain {what} {plain_loss}, rel {rel:.3e}; ln(vocab) = "
          f"{np.log(cfg.vocab_size):.4f}", flush=True)

    def step(i, ev=None):
        batch = train.to_device(data.batch_at(i), dev)
        alias = [p.detach().requires_grad_() for p in leaves(params)]
        if ev:
            ev[0].record()
        loss = M.loss_fn(unflatten(params, alias), batch, cfg)
        if ev:
            ev[1].record()
        grads = torch.autograd.grad(loss, alias)
        if ev:
            ev[2].record()
        adamw.update(unflatten(params, list(grads)), st, params, opt_cfg)
        if ev:
            ev[3].record()
        return float(loss.detach())

    step(0)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    t0 = time.time()
    step(1, ev)
    torch.cuda.synchronize()
    wall = time.time() - t0
    fwd, bwd, opt = (ev[i].elapsed_time(ev[i + 1]) for i in range(3))
    print(f"train breakdown {arch}: one step wall_s={wall:.4f}: forward "
          f"{fwd:.2f} ms, backward {bwd:.2f} ms, optimizer {opt:.2f} ms "
          f"(device timeline between events)", flush=True)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        step(2)
        torch.cuda.synchronize()
        wall = time.time() - t0
    device_rows(prof, f"profile train {arch} 1 step", wall, 1)
    totals = device_totals(prof)
    averaged = {e.key: (e.self_device_time_total, e.count)
                for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and e.self_device_time_total > 0
                and not e.key.startswith("Activity Buffer")}
    require(totals.keys() == averaged.keys() and all(
        totals[k][1] == averaged[k][1]
        and abs(totals[k][0] - averaged[k][0]) <= 1e-6 * averaged[k][0]
        for k in totals), f"train {arch}: the raw device events disagree "
        f"with key_averages")
    busy = sum(us for us, _ in totals.values())
    ours = sum(us for k, (us, _) in totals.items() if is_kernel(k))
    print(f"train breakdown {arch}: {what} kernels {ours / 1e3:.2f} ms of "
          f"{busy / 1e3:.2f} ms device busy, share={ours / busy:.4f}; the "
          f"raw device events equal key_averages on {len(totals)} names",
          flush=True)


def ssm_paths(seed: int) -> dict:
    """mamba2-370m at full width through the serving steps: one
    ``make_prefill_step`` at batch 2 x 4,096 (the forward kernel must
    run) and ``make_serve_step`` decoding 128 greedy tokens at batch 8
    from ``init_cache`` (the recurrence in plain torch, no kernel).  ->
    {path: launch counts}."""
    dev = torch.device("cuda")
    cfg = registry.get_arch(SSM_ARCH)
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(
        seed), dev)
    batch = train.to_device(SyntheticLM(cfg.vocab_size_raw, TRAIN_SEQ,
                                        TRAIN_BATCH, seed=seed).batch_at(0),
                            dev)
    prefill = steps.make_prefill_step(cfg)
    torch.cuda.reset_peak_memory_stats()
    logits, wall, pre_counts = clocked(
        "prefill_ssm", lambda: prefill(params, batch), ("mamba_scan_fwd",))
    require(logits.shape == (TRAIN_BATCH, TRAIN_SEQ, cfg.vocab_size)
            and bool(torch.isfinite(logits).all()),
            "prefill_ssm: logits not finite or of another shape")
    print(f"main path prefill {SSM_ARCH} full: batch={TRAIN_BATCH} "
          f"seq={TRAIN_SEQ} wall_s={wall:.4f} "
          f"tok_s={TRAIN_BATCH * TRAIN_SEQ / wall:.1f} peak_device_memory_"
          f"gib={torch.cuda.max_memory_allocated() / 2 ** 30:.2f} "
          f"launches={pre_counts}", flush=True)
    del logits, batch
    serve_step = steps.make_serve_step(cfg)

    def decode():
        cache = M.init_cache(cfg, DECODE_BATCH, DECODE_TOKENS, dev)
        tok = torch.zeros((DECODE_BATCH, 1), dtype=torch.int32, device=dev)
        out = []
        for t in range(DECODE_TOKENS):
            tok, cache = serve_step(params, tok, cache, t)
            out.append(tok)
        return torch.cat(out, 1), cache

    (toks, cache), wall, dec_counts = counted("decode_ssm", decode, ())
    require(bool(((toks >= 0) & (toks < cfg.vocab_size)).all())
            and bool(torch.isfinite(cache.ssm.float()).all()),
            "decode_ssm: tokens out of range or state not finite")
    print(f"main path decode {SSM_ARCH} full: batch={DECODE_BATCH} "
          f"tokens={DECODE_TOKENS} wall_s={wall:.4f} "
          f"tok_s={DECODE_BATCH * DECODE_TOKENS / wall:.1f} distinct_tokens="
          f"{int(torch.unique(toks).numel())} launches={dec_counts}",
          flush=True)
    return {"prefill_ssm": pre_counts, "decode_ssm": dec_counts}


def ssm_consistency(seed: int, T_: int = 128, tol: float = 1e-2):
    """mamba2-370m at full width and depth in f32 (TF32 off), random
    weights from the seed: the prefill logits over ``T_`` tokens through
    the forward kernel (two chunks of 64) against the recurrent decode's
    logits token by token, the max difference within ``tol`` of the
    largest logit.  The two paths share no scan code: the chunked scan
    sums decays as exp of cumsum differences, the recurrence multiplies
    exp(dt A) a step at a time."""
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(registry.get_arch(SSM_ARCH), dtype="float32")
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(
        seed), dev)
    tokens = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab_size_raw, (1, T_)).astype(np.int32)).to(dev)
    before = _backend.launches["mamba_scan_fwd"]
    with torch.no_grad():
        pre = M.prefill(params, {"tokens": tokens}, cfg)[0]
    torch.cuda.synchronize()
    require(_backend.launches["mamba_scan_fwd"] == before + cfg.n_layers,
            "ssm consistency: the prefill did not run the forward kernel")
    cache = M.init_cache(cfg, 1, T_, dev)
    dec = []
    for t in range(T_):
        logits, cache = M.decode_step(params, tokens[:, t: t + 1], cache, t,
                                      cfg)
        dec.append(logits[0, 0])
    dec = torch.stack(dec)
    err = float((pre.double() - dec.double()).abs().max())
    top = float(pre.abs().max())
    agree = float((pre.argmax(-1) == dec.argmax(-1)).float().mean())
    require(err <= tol * top, f"ssm consistency: prefill vs decode error "
            f"{err} > {tol} x {top}")
    print(f"ssm consistency {SSM_ARCH} full width f32: prefill (kernel) vs "
          f"recurrent decode over {T_} tokens: max_abs_err={err} "
          f"max_logit={top} rel={err / top:.3e} argmax_agree={agree}",
          flush=True)
    del params, cache
    torch.cuda.empty_cache()


# the other model families at full width: zamba2-1.2b (hybrid) trains,
# prefills and serves at its depth; llava-next-mistral-7b (vlm) prefills
# and serves at its depth; llama4-scout (MoE) at its published widths cut
# to one dense + MoE super-layer (4,460,487,680 params; 48 layers are
# 119 GB in bf16)
HYBRID_ARCH, VLM_ARCH, MOE_ARCH = ("zamba2-1.2b", "llava-next-mistral-7b",
                                   "llama4-scout")
# zamba2-1.2b's train batch (x TRAIN_SEQ tokens): on an NVIDIA H100 80GB
# HBM3 (700 W) batch 2 ran out of memory at its third step in this script
# (70.06 GiB allocated, 78.30 GiB held by the process, after the earlier
# phases), so it takes batch 1
HYBRID_BATCH = 1
MOE_LAYERS = 2
HYBRID_KERNELS = TRAIN_KERNELS + SSM_KERNELS


def family_paths(seed: int) -> dict:
    """The hybrid, vlm and MoE families on the card.  zamba2-1.2b:
    ``launch.train.train`` for 6 AdamW steps at HYBRID_BATCH x 4,096 (both
    flash and both scan kernels; its breakdown against the plain scan),
    then ``make_prefill_step`` at 2 x 4,096 and the ARMS serve; llava:
    prefill of 576 patch embeddings (numpy, from the seed) + 4,096 tokens
    at batch 2, then the ARMS serve; llama4-scout at one super-layer: the
    same.  Each serve: batch 8, SERVE_TOKENS tokens, pages of PG, as
    granite-8b's; ``paged_attention`` and ``migrate`` must run.  ->
    {path: launch counts}."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    losses, wall, counts = clocked("train_hybrid", lambda: train.train(
        HYBRID_ARCH, TRAIN_STEPS, HYBRID_BATCH, TRAIN_SEQ, full=True,
        seed=seed, log_every=1), HYBRID_KERNELS)
    require(len(losses) == TRAIN_STEPS and all(np.isfinite(losses)),
            f"train_hybrid: losses {losses} not finite")
    tokens = TRAIN_STEPS * HYBRID_BATCH * TRAIN_SEQ
    print(f"main path train {HYBRID_ARCH} full: steps={TRAIN_STEPS} "
          f"batch={HYBRID_BATCH} seq={TRAIN_SEQ} wall_s={wall:.3f} "
          f"tok_s_overall={tokens / wall:.1f} loss_first={losses[0]:.4f} "
          f"loss_last={losses[-1]:.4f} peak_device_memory_gib="
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} "
          f"launches={counts}", flush=True)
    out = {"train_hybrid": counts}
    torch.cuda.empty_cache()
    train_breakdown(HYBRID_ARCH, seed, losses[0], (Mb, "scan_ops",
                    types.SimpleNamespace(mamba_scan=plain_scan)),
                    lambda k: bool(SCAN_KERNEL.match(k))
                    or k.startswith("void fa_"), "scan",
                    batch_size=HYBRID_BATCH)
    stamp("main path train_hybrid")
    moe = dataclasses.replace(registry.get_arch(MOE_ARCH),
                              n_layers=MOE_LAYERS)
    for tag, cfg, pre_kernels in (
            ("hybrid", registry.get_arch(HYBRID_ARCH),
             ("flash_attention_fwd", "mamba_scan_fwd")),
            ("vlm", registry.get_arch(VLM_ARCH), ("flash_attention_fwd",)),
            ("moe", moe, ("flash_attention_fwd",))):
        torch.cuda.empty_cache()
        out.update(prefill_and_serve(tag, cfg, seed, pre_kernels))
        stamp(f"main path {tag} prefill and serve")
    return out


# the MLA and enc-dec families at full width: deepseek-v2-236b at its
# published widths cut to its dense layer 0 + one MoE layer
# (5,358,679,040 params, 10.7 GB in bf16; 60 layers are 471 GB) prefills
# and serves; whisper-small (238,139,904 params) trains, prefills and
# serves at its depth, its decoder over WHISPER_SEQ tokens (its published
# text context, arXiv:2212.04356) beside the 1,500 stub frames
MLA_ARCH, ENCDEC_ARCH = "deepseek-v2-236b", "whisper-small"
MLA_LAYERS = 2
WHISPER_SEQ = 448


def mla_encdec_paths(seed: int) -> dict:
    """deepseek-v2-236b at layer 0 + one MoE layer: ``make_prefill_step``
    at 2 x 4,096 (MLA's (192, 128) flash forward) and the ARMS serve;
    whisper-small: ``launch.train.train`` for 6 AdamW steps at batch 2 x
    WHISPER_SEQ over the launcher's zero frames (both flash kernels: the
    encoder's non-causal rows over 1,500 frames, the decoder's causal
    ones), then ``make_prefill_step`` over frames drawn with numpy from
    the seed and the ARMS serve.  Each serve as granite-8b's.  -> {path:
    launch counts}."""
    out = {}
    mla = dataclasses.replace(registry.get_arch(MLA_ARCH),
                              n_layers=MLA_LAYERS)
    torch.cuda.empty_cache()
    out.update(prefill_and_serve("mla", mla, seed, ("flash_attention_fwd",)))
    stamp("main path mla prefill and serve")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    losses, wall, counts = clocked("train_encdec", lambda: train.train(
        ENCDEC_ARCH, TRAIN_STEPS, TRAIN_BATCH, WHISPER_SEQ, full=True,
        seed=seed, log_every=1), TRAIN_KERNELS)
    require(len(losses) == TRAIN_STEPS and all(np.isfinite(losses)),
            f"train_encdec: losses {losses} not finite")
    tokens = TRAIN_STEPS * TRAIN_BATCH * WHISPER_SEQ
    print(f"main path train {ENCDEC_ARCH} full: steps={TRAIN_STEPS} "
          f"batch={TRAIN_BATCH} seq={WHISPER_SEQ} frames="
          f"{registry.get_arch(ENCDEC_ARCH).enc_seq} wall_s={wall:.3f} "
          f"tok_s_overall={tokens / wall:.1f} loss_first={losses[0]:.4f} "
          f"loss_last={losses[-1]:.4f} peak_device_memory_gib="
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} "
          f"launches={counts}", flush=True)
    out["train_encdec"] = counts
    torch.cuda.empty_cache()
    out.update(prefill_and_serve("encdec", registry.get_arch(ENCDEC_ARCH),
                                 seed, ("flash_attention_fwd",),
                                 seq=WHISPER_SEQ))
    stamp("main path encdec train, prefill and serve")
    return out


def prefill_and_serve(tag: str, cfg, seed: int, pre_kernels,
                      seq: int = TRAIN_SEQ) -> dict:
    """``cfg`` at full width, random weights from the seed: one
    ``make_prefill_step`` at batch 2 x ``seq`` tokens (a vlm's patches
    before them, an enc-dec model's frames beside them, numpy from the
    seed) and a profiled second one (busy share), then the ARMS serve
    with those weights and its breakdown.  -> {path: launch counts}."""
    dev = torch.device("cuda")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(
        seed), dev)
    torch.cuda.synchronize()
    print(f"main path {tag}: {cfg.name} weights ({cfg.n_layers} layers, "
          f"{cfg.n_params:,} params) made in {time.time() - t0:.3f}s",
          flush=True)
    batch = train.to_device(SyntheticLM(cfg.vocab_size_raw, seq,
                                        TRAIN_BATCH, seed=seed).batch_at(0),
                            dev)
    S_all, what = seq, ""
    draw = lambda n: torch.from_numpy(np.random.default_rng(
        seed).standard_normal((TRAIN_BATCH, n, cfg.d_model),
                              dtype=np.float32)).to(dev)
    if cfg.family == "vlm":
        batch["patch_embeds"] = draw(cfg.n_patches)
        S_all += cfg.n_patches
        what = f" ({cfg.n_patches} patches)"
    if cfg.family == "encdec":
        batch["audio_embeds"] = draw(cfg.enc_seq).to(dtype_of(cfg))
        what = f" (beside {cfg.enc_seq} frames)"
    prefill = steps.make_prefill_step(cfg)
    logits, wall, pre_counts = clocked(
        f"prefill_{tag}", lambda: prefill(params, batch), pre_kernels)
    require(logits.shape == (TRAIN_BATCH, S_all, cfg.vocab_size)
            and bool(torch.isfinite(logits).all()),
            f"prefill_{tag}: logits not finite or of another shape")
    print(f"main path prefill {cfg.name} full: batch={TRAIN_BATCH} "
          f"seq={S_all}{what} wall_s={wall:.4f} "
          f"tok_s={TRAIN_BATCH * S_all / wall:.1f} peak_device_memory_gib="
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} "
          f"launches={pre_counts}", flush=True)
    del logits
    profiled(f"profile prefill {cfg.name}", lambda: prefill(params, batch))
    del batch
    torch.cuda.reset_peak_memory_stats()
    (rep, syncs), wall, counts = counted(f"serve_{tag}", lambda: synced(
        lambda: serve.serve(cfg, n_tokens=SERVE_TOKENS, batch=SB, full=True,
                            seed=seed, page_size=PG, quiet=True,
                            params=params)), SERVE_KERNELS)
    require(rep.fast_mass.shape == (SERVE_TOKENS,)
            and bool(np.isfinite(rep.fast_mass).all())
            and np.isfinite(rep.slowdown) and rep.promotions > 0,
            f"serve_{tag}: non-finite telemetry or no promotions")
    print(f"main path serve_{tag} {cfg.name} full: tokens={SERVE_TOKENS} "
          f"batch={SB} pages={rep.kv.in_fast.shape[0]} of {PG} "
          f"wall_s={wall:.3f} init_s={rep.init_s:.3f} "
          f"decode_s={SERVE_TOKENS * SB / rep.tok_s:.3f} "
          f"tok_s={rep.tok_s:.1f} promotions={rep.promotions} "
          f"demotions={rep.demotions} thrash={rep.thrash:.4f} "
          f"slowdown={rep.slowdown:.4f} host_syncs_run={syncs} "
          f"peak_device_memory_gib="
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} "
          f"launches={counts}", flush=True)
    del rep
    serve_breakdown(seed, params, T_=8, T_prof=8, arch=cfg)
    del params
    torch.cuda.empty_cache()
    return {f"prefill_{tag}": pre_counts, f"serve_{tag}": counts}


SERVE_TOKENS = 128   # every family's run (ARMS's cut from 512, pages of
#                     16 -> 4, for this slice's new paths: under 700 s)


def synced(run):
    """``run()`` under PyTorch's sync debug mode: -> (its result, the host
    syncs it made)."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = run()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum("synchronizing CUDA operation" in str(w.message)
                    for w in caught)


def capture_check(rep):
    """The ARMS run's ``--capture`` trace against the access rows it
    served: one interval a ``policy_every`` tokens over the run's pages,
    and each served row's attention mass sums to batch x heads (a softmax
    a query head), so each interval holds ``policy_every`` times that."""
    tr, n = rep.trace, rep.kv.in_fast.shape[0]
    group = tr.meta["group"]
    require(tr.meta["steps"] == SERVE_TOKENS and tr.n == n
            and tr.T == -(-SERVE_TOKENS // group),
            f"capture: trace [{tr.T}x{tr.n}] of {tr.meta['steps']} steps")
    per_token = SB * SH
    want = np.full(tr.T, float(group * per_token))
    want[-1] = (SERVE_TOKENS - group * (tr.T - 1)) * per_token
    err = float(np.abs(tr.counts.sum(axis=1) / want - 1.0).max())
    require(err <= 1e-4 and bool((tr.counts >= 0).all()),
            f"capture: interval mass off by {err}")
    print(f"serve capture: trace [{tr.T}x{tr.n}] from {SERVE_TOKENS} "
          f"served rows grouped by {group}; each interval's mass "
          f"{group} x {per_token} within {err:.2e}", flush=True)


def sparse_check(rep, seed: int):
    """Sparse attention on the ARMS run's final paged KV against full
    paged attention (the kernel) at its last position.  For each query
    head, full attention is ``(1 - m) o_att + m o_skip`` with ``m`` the
    head's softmax mass on the skipped pages, so the gap is ``m |o_att -
    o_skip|``.  Gate: every head's gap at most ``2 m max|v|`` (+1e-5),
    ``m`` from a plain f64 softmax over the gathered pages.  Also printed:
    the JAX test's ratio (gap over the largest output entry against the
    skipped share of the summed mass), a bound its skewed decode meets and
    these random streams need not."""
    kv = rep.kv
    n = kv.in_fast.shape[0]
    cfg = PK.PagedKVConfig(page_size=PG, n_pages=n, fast_pages=kv.fast_pages,
                           policy_every=4)
    q = torch.randn((SB, SH, DH), generator=torch.Generator().manual_seed(
        seed + 7)).cuda()
    pos = SERVE_TOKENS - 1
    full, mass = PK.paged_attention_step(kv, q, pos, cfg)
    sparse, _, frac = sparse_attention_step(kv, q, pos, cfg)
    page = torch.arange(n, device=q.device)
    attended = (kv.in_fast | ((page >= pos // PG - 1) & (page <= pos // PG))
                | (page == 0))
    # each head's skipped softmax mass, plain f64 over the gathered pages
    k, v = (x.double() for x in PK.gather_kv(kv))      # [n, PG, B, KV, dh]
    rep_h = SH // SKV
    s_ = torch.einsum("bkrd,npbkd->bkrnp", q.double().view(SB, SKV, rep_h,
                                                           DH), k)
    s_ = s_.reshape(SB, SKV, rep_h, n * PG) / DH ** 0.5
    s_[..., pos + 1:] = float("-inf")
    p_ = torch.softmax(s_, dim=-1).view(SB, SKV, rep_h, n, PG).sum(-1)
    m = p_[..., ~attended].sum(-1).reshape(SB, SH)
    gap = (sparse - full).abs().amax(-1)                    # [B, H]
    vmax = float(v.abs().max())
    worst = float((gap - 2 * m * vmax).max())
    ratio = float((sparse - full).abs().max() / full.abs().max())
    skipped = float(mass[~attended].sum() / mass.sum())
    require(float(frac) < 1.0 and worst <= 1e-5,
            f"sparse attention: a head's gap exceeds 2 m max|v| by {worst}")
    print(f"sparse attention: {int(attended.sum())} of {n} pages attended "
          f"(frac {float(frac):.4f}); every head's gap within 2 m max|v| "
          f"(largest gap {float(gap.max()):.4e}, largest m "
          f"{float(m.max()):.4f}, max|v| {vmax:.4f}); the JAX test's "
          f"ratio: gap {ratio:.4f} of the largest output entry, skipped "
          f"mass share {skipped:.4f}", flush=True)


def serve_families(seed: int, params) -> dict:
    """``serve`` of granite-8b at full width (``params``) under each other
    registry family, batch 8, SERVE_TOKENS tokens in pages of PG (32
    pages, 8 fast), each under the sync debug mode.
    -> {path: launch counts}."""
    counts = {}
    for fam in sorted(experiment.POLICY_REGISTRY):
        if fam == "arms":
            continue
        kernels = (("paged_attention",)
                   + (() if fam == "all-slow" else ("migrate",))
                   + (("topk_mask",) if fam == "oracle" else ()))
        (rep, syncs), wall, counts[f"serve_{fam}"] = counted(
            f"serve_{fam}", lambda: synced(lambda: serve.serve(
                "granite-8b", n_tokens=SERVE_TOKENS, batch=SB, full=True,
                seed=seed, page_size=PG, policy=fam, quiet=True,
                params=params)), kernels)
        require(rep.fast_mass.shape == (SERVE_TOKENS,)
                and bool(np.isfinite(rep.fast_mass).all())
                and np.isfinite(rep.slowdown)
                and rep.kv.in_fast.shape[0] == NP
                and rep.kv.fast_pages == PF,
                f"serve {fam}: non-finite telemetry or pool shape")
        require((rep.promotions > 0) == (fam != "all-slow"),
                f"serve {fam}: {rep.promotions} promotions")
        print(f"main path serve_{fam} granite-8b full: "
              f"tokens={SERVE_TOKENS} batch={SB} pages={NP} of "
              f"{PG} wall_s={wall:.3f} tok_s={rep.tok_s:.1f} "
              f"promotions={rep.promotions} demotions={rep.demotions} "
              f"thrash={rep.thrash:.4f} slowdown={rep.slowdown:.4f} "
              f"host_syncs_run={syncs} "
              f"host_syncs_per_token={syncs / SERVE_TOKENS:.4f} "
              f"launches={counts[f'serve_{fam}']}", flush=True)
        del rep
    return counts


# the expert tier: deepseek-v2-236b's 160 routed experts of one MoE layer
# (d_model 5,120, expert d_ff 1,536, bf16: 47.2 MB a slab, 7.55 GB of
# home slabs), 32 fast; top-6 router load over 8 x 512 tokens a step
EXPERT_STEPS, EXPERT_TOKENS, EXPERT_FAST = 256, 8 * 512, 32
# the embedding tier: llama4-scout's table (202,048 x 5,120 bf16, 790
# blocks of 256 rows), 79 blocks fast; lookups of 8 x 4,096 ids
EMBED_LOOKUPS, EMBED_IDS, EMBED_FAST = 256, (8, 4096), 79
ZIPF_S = 1.1


def router_loads(rng, E: int, top: int) -> np.ndarray:
    """[EXPERT_STEPS, E] f32 tokens routed to each expert a step: each
    token picks ``top`` distinct experts with weights Zipf(1.1) over a
    seeded permutation of the experts (Gumbel top-k)."""
    logw = np.empty(E)
    logw[rng.permutation(E)] = -ZIPF_S * np.log(np.arange(1, E + 1))
    loads = np.empty((EXPERT_STEPS, E), np.float32)
    for s in range(EXPERT_STEPS):
        key = logw + rng.gumbel(size=(EXPERT_TOKENS, E))
        pick = np.argpartition(-key, top, axis=1)[:, :top]
        loads[s] = np.bincount(pick.ravel(), minlength=E)
    return loads


def zipf_ids(rng, V: int, shape) -> np.ndarray:
    """i32 ids, Zipf(1.1) over a seeded permutation of the vocabulary."""
    cdf = np.cumsum(np.arange(1, V + 1, dtype=np.float64) ** -ZIPF_S)
    rank = np.searchsorted(cdf / cdf[-1], rng.random(shape), side="right")
    return rng.permutation(V)[np.minimum(rank, V - 1)].astype(np.int32)


def tier_paths(seed: int) -> dict:
    """The expert and embedding tiers at published widths, ARMS placing.
    Gate: every expert's ``effective_weights`` bit for bit its home slab.
    -> {path: launch counts}."""
    rng = np.random.default_rng(seed + 11)
    counts = {}
    cfg = registry.get_arch("deepseek-v2-236b")
    E, D, F = cfg.n_experts, cfg.d_model, cfg.moe_d_ff
    t0 = time.time()
    loads = torch.from_numpy(router_loads(rng, E, cfg.experts_per_token))
    loads = loads.cuda()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    g = torch.Generator(device="cuda").manual_seed(seed + 12)
    wi = torch.randn((E, D, 2 * F), generator=g, device="cuda",
                     dtype=torch.bfloat16)
    wo = torch.randn((E, F, D), generator=g, device="cuda",
                     dtype=torch.bfloat16)
    xcfg = XT.ExpertTierConfig(n_experts=E, fast_experts=EXPERT_FAST)
    tier = XT.init_expert_tier(xcfg, wi, wo)
    del wi, wo
    torch.cuda.synchronize()
    setup_s = time.time() - t0

    def experts():
        t = tier
        for s in range(EXPERT_STEPS):
            t, _ = XT.observe_and_policy(t, loads[s], xcfg)
        return t

    tier, wall, counts["experts"] = counted(
        "experts", experts, ("ewma_update", "topk_mask", "migrate"))
    tele = TP.telemetry(tier.pool)
    wi_eff, wo_eff = XT.effective_weights(tier)
    require(torch.equal(wi_eff, tier.wi_slow)
            and torch.equal(wo_eff, tier.wo_slow),
            "experts: effective weights differ from the home slabs")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    require(tele["promotions"] > 0 and tele["fast_resident"] <= EXPERT_FAST,
            f"experts: {tele}")
    print(f"main path experts deepseek-v2-236b: experts={E} fast="
          f"{EXPERT_FAST} slab_mb={XT.expert_slab_bytes(tier) / 1e6:.1f} "
          f"home_gb={E * XT.expert_slab_bytes(tier) / 1e9:.2f} "
          f"steps={EXPERT_STEPS} tokens_per_step={EXPERT_TOKENS} "
          f"top={cfg.experts_per_token} setup_s={setup_s:.3f} "
          f"wall_s={wall:.3f} steps_per_s={EXPERT_STEPS / wall:.1f} "
          f"promotions={tele['promotions']} demotions={tele['demotions']} "
          f"thrash={tele['thrash']:.4f} slowdown={tele['slowdown']:.4f} "
          f"fast_resident={tele['fast_resident']} "
          f"peak_device_memory_gib={peak:.2f} effective_weights=home bit "
          f"for bit launches={counts['experts']}", flush=True)
    del tier, wi_eff, wo_eff, loads
    torch.cuda.empty_cache()

    cfg = registry.get_arch("llama4-scout")
    V, D = cfg.vocab_size_raw, cfg.d_model
    t0 = time.time()
    ids = torch.from_numpy(zipf_ids(rng, V, (EMBED_LOOKUPS,) + EMBED_IDS))
    ids = ids.cuda()
    ecfg = ET.EmbedTierConfig(vocab=V, fast_blocks=EMBED_FAST)
    emb_tier = ET.init_embed_tier(ecfg, torch.randn(
        (V, D), generator=g, device="cuda", dtype=torch.bfloat16))
    torch.cuda.synchronize()
    setup_s = time.time() - t0

    def lookups():
        t, hits = emb_tier, []
        for s in range(EMBED_LOOKUPS):
            _, hit, t = ET.lookup(t, ids[s], ecfg)
            t, _ = ET.policy(t, ecfg)
            hits.append(hit)
        return t, torch.stack(hits).cpu().numpy()

    (emb_tier, hits), wall, counts["embeddings"] = counted(
        "embeddings", lookups, ("ewma_update", "topk_mask"))
    tele = TP.telemetry(emb_tier.pool)
    require(bool(np.isfinite(hits).all()) and tele["promotions"] > 0,
            f"embeddings: hits {hits[-4:]}, {tele}")
    print(f"main path embeddings llama4-scout: vocab={V} d={D} "
          f"table_gb={V * D * 2 / 1e9:.2f} blocks={ecfg.n_blocks} "
          f"fast={EMBED_FAST} lookups={EMBED_LOOKUPS} ids_per_lookup="
          f"{EMBED_IDS[0] * EMBED_IDS[1]} setup_s={setup_s:.3f} "
          f"wall_s={wall:.3f} lookups_per_s={EMBED_LOOKUPS / wall:.1f} "
          f"hit_frac_mean={hits.mean():.4f} hit_frac_last={hits[-1]:.4f} "
          f"promotions={tele['promotions']} demotions={tele['demotions']} "
          f"launches={counts['embeddings']}", flush=True)
    del emb_tier, ids
    torch.cuda.empty_cache()
    return counts


def serve_breakdown(seed: int, params, T_: int = 32, T_prof: int = 16,
                    arch="granite-8b"):
    """Where a full-width serving token's time goes: CUDA events around
    the model decode and the tiered layer over ``T_`` tokens (device
    timeline, host gaps included) with PyTorch's sync debug mode counting
    the host syncs, then a ``torch.profiler`` window of ``T_prof`` more
    tokens for the busy share and device time by kernel.  ``arch``: a
    name or a config (granite-8b's lines carry no model name)."""
    from torch.profiler import ProfilerActivity, profile
    t0 = time.time()
    cfg, params, pk_cfg, kv, cache, draw = serve.setup(
        arch, SERVE_TOKENS, SB, full=True, page_size=PG, seed=seed,
        params=params)
    torch.cuda.synchronize()
    tag = "" if arch == "granite-8b" else f" {cfg.name}"
    print(f"serve breakdown{tag}: weights {cfg.n_params:,} params, cache and "
          f"pools made in {time.time() - t0:.3f}s; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB",
          flush=True)
    token = torch.zeros((SB, 1), dtype=torch.int32, device="cuda")
    ev = [[torch.cuda.Event(enable_timing=True) for _ in range(3)]
          for _ in range(T_)]
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        t0 = time.time()
        try:
            for t in range(T_):
                ev[t][0].record()
                logits, cache = M.decode_step(params, token, cache, t, cfg)
                token = logits[:, -1:].argmax(dim=-1).to(torch.int32)
                ev[t][1].record()
                q, k_new, v_new = draw(t)
                _, kv, _ = PK.serve_decode_step(kv, q, k_new, v_new, t,
                                                pk_cfg)
                ev[t][2].record()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    wall = time.time() - t0
    syncs = sum("synchronizing CUDA operation" in str(w.message)
                for w in caught)
    model = sum(e[0].elapsed_time(e[1]) for e in ev)
    tiered = sum(e[1].elapsed_time(e[2]) for e in ev)
    print(f"serve breakdown{tag}: {T_} tokens wall_s={wall:.4f} per token: "
          f"model decode {model / T_:.4f} ms, tiered layer "
          f"{tiered / T_:.4f} ms (device timeline between events); host "
          f"syncs in the loop: {syncs}", flush=True)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        for t in range(T_, T_ + T_prof):
            logits, cache = M.decode_step(params, token, cache, t, cfg)
            token = logits[:, -1:].argmax(dim=-1).to(torch.int32)
            q, k_new, v_new = draw(t)
            _, kv, _ = PK.serve_decode_step(kv, q, k_new, v_new, t, pk_cfg)
        torch.cuda.synchronize()
        wall = time.time() - t0
    device_rows(prof, f"profile serve{tag} {T_prof} tokens", wall, T_prof)
    del cache, kv


def profiled(label: str, run, top: int = 12):
    """``run()`` under ``torch.profiler``: its busy share and device time
    by kernel name (``device_rows``).  Every window records the device's
    activity only: host-side events would slow the host-bound loops they
    measure (15-20 %) and double the processing, and no reading uses
    them."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t1 = time.time()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        run()
        torch.cuda.synchronize()
        wall = time.time() - t0
    device_rows(prof, label, wall, top=top)
    print(f"{label}: the profiler's window and processing took "
          f"{time.time() - t1:.1f}s", flush=True)


# the port's own kernels, by the names their sources give them
PORT_KERNEL = re.compile(r"(void )?(ewma_update|interval_account|tier_migrate"
                         r"|topk_mask|migrate_fire|pa_|fa_|ms_)"
                         r"[a-z_0-9]*[<(]")


def device_rows(prof, label: str, wall: float, steps: int = 0,
                top: int = 12):
    """Print the busy share of ``wall`` and the device time by name, the
    ``top`` largest and every kernel of the port's (and, given ``steps``,
    the device time and the device kernels and copies a step)."""
    totals = device_totals(prof)
    busy = sum(us for us, _ in totals.values()) / 1e6
    per_step = (f" device_ms_per_step={busy * 1e3 / steps:.4f} "
                f"device_ops_per_step="
                f"{sum(c for _, c in totals.values()) / steps}"
                if steps else "")
    print(f"{label}: wall_s={wall:.4f} device_busy_s={busy:.4f} "
          f"busy_share={busy / wall:.4f}{per_step}", flush=True)
    ranked = sorted(totals.items(), key=lambda kv: -kv[1][0])
    for i, (key, (us, count)) in enumerate(ranked):
        if i < top or PORT_KERNEL.match(key):
            print(f"  device {us / 1e3:9.2f} ms x{count:6d}  {key[:70]}",
                  flush=True)


def device_totals(prof) -> dict:
    """{name: (device us, count)} of a window's device-side events
    (kernels, copies, sets), summed straight from the profiler's raw
    events as ``prof.key_averages()`` sums them (an event on another
    thread at its end, or asynchronous, counts with no time; a name whose
    time sums to 0 is left out).  ``key_averages`` builds a Python object
    an event first, 20x the time for the same sums; ``train_breakdown``
    holds the two equal."""
    # device-side events only: an operator's row would carry the time of
    # the kernels it launched again; "Activity Buffer Request" is the
    # profiler's own buffer traffic
    totals = {}
    for e in prof.profiler.kineto_results.events():
        if (e.device_type() != torch.autograd.DeviceType.CUDA
                or getattr(e, "is_hidden_event", lambda: False)()
                or e.name().startswith("Activity Buffer")):
            continue
        timed = not e.is_async() and e.start_thread_id() == e.end_thread_id()
        us, count = totals.get(e.name(), (0.0, 0))
        totals[e.name()] = (us + ((e.end_ns() - e.start_ns()) / 1e3
                                  if timed else 0.0), count + 1)
    return {k: v for k, v in totals.items() if v[0] > 0}


# ---------------------------------------------------------- whole-path check
def whole_path_check(seed: int):
    n, T_, k = 4096, 256, 512
    # a hot set twice the fast tier: the policy picks among equally hot
    # pages by sampled counts, so the grid's lanes take different paths
    trace = gups_trace(T_, n, seed + 2, hot_frac=0.25, shift_every=64)
    u = uniform_field(T_, n, seed=seed + 3)
    grid = dict(alpha_s=[0.5, 0.7, 0.5, 0.7], noise_z=[0.0, 0.0, 0.5, 0.5])
    for mname in ("pmem-large", "dram-cxl-pmem"):
        runs = {}
        for dev in ("cuda", "cpu"):
            runs[dev] = scan_engine.sweep_arms_configs(
                trace, mname, k, grid, sample_u=u, device=dev) + [
                scan_engine.arms_sim(trace, mname, k, sample_u=u,
                                     device=dev)]
        for a, b in zip(runs["cuda"], runs["cpu"]):
            same_runs(a, b, f"{mname} {a.name}")
        promos = [r.promotions for r in runs["cuda"]]
        require(len(set(promos)) > 1,
                f"{mname}: every lane took the same path ({promos})")
        print(f"whole-path check {mname}: card == cpu over "
              f"{len(runs['cuda'])} runs, promotions={promos} wasteful="
              f"{[r.wasteful for r in runs['cuda']]}", flush=True)


def same_runs(a, b, what: str, timelines: bool = True):
    """Card run ``a`` against CPU run ``b`` (or two card routes): counts
    and integer timelines (or, streamed, their summaries) exact,
    exec_time within 1e-4 relative, recall and hit fraction within
    1e-6."""
    require((a.promotions, a.demotions, a.wasteful)
            == (b.promotions, b.demotions, b.wasteful),
            f"{what}: counts {a.promotions}/{a.demotions}/{a.wasteful} != "
            f"{b.promotions}/{b.demotions}/{b.wasteful}")
    if timelines:
        require(np.array_equal(a.timeline_promotions, b.timeline_promotions)
                and np.array_equal(a.timeline_mode, b.timeline_mode),
                f"{what}: timelines differ")
    else:
        require(a.max_promotions_interval == b.max_promotions_interval
                and a.mean_mode == b.mean_mode, f"{what}: summaries differ")
    rel = abs(a.exec_time_s - b.exec_time_s) / abs(b.exec_time_s)
    require(rel <= 1e-4, f"{what}: exec_time rel {rel}")
    require(abs(a.hot_recall - b.hot_recall) <= 1e-6
            and abs(a.fast_hit_frac - b.fast_hit_frac) <= 1e-6,
            f"{what}: recall / hit fraction differ")


def policy_check(seed: int):
    """Every other policy family on the card against the CPU at n = 4,096,
    T = 256, 4 lanes of its main-path grid, on both machines; then, on the
    card, ``tier_shim=True`` bit for bit the hop-chain route for the six
    binary families.  k = 1,536: TPP's demotions and both of the oracle's
    plans are k wide, past the 1,024 entries ``tier_migrate`` stages in
    shared memory, so they take its streamed route as at full width."""
    n, T_, k = 4096, 256, 1536
    trace = gups_trace(T_, n, seed + 2, hot_frac=0.25, shift_every=64)
    u = uniform_field(T_, n, seed=seed + 3)
    for mname in ("pmem-large", "dram-cxl-pmem"):
        moved = []
        for fam, _, make, cfgs in POLICY_SWEEPS + (
                ("all-slow", None, static.AllSlowSpec, [{}]),
                ("oracle", None, static.OracleSpec, [{}])):
            lanes = cfgs[::max(1, len(cfgs) // 4)][:4]
            runs = [scan_engine.sweep_policy_configs(
                make, trace, mname, k, lanes, sample_u=u, device=dev)
                for dev in ("cuda", "cpu")]
            for a, b in zip(*runs):
                same_runs(a, b, f"{mname} {a.name}")
            moved.append(f"{fam}={[r.promotions for r in runs[0]]}")
        print(f"policy check {mname}: card == cpu, promotions "
              f"{' '.join(moved)}", flush=True)
        shims = []
        for fam, make in FAMILY_DEFAULTS:
            hop, shim = (scan_engine.simulate(make(), trace, mname, k,
                                              sample_u=u, tier_shim=ts)
                         for ts in (False, True))
            same_runs(shim, hop, f"{mname} {fam} tier_shim")
            require(shim.exec_time_s == hop.exec_time_s
                    and np.array_equal(shim.timeline_slow_bw,
                                       hop.timeline_slow_bw),
                    f"{mname} {fam}: tier_shim not bit for bit")
            shims.append(f"{fam}={hop.promotions}")
        print(f"shim check {mname}: tier_shim == hop chain bit for bit on "
              f"the card, promotions {' '.join(shims)}", flush=True)


def synth_check(seed: int, n: int = 4096, T_: int = 256, k: int = 512):
    """The PRNG and the synthesis path on the card against the CPU: keys,
    splits, uniform rows and permutations bit for bit (n up to 65,536); a
    synthesized 4-workload x 2-config ARMS sweep at n = 4,096, T = 256
    (counts exact, exec_time within 1e-4 relative); and, on the card, a
    synthesized run bit for bit its own replay of the materialized trace
    with the synthesized noise rows."""
    keys = torch.stack([prng.PRNGKey(s) for s in (seed, seed + 1, 99)])
    for m in (1, 5, 1626, 4096, 65536):
        for label, fn in (
                ("split", lambda k_: prng.split(k_, 3)),
                ("fold_in", lambda k_: prng.fold_in(k_, torch.arange(3))),
                ("uniform", lambda k_: prng.uniform(k_, (m,))),
                ("permutation", lambda k_: prng.permutation(k_, m))):
            require(torch.equal(fn(keys.cuda()).cpu(), fn(keys)),
                    f"prng {label} n={m}: card != cpu")
    wls = [workload_spec.named(nm, T=T_)
           for nm in ("gups", "silo-tpcc", "gapbs-bc", "btree")]
    fam = lambda **kw: ARMSSpec.make(kw)
    cfgs = SYN_CONFIGS[1::2]
    runs = [scan_engine.sweep_workload_configs(
        fam, cfgs, wls, "pmem-large", k, T_, n, sim_seed=seed,
        wl_seed=seed + 1, device=dev) for dev in ("cuda", "cpu")]
    for rc, rg in zip(*runs):
        for a, b in zip(rc, rg):
            same_runs(a, b, f"synth {a.name}")
    promos = [r.promotions for row in runs[0] for r in row]
    require(len(set(promos)) > 1, f"synth: every lane took one path "
            f"({promos})")
    wl = workload_spec.named("gapbs-bc", T=T_)
    syn = scan_engine.simulate_workload(ARMSSpec.make(), wl, "pmem-large",
                                        k, T_, n, sim_seed=seed,
                                        wl_seed=seed + 1)
    rep = scan_engine.simulate(
        ARMSSpec.make(), wl.materialize(T_, n, seed=seed + 1), "pmem-large",
        k, sample_u=synth_noise_field(T_, n, seed=seed), name=syn.name)
    require(all(getattr(syn, f) == getattr(rep, f) for f in (
        "exec_time_s", "promotions", "demotions", "wasteful", "hot_recall",
        "fast_hit_frac")) and np.array_equal(syn.timeline_slow_bw,
                                             rep.timeline_slow_bw),
            "synth: the card's synthesized run != its materialized replay")
    print(f"synth check: prng card == cpu; card == cpu over {len(promos)} "
          f"synthesized lanes, promotions={promos}; synthesized == "
          f"materialized replay bit for bit (promotions {syn.promotions})",
          flush=True)


def serve_check(seed: int, T_: int = 48, batch: int = 2):
    """The serving loop on the card and on the CPU under every registry
    family: reduced granite-8b in f32 (TF32 off), weights made from the
    seed on the CPU, the same q/k/v streams.  Plans, residency, slots and
    tokens exact at every step; attention mass, fast-mass share and the
    pools within 1e-5."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = registry.reduced(registry.get_arch("granite-8b"))
    params = M.init_params(cfg, torch.Generator().manual_seed(seed), "cpu")
    for fam in sorted(experiment.POLICY_REGISTRY):
        serve_check_family(seed, T_, batch, cfg, params, fam)


def serve_check_family(seed, T_, batch, cfg, params, fam):
    to = lambda t, d: {k: to(v, d) for k, v in t.items()} \
        if isinstance(t, dict) else t.to(d)
    runs = {}
    for dev in ("cuda", "cpu"):
        _, p, pk_cfg, kv, cache, draw = serve.setup(
            "granite-8b", T_, batch, page_size=8, seed=seed, device=dev,
            params=to(params, dev), policy=fam)
        token = torch.zeros((batch, 1), dtype=torch.int32, device=dev)
        ewma = torch.zeros((pk_cfg.n_pages,), dtype=torch.float32,
                           device=dev)
        steps = []
        for t in range(T_):
            token, cache, kv, plan, ewma, share = serve.serve_token(
                p, cfg, pk_cfg, token, cache, kv, ewma, t, draw)
            steps.append([x.cpu() for x in (
                token, plan.promote, plan.demote, plan.pexec, plan.dexec,
                kv.in_fast, kv.slot, plan.access, share)])
        runs[dev] = steps, kv.k.cpu(), kv.v.cpu()
    (card, kc, vc), (cpu, kw, vw) = runs["cuda"], runs["cpu"]
    fires = 0
    for t, (a, b) in enumerate(zip(card, cpu)):
        for nm, x, y in zip(("token", "promote", "demote", "pexec", "dexec",
                             "in_fast", "slot"), a[:7], b[:7]):
            require(torch.equal(x, y), f"serve check {fam} t={t}: {nm} "
                    f"differs card {x.tolist()} cpu {y.tolist()}")
        for nm, x, y in zip(("mass", "fast-mass share"), a[7:], b[7:]):
            err = float((x.double() - y.double()).abs().max())
            require(err <= 1e-5, f"serve check {fam} t={t}: {nm} error "
                    f"{err}")
        fires += int((a[1] >= 0).any())
    err = max(float((x - y).abs().max()) for x, y in ((kc, kw), (vc, vw)))
    require(err <= 1e-5, f"serve check {fam}: pools differ by {err}")
    print(f"serve check {fam}: card == cpu over {T_} tokens at batch "
          f"{batch} (reduced granite-8b, f32): plans, residency, slots and "
          f"tokens "
          f"exact ({fires} fires with plans, "
          f"{int(card[-1][5].sum())} pages fast at the end); pools max "
          f"error {err}", flush=True)


def engine_check(seed: int, n: int = 4096, T_: int = 96, k: int = 512):
    """``engine.run`` on the card against the CPU for every policy of
    ``ENGINE_POLICIES`` at n = 4,096 on one CRN field, a hot set twice the
    fast tier that moves every 32 intervals: counts and timelines exact,
    exec time within 1e-4 relative, recall and hits within 1e-6."""
    trace = gups_trace(T_, n, seed + 2, hot_frac=0.25, shift_every=32)
    u = uniform_field(T_, n, seed=seed + 3)
    moved = []
    for label, make, mname, _ in ENGINE_POLICIES:
        a, b = (engine.run(make(), trace, mname, k, sample_u=u, device=dev)
                for dev in ("cuda", "cpu"))
        same_runs(a, b, f"engine {label}")
        moved.append(f"{label}={a.promotions}")
    print(f"engine check: card == cpu at n={n} T={T_} k={k}, promotions "
          f"{' '.join(moved)}", flush=True)


# (arch, lr_slack) of ``train_check``.  deepseek-v2-236b's 5e-2: on an
# NVIDIA H100 80GB HBM3 (700 W), seed 0, one ``moe_layers/attn/wo``
# element whose first gradient is 5.1e-6 of its leaf's largest ends
# 7.79e-3 lr off (1.40e-5 of the leaf's largest); on the CPU at this
# config JAX's f32 and the port's differ by up to 3.97e-2 lr at such
# elements (seed 1, a ``moe_layers/moe/wi`` element at 1.7e-5 of its
# leaf's largest gradient): AdamW's normalised step turning f32 noise
# into a share of lr, as zamba2-1.2b's
TRAIN_CHECKS = (("stablelm-1.6b", 0.0), ("granite-8b", 0.0), (SSM_ARCH, 1e-2),
                (HYBRID_ARCH, 5e-2), (VLM_ARCH, 0.0), (MOE_ARCH, 0.0),
                (MLA_ARCH, 5e-2), (ENCDEC_ARCH, 0.0))
DECODE_CHECKS = (SSM_ARCH, HYBRID_ARCH, MLA_ARCH, ENCDEC_ARCH)


def train_check(seed: int, steps_: int = 3, seq: int = 40):
    """Train steps on the card and on the CPU: reduced stablelm-1.6b,
    granite-8b, mamba2-370m, zamba2-1.2b, llava-next-mistral-7b (with the
    launcher's zero patch stub), llama4-scout, deepseek-v2-236b (MLA: the
    (32, 16) flash kernels) and whisper-small (the launcher's zero frame
    stub) in f32 (TF32 off),
    weights made from the seed on the CPU, the same batches, each run
    free from step 0.  Loss
    and grad norm within 1e-5 relative at every step; params within 1e-5
    of each leaf's largest entry plus ``lr_slack`` of the summed lr,
    except where the first gradient is nonzero and below 10 eps = 1e-7,
    where AdamW's first normalised step g / (|g| + eps) turns f32
    summation noise into up to lr (those within 2 x the summed lr).
    ``lr_slack`` is 0 for the stacks without a scan, 1e-2 for
    mamba2-370m and 5e-2 for zamba2-1.2b (and for deepseek-v2-236b, whose
    MoE layers have such elements too: ``TRAIN_CHECKS``): AdamW
    divides each element's gradient by its own running RMS, so an element
    whose gradient is small against its leaf's largest turns the scan's
    f32 noise (about 1e-8 absolutely) into a step error of that noise
    over its gradient, times lr; ``conv_b`` and ``dt_bias`` start at zero,
    so their largest entry is itself about the summed lr (on seeds 0 and
    1: 1.354e-4 and 1.150e-4 of ``conv_b``'s largest, and an ``out_proj``
    element 5.479e-3 lr off; every step's loss and grad norm within
    4.709e-6).  zamba2-1.2b has more such elements: on seed 0 an
    ``out_proj`` element whose first gradient is 1.8e-6 of its leaf's
    largest is 2.73e-2 lr off (and on the CPU the JAX package's f32 and
    the port's differ by up to 8.86e-2 lr at such elements at this
    config).  Every reading is printed before the gates apply.  Then a
    restart on the card: 4 steps with a checkpoint every 2, the step-4
    checkpoint removed (a run cut after step 2's checkpoint), a restored
    run of steps 2-3 against the uninterrupted losses."""
    import shutil
    import tempfile
    torch.backends.cuda.matmul.allow_tf32 = False
    misses = []
    for arch, lr_slack in TRAIN_CHECKS:
        cfg = registry.reduced(registry.get_arch(arch))
        opt = adamw.AdamWConfig(total_steps=steps_, warmup_steps=1)
        params0 = M.init_params(cfg, torch.Generator().manual_seed(seed),
                                "cpu")
        data = SyntheticLM(cfg.vocab_size_raw, seq, 2, seed=seed)
        step = steps.make_train_step(cfg, opt, remat=False)
        batch_at = lambda i, dev: {**train.to_device(data.batch_at(i), dev),
                                   **train.stub_inputs(cfg, 2, dev)}
        runs = {}
        for dev in (torch.device("cuda"), torch.device("cpu")):
            p = map_leaves(lambda t: t.to(dev, copy=True), params0)
            st = adamw.init(p, opt)
            rec = []
            for i in range(steps_):
                p, st, m = step(p, st, batch_at(i, dev))
                rec.append((float(m["loss"]), float(m["grad_norm"]),
                            float(m["lr"])))
            runs[dev.type] = rec, map_leaves(lambda t: t.cpu(), p)
        (card, pc), (cpu, pw) = runs["cuda"], runs["cpu"]
        rels = [[abs(x - y) / abs(y) for x, y in zip(a[:2], b[:2])]
                for a, b in zip(card, cpu)]
        for i, r in enumerate(rels):
            for nm, rel in zip(("loss", "grad_norm"), r):
                if rel > 1e-5:
                    misses.append(f"{arch} step {i}: {nm} rel {rel}")
        _, g0 = steps.make_loss_and_grads(cfg, remat=False)(
            params0, batch_at(0, torch.device("cpu")))
        lr_sum = sum(r[2] for r in cpu)
        worst, noisy, over = 0.0, 0, []
        for (path, x), y, g in zip(flatten_with_path(pc), leaves(pw),
                                   leaves(g0)):
            err = (x - y).abs()
            loose = (g.abs() < 1e-7) & (g != 0)
            noisy += int(loose.sum())
            if not bool((err[loose] <= 2 * lr_sum).all()):
                misses.append(f"{arch}: a noisy-gradient param in "
                              f"{'/'.join(path)} moved more than 2 x lr")
            kept = torch.where(loose, torch.zeros_like(err), err)
            top = float(y.abs().max())
            e = float(kept.max()) / top
            worst = max(worst, e)
            if e > 1e-5:     # the worst element: error / lr, |g0| / max
                k = int(kept.argmax())
                gk = float(g.abs().flatten()[k] / g.abs().max())
                over.append(f"{'/'.join(path)} {e:.3e} ("
                            f"{float(kept.flatten()[k]) / lr_sum:.3e} lr, "
                            f"g0 {gk:.3e} of the leaf's largest)")
            if float((kept - lr_slack * lr_sum).max()) > 1e-5 * top:
                misses.append(f"{arch}: params {'/'.join(path)} error {e}")
        print(f"train check {arch} reduced: card vs cpu over {steps_} "
              f"steps at batch 2, seq {seq} (f32): losses "
              f"{[r[0] for r in card]} grad norms {[r[1] for r in card]}; "
              f"(loss, grad norm) rel by step {rels}; params within "
              f"{worst:.3e} of each leaf's largest entry (above 1e-5: "
              f"{over or 'none'}; gate 1e-5 of it + {lr_slack} x the "
              f"summed lr; {noisy} noisy-gradient elements within 2 x lr)",
              flush=True)
    require(not misses, f"train check (seed {seed}): {'; '.join(misses)}")

    kw = dict(arch="stablelm-1.6b", n_steps=4, batch=2, seq=seq,
              ckpt_every=2, seed=seed, log_every=100)
    with tempfile.TemporaryDirectory() as d:
        full = train.train(ckpt_dir=d, **kw)
        shutil.rmtree(Path(d) / "step_00000004")
        resumed = train.train(ckpt_dir=d, restore=True, **kw)
    rel = max(abs(a - b) / abs(b) for a, b in zip(resumed, full[2:]))
    require(len(resumed) == 2 and rel <= 1e-5,
            f"restart check: resumed {resumed} vs {full[2:]}")
    print(f"restart check (card, reduced stablelm-1.6b): resumed losses "
          f"{resumed} vs uninterrupted {full[2:]}: "
          f"{'bitwise equal' if resumed == full[2:] else f'rel {rel}'}",
          flush=True)


def decode_checks(seed: int, T_: int = 16, batch: int = 2):
    """16 greedy decode steps of reduced mamba2-370m, zamba2-1.2b,
    deepseek-v2-236b and whisper-small (f32) on the card and on the CPU
    from the same weights and the zero caches: tokens exact at every step,
    logits within 1e-5 of their largest entry."""
    for arch in DECODE_CHECKS:
        decode_check(arch, seed, T_, batch)


def decode_check(arch: str, seed: int, T_: int, batch: int):
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = registry.reduced(registry.get_arch(arch))
    params = M.init_params(cfg, torch.Generator().manual_seed(seed), "cpu")
    runs = {}
    for dev in ("cuda", "cpu"):
        p = map_leaves(lambda t: t.to(dev, copy=True), params)
        cache = M.init_cache(cfg, batch, T_, dev)
        tok = torch.full((batch, 1), 3, dtype=torch.int32, device=dev)
        step = steps.make_serve_step(cfg, greedy=False)
        rec = []
        for t in range(T_):
            logits, cache = step(p, tok, cache, t)
            tok = logits[:, -1:].argmax(dim=-1).to(torch.int32)
            rec.append((tok.cpu(), logits.cpu()))
        runs[dev] = rec
    worst = 0.0
    for t, ((ta, la), (tb, lb)) in enumerate(zip(runs["cuda"],
                                                 runs["cpu"])):
        require(torch.equal(ta, tb), f"decode check {arch} t={t}: tokens "
                f"{ta.tolist()} vs {tb.tolist()}")
        e = float((la - lb).abs().max()) / float(lb.abs().max())
        require(e <= 1e-5, f"decode check {arch} t={t}: logits error {e}")
        worst = max(worst, e)
    print(f"decode check (reduced {arch}, f32): card == cpu over "
          f"{T_} tokens at batch {batch}: tokens exact "
          f"{torch.cat([r[0] for r in runs['cuda']], 1)[0].tolist()}, "
          f"logits within {worst:.3e} of the largest", flush=True)


def compression_check(seed: int, steps_: int = 3):
    """``ft/compression.py`` on one train step's gradients of reduced
    deepseek-v2-236b (f32, made on the CPU from the seed and copied to
    the card): the bf16 round trip, and ``steps_`` int8 steps with the
    error feedback carried (the gradients scaled by 1, 2, 3), bit for bit
    the same on the card and on the CPU: q, the scales, the feedback and
    the decompressed gradients."""
    cfg = registry.reduced(registry.get_arch(MLA_ARCH))
    params = M.init_params(cfg, torch.Generator().manual_seed(seed), "cpu")
    data = SyntheticLM(cfg.vocab_size_raw, 40, 2, seed=seed)
    _, grads = steps.make_loss_and_grads(cfg, remat=False)(
        params, train.to_device(data.batch_at(0), torch.device("cpu")))
    runs = {}
    for dev in ("cuda", "cpu"):
        g = map_leaves(lambda t: t.to(dev, copy=True), grads)
        out = [compression.decompress_bf16(compression.compress_bf16(g))]
        ef = compression.init_error_feedback(g)
        for i in range(steps_):
            q, s, ef = compression.compress_int8(
                map_leaves(lambda t: t * (1.0 + i), g), ef)
            out += [q, s, ef, compression.decompress_int8(q, s)]
        runs[dev] = [t.cpu() for t in leaves(out)]
    same = [torch.equal(a, b) and a.dtype == b.dtype
            for a, b in zip(runs["cuda"], runs["cpu"])]
    require(len(same) == len(runs["cpu"]) and all(same),
            f"compression check: {same.count(False)} of {len(same)} "
            f"leaves differ card vs cpu")
    n = sum(t.numel() for t in leaves(grads))
    print(f"compression check (reduced {MLA_ARCH} gradients, "
          f"{len(leaves(grads))} leaves, {n:,} elements): bf16 round trip "
          f"and {steps_} int8 steps with error feedback bit for bit card == "
          f"cpu ({len(same)} tensors)", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(2)
    dev = torch.device("cuda")
    card = card_line()
    print(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)
    t0 = T0[0] = time.time()
    with ThreadPoolExecutor(len(BUILDS)) as pool:   # one nvcc a source
        list(pool.map(_backend.build, BUILDS))
    print(f"build: {time.time() - t0:.2f}s", flush=True)

    rows, held = kernel_phase(dev, np.random.default_rng(args.seed))
    stamp("kernel phase")
    count_fires()
    by_path = main_path(args.seed, held)
    stamp("main path")
    for nm, row in rows.items():   # launches: every path of the main path
        row["launches"] = sum(c[nm] for c in by_path.values())
        row["launches_by_path"] = {p: c[nm] for p, c in by_path.items()}
    for check in (whole_path_check, policy_check, engine_check, synth_check,
                  search_check, board_check, serve_check, train_check,
                  decode_checks, compression_check):
        t1 = time.time()
        check(args.seed)
        print(f"{check.__name__}: {time.time() - t1:.1f}s", flush=True)

    print(f"wall: {time.time() - t0:.1f}s from the build's start", flush=True)
    print(json.dumps({"kernels": list(rows.values())}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
