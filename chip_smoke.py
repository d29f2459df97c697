#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port of ARMS on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Run from the repository root on a machine with a CUDA card and ``nvcc``.
It imports the port only (``src/repro_torch``), never JAX, and:

  1. builds the interval-step CUDA kernels from ``src/`` and prints the
     card's name and power limit and the build time;
  2. kernel phase: holds each kernel against its plain PyTorch version on
     the card at the main path's shapes (16 lanes, n = 65,536 pages,
     k = 8,192, 2 and 3 tiers, 64-entry plans) and times both on the
     device (CUDA graphs of repeated calls over inputs larger than L2,
     CUDA events), beside the least time the card could take for the same
     bytes and operations;
  3. main path: ``sweep_arms_configs`` over a 16-lane ``alpha_s x noise_z``
     grid on ``pmem-large`` at n = 65,536, k = 8,192, T = 4,096 with the
     streaming reduction, then ``arms_sim`` on the 3-tier ``dram-cxl-pmem``
     at T = 1,024, on a GUPS-like trace made with numpy from ``--seed``;
     the launch counts are set to 0 before each of the two and read after
     it, and every kernel must have been launched by each; then a
     ``torch.profiler`` window of 256 intervals gives the device busy
     share and the device time by kernel;
  4. whole-path check: the same entry points on the card and on the CPU at
     n = 4,096, T = 256, 4 lanes, on both machines — counts exact,
     exec_time within 1e-4 relative;
  5. prints the ``kernels`` JSON line, the card line and, last, the
     ``{"ok": true, ...}`` line.

Any failed check raises, so the script exits non-zero and prints no
result line.  Without a CUDA card it exits non-zero at once.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.kernels import _backend  # noqa: E402
from repro_torch.kernels.interval_step import kernel, ops, ref  # noqa: E402
from repro_torch.simulator import (machine_spec, machines,  # noqa: E402
                                   scan_engine)
from repro_torch.simulator.sampling import uniform_field  # noqa: E402

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
L2_BYTES = 50 * 2 ** 20        # H100 L2 cache
F32_OPS_PER_S = 67e12          # H100 SXM f32 outside the tensor cores
B, N, K, T = 16, 65536, 8192, 4096
PLAN = 64                      # ARMSConfig.bs_max: promote/demote widths
TPU_KERNEL = "src/repro/kernels/interval_step/kernel.py"
SOURCE = "src/repro_torch/kernels/interval_step/csrc/interval_step.cu"


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


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
        return a.clone()

    n = min(32, max(2, -(-2 * L2_BYTES // bytes_)))
    return [args] + [tuple(clone(a) for a in args) for _ in range(n - 1)]


def nbytes(*ts) -> int:
    """Bytes a function must move: each tensor once, a row shared by all
    lanes (stride 0) once."""
    total = 0
    for t in ts:
        rows = 1 if t.dim() == 2 and t.stride(0) == 0 else t.shape[0]
        total += rows * (t.numel() // max(t.shape[0], 1)) * t.element_size()
    return total


def bound(bytes_: int, ops: int):
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def max_err(got, want) -> float:
    return max(float((g.double() - w.double()).abs().max())
               for g, w in zip(got, want))


def require(cond: bool, what: str):
    if not cond:
        raise AssertionError(what)


# ------------------------------------------------------------ kernel phase
def kernel_phase(dev, rng):
    rows = {}

    def entry(name, line, shape, kern, plain, args, exact, bytes_, ops,
              lib=None):
        as_tuple = lambda x: x if isinstance(x, tuple) else (x,)
        got, want = as_tuple(kern(*args)), as_tuple(plain(*args))
        err = max_err(got, want)
        if exact:
            require(err == 0.0, f"{name}: kernel differs from plain ({err})")
        else:
            rel = max(float(((g.double() - w.double()).abs()
                             / w.double().abs().clamp_min(1e-30)).max())
                      for g, w in zip(got, want))
            require(rel <= 1e-6, f"{name}: relative error {rel} > 1e-6")
        bms, by = bound(bytes_, ops)
        sets = copies(args, bytes_)
        ms, plain_ms = cuda_ms(kern, sets), cuda_ms(plain, sets)
        lib_ms = None if lib is None else cuda_ms(lib, sets)
        print(f"kernel {name} ({shape}): max_abs_err={err} ms={ms:.5f} "
              f"plain_ms={plain_ms:.5f} library_ms={lib_ms} "
              f"bound_ms={bms:.5f}", flush=True)
        if name not in rows:   # the JSON line keeps the first (2-tier) shape
            rows[name] = dict(
                name=name, route="cuda", source=SOURCE,
                replaces=f"{TPU_KERNEL}:{line}", launches=0,
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, library_ms=lib_ms)

    f = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    # ewma_update: scores of 16 lanes, per-lane params
    args = tuple(f(rng.random((B, N), dtype=np.float32)) for _ in range(3))
    args += (f(rng.random((B, 4), dtype=np.float32)),)
    entry("ewma_update", 332, f"B={B} n={N}", kernel.ewma_update,
          ref.ewma_score_update_ref, args, True,
          nbytes(*args) + 3 * 4 * B * N, 6 * B * N)

    # topk_mask: hotness scores with ties and signed zeros
    x = f((rng.integers(-4, 2000, (B, N)) * 0.5).astype(np.float32))
    x[:, ::97] = -0.0

    def library(x, k):
        m = torch.zeros((B, N), dtype=torch.bool, device=dev)
        return m.scatter_(1, torch.topk(x, k, dim=1).indices, True)

    entry("topk_mask", 87, f"B={B} n={N} k={K}", kernel.topk_mask,
          ref.topk_mask_ref, (x, K), True, nbytes(x) + B * N, 5 * B * N,
          library)

    for mname in ("pmem-large", "dram-cxl-pmem"):
        spec = machines.get(mname)
        R = spec.n_tiers
        mach, caps = machine_spec.lane_stack([spec] * B, N, K, dev)
        # tier_migrate: plans honouring the unique-index contract
        tier = f(rng.integers(0, R, (B, N)).astype(np.int32))
        plans = np.full((2, B, PLAN), -1, np.int32)
        for b in range(B):
            perm = rng.permutation(N)[:2 * PLAN]
            plans[0, b] = perm[:PLAN]
            plans[1, b, :PLAN // 2] = perm[PLAN:PLAN + PLAN // 2]
        args = (tier, f(plans[0]), f(plans[1]), caps)
        entry("tier_migrate", 198, f"B={B} n={N} R={R} P=D={PLAN}",
              kernel.tier_migrate, ref.tier_migrate_ref, args, True,
              nbytes(*args) + nbytes(tier) + 2 * B * PLAN
              + 8 * B * (R - 1), 4 * B * N)

        # interval_account: one trace row shared by every lane
        true = f((2e7 / N * rng.gamma(1.0, 1.0, N)).astype(np.float32))
        orc = ref.topk_mask_ref(true[None], K)[0]
        args = (mach, true[None].expand(B, N), tier,
                f(rng.integers(0, PLAN, (B, R - 1)).astype(np.float32)),
                f(rng.integers(0, PLAN, (B, R - 1)).astype(np.float32)),
                orc[None].expand(B, N), K)
        require(torch.equal(ops.interval_account(*args)[5],
                            ref.interval_account_ref(*args)[5]),
                "interval_account: recall")
        entry("interval_account", 292, f"B={B} n={N} R={R} k={K}",
              ops.interval_account, ref.interval_account_ref, args, False,
              nbytes(mach.lat_ns, mach.bw_read, mach.bw_write, mach.mlp,
                     *args[1:6]) + 6 * B * 4, (2 * R + 1) * B * N)
    return rows


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


PATH_KERNELS = ("ewma_update", "topk_mask", "tier_migrate",
                "interval_account")


def counted(label: str, run):
    """Drive one path of the main path with every launch count set to 0
    just before it and read just after; each kernel of the path must have
    been launched.  -> (result, wall seconds, launch counts)."""
    torch.cuda.synchronize()
    _backend.reset_launches()
    t0 = time.time()
    out = run()
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = {nm: int(_backend.launches.get(nm, 0)) for nm in PATH_KERNELS}
    for nm, c in counts.items():
        require(c > 0, f"{nm} was not launched by {label}")
    return out, wall, counts


def main_path(seed: int):
    """-> {path: {kernel: launches}} for the two paths of the main path."""
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

    T2 = 1024
    r, wall2, sim_counts = counted(
        "arms_sim", lambda: scan_engine.arms_sim(
            trace[:T2], "dram-cxl-pmem", K, sample_u=u[:T2]))
    require(np.isfinite(r.exec_time_s) and r.promotions > 0,
            "arms_sim: non-finite exec_time or no promotions")
    print(f"main path arms_sim dram-cxl-pmem: T={T2} n={N} "
          f"wall_s={wall2:.3f} intervals_per_s={T2 / wall2:.1f} "
          f"promotions={r.promotions} demotions={r.demotions} "
          f"wasteful={r.wasteful} launches={sim_counts}", flush=True)
    profile_window(trace, u)
    return {"sweep_arms_configs": sweep_counts, "arms_sim": sim_counts}


def profile_window(trace, u, T_: int = 256):
    """Device busy share of the first ``T_`` intervals of the sweep (set-up
    included), from a ``torch.profiler`` trace (profiling slows the host,
    so the share is a lower bound), and the device time by kernel name."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        scan_engine.sweep_arms_configs(trace[:T_], "pmem-large", K, GRID,
                                       sample_u=u[:T_], reduce="stream")
        torch.cuda.synchronize()
        wall = time.time() - t0
    # device-side rows only (kernels, copies): an operator row also carries
    # the device time of the kernels it launched, which would count twice;
    # "Activity Buffer Request" is the profiler's own buffer traffic
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and e.self_device_time_total > 0
              and not e.key.startswith("Activity Buffer")]
    busy = sum(e.self_device_time_total for e in events) / 1e6
    print(f"profile sweep_arms_configs T={T_}: wall_s={wall:.3f} "
          f"device_busy_s={busy:.3f} busy_share={busy / wall:.4f}",
          flush=True)
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"  device {e.self_device_time_total / 1e3:9.2f} ms "
              f"x{e.count:6d}  {e.key[:70]}", flush=True)


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
            require((a.promotions, a.demotions, a.wasteful)
                    == (b.promotions, b.demotions, b.wasteful),
                    f"{mname} {a.name}: card counts {a.promotions}/"
                    f"{a.demotions}/{a.wasteful} != cpu {b.promotions}/"
                    f"{b.demotions}/{b.wasteful}")
            require(np.array_equal(a.timeline_promotions,
                                   b.timeline_promotions)
                    and np.array_equal(a.timeline_mode, b.timeline_mode),
                    f"{mname} {a.name}: timelines differ")
            rel = abs(a.exec_time_s - b.exec_time_s) / abs(b.exec_time_s)
            require(rel <= 1e-4, f"{mname} {a.name}: exec_time rel {rel}")
            require(abs(a.hot_recall - b.hot_recall) <= 1e-6
                    and abs(a.fast_hit_frac - b.fast_hit_frac) <= 1e-6,
                    f"{mname} {a.name}: recall / hit fraction differ")
        promos = [r.promotions for r in runs["cuda"]]
        require(len(set(promos)) > 1,
                f"{mname}: every lane took the same path ({promos})")
        print(f"whole-path check {mname}: card == cpu over "
              f"{len(runs['cuda'])} runs, promotions={promos} wasteful="
              f"{[r.wasteful for r in runs['cuda']]}", flush=True)


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
    t0 = time.time()
    _backend.build(kernel.SOURCE)
    print(f"build: {time.time() - t0:.2f}s", flush=True)

    rows = kernel_phase(dev, np.random.default_rng(args.seed))
    by_path = main_path(args.seed)
    for nm, row in rows.items():   # launches: both paths of the main path
        row["launches"] = sum(c[nm] for c in by_path.values())
        row["launches_by_path"] = {p: c[nm] for p, c in by_path.items()}
    whole_path_check(args.seed)

    print(json.dumps({"kernels": list(rows.values())}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
