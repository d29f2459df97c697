#!/usr/bin/env python3
"""Device times behind the redesign of the port's kernels (``interval_account``
and the Mamba2 scan's forward), on one NVIDIA GPU.

    python3 tools/redesign_probe.py [--parent DIR] [--only PHASE ...]

Run from the repository root on a machine with a CUDA card and ``nvcc``.
Phases (all by default):

  ptxas     registers, spills and shared memory of the interval-step and
            scan sources' kernels (``nvcc -Xptxas -v`` with the port's
            flags);
  ab        the kernels' device times in this tree and in the tree at
            ``--parent`` (a checkout of another commit), each in its own
            process, in the order parent, this, this, parent:
            ``interval_account`` at the sweep's 16 x 65,536 (``pmem-large``,
            one true and oracle row shared by the lanes, k 8,192) and
            ``arms_sim``'s 1 x 65,536 (``dram-cxl-pmem``); the scan's
            forward and backward at mamba2-370m's training shape, each
            one's passes by kernel name under ``torch.profiler``, and a
            digest of one forward's y and h_final, so that a last line
            says whether this tree's forward gives the parent's bits;
  clusters  ``interval_account`` at 1, 2, 4, 8, 12 and 16 CTAs a lane, at
            16 x 65,536 and 1 x 65,536, each held to the plain version bit
            for bit, beside the wrapper's choice;
  products  one 64 x 64 x 64 product of the scan's backward (4,096 blocks,
            16 times over each block's tiles), f32 register tiles against
            3xTF32 ``mma.sync``, both held to the f64 product
            (``tools/product_probe.cu``).

Times are CUDA-event medians (``chip_smoke.cuda_ms``: graphs of repeated
calls over inputs larger than L2).  Each line is a JSON object; the card's
name and power limit come first.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def emit(**kw):
    print(json.dumps(kw), flush=True)


def nvcc_flags(root: Path):
    sys.path.insert(0, str(root / "src"))
    from repro_torch.kernels import _backend
    return _backend.nvcc(), list(_backend.NVCC_FLAGS)


def ptxas(out_dir: Path):
    cc, flags = nvcc_flags(ROOT)
    for src in ("src/repro_torch/kernels/interval_step/csrc/interval_step.cu",
                "src/repro_torch/kernels/mamba_scan/csrc/mamba_scan.cu"):
        proc = subprocess.run(
            [cc, *flags, "-Xptxas", "-v", "-o",
             str(out_dir / (Path(src).stem + ".so")), str(ROOT / src)],
            capture_output=True, text=True)
        lines = [ln for ln in proc.stderr.splitlines()
                 if "Compiling entry" in ln or "Used" in ln
                 or "spill" in ln or "error" in ln]
        emit(phase="ptxas", source=src, rc=proc.returncode, lines=lines)
        if proc.returncode:
            raise SystemExit(proc.stderr)


ACCOUNT_SHAPES = ((16, "pmem-large"), (1, "dram-cxl-pmem"))
PAGES, TOP = 65536, 8192


def account_args(lanes: int, machine: str, rng):
    """``ops.interval_account``'s arguments: one trace row and its top-k
    oracle shared by ``lanes`` lanes, random tiers and migration counts."""
    import numpy as np
    import torch
    from repro_torch.kernels.interval_step import ref
    from repro_torch.simulator import machine_spec, machines
    spec = machines.get(machine)
    R = spec.n_tiers
    mach, _ = machine_spec.lane_stack([spec] * lanes, PAGES, TOP, "cuda")
    f = lambda a: torch.from_numpy(np.ascontiguousarray(a)).cuda()
    true = f((2e7 / PAGES * rng.gamma(1.0, 1.0, PAGES)).astype(np.float32))
    orc = ref.topk_mask_ref(true[None], TOP)[0]
    return (mach, true[None].expand(lanes, PAGES),
            f(rng.integers(0, R, (lanes, PAGES)).astype(np.int32)),
            f(rng.integers(0, 64, (lanes, R - 1)).astype(np.float32)),
            f(rng.integers(0, 64, (lanes, R - 1)).astype(np.float32)),
            orc[None].expand(lanes, PAGES), TOP)


def scan_passes(run, calls: int = 5) -> dict:
    """Device ms of each ``ms_*`` kernel of one ``run()``, by name."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            run()
        torch.cuda.synchronize()
    return {e.key.split("(")[0].removeprefix("void "):
            e.self_device_time_total / 1e3 / calls
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0 and "ms_" in e.key}


def measure(root: Path):
    """Times in the tree at ``root`` (run in a child process)."""
    sys.path.insert(0, str(root))
    sys.path.insert(0, str(root / "src"))
    import numpy as np
    import torch
    import chip_smoke as cs
    from repro_torch.kernels.interval_step import ops
    from repro_torch.kernels.mamba_scan import kernel as skernel

    rng = np.random.default_rng(0)
    out = {"tree": str(root)}
    for lanes, machine in ACCOUNT_SHAPES:
        args = account_args(lanes, machine, rng)
        out[f"interval_account B={lanes} n={PAGES} {machine}"] = cs.cuda_ms(
            ops.interval_account, cs.copies(args, 9 * PAGES * lanes))
    B_, S, H, P, N_, Q = 2, 4096, 32, 64, 128, 64
    f = lambda *s: torch.from_numpy(rng.standard_normal(s, dtype=np.float32)
                                    ).cuda()
    x, Bm, Cm, dy = f(B_, S, H, P), f(B_, S, N_), f(B_, S, N_), f(B_, S, H, P)
    dt = torch.logaddexp(f(B_, S, H), torch.zeros((), device="cuda"))
    A = -torch.linspace(1.0, 16.0, H, device="cuda")
    ins = (x, dt, A, Bm, Cm)
    y, h = skernel.mamba_scan_fwd(*ins, chunk=Q)
    torch.cuda.synchronize()
    out["mamba_scan_fwd digest"] = {
        nm: hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()[:16]
        for nm, t in (("y", y), ("h_final", h))}
    sets = cs.copies(ins + (dy,), 5 * x.numel() * 4)
    out["mamba_scan_fwd"] = cs.cuda_ms(
        lambda *a: skernel.mamba_scan_fwd(*a[:5], chunk=Q), sets, reps=4)
    out["mamba_scan_bwd"] = cs.cuda_ms(
        lambda *a: skernel.mamba_scan_bwd(*a, chunk=Q), sets, reps=4)
    out["mamba_scan_fwd passes ms"] = scan_passes(
        lambda: skernel.mamba_scan_fwd(*ins, chunk=Q))
    out["mamba_scan_bwd passes ms"] = scan_passes(
        lambda: skernel.mamba_scan_bwd(*ins, dy, chunk=Q))
    emit(phase="ab", **out)


def clusters():
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch
    import chip_smoke as cs
    from repro_torch.kernels.interval_step import kernel, ops, ref
    rng = np.random.default_rng(1)
    for lanes, machine in ACCOUNT_SHAPES:
        args = account_args(lanes, machine, rng)
        want = ref.interval_account_ref(*args)
        dev = args[2].device
        key = ("account", lanes, PAGES, dev.index)
        chosen = kernel.account_cluster(lanes, PAGES, dev)
        row = {}
        for C in (1, 2, 4, 8, 12, 16):
            kernel._CLUSTERS[key] = C
            same = all(torch.equal(g, w) for g, w in
                       zip(ops.interval_account(*args), want))
            row[C] = (cs.cuda_ms(ops.interval_account,
                                 cs.copies(args, 9 * PAGES * lanes)), same)
        kernel._CLUSTERS[key] = chosen
        emit(phase="clusters", B=lanes, n=PAGES, machine=machine,
             chosen=chosen, ms_and_equal=row)


def products(out_dir: Path):
    import numpy as np
    import torch
    cc, flags = nvcc_flags(ROOT)
    lib_path = out_dir / "product_probe.so"
    subprocess.run([cc, *flags, "-o", str(lib_path),
                    str(ROOT / "tools" / "product_probe.cu")], check=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.probe_product.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 3 + [
        ctypes.c_int, ctypes.c_void_p]
    blocks, reps = 4096, 16
    rng = np.random.default_rng(2)
    A = torch.from_numpy(rng.standard_normal((blocks, 64, 64),
                                             dtype=np.float32)).cuda()
    B = torch.from_numpy(rng.standard_normal((blocks, 64, 64),
                                             dtype=np.float32)).cuda()
    want = reps * torch.einsum("bkm,bkn->bmn", A.double(), B.double())
    top = float(want.abs().max())
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    flops = 2.0 * blocks * reps * 64 ** 3
    for route, name in ((0, "ffma register tiles"), (1, "3xtf32 mma.sync")):
        out = torch.empty_like(A)
        times = []
        for _ in range(5):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            lib.probe_product(route, A.data_ptr(), B.data_ptr(),
                              out.data_ptr(), blocks, stream)
            a.record()
            for _ in range(10):
                err = lib.probe_product(route, A.data_ptr(), B.data_ptr(),
                                        out.data_ptr(), blocks, stream)
            b.record()
            b.synchronize()
            if err:
                raise RuntimeError(f"{name}: CUDA error {err}")
            times.append(a.elapsed_time(b) / 10)
        ms = float(np.median(times))
        err = float((out.double() - want).abs().max())
        emit(phase="products", route=name, ms=ms, tflops=flops / ms / 1e9,
             max_abs_err=err, rel_to_max=err / top)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path)
    ap.add_argument("--only", nargs="*",
                    default=["ptxas", "ab", "clusters", "products"])
    ap.add_argument("--measure", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.measure:
        return measure(args.measure.resolve())
    import torch
    if not torch.cuda.is_available():
        sys.exit("redesign_probe: no CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    emit(phase="card", card=card, torch=torch.__version__)
    out_dir = ROOT / "build" / "probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    if "ptxas" in args.only:
        ptxas(out_dir)
    if "ab" in args.only:
        trees = [ROOT] if args.parent is None else \
            [args.parent.resolve(), ROOT, ROOT, args.parent.resolve()]
        digests = {}
        for tree in trees:
            proc = subprocess.run(
                [sys.executable, __file__, "--measure", str(tree)],
                capture_output=True, text=True, env=dict(os.environ))
            print(proc.stdout, end="", flush=True)
            if proc.returncode:
                raise SystemExit(proc.stderr)
            ab = json.loads(proc.stdout.strip().splitlines()[-1])
            digests.setdefault(str(tree), ab["mamba_scan_fwd digest"])
        if args.parent is not None:
            this, parent = (digests[str(t.resolve())]
                            for t in (ROOT, args.parent))
            emit(phase="bits", forward_equals_parent=this == parent,
                 this=this, parent=parent)
    if "clusters" in args.only:
        clusters()
    if "products" in args.only:
        products(out_dir)


if __name__ == "__main__":
    main()
