#!/usr/bin/env python3
"""Device times behind the redesign of ``topk_mask`` and the Mamba2 scan's
backward, on one NVIDIA GPU.

    python3 tools/redesign_probe.py [--parent DIR] [--only PHASE ...]

Run from the repository root on a machine with a CUDA card and ``nvcc``.
Phases (all by default):

  ptxas     registers, spills and shared memory of the two sources'
            kernels (``nvcc -Xptxas -v`` with the port's flags);
  ab        the kernels' device times in this tree and in the tree at
            ``--parent`` (a checkout of another commit), each in its own
            process, in the order parent, this, this, parent: ``topk_mask``
            at the sweep's 16 x 65,536 (k 8,192), ``arms_sim``'s 1 x 65,536
            and the serving path's 1 x 32 (k 8), beside ``torch.topk`` +
            scatter; the scan's forward and backward at mamba2-370m's
            training shape, and the backward's passes by kernel name under
            ``torch.profiler``;
  clusters  ``topk_mask`` at 1, 2, 4, 6, 7, 8 and 16 CTAs a row, at
            16 x 65,536 and 1 x 65,536, beside the wrapper's choice;
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


def measure(root: Path):
    """Times in the tree at ``root`` (run in a child process)."""
    sys.path.insert(0, str(root))
    sys.path.insert(0, str(root / "src"))
    import numpy as np
    import torch
    import chip_smoke as cs
    from repro_torch.kernels.interval_step import kernel
    from repro_torch.kernels.mamba_scan import kernel as skernel
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(0)
    out = {"tree": str(root)}
    for B, n, k in ((16, 65536, 8192), (1, 65536, 8192), (1, 32, 8)):
        x = torch.from_numpy((rng.integers(-4, 2000, (B, n)) * 0.5).astype(
            np.float32)).cuda()
        x[:, ::97] = -0.0

        def lib(x, k):
            m = torch.zeros(x.shape, dtype=torch.bool, device="cuda")
            return m.scatter_(1, torch.topk(x, k, dim=1).indices, True)

        sets = cs.copies((x, k), 5 * B * n)
        out[f"topk B={B} n={n} k={k}"] = cs.cuda_ms(kernel.topk_mask, sets)
        out[f"torch.topk+scatter B={B} n={n} k={k}"] = cs.cuda_ms(lib, sets)
    B_, S, H, P, N_, Q = 2, 4096, 32, 64, 128, 64
    f = lambda *s: torch.from_numpy(rng.standard_normal(s, dtype=np.float32)
                                    ).cuda()
    x, Bm, Cm, dy = f(B_, S, H, P), f(B_, S, N_), f(B_, S, N_), f(B_, S, H, P)
    dt = torch.logaddexp(f(B_, S, H), torch.zeros((), device="cuda"))
    A = -torch.linspace(1.0, 16.0, H, device="cuda")
    ins = (x, dt, A, Bm, Cm)
    sets = cs.copies(ins + (dy,), 5 * x.numel() * 4)
    out["mamba_scan_fwd"] = cs.cuda_ms(
        lambda *a: skernel.mamba_scan_fwd(*a[:5], chunk=Q), sets, reps=4)
    out["mamba_scan_bwd"] = cs.cuda_ms(
        lambda *a: skernel.mamba_scan_bwd(*a, chunk=Q), sets, reps=4)
    skernel.mamba_scan_bwd(*ins, dy, chunk=Q)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            skernel.mamba_scan_bwd(*ins, dy, chunk=Q)
        torch.cuda.synchronize()
    passes = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA and \
                e.self_device_time_total > 0 and "ms_" in e.key:
            passes[e.key[:60]] = e.self_device_time_total / 1e3 / 5
    out["mamba_scan_bwd passes ms"] = passes
    emit(phase="ab", **out)


def clusters():
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch
    import chip_smoke as cs
    from repro_torch.kernels.interval_step import kernel, ref
    rng = np.random.default_rng(1)
    for B, n, k in ((16, 65536, 8192), (1, 65536, 8192)):
        x = torch.from_numpy((rng.integers(-4, 2000, (B, n)) * 0.5).astype(
            np.float32)).cuda()
        want = ref.topk_mask_ref(x, k)
        row = {}
        for C in (1, 2, 4, 6, 7, 8, 16):
            def run(x, k, C=C):
                m = torch.empty(x.shape, dtype=torch.bool, device="cuda")
                err = kernel._lib().arms_topk_mask(
                    x.data_ptr(), m.data_ptr(), B, n, k, C,
                    kernel._stream(x))
                if err:
                    raise RuntimeError(f"cluster {C}: CUDA error {err}")
                return m
            same = bool(torch.equal(run(x, k), want))
            row[C] = (cs.cuda_ms(run, cs.copies((x, k), 5 * B * n)), same)
        emit(phase="clusters", B=B, n=n, k=k,
             chosen=kernel.topk_cluster(B, n, x.device),
             ms_and_equal=row)


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
        for tree in trees:
            subprocess.run([sys.executable, __file__, "--measure", str(tree)],
                           check=True, env=dict(os.environ))
    if "clusters" in args.only:
        clusters()
    if "products" in args.only:
        products(out_dir)


if __name__ == "__main__":
    main()
