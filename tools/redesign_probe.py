#!/usr/bin/env python3
"""Device times behind the redesign of the port's kernels (``tier_migrate``,
``paged_attention`` and ``interval_account``), on one NVIDIA GPU.

    python3 tools/redesign_probe.py [--parent DIR] [--only PHASE ...]

Run from the repository root on a machine with a CUDA card and ``nvcc``.
Phases (all by default):

  ptxas     registers, spills and shared memory of the interval-step,
            paged-attention and scan sources' kernels (``nvcc -Xptxas -v``
            with the port's flags);
  ab        the kernels' device times in this tree and in the tree at
            ``--parent`` (a checkout of another commit), each in its own
            process, in the order parent, this, this, parent:
            ``tier_migrate`` at the sweep's 16 x 65,536 on ``pmem-large``
            (2 tiers) and ``dram-cxl-pmem`` (3) and at ``arms_sim``'s
            1 x 65,536 on ``dram-cxl-pmem``, on plans of 64 entries that
            share pages and caps that let some of them run, with a digest of
            the five outputs, so that a last line says whether this tree's
            outputs are the parent's bits; ``paged_attention`` at the
            serving path's fold (1 x 256 query heads over 64 KV heads of 128,
            f32, 32 pages of 16 tokens, page mass on) at positions 15 and 511,
            and the same fold over a table of 2,048 entries (32,768 tokens a
            sequence) at positions 511 and 32,767; ``interval_account`` at
            the sweep's 16 x 65,536 (one row shared by the lanes) on
            ``pmem-large`` and ``dram-cxl-pmem`` and at the tuning study's
            216 lanes of their own rows on ``pmem-large``, with a digest
            of its six outputs likewise;
  clusters  both kernels at 1, 2, 4, 8, 12 and 16 CTAs a cluster, at those
            shapes (``paged_attention`` at position 511, and at 32,767 of
            the 2,048-entry table), each held to the
            plain version (``tier_migrate`` bit for bit, ``paged_attention``
            within 1e-5), beside the wrapper's choice;
  minblocks copies of the paged-attention source whose f32 one-word
            ``pa_decode`` (the serving path's) asks for N resident CTAs an
            SM (``PA_MIN_BLOCKS``, which caps its registers; 0: the source
            as it is), each with
            its ``-Xptxas -v`` lines and its times at the fold (positions 15
            and 511) and at the 2,048-entry table (511 and 32,767), at the
            cluster size it chooses, each held to the plain version within
            1e-5;
  stage     ``tier_migrate`` at the ab phase's shapes from a copy of the
            interval-step source as it is and one whose every plan takes
            the streamed route (``MIGRATE_STAGE`` 0), each held to the
            plain version bit for bit;
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
import re
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
                "src/repro_torch/kernels/paged_attention/csrc/"
                "paged_attention.cu",
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


MIGRATE_SHAPES = ((16, "pmem-large"), (16, "dram-cxl-pmem"),
                  (1, "dram-cxl-pmem"))
PAGES, TOP, PLAN = 65536, 8192, 64
# the serving path's fold: granite-8b's 8 sequences x 32 heads over 8 x 8 KV
# heads of 128, 32 pages of 16 tokens (8 of them fast)
FOLD = dict(H=256, KV=64, dh=128, page=16, n_pp=32, fast=8)
FOLD_POS = (15, 511)
# the same fold at 32,768 tokens a sequence (serve.py --full --batch 8
# --tokens 32768): a table of 2,048 entries, at these positions
LONG_PP, LONG_POS = 2048, (511, 32767)


def migrate_args(lanes: int, machine: str, rng):
    """``tier_migrate``'s arguments: random tiers, 64-entry plans of which
    16 demote entries name pages of the promote plan, and caps a few pages
    above each tier's occupancy, so that some entries of each plan run."""
    import numpy as np
    import torch
    from repro_torch.simulator import machines
    R = machines.get(machine).n_tiers
    tier = rng.integers(0, R, (lanes, PAGES)).astype(np.int32)
    promote = np.full((lanes, PLAN), -1, np.int32)
    demote = np.full((lanes, PLAN), -1, np.int32)
    for b in range(lanes):
        perm = rng.permutation(PAGES)
        promote[b] = perm[:PLAN]
        demote[b, :PLAN // 2] = rng.permutation(
            np.concatenate([perm[:16], perm[PLAN:PLAN + 16]]))
    occ = np.stack([(tier == r).sum(1) for r in range(R)], 1)
    caps = (occ + rng.integers(-4, 24, (lanes, R))).astype(np.int32)
    caps[:, -1] = PAGES
    f = lambda a: torch.from_numpy(np.ascontiguousarray(a)).cuda()
    return tuple(f(a) for a in (tier, promote, demote, caps))


def fold_args(pos: int, rng, n_pp: int = FOLD["n_pp"]):
    """``paged_attention``'s arguments at the serving fold over a table of
    ``n_pp`` entries, ``pos + 1`` tokens valid (pools drawn on the card
    from a seed of ``rng``)."""
    import numpy as np
    import torch
    H, KV, dh, page, fast = (FOLD[k] for k in (
        "H", "KV", "dh", "page", "fast"))
    f = lambda a: torch.from_numpy(np.ascontiguousarray(a)).cuda()
    gen = torch.Generator(device="cuda").manual_seed(int(rng.integers(2**31)))
    pools = [torch.randn((fast + n_pp, page, KV, dh), generator=gen,
                         device="cuda") for _ in (0, 1)]
    table = fast + np.arange(n_pp)
    table[rng.choice(n_pp, fast, replace=False)] = np.arange(fast)
    q = f(rng.standard_normal((1, H, dh), dtype=np.float32))
    return (q, *pools, f(table[None].astype(np.int32)),
            f(np.array([pos + 1], np.int32)))


def fold_bytes(pos: int, n_pp: int = FOLD["n_pp"]) -> int:
    """Bytes one fold call must move: q and out, the valid pages' K and V,
    the table, the length and the mass."""
    H, KV, dh, page = (FOLD[k] for k in ("H", "KV", "dh", "page"))
    pages = min(pos // page + 1, n_pp)
    return 4 * (2 * H * dh + 2 * pages * page * KV * dh + 2 * n_pp + 1)


# (lanes, machine, one row shared by the lanes)
ACCOUNT_SHAPES = ((16, "pmem-large", True), (16, "dram-cxl-pmem", True),
                  (216, "pmem-large", False))


def account_args(lanes: int, machine: str, shared: bool, rng):
    """``interval_account``'s arguments as the replay gives them: gamma
    rows (one shared by every lane in trace mode), their top-k oracle,
    random tiers and migration counts.  -> (args, bytes to move)."""
    import numpy as np
    import torch
    from repro_torch.kernels.interval_step import ref
    from repro_torch.simulator import machine_spec, machines
    spec = machines.get(machine)
    R = spec.n_tiers
    f = lambda a: torch.from_numpy(np.ascontiguousarray(a)).cuda()
    rows = 1 if shared else lanes
    true = f((2e7 / PAGES * rng.gamma(1.0, 1.0, (rows, PAGES)))
             .astype(np.float32))
    orc = ref.topk_mask_ref(true, TOP)
    if shared:
        true, orc = (x.expand(lanes, PAGES) for x in (true, orc))
    mach = machine_spec.lane_stack([spec] * lanes, PAGES, TOP, "cuda")[0]
    args = (mach, true, f(rng.integers(0, R, (lanes, PAGES)).astype(
        np.int32)), f(rng.integers(0, PLAN, (lanes, R - 1)).astype(
            np.float32)), f(rng.integers(0, PLAN, (lanes, R - 1)).astype(
                np.float32)), orc, TOP)
    return args, rows * PAGES * 5 + lanes * PAGES * 4


def digest(ts) -> str:
    h = hashlib.sha256()
    for t in ts:
        h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def paged(*a):
    from repro_torch.kernels.paged_attention import kernel as pkernel
    return pkernel.paged_attention(*a, page_mass=True)


def measure(root: Path):
    """Times in the tree at ``root`` (run in a child process)."""
    sys.path.insert(0, str(root))
    sys.path.insert(0, str(root / "src"))
    import numpy as np
    import chip_smoke as cs
    from repro_torch.kernels.interval_step import kernel

    rng = np.random.default_rng(0)
    out = {"tree": str(root), "tier_migrate digest": {}}
    for lanes, machine in MIGRATE_SHAPES:
        args = migrate_args(lanes, machine, rng)
        name = f"tier_migrate B={lanes} n={PAGES} {machine}"
        out["tier_migrate digest"][name] = digest(kernel.tier_migrate(*args))
        out[name] = cs.cuda_ms(kernel.tier_migrate,
                               cs.copies(args, 8 * PAGES * lanes))
    from repro_torch.kernels.interval_step import ops
    out["interval_account digest"] = {}
    for lanes, machine, shared in ACCOUNT_SHAPES:
        args, bytes_ = account_args(lanes, machine, shared, rng)
        name = f"interval_account B={lanes} n={PAGES} {machine}"
        out["interval_account digest"][name] = digest(
            ops.interval_account(*args))
        out[name] = cs.cuda_ms(ops.interval_account,
                               cs.copies(args, bytes_))
    for pos in FOLD_POS:
        args = fold_args(pos, rng)
        out[f"paged_attention fold pos={pos}"] = cs.cuda_ms(
            paged, cs.copies(args, fold_bytes(511)))
    for pos in LONG_POS:
        args = fold_args(pos, rng, LONG_PP)
        out[f"paged_attention fold n_pp={LONG_PP} pos={pos}"] = cs.cuda_ms(
            paged, cs.copies(args, fold_bytes(pos, LONG_PP)))
    emit(phase="ab", **out)


def clusters():
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import _backend
    from repro_torch.kernels.interval_step import kernel, ref
    from repro_torch.kernels.paged_attention import kernel as pkernel
    from repro_torch.kernels.paged_attention import ref as pref
    rng = np.random.default_rng(1)
    sizes = (1, 2, 4, 8, 12, 16)
    for lanes, machine in MIGRATE_SHAPES:
        args = migrate_args(lanes, machine, rng)
        want = ref.tier_migrate_ref(*args)
        dev = args[0].device
        key = kernel.cluster_key("migrate", lanes, PAGES, dev)
        chosen = kernel.migrate_cluster(lanes, PAGES, dev)
        row = {}
        for C in sizes:
            _backend.clusters[key] = C
            same = all(torch.equal(g, w) for g, w in
                       zip(kernel.tier_migrate(*args), want))
            row[C] = (cs.cuda_ms(kernel.tier_migrate,
                                 cs.copies(args, 8 * PAGES * lanes)), same)
        _backend.clusters[key] = chosen
        emit(phase="clusters", kernel="tier_migrate", B=lanes, n=PAGES,
             machine=machine, chosen=chosen, ms_and_equal=row)
    H, KV, dh, page = (FOLD[k] for k in ("H", "KV", "dh", "page"))
    for n_pp, pos in ((FOLD["n_pp"], 511), (LONG_PP, LONG_POS[-1])):
        args = fold_args(pos, rng, n_pp)
        want = pref.paged_attention_ref(*args, page_mass=True)
        dev = args[0].device
        key = pkernel.cluster_key(1, H, KV, page, dh, n_pp, torch.float32,
                                  dev)
        chosen = pkernel.paged_cluster(1, H, KV, page, dh, n_pp,
                                       torch.float32, dev)
        row = {}
        for C in sizes:
            _backend.clusters[key] = C
            got = paged(*args)
            err = max(float(((g.double() - w.double()).abs()
                             / w.double().abs().clamp_min(1.0)).max())
                      for g, w in zip(got, want))
            row[C] = (cs.cuda_ms(paged, cs.copies(args, fold_bytes(pos,
                                                                   n_pp))),
                      err <= 1e-5)
        _backend.clusters[key] = chosen
        emit(phase="clusters", kernel="paged_attention",
             fold=dict(FOLD, n_pp=n_pp), pos=pos, chosen=chosen,
             ms_and_within_1e_5=row)


def minblocks(out_dir: Path, counts):
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import _backend
    from repro_torch.kernels.paged_attention import kernel as pkernel
    from repro_torch.kernels.paged_attention import ref as pref
    cc, flags = nvcc_flags(ROOT)
    text = pkernel.SOURCE.read_text()
    bound = re.search(r"#define PA_MIN_BLOCKS \d+", text).group(0)
    cases = [(FOLD["n_pp"], pos) for pos in FOLD_POS] + [
        (LONG_PP, pos) for pos in LONG_POS]
    rng = np.random.default_rng(3)
    inputs = {c: fold_args(c[1], rng, c[0]) for c in cases}
    wants = {c: pref.paged_attention_ref(*a, page_mass=True)
             for c, a in inputs.items()}
    for n in counts:
        root = out_dir / f"minblocks{n}" / "kernels"
        (root / "paged_attention" / "csrc").mkdir(parents=True,
                                                  exist_ok=True)
        src = root / "paged_attention" / "csrc" / "paged_attention.cu"
        for h in _backend.HEADERS.glob("*.cuh"):
            (root / h.name).write_text(h.read_text())
        src.write_text(text if n == 0 else text.replace(
            bound, f"#define PA_MIN_BLOCKS {n}"))
        lib_path = src.with_suffix(".so")
        proc = subprocess.run([cc, *flags, "-Xptxas", "-v", "-o",
                               str(lib_path), str(src)],
                              capture_output=True, text=True)
        if proc.returncode:
            raise SystemExit(proc.stderr)
        lib = ctypes.CDLL(str(lib_path))
        for fn, argtypes in pkernel._SIGNATURES.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        pkernel._lib = lambda lib=lib: lib
        _backend.clusters.clear()
        row = {}
        for (n_pp, pos), args in inputs.items():
            got = paged(*args)
            err = max(float(((g.double() - w.double()).abs()
                             / w.double().abs().clamp_min(1.0)).max())
                      for g, w in zip(got, wants[n_pp, pos]))
            chosen = pkernel.paged_cluster(1, FOLD["H"], FOLD["KV"],
                                           FOLD["page"], FOLD["dh"], n_pp,
                                           torch.float32, args[0].device)
            row[f"n_pp={n_pp} pos={pos}"] = (
                cs.cuda_ms(paged, cs.copies(args, fold_bytes(pos, n_pp))),
                chosen, err <= 1e-5)
        lines = [ln for ln in proc.stderr.splitlines()
                 if "Used" in ln or "spill" in ln]
        emit(phase="minblocks", n=n, ms_cluster_within_1e_5=row,
             ptxas=lines)


def stage(out_dir: Path):
    """``tier_migrate`` at the ab phase's shapes (64-entry plans) from two
    copies of the interval-step source: as it is (plans of up to
    ``MIGRATE_STAGE`` entries staged in shared memory) and with
    ``MIGRATE_STAGE`` 0 (every plan streamed), each held to the plain
    version bit for bit."""
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import _backend
    from repro_torch.kernels.interval_step import kernel, ref
    cc, flags = nvcc_flags(ROOT)
    text = kernel.SOURCE.read_text()
    line = re.search(r"#define MIGRATE_STAGE \d+", text).group(0)
    rng = np.random.default_rng(0)
    inputs = {(lanes, machine): migrate_args(lanes, machine, rng)
              for lanes, machine in MIGRATE_SHAPES}
    for n in (int(line.split()[-1]), 0):
        root = out_dir / f"stage{n}" / "kernels"
        src = root / "interval_step" / "csrc" / "interval_step.cu"
        src.parent.mkdir(parents=True, exist_ok=True)
        for h in _backend.HEADERS.glob("*.cuh"):
            (root / h.name).write_text(h.read_text())
        src.write_text(text.replace(line, f"#define MIGRATE_STAGE {n}"))
        lib_path = src.with_suffix(".so")
        proc = subprocess.run([cc, *flags, "-o", str(lib_path), str(src)],
                              capture_output=True, text=True)
        if proc.returncode:
            raise SystemExit(proc.stderr)
        lib = ctypes.CDLL(str(lib_path))
        for fn, argtypes in kernel._SIGNATURES.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        kernel._lib = lambda lib=lib: lib
        _backend.clusters.clear()
        row = {}
        for (lanes, machine), args in inputs.items():
            same = all(torch.equal(g, w) for g, w in zip(
                kernel.tier_migrate(*args), ref.tier_migrate_ref(*args)))
            row[f"B={lanes} n={PAGES} {machine}"] = (
                cs.cuda_ms(kernel.tier_migrate,
                           cs.copies(args, 8 * PAGES * lanes)), same)
        emit(phase="stage", migrate_stage=n, ms_equal_plain=row)


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
                    default=["ptxas", "ab", "clusters", "minblocks",
                             "stage", "products"])
    ap.add_argument("--blocks", type=int, nargs="*", default=[0, 1, 4, 6],
                    help="the minblocks phase's resident CTAs an SM")
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
            digests.setdefault(str(tree), ab)
        if args.parent is not None:
            this, parent = (digests[str(t.resolve())]
                            for t in (ROOT, args.parent))
            emit(phase="bits", **{
                f"{nm}_equals_parent": this[f"{nm} digest"]
                == parent.get(f"{nm} digest")
                for nm in ("tier_migrate", "interval_account")})
    if "clusters" in args.only:
        clusters()
    if "minblocks" in args.only:
        minblocks(out_dir, args.blocks)
    if "stage" in args.only:
        stage(out_dir)
    if "products" in args.only:
        products(out_dir)


if __name__ == "__main__":
    main()
