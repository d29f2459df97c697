#!/usr/bin/env python3
"""Device times behind the redesign of the port's ``migrate`` kernel (one
launch a fire), on one NVIDIA GPU.

    python3 tools/migrate_probe.py [--parent DIR] [--only PHASE ...]

Run from the repository root on a machine with a CUDA card and ``nvcc``.
Phases (all by default):

  ptxas  registers, spills and shared memory of ``migrate.cu``'s kernel
         (``nvcc -Xptxas -v`` with the port's flags);
  ab     device times of one fire at the serving fold (K and V pools of
         8 fast + 32 home pages of 4 tokens x 8 sequences x 8 KV heads x
         128, f32; 8 demotions and 8 promotions, every promotion into a
         vacated slot) and of 8 promotions at deepseek-v2-236b's expert slab
         rows (``wi`` [5120, 3072] and ``wo`` [1536, 5120] bf16, fused
         [8 + 16]-row pools; each alone and both in one fire), with the
         home pools on the card, and with them pinned on the host (the
         serving fold and ``wi``): this tree's kernel and, with
         ``--parent`` (a checkout of another commit,
         e.g. ``git archive <commit> | tar -x -C build/parent``), the
         parent's kernel (``arms_migrate``: a launch a direction and a
         row shape, so a fire at the serving fold is two launches and a
         fire over both slab weights two), in the order parent, this,
         this, parent; every output held bit for bit to the plain fire;
         with the homes pinned, beside one ``copy_`` of the promotions'
         bytes from pinned memory (the copy engines);
  rows   ``chip_smoke.py``'s kernel-phase lines of ``migrate`` (the serving
         fold's fires, the expert slabs in one launch, the host-link rows)
         and of ``paged_attention``, as the script prints them.

Times are CUDA-event medians (``chip_smoke.cuda_ms``: graphs of repeated
calls over inputs larger than L2).  Each line is a JSON object; the card's
name and power limit come first.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _backend  # noqa: E402
from repro_torch.kernels.migrate import kernel as mkernel  # noqa: E402
from repro_torch.kernels.migrate import ref as mref  # noqa: E402

_P, _I = ctypes.c_void_p, ctypes.c_int
PARENT_SIGNATURES = {"arms_migrate": [_P, _P, _I, _P, _P, _P, _I,
                                      ctypes.c_int64, _I, _I, _P]}


def emit(**kw):
    print(json.dumps(kw), flush=True)


def ptxas():
    flags = [f for f in _backend.NVCC_FLAGS if f not in ("-shared",)]
    proc = subprocess.run(
        [_backend.nvcc(), *flags, "-Xptxas", "-v", "-c", "-o", "/dev/null",
         str(mkernel.SOURCE)], capture_output=True, text=True)
    emit(phase="ptxas", rc=proc.returncode,
         lines=[ln for ln in proc.stderr.splitlines() if ln.strip()])


def parent_tables(k, out_row, in_row):
    """The parent's row moves within a fused pool: (src, dst, valid) of
    the demotions' copy-back, when the fire has any, and of the
    promotions."""
    slots = torch.arange(k, dtype=torch.int32, device=out_row.device)
    moves = [(slots, k + out_row, out_row >= 0)] \
        if bool((out_row >= 0).any()) else []
    return moves + [(k + in_row, slots, in_row >= 0)]


def parent_fire(lib, n_pools, *a):
    """The parent kernel's fire over fused pools ``a[:n_pools]``: a launch
    for the demotions' copy-back (where the fire has one) and one for the
    promotions, over the pools of each row shape (the parent's
    ``pool_fire``)."""
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    pools, tabs = a[:n_pools], a[n_pools:]
    groups = {}
    for p in pools:
        groups.setdefault((p.dtype, tuple(p.shape)), []).append(p)
    for group in groups.values():
        ptrs = (ctypes.c_void_p * len(group))(*(p.data_ptr() for p in group))
        rb = group[0][0].numel() * group[0].element_size()
        rows = group[0].shape[0]
        for j in range(0, len(tabs), 3):
            src, dst, ok = tabs[j:j + 3]
            err = lib.arms_migrate(ptrs, ptrs, len(group), src.data_ptr(),
                                   dst.data_ptr(), ok.data_ptr(),
                                   src.shape[0], rb, rows, rows, stream)
            if err:
                raise RuntimeError(f"parent migrate: CUDA error {err}")
    return pools


def groups_of(pools) -> int:
    return len({(p.dtype, tuple(p.shape)) for p in pools})


def cases(rng, dev):
    """(label, fused pools, k, out_row, in_row): the ab phase's fires."""
    F_ = cs.SB * cs.SKV * cs.DH
    out_row, in_row, _ = cs.fire_tables(rng, cs.PF, cs.NP, cs.PF)
    idx = lambda a: torch.as_tensor(a, device=dev)
    kv = tuple(torch.randn((cs.PF + cs.NP, cs.PG, F_), device=dev)
               for _ in (0, 1))
    yield "serving fold", kv, cs.PF, idx(out_row), idx(in_row)
    del kv
    out_row, in_row, _ = cs.fire_tables(rng, cs.SLAB_FAST, cs.SLAB_HOME,
                                        cs.SLAB_MOVES, vacate=False)
    slabs = {nm: torch.randn((cs.SLAB_FAST + cs.SLAB_HOME,) + row,
                             device=dev, dtype=torch.bfloat16)
             for nm, row in cs.slab_shapes()}
    for label, pools in (("slabs wi", (slabs["wi"],)),
                         ("slabs wo", (slabs["wo"],)),
                         ("slabs wi + wo", tuple(slabs.values()))):
        yield label, pools, cs.SLAB_FAST, idx(out_row), idx(in_row)


def ab(parent: Path | None):
    dev = torch.device("cuda")
    lib = None if parent is None else _backend.library(
        parent / "src/repro_torch/kernels/migrate/csrc/migrate.cu",
        PARENT_SIGNATURES)
    for label, pools, k, out_row, in_row in cases(
            np.random.default_rng(0), dev):
        rb = sum(p[0].numel() * p.element_size() for p in pools)
        moves = int((out_row >= 0).sum() + (in_row >= 0).sum())
        bytes_ = 2 * moves * rb
        want = [p.clone() for p in pools]
        mref.migrate_fire_ref([w[:k] for w in want], [w[k:] for w in want],
                              out_row, in_row)
        for home in ("card", "pinned"):
            if home == "pinned" and label not in ("serving fold",
                                                  "slabs wi"):
                continue
            homes = [p[k:].clone() for p in pools] if home == "card" else \
                [cs.pinned_copy(p[k:]) for p in pools]
            fasts = [p[:k].clone() for p in pools]
            # the inputs of every correctness check (timing updates
            # ``fasts`` and ``homes`` in place)
            first = [x.clone() for x in fasts + homes]

            def this(*a):
                n = (len(a) - 2) // 2
                mkernel.migrate_fire(a[:n], a[n:2 * n], a[-2], a[-1])
                return a[:2 * n]

            args = tuple(fasts) + tuple(homes) + (out_row, in_row)
            runs = {"this": this}
            if home == "card":
                if lib is not None:
                    fused = tuple(p.clone() for p in pools)
                    fused0 = tuple(p.clone() for p in pools)
                    ptabs = tuple(t for m in parent_tables(k, out_row, in_row)
                                  for t in m)
                    runs["parent"] = lambda *a: parent_fire(lib, len(pools),
                                                            *a)
            order = ([("parent",)] if "parent" in runs else []) + [
                tuple(r for r in runs if r != "parent")] * 2 + (
                [("parent",)] if "parent" in runs else [])
            ms = {r: [] for r in runs}
            for group in order:
                for r in group:
                    if r == "parent":
                        a = fused + ptabs
                        got = runs[r](*tuple(p.clone() for p in fused0),
                                      *ptabs)
                        exact = all(torch.equal(g, w)
                                    for g, w in zip(got, want))
                    else:
                        a = args
                        fresh = tuple(cs.pinned_copy(x) if x.device.type
                                      == "cpu" else x.clone() for x in first)
                        got = runs[r](*fresh, out_row, in_row)
                        torch.cuda.synchronize()
                        n = len(fasts)
                        exact = all(torch.equal(
                            torch.cat([g.to(dev), h.to(dev)]), w)
                            for g, h, w in zip(got[:n], got[n:], want))
                    if not exact:
                        raise AssertionError(f"{label} {home} {r}: differs "
                                             f"from the plain fire")
                    ms[r].append(cs.cuda_ms(runs[r], cs.copies(a, bytes_)))
            # each way over the link: the promotions up, the demotions down
            link = max(int((r >= 0).sum()) for r in (out_row, in_row)) * rb \
                if home == "pinned" else None
            if link:
                up = int((in_row >= 0).sum()) * rb
                host = torch.empty(up, dtype=torch.uint8, pin_memory=True)
                card = torch.empty(up, dtype=torch.uint8, device=dev)
                ms["copy_ of the promotions' bytes"] = cs.cuda_ms(
                    lambda s_, d_: d_.copy_(s_, non_blocking=True),
                    [(host, card)])
                del host, card
            emit(phase="ab", fire=label, home=home, k=k, moves=moves,
                 bytes=bytes_, bound_ms=(link / cs.PCIE_BYTES_PER_S * 1e3
                                         if link else bytes_
                                         / cs.HBM_BYTES_PER_S * 1e3),
                 bound_by="host link" if link else "HBM",
                 ms={r: v for r, v in ms.items()},
                 launches_a_fire={r: (groups_of(pools) * len(ptabs) // 3
                                      if r == "parent" else 1)
                                  for r in runs})
        del pools, want
        torch.cuda.empty_cache()


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path)
    ap.add_argument("--only", nargs="*",
                    default=["ptxas", "ab", "rows"])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("migrate_probe: no CUDA device")
    emit(card=cs.card_line(), torch=torch.__version__,
         cuda=torch.version.cuda)
    if "ptxas" in args.only:
        ptxas()
    if "ab" in args.only:
        ab(None if args.parent is None else args.parent.resolve())
    if "rows" in args.only:
        dev, rng = torch.device("cuda"), np.random.default_rng(0)
        entry = cs.make_entry({})
        cs.serving_rows(entry, lambda a: torch.from_numpy(
            np.ascontiguousarray(a)).to(dev), rng)
        cs.slab_rows(entry, rng, dev)
        cs.offload_rows(entry, rng, dev)


if __name__ == "__main__":
    main()
