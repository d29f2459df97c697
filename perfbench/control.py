#!/usr/bin/env python3
"""Readings that set the limits of ``correct`` (not run by the benchmark).

    python3 perfbench/control.py --workload <cell> --seeds <n> [<n> ...]
                                 [--device cuda]

For each seed, in one process: the cell's study at its own size, one pass
of the program, and the reference over the lanes a run of that seed
would check, computed twice: in float32 (the judge) and in bfloat16 (the
control: the reference put in the program's place one precision below
the configuration's float32).  Prints one JSON line a seed with the
program's readings against the judge (``program``) and the control's
(``control``).  The limits lie above the first and below the second.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def readings(name: str, seed: int, device: str, shrink=None) -> dict:
    from perfbench import cells, compare
    cell = cells.cell(name, seed, device=device, shrink=shrink)
    study = cells.load("studies", cell.traffic["study"]).Study(cell)
    got = {(0, key): v for key, v in study.run(0).items()}
    samples = [(0, i) for i in compare.sample(seed, 0, study.lanes,
                                              study.check_lanes)]
    judge = study.reference(samples)
    low = study.reference(samples, lowp=True)
    return dict(cell=name, seed=seed,
                program=compare.readings(got, judge),
                control=compare.readings(low, judge))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    for seed in args.seeds:
        t0 = time.time()
        out = readings(args.workload, seed, args.device)
        out["seconds"] = time.time() - t0
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
