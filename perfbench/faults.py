#!/usr/bin/env python3
"""Faults planted under the timed path, for showing that a run with one
comes out not correct (not run by the benchmark).

    python3 perfbench/faults.py --workload <cell> --seed <n> --fault <name>
                                [--seconds <s>]

runs the cell through the whole harness at its own size with the fault
planted and prints the run's result line.  ``FAULTS`` names each fault a
replay on one chip can have:

  * ``unchanged_migrations``: the migration step returns its state
    unchanged;
  * ``half_left_out``: half of the lanes left out, their answers the mean
    of the others';
  * ``answer_altered``: one lane's promotions altered where ``_simulate``
    produces them.

A plant takes ``setattr`` (or pytest's ``monkeypatch.setattr``).
"""
import argparse
import sys
import time

T_START = time.time()

from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def unchanged_migrations(setattr):
    import torch
    from repro_torch.kernels.interval_step import ops

    def step(tier, promote, demote, caps):
        none = lambda plan: torch.zeros_like(plan, dtype=torch.bool)
        z = torch.zeros((tier.shape[0], caps.shape[-1] - 1),
                        dtype=torch.int32, device=tier.device)
        return tier, none(promote), none(demote), z, z
    setattr(ops, "tier_migrate", step)


def _wrap_simulate(setattr, change):
    from repro_torch.simulator import scan_engine
    real = scan_engine._simulate

    def simulate(*a, **kw):
        out = real(*a, **kw)
        change(out)
        return out
    setattr(scan_engine, "_simulate", simulate)


def half_left_out(setattr):
    def change(out):
        B = out["promotions"].shape[0]
        h = max(1, B // 2)
        for v in out.values():
            if v.dim() == 1:
                mean = v[:h].double().mean()
                v[h:] = mean.round() if not v.is_floating_point() else mean
    _wrap_simulate(setattr, change)


def answer_altered(setattr):
    def change(out):
        out["promotions"][-1] += 1
    _wrap_simulate(setattr, change)


FAULTS = {f.__name__: f for f in (unchanged_migrations, half_left_out,
                                    answer_altered)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--fault", choices=sorted(FAULTS), required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from perfbench import harness
    FAULTS[args.fault](setattr)
    return harness.run(args.workload, args.seed, args.seconds, False,
                       T_START)


if __name__ == "__main__":
    sys.exit(main())
