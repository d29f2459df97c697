#!/usr/bin/env python3
"""Benchmark of the PyTorch/CUDA port of ARMS (``src/repro_torch``).

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
                             --trace <0|1>

Run from the root of a checkout on a machine with the CUDA cards the cell
asks for.  It runs cell ``<cell>`` of ``BENCHMARK.json`` (``harness.py``
says how) and prints one JSON line: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, the numbers compared with the
reference beside their limits.  It imports the port and never JAX; build
and kernel caches stay under the checkout's ``build/``.
"""
import time

T_START = time.time()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(ROOT / "build" / sub)
    here = str(Path(__file__).resolve().parent)
    sys.path[:] = [str(ROOT), str(ROOT / "src")] + [
        p for p in sys.path if str(Path(p or ".").resolve()) != here]
    from perfbench import harness
    return harness.run(args.workload, args.seed, args.seconds,
                       bool(args.trace), T_START)


if __name__ == "__main__":
    sys.exit(main())
