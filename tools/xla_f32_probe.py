#!/usr/bin/env python3
"""Census of the one f32 step where the port's workload synthesis leaves
XLA's compiled CPU code: ``pow``.

    PYTHONPATH=src JAX_PLATFORMS=cpu python3 tools/xla_f32_probe.py

Runs on the CPU with both packages installed and prints:

  * ``pow``: XLA's ``(r + 1) ** -s`` (glibc's ``powf``) against the
    port's f64 ``pow`` rounded once, over r < 65,536, for the named
    workloads' zipf exponents: elements that differ, largest ulp distance;
  * whole rows: for each named workload, the elements of the port's
    ``materialize`` that differ from JAX's and the largest ulp distance,
    at n = 1,024 (T = 64) and at the main path's n = 65,536 (T = 41).

The other f32 steps (row sums, ``exp``, the ``pow(exp(a), w)`` rewrite)
are XLA's bit for bit; ``tests/test_torch_workload_spec.py`` asserts them.
"""
from __future__ import annotations

import jax
import numpy as np
import torch

from repro.simulator import workload_spec as jws
from repro_torch.simulator import workload_spec as pws


def ulps(a, b) -> np.ndarray:
    ai = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    bi = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(ai - bi)


def main():
    r = np.arange(65536, dtype=np.float32) + 1
    for s in (0.99, 0.9, 0.8, 0.75, 0.7, 0.6):
        want = np.asarray(jax.jit(lambda r, s: r ** -s)(r, np.float32(s)))
        got = pws._pow(torch.from_numpy(r), torch.tensor(-np.float32(s)))
        d = ulps(want, got.numpy())
        print(f"pow s={s}: {int((d > 0).sum())} of {r.size} differ, "
              f"at most {int(d.max())} ulp")

    for n, T in ((1024, 64), (65536, 41)):
        for name in jws.NAMED_WORKLOADS:
            a = jws.named(name, T=64).materialize(T, n, 3)
            b = pws.named(name, T=64).materialize(T, n, 3, device="cpu")
            d = ulps(a, b)
            print(f"rows n={n} T={T} {name}: {int((d > 0).sum())} of "
                  f"{d.size} differ, at most {int(d.max())} ulp")


if __name__ == "__main__":
    main()
