"""Workload access-trace generators (paper Table 4 analogues) — the
materializing API (the port of ``repro/simulator/workloads.py``).

Every generator is a thin constructor over the declarative
``WorkloadSpec`` protocol (simulator/workload_spec.py): it builds the
spec and materializes the dense ``[T, n_pages]`` float32 array of TRUE
per-interval access counts a trace replay reads (on the card unless the
caller passes ``device="cpu"``).
Every interval carries the same amount of application work (``work``
accesses), so simulated execution time is directly comparable across
policies.  PEBS-style sampling noise is applied separately (sampling.py)
— policies never see these true counts.

The scan engine does not need these arrays at all: it synthesizes the
same counts on the device, interval by interval, directly from the spec
(O(n) per lane instead of O(T*n) — see
``scan_engine.simulate_workload`` / ``sweep_workloads``), bit for bit
the materialized rows on the same device.

The set mirrors the paper's workloads: GUPS (dynamic hot set), Silo-YCSB /
Btree (Zipfian), Silo-TPCC ("latest" distribution), XSBench (small hot set +
uniform background), GapBS BC/PR/CC (power-law with phase changes), and a
Liblinear-style periodic streaming workload (§7.2 "dynamic batched
migrations").
"""
from __future__ import annotations

import numpy as np

from repro_torch.simulator import workload_spec
from repro_torch.simulator.workload_spec import DEFAULT_PAGES, DEFAULT_WORK


def gups(T: int, n: int = DEFAULT_PAGES, work: float = DEFAULT_WORK,
         seed: int = 0, hot_frac: float = 0.125, hot_weight: float = 0.9,
         shift_every: int = 150, device=None) -> np.ndarray:
    """Uniform accesses within a small hot set that RELOCATES periodically."""
    return workload_spec.gups_spec(
        work=work, seed=seed, hot_frac=hot_frac, hot_weight=hot_weight,
        shift_every=shift_every).materialize(T, n, device=device)


def zipfian(T: int, n: int = DEFAULT_PAGES, work: float = DEFAULT_WORK,
            seed: int = 1, s: float = 0.99, shuffle_at=(),
            device=None) -> np.ndarray:
    """Static Zipf distribution (Silo YCSB-C), optional one-shot mid-run
    reshuffles (independently-permuted phases)."""
    return workload_spec.zipf_shuffled_spec(
        s=s, work=work, seed=seed, shuffle_at=shuffle_at).materialize(
        T, n, device=device)


def btree(T: int, n: int = DEFAULT_PAGES, work: float = DEFAULT_WORK,
          seed: int = 2, device=None) -> np.ndarray:
    """Zipfian index lookups with a hot-set change mid-run (paper Fig. 9)."""
    return workload_spec.btree_spec(T, work=work, seed=seed).materialize(
        T, n, device=device)


def silo_ycsb(T: int, n: int = DEFAULT_PAGES, work: float = DEFAULT_WORK,
              seed: int = 3, device=None) -> np.ndarray:
    return zipfian(T, n, work, seed=seed, s=0.99, device=device)


def silo_tpcc(T: int, n: int = DEFAULT_PAGES, work: float = DEFAULT_WORK,
              seed: int = 4, window_frac: float = 0.15,
              drift_pages: float = 2.0, device=None) -> np.ndarray:
    """"Latest" distribution: a hot window slides forward as rows are
    inserted (paper §7.1: Memtis's infrequent cooling hurts here).

    Drift is calibrated to TPC-C-like insert rates: tens of thousands of
    txn/s filling a 2 MB page every ~50 ms -> ~2 pages per 100 ms interval.
    """
    return workload_spec.tpcc_spec(
        work=work, seed=seed, window_frac=window_frac,
        drift_pages=drift_pages).materialize(T, n, device=device)


def xsbench(T: int, n: int = DEFAULT_PAGES, work: float = DEFAULT_WORK,
            seed: int = 5, hot_frac: float = 0.02, device=None) -> np.ndarray:
    """Small very-hot lookup tables + uniform random background over the
    whole RSS — the background makes threshold policies thrash (§3.2)."""
    return workload_spec.xsbench_spec(
        work=work, seed=seed, hot_frac=hot_frac).materialize(
        T, n, device=device)


def gapbs_bc(T: int, n: int = DEFAULT_PAGES, work: float = DEFAULT_WORK,
             seed: int = 6, device=None) -> np.ndarray:
    return workload_spec.gapbs_spec(
        s=0.8, work=work, seed=seed, boost_every=40, boost_frac=0.05,
        boost_gain=0.3).materialize(T, n, device=device)


def gapbs_pr(T: int, n: int = DEFAULT_PAGES, work: float = DEFAULT_WORK,
             seed: int = 7, device=None) -> np.ndarray:
    return workload_spec.zipf_spec(
        s=0.7, work=work, seed=seed).materialize(T, n, device=device)


def gapbs_cc(T: int, n: int = DEFAULT_PAGES, work: float = DEFAULT_WORK,
             seed: int = 8, device=None) -> np.ndarray:
    return workload_spec.gapbs_spec(
        s=0.75, work=work, seed=seed, boost_every=100, boost_frac=0.1,
        boost_gain=0.2).materialize(T, n, device=device)


def liblinear(T: int, n: int = DEFAULT_PAGES, work: float = DEFAULT_WORK,
              seed: int = 9, period: int = 20, duty: float = 0.5,
              device=None) -> np.ndarray:
    """Periodic phases: memory-intensive Zipf sweeps alternating with
    near-idle compute phases — batched migration's best case (§7.2)."""
    return workload_spec.liblinear_spec(
        work=work, seed=seed, period=period, duty=duty).materialize(
        T, n, device=device)


WORKLOADS = {
    "gups": gups,
    "btree": btree,
    "silo-ycsb": silo_ycsb,
    "silo-tpcc": silo_tpcc,
    "xsbench": xsbench,
    "gapbs-bc": gapbs_bc,
    "gapbs-pr": gapbs_pr,
    "gapbs-cc": gapbs_cc,
    "liblinear": liblinear,
}


def spec(name: str, T: int = 400, work: float = DEFAULT_WORK,
         seed_offset: int = 0) -> workload_spec.WorkloadSpec:
    """The ``WorkloadSpec`` behind ``make`` (seed derivation lives in
    ``workload_spec.named``)."""
    return workload_spec.named(name, T=T, work=work,
                               seed_offset=seed_offset)


def make(name: str, T: int = 400, n: int = DEFAULT_PAGES,
         work: float = DEFAULT_WORK, seed_offset: int = 0,
         device=None) -> np.ndarray:
    return spec(name, T=T, work=work, seed_offset=seed_offset).materialize(
        T, n, device=device)
