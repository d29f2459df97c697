"""Two-tier machine models (paper Table 3) and the interval cost model.

The simulator charges each interval of application work against the tier the
pages live in:

    t_lat     = (acc_fast*L_fast + acc_slow*L_slow) / MLP
    t_bw_fast = (acc_fast*CL + mig_bytes) / BW_fast
    t_bw_slow = (acc_slow*CL + mig_bytes_slow) / BW_slow
    t         = max(t_lat, t_bw_fast, t_bw_slow)

i.e. the workload is limited by whichever resource saturates first; migration
traffic shares tier bandwidth with the application (this is exactly the
interference ARMS's BS formula manages).  MLP models the memory-level
parallelism of the threaded workload.

The port keeps its own copy of this JAX-free module (it imports nothing
of ``repro``).  Its engine runs the N-tier generalization of this model
(simulator/machine_spec.py); the two-tier dataclass here remains the
host-facing Table-3 description and converts via ``machines.get``.
"""
from __future__ import annotations

import dataclasses

CACHELINE = 64
PAGE_BYTES = 2 * 1024 * 1024  # 2 MB huge pages (paper §5)


@dataclasses.dataclass(frozen=True)
class MachineSpec:
    name: str
    lat_fast_ns: float
    lat_slow_ns: float
    bw_fast: float          # B/s
    bw_slow_read: float     # B/s
    bw_slow_write: float    # B/s
    mlp: float = 64.0       # outstanding misses across threads


# Table 3.
PMEM_LARGE = MachineSpec(
    name="pmem-large",
    lat_fast_ns=80.0, lat_slow_ns=200.0,
    bw_fast=138e9, bw_slow_read=7.45e9, bw_slow_write=2.25e9)

NUMA = MachineSpec(
    name="NUMA",
    lat_fast_ns=95.0, lat_slow_ns=145.0,
    bw_fast=56e9, bw_slow_read=36e9, bw_slow_write=36e9)

MACHINES = {"pmem-large": PMEM_LARGE, "numa": NUMA}


@dataclasses.dataclass(frozen=True)
class IntervalOutcome:
    """Raw (UNCLAMPED) utilization ratios: a tier demanding more
    bandwidth-time than the rest of the interval provides reports > 1 —
    the oversaturation magnitude the controller's cost/benefit signal
    needs.  Clamping happens only at the signal consumer (the engines
    clamp the policy-facing signal; core/scheduler.batch_size clips its
    input); ``min(1, raw)`` reproduces the old at-source clamp bitwise."""

    wall_s: float
    slow_bw_frac: float   # slow-tier bandwidth-time / rest of interval
    app_bw_frac: float    # fast-tier bandwidth-time / rest of interval


def interval_time(m: MachineSpec, acc_fast: float, acc_slow: float,
                  promo_pages: float, demo_pages: float) -> IntervalOutcome:
    """Wall time for one interval of work under a given placement."""
    app_fast_bytes = acc_fast * CACHELINE
    app_slow_bytes = acc_slow * CACHELINE
    # promotion: read slow + write fast; demotion: read fast + write slow.
    mig_fast_bytes = (promo_pages + demo_pages) * PAGE_BYTES
    mig_slow_read = promo_pages * PAGE_BYTES
    mig_slow_write = demo_pages * PAGE_BYTES

    t_lat = (acc_fast * m.lat_fast_ns + acc_slow * m.lat_slow_ns) * 1e-9 / m.mlp
    t_bw_fast = (app_fast_bytes + mig_fast_bytes) / m.bw_fast
    t_bw_slow = ((app_slow_bytes + mig_slow_read) / m.bw_slow_read
                 + mig_slow_write / m.bw_slow_write)
    wall = max(t_lat, t_bw_fast, t_bw_slow, 1e-12)

    slow_frac = t_bw_slow / max(t_lat, t_bw_fast, 1e-12)
    app_frac = t_bw_fast / max(t_lat, t_bw_slow, 1e-12)
    return IntervalOutcome(wall_s=wall, slow_bw_frac=slow_frac,
                           app_bw_frac=app_frac)
