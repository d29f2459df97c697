"""Declarative N-tier machine protocol: batchable ``TieredMachineSpec``.

A machine is a tensor dataclass whose leaves are per-tier arrays

    lat_ns[R], bw_read[R], bw_write[R], capacity_pages[R], mlp

over a tier chain (tier 0 fastest, R-1 the unbounded bottom).  Sweep
lanes stack them into ``[B, R]`` f32 leaves (``lane_stack``), the layout
the engine and the interval-step kernels read.

Cost-model semantics (generalizing machine.interval_time): placement is
an i32 per-page tier index; migrations are chains of adjacent-pair hops,
each crossing charging its endpoints' bandwidth; tier 0 charges all its
traffic against one symmetric bandwidth, every lower tier charges reads
and writes separately.

Capacity encoding (``capacity_pages``, resolved per run by
``resolved_caps``): ``c == 0`` unbounded (n pages), ``c > 0`` absolute
pages, ``c < 0`` ``round(-c*k)`` pages.  Tier 0 always resolves to the
run's ``k`` and the bottom tier to ``n``.

Host precompute stays in numpy f64: the per-pair migration costs
(``promo_pair_us``/``demo_pair_us``) are computed in f64 at construction
and cast to f32 once at the lane stack, and ``interval_outcome_host`` is
the f64 reference cost model (``tier_utilization_host`` its per-tier
utilization) — both exactly as the JAX package does.
Host-constructed specs therefore carry numpy leaves; ``lane_stack``
returns tensors.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.simulator.machine import CACHELINE, PAGE_BYTES, MachineSpec
from repro_torch.utils.pytree import tensor_dataclass
from repro_torch.utils.device import resolve_device


@tensor_dataclass(meta=("name",))
class TieredMachineSpec:
    """N-tier machine; every field but ``name`` is a (batchable) leaf."""

    lat_ns: torch.Tensor          # [R] per-access latency (ns)
    bw_read: torch.Tensor         # [R] B/s (tier 0: symmetric bandwidth)
    bw_write: torch.Tensor        # [R]
    capacity_pages: torch.Tensor  # [R] encoded capacities (module doc)
    mlp: torch.Tensor             # scalar memory-level parallelism
    promo_pair_us: torch.Tensor   # [R-1] per-pair hop costs (f64-derived)
    demo_pair_us: torch.Tensor    # [R-1]
    name: str = "machine"

    @property
    def n_tiers(self) -> int:
        return int(self.lat_ns.shape[-1])

    def promo_path_us(self):
        """Full bottom-to-top promotion cost (f32 sum over the pairs)."""
        return _pair_sum(self.promo_pair_us)

    def demo_path_us(self):
        return _pair_sum(self.demo_pair_us)


def _pair_sum(x):
    out = x[..., 0]
    for j in range(1, x.shape[-1]):
        out = out + x[..., j]
    return out


def make(name: str, lat_ns, bw_read, bw_write, capacity_pages=None,
         mlp: float = 64.0) -> TieredMachineSpec:
    """Host constructor: f64 numpy leaves (``lane_stack`` casts)."""
    lat = np.asarray(lat_ns, np.float64)
    br = np.asarray(bw_read, np.float64)
    bw = np.asarray(bw_write, np.float64)
    R = lat.shape[0]
    if R < 2 or br.shape[0] != R or bw.shape[0] != R:
        raise ValueError(f"need >=2 tiers with matching leaves, got "
                         f"{lat.shape}/{br.shape}/{bw.shape}")
    caps = (np.zeros(R) if capacity_pages is None
            else np.asarray(capacity_pages, np.float64))
    if caps.shape[0] != R:
        raise ValueError("capacity_pages length must equal tier count")
    # hop j+1 -> j reads the lower tier and writes the upper one; the
    # term order matches the JAX package's machine.promo_page_us /
    # demo_page_us exactly.
    promo = (PAGE_BYTES / br[1:] + PAGE_BYTES / bw[:-1]) * 1e6
    demo = (PAGE_BYTES / br[:-1] + PAGE_BYTES / bw[1:]) * 1e6
    return TieredMachineSpec(
        lat_ns=lat, bw_read=br, bw_write=bw,
        capacity_pages=caps, mlp=np.float64(mlp),
        promo_pair_us=promo, demo_pair_us=demo, name=name)


def from_machine(m: MachineSpec) -> TieredMachineSpec:
    """The two-tier dataclass as a tier chain (tier 0 takes the run's k,
    the slow tier is unbounded)."""
    return make(m.name, [m.lat_fast_ns, m.lat_slow_ns],
                [m.bw_fast, m.bw_slow_read], [m.bw_fast, m.bw_slow_write],
                mlp=m.mlp)


def resolved_caps(spec: TieredMachineSpec, n: int, k: int) -> np.ndarray:
    """Concrete per-tier capacities (i32 [R]) for a run of n pages, tier-0
    capacity k."""
    caps = np.asarray(spec.capacity_pages, np.float64)
    R = caps.shape[0]
    out = np.empty(R, np.int64)
    out[0] = k
    out[R - 1] = n
    for r in range(1, R - 1):
        c = caps[r]
        if c == 0:
            out[r] = n
        elif c < 0:
            out[r] = int(round(-c * k))
        else:
            out[r] = int(round(c))
    return np.clip(out, 0, n).astype(np.int32)


def pad_tiers(spec: TieredMachineSpec, caps: np.ndarray, R_target: int):
    """Insert neutral tiers (cap 0, bw inf, lat 0) above the bottom tier so
    machines of different depth stack into one lane axis; pair-cost leaves
    are zero-extended."""
    R = spec.n_tiers
    if R == R_target:
        return spec, caps
    if R > R_target:
        raise ValueError(f"cannot shrink {R} tiers to {R_target}")
    pad = R_target - R
    f32 = np.float32
    ins = lambda arr, val: np.concatenate(
        [np.asarray(arr, f32)[:-1], np.full(pad, val, f32),
         np.asarray(arr, f32)[-1:]])
    spec = dataclasses.replace(
        spec,
        lat_ns=ins(spec.lat_ns, 0.0),
        bw_read=ins(spec.bw_read, np.inf),
        bw_write=ins(spec.bw_write, np.inf),
        capacity_pages=ins(spec.capacity_pages, 1e-9),
        promo_pair_us=np.concatenate(
            [np.asarray(spec.promo_pair_us, f32), np.zeros(pad, f32)]),
        demo_pair_us=np.concatenate(
            [np.asarray(spec.demo_pair_us, f32), np.zeros(pad, f32)]))
    caps = np.concatenate(
        [caps[:-1], np.zeros(pad, np.int32), caps[-1:]]).astype(np.int32)
    return spec, caps


def lane_stack(machs: list, n: int, k: int, device=None):
    """Stack resolved machines into one lane axis.

    -> (TieredMachineSpec with [M, ...] f32 tensor leaves, caps i32
    tensor [M, R]) on ``device`` (``None``: the CUDA card).  Tier counts
    are unified by neutral padding; the stacked spec is named ``"lanes"``.
    """
    device = resolve_device(device)
    machs = list(machs)
    R = max(m.n_tiers for m in machs)
    specs, caps = [], []
    for m in machs:
        sp, cp = pad_tiers(m, resolved_caps(m, n, k), R)
        specs.append(sp)
        caps.append(cp)
    leaf = lambda nm: torch.from_numpy(np.stack(
        [np.asarray(getattr(s, nm), np.float32) for s in specs])).to(device)
    stacked = TieredMachineSpec(
        **{f.name: leaf(f.name) for f in dataclasses.fields(TieredMachineSpec)
           if f.name != "name"}, name="lanes")
    return stacked, torch.from_numpy(np.stack(caps)).to(device)


# ------------------------------------------------------- host cost model
def interval_outcome_host(spec: TieredMachineSpec, acc, mig_up, mig_down):
    """f64 reference interval cost.  ``acc`` [R] per-tier access counts,
    ``mig_up``/``mig_down`` [R-1] pages crossing each adjacent pair.
    Returns (wall_s, slow_share, app_bw_frac_raw, slow_bw_frac_raw); the
    *_raw ratios are unclamped (> 1 == oversaturated)."""
    lat = np.asarray(spec.lat_ns, np.float64)
    br = np.asarray(spec.bw_read, np.float64)
    bw = np.asarray(spec.bw_write, np.float64)
    R = lat.shape[0]
    acc = np.asarray(acc, np.float64)
    up = np.asarray(mig_up, np.float64)
    down = np.asarray(mig_down, np.float64)

    t_lat = acc[0] * lat[0]
    for r in range(1, R):
        t_lat = t_lat + acc[r] * lat[r]
    t_lat = t_lat * 1e-9 / float(spec.mlp)

    times = [(acc[0] * CACHELINE + (up[0] + down[0]) * PAGE_BYTES) / br[0]]
    for r in range(1, R):
        rd = up[r - 1]
        if r < R - 1:
            rd = rd + down[r]
        wr = down[r - 1]
        if r < R - 1:
            wr = wr + up[r]
        times.append((acc[r] * CACHELINE + rd * PAGE_BYTES) / br[r]
                     + wr * PAGE_BYTES / bw[r])

    wall = max(t_lat, *times, 1e-12)
    rest = acc[1]
    for r in range(2, R):
        rest = rest + acc[r]
    slow_share = rest / max(acc[0] + rest, 1e-9)
    app_raw = times[0] / max(t_lat, *times[1:], 1e-12)
    slow_raw = max(times[1:]) / max(t_lat, times[0], 1e-12)
    return wall, slow_share, app_raw, slow_raw


def tier_utilization_host(spec: TieredMachineSpec, acc, mig_up, mig_down):
    """f64 mirror of ``simjax.tier_utilization_impl``: each tier's
    bandwidth time over the interval wall.  Returns f64 [R]."""
    lat = np.asarray(spec.lat_ns, np.float64)
    br = np.asarray(spec.bw_read, np.float64)
    bw = np.asarray(spec.bw_write, np.float64)
    R = lat.shape[0]
    acc = np.asarray(acc, np.float64)
    up = np.asarray(mig_up, np.float64)
    down = np.asarray(mig_down, np.float64)

    t_lat = float((acc * lat).sum()) * 1e-9 / float(spec.mlp)
    times = [(acc[0] * CACHELINE + (up[0] + down[0]) * PAGE_BYTES) / br[0]]
    for r in range(1, R):
        rd = up[r - 1]
        if r < R - 1:
            rd = rd + down[r]
        wr = down[r - 1]
        if r < R - 1:
            wr = wr + up[r]
        times.append((acc[r] * CACHELINE + rd * PAGE_BYTES) / br[r]
                     + wr * PAGE_BYTES / bw[r])
    wall = max(t_lat, *times, 1e-12)
    return np.asarray(times, np.float64) / wall
