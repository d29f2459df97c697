"""Sweep fabric: the plain path of ``experiment.sweep``'s dispatches.

The port of ``repro/simulator/fabric.py`` without its two extensions.
``sim_trace`` and ``sim_synth`` run one lane-batched engine pass
(``scan_engine._simulate``) over a materialized trace or a synthesized
workload stack, with per-lane specs, machines, capacities and PRNG keys,
and return the raw per-lane output dict plus the fabric's dispatch info
(``{}`` on the plain path).

Waiting for the union fabric and lane sharding (ROADMAP queue 1), raising
``NotImplementedError``: ``UnionSpec`` and ``build_union``
(one pass over a mixed-family panel), any mesh that would shard the lane
axis, and ``pad_multiple`` (forced lane padding).  ``resolve_mesh``
resolves ``None`` and ``"auto"`` on one device to the plain path, as in
JAX.
"""
from __future__ import annotations

import torch

from repro_torch.simulator import scan_engine

__all__ = ["UnionSpec", "build_union", "resolve_mesh", "sim_trace",
           "sim_synth"]

#: the queue item every refusal below names, by title
WAITS_FOR = "the union fabric and lane sharding"


def _waits(what: str):
    raise NotImplementedError(
        f"{what} waits for {WAITS_FOR} (ROADMAP queue 1, not yet ported)")


class UnionSpec:
    """Not ported: one spec whose lanes may each be a different family."""

    def __init__(self, *args, **kw):
        _waits("UnionSpec")


def build_union(*args, **kw):
    """Not ported: fuse a mixed-family panel into one pass."""
    _waits("build_union (a mixed-family panel in one pass)")


def resolve_mesh(mesh) -> int | None:
    """``mesh`` -> None for the plain path.  ``None`` never shards and
    ``"auto"`` on a host with at most one CUDA device is the plain path;
    anything that would shard the lanes raises."""
    if mesh is None:
        return None
    if mesh == "auto" and torch.cuda.device_count() <= 1:
        return None
    _waits(f"mesh={mesh!r} (sharding the lane axis over devices)")


def _plain(mesh, pad_multiple):
    resolve_mesh(mesh)
    if pad_multiple:
        _waits(f"pad_multiple={pad_multiple!r} (lane padding)")


def sim_trace(spec, trace, oracle_mask, k, mach, caps, keys, sample,
              sampling, need_normal, reduce="stack", mesh=None,
              pad_multiple=None):
    """Trace-mode pass on the plain path.  ``trace`` f32 [T, n] and
    ``oracle_mask`` bool [T, n] on the lanes' device; ``keys`` [B, 2] the
    per-lane PRNG keys (``"prng"``), ``sample`` the [T, n] CRN field
    (``"crn"``).  -> (out, {})."""
    _plain(mesh, pad_multiple)
    out = scan_engine._simulate(
        spec, scan_engine._TraceRows(trace, oracle_mask, caps.shape[0]), k,
        mach, caps, keys if sampling == "prng" else sample, sampling,
        need_normal, reduce=reduce)
    return out, {}


def sim_synth(spec, wl, k, mach, caps, keys, sample, noise_key, wl_key,
              sampling, need_normal, wl_rep, n, T, wl_boost=True,
              reduce="stack", mesh=None, pad_multiple=None):
    """Synth-mode pass on the plain path: the [W]-lane workload stack
    ``wl`` is synthesized each interval from ``wl_key`` and workload ``w``
    feeds lanes ``w * wl_rep .. w * wl_rep + wl_rep - 1``.  The noise is
    the per-lane ``keys`` [B, 2] (``"prng"``), one row an interval from
    ``noise_key`` shared by every lane (``"crn_prng"``) or the [T, n]
    field ``sample`` (``"crn"``).  -> (out, {})."""
    _plain(mesh, pad_multiple)
    source = scan_engine._SynthRows(wl, T, n, k, wl_key, wl_boost, wl_rep)
    noise = {"prng": keys, "crn_prng": noise_key}.get(sampling, sample)
    out = scan_engine._simulate(spec, source, k, mach, caps, noise, sampling,
                                need_normal, reduce=reduce)
    return out, {}
