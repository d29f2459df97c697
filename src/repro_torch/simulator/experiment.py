"""Axis-product experiment API: policies x workloads x machines x seeds.

The port of ``repro/simulator/experiment.py``.  Policies
(baselines/protocol.py), workloads (simulator/workload_spec.py) and
machines (simulator/machine_spec.py) are each a lane-batchable spec, so a
whole P x W x M x S panel flattens into the lanes of one engine pass per
policy family:

    res = experiment.sweep(
        policies=["arms", HeMemSpec.make(hot_threshold=4)],
        workloads=["gups", "silo-tpcc"],       # synth mode (needs T, n)
        machines=["pmem-large", "dram-cxl-pmem"],
        seeds=[0], k=256, T=300, n=2048)
    res.at(policy="arms", workload="gups", machine="dram-cxl-pmem")

Lane layout of a pass: ``((w*P + p)*M + m)*S + s`` -- workloads
outermost (each workload's synthesized row feeds its P*M*S lanes),
machines of different tier depth unified by neutral padding
(``machine_spec.pad_tiers``), seeds innermost.  Policies of different
families (different state structures, ``utils.pytree.treedef``) share a
lane axis through the union fabric (simulator/fabric.py): a mixed-family
panel is ONE pass (``dispatch="auto"`` or ``"union"``), bit for bit the
grouped path (``"grouped"``: one pass a family over the whole W x M x S
product).  A single-family sweep (a tuning grid across machines or
workloads) is exactly one plain pass.  ``mesh`` shards the lanes over
devices, bit for bit the unsharded pass.

Noise pairing: with one seed every lane shares common random numbers
(trace mode: the uniform field of ``sim_seed``; synth mode: the
counter-based ``"crn_prng"`` rows), so comparisons across policies,
workloads and machines are paired.  With several seeds each seed lane
draws its own ``"prng"`` noise from ``PRNGKey(seed)``.
"""
from __future__ import annotations

import collections
import dataclasses

import numpy as np
import torch

from repro_torch.baselines.arms_policy import ARMSSpec
from repro_torch.baselines.hemem import HeMemSpec
from repro_torch.baselines.hybridtier import HybridTierSpec
from repro_torch.baselines.jenga import JengaSpec
from repro_torch.baselines.memtis import MemtisSpec
from repro_torch.baselines.static import AllSlowSpec, OracleSpec
from repro_torch.baselines.tierbpf import TierBPFSpec
from repro_torch.baselines.tpp import TPPSpec
from repro_torch.simulator import fabric, machine_spec, scan_engine
from repro_torch.simulator import machines as machines_mod
from repro_torch.simulator import workload_spec
from repro_torch.simulator.engine import SimResult, oracle_topk_masks
from repro_torch.simulator.sampling import uniform_field
from repro_torch.utils import prng
from repro_torch.utils.device import resolve_device
from repro_torch.utils.pytree import stack_specs, take_lanes, treedef

__all__ = ["sweep", "SweepResult", "policy_spec", "POLICY_REGISTRY"]

POLICY_REGISTRY = {
    "arms": lambda: ARMSSpec.make(),
    "hemem": lambda: HeMemSpec.make(),
    "memtis": lambda: MemtisSpec.make(),
    "tpp": lambda: TPPSpec.make(),
    "all-slow": AllSlowSpec,
    "oracle": OracleSpec,
    # tier-native families (baselines/protocol.py, tier-native contract)
    "hybridtier": lambda: HybridTierSpec.make(),
    "jenga": lambda: JengaSpec.make(),
    "tierbpf": lambda: TierBPFSpec.make(),
}

AXES = ("policy", "workload", "machine", "seed")


def policy_spec(p):
    """Resolve a policy name to its default-knob spec; specs pass through."""
    if isinstance(p, str):
        if p not in POLICY_REGISTRY:
            raise ValueError(f"unknown policy {p!r}; "
                             f"known: {sorted(POLICY_REGISTRY)}")
        return POLICY_REGISTRY[p]()
    return p


@dataclasses.dataclass
class SweepResult:
    """Structured P x W x M x S result grid.

    ``axes`` maps axis name -> labels (in order policy, workload, machine,
    seed); ``grid`` is the flat SimResult list in C order over those axes.
    """

    axes: dict
    grid: list

    @property
    def shape(self) -> tuple:
        return tuple(len(self.axes[a]) for a in AXES)

    def _index(self, axis: str, key) -> int:
        if isinstance(key, str):
            labels = [lb.lower() for lb in self.axes[axis]]
            try:
                return labels.index(key.lower())
            except ValueError:
                raise KeyError(
                    f"{key!r} not on {axis} axis {self.axes[axis]}")
        key = int(key)
        # flat C-order indexing would silently alias a negative or
        # out-of-range index into a neighbouring axis block.
        if not 0 <= key < len(self.axes[axis]):
            raise IndexError(f"{axis} index {key} out of range "
                             f"[0, {len(self.axes[axis])})")
        return key

    def at(self, policy=0, workload=0, machine=0, seed=0) -> SimResult:
        """One cell, addressed by axis label or integer index."""
        p, w, m, s = (self._index(a, v) for a, v in
                      zip(AXES, (policy, workload, machine, seed)))
        P, W, M, S = self.shape
        return self.grid[((p * W + w) * M + m) * S + s]

    def items(self):
        """Yield (coords dict, SimResult) over the full grid."""
        P, W, M, S = self.shape
        for i, res in enumerate(self.grid):
            s = i % S
            m = (i // S) % M
            w = (i // (S * M)) % W
            p = i // (S * M * W)
            yield {a: self.axes[a][j]
                   for a, j in zip(AXES, (p, w, m, s))}, res


def _dedup_labels(labels):
    """Disambiguate duplicate axis labels (``name#i``); the search engine
    keys its grouped results by these labels too."""
    counts = collections.Counter(labels)
    return [f"{nm}#{i}" if counts[nm] > 1 else nm
            for i, nm in enumerate(labels)]


#: lane_stack / TieredMachineSpec placeholder names that carry no identity;
#: hand-built specs keep their given ``name``, these fall back to ``m{i}``.
_ANON_MACHINE_NAMES = ("", "machine", "lanes")


def _machine_labels(machines_in, mach_specs):
    """Axis labels of the machine axis: the preset string the caller
    passed, else the spec's own name, else a positional ``m{i}``."""
    labels = []
    for i, (m_in, sp) in enumerate(zip(machines_in, mach_specs)):
        if isinstance(m_in, str):
            labels.append(m_in)
            continue
        nm = getattr(sp, "name", "") or ""
        labels.append(f"m{i}" if nm in _ANON_MACHINE_NAMES else nm)
    return labels


def _resolve_workloads(workloads, T):
    specs, names = [], []
    for i, w in enumerate(workloads):
        if isinstance(w, str):
            specs.append(workload_spec.named(w, T=T))
            names.append(w)
        else:
            specs.append(w)
            names.append(workload_spec.label_of(w, f"wl{i}"))
    return specs, names


def sweep(policies, *, workloads=None, trace=None, machines="pmem-large",
          seeds=(0,), k: int, T: int | None = None, n: int | None = None,
          sim_seed: int = 0, wl_seed: int = 0, sample_u=None,
          timelines: bool = False, use_interval_kernel: bool = True,
          dispatch: str = "auto", mesh=None, _pad_multiple=None,
          device=None) -> SweepResult:
    """Axis-product sweep: one lane-batched pass (one a family under
    ``dispatch="grouped"``).

    ``policies``: policy names and/or specs (a tuning grid is a list of
    same-family specs).  ``workloads``: workload names / WorkloadSpecs
    (synthesis mode; needs ``T`` and ``n``) -- or a materialized
    ``trace`` [T, n] instead (replay mode; the workload axis is the one
    trace).  ``machines``: registry names / MachineSpecs /
    TieredMachineSpecs of any tier depths.  ``seeds``: one entry keeps
    every lane CRN-paired (noise from ``sim_seed``); several give each
    seed lane its own PRNG noise.

    Per-interval outputs stream by default (``SimResult.mean_*`` and
    ``max_promotions_interval``, output memory O(lanes));
    ``timelines=True`` stacks the [T] ``timeline_*`` series instead.  The
    scalars are the same either way.

    ``dispatch``: ``"auto"`` fuses more than one family into ONE pass
    through the union fabric (simulator/fabric.py) and leaves a
    single-family panel on the plain stacked path; ``"union"`` and
    ``"grouped"`` force either side (grouped: one pass a family, the
    union's bitwise reference).  ``mesh`` shards the lane axis over
    devices: ``None``, ``"auto"`` (every device of ``device``'s kind) or
    a device count; results are bit for bit the unsharded pass's, padded
    lanes dropped before labeling.  ``_pad_multiple`` forces lane padding
    even on a mesh of 1 (tests).  ``use_interval_kernel=False`` pins
    JAX's unfused interval path, which the port does not have: it raises
    ValueError.  ``device``: where the passes run (``None``: the CUDA
    card).
    """
    if not use_interval_kernel:
        raise ValueError(
            "use_interval_kernel=False pins JAX's unfused interval path, "
            "which exists only for JAX's own equivalence tests; the port "
            "has one interval path: the kernels on the card and their "
            "plain versions on the CPU")
    reduce = "stack" if timelines else "stream"
    dev = resolve_device(device)
    policies = [policies] if not isinstance(policies, (list, tuple)) \
        else list(policies)
    pol_specs = [policy_spec(p) for p in policies]
    machines_in = [machines] if not isinstance(machines, (list, tuple)) \
        else list(machines)
    mach_specs = [machines_mod.get(m) for m in machines_in]
    mach_labels = _machine_labels(machines_in, mach_specs)
    seeds = list(seeds)
    P, M, S = len(pol_specs), len(mach_specs), len(seeds)
    if not (P and M and S):
        raise ValueError("every axis needs at least one entry")

    synth = workloads is not None
    if synth:
        if trace is not None:
            raise ValueError("pass either trace or workloads, not both")
        if T is None or n is None:
            raise ValueError("workload-synthesis mode needs T and n")
        if not list(workloads):
            raise ValueError("every axis needs at least one entry")
        T, n = int(T), int(n)
        wl_specs, wl_names = _resolve_workloads(list(workloads), T)
        W = len(wl_specs)
        wl = scan_engine._stack_workloads(wl_specs, dev)
        wl_boost = any(w.has_boost() for w in wl_specs)
    else:
        if trace is None:
            raise ValueError("need a trace or a workloads list")
        trace = np.asarray(trace)
        T, n = trace.shape
        W, wl_names = 1, ["trace"]
        oracle = oracle_topk_masks(trace, k)
    if not 0 < k <= n:
        raise ValueError(f"k={k} must lie in 1..{n}")

    to = lambda a: torch.from_numpy(np.require(a, requirements="CW")).to(dev)
    if sample_u is not None:
        if S > 1:
            # "crn" never reads the per-lane keys: the seed lanes would be
            # silent bitwise copies of each other.
            raise ValueError("sample_u fixes the noise for every lane; "
                             "it cannot be combined with a seeds axis")
        sampling = "crn"
        sample = np.asarray(sample_u, np.float32)
        if sample.shape != (T, n):
            raise ValueError(f"sample_u {sample.shape} != {(T, n)}")
        sample = to(sample)
    elif S == 1:
        # paired comparisons: every lane shares one CRN noise source
        sampling = "crn" if not synth else "crn_prng"
        sample = to(uniform_field(T, n, seed=sim_seed)) if not synth else None
    else:
        sampling, sample = "prng", None

    if dispatch not in ("auto", "union", "grouped"):
        raise ValueError(f"dispatch={dispatch!r}; "
                         "expected auto | union | grouped")
    mach_all, caps_all = machine_spec.lane_stack(mach_specs, n, k, dev)
    # group same-family policies: different state structures cannot stack,
    # unless the union fabric fuses the mixed panel into ONE group.  Key
    # on the treedef (class + meta), not the class: same-family specs with
    # different meta (e.g. migration_limit) have different plan widths.
    n_families = len({treedef(sp) for sp in pol_specs})
    use_union = dispatch == "union" or (dispatch == "auto"
                                        and n_families > 1)
    if use_union:
        lane_specs = fabric.build_union(pol_specs, n, k, mach_all)
        groups = {"union": list(range(P))}
    else:
        lane_specs = pol_specs
        groups = {}
        for i, sp in enumerate(pol_specs):
            groups.setdefault(treedef(sp), []).append(i)
    if not synth:
        trace_d = to(np.asarray(trace, np.float32))
        oracle_d = to(oracle)

    grid = [None] * (P * W * M * S)
    for idxs in groups.values():
        Pg = len(idxs)
        L = W * Pg * M * S
        lane = np.arange(L)
        p_local = (lane // (M * S)) % Pg
        m_of = (lane // S) % M
        s_of = lane % S
        lidx = lambda a: torch.from_numpy(a.astype(np.int64)).to(dev)
        spec_l = take_lanes(
            stack_specs([lane_specs[i] for i in idxs]).to(dev),
            lidx(p_local))
        mach_l = take_lanes(mach_all, lidx(m_of))
        caps_l = caps_all.index_select(0, lidx(m_of))
        keys = torch.stack([prng.PRNGKey(int(seeds[s]), dev) for s in s_of]) \
            if sampling == "prng" else None
        min_period = min(lane_specs[i].min_sampling_period() for i in idxs)
        if synth:
            out, finfo = fabric.sim_synth(
                spec_l, wl, k, mach_l, caps_l, keys, sample,
                prng.PRNGKey(sim_seed, dev), prng.PRNGKey(wl_seed, dev),
                sampling, scan_engine._synth_need_normal(wl_specs,
                                                         min_period),
                Pg * M * S, n, T, wl_boost=wl_boost, reduce=reduce,
                mesh=mesh, pad_multiple=_pad_multiple)
        else:
            out, finfo = fabric.sim_trace(
                spec_l, trace_d, oracle_d, k, mach_l, caps_l, keys, sample,
                sampling, scan_engine._need_normal(trace, min_period),
                reduce=reduce, mesh=mesh, pad_multiple=_pad_multiple)
        scan_engine._record_dispatch(
            lanes=L, sampling=sampling, policy=lane_specs[idxs[0]].name,
            synth=synth, workloads=W, configs=Pg, machines=M, seeds=S, T=T,
            axis_product=True, interval_kernel=True, reduce=reduce,
            dispatch="union" if use_union else "grouped",
            families=n_families if use_union else 1, device=str(dev),
            **finfo)
        for l in range(L):
            w = l // (Pg * M * S)
            p = idxs[p_local[l]]
            m, s = m_of[l], s_of[l]
            name = f"{pol_specs[p].name}@{wl_names[w]}[{mach_labels[m]}]"
            if S > 1:
                name += f"[seed={seeds[s]}]"
            grid[((p * W + w) * M + m) * S + s] = scan_engine._to_result(
                out, l, name)

    axes = dict(policy=_dedup_labels([sp.name for sp in pol_specs]),
                workload=_dedup_labels(wl_names),
                machine=_dedup_labels(mach_labels),
                seed=[str(s) for s in seeds])
    return SweepResult(axes=axes, grid=grid)
