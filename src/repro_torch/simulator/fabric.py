"""Sweep fabric: fuse a mixed-family policy panel into one engine pass,
and shard the lane axis over devices.

The port of ``repro/simulator/fabric.py``.  ``experiment.sweep`` flattens
its P x W x M x S product into the lanes of ``scan_engine._simulate``;
this module removes its two ceilings.

* **Union dispatch** (``build_union`` / ``UnionSpec``): policies of
  different families have different state structures, so a grouped sweep
  runs one pass a family.  ``UnionSpec`` is one spec whose state is a
  tuple of SLOT tensors, the union of the member families' state leaves
  bucketed by (shape, dtype) with per-bucket multiplicity the max over
  members (so the union's state is the largest member's, not the sum),
  and whose per-lane ``fam`` index names each lane's member.  JAX's
  ``lax.switch`` runs every branch on every lane and selects; here each
  member runs on its own lanes only: its lanes are gathered from the
  slots, the member's method runs on them, and what it changed is
  scattered back.  The member's lanes are fixed for the whole run, so
  their index is built once on the host.  A member's batch is then
  exactly the batch of its grouped pass, in the same order, so every
  member computes the grouped path's bits.  Every lane takes the
  tier-targeted route; binary members go through the protocol's shim,
  bit for bit the hop-chain route.  Oracle lanes observe true counts and
  TPP lanes carry their overhead through the engine's
  ``mixed_observation`` hooks, and ``fire_flags`` reads one flag a member
  in the interval's one host copy, so a member with no firing lane skips
  its policy pass.

* **Lane sharding** (``sim_trace`` / ``sim_synth`` with ``mesh``): the
  lanes are padded to a multiple of the mesh size D (padded lanes
  replicate lane 0 and are dropped before labeling) and cut into D
  blocks, each one ``_simulate`` on its own device (``cuda:i``; every
  block on the CPU when the lanes are there) from one host thread a
  device.  Specs, machines, capacities and PRNG keys are sharded; the
  trace, the CRN field and the workload stack are replicated to every
  shard, and each shard has its own fire gate.  Nothing a lane computes
  depends on its shard: its PRNG key is data, a skipped policy pass is a
  no-op for lanes that do not fire, and synthesized lanes gather their
  row by GLOBAL workload index (``widx``), the values of the unsharded
  repeat.  ``resolve_mesh`` reads the device count through
  ``device_count``.

``experiment.sweep(dispatch=..., mesh=...)`` is the public face; the
entry points here share the scan engine's underscore-helper contract
(change signatures in lockstep).
"""
from __future__ import annotations

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import torch

from repro_torch.baselines.protocol import SENTINEL, PolicySpec
from repro_torch.simulator import scan_engine
from repro_torch.utils.pytree import (from_treedef, lane_specs, leaves,
                                      take_lanes, tensor_dataclass, treedef)

__all__ = ["UnionSpec", "UnionMember", "build_union", "resolve_mesh",
           "device_count", "sim_trace", "sim_synth"]


# ------------------------------------------------------------ union spec
@dataclasses.dataclass(frozen=True)
class UnionMember:
    """Static identity of one member family inside a ``UnionSpec``.

    Keyed by the member's spec TREEDEF (class + meta), not just its
    class: two HeMemSpecs with different ``migration_limit`` meta have
    different plan widths and get separate members."""

    name: str
    spec_treedef: object      #: ``utils.pytree.treedef`` of the member spec
    state_treedef: object     #: ... and of its state
    slot_ids: tuple           #: state leaf i lives in union slot slot_ids[i]
    pad_mv: int               #: the member's own pad_moves(n, k)


class _Lanes:
    """The lanes of one member: i64 [B_f] ``idx`` on the device, and
    whether they are every lane (then gathers and scatters are the
    identity)."""

    def __init__(self, idx, B: int):
        self.idx, self.all = idx, idx.numel() == B

    def take(self, x):
        return x if self.all else x.index_select(0, self.idx)


@tensor_dataclass(meta=("members", "slot_defs", "pad_mv", "min_period"))
class UnionSpec(PolicySpec):
    """One spec whose lanes may each be a DIFFERENT policy family.

    Data leaves (lane-batched):
      * ``fam``        — i32 member index of the lane;
      * ``knobs[f]``   — member f's spec (lanes of other members carry the
        member's panel-representative knobs, never read);
      * ``wants_true`` — bool, the lane observes true counts (oracle);
      * ``slow_extra`` — f32 ns a slow access (TPP; 0.0 elsewhere, a
        bitwise no-op in the engine's wall term).

    State is a tuple of slot tensors ([B] + shape, ``slot_defs``); a
    member's state packs into and unpacks out of its ``slot_ids`` on its
    own lanes; other lanes and untouched slots pass through.
    """

    fam: torch.Tensor
    knobs: tuple
    wants_true: torch.Tensor
    slow_extra: torch.Tensor
    members: tuple = ()
    slot_defs: tuple = ()     #: ((shape, dtype-name), ...) a union slot
    pad_mv: int = 1
    min_period: float = PolicySpec.DEFAULT_SAMPLE_PERIOD

    name = "union"
    tier_native = True        # every lane takes the tier-targeted route
    mixed_observation = True  # per-lane wants_true / slow_extra hooks

    # --- member plumbing -------------------------------------------------
    def _cache(self) -> dict:
        """Per-instance host cache (not a dataclass field): the members'
        lanes, their gathered specs, gathered slots and fire flags."""
        c = self.__dict__.get("_run")
        if c is None:
            c = {}
            object.__setattr__(self, "_run", c)
        return c

    def _lanes(self) -> list:
        """[(f, _Lanes, member spec on its lanes)] for every member with a
        lane, from ``fam`` read once to the host."""
        c = self._cache()
        if "lanes" not in c:
            fam = self.fam.cpu()
            B = fam.shape[0]
            c["lanes"] = []
            for f in range(len(self.members)):
                idx = torch.nonzero(fam == f).flatten()
                if idx.numel():
                    ln = _Lanes(idx.to(self.fam.device), B)
                    c["lanes"].append(
                        (f, ln, take_lanes(self.knobs[f], ln.idx)))
            c["gathered"] = {f: {} for f in range(len(self.members))}
            c["fam"] = self.fam.long()
        return c["lanes"]

    def _unpack(self, f: int, lanes, slots):
        """Member f's state on its lanes.  A slot gathered before and not
        replaced since is reused."""
        got = self._cache()["gathered"][f]
        out = []
        for i in self.members[f].slot_ids:
            src, val = got.get(i, (None, None))
            if src is not slots[i]:
                val = lanes.take(slots[i])
                got[i] = (slots[i], val)
            out.append(val)
        return from_treedef(self.members[f].state_treedef, out)

    def _pack(self, slots, updates):
        """Scatter member states into the slots: ``updates`` a list of
        (f, lanes, old state, new state).  A slot leaf a member left
        untouched (the same tensor) is not written; each written slot is
        copied once.  Dtypes must be the slot's (the layout buckets by
        them), so nothing is cast."""
        out = list(slots)
        copied = set()
        for f, lanes, old, new in updates:
            for i, a, b in zip(self.members[f].slot_ids, leaves(old),
                               leaves(new)):
                if a is b:
                    continue
                if b.dtype != out[i].dtype:
                    raise TypeError(f"{self.members[f].name}: state leaf "
                                    f"{b.dtype} into a {out[i].dtype} slot")
                if lanes.all:
                    out[i] = b
                else:
                    if i not in copied:
                        out[i] = out[i].clone()
                        copied.add(i)
                    out[i].index_copy_(0, lanes.idx, b)
        # the gathered slots stay valid: a member's lanes of a new slot
        # hold what it wrote there, or what they held before
        gathered = self._cache()["gathered"]
        for f, lanes, old, new in updates:
            for i, b in zip(self.members[f].slot_ids, leaves(new)):
                gathered[f][i] = (out[i], b)
        return tuple(out)

    def _per_lane(self, state, method, dtype):
        """[B] tensor of a per-lane member method (``fires``,
        ``sampling_period``, ``mode_of``), each member on its lanes."""
        out = torch.empty((self.fam.shape[0],), dtype=dtype,
                          device=self.fam.device)
        for f, lanes, sp in self._lanes():
            v = getattr(sp, method)(self._unpack(f, lanes, state)).to(dtype)
            if lanes.all:
                return v
            out.index_copy_(0, lanes.idx, v)
        return out

    # --- shape contract --------------------------------------------------
    def pad_promote(self, n: int, k: int) -> int:
        return self.pad_mv

    pad_demote = pad_promote

    def pad_moves(self, n: int, k: int) -> int:
        return self.pad_mv

    def min_sampling_period(self) -> float:
        return float(self.min_period)

    # --- per-lane hooks (scan_engine ``mixed_observation`` route) --------
    def wants_true_lane(self, B: int, device):
        return self.wants_true

    def slow_extra_lane(self, B: int, device):
        return self.slow_extra

    def fire_flags(self, do):
        """One flag a member: does any of its lanes fire?  Read to the
        host in one copy; ``tier_policy`` runs the flagged members."""
        self._lanes()
        hits = torch.zeros((len(self.members),), dtype=torch.int32,
                           device=do.device)
        hits.index_add_(0, self._cache()["fam"], do.to(torch.int32))
        flags = (hits > 0).cpu()
        self._cache()["firing"] = flags
        return flags

    # --- behaviour: each member on its own lanes -------------------------
    def init(self, n_pages, k, machine):
        B = self.fam.shape[0]
        dev = self.fam.device
        slots = tuple(torch.zeros((B,) + tuple(shape),
                                  dtype=getattr(torch, dtype), device=dev)
                      for shape, dtype in self.slot_defs)
        updates = []
        for f, lanes, sp in self._lanes():
            zeros = from_treedef(self.members[f].state_treedef,
                                 [lanes.take(slots[i])
                                  for i in self.members[f].slot_ids])
            updates.append((f, lanes, zeros, sp.init(
                n_pages, k, take_lanes(machine, lanes.idx))))
        return self._pack(slots, updates)

    def observe(self, state, observed):
        updates = []
        for f, lanes, sp in self._lanes():
            st = self._unpack(f, lanes, state)
            updates.append((f, lanes, st,
                            sp.observe(st, lanes.take(observed))))
        return self._pack(state, updates)

    def fires(self, state):
        return self._per_lane(state, "fires", torch.bool)

    def fire_period(self):
        return None     # each member's lanes keep their own cadence

    def sampling_period(self, state):
        return self._per_lane(state, "sampling_period", torch.float32)

    def mode_of(self, state):
        return self._per_lane(state, "mode_of", torch.int32)

    def tier_policy(self, state, tier_util, slow_bw, app_bw, k: int, caps):
        """Each member whose lanes fire (``fire_flags``; every member
        without it) runs its ``tier_policy`` on its lanes; the plans are
        widened to ``pad_mv`` by APPENDING blank entries, trailing no-ops
        of ``apply_targeted_migrations``."""
        B = self.fam.shape[0]
        dev = self.fam.device
        firing = self._cache().get("firing")
        pages = torch.full((B, self.pad_mv), SENTINEL, dtype=torch.int32,
                           device=dev)
        dst = torch.zeros((B, self.pad_mv), dtype=torch.int32, device=dev)
        updates = []
        for f, lanes, sp in self._lanes():
            if firing is not None and not bool(firing[f]):
                continue
            st = self._unpack(f, lanes, state)
            st2, p, d = sp.tier_policy(
                st, lanes.take(tier_util), lanes.take(slow_bw),
                lanes.take(app_bw), k, lanes.take(caps))
            w = p.shape[1]
            if lanes.all:
                pages[:, :w] = p
                dst[:, :w] = d
            else:
                pages[:, :w].index_copy_(0, lanes.idx, p.to(torch.int32))
                dst[:, :w].index_copy_(0, lanes.idx, d.to(torch.int32))
            updates.append((f, lanes, st, st2))
        return self._pack(state, updates), pages, dst


def build_union(pol_specs, n: int, k: int, mach_all):
    """Union-ize a mixed-family policy panel.

    ``pol_specs`` are the panel's (unstacked) PolicySpecs; ``mach_all`` a
    lane-stacked machine ([M, ...] leaves) whose first lane templates the
    state layouts (all lanes share one padded tier depth,
    ``machine_spec.lane_stack``).  Returns one ``UnionSpec`` a policy
    (stackable: identical meta), ready for ``stack_specs`` +
    ``take_lanes``.

    Slot layout, as JAX's: member state leaves are bucketed by (shape,
    dtype); the union carries max-over-members slots a bucket, in
    (dtype, shape) order.  The layouts come from one ``init`` of each
    member on one lane (JAX: ``jax.eval_shape``), the lane axis dropped.
    """
    mach1 = take_lanes(mach_all, torch.zeros((1,), dtype=torch.long,
                                             device=mach_all.lat_ns.device))
    fam_of, reps, keys = [], [], {}
    for sp in pol_specs:
        key = treedef(sp)
        if key not in keys:
            keys[key] = len(reps)
            reps.append(sp)
        fam_of.append(keys[key])

    slot_req: dict = {}
    fam_layouts = []
    for rep in reps:
        st = lane_specs(rep, 1).to(mach1.lat_ns.device).init(n, k, mach1)
        buckets: dict = {}
        fam_slots = []
        for leaf in leaves(st):
            bk = (tuple(leaf.shape[1:]),
                  str(leaf.dtype).removeprefix("torch."))
            i = buckets.get(bk, 0)
            buckets[bk] = i + 1
            fam_slots.append((bk, i))
        for bk, cnt in buckets.items():
            slot_req[bk] = max(slot_req.get(bk, 0), cnt)
        fam_layouts.append((treedef(st), fam_slots))

    # deterministic global slot order: buckets sorted by (dtype, shape)
    slot_defs, base = [], {}
    for bk in sorted(slot_req, key=lambda b: (b[1], b[0])):
        base[bk] = len(slot_defs)
        slot_defs.extend([bk] * slot_req[bk])
    slot_defs = tuple(slot_defs)

    members = tuple(
        UnionMember(name=rep.name, spec_treedef=treedef(rep),
                    state_treedef=td,
                    slot_ids=tuple(base[bk] + i for bk, i in fam_slots),
                    pad_mv=int(rep.pad_moves(n, k)))
        for rep, (td, fam_slots) in zip(reps, fam_layouts))
    pad_mv = max(m.pad_mv for m in members)
    min_period = min(sp.min_sampling_period() for sp in pol_specs)
    return [UnionSpec(
        fam=torch.tensor(f, dtype=torch.int32),
        knobs=tuple(sp if g == f else reps[g] for g in range(len(reps))),
        wants_true=torch.tensor(bool(type(sp).wants_true_counts)),
        slow_extra=torch.tensor(type(sp).slow_access_extra_ns,
                                dtype=torch.float32),
        members=members, slot_defs=slot_defs, pad_mv=int(pad_mv),
        min_period=float(min_period))
        for sp, f in zip(pol_specs, fam_of)]


# --------------------------------------------------------- lane sharding
def device_count(device=None) -> int:
    """Devices a mesh may span for lanes on ``device`` (``None``: the
    card): the CUDA device count, or 1 for the CPU."""
    if device is not None and torch.device(device).type == "cpu":
        return 1
    return torch.cuda.device_count()


def resolve_mesh(mesh, device=None) -> int | None:
    """``mesh`` -> shard count D, or None for the plain path.

    ``None`` never shards; ``"auto"`` shards over every device of
    ``device``'s kind (the plain path with one); an int forces that many
    (1 is allowed: the forced-mesh equivalence tests)."""
    if mesh is None:
        return None
    count = device_count(device)
    if mesh == "auto":
        return count if count > 1 else None
    d = int(mesh)
    if not 1 <= d <= count:
        raise ValueError(f"mesh={d} but only {count} device(s) are "
                         "available")
    return d


def _plan_padding(B: int, D: int, pad_multiple) -> int:
    mult = D * int(pad_multiple or 1)
    return ((B + mult - 1) // mult) * mult


def _pad_idx(B: int, Lp: int, device):
    """Lane gather widening [B] -> [Lp], padded lanes replicating lane 0
    (cheap, and every padded lane stays a valid simulation)."""
    return torch.cat([torch.arange(B, device=device),
                      torch.zeros((Lp - B,), dtype=torch.long,
                                  device=device)])


def _shard_device(base, i: int):
    return torch.device("cuda", i) if base.type == "cuda" else base


def _run_shards(D: int, Lp: int, base, run):
    """``run(dev, lo, hi)`` for each of D lane blocks of ``Lp / D``, one
    host thread a shard (its device current there), outputs joined along
    the lane axis."""
    per = Lp // D

    def shard(i):
        dev = _shard_device(base, i)
        if dev.type == "cuda":
            with torch.cuda.device(dev):
                return run(dev, i * per, (i + 1) * per)
        return run(dev, i * per, (i + 1) * per)

    if D == 1:
        outs = [shard(0)]
    else:
        with ThreadPoolExecutor(D) as pool:
            outs = list(pool.map(shard, range(D)))
    return {key: torch.cat([o[key] for o in outs]) for key in outs[0]}


def _unpad_out(out: dict, B: int) -> dict:
    """Drop padded lanes from a raw engine output dict (every value
    lane-leading, ``timeline_*`` [B, T])."""
    return {key: v[:B] for key, v in out.items()}


def _shard_inputs(spec, mach, caps, keys, B: int, Lp: int):
    idx = _pad_idx(B, Lp, caps.device)
    return (take_lanes(spec, idx), take_lanes(mach, idx),
            caps.index_select(0, idx),
            None if keys is None else keys.index_select(0, idx))


def sim_trace(spec, trace, oracle_mask, k, mach, caps, keys, sample,
              sampling, need_normal, reduce="stack", mesh=None,
              pad_multiple=None):
    """Trace-mode pass, optionally sharded.  ``trace`` f32 [T, n] and
    ``oracle_mask`` bool [T, n] on the lanes' device; ``keys`` [B, 2] the
    per-lane PRNG keys (``"prng"``), ``sample`` the [T, n] CRN field
    (``"crn"``).  -> (out, info): the raw engine output dict with padded
    lanes dropped, and the dispatch info (``{}`` on the plain path)."""
    D = resolve_mesh(mesh, caps.device)
    B = caps.shape[0]
    if D is None and not pad_multiple:
        out = scan_engine._simulate(
            spec, scan_engine._TraceRows(trace, oracle_mask, B), k, mach,
            caps, keys if sampling == "prng" else sample, sampling,
            need_normal, reduce=reduce)
        return out, {}
    D = D or 1
    Lp = _plan_padding(B, D, pad_multiple)
    spec, mach, caps, keys = _shard_inputs(spec, mach, caps, keys, B, Lp)

    def run(dev, lo, hi):
        cut = lambda x: x[lo:hi].to(dev)
        noise = (cut(keys) if sampling == "prng" else sample.to(dev))
        return scan_engine._simulate(
            take_lanes(spec, torch.arange(lo, hi, device=caps.device))
            .to(dev), scan_engine._TraceRows(trace.to(dev),
                                             oracle_mask.to(dev), hi - lo),
            k, take_lanes(mach, torch.arange(lo, hi, device=caps.device))
            .to(dev), cut(caps), noise, sampling, need_normal,
            reduce=reduce)

    out = _run_shards(D, Lp, caps.device, run)
    return _unpad_out(out, B), dict(mesh=D, padded_lanes=Lp)


def sim_synth(spec, wl, k, mach, caps, keys, sample, noise_key, wl_key,
              sampling, need_normal, wl_rep, n, T, wl_boost=True,
              reduce="stack", mesh=None, pad_multiple=None):
    """Synth-mode pass, optionally sharded (see ``sim_trace``): the
    [W]-lane workload stack ``wl`` is synthesized each interval from
    ``wl_key`` and workload ``w`` feeds lanes ``w * wl_rep .. w * wl_rep +
    wl_rep - 1``.  The noise is the per-lane ``keys`` [B, 2] (``"prng"``),
    one row an interval from ``noise_key`` shared by every lane
    (``"crn_prng"``) or the [T, n] field ``sample`` (``"crn"``).  Sharded,
    every shard synthesizes the whole stack and gathers its lanes' rows
    by global workload index."""
    D = resolve_mesh(mesh, caps.device)
    B = caps.shape[0]
    if D is None and not pad_multiple:
        source = scan_engine._SynthRows(wl, T, n, k, wl_key, wl_boost, wl_rep)
        noise = {"prng": keys, "crn_prng": noise_key}.get(sampling, sample)
        out = scan_engine._simulate(spec, source, k, mach, caps, noise,
                                    sampling, need_normal, reduce=reduce)
        return out, {}
    D = D or 1
    Lp = _plan_padding(B, D, pad_multiple)
    widx = torch.cat([torch.arange(B, device=caps.device) // wl_rep,
                      torch.zeros((Lp - B,), dtype=torch.long,
                                  device=caps.device)])
    spec, mach, caps, keys = _shard_inputs(spec, mach, caps, keys, B, Lp)

    def run(dev, lo, hi):
        cut = lambda x: x[lo:hi].to(dev)
        lanes = torch.arange(lo, hi, device=caps.device)
        noise = {"prng": keys[lo:hi] if keys is not None else None,
                 "crn_prng": noise_key}.get(sampling, sample)
        source = scan_engine._SynthRows(wl.to(dev), T, n, k, wl_key.to(dev),
                                        wl_boost, wl_rep, widx=cut(widx))
        return scan_engine._simulate(
            take_lanes(spec, lanes).to(dev), source, k,
            take_lanes(mach, lanes).to(dev), cut(caps), noise.to(dev),
            sampling, need_normal, reduce=reduce)

    out = _run_shards(D, Lp, caps.device, run)
    return _unpad_out(out, B), dict(mesh=D, padded_lanes=Lp)
