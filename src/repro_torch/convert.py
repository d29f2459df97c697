"""State carried across from the JAX package into the port's dataclasses.

Each function takes the JAX package's object with its leaves as numpy
arrays (``jax.tree_util.tree_map(np.asarray, obj)``) and returns the
port's tensor dataclass (or, for ``model_params``, its parameter dict):
the simulator's policy specs, policy state and machines (ARMS and the
eight baseline families), its workload specs and workload state, the
model weights, the serving layer's ``TieredPool`` (any policy family),
``PagedKV``, ``ExpertTier`` and ``EmbedTier``, and the optimizer's
``AdamWState``.  ``pool_leaves`` and ``expert_leaves`` carry the serving
state back to the JAX package's layout as numpy arrays.  Fields are read
by name, so nothing of the JAX package is imported here.  A per-lane
object (the JAX package's layout outside ``vmap``) gains a lane axis of
1; a lane-batched one keeps its lanes.
Like every entry point of the port, each function puts its tensors on
the CUDA card unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.baselines.arms_policy import ARMSRunState, ARMSSpec
from repro_torch.core.state import ARMSConfig, PHTState, TieringState
from repro_torch.simulator.machine_spec import TieredMachineSpec
from repro_torch.utils.device import resolve_device
from repro_torch.utils.pytree import tree_map


def _tensor(x, lanes: bool, device):
    t = torch.from_numpy(np.array(x))
    return (t if lanes else t.unsqueeze(0)).to(device)


def _fields(cls, obj, lanes: bool, device, **nested):
    return cls(**{f.name: nested[f.name] if f.name in nested
                  else _tensor(getattr(obj, f.name), lanes, device)
                  for f in dataclasses.fields(cls)})


def arms_config(cfg) -> ARMSConfig:
    """The JAX ``ARMSConfig`` (same field names) as the port's."""
    return ARMSConfig(**{f.name: getattr(cfg, f.name)
                         for f in dataclasses.fields(ARMSConfig)})


def arms_spec(spec, device=None) -> ARMSSpec:
    """``ARMSSpec`` (``cfg_vals``, ``cfg_names``, ``base_cfg``); a
    lane-batched spec keeps its ``[B, m]`` values."""
    return ARMSSpec(cfg_vals=torch.from_numpy(
                        np.array(spec.cfg_vals, np.float32)).to(
                            resolve_device(device)),
                    cfg_names=tuple(spec.cfg_names),
                    base_cfg=arms_config(spec.base_cfg))


def pht_state(obj, lanes: bool = False, device=None) -> PHTState:
    return _fields(PHTState, obj, lanes, resolve_device(device))


def tiering_state(obj, device=None) -> TieringState:
    device = resolve_device(device)
    lanes = np.ndim(obj.ewma_s) == 2
    return _fields(TieringState, obj, lanes, device,
                   pht=pht_state(obj.pht, lanes, device))


def arms_run_state(obj, device=None) -> ARMSRunState:
    device = resolve_device(device)
    inner = tiering_state(obj.inner, device)
    lanes = np.ndim(obj.inner.ewma_s) == 2
    return _fields(ARMSRunState, obj, lanes, device, inner=inner)


def _families() -> dict:
    """family name -> (the port's spec class, its state class)."""
    from repro_torch.baselines import (hemem, hybridtier, jenga, memtis,
                                       static, tierbpf, tpp)
    return {
        "all-slow": (static.AllSlowSpec, static.StaticState),
        "oracle": (static.OracleSpec, static.OracleState),
        "hemem": (hemem.HeMemSpec, hemem.HeMemState),
        "memtis": (memtis.MemtisSpec, memtis.MemtisState),
        "tpp": (tpp.TPPSpec, tpp.TPPState),
        "hybridtier": (hybridtier.HybridTierSpec, hybridtier.HybridTierState),
        "jenga": (jenga.JengaSpec, jenga.JengaState),
        "tierbpf": (tierbpf.TierBPFSpec, tierbpf.TierBPFState),
    }


def policy_spec(spec, device=None):
    """A JAX baseline spec (any family but ARMS, picked by ``spec.name``)
    as the port's: knob leaves as they are (0-d for one spec, [B] for a
    lane stack), meta fields (``migration_limit``, ``bs_max``) copied."""
    device = resolve_device(device)
    cls = _families()[spec.name][0]
    meta = cls._meta_fields
    return cls(**{f.name: getattr(spec, f.name) if f.name in meta
                  else torch.from_numpy(np.array(getattr(spec, f.name)))
                  .to(device)
                  for f in dataclasses.fields(cls)})


def policy_state(obj, family: str, device=None):
    """A JAX baseline family's policy state as the port's: a per-lane
    state (scalar ``t``) gains a lane axis of 1, a lane-batched one keeps
    its lanes."""
    device = resolve_device(device)
    cls = _families()[family][1]
    return _fields(cls, obj, np.ndim(obj.t) == 1, device)


def machine(obj, device=None) -> TieredMachineSpec:
    """A ``TieredMachineSpec`` as f32 tensor leaves ([R] -> [1, R])."""
    device = resolve_device(device)
    lanes = np.ndim(obj.lat_ns) == 2
    leaves = {f.name: _tensor(np.asarray(getattr(obj, f.name), np.float32),
                              lanes, device)
              for f in dataclasses.fields(TieredMachineSpec)
              if f.name != "name"}
    return TieredMachineSpec(**leaves, name=obj.name)


def workload_spec(spec, device=None):
    """A JAX ``WorkloadSpec`` (``[S]`` leaves, or ``[W, S]`` for a lane
    stack) as the port's, its display label kept."""
    from repro_torch.simulator import workload_spec as ws
    device = resolve_device(device)
    out = ws.WorkloadSpec(**{
        f.name: torch.from_numpy(np.array(getattr(spec, f.name))).to(device)
        for f in dataclasses.fields(ws.WorkloadSpec)})
    if hasattr(spec, "_label"):
        ws.with_label(out, spec._label)
    return out


def workload_state(state, device=None):
    """A JAX ``WorkloadState``: i32 ranks as they are, the uint32
    ``base_key`` words as int64 (the port's key layout)."""
    from repro_torch.simulator.workload_spec import WorkloadState
    device = resolve_device(device)
    t = lambda x, dt: torch.from_numpy(np.asarray(x).astype(dt)).to(device)
    return WorkloadState(rank=t(state.rank, np.int32),
                         rank2=t(state.rank2, np.int32),
                         base_key=t(state.base_key, np.int64))


# ---------------------------------------------------------------- serving
def model_params(params_np, cfg, device=None):
    """The JAX parameter tree of ``cfg``'s model (nested dicts, numpy
    leaves; bf16 leaves as ``ml_dtypes.bfloat16``) as the port's params.
    The trees have the same keys and leaf shapes (``models/model.py``),
    and each leaf keeps its own dtype: a bf16 model's Mamba2 layers hold
    ``A_log``, ``D`` and ``dt_bias`` in f32 (``models/mamba2.py``)."""
    device = resolve_device(device)

    def leaf(x):
        if isinstance(x, dict):
            return {k: leaf(v) for k, v in x.items()}
        name = np.asarray(x).dtype.name
        if name not in ("bfloat16", "float32"):
            raise TypeError(f"model_params: a {cfg.name} leaf is {name}, "
                            f"expected bfloat16 or float32")
        dtype = torch.bfloat16 if name == "bfloat16" else torch.float32
        return torch.from_numpy(np.array(x, np.float32)).to(device, dtype)

    return leaf(params_np)


def decode_cache(cache_np, device=None):
    """A JAX model's decode cache (``init_cache``'s tree, numpy leaves) as
    the port's: every family's layout is the JAX package's, so each
    ``KVCache`` (``k``, ``v``), ``MLACache`` (``c_kv``, ``k_rope``) and
    ``MambaCache`` (``conv``, ``ssm``) is rebuilt by field name, and dicts
    (the MoE, MLA, enc-dec and hybrid caches) keep their keys.  Leaves
    keep their dtype."""
    from repro_torch.models.attention import KVCache, MLACache
    from repro_torch.models.mamba2 import MambaCache
    device = resolve_device(device)

    def leaf(x):
        x = np.asarray(x)
        if x.dtype.name == "bfloat16":
            return torch.from_numpy(x.astype(np.float32)).to(
                device, torch.bfloat16)
        return torch.from_numpy(np.array(x)).to(device)

    def build(c):
        if isinstance(c, dict):
            return {k: build(v) for k, v in c.items()}
        for cls in (KVCache, MLACache, MambaCache):
            names = [f.name for f in dataclasses.fields(cls)]
            if all(hasattr(c, nm) for nm in names):
                return cls(**{nm: leaf(getattr(c, nm)) for nm in names})
        raise TypeError(f"decode_cache: unknown cache node {type(c)}")

    return build(cache_np)


def adamw_state(state_np, params, device=None):
    """A JAX ``AdamWState`` (``step``, and ``m``/``v``/``master`` trees
    shaped like the params; ``master`` ``{}`` without a master copy) as
    the port's, so that a JAX run continues in the port: step i32, the
    moments and the master in f32."""
    from repro_torch.optim.adamw import AdamWState
    from repro_torch.utils.pytree import flatten_with_path
    device = resolve_device(device)
    shapes = {path: tuple(p.shape) for path, p in flatten_with_path(params)}

    def f32_tree(tree):
        if isinstance(tree, dict):
            return {k: f32_tree(v) for k, v in tree.items()}
        return torch.from_numpy(np.array(tree, np.float32)).to(device)

    out = {nm: f32_tree(getattr(state_np, nm)) for nm in ("m", "v", "master")}
    for nm, tree in out.items():
        got = {path: tuple(t.shape) for path, t in flatten_with_path(tree)}
        if got and got != shapes:
            raise ValueError(f"adamw_state: {nm} does not match the params")
    return AdamWState(
        step=torch.tensor(int(np.asarray(state_np.step)), dtype=torch.int32,
                          device=device), **out)


def tiered_pool(pool, device=None):
    """A JAX ``TieredPool`` of any policy family as the port's: the spec
    and its state with one lane, the host count ``t`` from the pool's
    ``t``, the fire period from the spec."""
    from repro_torch.baselines.arms_policy import ARMSServeSpec
    from repro_torch.tiering.tiered_pool import TieredPool
    from repro_torch.utils.pytree import lane_specs
    device = resolve_device(device)
    jspec = pool.spec
    if jspec.name != "arms":
        spec = policy_spec(jspec, device)
        state = policy_state(pool.state, jspec.name, device)
    else:
        if hasattr(jspec, "pool_every"):
            spec = ARMSServeSpec(
                cfg_vals=torch.from_numpy(np.array(jspec.cfg_vals,
                                                   np.float32)).to(device),
                cfg_names=tuple(jspec.cfg_names),
                base_cfg=arms_config(jspec.base_cfg),
                pool_every=int(jspec.pool_every))
        else:
            spec = arms_spec(jspec, device)
        state = arms_run_state(pool.state, device)
    spec = lane_specs(spec, 1)
    return _fields(TieredPool, pool, True, device, spec=spec, state=state,
                   mach=tree_map(lambda x: x[0], machine(pool.mach, device)),
                   t=int(np.asarray(pool.t)), period=spec.fire_period())


#: the residency and telemetry leaves of a ``TieredPool``, by name
POOL_LEAVES = ("in_fast", "slot", "counts", "read_fast", "read_slow",
               "promoted_at", "demoted_at", "promos", "demos", "waste",
               "wall_s", "wall_flat_s")


def pool_leaves(pool) -> dict:
    """The port's ``TieredPool`` back in the JAX package's layout: its
    residency and telemetry leaves (``POOL_LEAVES``) and ``t`` as numpy
    arrays, keyed by the JAX field names."""
    out = {nm: getattr(pool, nm).cpu().numpy() for nm in POOL_LEAVES}
    out["t"] = np.int32(pool.t)
    return out


def paged_kv(kv, device=None):
    """A JAX ``PagedKV`` as the port's: each of K and V one tensor, the
    fast pool's rows first, then the slow pool's."""
    from repro_torch.tiering.paged_kv import PagedKV
    device = resolve_device(device)
    cat = lambda f, s: torch.from_numpy(
        np.concatenate([np.asarray(f), np.asarray(s)])).to(device)
    return PagedKV(k=cat(kv.k_fast, kv.k_slow), v=cat(kv.v_fast, kv.v_slow),
                   pool=tiered_pool(kv.pool, device))


def expert_tier(t, device=None):
    """A JAX ``ExpertTier`` as the port's: each of ``wi`` and ``wo`` one
    tensor, the fast slots first, then the home rows."""
    from repro_torch.tiering.expert_tiering import ExpertTier
    device = resolve_device(device)
    cat = lambda f, s: torch.from_numpy(
        np.concatenate([np.asarray(f), np.asarray(s)])).to(device)
    return ExpertTier(wi=cat(t.wi_fast, t.wi_slow),
                      wo=cat(t.wo_fast, t.wo_slow),
                      pool=tiered_pool(t.pool, device))


def expert_leaves(t) -> dict:
    """The port's ``ExpertTier`` pools back in the JAX package's layout:
    ``wi_fast``, ``wi_slow``, ``wo_fast``, ``wo_slow`` as numpy arrays."""
    return {nm: getattr(t, nm).cpu().numpy()
            for nm in ("wi_fast", "wi_slow", "wo_fast", "wo_slow")}


def embed_tier(t, device=None):
    """A JAX ``EmbedTier`` (home table + pool) as the port's."""
    from repro_torch.tiering.embedding_tiering import EmbedTier
    device = resolve_device(device)
    return EmbedTier(table=torch.from_numpy(np.array(t.table)).to(device),
                     pool=tiered_pool(t.pool, device))
