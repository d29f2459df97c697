"""State carried across from the JAX package into the port's dataclasses.

Each function takes the JAX package's object with its leaves as numpy
arrays (``jax.tree_util.tree_map(np.asarray, obj)``) and returns the
port's tensor dataclass.  Fields are read by name, so nothing of the JAX
package is imported here.  A per-lane object (the JAX package's layout
outside ``vmap``) gains a lane axis of 1; a lane-batched one keeps its
lanes.  Like every entry point of the port, each function puts its
tensors on the CUDA card unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.baselines.arms_policy import ARMSRunState, ARMSSpec
from repro_torch.core.state import ARMSConfig, PHTState, TieringState
from repro_torch.simulator.machine_spec import TieredMachineSpec
from repro_torch.utils.device import resolve_device


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


def machine(obj, device=None) -> TieredMachineSpec:
    """A ``TieredMachineSpec`` as f32 tensor leaves ([R] -> [1, R])."""
    device = resolve_device(device)
    lanes = np.ndim(obj.lat_ns) == 2
    leaves = {f.name: _tensor(np.asarray(getattr(obj, f.name), np.float32),
                              lanes, device)
              for f in dataclasses.fields(TieredMachineSpec)
              if f.name != "name"}
    return TieredMachineSpec(**leaves, name=obj.name)
