"""Machine registry: one ``machines.get()`` lookup for every call site.

Every entry point that takes a machine accepts a registry NAME
(``"pmem-large"``, ``"numa"``, ``"cxl-1hop"``, ``"dram-cxl-pmem"``,
``"hbm-pcie"``), a two-tier ``MachineSpec`` or a ``TieredMachineSpec``.
The presets are the JAX package's, value for value:

  * ``pmem-large`` — DRAM + Optane PMem (paper's main machine);
  * ``numa``       — emulated-CXL remote NUMA node (paper §7.3);
  * ``cxl-1hop``   — DRAM + one-hop CXL-attached expander;
  * ``dram-cxl-pmem`` — three-tier chain: DRAM (capacity k), CXL
    expander (capacity 2k), PMem bottom (unbounded);
  * ``hbm-pcie``  — accelerator HBM over host memory via PCIe, the
    serving-layer topology.
"""
from __future__ import annotations

from repro_torch.simulator import machine as machine_mod
from repro_torch.simulator import machine_spec
from repro_torch.simulator.machine_spec import TieredMachineSpec

#: tier-0 bandwidth parameter (B/s) of the simulated ``hbm-pcie`` machine;
#: the JAX package's preset takes the same value from its roofline module.
HBM_PCIE_TIER0_BW = 819e9

HBM_PCIE = machine_spec.make(
    "hbm-pcie",
    lat_ns=[120.0, 900.0],
    bw_read=[HBM_PCIE_TIER0_BW, 25e9],
    bw_write=[HBM_PCIE_TIER0_BW, 25e9])

CXL_1HOP = machine_spec.make(
    "cxl-1hop",
    lat_ns=[80.0, 250.0],
    bw_read=[138e9, 30e9],
    bw_write=[138e9, 25e9])

DRAM_CXL_PMEM = machine_spec.make(
    "dram-cxl-pmem",
    lat_ns=[80.0, 250.0, 400.0],
    bw_read=[138e9, 30e9, 7.45e9],
    bw_write=[138e9, 25e9, 2.25e9],
    capacity_pages=[-1.0, -2.0, 0.0])   # k / 2k / unbounded

REGISTRY: dict[str, TieredMachineSpec] = {
    **{nm: machine_spec.from_machine(m)
       for nm, m in machine_mod.MACHINES.items()},
    "cxl-1hop": CXL_1HOP,
    "dram-cxl-pmem": DRAM_CXL_PMEM,
    "hbm-pcie": HBM_PCIE,
}


def names() -> list[str]:
    return sorted(REGISTRY)


def get(m) -> TieredMachineSpec:
    """Resolve anything machine-shaped to a ``TieredMachineSpec``."""
    if isinstance(m, TieredMachineSpec):
        return m
    if isinstance(m, machine_mod.MachineSpec):
        return machine_spec.from_machine(m)
    if isinstance(m, str):
        key = m.lower()
        if key not in REGISTRY:
            raise ValueError(f"unknown machine {m!r}; known: {names()}")
        return REGISTRY[key]
    raise TypeError(f"machine must be a name, MachineSpec or "
                    f"TieredMachineSpec, got {type(m).__name__}")
