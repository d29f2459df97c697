"""Finding a cell's files by name.

``BENCHMARK.json`` at the repository root names each cell with its
configuration and traffic.  The configuration's sizes are
``configs/<config>.json``; the traffic (the study a run replays) is
``workloads/<traffic>.json``, whose ``"study"`` names the module that
runs it, ``studies/<study>.py``.  Metrics are ``metrics/<metric>.py``;
a metric ``<base>.<part>`` with no module of its own, one quantity split
by the cells that report it, is read by ``metrics/<base>.py``.  Reference
policies ``reference/<family>.py`` and trace generators
``traffic/<generator>.py``.  Adding a cell, a configuration, a metric or
a study adds files and entries; no file here names any of them.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass
class Cell:
    """One cell of the benchmark as a run sees it."""

    name: str
    config: dict
    traffic: dict
    chips: int
    seed: int
    device: object = None
    #: keys of ``config`` and ``traffic`` replaced for a small run (tests)
    shrink: dict = dataclasses.field(default_factory=dict)

    def size(self, key: str):
        """A size of the cell: ``shrink``, then the traffic, then the
        configuration."""
        if key in self.shrink:
            return self.shrink[key]
        if key in self.traffic:
            return self.traffic[key]
        return self.config[key]


def benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def read_json(kind: str, name: str) -> dict:
    path = HERE / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file {path}")
    return json.loads(path.read_text())


def load(kind: str, name: str):
    """The module ``<kind>/<name>.py`` (names may hold dots and dashes),
    or, where there is none, that of ``name`` without its last dotted
    part, and so on."""
    base = name
    path = HERE / kind / f"{base}.py"
    while not path.is_file() and "." in base:
        base = base.rsplit(".", 1)[0]
        path = HERE / kind / f"{base}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} module for {name!r} in "
                                f"{HERE / kind}")
    mod_name = f"perfbench.{kind}.{base.replace('.', '_').replace('-', '_')}"
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


def cell(name: str, seed: int, bench: dict | None = None, device=None,
         shrink: dict | None = None) -> Cell:
    bench = bench if bench is not None else benchmark()
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json")
    return Cell(name=name, config=read_json("configs", entry["config"]),
                traffic=read_json("workloads", entry["traffic"]),
                chips=int(entry["chips"]), seed=int(seed), device=device,
                shrink=dict(shrink or {}))


def metrics_of(bench: dict, cell_name: str, trace: bool) -> list:
    """The metric entries a run of ``cell_name`` reports: the end-to-end
    ones without tracing, the per-layer ones with it; an entry with a
    ``workloads`` key applies to the cells it lists (a quantity split by
    cells, such as ``lane_intervals_per_s.tune`` and ``.seeds``)."""
    entries = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in entries
            if "workloads" not in m or cell_name in m["workloads"]]
