"""The tuning study (the paper's §3 "Tuned-X", and ARMS's sensitivity
check of §6): ``tuning.tune`` of one policy family by exhaustive grid
scoring, one pass of ``workloads x grid`` lanes.

Traffic fields: ``family``, ``budget`` (grid points), ``space`` and
``defaults`` (the knob grid), ``T`` (intervals a pass), ``warm_T``,
``check_lanes`` (lanes of each pass the reference replays),
``grid_seed``.  The
configuration gives the machine, ``n``, ``k`` and the ``workloads``,
synthesised on the device; every lane shares one noise row a interval.

Seeds: the grid is drawn once from the traffic's ``grid_seed``, so every
run scores the same knob points and does the same work; pass ``p`` scores
them under the sim seed ``seed + p``, so no two passes replay the same
noise.
"""
from __future__ import annotations

import importlib

import torch

from perfbench import compare
from perfbench.reference import grid, prng, replay, workloads


def _key(cfg: dict) -> tuple:
    return tuple(sorted(cfg.items()))


class Study:
    def __init__(self, cell):
        from repro_torch.simulator import tuning
        self.tune = tuning.tune
        self.cell = cell
        tr, cf = cell.traffic, cell.config
        self.family = tr["family"]
        self.space = {nm: list(v) for nm, v in tr["space"].items()}
        self.defaults = dict(tr["defaults"])
        self.budget = int(cell.size("budget"))
        self.T, self.warm_T = int(cell.size("T")), int(cell.size("warm_T"))
        self.n, self.k = int(cell.size("n")), int(cell.size("k"))
        self.check_lanes = int(cell.size("check_lanes"))
        self.machine = cf["machine"]
        self.seed = cell.seed
        self.grid_seed = int(tr["grid_seed"])
        self.configs = grid.draw(self.space, self.defaults, self.budget,
                                 self.grid_seed)
        self.groups = list(cell.size("workloads"))
        self.lanes = len(self.groups) * len(self.configs)

    def _call(self, T: int, sim_seed: int):
        return self.tune(self.family, None, self.machine["preset"], self.k,
                         budget=self.budget, search_seed=self.grid_seed,
                         sim_seed=sim_seed & 0xFFFFFFFF, space=self.space,
                         defaults=self.defaults, workloads=self.groups, T=T,
                         n=self.n, strategy="grid", device=self.cell.device)

    def warm(self):
        self._call(self.warm_T, self.seed + 0x7FFFFFFF)

    def run(self, p: int) -> dict:
        """Pass ``p`` -> {(group, config key): compared numbers}."""
        out = self._call(self.T, self.seed + p)
        return {(g, _key(cfg)): compare.lane_tuple(res)
                for g, (_, _, rows) in out.items() for cfg, res in rows}

    def expected(self, p: int) -> list:
        """The lane keys pass ``p`` answers, in lane order (group-major)."""
        return [(g, _key(c)) for g in self.groups for c in self.configs]

    def reference(self, samples: list, lowp: bool = False) -> dict:
        """The reference's answers for ``samples``, ``(p, lane)`` pairs
        (``lane`` indexes ``expected(p)``), in one replay: the lanes of pass
        ``p`` sample from its sim seed's noise rows."""
        dev = self.cell.device
        fam = importlib.import_module(f"perfbench.reference.{self.family}")
        P = len(self.configs)
        passes = sorted({p for p, _ in samples})
        keys = torch.stack([prng.key((self.seed + p) & 0xFFFFFFFF, dev)
                            for p in passes])
        group = torch.tensor([passes.index(p) for p, _ in samples],
                             device=dev)
        widx = torch.tensor([i // P for _, i in samples], device=dev)
        cf = self.cell.config
        syn = workloads.Synth(self.groups, self.T, self.n,
                              int(cf["wl_seed"]), cf["work_per_interval"],
                              dev)
        m = replay.machine(self.machine, cf["page_bytes"], dev)
        out = replay.replay(fam, [self.configs[i % P] for _, i in samples],
                            replay.SynthRows(syn, widx), self.k, m,
                            "crn_prng", keys, group=group, lowp=lowp)
        lane_keys = self.expected(0)
        return {(p, lane_keys[i]): (
            int(out["promotions"][j]), int(out["demotions"][j]),
            int(out["wasteful"][j]), float(out["exec_time"][j]))
            for j, (p, i) in enumerate(samples)}
