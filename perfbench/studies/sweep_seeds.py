"""The sampling-noise study: ``scan_engine.sweep_seeds``, one lane a PRNG
seed, every lane replaying the same trace with its own noise (each lane's
key split every interval).

Traffic fields: ``family`` (``experiment.policy_spec`` name, at its
defaults), ``lanes`` (seeds a pass), ``T``, ``warm_T``, ``check_lanes``.
The configuration gives the machine, ``n``, ``k`` and the ``trace``: a
generator of ``traffic/`` and its parameters, made on the device from the
run's seed once, in set-up.

Pass ``p`` replays the seeds ``seed + p * lanes + j``, so no two passes
replay the same noise.
"""
from __future__ import annotations

import importlib

import torch

from perfbench import cells, compare
from perfbench.reference import prng, replay


class Study:
    def __init__(self, cell):
        from repro_torch.simulator import experiment, scan_engine
        self.sweep = scan_engine.sweep_seeds
        self.cell = cell
        tr, cf = cell.traffic, cell.config
        self.family = tr["family"]
        self.spec = experiment.policy_spec(self.family)
        self.lanes = int(cell.size("lanes"))
        self.T, self.warm_T = int(cell.size("T")), int(cell.size("warm_T"))
        self.n, self.k = int(cell.size("n")), int(cell.size("k"))
        self.check_lanes = int(cell.size("check_lanes"))
        self.machine = cf["machine"]
        self.seed = cell.seed
        params = dict(cf["trace"], **cell.shrink.get("trace", {}))
        gen = cells.load("traffic", params["generator"])
        self.trace = gen.make(params, self.T, self.n, self.seed, cell.device)
        # the entry point takes the trace as a host array
        self.trace_host = self.trace.cpu().numpy()

    def _seeds(self, p: int) -> list:
        return [self.seed + p * self.lanes + j for j in range(self.lanes)]

    def warm(self):
        self.sweep(self.trace_host[:self.warm_T], self.machine["preset"],
                   self.k, self._seeds(-1), spec=self.spec,
                   device=self.cell.device)

    def run(self, p: int) -> dict:
        out = self.sweep(self.trace_host, self.machine["preset"], self.k,
                         self._seeds(p), spec=self.spec,
                         device=self.cell.device)
        return {s: compare.lane_tuple(r) for s, r in zip(self._seeds(p), out)}

    def expected(self, p: int) -> list:
        """The lane keys pass ``p`` answers, in lane order."""
        return self._seeds(p)

    def reference(self, samples: list, lowp: bool = False) -> dict:
        """The reference's answers for ``samples``, ``(p, lane)`` pairs, in
        one replay of their seeds."""
        dev = self.cell.device
        fam = importlib.import_module(f"perfbench.reference.{self.family}")
        seeds = [self._seeds(p)[i] for p, i in samples]
        keys = torch.stack([prng.key(s, dev) for s in seeds])
        m = replay.machine(self.machine, self.cell.config["page_bytes"], dev)
        out = replay.replay(fam, [{}] * len(seeds),
                            replay.TraceRows(self.trace, len(seeds)),
                            self.k, m, "prng", keys, lowp=lowp)
        return {(p, s): (int(out["promotions"][j]), int(out["demotions"][j]),
                         int(out["wasteful"][j]), float(out["exec_time"][j]))
                for j, ((p, _), s) in enumerate(zip(samples, seeds))}
