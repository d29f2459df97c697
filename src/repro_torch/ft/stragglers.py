"""Straggler detection — the ARMS machinery reused at cluster scope (the
port's numpy copy of ``repro/ft/stragglers.py``).

The paper's hot/cold insight (dual-horizon EWMAs + change-point detection,
§4.1-4.2) applies verbatim to per-host step-time telemetry: the short EWMA
reacts to a host that suddenly slows (preemption signal, failing HBM,
thermal throttle); the long EWMA is the host's baseline; a Page-Hinkley
test on the fleet-normalized maximum flags sustained degradation.

``StragglerMonitor`` is host-side (numpy) — it runs in the launcher, not in
the jitted step."""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class StragglerReport:
    flagged: np.ndarray        # bool [n_hosts]
    slowdown: np.ndarray       # f32 [n_hosts] short/long EWMA ratio
    fleet_alarm: bool          # PHT alarm on fleet max slowdown


class StragglerMonitor:
    def __init__(self, n_hosts: int, alpha_s: float = 0.7,
                 alpha_l: float = 0.05, threshold: float = 1.35,
                 pht_delta: float = 0.01, pht_lambda: float = 0.5):
        self.n = n_hosts
        self.alpha_s, self.alpha_l = alpha_s, alpha_l
        self.threshold = threshold
        self.pht_delta, self.pht_lambda = pht_delta, pht_lambda
        self.ewma_s = np.zeros(n_hosts)
        self.ewma_l = np.zeros(n_hosts)
        self.steps = 0
        # PHT state over fleet max slowdown
        self._pht_n = 0
        self._pht_mean = 0.0
        self._pht_m = 0.0
        self._pht_min = 0.0

    def observe(self, step_times: np.ndarray) -> StragglerReport:
        x = np.asarray(step_times, dtype=np.float64)
        assert x.shape == (self.n,)
        if self.steps == 0:
            self.ewma_s[:] = x
            self.ewma_l[:] = x
        else:
            self.ewma_s = self.alpha_s * x + (1 - self.alpha_s) * self.ewma_s
            self.ewma_l = self.alpha_l * x + (1 - self.alpha_l) * self.ewma_l
        self.steps += 1

        baseline = np.median(self.ewma_l)
        slowdown = self.ewma_s / max(baseline, 1e-9)
        flagged = (slowdown > self.threshold) & (self.steps >= 3)

        # Page-Hinkley on the fleet-max slowdown (sustained degradation)
        z = float(slowdown.max())
        self._pht_n += 1
        self._pht_mean += (z - self._pht_mean) / self._pht_n
        self._pht_m += z - self._pht_mean - self.pht_delta
        self._pht_min = min(self._pht_min, self._pht_m)
        alarm = (self._pht_m - self._pht_min) > self.pht_lambda
        if alarm:
            self._pht_n, self._pht_mean = 0, 0.0
            self._pht_m, self._pht_min = 0.0, 0.0
        return StragglerReport(flagged=flagged, slowdown=slowdown,
                               fleet_alarm=bool(alarm))
