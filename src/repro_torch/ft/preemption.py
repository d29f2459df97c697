"""The port's copy of ``repro/ft/preemption.py``.  Preemption-safe
execution: SIGTERM/SIGINT set a flag; the training loop
checkpoints and exits cleanly at the next step boundary."""
from __future__ import annotations

import signal
import threading


class PreemptionGuard:
    def __init__(self, signals=(signal.SIGTERM,)):
        self._flag = threading.Event()
        self._signals = signals
        self._old = {}

    def __enter__(self):
        for s in self._signals:
            self._old[s] = signal.signal(s, self._handler)
        return self

    def __exit__(self, *exc):
        for s, h in self._old.items():
            signal.signal(s, h)
        return False

    def _handler(self, signum, frame):
        self._flag.set()

    def fire(self):          # for tests
        self._flag.set()

    @property
    def preempted(self) -> bool:
        return self._flag.is_set()
