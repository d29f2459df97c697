"""Stateful policy interface of the numpy reference engine.

A policy sees only PEBS-sampled counts and bandwidth signals (never true
access counts) and returns per-interval promotion/demotion page lists.  The
simulator engine (``simulator/engine.py::run``) applies them, charges
migration traffic, and scores the run.

This imperative interface is the legacy face of the functional policy
protocol (baselines/protocol.py): every concrete policy is a ``PolicySpec``
and reaches the numpy engine through ``protocol.LegacyPolicyAdapter``, so
both engines replay the same decisions.  The policy's state lives on the
device ``reset`` names; the engine's bookkeeping stays numpy on the host.
"""
from __future__ import annotations


class Policy:
    name: str = "base"
    #: pages the engine will migrate for this policy in one interval; models
    #: serial (kernel-thread) vs batched (Nimble/ARMS) migration mechanisms.
    migration_limit: int = 10**9

    def reset(self, n_pages: int, k: int, machine, device) -> None:
        """Fresh state over ``n_pages`` pages, ``k`` fast, on ``device``
        (``machine``: a registry name or machine spec)."""
        raise NotImplementedError

    def sampling_period(self) -> float:
        return 10_000.0

    def step(self, observed, slow_bw_frac: float, app_bw_frac: float):
        """-> (promote_idx: np.ndarray, demote_idx: np.ndarray)

        ``observed`` is the interval's f32 [n] sampled counts on the
        policy's device.  ``promote`` are slow-tier pages to move fast
        (priority order); ``demote`` are fast-tier pages to move slow.  The
        engine executes demotions first, then promotions, capped by
        capacity and ``migration_limit``.
        """
        raise NotImplementedError

    def wants_true_counts(self) -> bool:
        return False
