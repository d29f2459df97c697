"""Functional policy protocol, lane-batched: pure functions over tensor
dataclass state, with an explicit leading lane axis on every leaf.

    state = spec.init(n_pages, k, machine)       # machine: [B, R] leaves
    state = spec.observe(state, observed)        # cheap, every interval
    fire  = spec.fires(state)                    # bool [B]
    state, promote, demote = spec.policy(state, slow_bw, app_bw, k)

``promote``/``demote`` are fixed-shape i32 ``[B, pad]`` arrays (padded-
index contract): ``-1`` entries are padding, the others page indices in
priority order, unique within a lane.  The engine executes demotions
first, then promotions capped by free capacity
(``simjax.apply_tier_migrations``).

Only the binary hop-chain route is ported: the tier-native contract
(``tier_policy``), the per-lane ``mixed_observation`` hooks and the numpy
engine's ``LegacyPolicyAdapter`` wait.
"""
from __future__ import annotations

#: padding entry of the padded-index plans
SENTINEL = -1


class PolicySpec:
    """Base of the functional policy protocol (subclass + tensor_dataclass).

    Class attributes are static protocol metadata; dataclass fields are
    the knob leaves, lane-batched along axis 0."""

    name: str = "base"
    #: specs that target tiers directly (``tier_policy``) and union specs
    #: mixing observation kinds per lane; neither is ported yet.
    tier_native: bool = False
    mixed_observation: bool = False

    DEFAULT_SAMPLE_PERIOD = 10_000.0

    def pad_promote(self, n: int, k: int) -> int:
        """Width of the padded ``promote`` plan."""
        raise NotImplementedError

    def pad_demote(self, n: int, k: int) -> int:
        """Width of the padded ``demote`` plan."""
        raise NotImplementedError

    def init(self, n_pages: int, k: int, machine):
        raise NotImplementedError

    def observe(self, state, observed):
        return state

    def fires(self, state):
        raise NotImplementedError

    def sampling_period(self, state):
        raise NotImplementedError

    def min_sampling_period(self) -> float:
        """Host-side lower bound on the sampling period."""
        return float(self.DEFAULT_SAMPLE_PERIOD)

    def mode_of(self, state):
        raise NotImplementedError

    def policy(self, state, slow_bw, app_bw, k: int):
        raise NotImplementedError
