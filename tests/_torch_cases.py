"""Numpy-seeded inputs of the interval-step ops, shared by the parity
tests (test_torch_interval_step.py) and the card tests
(test_torch_kernels_cuda.py).  Imports no JAX."""
import numpy as np
import torch

from repro_torch.simulator import machine_spec, machines


def t(x):
    return torch.from_numpy(np.array(x))


def plans(rng, B, n, P, D):
    """Sentinel-padded plans honouring the unique-valid-index contract."""
    promote = np.full((B, P), -1, np.int32)
    demote = np.full((B, D), -1, np.int32)
    for b in range(B):
        perm = rng.permutation(n)
        npro = rng.integers(0, min(P, n) + 1) if P else 0
        nde = rng.integers(0, min(D, n - npro) + 1) if D else 0
        promote[b, :npro] = perm[:npro]
        demote[b, :nde] = perm[npro:npro + nde]
    return promote, demote


def migrate_case(B, n, R, P, D, seed):
    """(tier, promote, demote, caps) as numpy arrays."""
    rng = np.random.default_rng(seed)
    tier = rng.integers(0, R, (B, n)).astype(np.int32)
    caps = np.stack([np.append(rng.integers(1, n, R - 1), n)
                     for _ in range(B)]).astype(np.int32)
    promote, demote = plans(rng, B, n, P, D)
    return tier, promote, demote, caps


def account_case(B, n, machine, seed):
    """(port machine lanes, true, tier, mig_up, mig_down, oracle, k); the
    rows are numpy arrays."""
    k = max(1, n // 4)
    rng = np.random.default_rng(seed)
    spec = machines.get(machine)
    R = spec.n_tiers
    pmach, _ = machine_spec.lane_stack([spec] * B, n, k, device="cpu")
    true = rng.gamma(1.5, 2.0, (B, n)).astype(np.float32)
    tier = rng.integers(0, R, (B, n)).astype(np.int32)
    up = rng.integers(0, 5, (B, R - 1)).astype(np.float32)
    down = rng.integers(0, 5, (B, R - 1)).astype(np.float32)
    oracle = rng.random((B, n)) < 0.25
    return pmach, true, tier, up, down, oracle, k
