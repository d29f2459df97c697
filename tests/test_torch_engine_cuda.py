"""The numpy reference engine (repro_torch/simulator/engine.py::run) on
the card against the same run on the CPU (marked ``cuda``; skipped where
there is none).

Run on a machine with an NVIDIA GPU and nvcc:

    PYTHONPATH=src python -m pytest -q -m cuda --noconftest tests/test_torch_engine_cuda.py

At n = 4,096 pages, a GUPS-like trace with a hot set twice the fast tier
that moves every 32 intervals, one CRN field: on the card the policy, the
sampler and the accounting run through the hand-written kernels
(``ewma_update``, ``topk_mask``, ``interval_account``), on the CPU
through their plain versions; every count and timeline is exact and the
exec time within 1e-4 relative, for a binary family (ARMS, hand-tuned
wrapper) and a tier-native one (Jenga on the 3-tier machine).  This file
imports no JAX.
"""
import numpy as np
import pytest
import torch

from repro_torch.baselines.arms_policy import ARMSPolicy
from repro_torch.baselines.jenga import JengaPolicy
from repro_torch.kernels import _backend
from repro_torch.simulator import engine
from repro_torch.simulator.sampling import uniform_field

T, N, K = 96, 4096, 512


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _trace(seed):
    rng = np.random.default_rng(seed)
    trace = np.empty((T, N), np.float32)
    for t0 in range(0, T, 32):
        probs = np.full(N, 0.1 / (N - 2 * K))
        probs[rng.permutation(N)[:2 * K]] = 0.9 / (2 * K)
        trace[t0:t0 + 32] = (2.0e7 * probs).astype(np.float32)
    return trace


@pytest.mark.cuda
@pytest.mark.parametrize("policy,machine,kernels", [
    (ARMSPolicy, "pmem-large", ("ewma_update", "topk_mask",
                                "interval_account")),
    (JengaPolicy, "dram-cxl-pmem", ("interval_account",))])
def test_run_card_equals_cpu(card, policy, machine, kernels):
    trace, u = _trace(1), uniform_field(T, N, seed=2)
    before = {nm: _backend.launches[nm] for nm in kernels}
    got = engine.run(policy(), trace, machine, K, sample_u=u, device=card)
    for nm in kernels:
        assert _backend.launches[nm] > before[nm], nm
    want = engine.run(policy(), trace, machine, K, sample_u=u, device="cpu")
    assert got.promotions > 0
    for nm in ("promotions", "demotions", "wasteful"):
        assert getattr(got, nm) == getattr(want, nm), nm
    for nm in ("timeline_promotions", "timeline_mode"):
        np.testing.assert_array_equal(getattr(got, nm), getattr(want, nm))
    for nm in ("exec_time_s", "hot_recall", "fast_hit_frac"):
        np.testing.assert_allclose(getattr(got, nm), getattr(want, nm),
                                   rtol=1e-4)
