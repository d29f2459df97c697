"""Port parity of the CRN sampling path: the Poisson inverse-CDF transform
(both branches — λ > 12 takes the normal approximation through the ported
Cephes ndtri), the numpy uniform field and the precomputed "pre"
observation grids, against the JAX package on the same inputs.  Counts
must be equal exactly."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.scipy.special import ndtri as jndtri

from repro.simulator import sampling as js
from repro.simulator import scan_engine as jscan
from repro_torch.simulator import sampling as ps
from repro_torch.simulator import scan_engine as pscan


def _rates(rng, T, n, top):
    """Per-page true counts whose rates span both sampler branches."""
    return (rng.gamma(0.6, 1.0, (T, n)) * top).astype(np.float32)


def test_uniform_field_equal():
    np.testing.assert_array_equal(ps.uniform_field(7, 33, seed=4),
                                  js.uniform_field(7, 33, seed=4))


def test_ndtri_matches_cephes_jax():
    rng = np.random.default_rng(0)
    p = np.concatenate([rng.random(20000), np.exp(-rng.uniform(0, 60, 2000)),
                        [0.0, 1.0, 0.5, 1e-7, 1 - 1e-7]]).astype(np.float32)
    got = ps.ndtri(torch.from_numpy(p)).numpy()
    want = np.asarray(jndtri(jnp.asarray(p)))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=2e-6, atol=0)


@pytest.mark.parametrize("period", [100.0, 5000.0, 10000.0])
@pytest.mark.parametrize("need_normal", [True, False])
def test_pebs_counts_exact(period, need_normal):
    rng = np.random.default_rng(int(period))
    T, n = 16, 1024
    true = _rates(rng, T, n, 400 * period)
    if not need_normal:
        true = np.minimum(true, np.float32(11.5 * period))
    true[:, :8] = 0.0
    u = js.uniform_field(T, n, seed=int(period) + 1)
    lam = true / np.float32(period)
    assert (lam.max() > 12) == need_normal
    want = np.asarray(js.pebs_sample_from_uniform(
        jnp.asarray(u), jnp.asarray(true), jnp.float32(period),
        need_normal=need_normal))
    got = ps.pebs_sample_from_uniform(
        torch.from_numpy(u), torch.from_numpy(true),
        torch.tensor(period, dtype=torch.float32),
        need_normal=need_normal).numpy()
    np.testing.assert_array_equal(got, want)


def test_lane_periods_broadcast():
    """The "crn" engine path: one u row, lanes with their own period."""
    rng = np.random.default_rng(9)
    n = 512
    true = _rates(rng, 1, n, 200000.0)
    u = js.uniform_field(1, n, seed=3)
    periods = np.asarray([[5000.0], [10000.0], [5000.0]], np.float32)
    want = np.asarray(js.pebs_sample_from_uniform(
        jnp.asarray(u), jnp.asarray(np.repeat(true, 3, 0)),
        jnp.asarray(periods)))
    got = ps.pebs_sample_from_uniform(
        torch.from_numpy(u), torch.from_numpy(true).expand(3, n),
        torch.from_numpy(periods)).numpy()
    np.testing.assert_array_equal(got, want)


def test_precomputed_observation_grids_equal(monkeypatch):
    monkeypatch.setattr(pscan, "_OBS_ROWS", 7)   # chunks of 7, 7, 7, 3
    rng = np.random.default_rng(5)
    T, n = 24, 300
    true = _rates(rng, T, n, 150000.0)
    u = js.uniform_field(T, n, seed=8)
    want = np.asarray(jscan._precompute_observations(
        jnp.asarray(true), jnp.asarray(u), (10000, 5000), True))
    got = pscan._precompute_observations(
        torch.from_numpy(true), torch.from_numpy(u), (10000, 5000),
        True).numpy()
    np.testing.assert_array_equal(got, want)
