"""The hand-written CUDA interval-step kernels against their plain
versions, on the card (marked ``cuda``; skipped where there is none).

Run on a machine with an NVIDIA GPU and nvcc:

    PYTHONPATH=src python -m pytest -q -m cuda --noconftest tests/test_torch_kernels_cuda.py

Every output must equal the plain version's exactly: the masks, tiers and
counts are integers, the EWMA is op for op the same f32 arithmetic (the
kernels build with ``-fmad=false``), and the accounting sums round once
from f64 on both sides.  This file imports no JAX, so it runs where the
JAX package is not installed.
"""
import numpy as np
import pytest
import torch

from _torch_cases import account_case, migrate_case
from _torch_cases import t as _t
from repro_torch.kernels import _backend
from repro_torch.kernels.interval_step import kernel, ops, ref


def _ewma_case(B, n, seed):
    rng = np.random.default_rng(seed)
    s = rng.random((B, n)).astype(np.float32)
    l = rng.random((B, n)).astype(np.float32)
    c = rng.poisson(5, (B, n)).astype(np.float32)
    params = rng.random((B, 4)).astype(np.float32)
    return s, l, c, params


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _launches(name, fn):
    before = _backend.launches[name]
    out = fn()
    torch.cuda.synchronize()
    assert _backend.launches[name] == before + 1
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("B,n,k", [(1, 7, 1), (3, 37, 5), (2, 37, 37),
                                   (4, 513, 1), (2, 4097, 512),
                                   (16, 65536, 8192)])
def test_topk_kernel_vs_plain(card, B, n, k):
    rng = np.random.default_rng(n + k)
    x = (rng.integers(-3, 5, (B, n)) * 0.25).astype(np.float32)
    x[:, ::7] = -0.0
    xd = _t(x).to(card)
    got = _launches("topk_mask", lambda: kernel.topk_mask(xd, k))
    assert torch.equal(got.cpu(), ref.topk_mask_ref(_t(x), k))


@pytest.mark.cuda
@pytest.mark.parametrize("B,n,R,P,D", [(2, 13, 2, 3, 4), (3, 29, 3, 5, 5),
                                       (4, 64, 4, 8, 8),
                                       (16, 65536, 3, 64, 64)])
def test_migrate_kernel_vs_plain(card, B, n, R, P, D):
    case = migrate_case(B, n, R, P, D, n + R)
    got = _launches("tier_migrate", lambda: kernel.tier_migrate(
        *(_t(a).to(card) for a in case)))
    want = ref.tier_migrate_ref(*(_t(a) for a in case))
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.cuda
@pytest.mark.parametrize("machine", ["pmem-large", "dram-cxl-pmem"])
@pytest.mark.parametrize("B,n", [(1, 7), (3, 130), (16, 65536)])
def test_account_kernel_vs_plain(card, machine, B, n):
    pmach, true, tier, up, down, oracle, k = account_case(B, n, machine, n)
    row, orow = _t(true[0]).to(card), _t(oracle[0]).to(card)
    got = _launches("interval_account", lambda: ops.interval_account(
        pmach.to(card), row[None].expand(B, n), _t(tier).to(card),
        _t(up).to(card), _t(down).to(card), orow[None].expand(B, n), k))
    want = ref.interval_account_ref(
        pmach, _t(true[0])[None].expand(B, n), _t(tier), _t(up), _t(down),
        _t(oracle[0])[None].expand(B, n), k)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.cuda
@pytest.mark.parametrize("B,n", [(1, 17), (3, 1000), (16, 65536)])
def test_ewma_kernel_vs_plain_bitwise(card, B, n):
    s, l, c, params = _ewma_case(B, n, n)
    params = _t(params)
    got = _launches("ewma_update", lambda: kernel.ewma_update(
        _t(s).to(card), _t(l).to(card), _t(c).to(card), params.to(card)))
    want = ref.ewma_score_update_ref(_t(s), _t(l), _t(c), params)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.cuda
def test_wrappers_reject_bad_inputs(card):
    x = torch.zeros((2, 64), device=card)
    with pytest.raises(TypeError):
        kernel.topk_mask(x.double(), 4)
    with pytest.raises(ValueError):
        kernel.topk_mask(x[:, ::2], 4)
    with pytest.raises(ValueError):
        kernel.topk_mask(x.cpu(), 4)
    with pytest.raises(ValueError):
        kernel.topk_mask(x, 65)
