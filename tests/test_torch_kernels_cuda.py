"""The hand-written CUDA kernels against their plain versions, on the
card (marked ``cuda``; skipped where there is none).

Run on a machine with an NVIDIA GPU and nvcc:

    PYTHONPATH=src python -m pytest -q -m cuda --noconftest tests/test_torch_kernels_cuda.py

The interval-step kernels and the migration fire must equal the plain
version exactly (the fire over pools on the card and homes pinned on the
host, one launch a fire through ``pool_step``, repeated random fires, a
pinned home dropped while its fire runs; host offload's ``memkind``
pins): the masks, tiers, counts and copied rows are exact, the
EWMA is op for op the same f32 arithmetic (the kernels build with
``-fmad=false``), and the accounting sums round once from f64 on both
sides.  Paged attention sums in another order than the plain version:
its output and page mass are held within 1e-5 (absolutely, relatively
above 1; bf16 within 2e-2), and two runs must give the same bits.  Flash
attention is held to its plain version computed in f32 from the same
inputs: f32 output within 2e-5 and gradients within 1e-4 of the largest
entry; bf16 (on the tensor cores, P and dS rounded to bf16) output within
2e-2 and gradients within 2e-2 of the largest entry; two backward runs
give the same bits.  The single-row score update equals its plain version
bit for bit.  The Mamba2 scan likewise,
forward and backward, at the JAX test's shapes, reduced mamba2-370m's and
the training shape (tolerances in its tests: the cumsum's rounding
through ``exp``).  This file imports no JAX, so it runs where the JAX
package is not installed.
"""
import numpy as np
import pytest
import torch

from _torch_cases import account_case, migrate_case, migrate_edge_case
from _torch_cases import t as _t
from repro_torch.kernels import _backend
from repro_torch.kernels.interval_step import kernel, ops, ref
from repro_torch.utils.pytree import take_lanes


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


def _topk_case(B, n, k, kind, card=None):
    """Rows for the top-k cases.  ``ties``: few distinct values and signed
    zeros; ``equal``: every key the same; ``straddle``: 40 keys on each
    side of every CTA boundary of the row's cluster equal the threshold,
    of which half are taken (k - half of them keys lie above it, at random
    places; the rest below it)."""
    rng = np.random.default_rng(n + k)
    if kind == "equal":
        return np.full((B, n), 1.5, np.float32)
    if kind == "straddle":
        x = rng.random((B, n), dtype=np.float32)
        C = kernel.topk_cluster(B, n, card)
        slice_ = -(-(-(-n // C)) // 16) * 16
        tied = np.zeros(n, bool)
        for r in range(1, C):
            tied[max(0, r * slice_ - 40):min(n, r * slice_ + 40)] = True
        x[:, tied] = 5.0
        free = np.flatnonzero(~tied)
        for b in range(B):
            up = rng.choice(free, k - int(tied.sum()) // 2, replace=False)
            x[b, up] = 10.0 + rng.random(up.size, dtype=np.float32)
        return x
    x = (rng.integers(-3, 5, (B, n)) * 0.25).astype(np.float32)
    x[:, ::7] = -0.0
    return x


# the sweep's 16 x 65,536 and arms_sim's single row; k = 1 and k = n past
# one CTA's slice; an n no slice divides; rows past the shared-memory route
# (slices of more than 40,960 keys stream from device memory)
TOPK_CASES = [(1, 7, 1, "ties"), (3, 37, 5, "ties"), (2, 37, 37, "ties"),
              (4, 513, 1, "ties"), (2, 4097, 512, "ties"),
              (16, 65536, 8192, "ties"), (1, 65536, 8192, "ties"),
              (2, 30000, 3000, "equal"), (1, 65536, 8192, "straddle"),
              (16, 65536, 8192, "straddle"), (2, 20000, 1, "ties"),
              (2, 20000, 20000, "ties"), (3, 100003, 777, "ties"),
              (1, 1000003, 4096, "ties"), (2, 800000, 12345, "straddle")]


@pytest.mark.cuda
@pytest.mark.parametrize("B,n,k,kind", TOPK_CASES)
def test_topk_kernel_vs_plain(card, B, n, k, kind):
    x = _topk_case(B, n, k, kind, card)
    xd = _t(x).to(card)
    got = _launches("topk_mask", lambda: kernel.topk_mask(xd, k))
    assert torch.equal(got.cpu(), ref.topk_mask_ref(_t(x), k))


def _migrate_on_card(card, case):
    """The kernel's five outputs (one launch, the input row unchanged) and
    the plain version's on the CPU."""
    args = [_t(a).to(card) for a in case]
    row = args[0].clone()
    got = _launches("tier_migrate", lambda: kernel.tier_migrate(*args))
    assert torch.equal(args[0], row)
    return got, ref.tier_migrate_ref(*(_t(a) for a in case))


# rows shorter than one CTA's slice; the sweep's 16 x 65,536 at 2 and 3
# tiers and arms_sim's 1 x 65,536 (lanes on clusters); 8 tiers with n not a
# multiple of 4; plans of 1,024 entries, the widest that are staged in
# shared memory
@pytest.mark.cuda
@pytest.mark.parametrize("B,n,R,P,D", [(2, 13, 2, 3, 4), (3, 29, 3, 5, 5),
                                       (4, 64, 4, 8, 8),
                                       (16, 65536, 3, 64, 64),
                                       (16, 65536, 2, 64, 64),
                                       (1, 65536, 3, 64, 64),
                                       (3, 4099, 8, 64, 64),
                                       (2, 5001, 5, 1024, 1024)])
def test_migrate_kernel_vs_plain(card, B, n, R, P, D):
    got, want = _migrate_on_card(card, migrate_case(B, n, R, P, D, n + R))
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


# plan widths P/D past the staged route's 1,024: TPP's 12-entry promotions
# and k-wide demotions, both of the oracle's plans k wide (k = 8,192 at
# n = 65,536), a ragged 1,025/33; and ARMS's 64/64 on the staged route
@pytest.mark.cuda
@pytest.mark.parametrize("R", [2, 3])
@pytest.mark.parametrize("B", [1, 16])
@pytest.mark.parametrize("P,D", [(12, 8192), (8192, 8192), (1025, 33),
                                 (64, 64)])
def test_migrate_kernel_wide_plans(card, B, R, P, D):
    n = 65536
    for case in (migrate_case(B, n, R, P, D, P + D + R),
                 migrate_edge_case(B, n, R, P, D, P + D + R, "both")):
        got, want = _migrate_on_card(card, case)
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["both", "tight", "invalid"])
@pytest.mark.parametrize("B,n,R,P,D", [(2, 13, 2, 4, 4), (3, 4099, 8, 64, 64),
                                       (1, 65536, 3, 64, 64),
                                       (2, 37, 4, 0, 6), (2, 37, 4, 6, 0),
                                       (2, 5, 3, 0, 0)])
def test_migrate_kernel_edges(card, B, n, R, P, D, kind):
    """Pages in both plans (the promotion's write wins), tier 0's room and
    the middle tiers' slack at or below 0, zero-width and all-invalid
    plans, at rows below one CTA's slice and on clusters."""
    got, want = _migrate_on_card(
        card, migrate_edge_case(B, n, R, P, D, n + R + P, kind))
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.cuda
@pytest.mark.parametrize("cluster", [1, 2, 3, 7, 16])
@pytest.mark.parametrize("B,n", [(2, 37), (3, 4099), (16, 65536)])
def test_migrate_kernel_every_cluster_size(card, monkeypatch, B, n,
                                           cluster):
    """A lane over a forced number of CTAs: slices that end ragged, CTAs
    with no page at all, and plan pages in every CTA's slice."""
    monkeypatch.setitem(_backend.clusters, kernel.cluster_key(
        "migrate", B, n, torch.cuda.current_device()), cluster)
    for case in (migrate_case(B, n, 4, 64, 64, n),
                 migrate_edge_case(B, n, 4, 64, 64, n, "both")):
        got, want = _migrate_on_card(card, case)
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 16])
def test_migrate_spreads_a_lane_over_a_cluster(card, B):
    """At the replay's 65,536 pages a lane takes more than one CTA."""
    assert 1 < kernel.migrate_cluster(B, 65536, card) <= 16


# rows shorter than one CTA's slice; the sweep's 16 x 65,536 and arms_sim's
# 1 x 65,536 (lanes on clusters); n not a multiple of 4 (the scalar tail,
# and lane rows off a 16-byte boundary); 2^20 pages (64 words a thread)
ACCOUNT_SHAPES = [(1, 7), (3, 130), (16, 65536), (1, 65536), (2, 1001),
                  (4, 65539), (1, 2 ** 20)]


def _account_on_card(card, machine, B, n, shared):
    """The kernel's six outputs (one launch) and the plain version's on
    the CPU; with ``shared`` the true and oracle rows are lane 0's,
    broadcast to every lane (lane stride 0), else each lane's own (lane
    stride n)."""
    pmach, true, tier, up, down, oracle, k = account_case(B, n, machine, n)
    if shared:   # expanded on the card: a copy of an expanded row is dense
        rows = [_t(a[0])[None].expand(B, n) for a in (true, oracle)]
        on_card = [_t(a[0]).to(card)[None].expand(B, n)
                   for a in (true, oracle)]
        assert B == 1 or all(r.stride(0) == 0 for r in on_card)
    else:
        rows = [_t(a) for a in (true, oracle)]
        on_card = [r.to(card) for r in rows]
        assert all(r.stride(0) == n for r in on_card)
    got = _launches("interval_account", lambda: ops.interval_account(
        pmach.to(card), on_card[0], _t(tier).to(card),
        _t(up).to(card), _t(down).to(card), on_card[1], k))
    want = ref.interval_account_ref(pmach, rows[0], _t(tier), _t(up),
                                    _t(down), rows[1], k)
    return got, want


@pytest.mark.cuda
@pytest.mark.parametrize("shared", [True, False], ids=["shared", "own"])
@pytest.mark.parametrize("machine", ["pmem-large", "dram-cxl-pmem"])
@pytest.mark.parametrize("B,n", ACCOUNT_SHAPES)
def test_account_kernel_vs_plain(card, machine, B, n, shared):
    got, want = _account_on_card(card, machine, B, n, shared)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.cuda
@pytest.mark.parametrize("cluster", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("B,n", [(2, 37), (3, 4099), (16, 65536)])
def test_account_kernel_every_cluster_size(card, monkeypatch, B, n,
                                           cluster):
    """A lane over a forced number of CTAs (every divisor of the 16
    sub-slices): sub-slices that end ragged, and sub-slices with no page
    at all (37 pages in 16 sub-slices of 4 leave six empty), still equal
    the plain version."""
    monkeypatch.setitem(_backend.clusters, kernel.cluster_key(
        "account", B, n, torch.cuda.current_device()), cluster)
    for shared in (True, False):
        got, want = _account_on_card(card, "dram-cxl-pmem", B, n, shared)
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w)


def _wide_range_rows(rng, B, n):
    """f32 rows spanning some 2^46: their f64 sums are not exact, so the
    order of the additions shows in the bits."""
    return np.exp(rng.normal(0.0, 8.0, (B, n))).astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("machine", ["pmem-large", "dram-cxl-pmem"])
def test_account_lane_bits_independent_of_lane_count(card, monkeypatch,
                                                     machine):
    """One lane embedded in batches of 1, 9, 21, 168 and 216 lanes, each
    at the cluster size its chooser picks, and at every cluster size
    forced, gives the same bits on rows whose f64 sums are not exact: a
    lane's row is summed in 16 fixed sub-slices, added in order."""
    n, Bmax = 65536, 216
    rng = np.random.default_rng(11)
    pmach, _, tier, up, down, oracle, k = account_case(Bmax, n, machine, 5)
    true = _wide_range_rows(rng, Bmax, n)
    args = [_t(a).to(card) for a in (true, tier, up, down, oracle)]
    mach = pmach.to(card)
    lane = 3                                   # the lane held everywhere

    def run(B, at):
        idx = torch.tensor([b for b in range(Bmax) if b != lane][:B - 1],
                           dtype=torch.long)
        idx = torch.cat([idx[:at], torch.tensor([lane]), idx[at:]]).to(card)
        take = lambda x: x.index_select(0, idx).contiguous()
        out = ops.interval_account(
            take_lanes(mach, idx), take(args[0]), take(args[1]),
            take(args[2]), take(args[3]), take(args[4]), k)
        return torch.stack([o[at] for o in out]).cpu()

    want = run(1, 0)
    seen = set()
    for B in (1, 9, 21, 168, 216):
        seen.add(kernel.account_cluster(B, n, card))
        for at in (0, B // 2, B - 1):
            assert torch.equal(run(B, at), want), (B, at)
    assert len(seen) > 1                   # the batches span cluster sizes
    for c in (1, 2, 4, 8, 16):
        monkeypatch.setitem(_backend.clusters, kernel.cluster_key(
            "account", 9, n, torch.cuda.current_device()), c)
        assert torch.equal(run(9, 4), want), c


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 16])
def test_account_spreads_a_lane_over_a_cluster(card, B):
    """At the replay's 65,536 pages a lane takes more than one CTA."""
    assert 1 < kernel.account_cluster(B, 65536, card) <= 16


@pytest.mark.cuda
@pytest.mark.parametrize("B,n", [(1, 17), (3, 1000), (16, 65536), (4, 1001),
                                 (1, 4096 * 1024 + 5)])
def test_ewma_kernel_vs_plain_bitwise(card, B, n):
    """Bitwise at lanes on and off a 16-byte boundary (n odd), a ragged
    tail and more pages than the grid's threads."""
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


# ------------------------------------------------------------------ migrate
from _torch_cases import (MIGRATE_SHAPES, PAGED_EDGE_SHAPES,  # noqa: E402
                          PAGED_SHAPES, migrate_pools_case, paged_case)
from repro_torch.kernels.migrate import kernel as mkernel  # noqa: E402
from repro_torch.kernels.migrate import ops as mops  # noqa: E402
from repro_torch.kernels.migrate import ref as mref  # noqa: E402
from repro_torch.kernels.paged_attention import kernel as pkernel  # noqa: E402
from repro_torch.kernels.paged_attention import ref as pref  # noqa: E402
from repro_torch.tiering import host_offload as HO  # noqa: E402
from repro_torch.tiering import tiered_pool as TP  # noqa: E402


def fire_case(k, n, row, seed, dtype=np.float32, vacated=False):
    """(fast [k, *row], home [n, *row], out_row, in_row) numpy arrays of a
    fire: demotions of some slots to unique home rows, promotions of other
    unique home rows into some slots (``vacated``: exactly the demoted
    ones), and in unused entries -1 or rows past the home pool."""
    rng = np.random.default_rng(seed)
    fast = (rng.standard_normal((k,) + row) * 100).astype(dtype)
    home = (rng.standard_normal((n,) + row) * 100).astype(dtype)
    pages = rng.permutation(n)
    nd = int(rng.integers(1, min(k, n // 2) + 1))
    d_slots = rng.choice(k, nd, replace=False)
    rest = pages[nd:]
    if vacated:
        p_slots = d_slots[:min(nd, len(rest))]
    else:
        p_slots = rng.choice(k, int(rng.integers(1, min(k, len(rest)) + 1)),
                             replace=False)
    out_row = np.full(k, -1, np.int32)
    in_row = np.full(k, -1, np.int32)
    out_row[d_slots] = pages[:nd]
    in_row[p_slots] = rest[:len(p_slots)]
    out_row[(out_row < 0) & (rng.random(k) < 0.5)] = n + 3
    in_row[(in_row < 0) & (rng.random(k) < 0.5)] = n
    return fast, home, out_row, in_row


def _fire_on_card(card, case, pinned=False):
    """The kernel's fire (one launch) and the plain fire on the CPU: ->
    ((fast, home) from the card, (fast, home) plain)."""
    fast, home, out_row, in_row = (_t(a) for a in case)
    f = fast.to(card)
    h = home.pin_memory() if pinned else home.to(card)
    assert _launches("migrate", lambda: mkernel.migrate_fire(
        [f], [h], out_row.to(card), in_row.to(card))) is True
    mref.migrate_fire_ref([fast], [home], out_row, in_row)
    return (f.cpu(), h.cpu()), (fast, home)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float32, np.int32, np.float16])
@pytest.mark.parametrize("shape", MIGRATE_SHAPES)
def test_migrate_pages_kernel_vs_plain(card, shape, dtype):
    """Bit for bit at the port's test shapes: odd row sizes of 4 and 2
    bytes."""
    Ps, Pd, _, page, feat = shape
    got, want = _fire_on_card(card, fire_case(Pd, Ps, (page, feat),
                                              sum(shape), dtype))
    assert all(torch.equal(g, w) for g, w in zip(got, want))


# row bytes at and around the 16 KiB chunk and the 4 KiB smallest chunk,
# at slot counts that do and do not shrink the chunk
CHUNK_ROWS = [(4, 9, 1024), (8, 20, 1023), (3, 7, 4096), (4, 9, 4100),
              (2, 5, 3 * 4096 + 3), (64, 130, 4096), (16, 40, 8192 + 4)]


@pytest.mark.cuda
@pytest.mark.parametrize("vacated", [False, True], ids=["free", "vacated"])
@pytest.mark.parametrize("k,n,words", CHUNK_ROWS)
def test_fire_kernel_at_chunk_boundaries(card, k, n, words, vacated):
    got, want = _fire_on_card(card, fire_case(k, n, (words,), k + words,
                                              vacated=vacated))
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("pinned", [False, True], ids=["card", "pinned"])
def test_fire_every_promotion_into_a_vacated_slot(card, pinned):
    """The case that breaks a naive single launch: every slot is demoted
    and refilled in the same fire (the serving fold's 8 fast pages), with
    the home on the card and pinned on the host."""
    k, n, row = 8, 32, (4, 8 * 8 * 128)
    fast, home, _, _ = fire_case(k, n, row, 5)
    pages = np.random.default_rng(6).permutation(n)
    case = (fast, home, pages[:k].astype(np.int32),
            pages[k:2 * k].astype(np.int32))
    got, want = _fire_on_card(card, case, pinned)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert torch.equal(got[0], _t(home)[_t(case[3]).long()])
    assert torch.equal(got[1][_t(case[2]).long()], _t(fast))


@pytest.mark.cuda
def test_migrate_empty_and_all_invalid(card):
    """An empty plan (k = 0) launches nothing; tables of -1 and rows past
    the pool launch once and copy nothing."""
    fast, home, _, _ = fire_case(4, 8, (4, 32), 3)
    f, h = _t(fast).to(card), _t(home).to(card)
    before = _backend.launches["migrate"]
    e = torch.zeros((0,), dtype=torch.int32, device=card)
    assert mkernel.migrate_fire([f[:0]], [h], e, e) is False
    assert _backend.launches["migrate"] == before   # k = 0: no launch
    for fill in (-1, 8):
        tab = torch.full((4,), fill, dtype=torch.int32, device=card)
        _launches("migrate", lambda: mops.migrate_fire([f], [h], tab, tab))
    assert torch.equal(f.cpu(), _t(fast)) and torch.equal(h.cpu(), _t(home))


@pytest.mark.cuda
def test_migrate_rows_same_tensor_two_pools(card):
    """The serving layer's fire: K and V fused ``[k + n, ...]`` tensors,
    one launch over both through views, demotions and promotions."""
    k, n = 8, 32
    fast, home, out_row, in_row = fire_case(k, n, (16, 8 * 8 * 16), 11)
    fused = [np.concatenate([fast, home]),
             np.concatenate([fast, home])[::-1].copy()]
    on_card = [_t(b).to(card) for b in fused]
    tabs = [_t(out_row), _t(in_row)]
    _launches("migrate", lambda: mops.migrate_fire(
        [b[:k] for b in on_card], [b[k:] for b in on_card],
        *(t.to(card) for t in tabs)))
    want = [_t(b) for b in fused]
    mops.migrate_fire([b[:k] for b in want], [b[k:] for b in want], *tabs)
    assert all(torch.equal(g.cpu(), w) for g, w in zip(on_card, want))


# deepseek-v2-236b's routed experts (d_model 5,120, expert d_ff 1,536, bf16):
# a ``wi`` row [5120, 3072] is 31.5 MB (1,920 chunks of 16 KiB), a ``wo``
# row [1536, 5120] 15.7 MB
SLAB_ROWS = [(5120, 3072), (1536, 5120)]


def _slab_pools(card, rows, fast, home):
    g = torch.Generator(device=card).manual_seed(sum(rows[0]))
    return [torch.randn((fast + home,) + r, generator=g, device=card,
                        dtype=torch.bfloat16) for r in rows]


@pytest.mark.cuda
@pytest.mark.parametrize("row", SLAB_ROWS, ids=["wi", "wo"])
def test_migrate_rows_at_expert_slab_rows(card, row):
    """The expert tier's promotion: home rows (after 3 fast slots) copied
    up into fast slots of one fused pool, one launch."""
    pool, = _slab_pools(card, [row], 3, 6)
    want = pool.cpu()
    none = torch.full((3,), -1, dtype=torch.int32)
    in_row = torch.tensor([0, 4, -1], dtype=torch.int32)
    _launches("migrate", lambda: mkernel.migrate_fire(
        [pool[:3]], [pool[3:]], none.to(card), in_row.to(card)))
    mops.migrate_fire([want[:3]], [want[3:]], none, in_row)
    assert torch.equal(pool.cpu(), want)
    assert torch.equal(want[1], want[3 + 4]) and torch.equal(want[0],
                                                             want[3])


@pytest.mark.cuda
@pytest.mark.parametrize("pinned", [False, True], ids=["card", "pinned"])
def test_fire_pools_of_two_row_shapes_one_launch(card, pinned):
    """``wi`` and ``wo`` moved by ONE launch (their two row shapes), with a
    demotion and promotions into the vacated slot; homes on the card, or
    pinned on the host."""
    k = 3
    pools = _slab_pools(card, SLAB_ROWS, k, 5)
    want = [p.cpu() for p in pools]
    homes = [HO.to_slow_tier(p[k:], "memkind") if pinned else p[k:]
             for p in pools]
    out_row = torch.tensor([-1, 2, -1], dtype=torch.int32)
    in_row = torch.tensor([4, 0, 1], dtype=torch.int32)
    _launches("migrate", lambda: mkernel.migrate_fire(
        [p[:k] for p in pools], homes, out_row.to(card), in_row.to(card)))
    mops.migrate_fire([w[:k] for w in want], [w[k:] for w in want], out_row,
                      in_row)
    for p, h, w in zip(pools, homes, want):
        assert torch.equal(p[:k].cpu(), w[:k]) and torch.equal(h.cpu(),
                                                               w[k:])


@pytest.mark.cuda
@pytest.mark.parametrize("vacated", [False, True], ids=["free", "vacated"])
def test_fire_home_pinned_on_the_host(card, vacated):
    """A home pool in pinned host memory (``host_offload.to_slow_tier``),
    in both directions: demotions write it, promotions read it over the
    host link; beside a pool whose home is on the card, one launch."""
    k, n, row = 8, 32, (4, 8 * 8 * 128)
    fast, home, out_row, in_row = fire_case(k, n, row, 13, vacated=vacated)
    assert (out_row[out_row < n] >= 0).any() and (in_row[in_row < n]
                                                  >= 0).any()
    f = [_t(fast).to(card), _t(fast).to(card)]
    h = [HO.to_slow_tier(_t(home), "memkind"), _t(home).to(card)]
    assert h[0].is_pinned() and h[0].device.type == "cpu"
    _launches("migrate", lambda: mops.migrate_fire(
        f, h, _t(out_row).to(card), _t(in_row).to(card)))
    wf, wh = _t(fast), _t(home)
    mref.migrate_fire_ref([wf], [wh], _t(out_row), _t(in_row))
    for fi, hi in zip(f, h):
        assert torch.equal(fi.cpu(), wf) and torch.equal(hi.cpu(), wh)
    got, want = _fire_on_card(card, (fast, home, out_row, in_row),
                              pinned=True)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.cuda
def test_fire_keeps_a_dropped_pinned_home_until_the_stream_is_past_it(card):
    """A fire whose demotions write a pinned home, queued behind a spin of
    the stream; the caller drops the home at once and pins a buffer of the
    same size, which the host fills.  The wrapper recorded the fire with
    the caching host allocator, so the new buffer is not the home's block
    and keeps the host's bytes after the stream is done."""
    k, n, words = 8, 16, 1 << 18
    fast = torch.randn((k, words), device=card)
    home = HO.to_slow_tier(torch.zeros((n, words)), "memkind")
    out_row = torch.arange(k, dtype=torch.int32, device=card)
    none = torch.full((k,), -1, dtype=torch.int32, device=card)
    mkernel.migrate_fire([fast], [home], none, none)   # built before the spin
    torch.cuda.synchronize()
    before = _backend.launches["migrate"]
    torch.cuda._sleep(200_000_000)   # about 0.1 s of the stream
    assert mkernel.migrate_fire([fast], [home], out_row, none) is True
    del home                         # no sync until the host's fill is done
    fresh = torch.empty((n, words), pin_memory=True)
    fresh.fill_(7.0)
    torch.cuda.synchronize()
    assert _backend.launches["migrate"] == before + 1
    assert bool((fresh == 7.0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("pinned", [False, True], ids=["card", "pinned"])
def test_fire_random_plans_repeated(card, pinned):
    """Many fires in a row over pools of random row sizes (16-, 4- and
    1-byte words: f16 rows of an odd length, at and around the chunks),
    half of them refilling every slot they vacate, each bit for bit the
    plain fire: a race between blocks or threads would show as a
    differing fire."""
    rng = np.random.default_rng(41)
    for i in range(120):
        k = int(rng.integers(1, 17))
        n = int(rng.integers(2 * k + 2, 4 * k + 8))
        words = int(rng.choice([3, 257, 1024, 1031, 4096, 4100, 8 * 1024,
                                32 * 1024 + 1]))
        case = fire_case(k, n, (words,), int(rng.integers(1 << 30)),
                         (np.float32, np.int32, np.float16)[i % 3],
                         vacated=bool(i % 2))
        got, want = _fire_on_card(card, case, pinned)
        assert all(torch.equal(g, w) for g, w in zip(got, want)), i


@pytest.mark.cuda
def test_fire_refuses_what_it_cannot_take(card):
    fast = torch.zeros((2, 64), device=card)
    tab = torch.full((2,), -1, dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="pinned"):
        mops.migrate_fire([fast], [torch.zeros((4, 64))], tab, tab)
    with pytest.raises(TypeError):
        mkernel.migrate_fire([fast], [torch.zeros((4, 64), device=card,
                                                  dtype=torch.int32)],
                             tab, tab)
    with pytest.raises(ValueError):
        mkernel.migrate_fire([fast], [torch.zeros((4, 64), device=card)],
                             tab[:1], tab[:1])


@pytest.mark.cuda
@pytest.mark.parametrize("copy_back", [True, False], ids=["copy", "nocopy"])
def test_pool_fire_one_launch_a_fire(card, copy_back):
    """``pool_step`` on the card: exactly one ``migrate`` launch a fire for
    buffers of two row shapes, none between fires, and the card's pools,
    plans and residency bit for bit the CPU's."""
    n, k, every, T = 13, 4, 3, 45
    rng = np.random.default_rng(29)
    fused = [(rng.standard_normal((k + n, 2, 36)) * 9).astype(np.float32),
             rng.integers(-99, 99, (k + n, 5)).astype(np.int32)]
    runs = {}
    for dev in ("cpu", card):
        pool = TP.init_pool("arms", n, k, pool_every=every, device=dev)
        bufs = tuple(_t(b).to(dev) for b in fused)
        rng_t = np.random.default_rng(31)
        steps = []
        for t in range(T):
            access = rng_t.random(n).astype(np.float32)
            access[(np.arange(3) + 4 * (t // 15)) % n] += 20.0
            before = _backend.launches["migrate"]
            pool, bufs, plan = TP.pool_step(pool, _t(access).to(dev), 1.0,
                                            1.0, k=k, bufs=bufs,
                                            copy_back=copy_back)
            if dev != "cpu":
                torch.cuda.synchronize()
                fired = pool.period > 0 and pool.t % pool.period == 0
                assert _backend.launches["migrate"] - before == int(fired)
            steps.append([x.cpu().clone() for x in (
                plan.promote, plan.demote, pool.in_fast, pool.slot) + bufs])
        runs[str(dev)] = steps
    for a, b in zip(runs["cpu"], runs[str(card)]):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert int(pool.promos) > k and int(pool.demos) > 0


@pytest.mark.cuda
def test_host_offload_memkind_on_card(card):
    """``memkind`` on a card: a pinned host copy, and a tensor back on the
    card, same values, dtype and shape; ``buffer`` returns its input."""
    assert HO.supports_memkind()
    x = torch.randn((5, 7), device=card).to(torch.bfloat16)
    h = HO.to_slow_tier(x, "memkind")
    assert h.device.type == "cpu" and h.is_pinned()
    assert h.dtype == x.dtype and torch.equal(h, x.cpu())
    assert HO.to_slow_tier(h, "memkind") is h
    back = HO.to_fast_tier(h, "memkind")
    assert back.device.type == "cuda" and torch.equal(back, x)
    assert HO.to_slow_tier(x, "buffer") is x
    assert HO.to_slow_tier(x.cpu(), "memkind").is_pinned()


# ---------------------------------------------------------- paged attention
def _paged_on_card(card, case, dtype=torch.float32):
    q, k, v, tab, lens = case
    args = [_t(q).to(dtype), _t(k).to(dtype), _t(v).to(dtype), _t(tab),
            _t(lens)]
    got = _launches("paged_attention", lambda: pkernel.paged_attention(
        *(a.to(card) for a in args), page_mass=True))
    want = pref.paged_attention_ref(*args, page_mass=True)
    return got, want


def _close(got, want, tol):
    err = (got.cpu().double() - want.double()).abs()
    assert float((err / want.double().abs().clamp_min(1.0)).max()) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("shape", PAGED_SHAPES)
def test_paged_attention_kernel_vs_plain(card, shape):
    (out, mass), (w_out, w_mass) = _paged_on_card(
        card, paged_case(*shape, seed=sum(shape)))
    _close(out, w_out, 1e-5)
    _close(mass, w_mass, 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", PAGED_SHAPES[:2] + [
    (1, 8, 2, 320, 16, 3), (1, 4, 4, 1002, 8, 2), (2, 8, 2, 640, 16, 5)])
def test_paged_attention_kernel_bf16(card, shape):
    """Also head_dim past one column block of a CTA in bf16 (512
    elements)."""
    (out, mass), (w_out, w_mass) = _paged_on_card(
        card, paged_case(*shape, seed=sum(shape)), torch.bfloat16)
    assert out.dtype == torch.bfloat16
    _close(out.float(), w_out.float(), 2e-2)
    _close(mass, w_mass, 2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("pos", [0, 7, 16, 200, 511])
def test_paged_attention_serve_fold_bitwise_repeatable(card, pos):
    """The serving layer's folded view (8 sequences x 32 heads over 8 KV
    heads, 32 pages of 16 tokens): within 1e-5 of the plain version,
    masked pages carry exactly 0 mass, and two runs give the same bits."""
    case = paged_case(1, 256, 64, 128, 16, 32, seed=pos, lens=[pos + 1])
    (out, mass), (w_out, w_mass) = _paged_on_card(card, case)
    _close(out, w_out, 1e-5)
    _close(mass, w_mass, 1e-5)
    assert not mass[0, pos // 16 + 1:].any()
    (out2, mass2), _ = _paged_on_card(card, case)
    assert torch.equal(out, out2) and torch.equal(mass, mass2)


def _masked_pages_carry_no_mass(mass, lens, page):
    for b, n in enumerate(lens):
        if n > 0:
            assert not mass[b, -(-int(n) // page):].any()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", PAGED_EDGE_SHAPES)
def test_paged_attention_kernel_edges(card, shape):
    """Tables no cluster divides, two 16-byte words a lane (head_dim 256),
    element loads without staging (head_dim 6), more than one column block
    (head_dim 320 and 1,002) and 3 query rows a KV head."""
    case = paged_case(*shape, seed=sum(shape))
    (out, mass), (w_out, w_mass) = _paged_on_card(card, case)
    _close(out, w_out, 1e-5)
    _close(mass, w_mass, 1e-5)
    _masked_pages_carry_no_mass(mass, case[4], shape[4])


@pytest.mark.cuda
@pytest.mark.parametrize("cluster", [None, 1, 16])
@pytest.mark.parametrize("lens", [[32768] * 8,
                                  [1, 300, 4097, 32768, 17, 16384, 30000,
                                   0]])
def test_paged_attention_long_table(card, monkeypatch, lens, cluster):
    """A table of 2,048 entries over 8 x 8 (sequence, KV head) clusters,
    granite-8b's 4 query rows a KV head and pages of 16 tokens at 32,768
    tokens a sequence: a CTA's shared memory does not grow with the table,
    so every cluster size launches (the wrapper's choice, and forced 1 and
    16); within 1e-5 of the plain version (run on the card), masked pages
    0, the same bits on two runs."""
    shape = (8, 32, 8, 128, 16, 2048)
    if cluster is not None:
        monkeypatch.setitem(_backend.clusters, pkernel.cluster_key(
            *shape[:3], shape[4], shape[3], shape[5], torch.float32,
            torch.cuda.current_device()), cluster)
    q, k, v, tab, ln = (_t(a).to(card) for a in paged_case(
        *shape, seed=len(set(lens)), lens=lens, pool=64))
    run = lambda: _launches("paged_attention", lambda: (
        pkernel.paged_attention(q, k, v, tab, ln, page_mass=True)))
    out, mass = run()
    w_out, w_mass = pref.paged_attention_ref(q, k, v, tab, ln, page_mass=True)
    _close(out, w_out.cpu(), 1e-5)
    _close(mass, w_mass.cpu(), 1e-5)
    _masked_pages_carry_no_mass(mass.cpu(), lens, 16)
    out2, mass2 = run()
    assert torch.equal(out, out2) and torch.equal(mass, mass2)


@pytest.mark.cuda
@pytest.mark.parametrize("lens", [[0, 17, 144], [1, 144, 70]])
def test_paged_attention_lengths_differ(card, lens):
    """B > 1 with a length each (0: every token masked, the mean of V)."""
    case = paged_case(3, 16, 4, 128, 16, 9, seed=len(lens), lens=lens)
    (out, mass), (w_out, w_mass) = _paged_on_card(card, case)
    _close(out, w_out, 1e-5)
    _close(mass, w_mass, 1e-5)
    _masked_pages_carry_no_mass(mass, lens, 16)


@pytest.mark.cuda
@pytest.mark.parametrize("cluster", [1, 2, 3, 7, 16])
@pytest.mark.parametrize("shape,pos", [((1, 256, 64, 128, 16, 32), 511),
                                       ((1, 256, 64, 128, 16, 32), 100),
                                       ((2, 8, 4, 128, 16, 5), None)])
def test_paged_attention_every_cluster_size(card, monkeypatch, shape, pos,
                                            cluster):
    """A (sequence, KV head) over a forced number of CTAs, CTAs past the
    table's end included: within 1e-5, masked pages 0, and the same bits
    on two runs."""
    B, H, KV, dh, page, n_pp = shape
    monkeypatch.setitem(_backend.clusters, pkernel.cluster_key(
        B, H, KV, page, dh, n_pp, torch.float32,
        torch.cuda.current_device()), cluster)
    case = paged_case(*shape, seed=cluster,
                      lens=None if pos is None else [pos + 1])
    (out, mass), (w_out, w_mass) = _paged_on_card(card, case)
    _close(out, w_out, 1e-5)
    _close(mass, w_mass, 1e-5)
    _masked_pages_carry_no_mass(mass, case[4], page)
    (out2, mass2), _ = _paged_on_card(card, case)
    assert torch.equal(out, out2) and torch.equal(mass, mass2)


@pytest.mark.cuda
@pytest.mark.parametrize("pos", [15, 511])
def test_paged_attention_serve_fold_bf16(card, pos):
    """The serving fold in bf16: within 2e-2, masked pages 0, repeatable."""
    case = paged_case(1, 256, 64, 128, 16, 32, seed=pos, lens=[pos + 1])
    (out, mass), (w_out, w_mass) = _paged_on_card(card, case, torch.bfloat16)
    assert out.dtype == torch.bfloat16
    _close(out.float(), w_out.float(), 2e-2)
    _close(mass, w_mass, 2e-2)
    _masked_pages_carry_no_mass(mass, [pos + 1], 16)
    (out2, mass2), _ = _paged_on_card(card, case, torch.bfloat16)
    assert torch.equal(out, out2) and torch.equal(mass, mass2)


@pytest.mark.cuda
def test_out_of_range_indices_stay_inside_the_pools(card):
    """Migrate skips entries with an out-of-range index; paged attention
    clamps out-of-range table entries; both as their plain versions."""
    src, dst, _, _, _ = migrate_pools_case(9, 7, 5, 3, 5, seed=21)
    out_row = np.array([9, -2, 12, 40, -1, 2, 10], np.int32)
    in_row = np.array([-5, 9, 99, -1, 10, 3, 2 ** 31 - 1], np.int32)
    got, want = _fire_on_card(card, (dst, src, out_row, in_row))
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert torch.equal(got[1][2], _t(dst)[5]) and torch.equal(got[0][5],
                                                             _t(src)[3])
    case = list(paged_case(2, 8, 4, 128, 16, 4, seed=3))
    case[3][0, 1] = case[1].shape[0] + 5
    (out, mass), (w_out, w_mass) = _paged_on_card(card, case)
    _close(out, w_out, 1e-5)
    _close(mass, w_mass, 1e-5)


# ---------------------------------------------------------- flash attention
from _torch_cases import FAMILY_FLASH_SHAPES  # noqa: E402
from _torch_cases import FLASH_SHAPES, flash_case  # noqa: E402
from _torch_cases import MLA_FLASH_SHAPES  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fkernel  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fops  # noqa: E402
from repro_torch.kernels.flash_attention import ref as fref  # noqa: E402


def _flash_on_card(card, shape, dtype, dv=None):
    """Kernel forward and backward on the card, and the plain version's
    output and autograd gradient computed in f32 from the same (rounded)
    inputs; v ``dv`` wide (q's width by default)."""
    B, S, H, KV, dh, causal, window = shape
    q, k, v, do = (_t(a).to(card, dtype)
                   for a in flash_case(B, S, H, KV, dh, sum(shape) + (dv or 0),
                                       dv))
    kw = dict(causal=causal, window=window)
    out, lse = _launches("flash_attention_fwd",
                         lambda: fkernel.flash_attention_fwd(q, k, v, **kw))
    grads = _launches("flash_attention_bwd",
                      lambda: fkernel.flash_attention_bwd(q, k, v, out, lse,
                                                          do, **kw))
    qf, kf, vf = (x.float().clone().requires_grad_() for x in (q, k, v))
    want = fref.flash_attention_ref(qf, kf, vf, **kw)
    wgrads = torch.autograd.grad(want, (qf, kf, vf), do.float())
    return (q, k, v, do), (out, lse, grads), (want.detach(), wgrads)


def _within_of_max(got, want, tol, scale=None):
    """max |got - want| <= tol x max |want| (or x ``scale``)."""
    err = float((got.double() - want.double()).abs().max())
    if scale is None:
        scale = float(want.double().abs().max())
    assert err <= tol * scale, err


def _grads_within(grads, wgrads, tol):
    """Each gradient within ``tol`` of its largest entry.  A gradient that
    is exactly zero in the plain version (window 1: each query sees only
    its own key, so the scores carry no gradient) is held to ``tol`` times
    the largest entry of the three: the kernel's dS = P (dP - Delta) is
    then a difference of two equal sums in f32."""
    top = max(float(w.double().abs().max()) for w in wgrads)
    for g, w in zip(grads, wgrads):
        _within_of_max(g.float(), w, tol,
                       None if bool(w.any()) else top)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", FLASH_SHAPES)
def test_flash_attention_kernel_vs_plain_f32(card, shape):
    _, (out, lse, grads), (want, wgrads) = _flash_on_card(card, shape,
                                                          torch.float32)
    _within_of_max(out, want, 2e-5)
    _grads_within(grads, wgrads, 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", FLASH_SHAPES)
def test_flash_attention_kernel_vs_plain_bf16(card, shape):
    """bf16 in and out: the output within 2e-2, each gradient within 2e-2
    of its largest entry (the bf16 tolerance of tests/test_kernels.py)."""
    _, (out, lse, grads), (want, wgrads) = _flash_on_card(card, shape,
                                                          torch.bfloat16)
    assert out.dtype == torch.bfloat16 and grads[0].dtype == torch.bfloat16
    assert float((out.float() - want).abs().max()) <= 2e-2
    _grads_within(grads, wgrads, 2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [FLASH_SHAPES[3], FLASH_SHAPES[7]])
def test_flash_attention_lse_and_repeatable_backward(card, shape):
    """The row log-sum-exp matches the masked scores' logsumexp, and two
    backward runs give the same bits (no atomics)."""
    B, S, H, KV, dh, causal, window = shape
    (q, k, v, do), (out, lse, grads), _ = _flash_on_card(card, shape,
                                                         torch.float32)
    rep = H // KV
    s = torch.einsum("bqkrd,bskd->bkrqs", q.reshape(B, S, KV, rep, dh),
                     k) * dh ** -0.5
    qi = torch.arange(S, device=card)[:, None]
    kj = torch.arange(S, device=card)[None, :]
    mask = (kj <= qi) if causal else torch.ones_like(qi - kj, dtype=bool)
    if window:
        mask &= kj > qi - window
    want = torch.logsumexp(torch.where(mask, s, -1e30), dim=-1)
    _within_of_max(lse, want.reshape(B, H, S), 1e-5)
    again = fkernel.flash_attention_bwd(q, k, v, out, lse, do,
                                        causal=causal, window=window)
    for g, h in zip(grads, again):
        assert torch.equal(g, h)


@pytest.mark.cuda
def test_flash_attention_op_routes_both_passes_through_the_kernels(card):
    """``ops.flash_attention`` on CUDA tensors: the forward and, through
    autograd, the backward are the kernels' (same bits as calling them),
    one launch each."""
    B, S, H, KV, dh = 2, 70, 8, 2, 64
    q, k, v, do = (_t(a).to(card, torch.bfloat16)
                   for a in flash_case(B, S, H, KV, dh, 5))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    before = dict(_backend.launches)
    out = fops.flash_attention(*leaves)
    grads = torch.autograd.grad(out, leaves, do)
    torch.cuda.synchronize()
    for nm in ("flash_attention_fwd", "flash_attention_bwd"):
        assert _backend.launches[nm] == before.get(nm, 0) + 1
    w_out, lse = fkernel.flash_attention_fwd(q, k, v)
    assert torch.equal(out.detach(), w_out)
    for g, w in zip(grads, fkernel.flash_attention_bwd(q, k, v, w_out, lse,
                                                       do)):
        assert torch.equal(g, w)


@pytest.mark.cuda
def test_flash_attention_rejects_bad_inputs(card):
    q = torch.zeros((1, 8, 4, 64), device=card)
    with pytest.raises(ValueError):          # head_dim 32 is not built
        fkernel.flash_attention_fwd(q[..., :32].contiguous(),
                                    q[..., :32].contiguous(),
                                    q[..., :32].contiguous())
    with pytest.raises(TypeError):
        fkernel.flash_attention_fwd(q.double(), q.double(), q.double())
    with pytest.raises(ValueError):
        fkernel.flash_attention_fwd(q, q.cpu(), q)
    with pytest.raises(ValueError):          # H not a multiple of KV
        fkernel.flash_attention_fwd(q, q[:, :, :3].contiguous(),
                                    q[:, :, :3].contiguous())
    with pytest.raises(ValueError):
        fkernel.flash_attention_fwd(q.transpose(1, 2), q, q)


# bf16 on the tensor cores at tile edges: S around the 64-row tiles (1, 63,
# 65, 127, 129) and the training length, every head width, GQA rep 4, a
# 1,024 window and non-causal rows
FLASH_TC_SHAPES = ([(2, S, 8, 2, dh, True, 0) for S in (1, 63, 65, 127, 129)
                    for dh in (16, 64, 128)]
                   + [(1, 4096, 4, 1, dh, True, 0) for dh in (16, 64, 128)]
                   + [(1, 4096, 4, 1, 64, True, 1024),
                      (1, 1500, 8, 2, 128, True, 1024),
                      (2, 129, 8, 2, 64, False, 0),
                      (1, 4096, 4, 1, 128, False, 0)])


@pytest.mark.cuda
@pytest.mark.parametrize("shape", FLASH_TC_SHAPES)
def test_flash_attention_bf16_tile_edges(card, shape):
    """The bf16 route (wgmma, TMA tiles zero-filled past S) within 2e-2 of
    the plain version in f32 from the same inputs, the same bits from two
    backward runs, and the row log-sum-exp finite on every row."""
    B, S, H, KV, dh, causal, window = shape
    (q, k, v, do), (out, lse, grads), (want, wgrads) = _flash_on_card(
        card, shape, torch.bfloat16)
    assert float((out.float() - want).abs().max()) <= 2e-2
    _grads_within(grads, wgrads, 2e-2)
    assert bool(torch.isfinite(lse).all())
    again = fkernel.flash_attention_bwd(q, k, v, out, lse, do,
                                        causal=causal, window=window)
    for g, h in zip(grads, again):
        assert torch.equal(g, h)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", FAMILY_FLASH_SHAPES)
def test_flash_attention_at_the_families_prefill_shapes(card, shape):
    """bf16 at the vlm and MoE families' prefill shapes (S 4,672, a
    multiple of 64 with 576 patch rows in front; 40 query heads over 8
    KV heads, with and without an effective window): the output within
    2e-2 of the plain version in f32, each output row within 1e-2 of its
    own norm, each gradient within 2e-2 of its largest entry, and the same
    bits from two backward runs."""
    B, S, H, KV, dh, causal, window = shape
    (q, k, v, do), (out, lse, grads), (want, wgrads) = _flash_on_card(
        card, shape, torch.bfloat16)
    assert float((out.float() - want).abs().max()) <= 2e-2
    row = ((out.float() - want).norm(dim=-1)
           / want.norm(dim=-1).clamp_min(1e-30))
    assert float(row.max()) <= 1e-2
    _grads_within(grads, wgrads, 2e-2)
    again = fkernel.flash_attention_bwd(q, k, v, out, lse, do,
                                        causal=causal, window=window)
    for g, h in zip(grads, again):
        assert torch.equal(g, h)


@pytest.mark.cuda
@pytest.mark.parametrize("dh", [16, 128])
def test_flash_attention_op_routes_bf16_head_widths(card, dh):
    """``ops.flash_attention`` in bf16 at the head widths beside 64: one
    launch of each kernel, and the kernels' own bits."""
    B, S, H, KV = 1, 100, 8, 2
    q, k, v, do = (_t(a).to(card, torch.bfloat16)
                   for a in flash_case(B, S, H, KV, dh, dh))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    before = dict(_backend.launches)
    out = fops.flash_attention(*leaves)
    grads = torch.autograd.grad(out, leaves, do)
    torch.cuda.synchronize()
    for nm in ("flash_attention_fwd", "flash_attention_bwd"):
        assert _backend.launches[nm] == before.get(nm, 0) + 1
    w_out, lse = fkernel.flash_attention_fwd(q, k, v)
    assert torch.equal(out.detach(), w_out)
    for g, w in zip(grads, fkernel.flash_attention_bwd(q, k, v, w_out, lse,
                                                       do)):
        assert torch.equal(g, w)


@pytest.mark.cuda
def test_flash_attention_bf16_alignment(card):
    """The TMA tiles need 16-byte aligned bf16 tensors: the wrapper refuses
    a tensor that starts off such a boundary, the op copies it."""
    q, k, v, _ = (_t(a).to(card, torch.bfloat16)
                  for a in flash_case(1, 40, 4, 4, 64, 3))
    flat = torch.empty(q.numel() + 1, dtype=torch.bfloat16, device=card)
    odd = flat[1:].view(q.shape)
    odd.copy_(q)
    assert odd.is_contiguous() and odd.data_ptr() % 16
    with pytest.raises(ValueError):
        fkernel.flash_attention_fwd(odd, k, v)
    assert torch.equal(fops.flash_attention(odd, k, v),
                       fkernel.flash_attention_fwd(q, k, v)[0])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", MLA_FLASH_SHAPES)
def test_flash_attention_unequal_widths_vs_plain(card, shape, dtype):
    """q and k ``dq`` wide, v ``dv`` wide (MLA's pairs) and whisper's
    encoder: forward and backward against the plain version in f32 from
    the same inputs (f32 output within 2e-5 and gradients within 1e-4 of
    the largest entry; bf16 within 2e-2), the output and dV ``dv`` wide,
    dQ and dK ``dq`` wide, and the same bits from two backward runs."""
    B, S, H, KV, dq, dv, causal, window = shape
    (q, k, v, do), (out, lse, grads), (want, wgrads) = _flash_on_card(
        card, (B, S, H, KV, dq, causal, window), dtype, dv)
    assert out.shape == (B, S, H, dv) and out.dtype == dtype
    assert [g.shape[-1] for g in grads] == [dq, dq, dv]
    if dtype == torch.float32:
        _within_of_max(out, want, 2e-5)
        _grads_within(grads, wgrads, 1e-4)
    else:
        assert float((out.float() - want).abs().max()) <= 2e-2
        _grads_within(grads, wgrads, 2e-2)
    assert bool(torch.isfinite(lse).all())
    again = fkernel.flash_attention_bwd(q, k, v, out, lse, do,
                                        causal=causal, window=window)
    for g, h in zip(grads, again):
        assert torch.equal(g, h)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_op_routes_unequal_widths(card, dtype):
    """``ops.flash_attention`` at deepseek-v2's (192, 128): one launch of
    each kernel, the kernels' own bits, and a pair outside ``HEAD_DIMS``
    (v of another width than its pair's) raises in both passes'
    wrapper."""
    q, k, v, do = (_t(a).to(card, dtype)
                   for a in flash_case(1, 70, 4, 2, 192, 9, dv=128))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    before = dict(_backend.launches)
    out = fops.flash_attention(*leaves)
    grads = torch.autograd.grad(out, leaves, do)
    torch.cuda.synchronize()
    for nm in ("flash_attention_fwd", "flash_attention_bwd"):
        assert _backend.launches[nm] == before.get(nm, 0) + 1
    w_out, lse = fkernel.flash_attention_fwd(q, k, v)
    assert torch.equal(out.detach(), w_out)
    for g, w in zip(grads, fkernel.flash_attention_bwd(q, k, v, w_out, lse,
                                                       do)):
        assert torch.equal(g, w)
    for dq, dv in ((192, 64), (128, 192), (32, 32), (64, 16)):
        qq, kk, vv, dd = (_t(a).to(card, dtype)
                          for a in flash_case(1, 8, 2, 2, dq, 1, dv=dv))
        with pytest.raises(ValueError, match="head widths"):
            fkernel.flash_attention_fwd(qq, kk, vv)
        with pytest.raises(ValueError, match="head widths"):
            fops.flash_attention(qq, kk, vv)
        with pytest.raises(ValueError, match="head widths"):
            fkernel.flash_attention_bwd(qq, kk, vv, dd, torch.zeros(
                (1, 2, 8), device=card), dd)


# ------------------------------------------------------------- score update
from repro_torch.kernels.score_update import kernel as ukernel  # noqa: E402
from repro_torch.kernels.score_update import ops as uops  # noqa: E402


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 3, 17, 1000, 4099, 1 << 20])
@pytest.mark.parametrize("offset", [0, 1])
def test_score_update_kernel_vs_plain_bitwise(card, n, offset):
    """All three outputs equal the plain version's bits (one lane of the
    interval step's EWMA), at ragged n and on rows that start one element
    past a 16-byte boundary."""
    rng = np.random.default_rng(n + offset)
    rows = [torch.from_numpy(rng.random(n + offset, dtype=np.float32) * 50)
            for _ in range(2)]
    rows.append(torch.from_numpy(
        rng.poisson(3, n + offset).astype(np.float32)))
    rows = [r.to(card)[offset:] for r in rows]
    params = torch.tensor([0.3, 0.05, 0.6, 0.4], device=card)
    got = _launches("score_update",
                    lambda: ukernel.score_update(*rows, params))
    want = [w[0] for w in ref.ewma_score_update_ref(
        *(r[None] for r in rows), params[None])]
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    via_op = uops.score_update(*rows, alpha_s=0.3, alpha_l=0.05, w_s=0.6,
                               w_l=0.4)
    for g, w in zip(via_op, got):
        assert torch.equal(g, w)


@pytest.mark.cuda
def test_score_update_rejects_bad_inputs(card):
    x = torch.zeros(8, device=card)
    p = torch.zeros(4, device=card)
    with pytest.raises(ValueError):
        ukernel.score_update(x, x.cpu(), x, p)
    with pytest.raises(TypeError):
        ukernel.score_update(x.double(), x, x, p)
    with pytest.raises(ValueError):
        ukernel.score_update(x, x[:4], x, p)
    with pytest.raises(ValueError):
        ukernel.score_update(x, x, x, p[:3])
    with pytest.raises(ValueError):
        ukernel.score_update(x[::2], x[::2], x[::2], p)


# --------------------------------------------------------------- mamba scan
from _torch_cases import HYBRID_TRAIN_SHAPE  # noqa: E402
from _torch_cases import MAMBA_SHAPES, MAMBA_TRAIN_SHAPE  # noqa: E402
from _torch_cases import mamba_case  # noqa: E402
from repro_torch.kernels.mamba_scan import kernel as skernel  # noqa: E402
from repro_torch.kernels.mamba_scan import ops as sops  # noqa: E402
from repro_torch.kernels.mamba_scan import ref as sref  # noqa: E402


def _cs_ulp(dt, A, Q) -> float:
    """One f32 ulp of the largest chunk cumsum of dt * A: the kernel sums
    it in f64 (as the CPU's ``torch.cumsum`` does), the plain version on
    the card with ``torch.cumsum`` in f32, and ``exp`` turns that
    last-ulp difference of a decay exponent into a relative error of the
    decay."""
    B, S, H = dt.shape
    cs = torch.cumsum((dt * A).double().reshape(B, S // Q, Q, H), dim=2)
    return float(np.spacing(np.float32(cs.abs().max().item())))


def _scan_on_card(card, shape, dtype, model_like=False):
    """The kernels' forward and backward (cotangents of y and h_final) on
    the card, and the plain version's outputs and autograd gradients in
    f32 from the same (rounded) inputs."""
    B, S, H, P, N, Q = shape
    x, dt, A, Bm, Cm, dy, dh = mamba_case(B, S, H, P, N, sum(shape),
                                          model_like)
    x, dy = _t(x).to(card, dtype), _t(dy).to(card, dtype)
    dt, A, Bm, Cm, dh = (_t(a).to(card) for a in (dt, A, Bm, Cm, dh))
    y, h = _launches("mamba_scan_fwd", lambda: skernel.mamba_scan_fwd(
        x, dt, A, Bm, Cm, chunk=Q))
    grads = _launches("mamba_scan_bwd", lambda: skernel.mamba_scan_bwd(
        x, dt, A, Bm, Cm, dy, dh, chunk=Q))
    leaves = [a.float().clone().requires_grad_() for a in (x, dt, A, Bm,
                                                           Cm)]
    wy, wh = sref.mamba_scan_ref(*leaves, Q)
    wgrads = torch.autograd.grad((wy, wh), leaves, (dy.float(), dh))
    return (x, dt, A, Bm, Cm, dy, dh), (y, h, grads), \
        (wy.detach(), wh.detach(), wgrads), _cs_ulp(dt, A, Q)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", MAMBA_SHAPES + [MAMBA_TRAIN_SHAPE])
def test_mamba_scan_kernel_vs_plain_f32(card, shape):
    """y and h_final within 2e-5 + 4 ulp(max |cs|) of their largest
    entries, each gradient within 1e-4 + 8 ulp(max |cs|) of its largest
    entry (sums over chunks, heads and positions in another order; dA
    sums all B x S of them).  The training shape draws dt and A as
    mamba2-370m's init gives them."""
    model_like = shape == MAMBA_TRAIN_SHAPE
    _, (y, h, grads), (wy, wh, wgrads), ulp = _scan_on_card(
        card, shape, torch.float32, model_like)
    _within_of_max(y, wy, 2e-5 + 4 * ulp)
    _within_of_max(h, wh, 2e-5 + 4 * ulp)
    for g, w in zip(grads, wgrads):
        assert g.dtype == w.dtype and g.shape == w.shape
        _within_of_max(g, w, 1e-4 + 8 * ulp)


@pytest.mark.cuda
def test_mamba_scan_at_zamba2s_training_shape(card):
    """zamba2-1.2b's scan (H 64, P 64, N 64: the backward's N walk is one
    block, P the widest frame it takes) with dt and A as its init gives
    them: forward and backward within the f32 tolerances above, and the
    same bits from two backward runs."""
    ins, (y, h, grads), (wy, wh, wgrads), ulp = _scan_on_card(
        card, HYBRID_TRAIN_SHAPE, torch.float32, model_like=True)
    _within_of_max(y, wy, 2e-5 + 4 * ulp)
    _within_of_max(h, wh, 2e-5 + 4 * ulp)
    for g, w in zip(grads, wgrads):
        _within_of_max(g, w, 1e-4 + 8 * ulp)
    again = skernel.mamba_scan_bwd(*ins, chunk=HYBRID_TRAIN_SHAPE[-1])
    for g, a in zip(grads, again):
        assert torch.equal(g, a)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", MAMBA_SHAPES)
def test_mamba_scan_kernel_vs_plain_bf16(card, shape):
    """bf16 x, y, dy and dx (the rest f32): y within 2e-2 absolutely and
    relatively (the bf16 tolerance of tests/test_kernels.py), each
    gradient within 2e-2 of its largest entry."""
    _, (y, h, grads), (wy, wh, wgrads), ulp = _scan_on_card(
        card, shape, torch.bfloat16)
    assert y.dtype == torch.bfloat16 and grads[0].dtype == torch.bfloat16
    assert bool(((y.float() - wy).abs() <= 2e-2 + 2e-2 * wy.abs()).all())
    _within_of_max(h, wh, 2e-5 + 4 * ulp)
    for g, w in zip(grads, wgrads):
        _within_of_max(g.float(), w, 2e-2)


# an odd chunk count (5) at mamba2-370m's widths, and widths the 4 x 4
# register tiles and 64-wide frames do not divide: P 18, N 30, chunk 10
# (7 chunks); P 35, N 99 (two column blocks, P N odd: the chunk walk's
# one-element route and the scalar stores), chunk 12
MAMBA_EDGE_SHAPES = [(2, 320, 4, 64, 128, 64), (2, 70, 3, 18, 30, 10),
                     (1, 96, 2, 35, 99, 12)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", MAMBA_EDGE_SHAPES)
def test_mamba_scan_kernel_edges_f32(card, shape):
    """The f32 gates of ``test_mamba_scan_kernel_vs_plain_f32`` at chunk
    counts and widths off the tiles."""
    _, (y, h, grads), (wy, wh, wgrads), ulp = _scan_on_card(
        card, shape, torch.float32, True)
    _within_of_max(y, wy, 2e-5 + 4 * ulp)
    _within_of_max(h, wh, 2e-5 + 4 * ulp)
    for g, w in zip(grads, wgrads):
        assert g.dtype == w.dtype and g.shape == w.shape
        _within_of_max(g, w, 1e-4 + 8 * ulp)


# forward-only shapes past the backward's one frame: P and the chunk over
# 64 (two frames each way, the second ragged), N off the column blocks
MAMBA_FWD_SHAPES = [(1, 256, 2, 72, 32, 128), (2, 200, 3, 70, 21, 100)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", MAMBA_FWD_SHAPES + [MAMBA_TRAIN_SHAPE])
def test_mamba_scan_forward_frames_and_repeatable(card, shape, dtype):
    """The forward over several output frames (and at the training shape)
    against the plain version in f32 from the same inputs: h_final within
    2e-5 + 4 ulp(max |cs|) of its largest entry, y too in f32 and within
    2e-2 absolutely and relatively in bf16; two runs give the same bits."""
    B, S, H, P, N, Q = shape
    model_like = shape == MAMBA_TRAIN_SHAPE
    x, dt, A, Bm, Cm, _, _ = mamba_case(B, S, H, P, N, sum(shape),
                                        model_like)
    x = _t(x).to(card, dtype)
    dt, A, Bm, Cm = (_t(a).to(card) for a in (dt, A, Bm, Cm))
    y, h = _launches("mamba_scan_fwd", lambda: skernel.mamba_scan_fwd(
        x, dt, A, Bm, Cm, chunk=Q))
    wy, wh = sref.mamba_scan_ref(x.float(), dt, A, Bm, Cm, Q)
    ulp = _cs_ulp(dt, A, Q)
    assert y.dtype == dtype and y.shape == x.shape
    _within_of_max(h, wh, 2e-5 + 4 * ulp)
    if dtype == torch.float32:
        _within_of_max(y, wy, 2e-5 + 4 * ulp)
    else:
        assert bool(((y.float() - wy).abs() <= 2e-2 + 2e-2 * wy.abs()).all())
    y2, h2 = skernel.mamba_scan_fwd(x, dt, A, Bm, Cm, chunk=Q)
    assert torch.equal(y, y2) and torch.equal(h, h2)


@pytest.mark.cuda
def test_mamba_scan_backward_rejects_wide_frames(card):
    """The backward holds P and the chunk within one 64-wide frame."""
    x, dt, A, Bm, Cm, dy, _ = (_t(a).to(card) for a in mamba_case(
        1, 128, 1, 65, 8, 0))
    with pytest.raises(ValueError):
        skernel.mamba_scan_bwd(x, dt, A, Bm, Cm, dy, chunk=64)
    x, dt, A, Bm, Cm, dy, _ = (_t(a).to(card) for a in mamba_case(
        1, 128, 1, 8, 8, 0))
    with pytest.raises(ValueError):
        skernel.mamba_scan_bwd(x, dt, A, Bm, Cm, dy, chunk=128)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [MAMBA_SHAPES[0], MAMBA_TRAIN_SHAPE,
                                   MAMBA_EDGE_SHAPES[1]])
def test_mamba_scan_backward_is_repeatable(card, shape):
    """Two backward runs (and two forward runs) give the same bits: no
    atomics, every sum in a fixed order."""
    B, S, H, P, N, Q = shape
    x, dt, A, Bm, Cm, dy, _ = (_t(a).to(card) for a in mamba_case(
        B, S, H, P, N, 1, model_like=True))
    a = skernel.mamba_scan_bwd(x, dt, A, Bm, Cm, dy, chunk=Q)
    b = skernel.mamba_scan_bwd(x, dt, A, Bm, Cm, dy, chunk=Q)
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    assert all(torch.equal(u, v) for u, v in zip(
        skernel.mamba_scan_fwd(x, dt, A, Bm, Cm, chunk=Q),
        skernel.mamba_scan_fwd(x, dt, A, Bm, Cm, chunk=Q)))


@pytest.mark.cuda
def test_mamba_scan_op_routes_both_passes_through_the_kernels(card):
    """``ops.mamba_scan`` on CUDA tensors: the forward and, through
    autograd, the backward are the kernels' (same bits as calling them),
    one launch each; an unused h_final sends no cotangent (the kernel's
    zero)."""
    B, S, H, P, N, Q = MAMBA_SHAPES[3]
    x, dt, A, Bm, Cm, dy, _ = (_t(a).to(card) for a in mamba_case(
        B, S, H, P, N, 7))
    leaves = [a.clone().requires_grad_() for a in (x, dt, A, Bm, Cm)]
    before = dict(_backend.launches)
    y, _ = sops.mamba_scan(*leaves, chunk=Q)
    grads = torch.autograd.grad(y, leaves, dy)
    torch.cuda.synchronize()
    for nm in ("mamba_scan_fwd", "mamba_scan_bwd"):
        assert _backend.launches[nm] == before.get(nm, 0) + 1
    assert torch.equal(y.detach(), skernel.mamba_scan_fwd(
        x, dt, A, Bm, Cm, chunk=Q)[0])
    for g, w in zip(grads, skernel.mamba_scan_bwd(x, dt, A, Bm, Cm, dy,
                                                  chunk=Q)):
        assert torch.equal(g, w)


@pytest.mark.cuda
def test_mamba_scan_rejects_bad_inputs(card):
    x, dt, A, Bm, Cm, dy, _ = (_t(a).to(card) for a in mamba_case(
        1, 16, 2, 8, 4, 0))
    fwd = skernel.mamba_scan_fwd
    with pytest.raises(ValueError):          # on the CPU
        fwd(x.cpu(), dt, A, Bm, Cm, chunk=8)
    with pytest.raises(ValueError):
        fwd(x, dt, A.cpu(), Bm, Cm, chunk=8)
    with pytest.raises(TypeError):           # f64 x
        fwd(x.double(), dt, A, Bm, Cm, chunk=8)
    with pytest.raises(ValueError):          # bf16 dt
        fwd(x, dt.bfloat16(), A, Bm, Cm, chunk=8)
    with pytest.raises(ValueError):          # S not a multiple of the chunk
        fwd(x, dt, A, Bm, Cm, chunk=5)
    with pytest.raises(ValueError):          # dt of another length
        fwd(x, dt[:, :8].contiguous(), A, Bm, Cm, chunk=8)
    with pytest.raises(ValueError):          # non-contiguous x
        fwd(x.transpose(1, 2).contiguous().transpose(1, 2), dt, A, Bm, Cm,
            chunk=8)
    with pytest.raises(ValueError):          # too much shared memory
        big = torch.zeros((1, 128, 1, 128), device=card)
        bc = torch.zeros((1, 128, 256), device=card)
        fwd(big, torch.ones((1, 128, 1), device=card), A[:1], bc, bc,
            chunk=128)
    with pytest.raises(ValueError):          # dy of another dtype
        skernel.mamba_scan_bwd(x, dt, A, Bm, Cm, dy.bfloat16(), chunk=8)
    with pytest.raises(ValueError):          # dh_final of another shape
        skernel.mamba_scan_bwd(x, dt, A, Bm, Cm, dy, dy, chunk=8)


# ------------------------------------------ threefry and trace synthesis
# Plain torch on both devices (no kernel of their own): the card must give
# the CPU's bits, so a synthesized replay on the card is the CPU's.
from repro_torch.simulator import scan_engine as pscan  # noqa: E402
from repro_torch.simulator import scenarios as pscen  # noqa: E402
from repro_torch.simulator import workload_spec as pws  # noqa: E402
from repro_torch.baselines.arms_policy import ARMSSpec  # noqa: E402
from repro_torch.utils import prng  # noqa: E402

PRNG_DRAWS = {
    "split": lambda k, n: prng.split(k, 3),
    "fold_in": lambda k, n: prng.fold_in(k, torch.arange(3)),
    "bits": lambda k, n: prng.random_bits(k, (n,)),
    "uniform": lambda k, n: prng.uniform(k, (n,)),
    "uniform_range": lambda k, n: prng.uniform(k, (n,), -2.0, 5.0),
    "permutation": lambda k, n: prng.permutation(k, n),
}


@pytest.mark.cuda
@pytest.mark.parametrize("draw", sorted(PRNG_DRAWS))
@pytest.mark.parametrize("n", [1, 5, 1626, 4096, 65536])
def test_prng_card_equals_cpu(card, draw, n):
    keys = torch.stack([prng.PRNGKey(s) for s in (0, 7, 12345)])
    fn = PRNG_DRAWS[draw]
    assert torch.equal(fn(keys.to(card), n).cpu(), fn(keys, n))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [4096, 65536])
def test_synthesized_rows_card_equal_cpu(card, n):
    specs = [pws.named(nm, T=48) for nm in pws.NAMED_WORKLOADS] \
        + pscen.suite(n, n // 8)
    for s in specs:
        cpu = s.materialize(48, n, 3, device="cpu")
        gpu = s.materialize(48, n, 3, device=card)
        np.testing.assert_array_equal(cpu.view(np.int32), gpu.view(np.int32))


@pytest.mark.cuda
def test_synthesized_sweep_card_equals_cpu(card):
    wls = [pws.named(nm, T=96) for nm in ("gups", "silo-tpcc", "gapbs-bc",
                                          "liblinear")]
    configs = [dict(alpha_s=0.5), dict(alpha_s=0.8)]
    fam = lambda **kw: ARMSSpec.make(kw)
    cpu = pscan.sweep_workload_configs(fam, configs, wls, "pmem-large", 512,
                                       96, 4096, sim_seed=1, device="cpu")
    gpu = pscan.sweep_workload_configs(fam, configs, wls, "pmem-large", 512,
                                       96, 4096, sim_seed=1, device=card)
    for rc, rg in zip(cpu, gpu):
        for a, b in zip(rc, rg):
            assert (a.promotions, a.demotions, a.wasteful) == \
                (b.promotions, b.demotions, b.wasteful)
            np.testing.assert_allclose(a.exec_time_s, b.exec_time_s,
                                       rtol=1e-4)


# --------------------------------------- the tuning study's lane counts
# The tuning study launches the interval-step kernels at the nine named
# workloads x 24, 20 and 16 configs (216, 180 and 144 lanes) of 65,536
# pages, where each chooser picks another cluster size than at the
# replay's 16 lanes: the kernels at the chooser's own pick, held to the
# plain versions.
STUDY_LANES = [144, 180, 216]


@pytest.mark.cuda
@pytest.mark.parametrize("B", STUDY_LANES)
def test_interval_step_kernels_at_the_study_lanes(card, B):
    n, k = 65536, 8192
    x = _topk_case(B, n, k, "ties")
    got = _launches("topk_mask", lambda: kernel.topk_mask(_t(x).to(card), k))
    assert torch.equal(got.cpu(), ref.topk_mask_ref(_t(x), k))
    got, want = _account_on_card(card, "pmem-large", B, n, False)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    for P, D in ((12, 12), (12, k)):         # HeMem/Memtis's and TPP's
        got, want = _migrate_on_card(card, migrate_case(B, n, 2, P, D, B))
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w)
    s, l, c, params = _ewma_case(B, n, B)
    got = _launches("ewma_update", lambda: kernel.ewma_update(
        _t(s).to(card), _t(l).to(card), _t(c).to(card), _t(params).to(card)))
    want = ref.ewma_score_update_ref(_t(s), _t(l), _t(c), _t(params))
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.cuda
def test_sweep_and_grid_search_card_equal_cpu(card):
    """A synthesized 2-seed sweep over a mixed 2/3-tier panel, and a grid
    search over three workloads: card == CPU (counts exact, exec_time
    within 1e-4 relative, rankings equal)."""
    from repro_torch.simulator import experiment, search
    kw = dict(workloads=["gups", "silo-tpcc"],
              machines=["pmem-large", "dram-cxl-pmem"], seeds=[0, 1], k=512,
              T=96, n=4096, dispatch="grouped")
    cpu, gpu = (experiment.sweep(["hemem", "jenga"], device=d, **kw)
                for d in ("cpu", card))
    assert cpu.axes == gpu.axes
    for (_, a), (_, b) in zip(cpu.items(), gpu.items()):
        assert (a.promotions, a.demotions, a.wasteful) == \
            (b.promotions, b.demotions, b.wasteful)
        np.testing.assert_allclose(a.exec_time_s, b.exec_time_s, rtol=1e-4)
    kw = dict(workloads=["gups", "silo-tpcc", "btree"], T=96, n=4096,
              k=512, budget=8)
    cpu, gpu = (search.run("hemem", "grid", device=d, **kw)
                for d in ("cpu", card))
    for g in cpu:
        assert [c for c, _ in cpu[g].rows] == [c for c, _ in gpu[g].rows]
        for (_, a), (_, b) in zip(cpu[g].rows, gpu[g].rows):
            assert (a.promotions, a.demotions, a.wasteful) == \
                (b.promotions, b.demotions, b.wasteful)
            np.testing.assert_allclose(a.exec_time_s, b.exec_time_s,
                                       rtol=1e-4)
