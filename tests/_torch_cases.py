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


def migrate_edge_case(B, n, R, P, D, seed, kind):
    """(tier, promote, demote, caps) at the edges the migration kernel is
    held to.  ``both``: about half of each lane's demote entries name pages
    its promote plan names too (some of them in tier 0, so a page demoted
    from tier 0 may be promoted back), room enough for some promotions;
    ``tight``: tier 0 over its cap (room <= 0 after the departures) and the
    middle tiers over theirs (negative slack); ``invalid``: every entry
    -1.  Valid entries stay unique within each plan."""
    rng = np.random.default_rng(seed)
    tier = rng.integers(0, R, (B, n)).astype(np.int32)
    promote = np.full((B, P), -1, np.int32)
    demote = np.full((B, D), -1, np.int32)
    occ = np.stack([(tier == r).sum(1) for r in range(R)], 1)
    if kind == "both":
        for b in range(B):
            perm = rng.permutation(n)
            npro = min(P, n)
            promote[b, :npro] = perm[:npro]
            shared = perm[:min(D // 2, npro)]
            fresh = perm[npro:npro + min(D - shared.size, n - npro)]
            pick = np.concatenate([shared, fresh])
            demote[b, :pick.size] = rng.permutation(pick)
        caps = occ + rng.integers(-2, max(3, P // 2), (B, R))
    elif kind == "tight":
        promote, demote = plans(rng, B, n, P, D)
        caps = occ - rng.integers(D + 1, D + 8, (B, R))
    elif kind == "invalid":
        caps = occ + rng.integers(1, n + 1, (B, R))
    else:
        raise ValueError(kind)
    caps[:, -1] = n
    return tier, promote, demote, caps.astype(np.int32)


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


# (Ps, Pd, M, page, feat): the shapes of tests/test_kernels.py, odd page
# and feature sizes, and the serving pool's fused K/V rows.
MIGRATE_SHAPES = [(16, 8, 4, 16, 128), (4, 4, 4, 8, 256),
                  (32, 32, 12, 64, 128), (9, 7, 5, 3, 5), (6, 11, 6, 1, 7)]
# (B, H, KV, dh, page, n_pp): the shapes of tests/test_kernels.py.
PAGED_SHAPES = [(2, 8, 4, 128, 16, 4), (1, 4, 4, 64, 32, 2),
                (3, 16, 2, 128, 8, 8), (2, 8, 8, 128, 64, 2)]
# (B, H, KV, dh, page, n_pp): tables of 1, 5 and 33 entries (no multiple
# of a cluster of CTAs), head_dim 256 and 6 (not a multiple of 16 bytes),
# head_dim 320 and 1,002 (more than one column block of a CTA), 3 query
# rows a KV head (no multiple of the rows a pass serves).
PAGED_EDGE_SHAPES = [(2, 8, 4, 128, 16, 1), (2, 8, 2, 64, 16, 5),
                     (1, 16, 4, 128, 16, 33), (1, 8, 2, 256, 16, 4),
                     (2, 4, 2, 6, 8, 3), (1, 8, 2, 320, 16, 3),
                     (1, 4, 4, 1002, 8, 2), (2, 6, 2, 64, 16, 7)]


def migrate_pools_case(Ps, Pd, M, page, feat, seed, dtype=np.float32):
    """(src, dst, src_idx, dst_idx, valid) numpy arrays: unique valid
    indices, about a third of the entries invalid with -1 indices."""
    rng = np.random.default_rng(seed)
    src = rng.standard_normal((Ps, page, feat)).astype(dtype)
    dst = rng.standard_normal((Pd, page, feat)).astype(dtype)
    src_idx = rng.choice(Ps, M, replace=False).astype(np.int32)
    dst_idx = rng.choice(Pd, M, replace=False).astype(np.int32)
    valid = rng.random(M) < 0.7
    src_idx[~valid & (rng.random(M) < 0.5)] = -1
    dst_idx[~valid & (rng.random(M) < 0.5)] = -1
    return src, dst, src_idx, dst_idx, valid


def paged_case(B, H, KV, dh, page, n_pp, seed, lens=None, pool=None):
    """(q, k_pages, v_pages, tables, lens) f32 numpy arrays over a pool of
    ``n_pp * B + 3`` pages, distinct table entries; or, with ``pool``, over
    that many pages, entries drawn with repeats (long tables)."""
    rng = np.random.default_rng(seed)
    P = n_pp * B + 3 if pool is None else pool
    q = rng.standard_normal((B, H, dh)).astype(np.float32)
    k = rng.standard_normal((P, page, KV, dh)).astype(np.float32)
    v = rng.standard_normal((P, page, KV, dh)).astype(np.float32)
    tables = rng.choice(P, (B, n_pp), replace=pool is not None).astype(
        np.int32)
    if lens is None:
        lens = rng.integers(1, n_pp * page + 1, B)
    return q, k, v, tables, np.asarray(lens, np.int32)


# (B, S, H, KV, dh, causal, window): causal and not, windowed, GQA rep 1,
# 2 and 4, every head_dim the configs use (16 reduced, 64, 128), S below,
# at and above the kernels' 64-row tile, ragged tails.
FLASH_SHAPES = [(2, 40, 4, 4, 16, True, 0), (2, 40, 4, 2, 16, False, 0),
                (1, 64, 4, 1, 64, True, 0), (2, 100, 8, 2, 64, True, 0),
                (1, 130, 4, 4, 64, False, 0), (1, 200, 8, 2, 128, True, 0),
                (2, 77, 8, 2, 128, False, 0), (1, 300, 4, 1, 64, True, 48),
                (1, 257, 4, 4, 16, True, 1), (1, 96, 4, 2, 64, False, 17)]


def flash_case(B, S, H, KV, dh, seed, dv=None):
    """(q, k, v, cotangent) f32 numpy arrays, standard normal; v and the
    cotangent ``dv`` wide (``dh`` by default)."""
    dv = dv or dh
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, H, dh)).astype(np.float32)
    k = rng.standard_normal((B, S, KV, dh)).astype(np.float32)
    v = rng.standard_normal((B, S, KV, dv)).astype(np.float32)
    do = rng.standard_normal((B, S, H, dv)).astype(np.float32)
    return q, k, v, do


# (B, S, H, P, N, Q): the shapes of tests/test_kernels.py's mamba scan
# test and reduced mamba2-370m's scan (32 tokens, 4 heads of 32, N 16,
# chunk 8).
MAMBA_SHAPES = [(2, 128, 3, 16, 32, 32), (1, 64, 2, 64, 128, 16),
                (3, 256, 1, 32, 64, 64), (2, 32, 4, 32, 16, 8)]
# mamba2-370m's scan at the training path's batch 2 x 4,096 tokens.
MAMBA_TRAIN_SHAPE = (2, 4096, 32, 64, 128, 64)
# zamba2-1.2b's: 64 heads of 64, N 64 (one block of the backward's N walk)
HYBRID_TRAIN_SHAPE = (2, 4096, 64, 64, 64, 64)
# (B, S, H, KV, dh, causal, window) of the families' prefill attention:
# llava-next-mistral-7b's 576 patches + 4,096 tokens, llama4-scout's 40
# query heads over 8 (a group of 5) with its 8,192 window, and the same
# heads under a window shorter than the sequence
# (B, S, H, KV, dq, dv, causal, window): MLA's unequal widths, reduced
# (32, 16) and deepseek-v2's (192, 128): causal, non-causal, windowed,
# ragged S (37 and whisper's 1,500 frames), GQA rep 2 and 4; and
# whisper-small's encoder (12 heads of 64, non-causal, S 1,500)
MLA_FLASH_SHAPES = [(2, 40, 4, 4, 32, 16, True, 0),
                    (2, 37, 4, 2, 32, 16, False, 0),
                    (1, 300, 4, 1, 32, 16, True, 48),
                    (1, 1500, 4, 2, 32, 16, False, 0),
                    (1, 130, 4, 4, 192, 128, True, 0),
                    (2, 37, 4, 4, 192, 128, False, 0),
                    (1, 300, 4, 2, 192, 128, True, 48),
                    (1, 1500, 2, 2, 192, 128, False, 0),
                    (1, 1500, 12, 12, 64, 64, False, 0)]

FAMILY_FLASH_SHAPES = [(2, 4672, 32, 8, 128, True, 0),
                       (2, 4096, 40, 8, 128, True, 8192),
                       (1, 2048, 40, 8, 128, True, 1024)]


def mamba_case(B, S, H, P, N, seed, model_like=False):
    """(x, dt, A, Bm, Cm, dy, dh_final) f32 numpy arrays.  x, Bm, Cm and
    the cotangents standard normal; dt uniform in [0.1, 0.9] and A in
    -[0.5, 2] as tests/test_kernels.py draws them, or with ``model_like``
    as mamba2-370m's init gives them: dt = softplus(N(0, 1)) and
    A = -linspace(1, 16, H)."""
    rng = np.random.default_rng(seed)
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    x, Bm, Cm = f(B, S, H, P), f(B, S, N), f(B, S, N)
    if model_like:
        dt = np.logaddexp(f(B, S, H), 0).astype(np.float32)
        A = -np.linspace(1.0, 16.0, H).astype(np.float32)
    else:
        dt = rng.uniform(0.1, 0.9, (B, S, H)).astype(np.float32)
        A = -rng.uniform(0.5, 2.0, (H,)).astype(np.float32)
    return x, dt, A, Bm, Cm, f(B, S, H, P), f(B, H, P, N)


def same_result(a, b):
    """The replay contract between two SimResults (DESIGN.md §2):
    promotions, demotions, wasteful and the integer timelines exact;
    exec_time within 1e-4 relative; hot_recall and fast_hit_frac within
    1e-6; the slow-share timeline within 1e-5 (a ratio of access sums that
    the JAX package accumulates in f32 and the port rounds once from
    f64)."""
    assert (a.promotions, a.demotions, a.wasteful) == \
        (b.promotions, b.demotions, b.wasteful), (a.name, b.name)
    np.testing.assert_allclose(a.exec_time_s, b.exec_time_s, rtol=1e-4)
    assert abs(a.hot_recall - b.hot_recall) <= 1e-6
    assert abs(a.fast_hit_frac - b.fast_hit_frac) <= 1e-6
    np.testing.assert_array_equal(a.timeline_mode, b.timeline_mode)
    np.testing.assert_array_equal(a.timeline_promotions,
                                  b.timeline_promotions)
    np.testing.assert_allclose(a.timeline_slow_bw, b.timeline_slow_bw,
                               rtol=1e-5, atol=0)


def ranked_keys(rng, B, n):
    """f32 [B, n] keys with repeated values and both signed zeros."""
    x = (rng.integers(-3, 4, (B, n)) * 0.5).astype(np.float32)
    x[rng.random((B, n)) < 0.2] = -0.0
    return x
