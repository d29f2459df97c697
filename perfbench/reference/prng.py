"""Threefry-2x32 counter-based keys and draws, in plain torch.

A key is an int64 tensor ``[..., 2]`` of two uint32 words; every word is
masked to 32 bits, so the arithmetic is exact on any device.  The bit
layout is JAX's ``jax_threefry_partitionable`` layout: element ``i`` of a
draw hashes the 64-bit counter ``i`` as (high word, low word), and
``split(key)[i]`` hashes the counter ``i``.  Salmon et al., "Parallel
random numbers: as easy as 1, 2, 3" (SC 2011), gives the rounds.
"""
from __future__ import annotations

import math

import numpy as np
import torch

_M = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x, r: int):
    return ((x << r) & _M) | (x >> (32 - r))


def threefry2x32(k1, k2, x1, x2):
    """20 rounds of Threefry-2x32 on broadcasting integer arrays (torch
    or numpy) holding uint32 values."""
    k3 = k1 ^ k2 ^ _PARITY
    ks = (k1, k2, k3)
    x1 = (x1 + k1) & _M
    x2 = (x2 + k2) & _M
    for i in range(5):
        for r in _ROT[i % 2]:
            x1 = (x1 + x2) & _M
            x2 = x1 ^ _rotl(x2, r)
        x1 = (x1 + ks[(i + 1) % 3]) & _M
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & _M
    return x1, x2


def key(seed: int, device=None):
    """The key of an integer seed: its low 32 bits in the low word."""
    return torch.tensor([0, int(seed) & _M], dtype=torch.int64,
                        device=device)


def fold_in(k, data):
    """Hash of the counter ``(0, data)`` under ``k``; ``data`` an int or an
    integer tensor broadcasting against the key's leading axes."""
    if isinstance(data, torch.Tensor):
        d = data.to(device=k.device, dtype=torch.int64) & _M
    else:
        d = torch.full((), int(data) & _M, dtype=torch.int64, device=k.device)
    y1, y2 = threefry2x32(k[..., 0], k[..., 1], torch.zeros_like(d), d)
    return torch.stack(torch.broadcast_tensors(y1, y2), dim=-1)


def _hash_counters(k, shape):
    size = math.prod(shape)
    idx = torch.arange(size, dtype=torch.int64, device=k.device).reshape(shape)
    extra = (1,) * len(shape)
    return threefry2x32(k[..., 0].reshape(k.shape[:-1] + extra),
                        k[..., 1].reshape(k.shape[:-1] + extra),
                        idx >> 32, idx & _M)


def split2(k):
    """(next key, subkey) of one split: the hashes of counters 0 and 1."""
    y1, y2 = _hash_counters(k, (2,))
    pair = torch.stack((y1, y2), dim=-1)
    return pair[..., 0, :], pair[..., 1, :]


def subkey_chain(k, T: int):
    """The subkeys of ``T`` successive ``k, sub = split(k)`` steps,
    ``[T, ..., 2]``, worked out on the host in numpy."""
    kk = k.cpu().numpy().astype(np.int64)
    k1, k2 = kk[..., 0], kk[..., 1]
    zero = np.zeros_like(k1)
    subs = np.empty((T,) + kk.shape, np.int64)
    for t in range(T):
        subs[t, ..., 0], subs[t, ..., 1] = threefry2x32(k1, k2, zero, zero + 1)
        k1, k2 = threefry2x32(k1, k2, zero, zero)
    return torch.from_numpy(subs).to(k.device)


def bits(k, shape):
    y1, y2 = _hash_counters(k, tuple(shape))
    return y1 ^ y2


def uniform(k, shape):
    """f32 uniforms in [0, 1): the top 23 bits as a mantissa in [1, 2),
    minus one."""
    fb = (bits(k, shape) >> 9) | 0x3F800000
    return fb.to(torch.int32).view(torch.float32) - 1.0


def permutation(k, n: int):
    """Random permutation of ``arange(n)``: rounds of a stable sort by
    fresh 32-bit keys, each round's key split off the last."""
    rounds = int(np.ceil(3 * np.log(max(1, n))
                         / np.log(np.iinfo(np.uint32).max)))
    x = torch.arange(n, dtype=torch.int64, device=k.device)
    x = x.expand(k.shape[:-1] + (n,))
    for _ in range(rounds):
        k, sub = split2(k)
        order = torch.sort(bits(sub, (n,)), dim=-1, stable=True).indices
        x = torch.gather(x, -1, order)
    return x
