"""JAX's threefry PRNG in torch, bit for bit.

The counter-based Threefry-2x32 hash (20 rounds, Salmon et al. 2011) and
the key API the JAX package draws its noise and permutations with:
``PRNGKey``, ``fold_in``, ``split``, ``random_bits``, ``uniform`` and
``permutation``.  The bit layout is JAX's under
``jax_threefry_partitionable=True`` (the default of the jax releases the
JAX package runs on): element ``i`` of a draw hashes the 64-bit counter
``i`` split into its high and low words, and ``split(key, m)[i]`` is the
hash of the counter ``i``.

A key is an int64 tensor ``[..., 2]`` holding the two uint32 words of a
JAX key (``np.asarray(jax_key)``); every word of every intermediate is
kept in ``[0, 2^32)`` by a mask, so the arithmetic is exact int64 on the
CPU and on the card alike.  Leading key axes batch: ``[B, 2]`` keys give
``[B, n]`` draws, a lane axis with no Python loop.

Everything here is plain torch (JAX computes it in plain XLA too); a
draw of shape ``[B, n]`` costs about two hundred elementwise launches.
"""
from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["PRNGKey", "threefry2x32", "fold_in", "split", "split_chain",
           "random_bits", "uniform", "permutation", "shuffle_rounds"]

_M = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x, r: int):
    return ((x << r) & _M) | (x >> (32 - r))


def threefry2x32(k1, k2, x1, x2):
    """Threefry-2x32 of the counter words ``(x1, x2)`` under the key words
    ``(k1, k2)``; broadcasting int64 tensors of uint32 values."""
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


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` as an int64 ``[2]`` tensor: the seed's
    32-bit value in the low word (JAX without x64 holds an int seed as
    int32, whose logical shift by 32 leaves a zero high word)."""
    lo = int(seed) & _M
    return torch.tensor([0, lo], dtype=torch.int64, device=device)


def _words(key):
    return key[..., 0], key[..., 1]


def fold_in(key, data):
    """``jax.random.fold_in``: the hash of the counter ``(0, data)``.
    ``data`` is an int or an integer tensor broadcasting against the key's
    leading axes (a batch of fold-ins at once)."""
    k1, k2 = _words(key)
    if isinstance(data, torch.Tensor):
        d = data.to(device=key.device, dtype=torch.int64) & _M
    else:
        d = torch.full((), int(data) & _M, dtype=torch.int64,
                       device=key.device)
    y1, y2 = threefry2x32(k1, k2, torch.zeros_like(d), d)
    return torch.stack(torch.broadcast_tensors(y1, y2), dim=-1)


def _counters(shape, device):
    """JAX's ``iota_2x32_shape``: the row-major index of every element,
    as its high and low 32-bit words."""
    size = math.prod(shape)
    idx = torch.arange(size, dtype=torch.int64, device=device).reshape(shape)
    return idx >> 32, idx & _M


def _hash_counters(key, shape):
    """Both hash words of every counter of ``shape`` under each key:
    ``key [..., 2]`` -> two ``[..., *shape]`` tensors."""
    k1, k2 = _words(key)
    extra = (1,) * len(shape)
    hi, lo = _counters(shape, key.device)
    return threefry2x32(k1.reshape(k1.shape + extra),
                        k2.reshape(k2.shape + extra), hi, lo)


def split(key, num: int = 2):
    """``jax.random.split(key, num)`` -> ``[..., num, 2]``."""
    y1, y2 = _hash_counters(key, (int(num),))
    return torch.stack((y1, y2), dim=-1)


def split_chain(key, T: int):
    """The subkeys of ``T`` successive ``key, sub = split(key)`` steps:
    ``key [..., 2]`` -> ``[T, ..., 2]`` on the key's device.  The chain is
    sequential and its keys are tiny, so it runs on the host in numpy
    (the same int64 arithmetic), not as ``T`` rounds of device launches."""
    k = key.cpu().numpy().astype(np.int64)
    k1, k2 = k[..., 0], k[..., 1]
    zero = np.zeros_like(k1)
    subs = np.empty((T,) + k.shape, np.int64)
    for t in range(T):
        subs[t, ..., 0], subs[t, ..., 1] = threefry2x32(k1, k2, zero,
                                                        zero + 1)
        k1, k2 = threefry2x32(k1, k2, zero, zero)
    return torch.from_numpy(subs).to(key.device)


def random_bits(key, shape):
    """``jax.random.bits(key, shape)`` (uint32) -> int64 ``[..., *shape]``."""
    y1, y2 = _hash_counters(key, tuple(shape))
    return y1 ^ y2


def uniform(key, shape, minval: float = 0.0, maxval: float = 1.0):
    """``jax.random.uniform(key, shape, float32, minval, maxval)``: the
    top 23 random bits as the mantissa of a float in [1, 2), minus one,
    scaled into ``[minval, maxval)`` by one fused multiply-add (as XLA
    compiles it); f32 ``[..., *shape]``."""
    bits = random_bits(key, shape)
    fbits = (bits >> 9) | 0x3F800000
    floats = fbits.to(torch.int32).view(torch.float32) - 1.0
    if minval == 0.0 and maxval == 1.0:
        return floats
    from repro_torch.kernels.interval_step.ref import fma
    lo = torch.full_like(floats, float(np.float32(minval)))
    hi = torch.full_like(floats, float(np.float32(maxval)))
    # XLA fuses the scaling into one multiply-add
    return torch.maximum(lo, fma(floats, hi - lo, lo))


def shuffle_rounds(n: int) -> int:
    """Sort rounds of JAX's ``_shuffle`` for ``n`` items: enough fresh
    32-bit keys that all n are told apart with high probability."""
    return int(np.ceil(3 * np.log(max(1, n)) / np.log(np.iinfo(np.uint32)
                                                      .max)))


def permutation(key, n: int):
    """``jax.random.permutation(key, n)`` -> int64 ``[..., n]``: rounds of
    a STABLE sort of ``arange(n)`` by fresh 32-bit keys, each round's key
    split off the last (``_shuffle``).  Equal sort keys keep their order,
    as ``lax.sort_key_val(..., is_stable=True)`` does; at n = 65,536 two
    equal keys in a round are likely, so the tie rule is part of the
    result."""
    x = torch.arange(n, dtype=torch.int64, device=key.device)
    x = x.expand(key.shape[:-1] + (n,))
    for _ in range(shuffle_rounds(n)):
        pair = split(key)
        key, sub = pair[..., 0, :], pair[..., 1, :]
        order = torch.sort(random_bits(sub, (n,)), dim=-1,
                           stable=True).indices
        x = torch.gather(x, -1, order)
    return x
