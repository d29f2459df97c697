"""Port parity of JAX's threefry PRNG (``repro_torch.utils.prng``) against
the installed jax (partitionable threefry): keys, ``fold_in``, ``split``,
random bits, ``uniform`` (with and without a range) and ``permutation``,
for single and batched keys.

Contract: bit for bit, every case.  The permutation sizes cover n = 1
(no sort round), odd n, n = 1,625 and 1,626 (the last with one shuffle
round and the first with two), n = 2,048, and n = 65,536, where equal
sort keys within a round are likely (the stable sort's tie order is then
part of the result: each case asserts that a tie occurred)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.utils import prng

SEEDS = [0, 1, 42, 123456789, 2 ** 31 - 1]


def _jkey(seed):
    return jax.random.PRNGKey(seed)


def _u32(x):
    return np.asarray(x).astype(np.int64)


def _bits_equal(want, got):
    want, got = np.asarray(want), got.numpy()
    assert want.shape == got.shape
    if want.dtype == np.float32:
        np.testing.assert_array_equal(want.view(np.int32), got.view(np.int32))
    else:
        np.testing.assert_array_equal(want.astype(np.int64), got)


def test_threefry_known_answer():
    """The Random123 known-answer vector for Threefry-2x32-20."""
    k1, k2, x1, x2 = (torch.tensor(v, dtype=torch.int64) for v in (
        0x13198a2e, 0x03707344, 0x243f6a88, 0x85a308d3))
    y1, y2 = prng.threefry2x32(k1, k2, x1, x2)
    assert (int(y1), int(y2)) == (0xc4923a9c, 0x483df7a0)


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_fold_in_split(seed):
    key = prng.PRNGKey(seed)
    _bits_equal(_jkey(seed), key)
    for d in (0, 1, 7, 2 ** 32 - 1):
        _bits_equal(jax.random.fold_in(_jkey(seed), d), prng.fold_in(key, d))
    for num in (2, 3, 5):
        _bits_equal(jax.random.split(_jkey(seed), num), prng.split(key, num))
    # fold_in over a tensor of data: one key per datum
    data = torch.arange(6, dtype=torch.int64)
    want = jax.vmap(lambda d: jax.random.fold_in(_jkey(seed), d))(
        jnp.arange(6))
    _bits_equal(want, prng.fold_in(key, data))


@pytest.mark.parametrize("n", [1, 3, 7, 1000, 2048])
@pytest.mark.parametrize("seed", SEEDS[:3])
def test_bits_and_uniform(seed, n):
    key = prng.PRNGKey(seed)
    _bits_equal(jax.random.bits(_jkey(seed), (n,)),
                prng.random_bits(key, (n,)))
    _bits_equal(jax.random.uniform(_jkey(seed), (n,)),
                prng.uniform(key, (n,)))
    _bits_equal(jax.random.uniform(_jkey(seed), (n,), minval=-1.5,
                                   maxval=3.25),
                prng.uniform(key, (n,), -1.5, 3.25))
    _bits_equal(jax.random.uniform(_jkey(seed), (2, n)),
                prng.uniform(key, (2, n)))


@pytest.mark.parametrize("n", [1, 2, 5, 1625, 1626, 2048])
@pytest.mark.parametrize("seed", SEEDS)
def test_permutation(seed, n):
    assert prng.shuffle_rounds(n) == (0 if n == 1 else 1 if n <= 1625
                                      else 2)
    _bits_equal(jax.random.permutation(_jkey(seed), n),
                prng.permutation(prng.PRNGKey(seed), n))


@pytest.mark.parametrize("seed", [1, 9, 2 ** 31 - 1])
def test_permutation_with_ties(seed):
    """n = 65,536 over two shuffle rounds, at seeds whose rounds hold
    equal 32-bit sort keys (asserted; the last seed's first round too):
    the permutation is still JAX's bit for bit."""
    n, ties = 65536, []
    key = prng.PRNGKey(seed)
    for _ in range(prng.shuffle_rounds(n)):
        pair = prng.split(key)
        key, sub = pair[0], pair[1]
        ties.append(n - torch.unique(prng.random_bits(sub, (n,))).numel())
    assert sum(ties) > 0, ties
    _bits_equal(jax.random.permutation(_jkey(seed), n),
                prng.permutation(prng.PRNGKey(seed), n))


def test_batched_keys():
    """[B, 2] keys give [B, ...] draws, each its own key's."""
    seeds = [3, 9, 27, 81]
    jkeys = jnp.stack([_jkey(s) for s in seeds])
    keys = torch.stack([prng.PRNGKey(s) for s in seeds])
    _bits_equal(jax.vmap(jax.random.split)(jkeys), prng.split(keys))
    _bits_equal(jax.vmap(lambda k: jax.random.uniform(k, (513,)))(jkeys),
                prng.uniform(keys, (513,)))
    _bits_equal(jax.vmap(lambda k: jax.random.permutation(k, 1700))(jkeys),
                prng.permutation(keys, 1700))
    _bits_equal(jax.vmap(jax.random.fold_in)(jkeys, jnp.arange(4)),
                prng.fold_in(keys, torch.arange(4)))
