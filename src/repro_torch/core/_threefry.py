"""JAX's default PRNG (threefry2x32, partitionable) in numpy, as far as
the FL round's client draw needs it.

The JAX round samples its active clients with
``jax.random.permutation(jax.random.fold_in(jax.random.PRNGKey(17),
round), C)[:n_active]``.  :func:`client_permutation` computes the same
permutation from the same uint32 key pair, so the port draws the same
clients as the reference in every round.  The pieces follow
``jax/_src/prng.py`` (``threefry_2x32``, ``_threefry_split_foldlike``,
``_threefry_fold_in``, ``_threefry_random_bits_partitionable``) and
``jax/_src/random.py`` (``_shuffle``).
"""
from __future__ import annotations

import numpy as np

_U32 = np.uint32
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << _U32(r)) | (x >> _U32(32 - r))


def threefry2x32(key, x0, x1):
    """The 20-round Threefry-2x32 hash of counter words ``(x0, x1)``
    (uint32 arrays of one shape) under the key pair ``key``."""
    k0, k1 = _U32(key[0]), _U32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ _U32(0x1BD11BDA))
    x0 = np.asarray(x0, _U32).copy()
    x1 = np.asarray(x1, _U32).copy()
    with np.errstate(over="ignore"):
        x0 += ks[0]
        x1 += ks[1]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x0 += x1
                x1 = _rotl(x1, r) ^ x0
            x0 += ks[(i + 1) % 3]
            x1 += ks[(i + 2) % 3] + _U32(i + 1)
    return x0, x1


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` for a seed below 2**32."""
    return np.array([0, seed], _U32)


def fold_in(key, data: int) -> np.ndarray:
    """``jax.random.fold_in(key, data)``: the hash of the counters
    ``[0, data]``."""
    y0, y1 = threefry2x32(key, [0], [data])
    return np.array([y0[0], y1[0]], _U32)


def split(key):
    """``jax.random.split(key)`` in its partitionable form: the new keys
    are the hashes of the counter pairs ``(0, 0)`` and ``(0, 1)``."""
    b1, b2 = threefry2x32(key, [0, 0], [0, 1])
    return np.array([b1[0], b2[0]], _U32), np.array([b1[1], b2[1]], _U32)


def random_bits32(key, n: int) -> np.ndarray:
    """``n`` random uint32 words: ``bits1 ^ bits2`` of the counters
    ``(0, i)``."""
    b1, b2 = threefry2x32(key, np.zeros(n, _U32), np.arange(n, dtype=_U32))
    return b1 ^ b2


def permutation(key, n: int) -> np.ndarray:
    """``jax.random.permutation(key, n)``: ``ceil(3 ln n / ln(2**32-1))``
    rounds of a stable sort of ``arange(n)`` by fresh random words."""
    x = np.arange(n, dtype=np.int64)
    rounds = int(np.ceil(3 * np.log(max(1, n))
                         / np.log(np.iinfo(np.uint32).max)))
    for _ in range(rounds):
        key, sub = split(key)
        x = x[np.argsort(random_bits32(sub, n), kind="stable")]
    return x


def client_permutation(round_: int, n: int, key=None) -> np.ndarray:
    """The round's client order: ``permutation(fold_in(PRNGKey(17),
    round_), n)``, or ``permutation(key, n)`` for an explicit key pair."""
    if key is None:
        key = fold_in(prng_key(17), round_)
    return permutation(np.asarray(key, _U32), n)
