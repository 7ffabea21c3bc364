"""The port's own copy of the part of ``jax.random`` that it needs.

Reproduces, bit for bit, ``jax.random`` under
``jax_default_prng_impl=threefry2x32`` and
``jax_threefry_partitionable=True`` (both checked on jax 0.9.0): a key is
two ``uint32`` words, every draw is Threefry-2x32 (20 rounds, rotations
13, 15, 26, 6 / 17, 29, 16, 24) of the key over a 64-bit counter split
into (hi, lo) words. Implemented in ``numpy.uint32``, whose arithmetic
wraps mod 2**32 as the reference's does; no import of ``jax``.

- ``key(seed)``: ``PRNGKey``; a Python int seed is taken as int64 and
  cast to int32 as jax does with 64-bit types off, so the key is
  (0, seed mod 2**32).
- ``fold_in(key, data)``: Threefry of the key over the counter (0, data).
- ``split(key, n)``: key i is Threefry of the key over the counter
  (hi(i), lo(i)), the same as ``fold_in(key, i)``.
- ``random_bits(key, shape)``: 32-bit draws, the XOR of Threefry's two
  output words over the flat index of each element.
- ``randint(key, shape, lo, hi)``: two draws from ``split(key, 2)`` joined
  by jax's two-draw modulus: ((h mod s) * ((2**16 mod s)**2 mod s) +
  (l mod s)) mod s, mod 2**32, with s = hi - lo.
"""

from __future__ import annotations

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(k0, k1, x0, x1) -> tuple[np.ndarray, np.ndarray]:
    """Threefry-2x32 of keys (k0, k1) over counters (x0, x1); all
    ``uint32`` arrays that broadcast together."""
    k0, k1 = np.asarray(k0, np.uint32), np.asarray(k1, np.uint32)
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    with np.errstate(over="ignore"):  # numpy scalars warn where arrays wrap
        x0 = np.asarray(x0, np.uint32) + ks[0]
        x1 = np.asarray(x1, np.uint32) + ks[1]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x0 = x0 + x1
                x1 = _rotl(x1, r) ^ x0
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)``: uint32 [hi, lo]."""
    lo = np.int64(seed).astype(np.int32).view(np.uint32)
    return np.array([0, lo], np.uint32)


def _counters(n: int) -> tuple[np.ndarray, np.ndarray]:
    """The (hi, lo) words of 0 .. n - 1."""
    i = np.arange(n, dtype=np.uint64)
    return (i >> np.uint64(32)).astype(np.uint32), i.astype(np.uint32)


def fold_in(k: np.ndarray, data: int) -> np.ndarray:
    """``jax.random.fold_in(k, data)``."""
    y0, y1 = threefry2x32(k[0], k[1], np.uint32(0),
                          np.uint32(int(data) & 0xFFFFFFFF))
    return np.array([y0, y1], np.uint32)


def split(k: np.ndarray, n: int = 2) -> np.ndarray:
    """``jax.random.split(k, n)``: uint32 [n, 2]."""
    return np.stack(threefry2x32(k[0], k[1], *_counters(n)), axis=1)


def random_bits(k: np.ndarray, shape) -> np.ndarray:
    """``jax.random.bits(k, shape)`` (32-bit): uint32 of ``shape``. ``k``
    may also be [..., 2], a stack of keys, each drawing ``shape``."""
    shape = tuple(shape)
    hi, lo = _counters(int(np.prod(shape, dtype=np.int64)))
    k = np.asarray(k, np.uint32)
    lead = k.shape[:-1]
    k0, k1 = (k[..., j].reshape(*lead, 1) for j in (0, 1))
    y0, y1 = threefry2x32(k0, k1, hi, lo)
    return (y0 ^ y1).reshape(*lead, *shape)


def randint(k: np.ndarray, shape, lo: int, hi: int) -> np.ndarray:
    """``jax.random.randint(k, shape, lo, hi, jnp.int32)`` for int32 bounds
    with lo < hi: int32 of ``shape``."""
    if not -2**31 <= lo < hi <= 2**31 - 1:
        raise ValueError(f"need int32 bounds lo < hi; got {lo}, {hi}")
    higher, lower = random_bits(split(k, 2), shape)
    span = np.uint32(hi - lo)
    mult = np.uint32((2**16 % int(span)) ** 2 % int(span))
    off = ((higher % span) * mult + lower % span) % span
    return (off + np.uint32(lo & 0xFFFFFFFF)).view(np.int32)
