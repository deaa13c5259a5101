"""JAX's threefry2x32 random stream, in NumPy: the stream the ``random``
baseline of the paper's sweeps draws (``jax.random.PRNGKey(seed)``, one
``key, sub = split(key)`` a step, ``categorical(sub, logits)`` as the first
argmax of ``gumbel(sub, (N,))``).

A frozen copy for the benchmark's reference: it imports nothing of the
program under test.  Words are uint32 values held in int64 arrays.
"""

from __future__ import annotations

import numpy as np

M32 = 0xFFFFFFFF
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
TINY32 = float(np.finfo(np.float32).tiny)


def threefry2x32(k1, k2, x1, x2):
    """Threefry-2x32, 20 rounds (Salmon et al., SC'11; JAX's
    ``threefry2x32_p``), elementwise with broadcasting."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + ks[0]) & M32
    x2 = (x2 + ks[1]) & M32
    for i in range(5):
        for r in ROTATIONS[i % 2]:
            x1 = (x1 + x2) & M32
            x2 = x1 ^ (((x2 << r) & M32) | (x2 >> (32 - r)))
        x1 = (x1 + ks[(i + 1) % 3]) & M32
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & M32
    return x1, x2


def prng_key(seed: int) -> tuple[int, int]:
    """``PRNGKey(seed)`` of a uint32 seed: the words (0, seed)."""
    return 0, int(seed) & M32


def split(key: tuple[int, int]) -> tuple[tuple[int, int], tuple[int, int]]:
    """``key, sub = jax.random.split(key)`` (partitionable layout), on
    Python integers."""
    (a1, a2), (b1, b2) = (threefry2x32(key[0], key[1], 0, i) for i in range(2))
    return (a1, a2), (b1, b2)


def random_bits(key: tuple[int, int], n: int) -> np.ndarray:
    """``jax.random.bits(key, (n,))``: n 32-bit words."""
    idx = np.arange(n, dtype=np.int64)
    b1, b2 = threefry2x32(np.int64(key[0]), np.int64(key[1]),
                          np.zeros_like(idx), idx)
    return b1 ^ b2


def uniform(bits: np.ndarray) -> np.ndarray:
    """JAX's float32 ``uniform(minval=tiny, maxval=1)``: the top 23 bits as
    the mantissa of a float in [1, 2), minus 1; tiny where that is 0."""
    f = ((bits >> 9) | 0x3F800000).astype(np.uint32).view(np.float32) - np.float32(1)
    return np.where(f == 0, np.float32(TINY32), f)


def gumbel(bits: np.ndarray) -> np.ndarray:
    """JAX's float32 ``gumbel``: -log(-log(u)), each log taken in float64
    and rounded once to float32."""
    inner = np.log(uniform(bits).astype(np.float64)).astype(np.float32)
    return -np.log((-inner).astype(np.float64)).astype(np.float32)
