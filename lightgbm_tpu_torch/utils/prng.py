"""JAX's default random stream (threefry2x32) in torch ``int64`` arithmetic.

``rank_xendcg`` draws its per-document gammas from ``jax.random`` in the JAX
package (``jax.random.uniform(jax.random.fold_in(jax.random.PRNGKey(seed),
i), shape)``).  The port computes the same bits with these functions, as the
installed ``jax/_src/prng.py`` (``threefry_seed``, ``_threefry2x32_lowering``,
``_threefry_fold_in``, ``_threefry_random_bits_partitionable``, the default
with ``jax_threefry_partitionable`` on) and ``jax/_src/random.py``
(``_uniform``) define them: torch has little ``uint32`` support, so every
value is an ``int64`` in [0, 2**32), masked after each add and shift.

A key is a pair of Python ints (the two ``uint32`` words).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))

Key = Tuple[int, int]


def prng_key(seed: int) -> Key:
    """``jax.random.PRNGKey(seed)`` for a seed in [0, 2**31): the seed's
    high and low 32-bit words."""
    seed = int(seed)
    if not 0 <= seed < 2 ** 31:
        raise ValueError("seed %d outside [0, 2**31)" % seed)
    return (0, seed)


def threefry2x32(key: Key, x1: torch.Tensor, x2: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 block cipher (20 rounds) of the counter pairs
    (``x1``, ``x2``), int64 tensors of uint32 values, under ``key``."""
    k1, k2 = key
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + ks[0]) & _M32
    x2 = (x2 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _M32
            x2 = ((x2 << r) & _M32) | (x2 >> (32 - r))
            x2 = x1 ^ x2
        x1 = (x1 + ks[(i + 1) % 3]) & _M32
        x2 = (x2 + ks[(i + 2) % 3] + i + 1) & _M32
    return x1, x2


def fold_in(key: Key, data: int) -> Key:
    """``jax.random.fold_in(key, data)``: the cipher of the counter pair
    (0, data)."""
    zero = torch.zeros(1, dtype=torch.int64)
    a, b = threefry2x32(key, zero, zero + (int(data) & _M32))
    return (int(a[0]), int(b[0]))


def uniform(key: Key, shape: Sequence[int],
            device: torch.device) -> torch.Tensor:
    """``jax.random.uniform(key, shape, dtype=float32)`` in [0, 1): 32 random
    bits a value (the xor of the cipher's two words over the counters
    (0, 0..n-1)), their top 23 bits as the mantissa of a float in [1, 2),
    minus one.  Computed on ``device``."""
    n = 1
    for d in shape:
        n *= int(d)
    lo = torch.arange(n, dtype=torch.int64, device=device)
    b1, b2 = threefry2x32(key, torch.zeros_like(lo), lo)
    bits = ((b1 ^ b2) >> 9) | 0x3F800000
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    return floats.reshape(tuple(int(d) for d in shape))
