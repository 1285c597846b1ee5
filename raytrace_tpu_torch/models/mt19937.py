"""Bit-exact reimplementation of std::mt19937 + libstdc++ float distributions.

The reference scene generator (reference src/scene.h:120 ``std::mt19937
engine{}``) uses a default-seeded Mersenne Twister with
``std::uniform_real_distribution<float>`` (scene.h:37-44) to lay out the 484
small spheres.  To make our TPU renderer's scene byte-identical to the Vulkan
renderer's, we reproduce both the engine and libstdc++'s ``generate_canonical``
float path exactly.

libstdc++ details (bits/random.tcc): ``uniform_real_distribution<float>`` draws
``generate_canonical<float, 24>(urng)`` which, for a 32-bit engine, performs a
single draw and computes ``float(x) / 2^32`` in float arithmetic, clamped to
``nextafter(1.0f, 0.0f)`` if rounding produces 1.0f; the result is then scaled
as ``ret * (b - a) + a`` in float32.

Port copy of ``raytrace_tpu/models/mt19937.py``, byte-for-byte in behaviour
(numpy only): the port never imports the JAX package, whose ``__init__``
imports jax.
"""

from __future__ import annotations

import numpy as np

_N = 624
_M = 397
_MATRIX_A = 0x9908B0DF
_UPPER_MASK = 0x80000000
_LOWER_MASK = 0x7FFFFFFF
_MASK32 = 0xFFFFFFFF

# float32 just below 1.0 (nextafter(1.0f, 0.0f))
_ONE_MINUS_ULP = np.float32(np.nextafter(np.float32(1.0), np.float32(0.0)))


class MT19937:
    """std::mt19937 with the standard default seed 5489."""

    def __init__(self, seed: int = 5489):
        self.mt = [0] * _N
        self.mti = _N
        self.mt[0] = seed & _MASK32
        for i in range(1, _N):
            self.mt[i] = (1812433253 * (self.mt[i - 1] ^ (self.mt[i - 1] >> 30)) + i) & _MASK32

    def _twist(self) -> None:
        mt = self.mt
        for i in range(_N):
            y = (mt[i] & _UPPER_MASK) | (mt[(i + 1) % _N] & _LOWER_MASK)
            mt[i] = mt[(i + _M) % _N] ^ (y >> 1)
            if y & 1:
                mt[i] ^= _MATRIX_A
        self.mti = 0

    def next_u32(self) -> int:
        if self.mti >= _N:
            self._twist()
        y = self.mt[self.mti]
        self.mti += 1
        y ^= y >> 11
        y ^= (y << 7) & 0x9D2C5680
        y ^= (y << 15) & 0xEFC60000
        y ^= y >> 18
        return y & _MASK32


def canonical_float(engine: MT19937) -> np.float32:
    """libstdc++ generate_canonical<float, 24> for a 32-bit engine."""
    x = engine.next_u32()
    ret = np.float32(np.float32(x) / np.float32(4294967296.0))
    if ret >= np.float32(1.0):
        ret = _ONE_MINUS_ULP
    return ret


def uniform_float(engine: MT19937, lo: float = 0.0, hi: float = 1.0) -> np.float32:
    """std::uniform_real_distribution<float>(lo, hi)(engine) under libstdc++."""
    lo32 = np.float32(lo)
    hi32 = np.float32(hi)
    return np.float32(canonical_float(engine) * (hi32 - lo32) + lo32)
