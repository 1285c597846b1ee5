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

The port draws in blocks: ``MT19937.draw(n)`` returns the next ``n`` words of
the stream as one ``uint32`` array (the twist and the tempering are array
ops), and ``canonical_float`` / ``uniform_float`` map whole arrays, with the
same float32 operations as the JAX package's scalar draws
(``raytrace_tpu/models/mt19937.py``), so every value is byte-equal to them.
numpy only: the port never imports the JAX package, whose ``__init__``
imports jax.
"""

from __future__ import annotations

import numpy as np

_N = 624
_M = 397
_MATRIX_A = np.uint32(0x9908B0DF)
_UPPER_MASK = np.uint32(0x80000000)
_LOWER_MASK = np.uint32(0x7FFFFFFF)
_MASK32 = 0xFFFFFFFF

# float32 just below 1.0 (nextafter(1.0f, 0.0f))
_ONE_MINUS_ULP = np.float32(np.nextafter(np.float32(1.0), np.float32(0.0)))


def _mag(y: np.ndarray) -> np.ndarray:
    """The twist's ``(y >> 1) ^ (y & 1 ? MATRIX_A : 0)``."""
    return (y >> 1) ^ ((y & 1) * _MATRIX_A)


def _temper(y: np.ndarray) -> np.ndarray:
    y = y ^ (y >> 11)
    y ^= (y << 7) & np.uint32(0x9D2C5680)
    y ^= (y << 15) & np.uint32(0xEFC60000)
    return y ^ (y >> 18)


class MT19937:
    """std::mt19937 with the standard default seed 5489, drawn in blocks."""

    def __init__(self, seed: int = 5489):
        x = seed & _MASK32
        mt = [x]
        for i in range(1, _N):
            x = (1812433253 * (x ^ (x >> 30)) + i) & _MASK32
            mt.append(x)
        self.mt = np.array(mt, np.uint32)
        self.mti = _N

    def _twist(self) -> None:
        """The 624-word twist as four array steps.  Word i takes the old
        words i and i + 1 and word (i + 397) mod 624, which for i >= 227 the
        twist has already replaced: so [0, 227) reads the old state,
        [227, 454) the new [0, 227), [454, 623) the new [227, 396), and 623
        the new words 0 and 396."""
        old = self.mt
        mag = _mag((old[:-1] & _UPPER_MASK) | (old[1:] & _LOWER_MASK))
        new = np.empty_like(old)
        new[:227] = old[_M:] ^ mag[:227]
        new[227:454] = new[:227] ^ mag[227:454]
        new[454:623] = new[227:396] ^ mag[454:623]
        new[623] = new[396] ^ _mag((old[623] & _UPPER_MASK) | (new[0] & _LOWER_MASK))
        self.mt = new
        self.mti = 0

    def draw(self, n: int) -> np.ndarray:
        """The stream's next ``n`` words (``engine()`` ``n`` times), as uint32."""
        out = []
        while n > 0:
            if self.mti >= _N:
                self._twist()
            take = min(n, _N - self.mti)
            out.append(self.mt[self.mti:self.mti + take])
            self.mti += take
            n -= take
        return _temper(np.concatenate(out) if out else np.zeros(0, np.uint32))


def canonical_float(words: np.ndarray) -> np.ndarray:
    """libstdc++ generate_canonical<float, 24> of each 32-bit word: float32."""
    ret = np.asarray(words, np.uint32).astype(np.float32) / np.float32(4294967296.0)
    # a word near 2^32 rounds to 1.0f, which libstdc++ clamps below 1
    return np.minimum(ret, _ONE_MINUS_ULP)


def uniform_float(canon: np.ndarray, lo: float = 0.0, hi: float = 1.0) -> np.ndarray:
    """std::uniform_real_distribution<float>(lo, hi) under libstdc++, of
    canonical floats (``canonical_float``): ``ret * (hi - lo) + lo`` in float32."""
    lo32 = np.float32(lo)
    hi32 = np.float32(hi)
    return canon * (hi32 - lo32) + lo32
