"""The reference device RNG in numpy uint32, for the CPU oracle.

Port copy of the numpy path of ``raytrace_tpu/ops/rng.py`` (the GLSL
``random.glsl``): ``getRandomSeed`` (TEA 16 rounds, :1-13), ``randomInt``
(the LCG ``seed = 1664525*seed + 1013904223``, :15-18), ``randomFloat``
(24-bit mantissa, :20-22), ``randomInInterval``, ``randomVector`` and
``randomUnitVector`` (normalize of uniform-in-cube, :24-34: deliberately not
uniform on the sphere).  Elementwise over numpy uint32 values; integer
arithmetic wraps mod 2**32.  The port's ``ops/rng.py`` is the same stream in
torch int64 for the render path.
"""

from __future__ import annotations

import numpy as np

_U = np.uint32


def tea_hash(val0, val1):
    """getRandomSeed — TEA 16 rounds (random.glsl:1-13). Elementwise uint32."""
    with np.errstate(over="ignore"):  # uint32 wrap is the intended semantics
        v0 = val0 + _U(0) * val1  # broadcast to common shape
        v1 = val1 + _U(0) * val0
        for n in range(16):
            s0 = _U(((n + 1) * 0x9E3779B9) & 0xFFFFFFFF)
            v0 = v0 + ((((v1 << _U(4)) + _U(0xA341316C)) ^ (v1 + s0)) ^ ((v1 >> _U(5)) + _U(0xC8013EA4)))
            v1 = v1 + ((((v0 << _U(4)) + _U(0xAD90777D)) ^ (v0 + s0)) ^ ((v0 >> _U(5)) + _U(0x7E95761E)))
        return v0


def lcg_next(seed):
    """randomInt — LCG step (random.glsl:15-18)."""
    with np.errstate(over="ignore"):  # uint32 wrap is the intended semantics
        return seed * _U(1664525) + _U(1013904223)


def random_float(seed):
    """randomFloat (random.glsl:20-22). Returns (new_seed, f32 in [0,1));
    the u32 -> f32 cast goes through i32, exact since the mask keeps 24
    bits."""
    seed = lcg_next(seed)
    masked = seed & _U(0x00FFFFFF)
    f = masked.astype(np.int32).astype(np.float32)
    return seed, f / np.float32(0x01000000)


def random_in_interval(seed, lo, hi):
    """randomInInterval (random.glsl:24-26)."""
    seed, r = random_float(seed)
    return seed, r * (np.float32(hi) - np.float32(lo)) + np.float32(lo)


def random_vector3(seed, lo, hi):
    """randomVector (random.glsl:28-30): three sequential draws."""
    seed, x = random_in_interval(seed, lo, hi)
    seed, y = random_in_interval(seed, lo, hi)
    seed, z = random_in_interval(seed, lo, hi)
    return seed, x, y, z


def random_unit_vector(seed):
    """randomUnitVector (random.glsl:32-34): normalize(uniform in [-1,1]^3),
    the reference's corner-biased distribution.  Returns (new_seed, x, y,
    z); a zero vector gives inf/nan, as GLSL's normalize does."""
    seed, x, y, z = random_vector3(seed, -1.0, 1.0)
    inv = np.float32(1.0) / np.sqrt(x * x + y * y + z * z)
    return seed, x * inv, y * inv, z * inv
