"""Counter/stream RNG ops, bit-exact with the reference device RNG.

Port of ``raytrace_tpu/ops/rng.py`` (the GLSL ``random.glsl``): TEA 16-round
seed hash, the LCG ``seed = 1664525*seed + 1013904223``, 24-bit floats and the
normalize-of-uniform-cube unit vector.

PyTorch on the CPU has no add, shift or compare for ``torch.uint32``, so a u32
value is held as ``torch.int64`` in ``[0, 2**32)`` and masked back to 32 bits
after every add, multiply and shift.  The CUDA kernels use ``uint32_t``; the
state tensors keep the u32 bits in ``torch.int32`` storage (``to_u32`` /
``to_i32`` convert).
"""

from __future__ import annotations

import numpy as np
import torch

from . import fp

MASK = 0xFFFFFFFF
_K0, _K1, _K2, _K3 = 0xA341316C, 0xC8013EA4, 0xAD90777D, 0x7E95761E


def to_u32(x: torch.Tensor) -> torch.Tensor:
    """Any integer tensor (u32 bits in int32 storage included) -> int64 u32."""
    return x.to(torch.int64) & MASK


def to_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 u32 (or any int64 whose low 32 bits matter) -> int32 bits."""
    x = x & MASK
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


def tea_hash(val0: torch.Tensor, val1: torch.Tensor) -> torch.Tensor:
    """getRandomSeed — TEA 16 rounds (random.glsl:1-13), elementwise u32."""
    v0 = to_u32(val0)
    v1 = to_u32(val1)
    v0, v1 = torch.broadcast_tensors(v0, v1)
    for n in range(16):
        s0 = ((n + 1) * 0x9E3779B9) & MASK
        v0 = (v0 + ((((v1 << 4) + _K0) ^ (v1 + s0)) ^ ((v1 >> 5) + _K1))) & MASK
        v1 = (v1 + ((((v0 << 4) + _K2) ^ (v0 + s0)) ^ ((v0 >> 5) + _K3))) & MASK
    return v0


def lcg_next(seed: torch.Tensor) -> torch.Tensor:
    """randomInt — LCG step (random.glsl:15-18)."""
    return (seed * 1664525 + 1013904223) & MASK


def random_float(seed: torch.Tensor):
    """randomFloat (random.glsl:20-22). Returns (new_seed, f32 in [0,1))."""
    seed = lcg_next(seed)
    f = (seed & 0x00FFFFFF).to(torch.float32)  # exact: 24 bits
    return seed, f / 16777216.0


def random_in_interval(seed: torch.Tensor, lo: float, hi: float):
    """randomInInterval (random.glsl:24-26): r * (hi - lo) + lo in f32."""
    seed, r = random_float(seed)
    return seed, r * float(np.float32(hi) - np.float32(lo)) + float(np.float32(lo))


def random_unit_vector(seed: torch.Tensor):
    """randomUnitVector (random.glsl:32-34): normalize(uniform in [-1,1]^3).

    Faithful to the reference's corner-biased distribution.  Returns
    (new_seed, x, y, z)."""
    seed, x = random_in_interval(seed, -1.0, 1.0)
    seed, y = random_in_interval(seed, -1.0, 1.0)
    seed, z = random_in_interval(seed, -1.0, 1.0)
    inv = 1.0 / fp.sqrt(x * x + y * y + z * z)
    return seed, x * inv, y * inv, z * inv
