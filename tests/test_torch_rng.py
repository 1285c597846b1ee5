"""Port parity: the TEA + LCG random streams, bit for bit.

The port holds u32 values as int64 masked to 32 bits (torch on the CPU has
no add, shift or compare for uint32); every primitive must reproduce
``raytrace_tpu.ops.rng`` exactly on seeded numpy u32 inputs, including
values near 2**32 where the masking matters.
"""

import numpy as np
import pytest
import torch

from raytrace_tpu.ops import rng as jrng
from raytrace_tpu_torch.ops import rng as trng

torch.set_num_threads(1)

_EDGES = np.array([0, 1, 2, 0x7FFFFFFF, 0x80000000, 0x80000001, 0xFFFFFFFE,
                   0xFFFFFFFF, 0xFF000000, 0x00FFFFFF], np.uint32)


def _u32(seed, n=4096):
    rng = np.random.default_rng(seed)
    vals = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    near_top = (np.uint64(2**32) - rng.integers(1, 4096, 64, dtype=np.uint64)).astype(np.uint32)
    return np.concatenate([vals, near_top, _EDGES])


def _t(a):
    return torch.from_numpy(a.astype(np.int64))


def _np(t):
    return t.numpy().astype(np.uint32)


def test_tea_hash_bit_exact():
    a, b = _u32(0), _u32(1)
    assert np.array_equal(_np(trng.tea_hash(_t(a), _t(b))), jrng.tea_hash(a, b))


def test_tea_hash_accepts_int32_bit_storage():
    """State tensors keep u32 bits in int32 storage; the hash reads them."""
    a, b = _u32(2), _u32(3)
    got = trng.tea_hash(torch.from_numpy(a.view(np.int32)), torch.from_numpy(b.view(np.int32)))
    assert np.array_equal(_np(got), jrng.tea_hash(a, b))


def test_lcg_next_bit_exact():
    a = _u32(4)
    assert np.array_equal(_np(trng.lcg_next(_t(a))), jrng.lcg_next(a))


def test_random_float_bit_exact():
    a = _u32(5)
    s_ref, f_ref = jrng.random_float(a)
    s, f = trng.random_float(_t(a))
    assert np.array_equal(_np(s), s_ref)
    assert f.dtype == torch.float32
    assert f.numpy().tobytes() == np.asarray(f_ref, np.float32).tobytes()


@pytest.mark.parametrize("lo,hi", [(-1.0, 1.0), (0.5, 1.0), (0.0, 360.0)])
def test_random_in_interval_bit_exact(lo, hi):
    a = _u32(6)
    s_ref, v_ref = jrng.random_in_interval(a, lo, hi)
    s, v = trng.random_in_interval(_t(a), lo, hi)
    assert np.array_equal(_np(s), s_ref)
    assert v.numpy().tobytes() == np.asarray(v_ref, np.float32).tobytes()


def test_random_unit_vector_bit_exact():
    a = _u32(7)
    ref = jrng.random_unit_vector(a)
    got = trng.random_unit_vector(_t(a))
    assert np.array_equal(_np(got[0]), ref[0])
    for g, r in zip(got[1:], ref[1:]):
        assert g.numpy().tobytes() == np.asarray(r, np.float32).tobytes()


def test_int32_round_trip():
    a = _u32(8)
    bits = trng.to_i32(_t(a))
    assert bits.dtype == torch.int32
    assert np.array_equal(bits.numpy().view(np.uint32), a)
    assert np.array_equal(_np(trng.to_u32(bits)), a)
