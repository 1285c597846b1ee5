"""Port: the block-drawn ``std::mt19937`` (models/mt19937.py) against the
JAX package's scalar engine, which tests/test_mt19937.py pins to libstdc++.

``MT19937.draw(n)`` must give the scalar engine's words in any split of the
stream into blocks, on and off the 624-word twist boundary, and the array
``canonical_float`` / ``uniform_float`` the scalar draws' float32 bytes,
with the words near 2^32 that round to 1.0f clamped below 1.
"""

import numpy as np
import pytest

from raytrace_tpu.models import mt19937 as jmt
from raytrace_tpu_torch.models import mt19937 as tmt

N_WORDS = 10_000


class _Words:
    """A stand-in engine whose ``next_u32`` returns given words in turn."""

    def __init__(self, words):
        self._it = iter(int(w) for w in words)

    def next_u32(self):
        return next(self._it)


def _scalar_words(n=N_WORDS):
    eng = jmt.MT19937()
    return np.array([eng.next_u32() for _ in range(n)], np.uint32)


# the words near 2^32: from 2^32 - 128 up, float32(x) rounds to 2^32 and
# x / 2^32 to 1.0f, which the distribution clamps to nextafter(1.0f, 0.0f)
EDGE_WORDS = np.array([0, 1, 2, 255, 256, 1 << 24, (1 << 24) + 1, 1 << 31,
                       0xFFFFFF00, 0xFFFFFF7F, 0xFFFFFF80, 0xFFFFFF81,
                       0xFFFFFFFE, 0xFFFFFFFF], np.uint32)


@pytest.mark.parametrize("blocks", [
    [N_WORDS],
    [624] * 16 + [N_WORDS - 624 * 16],
    [1, 623, 624, 1000, 7, 2500, 5245],
    [0, 227, 0, 1021, 3, 311] * 6 + [N_WORDS - 1562 * 6],
], ids=["one", "twists", "uneven", "odd_and_empty"])
def test_block_words_equal_scalar_engine(blocks):
    assert sum(blocks) == N_WORDS
    eng = tmt.MT19937()
    parts = [eng.draw(n) for n in blocks]
    assert all(p.dtype == np.uint32 and p.shape == (n,) for p, n in zip(parts, blocks))
    got = np.concatenate(parts)
    np.testing.assert_array_equal(got, _scalar_words())
    # ISO C++ [rand.predef]: the 10000th invocation from the default seed
    assert got[N_WORDS - 1] == 4123659995


def test_draw_leaves_the_engine_state_to_the_stream():
    """Tempering a block must not write into the engine's state."""
    eng = tmt.MT19937()
    before = eng.mt.copy()
    eng.draw(10)
    assert eng.mti == 10
    # the first twist replaced the seeded state; drawing again does not alter it
    state = eng.mt.copy()
    eng.draw(600)
    np.testing.assert_array_equal(eng.mt, state)
    assert not np.array_equal(state, before)


@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (0.0, 360.0), (0.5, 1.0), (-11.0, 11.0)])
def test_canonical_and_uniform_byte_equal_scalar(lo, hi):
    words = np.concatenate([_scalar_words(), EDGE_WORDS])
    canon = tmt.canonical_float(words)
    uni = tmt.uniform_float(canon, lo, hi)
    eng_c, eng_u = _Words(words), _Words(words)
    want_c = np.array([jmt.canonical_float(eng_c) for _ in words], np.float32)
    want_u = np.array([jmt.uniform_float(eng_u, lo, hi) for _ in words], np.float32)
    assert canon.dtype == uni.dtype == np.float32
    assert canon.tobytes() == want_c.tobytes()
    assert uni.tobytes() == want_u.tobytes()


def test_words_near_two_to_the_32_clamp_below_one():
    canon = tmt.canonical_float(EDGE_WORDS)
    below_one = np.nextafter(np.float32(1.0), np.float32(0.0))
    near = EDGE_WORDS >= 0xFFFFFF80
    assert near.sum() == 4 and (canon[near] == below_one).all()
    # below them the quotient is exact: float32(x) over a power of two
    exact = EDGE_WORDS[~near].astype(np.float32).astype(np.float64) / 2.0**32
    assert (canon[~near].astype(np.float64) == exact).all()
    assert canon.max() == below_one
    assert tmt.uniform_float(canon, 0.0, 360.0).max() < np.float32(360.0)
