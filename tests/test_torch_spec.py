"""Port parity: the eager spec path (``bruteforce``) against the goldens.

The spec path is the generic wavefront loop of the JAX ``render_band_core``
in eager torch, in the CPU oracle's fp op order.  It must reproduce the
oracle golden near-bitwise (the rule of tests/test_golden_fullscene.py:
at most 3 of 336 pixels off by more than 1e-4), keep the band-offset,
progressive-call and pixels-per-lane invariances of
tests/test_trace_golden.py, and in fast mode stay near-bitwise to the JAX
bruteforce backend under the same 3-pixel rule.
"""

import os

import numpy as np
import pytest
import torch

from raytrace_tpu.config import RR_CAP_DEPTH, RR_PMIN, RR_START_DEPTH
from raytrace_tpu.models.scene import generate_random_scene as j_book
from raytrace_tpu.ops import trace as jtrace
from raytrace_tpu_torch.models.scene import generate_random_scene, three_sphere_scene
from raytrace_tpu_torch.ops import trace
from raytrace_tpu_torch.runtime.renderer import reference_camera

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "data",
                      "golden_fullscene_24x14_2spp_d12.npy")
RR = (RR_START_DEPTH, RR_CAP_DEPTH, RR_PMIN)


def _near_bitwise(out, ref, allow=3):
    bad = int((np.abs(out - ref).max(axis=2) > 1e-4).sum())
    assert bad <= allow, f"{bad} pixels off (allow {allow})"


def _render(scene, w, h, *, spp, depth, band_h=None, y0=0, number=0,
            accum=None, m=1, rr=None):
    ds = trace.device_scene_from_numpy(trace.prepare_scene(scene), "cpu")
    vp = trace.viewport_arrays(reference_camera(), w, h)
    return trace.render_band(
        ds, vp, band_h=h if band_h is None else band_h, width=w, y0=y0,
        seed_y0=y0, offset_x=0, spp=spp, number=number, accum_init=accum,
        max_depth=depth, backend="bruteforce", pixels_per_lane=m, rr=rr).numpy()


@pytest.fixture(scope="module")
def three():
    return three_sphere_scene()


@pytest.fixture(scope="module")
def full3(three):
    return _render(three, 32, 18, spp=4, depth=8)


def test_bruteforce_matches_golden():
    out = _render(generate_random_scene(0.0), 24, 14, spp=2, depth=12)
    _near_bitwise(out, np.load(GOLDEN))


def test_band_offset_consistency(three, full3):
    band = _render(three, 32, 18, spp=4, depth=8, y0=6, band_h=6)
    assert np.array_equal(band, full3[6:12])


def test_progressive_accumulation(three, full3):
    two = _render(three, 32, 18, spp=4, depth=8, accum=torch.from_numpy(full3))
    assert np.allclose(two, 2 * full3, rtol=1e-6)


def test_progressive_number_decorrelates(three, full3):
    b = _render(three, 32, 18, spp=4, depth=8, number=1)
    assert not np.array_equal(full3, b)
    assert abs(full3.mean() - b.mean()) / full3.mean() < 0.05


@pytest.mark.parametrize("m", [4, 7])
def test_pixels_per_lane_invariant(three, full3, m):
    assert np.array_equal(_render(three, 32, 18, spp=4, depth=8, m=m), full3)


def test_spp_zero_is_black(three):
    assert np.all(_render(three, 32, 18, spp=0, depth=8) == 0)


def test_fast_mode_near_bitwise_to_jax():
    """Russian roulette draws the same stream in both implementations."""
    sc = j_book(0.0)
    ref = np.asarray(jtrace.render_band(
        jtrace.prepare_scene(sc), jtrace.viewport_arrays(reference_camera(), 24, 14),
        band_h=14, width=24, y0=np.int32(0), seed_y0=np.int32(0),
        offset_x=np.int32(0), spp=np.int32(2), number=np.uint32(0),
        max_depth=12, backend="bruteforce", pixels_per_lane=1, rr=RR))
    out = _render(generate_random_scene(0.0), 24, 14, spp=2, depth=12, rr=RR)
    _near_bitwise(out, ref)
    exact = _render(generate_random_scene(0.0), 24, 14, spp=2, depth=12)
    assert not np.array_equal(out, exact)  # RR really changed the paths
