"""Port: the CPU oracle (``raytrace_tpu_torch/oracle``) against the JAX
package's and the stored golden.

The port's oracle is the JAX package's numpy oracle copied line for line,
with its own numpy RNG (``oracle/rng_np.py``), so both must agree bit for
bit (tolerance 0): on the 24x14 x 2 spp, depth 12 golden config (also
against ``tests/data``'s golden, which is the JAX oracle's f64 sum cast to
f32), on the three-sphere scene, and on a band with an offset, fast mode's
Russian roulette and an f32 accumulator.  The port's ``bruteforce`` spec
path holds against the port's oracle under the golden rule (at most 3 of
336 pixels off by more than 1e-4, tests/test_golden_fullscene.py).
"""

import os

import numpy as np
import pytest
import torch

from raytrace_tpu.config import RenderCallInfo as JaxInfo
from raytrace_tpu.models.scene import generate_random_scene as jax_book
from raytrace_tpu.models.scene import three_sphere_scene as jax_three
from raytrace_tpu.ops import rng as jax_rng
from raytrace_tpu.oracle.cpu_reference import render_oracle as jax_oracle
from raytrace_tpu_torch.config import RR_CAP_DEPTH, RR_PMIN, RR_START_DEPTH, RenderCallInfo
from raytrace_tpu_torch.models.scene import generate_random_scene, three_sphere_scene
from raytrace_tpu_torch.ops import trace
from raytrace_tpu_torch.oracle import rng_np
from raytrace_tpu_torch.oracle.cpu_reference import render_oracle
from raytrace_tpu_torch.runtime.renderer import reference_camera

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "data", "golden_fullscene_24x14_2spp_d12.npy")
W, H, SPP, DEPTH = 24, 14, 2, 12
RR = (RR_START_DEPTH, RR_CAP_DEPTH, RR_PMIN)


def _bits(x):
    x = np.asarray(x)
    return x.view(np.uint32) if x.dtype == np.float32 else x


@pytest.fixture(scope="module")
def seeds():
    return np.random.default_rng(0).integers(0, 2**32, size=4096, dtype=np.uint64).astype(
        np.uint32)


@pytest.mark.parametrize("fn, args", [
    ("tea_hash", ()), ("lcg_next", ()), ("random_float", ()),
    ("random_in_interval", (-1.0, 1.0)), ("random_vector3", (-2.0, 3.0)),
    ("random_unit_vector", ()),
])
def test_rng_bit_equal_on_4096_seeds(seeds, fn, args):
    if fn == "tea_hash":
        ours = rng_np.tea_hash(seeds, seeds[::-1].copy())
        theirs = jax_rng.tea_hash(seeds, seeds[::-1].copy())
    else:
        ours = getattr(rng_np, fn)(seeds, *args)
        theirs = getattr(jax_rng, fn)(seeds, *args)
    ours, theirs = (o if isinstance(o, tuple) else (o,) for o in (ours, theirs))
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        assert a.dtype == b.dtype and np.array_equal(_bits(a), _bits(b))


def test_rng_scalar_stream_bit_equal():
    """The oracle draws from numpy scalars one at a time."""
    s_ours = s_theirs = rng_np.tea_hash(np.uint32(5), np.uint32(7))
    for _ in range(64):
        s_ours, u_ours = rng_np.random_float(s_ours)
        s_theirs, u_theirs = jax_rng.random_float(s_theirs)
        assert s_ours == s_theirs and _bits(u_ours) == _bits(u_theirs)


@pytest.fixture(scope="module")
def golden_config():
    info = RenderCallInfo(samples_per_render_call=SPP, image_size=(W, H))
    jinfo = JaxInfo(samples_per_render_call=SPP, image_size=(W, H))
    return (render_oracle(generate_random_scene(0.0), info, max_depth=DEPTH),
            jax_oracle(jax_book(0.0), jinfo, max_depth=DEPTH))


def test_oracle_bit_equal_to_jax_oracle_on_golden_config(golden_config):
    ours, theirs = golden_config
    assert ours.dtype == theirs.dtype == np.float64 and ours.shape == (H, W, 3)
    assert np.array_equal(ours, theirs)


def test_oracle_bit_equal_to_stored_golden(golden_config):
    golden = np.load(GOLDEN)
    assert np.array_equal(_bits(golden_config[0].astype(np.float32)), _bits(golden))


@pytest.mark.parametrize("case", ["three_sphere", "band_rr_f32"])
def test_oracle_bit_equal_to_jax_oracle(case):
    if case == "three_sphere":
        kw = dict(info=dict(samples_per_render_call=4, image_size=(32, 18)), max_depth=8)
        ours_scene, jax_scene = three_sphere_scene(), jax_three()
    else:  # a 4-row band 5 rows down, call number 3, fast mode, f32 sums
        kw = dict(info=dict(number=3, samples_per_render_call=2, offset=(0, 5),
                            image_size=(16, 12)),
                  max_depth=DEPTH, band_height=4, accum_dtype=np.float32, rr=RR)
        ours_scene, jax_scene = generate_random_scene(0.0), jax_book(0.0)
    info = kw.pop("info")
    ours = render_oracle(ours_scene, RenderCallInfo(**info), **kw)
    theirs = jax_oracle(jax_scene, JaxInfo(**info), **kw)
    assert ours.dtype == theirs.dtype and ours.shape == theirs.shape
    assert np.array_equal(_bits(ours), _bits(theirs))


def test_bruteforce_holds_against_port_oracle(golden_config):
    ds = trace.device_scene_from_numpy(trace.prepare_scene(generate_random_scene(0.0)), "cpu")
    vp = trace.viewport_arrays(reference_camera(), W, H)
    out = trace.render_band(ds, vp, band_h=H, width=W, y0=0, seed_y0=0, offset_x=0,
                            spp=SPP, number=0, max_depth=DEPTH, backend="bruteforce",
                            pixels_per_lane=1).numpy()
    bad = int((np.abs(out - golden_config[0]).max(axis=2) > 1e-4).sum())
    assert bad <= 3, f"{bad} of {W * H} pixels off by > 1e-4"
