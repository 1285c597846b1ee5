"""Port: a band's set-up (ops/trace.py ``pack_state``).

On a CUDA device ``pack_state`` launches one hand-written kernel
(``csrc/packstate.cu``) that writes every row of the band's initial state and,
on the paged path, the first sort key; on the CPU it runs the plain torch
version ``pack_state_plain``.  The kernel is held against the plain version
bit for bit on the card (tests/test_torch_cuda.py, chip_smoke.py phase 3).
Here the plain version is pinned to the state it has always packed (digests
of every output, taken before the kernel existed), the route is checked to
follow the tensors' device, and the driver's ``band.setup`` span to name the
route it took.
"""

import hashlib
import time

import numpy as np
import pytest
import torch

from raytrace_tpu_torch import RenderConfig
from raytrace_tpu_torch.models.scene import generate_random_scene, random_sphere_field
from raytrace_tpu_torch.ops import launches, trace
from raytrace_tpu_torch.runtime.balance import build_passign
from raytrace_tpu_torch.runtime.renderer import Renderer, reference_camera

torch.set_num_threads(1)

W, H = 24, 14
NUMBER = 4100000001  # a seed past 2**31, as the benchmark draws them


def _scene(backend):
    sc = (random_sphere_field(2000, seed=1, extent=7.0) if backend == "paged"
          else generate_random_scene(0.0))
    ds = trace.device_scene_from_numpy(trace.prepare_scene(sc), "cpu")
    assert (ds.paged if backend == "paged" else ds.grid) is not None
    return ds


def _table(m):
    cost = np.random.default_rng(5).random(W * H)
    return torch.from_numpy(build_passign(cost, m, trace.LANE_PAD))


def _accum(m):
    g = torch.Generator().manual_seed(m)
    return torch.rand((H, W, 3), generator=g)


# name: (backend, pack_state keywords beyond the scene and viewport)
CASES = {
    "grid_m1": ("grid", dict(pixels_per_lane=1)),
    "grid_m2_passign": ("grid", dict(pixels_per_lane=2, passign=2)),
    "grid_m16_passign_merged": ("grid", dict(pixels_per_lane=16, passign=16, spp=1,
                                             n_calls=65, spp_last=1)),
    "grid_band_offset_spp0": ("grid", dict(band_h=8, y0=6, seed_y0=6, offset_x=5,
                                           spp=0, pixels_per_lane=2)),
    "paged_m2": ("paged", dict(pixels_per_lane=2)),
    "paged_m31": ("paged", dict(pixels_per_lane=31)),
    "paged_band_offset": ("paged", dict(band_h=8, y0=6, seed_y0=6, offset_x=5,
                                        pixels_per_lane=3)),
    "mega_m2_accum": ("mega", dict(pixels_per_lane=2, accum_init=2)),
    "mega_m16_accum": ("mega", dict(pixels_per_lane=16, accum_init=16)),
}


def _kwargs(backend, extra):
    kw = dict(backend=backend, band_h=H, width=W, y0=0, seed_y0=0, offset_x=0, spp=2,
              number=NUMBER)
    kw.update(extra)
    if "passign" in kw:
        kw["passign"] = _table(kw["passign"])
    if "accum_init" in kw:
        kw["accum_init"] = _accum(kw["accum_init"])[: kw["band_h"]]
    return kw


def _digest(t):
    return hashlib.sha256(t.contiguous().numpy().tobytes()).hexdigest()[:16]


# sha256 (first 16 hex digits) of fstate, ustate, scal and vpr, and of the
# paged first key, as pack_state and _rebucket_key packed them before the
# set-up kernel existed
PINS = {
    "grid_m1": ["9148ed93808daeba", "7c91ccfc78087ff5", "d6ce0c00755ca19f", "6c4136dd67ca79de"],
    "grid_m2_passign": [
        "d843078435a2861e", "eb72fb4ace7e0b9f", "d6ce0c00755ca19f", "6c4136dd67ca79de"],
    "grid_m16_passign_merged": [
        "c1ccc5802161b87d", "d1dc71b91cb1dc64", "9e2fd5502a5533a5", "6c4136dd67ca79de"],
    "grid_band_offset_spp0": [
        "e22dde3b6536675f", "cbc1c44c542dbca0", "bbe44ef3bfecdb8c", "6c4136dd67ca79de"],
    "paged_m2": [
        "db04ea22e14e2f2b", "3a393f4278d4ec52", "d6ce0c00755ca19f",
        "6c4136dd67ca79de", "69c192ececcdbc55"],
    "paged_m31": [
        "726a5e706e45255b", "681ed2f097b128fb", "d6ce0c00755ca19f",
        "6c4136dd67ca79de", "ea743283c8a310e4"],
    "paged_band_offset": [
        "c0b8e9a8b4d23ea8", "1b16f933301697fe", "d70a967577d5f048",
        "6c4136dd67ca79de", "4e2c52b894ed8195"],
    "mega_m2_accum": [
        "18f0e7e18398ba62", "2631c5811b7c0778", "d6ce0c00755ca19f", "6c4136dd67ca79de"],
    "mega_m16_accum": [
        "45fd26162746d364", "091628c6073e63f0", "d6ce0c00755ca19f", "6c4136dd67ca79de"],
}


@pytest.mark.parametrize("name", list(CASES))
def test_plain_state_is_pinned(name):
    """``pack_state_plain`` packs the same state, row for row and bit for bit,
    as the set-up always has (grid with and without a balanced table, at
    M = 1, 2 and 16 with the call merge's slots; paged at M = 2 and 31;
    mega with a carried accumulator; a band below the top with an x offset,
    and one of no samples), and the paged first key is ``_rebucket_key`` of
    that state."""
    backend, extra = CASES[name]
    ds = _scene(backend)
    kw = _kwargs(backend, extra)
    vp = trace.viewport_arrays(reference_camera(), W, H)
    first_key = backend == "paged"
    out = trace.pack_state_plain(ds, vp, first_key=first_key, **kw)
    f, u, scal, vpr, geom = out[:5]
    got = [_digest(t) for t in (f, u, scal, vpr)]
    if first_key:
        key = out[5]
        assert torch.equal(key, trace._rebucket_key(f, u, ds.paged.gscal))
        got.append(_digest(key))
    assert got == PINS[name]
    m = kw["pixels_per_lane"]
    assert geom == dict(m_slots=m, n_lanes=-(-kw["band_h"] * W // m),
                        p_total=kw["band_h"] * W, width=W)


def test_route_follows_the_device():
    """CPU tensors take the plain route and count in its ``launches``; the
    kernel's count does not move.  A CUDA device names the kernel route
    (decided from the device alone, without a card)."""
    assert trace.state_route("cpu") == "plain"
    assert trace.state_route(torch.device("cuda", 0)) == "kernel"
    ds = _scene("grid")
    vp = trace.viewport_arrays(reference_camera(), W, H)
    kernel0, plain0 = trace.pack_state.launches, trace.pack_state_plain.launches
    out = trace.pack_state(ds, vp, **_kwargs("grid", CASES["grid_m2_passign"][1]))
    assert trace.pack_state_plain.launches == plain0 + 1
    assert trace.pack_state.launches == kernel0
    assert [_digest(t) for t in out[:4]] == PINS["grid_m2_passign"]


@pytest.mark.parametrize("backend, extra, what", [
    ("grid", dict(first_key=True), "first sort key"),
    ("grid", dict(passign=1), "passign"),  # a table of another M
])
def test_set_up_refuses_what_its_state_cannot_hold(backend, extra, what):
    """A first sort key outside the paged backend, and a balanced table
    whose shape is not the band's (M slots by the padded lanes), raise."""
    ds = _scene(backend)
    vp = trace.viewport_arrays(reference_camera(), W, H)
    kw = _kwargs(backend, dict(extra, pixels_per_lane=2))
    with pytest.raises(ValueError, match=what):
        trace.pack_state(ds, vp, **kw)


@pytest.mark.parametrize("backend", ["grid", "paged"])
def test_band_setup_span_names_its_route(backend):
    """Under the profiler each band's ``band.setup`` span carries the route
    its set-up took: ``plain`` for a render on the CPU, one plain set-up
    per band."""
    sc = (random_sphere_field(2000, seed=1, extent=7.0) if backend == "paged"
          else generate_random_scene(0.0))
    r = Renderer(RenderConfig(samples=1, width=16, height=8, max_depth=3), scene=sc,
                 device="cpu")
    assert r.backend == backend
    r.chunk_rows = 3  # three bands
    plain0 = trace.pack_state_plain.launches
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        r.render_call(1, number=3)
    setups = [rec for rec in launches.records(t0) if rec.name == "band.setup"]
    assert len(setups) == 3
    assert all(rec.attrs["route"] == "plain" and rec.attrs["backend"] == backend
               for rec in setups)
    assert trace.pack_state_plain.launches == plain0 + 3
