"""Port: the program's spans (ops/launches.py ``span``, ``section``,
``records``) in the renderer, the band drivers, the scene generators and
the scene's tables (their upload and, on either route, the paged build).

Off (no profiler running) a span records nothing and opens no profiler
range.  On, each render call logs one ``renderer.call``, one ``band.setup``
per band under it and one ``grid.launch`` or ``paged.launch`` per kernel
launch, whose live counts add up to the driver's own lane-slot tally; the
profiler sees the ``rt.*`` ranges as function ranges, not as user
annotations (which the profiler copies onto the device's timeline).  The
image is the same either way.
"""

import sys
import threading
import time

import pytest
import torch

from raytrace_tpu_torch import RenderConfig
from raytrace_tpu_torch.models.scene import generate_random_scene, random_sphere_field
from raytrace_tpu_torch.models.grid import MAX_SPHERES
from raytrace_tpu_torch.ops import gridkernel, launches, pagedkernel, trace
from raytrace_tpu_torch.ops.trace import LANE_PAD
from raytrace_tpu_torch.runtime.renderer import Renderer

torch.set_num_threads(1)

STEP = {"grid": gridkernel.grid_megakernel_step_plain,
        "paged": pagedkernel.paged_megakernel_step_plain}
SECTIONS = {"grid": ("rt.grid.count", "rt.grid.compact", "rt.grid.step"),
            "paged": ("rt.paged.order", "rt.paged.gather", "rt.paged.step")}


def _scene(backend):
    if backend == "grid":
        return generate_random_scene(0.0)
    return random_sphere_field(2000, seed=1, extent=7.0)


def _renderer(backend):
    cfg = RenderConfig(samples=1, width=16, height=8, max_depth=3)
    r = Renderer(cfg, scene=_scene(backend), device="cpu")
    assert r.backend == backend
    r.chunk_rows = 3  # three bands of 3, 3 and 2 rows
    return r


def _profiled():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


@pytest.mark.parametrize("backend", ["grid", "paged"])
def test_off_records_nothing_and_opens_no_range(backend, monkeypatch):
    def no_range(name):
        raise AssertionError(f"a profiler range {name!r} was opened with the profiler off")

    monkeypatch.setattr(launches, "_RANGE", no_range)
    t0 = time.perf_counter()
    r = _renderer(backend)
    r.set_scene(_scene(backend))
    r.render_call(1)
    assert not launches.recording()
    assert launches.records(t0) == []


@pytest.mark.parametrize("backend", ["grid", "paged"])
def test_on_one_record_per_call_band_and_launch(backend):
    r = _renderer(backend)
    launches_before = STEP[backend].launches
    t0 = time.perf_counter()
    with _profiled() as prof:
        r.set_scene(_scene(backend))
        _, _, lane_slots = r.render_call(1, number=3, return_iters=True)
    recs = launches.records(t0)
    by_name = {}
    for rec in recs:
        by_name.setdefault(rec.name, []).append(rec)

    (put,) = by_name["renderer.set_scene"]
    (prep,) = by_name["scene.prepare"]
    assert put.attrs["backend"] == backend and prep.attrs["tables"] == backend
    assert prep.parent == put.id and put.t0 <= prep.t0 <= prep.t1 <= put.t1

    (call,) = by_name["renderer.call"]
    assert call.attrs == {"spp": 1, "n_calls": 1, "bands": 3}
    setups = by_name["band.setup"]
    assert [s.attrs["y0"] for s in setups] == [0, 3, 6]
    assert all(s.parent == call.id and s.attrs["backend"] == backend for s in setups)
    assert all(s.attrs["n_lanes"] > 0 and s.attrs["m_slots"] >= 1 for s in setups)

    runs = by_name[f"{backend}.launch"]
    assert len(runs) == STEP[backend].launches - launches_before
    assert sum(x.attrs["k"] * -(-x.attrs["n_live"] // LANE_PAD) * LANE_PAD
               for x in runs) == lane_slots
    bands, first = 0, None
    for x in runs:
        a = x.attrs
        assert x.parent == call.id and call.t0 <= x.t0 <= x.t1 <= call.t1
        assert a["t_counted"] <= a["t_issued"] <= a["t_done"]
        if a["index"] == 0:
            bands, first = bands + 1, a["n_live"]
        assert a["n_first"] == first and 0 < a["n_live"] <= first
    assert bands == 3

    names = {e.name: e for e in prof.events()}
    for name in ("rt.renderer.call", "rt.renderer.set_scene", "rt.scene.prepare",
                 "rt.scene.generate", "rt.band.setup", f"rt.{backend}.launch",
                 *SECTIONS[backend]):
        assert name in names, name
        assert names[name].is_user_annotation is False, name


def test_set_scene_logs_one_grid_prepare_per_call():
    """The frame loop's scene swap: each ``set_scene`` of the book scene logs
    one ``scene.prepare`` record, tables "grid" built on the host, under its
    own ``renderer.set_scene`` (the record scene_prepare_ms.anim reads)."""
    r = Renderer(RenderConfig(samples=1, width=16, height=8, max_depth=3), device="cpu")
    times = (0.0, 1 / 60, 317.41, 599.983)
    t0 = time.perf_counter()
    with _profiled():
        for t in times:
            r.set_scene(generate_random_scene(t))
    recs = launches.records(t0)
    puts = [x for x in recs if x.name == "renderer.set_scene"]
    preps = [x for x in recs if x.name == "scene.prepare"]
    assert len(puts) == len(preps) == len(times)
    for put, prep in zip(puts, preps):
        assert prep.attrs == {"tables": "grid", "route": "host"} and prep.parent == put.id
        assert put.t0 <= prep.t0 <= prep.t1 <= put.t1


def _route(monkeypatch, route):
    """Build a large scene's tables by ``route``: "device" (a scene the grid
    refuses by its size takes it by itself) or "host" (``prepare_scene``)."""
    monkeypatch.setattr(trace, "builds_on_device",
                        lambda scene: route == "device" and int(scene.n_spheres) >= MAX_SPHERES)


@pytest.mark.parametrize("route", ["host", "device"])
def test_set_scene_logs_the_upload_and_the_paged_build(route, monkeypatch):
    """A field too large for the grid: ``set_scene`` logs ``scene.upload``
    (the bytes sent and the devices), ``scene.prepare`` (route and tables)
    and under it ``paged.build`` (route, spheres, pairs, pages, slots and
    host reads of the device), each under ``renderer.set_scene``."""
    _route(monkeypatch, route)
    scene = random_sphere_field(5000, seed=4, extent=9.0, t=1.0)
    r = Renderer(RenderConfig(samples=1, width=16, height=8, max_depth=3), scene=scene,
                 device="cpu")
    t0 = time.perf_counter()
    with _profiled() as prof:
        r.set_scene(random_sphere_field(5000, seed=4, extent=9.0, t=2.0))
    by_name = {}
    for rec in launches.records(t0):
        by_name.setdefault(rec.name, []).append(rec)
    (put,) = by_name["renderer.set_scene"]
    (up,) = by_name["scene.upload"]
    (prep,) = by_name["scene.prepare"]
    (build,) = by_name["paged.build"]
    assert up.parent == put.id and prep.parent == put.id and build.parent == prep.id
    assert prep.t0 <= build.t0 <= build.t1 <= prep.t1
    assert prep.attrs == {"route": route, "tables": "paged"}
    assert up.attrs["devices"] == 1
    if route == "host":  # the whole DeviceScene goes up, after the build
        assert up.t0 >= prep.t1 and up.attrs["bytes"] > 20 * scene.centers.nbytes
    else:  # the scene's own arrays, 256-byte aligned, before the build
        assert up.t1 <= prep.t0 and up.attrs["bytes"] == 4 * 13 * 5120
    assert build.attrs["route"] == route and build.attrs["syncs"] == 5
    want = trace.prepare_scene(scene).paged
    assert build.attrs["n_spheres"] == 5004
    assert build.attrs["n_pages"] == want.lids.shape[0]
    assert build.attrs["n_slots"] == want.lids.shape[1]
    assert build.attrs["pairs"] > 5000
    names = {e.name for e in prof.events()}
    assert {"rt.scene.upload", "rt.paged.build"} <= names


@pytest.mark.parametrize("route", ["host", "device"])
def test_the_upload_and_the_build_record_nothing_off(route, monkeypatch):
    _route(monkeypatch, route)
    r = Renderer(RenderConfig(samples=1, width=16, height=8, max_depth=3),
                 scene=random_sphere_field(5000, seed=4, extent=9.0), device="cpu")
    t0 = time.perf_counter()
    r.set_scene(random_sphere_field(5000, seed=4, extent=9.0, t=2.0))
    assert r.backend == "paged"
    assert launches.records(t0) == []


@pytest.mark.parametrize("backend", ["grid", "paged"])
def test_the_image_is_the_same_with_the_profiler_on(backend):
    r = _renderer(backend)
    plain = r.render_call(2, number=5)
    with _profiled():
        traced = r.render_call(2, number=5)
    assert torch.equal(plain, traced)


def test_spans_on_many_threads_keep_their_parents():
    """Threads log into one list; each span's parent is the span open
    around it on its own thread, and no record is lost."""
    n_threads, n_spans = 16, 200
    t0 = time.perf_counter()
    errors = []

    def work(i):
        try:
            for j in range(n_spans):
                with launches.span("outer", thread=i, j=j) as outer:
                    with launches.span("inner", thread=i, j=j) as inner:
                        pass
                    assert inner.parent == outer.id
        except AssertionError as e:  # surfaced by the main thread below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with _profiled():
            threads = [threading.Thread(target=work, args=(i,)) for i in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert not errors
    recs = launches.records(t0)
    outer = {r.id: r for r in recs if r.name == "outer"}
    inner = [r for r in recs if r.name == "inner"]
    assert len(outer) == len(inner) == n_threads * n_spans
    assert len({r.id for r in recs}) == len(recs)
    for r in inner:
        o = outer[r.parent]
        assert o.attrs == r.attrs and o.parent is None
