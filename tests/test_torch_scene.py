"""Port parity: host-side scene, camera, sphere table and grid tables.

The port copies the JAX package's numpy modules (it must never import
``raytrace_tpu``); these tests pin the copies byte for byte against the
reference on the book scene at several animation times, the three-sphere
scene, the 2000-sphere stretch field and seeded fields of 40-3,000 spheres,
and the grid tables at pitch 1 and 2, the slot cap met and crowded past.
Every call draws the book's layout anew: its ``scene.generate`` span says
how many engine words it drew.
"""

import time

import numpy as np
import pytest
import torch

from raytrace_tpu.models import camera as jcamera
from raytrace_tpu.models import grid as jgrid
from raytrace_tpu.models import scene as jscene
from raytrace_tpu.ops import pallas_intersect as jpi
from raytrace_tpu.ops import trace as jtrace
from raytrace_tpu_torch.models import camera as tcamera
from raytrace_tpu_torch.models import grid as tgrid
from raytrace_tpu_torch.models import mt19937 as tmt
from raytrace_tpu_torch.models import scene as tscene
from raytrace_tpu_torch.ops import intersect as tintersect
from raytrace_tpu_torch.ops import launches
from raytrace_tpu_torch.ops import trace as ttrace

torch.set_num_threads(1)

SCENES = {
    "book_t0": lambda m: m.generate_random_scene(0.0),
    "book_t0.9": lambda m: m.generate_random_scene(0.9),
    "book_t2.7": lambda m: m.generate_random_scene(2.7),
    # the frame loop's times: t0 in [0, 600) plus i / 60, and past either end
    "book_t-600": lambda m: m.generate_random_scene(-600.0),
    "book_t599.983": lambda m: m.generate_random_scene(599.983),
    "book_t0.0166": lambda m: m.generate_random_scene(1 / 60),
    "book_t317.41": lambda m: m.generate_random_scene(317.41 + 7 / 60),
    "book_t1e4": lambda m: m.generate_random_scene(12345.678),
    "three_sphere": lambda m: m.three_sphere_scene(),
    "field2000": lambda m: m.random_sphere_field(2000, seed=1, extent=7.0),
    "tall60": lambda m: m.random_sphere_field(60, seed=3, extent=8.0, y_range=(0.2, 2.5)),
    # small spheres that carry a texture: the grid then builds its ttab
    "textured80": lambda m: _textured(m.random_sphere_field(80, seed=5, extent=6.0)),
}
# seeded fields of 40-3,000 spheres over a 24x24 square, every other one at
# varied heights (the 5-value layout); from 1,400 spheres on, cells crowd
# past the slot cap and the grid says None
FIELD_COUNTS = (40, 90, 150, 250, 400, 600, 900, 1400, 2100, 3000)
for _i, _count in enumerate(FIELD_COUNTS):
    SCENES[f"field{_count}_s{100 + _i}"] = (
        lambda m, c=_count, i=_i: m.random_sphere_field(
            c, seed=100 + i, extent=12.0, y_range=(0.1, 2.0) if i % 2 else None))


def _textured(sc):
    tex = np.array(sc.texture)
    tex[4:int(sc.n_spheres):7] = 1
    return sc._replace(texture=tex)


def _byte_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype, a.shape, b.shape)
    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("name", list(SCENES))
def test_scene_arrays_byte_equal(name):
    ref = SCENES[name](jscene)
    port = SCENES[name](tscene)
    assert tscene.SceneArrays._fields == jscene.SceneArrays._fields
    for field in jscene.SceneArrays._fields:
        _byte_equal(getattr(port, field), getattr(ref, field))


# the book layout's engine words: 4 a diffuse sphere, 6 a metal, 3 a glass
BOOK_DRAWS = 2017


@pytest.mark.parametrize("name", ["book_t0", "field2000"])
def test_every_call_draws_the_whole_stream(name, monkeypatch):
    """No layout is kept between calls: each of two successive calls seeds
    an engine, draws its block, and records the words its layout drew."""
    entered = []
    draw = tmt.MT19937.draw

    def counted(self, n):
        entered.append(n)
        return draw(self, n)

    monkeypatch.setattr(tmt.MT19937, "draw", counted)
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        first = SCENES[name](tscene)
        second = SCENES[name](tscene)
    recs = [r for r in launches.records(t0) if r.name == "scene.generate"]
    assert [r.attrs["draws"] for r in recs] == [BOOK_DRAWS, BOOK_DRAWS]
    assert [r.attrs["n_spheres"] for r in recs] == [int(first.n_spheres)] * 2
    assert len(entered) == 2 and all(n >= BOOK_DRAWS for n in entered)
    for field in tscene.SceneArrays._fields:
        _byte_equal(getattr(first, field), getattr(second, field))


def test_book_layout_material_counts():
    """The draws follow from the materials: 4, 6 and 3 words a sphere."""
    sc = tscene.generate_random_scene(0.0)
    mat = sc.material[4:int(sc.n_spheres)]
    counts = [int((mat == m).sum()) for m in (tscene.DIFFUSE, tscene.METAL, tscene.REFRACTIVE)]
    assert sum(counts) == 484
    assert 4 * counts[0] + 6 * counts[1] + 3 * counts[2] == BOOK_DRAWS


@pytest.mark.parametrize("aspect", [24 / 14, 16 / 9, 1.0])
@pytest.mark.parametrize("look_from", [(13.0, 11.0, -3.0), (-2.0, 5.0, 9.0)])
def test_calculate_viewport_byte_equal(aspect, look_from):
    ref = jcamera.calculate_viewport(jcamera.Camera(look_from=look_from), aspect)
    port = tcamera.calculate_viewport(tcamera.Camera(look_from=look_from), aspect)
    for field in ("horizontal", "vertical", "upper_left_corner", "camera_up",
                  "camera_right", "look_from", "aperture"):
        _byte_equal(getattr(port, field), getattr(ref, field))


@pytest.mark.parametrize("name", ["book_t0", "three_sphere", "field2000"])
def test_sphere_table_byte_equal(name):
    _byte_equal(tintersect.sphere_table(SCENES[name](tscene)),
                jpi.sphere_table(SCENES[name](jscene)))


# (scene, pitch, slot cap): the frame loop's times at pitch 1 and 2, both
# ctab layouts, the ttab, caps at and below a scene's worst cell, the
# seeded fields.  The cases the builder answers None:
CAP = tgrid.MAX_N_SLOTS
GRID_CASES = [("book_t0", 1.0, CAP), ("book_t0", 2.0, CAP), ("tall60", 1.0, CAP),
              ("field2000", 1.0, CAP),
              *[(name, pitch, CAP) for name in ("book_t-600", "book_t599.983", "book_t317.41")
                for pitch in (1.0, 2.0)],
              ("tall60", 2.0, CAP), ("textured80", 1.0, CAP),
              ("book_t0", 2.0, 6), ("tall60", 2.0, 4), ("tall60", 2.0, 5),
              *[(f"field{c}_s{100 + i}", 1.0, CAP) for i, c in enumerate(FIELD_COUNTS)]]
NO_GRID = {("field2000", 1.0, CAP), ("book_t0", 2.0, 6), ("tall60", 2.0, 4),
           *[(f"field{c}_s{100 + i}", 1.0, CAP) for i, c in enumerate(FIELD_COUNTS) if c >= 1400]}


@pytest.mark.parametrize("name,pitch,max_slots", [
    pytest.param(*case, id=f"{case[0]}-{case[1]}" + (f"-max{case[2]}" if case[2] != CAP else ""))
    for case in GRID_CASES])
def test_grid_tables_byte_equal(name, pitch, max_slots):
    sc = SCENES[name](jscene)
    ref = jgrid.build_grid(sc, jpi.sphere_table(sc), pitch=pitch, max_slots=max_slots)
    port = tgrid.build_grid(sc, tintersect.sphere_table(sc), pitch=pitch, max_slots=max_slots)
    # too many cells, or cells crowded past the slot cap: no grid
    assert (ref is None) == (port is None) == ((name, pitch, max_slots) in NO_GRID)
    if ref is None:
        return
    assert (port.ttab is not None) == (name == "textured80")
    assert tgrid.GridTables._fields == jgrid.GridTables._fields
    for field in jgrid.GridTables._fields:
        a, b = getattr(port, field), getattr(ref, field)
        assert (a is None) == (b is None), field
        if a is not None:
            _byte_equal(a, b)


def test_tall_field_uses_five_value_layout():
    """Varied sphere heights exercise the general 5-value slot layout."""
    sc = SCENES["tall60"](tscene)
    g = tgrid.build_grid(sc, tintersect.sphere_table(sc))
    assert g.has_cy is not None


def test_device_scene_from_jax_scene_matches_port():
    """The port's weight import: the JAX DeviceScene (numpy fields incl. its
    GridTables, re-laid into the kernel's CellTables) becomes the same torch
    tensors as the port's own prep."""
    sc = jscene.generate_random_scene(0.0)
    from_jax = ttrace.device_scene_from_numpy(jtrace.prepare_scene(sc), "cpu")
    own = ttrace.device_scene_from_numpy(ttrace.prepare_scene(sc), "cpu")
    for field in ttrace.DeviceScene._fields:
        if field in ("grid", "paged"):
            continue
        assert torch.equal(getattr(from_jax, field), getattr(own, field)), field
    assert isinstance(own.grid, tgrid.CellTables)
    for field in tgrid.CellTables._fields:
        a, b = getattr(from_jax.grid, field), getattr(own.grid, field)
        assert (a is None) == (b is None)
        if torch.is_tensor(a):
            assert torch.equal(a, b), field
        else:
            assert a == b, field
    assert from_jax.paged is None and own.paged is None
