"""Port: the paged tables and the sphere table built with torch ops
(``models/paged_grid.build_paged_grid``, ``ops/intersect.sphere_table_device``)
against the JAX package's builders, and the device route of ``set_scene``.

On the CPU the builder runs on CPU tensors of a scene made by the JAX
package's generators; its tables must equal the JAX ``build_paged_grid``'s
byte for byte, field by field, and its ``None`` verdicts must fall where the
JAX builder's do.  A Renderer whose scene takes the device route renders the
same frames, bit for bit, as one whose scene takes the host route.
"""

import numpy as np
import pytest
import torch

from raytrace_tpu.models.paged_grid import build_paged_grid as j_build_paged
from raytrace_tpu.models.scene import CHECKERED as J_CHECKERED
from raytrace_tpu.models.scene import generate_random_scene as j_book
from raytrace_tpu.models.scene import random_sphere_field as j_field
from raytrace_tpu.models.scene import three_sphere_scene as j_three
from raytrace_tpu.ops.intersect import sphere_constants as j_sphere_constants
from raytrace_tpu.ops.pallas_intersect import sphere_table as j_sphere_table
from raytrace_tpu_torch import RenderConfig
from raytrace_tpu_torch.models.grid import MAX_SPHERES, POISON
from raytrace_tpu_torch.models.paged_grid import build_paged_grid
from raytrace_tpu_torch.models.scene import random_sphere_field
from raytrace_tpu_torch.ops import trace
from raytrace_tpu_torch.ops.intersect import sphere_table_device
from raytrace_tpu_torch.runtime import renderer
from raytrace_tpu_torch.runtime.renderer import Renderer

torch.set_num_threads(1)


def _textured(count, seed, extent, y_range=None):
    """A field whose every third small sphere is checkered (``has_tex``)."""
    sc = j_field(count, seed=seed, extent=extent, y_range=y_range)
    sc.texture[4 : 4 + count : 3] = J_CHECKERED
    sc.color1[4 : 4 + count : 3] = (0.9, 0.2, 0.4)
    return sc


def _globals(k):
    """A field of 2,000 spheres with ``k`` too large for the pages (the
    ground, the heroes and ``k - 4`` of the field's); MAX_GLOBALS is 16."""
    sc = j_field(2000, seed=5, extent=7.0)
    sc.radii[4 : k] = 0.75
    return sc


def _field(count, seed, extent, **kw):
    return lambda: j_field(count, seed=seed, extent=extent, **kw)


# name: (scene, builder keywords, what the JAX builder gives: "tables",
# "govf" or None; for None, keywords under which the same scene gets tables,
# so the verdict is the one the case names)
CASES = {
    "1000-seed0": (_field(1000, 0, 5.0), {}, "tables", None),
    "1000-seed3": (_field(1000, 3, 5.0), {}, "tables", None),
    "4000-seed1": (_field(4000, 1, 10.0), {}, "tables", None),
    "8000-seed7": (_field(8000, 7, 14.0), {}, "tables", None),
    "20000-seed2": (_field(20000, 2, 22.0), {}, "tables", None),
    "heights": (_field(6000, 3, 9.0, t=2.5, y_range=(0.1, 2.0)), {}, "tables", None),
    "textured": (lambda: _textured(5000, 4, 9.0), {}, "tables", None),
    "heights-textured": (lambda: _textured(5000, 11, 9.0, (0.1, 1.5)), {}, "tables", None),
    "cell-size": (_field(2000, 5, 7.0), {"cell_size": 0.3}, "tables", None),
    "pad-slots": (_field(4000, 1, 10.0), {"pad_slots": 24}, "tables", None),
    "hot-auto": (_field(12000, 8, 17.0), {"hot_slots": -1}, "govf", None),
    "hot-fixed": (_field(2000, 5, 7.0), {"hot_slots": 4}, "govf", None),
    "globals-16": (lambda: _globals(16), {}, "tables", None),
    "book": (lambda: j_book(1.5), {}, "tables", None),
    "none-globals": (lambda: _globals(17), {}, None, None),
    "none-crowded": (_field(4000, 1, 10.0), {"max_slots": 3}, None, {}),
    "none-ab": (_field(20000, 2, 22.0), {"max_ab": 0}, None, {}),
    "none-page-grid": (_field(2000, 5, 7.0), {"cell_size": 0.02}, None, {"cell_size": 0.3}),
    "none-budget": (_field(4000, 10, 50.0), {"cell_size": 0.25, "pad_slots": 32}, None,
                    {"cell_size": 0.25}),
}


def _on(scene, device="cpu"):
    """The scene's arrays as tensors (``trace.scene_to_device``)."""
    return trace.scene_to_device(scene, device)[0]


def _bits(a):
    t = torch.as_tensor(np.ascontiguousarray(a)) if isinstance(a, np.ndarray) else a
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _assert_tables_equal(want, got):
    assert tuple(type(want)._fields) == tuple(type(got)._fields)
    for f in want._fields:
        a, b = getattr(want, f), getattr(got, f)
        if a is None:
            assert b is None, f
            continue
        assert b is not None, f
        assert tuple(a.shape) == tuple(b.shape), (f, a.shape, b.shape)
        assert torch.equal(_bits(a), _bits(b)), f


def _pairs(tables):
    """The (cell, sphere) pairs of a build: its kc values that are not POISON."""
    w = 3 if tables.has_cy is None else 4
    return sum(int(np.count_nonzero(np.asarray(t)[:, w - 1 :: w] != POISON))
               for t in (tables.geom, tables.govf) if t is not None)


@pytest.mark.parametrize("case", sorted(CASES))
def test_the_builder_equals_the_jax_builder(case):
    make, kw, expect, control = CASES[case]
    scene = make()
    want = j_build_paged(scene, j_sphere_table(scene), **kw)
    if control is not None:
        assert j_build_paged(scene, j_sphere_table(scene), **control) is not None
    on = _on(scene)
    table, _ = sphere_table_device(on)
    stats = {}
    got = build_paged_grid(on, table, stats=stats, **kw)
    if expect is None:
        assert want is None and got is None
        assert 1 <= stats["syncs"] <= 5
    else:
        assert want is not None
        assert (want.govf is not None) == (expect == "govf")
        _assert_tables_equal(want, got)
        assert stats["n_pages"] == want.lids.shape[0] and stats["n_slots"] == want.lids.shape[1]
        assert stats["pairs"] == _pairs(want)
        assert stats["syncs"] == (6 if kw.get("hot_slots") == -1 else 5)


@pytest.mark.parametrize("make", [
    lambda: j_field(100, seed=1, extent=3.0),  # 128 rows, no padding
    lambda: j_field(700, seed=2, extent=5.0),  # 768 rows, padded to 1024
    lambda: j_field(1020, seed=3, extent=5.0),  # 1024 rows, a multiple of 512
    lambda: j_book(42.0),
    j_three,
], ids=["128", "768", "1024", "book", "three"])
def test_the_device_sphere_table_equals_the_jax_table(make):
    scene = make()
    table, kc = sphere_table_device(_on(scene))
    want = j_sphere_table(scene)
    assert tuple(table.shape) == want.shape
    assert torch.equal(_bits(table), _bits(want))
    want_kc = np.asarray(j_sphere_constants(scene.centers, scene.radii), np.float32)
    assert torch.equal(_bits(kc), _bits(want_kc))


def test_the_device_scene_equals_the_uploaded_host_scene():
    scene = random_sphere_field(5000, seed=12, extent=9.0, t=3.0)
    want = trace.device_scene_from_numpy(trace.prepare_scene(scene), "cpu")
    got = trace.prepare_scene_device(_on(scene))
    for f in trace.DeviceScene._fields:
        a, b = getattr(want, f), getattr(got, f)
        if f == "paged":
            _assert_tables_equal(a, b)
        elif a is None:
            assert b is None, f
        else:
            assert a.dtype == b.dtype and a.shape == b.shape, f
            assert torch.equal(_bits(a), _bits(b)), f


def test_the_device_route_applies_to_scenes_too_large_for_the_grid():
    big = random_sphere_field(MAX_SPHERES - 4, seed=1, extent=10.0)  # n = MAX_SPHERES
    small = random_sphere_field(MAX_SPHERES - 5, seed=1, extent=10.0)
    assert trace.builds_on_device(big) and not trace.builds_on_device(small)
    with pytest.raises(ValueError):
        trace.prepare_scene_device(_on(small))


_PREPARE = trace.prepare_scene_device


def _frames(monkeypatch, on_device: bool):
    """Two frames (two scene times) of a field through Renderer on the CPU,
    its tables built by the route asked for; returns the sums and the number
    of device-route builds."""
    built = []

    def counted(scene):
        built.append(int(scene.n_spheres))
        return _PREPARE(scene)

    monkeypatch.setattr(trace, "builds_on_device",
                        lambda scene: on_device and int(scene.n_spheres) >= MAX_SPHERES)
    monkeypatch.setattr(trace, "prepare_scene_device", counted)
    cfg = RenderConfig(samples=1, width=16, height=8, max_depth=4)
    r = Renderer(cfg, scene=random_sphere_field(5000, seed=13, extent=9.0, t=0.0), device="cpu")
    out = []
    for i, t in enumerate((1.25, 97.5)):
        r.set_scene(random_sphere_field(5000, seed=13, extent=9.0, t=t))
        assert r.backend == "paged"
        out.append(r.render_call(1, number=i))
    return out, built


def test_frames_render_the_same_by_either_route(monkeypatch):
    host, built_host = _frames(monkeypatch, on_device=False)
    dev, built_dev = _frames(monkeypatch, on_device=True)
    assert built_host == [] and built_dev == [5004] * 3
    assert not torch.equal(host[0], host[1])
    for a, b in zip(host, dev):
        assert torch.equal(_bits(a), _bits(b))


def test_upload_per_device_builds_once_on_each_distinct_device(monkeypatch):
    calls = []
    monkeypatch.setattr(trace, "prepare_scene_device",
                        lambda scene: calls.append(1) or _PREPARE(scene))
    scene = random_sphere_field(4500, seed=14, extent=9.0)
    cpu = torch.device("cpu")
    out = renderer.upload_per_device(scene, [cpu, cpu, cpu])
    assert list(out) == [cpu] and len(calls) == 1
    assert out[cpu].paged is not None
