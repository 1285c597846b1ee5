"""The kernels' work count: a function of the cell's inputs only."""

import numpy as np
import pytest

from benchmark import workcount
from benchmark.reference import camera, scenes

RR = (1, 16, 0.05)


def _count(backend, scene, w=32, h=18, spp=100, rr=RR):
    # the count takes no backend: every backend's cell reads the same number
    return workcount.image_ops(scene, camera.viewport(w, h), w, h, spp, 50, rr)


def test_the_count_is_the_same_whichever_backend_renders(tiny):
    from benchmark import loops, run, spec

    bench, base = tiny
    counts = []
    for backend in ("grid", "paged", "mega"):
        cell = spec.cell(bench, "t-field", base=base)
        cell["config_data"] = dict(cell["config_data"], backend=backend)
        sess = loops.Session(cell, 2**31 + 3, ["cpu"])
        counts.append(run.traced_work(cell, sess))
    assert counts[0] == counts[1] == counts[2] > 0


def test_the_count_repeats_exactly_for_a_seed():
    a = _count("grid", scenes.sphere_field(800, 2**33 + 1))
    b = _count("grid", scenes.sphere_field(800, 2**33 + 1))
    c = _count("grid", scenes.sphere_field(800, 2**33 + 2))
    assert a == b and a != c


@pytest.mark.parametrize("mode_rr", [None, RR], ids=["exact", "fast"])
def test_the_count_is_no_more_than_the_reference_performs(mode_rr):
    """The frozen reference tests every sphere at every segment and shades
    every hit: its own float32 operations bound the count from above."""
    from benchmark.reference import tracer

    sc = scenes.book_scene(0.0)
    w, h, spp = 24, 14, 16
    pix = workcount.lattice(w, h)
    stats = {}
    tracer.render_pixels(sc, camera.viewport(w, h), pix, np.zeros((len(pix), 1), np.int64),
                         [spp], 50, mode_rr, stats=stats)
    n_spheres = len(sc.radii)
    performed = (stats["samples"] * (workcount.OPS_CAMERA + workcount.OPS_TERM)
                 + stats["segments"] * (workcount.OPS_RAY + n_spheres * 17)
                 + stats["hits"] * (5 + workcount.OPS_SHADE)
                 + stats["bounces"] * workcount.OPS_BOUNCE)
    rates = workcount.event_rates(sc, camera.viewport(w, h), w, h, 50, mode_rr)
    count = stats["samples"] * workcount.ops_per_sample(rates)
    assert 0 < count <= performed
    # and per segment, one sphere test against the reference's 488
    assert count < performed / 50


def test_fast_mode_counts_less_than_exact():
    sc = scenes.book_scene(0.0)
    assert _count("grid", sc, rr=RR) < _count("grid", sc, rr=None)
