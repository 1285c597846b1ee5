"""Port parity: the grid-DDA wavefront step (ops/gridkernel.py), main path.

On the CPU the step wrapper runs the plain torch version.  It is held
against the JAX ``grid_megakernel_step`` (Pallas interpret mode, j_steps=2)
from the same packed state, and the port's grid renders against the port's
brute-force megakernel: bit-identical at depth 4 and at most 2% of pixels at
depth 50 (the rules of tests/test_grid.py), on the book scene, on a
varied-height field (the 5-value slot layout), on a field with textured
spheres (the ``ttab`` fetch) and at pitch 2.  The CUDA
kernel itself is compared with the plain version on the card
(tests/test_torch_cuda.py and chip_smoke.py).

Tolerance of the step comparison: as in test_torch_megakernel.py — XLA:CPU's
FMA contraction and rsqrt rewrite leave the geometry rows (o, d, t_end,
t_nx, t_nz) equal only to float noise; the discrete state (u32 rows, pixel
coords, throughput) must be bit-equal on at least 97% of lanes (measured
98.5% after one 40-iteration launch at depth 12; 99.9% after one iteration),
and on those lanes the winner key, the running sum ``cur`` and the
accumulators are compared bit for bit and the geometry rows within a stated
tolerance, each on a stated share of lanes.  The JAX state's rows 8-11
(in-kernel call merge, hoisted fresh seeds) are not in the port.
"""

import numpy as np
import pytest
import torch

from raytrace_tpu.models.scene import generate_random_scene as j_book
from raytrace_tpu.models.scene import random_sphere_field as j_field
from raytrace_tpu.ops import gridkernel as jgrid
from raytrace_tpu.ops import trace as jtrace
from raytrace_tpu_torch.models.scene import (CHECKERED, generate_random_scene,
                                             random_sphere_field)
from raytrace_tpu_torch.ops import gridkernel, trace
from raytrace_tpu_torch.runtime.renderer import reference_camera, resolve_backend

torch.set_num_threads(1)

W, H = 64, 36
DISCRETE_F_ROWS = [gridkernel.R_FX, gridkernel.R_FY, gridkernel.R_THR,
                   gridkernel.R_THR + 1, gridkernel.R_THR + 2]


@pytest.fixture(scope="module")
def book():
    return trace.prepare_scene(generate_random_scene(0.0))


def _render(ds_np, backend, *, depth, spp, m=2, w=W, h=H):
    ds = trace.device_scene_from_numpy(ds_np, "cpu")
    vp = trace.viewport_arrays(reference_camera(), w, h)
    return trace.render_band(
        ds, vp, band_h=h, width=w, y0=0, seed_y0=0, offset_x=0, spp=spp,
        number=0, max_depth=depth, backend=backend, pixels_per_lane=m,
        skip_tmax=True).numpy()


def _steps(book, k_steps):
    """(port state, JAX state, packed input, n_lanes) after one step of
    ``k_steps`` iterations, j_steps=2, from the same packed state: one JAX
    TILE (4096 lanes), M=3."""
    ds = trace.device_scene_from_numpy(book, "cpu")
    vp = trace.viewport_arrays(reference_camera(), 64, 48)
    f, u, scal, vpr, geom = trace.pack_state(
        ds, vp, backend="grid", band_h=48, width=64, y0=0, seed_y0=0,
        offset_x=0, spp=2, number=0, pixels_per_lane=3, lane_pad=jgrid.TILE)
    kw = dict(geom, max_depth=12, skip_tmax=True, k_steps=k_steps, j_steps=2)
    g = book.grid
    u12 = np.zeros((12, f.shape[1]), np.uint32)  # JAX rows 8-11: call merge
    u12[:8] = u.numpy().view(np.uint32)
    u12[jgrid.U_PEND] = 1  # fresh-seed rows start stale, as JAX's _render_band_mega sets them
    fj, uj = jgrid.grid_megakernel_step(
        scal.numpy(), vpr.numpy(), g.gscal, g.gtab, g.gttab, g.ctab, g.atab,
        f.numpy(), u12, None, None, interpret=True, five=False, n_slots=4, **kw)
    fj = np.asarray(fj)
    uj = np.asarray(uj)[:8].view(np.int32)
    before = gridkernel.grid_megakernel_step_plain.launches
    fp, up = gridkernel.grid_megakernel_step(scal, vpr, ds.grid, f, u, **kw)
    assert gridkernel.grid_megakernel_step_plain.launches == before + 1
    fp, up = fp.numpy(), up.numpy()
    assert fp.shape == fj.shape and up.shape == uj.shape
    return fp, up, fj, uj, (f.numpy(), u.numpy()), geom["n_lanes"]


def _discrete_same(fp, up, fj, uj):
    return (up == uj).all(axis=0) & (fp[DISCRETE_F_ROWS] == fj[DISCRETE_F_ROWS]).all(axis=0)


def _close_share(a, b, tol):
    return float(np.isclose(a, b, rtol=tol, atol=tol, equal_nan=True).all(axis=0).mean())


GEOM_ROWS = {"o": slice(0, 3), "d": slice(3, 6),
             "t": slice(gridkernel.R_TB, gridkernel.R_BKEY)}


def test_step_matches_jax_interpret(book):
    """Book scene, one launch (K_STEPS iterations of j_steps=2 cells)."""
    fp, up, fj, uj, (f0, u0), n = _steps(book, gridkernel.K_STEPS)
    # padding lanes (dead from the start) pass through untouched
    assert np.array_equal(fp[:, n:], f0[:, n:])
    assert np.array_equal(up[:, n:], u0[:, n:])
    fp, up, fj, uj = fp[:, :n], up[:, :n], fj[:, :n], uj[:, :n]
    same = _discrete_same(fp, up, fj, uj)
    assert same.mean() >= 0.97, f"discrete state equal on {same.mean():.2%} of lanes"
    # on those lanes: the winner key and the running pixel sum bit for bit
    # on every lane, the accumulators on >= 96% (measured 96.9%; the rest
    # flushed a sample whose path had split and rejoined), the geometry rows
    # to XLA's float noise (o, d measured 98.2% / 98.1% within 1e-3; the
    # march's t rows 98.5% within 1e-2)
    cur = slice(gridkernel.R_CUR, gridkernel.R_CUR + 3)
    acc = slice(gridkernel.R_ACC, gridkernel.R_ACC + 9)
    assert np.array_equal(fp[gridkernel.R_BKEY, same], fj[gridkernel.R_BKEY, same])
    assert np.array_equal(fp[cur, same], fj[cur, same])
    assert (fp[acc, same] == fj[acc, same]).all(axis=0).mean() >= 0.96
    for name, rows in GEOM_ROWS.items():
        tol = 1e-2 if name == "t" else 1e-3
        assert _close_share(fp[rows, same], fj[rows, same], tol) >= 0.95, name


def test_first_iteration_matches_jax_interpret(book):
    """One iteration (segment start, globals, slab clip, DDA init, two
    cells), before XLA's float noise compounds: the discrete state on >= 99%
    of lanes (measured 99.9%), and on those lanes every row but the geometry
    (o, d, t_best) bit for bit; the geometry within 1e-4 on >= 88% and
    within 1e-3 on >= 97% of them (measured 90.2% and 98.5%)."""
    fp, up, fj, uj, _, n = _steps(book, 1)
    fp, up, fj, uj = fp[:, :n], up[:, :n], fj[:, :n], uj[:, :n]
    same = _discrete_same(fp, up, fj, uj)
    assert same.mean() >= 0.99, f"discrete state equal on {same.mean():.2%} of lanes"
    geom = [0, 1, 2, 3, 4, 5, gridkernel.R_TB]
    rest = [r for r in range(fp.shape[0]) if r not in geom]
    assert np.array_equal(fp[rest][:, same], fj[rest][:, same])
    assert _close_share(fp[geom][:, same], fj[geom][:, same], 1e-4) >= 0.88
    assert _close_share(fp[geom][:, same], fj[geom][:, same], 1e-3) >= 0.97


def test_dense_field_builds_no_grid():
    """``random_sphere_field(2000, seed=1, extent=7.0)`` crowds its cells
    past the slot limit in both packages' builders (it is the JAX paged
    backend's field), so the 5-value layout is tested on ``tall_field``
    below and this field gets paged-grid tables and renders on the paged
    kernel (tests/test_torch_paged.py)."""
    sc = random_sphere_field(2000, seed=1, extent=7.0)
    assert trace.prepare_scene(sc).grid is None
    assert jtrace.prepare_scene(j_field(2000, seed=1, extent=7.0)).grid is None
    ds = trace.device_scene_from_numpy(trace.prepare_scene(sc), "cpu")
    assert ds.paged is not None
    assert resolve_backend("auto", ds) == "paged"


def _textured_field():
    sc = random_sphere_field(60, seed=3, extent=8.0)
    sc.texture[10:20] = CHECKERED  # textured field spheres: the ttab path
    sc.color1[10:20] = (0.9, 0.1, 0.1)
    return sc


SCENES = {
    "book": lambda: trace.prepare_scene(generate_random_scene(0.0)),
    "tall_field": lambda: trace.prepare_scene(
        random_sphere_field(60, seed=3, extent=8.0, y_range=(0.2, 2.5))),
    "book_pitch2": lambda: trace.prepare_scene(generate_random_scene(0.0), grid_pitch=2.0),
    "textured_field": lambda: trace.prepare_scene(_textured_field()),
}


@pytest.mark.parametrize("name", list(SCENES))
def test_grid_equals_mega(name):
    ds = SCENES[name]()
    assert ds.grid is not None
    if name == "tall_field":
        assert ds.grid.has_cy is not None  # 5-value slots
    if name == "book_pitch2":
        assert ds.grid.gscal[0, 12] == 2.0
    if name == "textured_field":
        assert ds.grid.ttab is not None
    # stable regime: bit-identical at depth 4
    assert np.array_equal(_render(ds, "grid", depth=4, spp=2),
                          _render(ds, "mega", depth=4, spp=2))
    # full depth: <= 2% of pixels may differ (tests/test_grid.py); eager
    # IEEE torch has no per-graph fp choices, so expect none
    a = _render(ds, "grid", depth=50, spp=2)
    b = _render(ds, "mega", depth=50, spp=2)
    assert float((np.abs(a - b).max(axis=2) > 0).mean()) <= 0.02
    assert np.array_equal(a, b)


def test_grid_pixels_per_lane_invariant(book):
    base = _render(book, "grid", depth=8, spp=2, m=1)
    assert np.array_equal(_render(book, "grid", depth=8, spp=2, m=5), base)


def test_jax_built_tables_give_the_same_image():
    """Weight import: tables built by the JAX package render the same image
    as the port's own tables."""
    own = _render(trace.prepare_scene(generate_random_scene(0.0)), "grid",
                  depth=8, spp=1)
    from_jax = _render(jtrace.prepare_scene(j_book(0.0)), "grid", depth=8, spp=1)
    assert np.array_equal(own, from_jax)

