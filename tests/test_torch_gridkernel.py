"""Port parity: the grid-DDA wavefront step (ops/gridkernel.py), main path.

On the CPU the step wrapper runs the plain torch version.  It is held
against the JAX ``grid_megakernel_step`` (Pallas interpret mode, j_steps=2)
from the same packed state, and the port's grid renders against the port's
brute-force megakernel: bit-identical at depth 4 and at most 2% of pixels at
depth 50 (the rules of tests/test_grid.py), on the book scene, on a
varied-height field (the 5-value slot layout), on a field with textured
spheres (the ``ttab`` fetch) and at pitch 2.  The cell-major tables the step
reads (``models.grid.cell_major``) equal the block-major ones value for
value, and the image is bit-identical with and without the driver's
live-lane compaction, across M and across ``j_steps``.  The CUDA kernel
itself is compared with the plain version on the card
(tests/test_torch_cuda.py and chip_smoke.py).

The port's grid state keeps no accumulator rows (the pixel sums go into a
home-order accumulator) and no unused rows; ``_jax_layout`` maps its state
and accumulator onto the JAX state's rows for the step comparisons, as
test_torch_paged.py does.

Tolerance of the step comparison: as in test_torch_megakernel.py — XLA:CPU's
FMA contraction and rsqrt rewrite leave the geometry rows (o, d, t_end,
t_nx, t_nz) equal only to float noise; the discrete state (u32 rows, pixel
coords, throughput) must be bit-equal on at least 97% of lanes (measured
98.5% after one 40-iteration launch at depth 12; 99.9% after one iteration),
and on those lanes the winner key, the running sum ``cur`` and the
accumulators are compared bit for bit and the geometry rows within a stated
tolerance, each on a stated share of lanes.  The JAX state's call row (8) is
the port's ``U_CALL`` (9); its hoisted fresh-seed rows (9-11) are not in the
port, which computes those seeds inline.

The call merge, the balanced table and the iterstats probe: the step with
``n_calls=3`` and with a seeded table against the JAX step under the same
rules; within the port, the merged band == the host loop, any table == the
strided map, a balanced carry and a balanced merge, and the probe's green
and blue == the normal render's, all bit for bit; the merged band against
the JAX package's within its own budget (tests/test_balance.py: <= 1% of
pixels differ, the mean within 1%).
"""

import numpy as np
import pytest
import torch

from raytrace_tpu.models.scene import generate_random_scene as j_book
from raytrace_tpu.models.scene import random_sphere_field as j_field
from raytrace_tpu.ops import gridkernel as jgrid
from raytrace_tpu.ops import trace as jtrace
from raytrace_tpu_torch.models.grid import cell_major
from raytrace_tpu_torch.models.scene import (CHECKERED, generate_random_scene,
                                             random_sphere_field)
from raytrace_tpu_torch.ops import gridkernel, trace
from raytrace_tpu_torch.runtime.renderer import reference_camera, resolve_backend

torch.set_num_threads(1)

W, H = 64, 36
# rows of the JAX f32 state (the port's rows 0-15 are its rows 0-15, the
# port's cur its rows 18-20)
DISCRETE_F_ROWS = [jgrid.R_FX, jgrid.R_FY, jgrid.R_THR, jgrid.R_THR + 1, jgrid.R_THR + 2]
PORT_TO_JAX = list(range(gridkernel.R_CUR)) + [jgrid.R_CUR + i for i in range(3)]


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


def _jax_layout(f, acc, m_slots, n_lanes, table=None):
    """The JAX package's f32 grid state rows from the port's state and
    home-order accumulator, for lanes in home order (lane k is lane0 k);
    slot m of lane k holds pixel m * n_lanes + k, or ``table[m, k]``."""
    f = f.numpy()
    out = np.zeros((jgrid.f_rows(m_slots), f.shape[1]), np.float32)
    out[PORT_TO_JAX] = f
    pix = (np.arange(m_slots)[:, None] * n_lanes + np.arange(n_lanes)[None, :]
           if table is None else table[:, :n_lanes])
    # padding slots and the table's sentinel read a zero row
    acc_pad = np.zeros((max(m_slots * n_lanes, acc.shape[0]) + 1, 3), np.float32)
    acc_pad[: acc.shape[0]] = acc.numpy()
    out[jgrid.R_ACC : jgrid.R_ACC + 3 * m_slots, :n_lanes] = (
        acc_pad[pix.reshape(-1)].reshape(m_slots, n_lanes, 3)
        .transpose(0, 2, 1).reshape(3 * m_slots, n_lanes))
    return out


def _steps(book, k_steps, n_calls=None, spp_last=None, table=None, spp=2):
    """(port state, JAX state, packed input, n_lanes) after one step of
    ``k_steps`` iterations, j_steps=2, from the same packed state: one JAX
    TILE (4096 lanes), M=3; f32 states in the JAX layout, u32 rows 0-7 and
    the call row (the port's 9, the JAX 8) last.  ``n_calls``/``spp_last``:
    the call merge; ``table``: a balanced table [3, TILE] (numpy)."""
    ds = trace.device_scene_from_numpy(book, "cpu")
    vp = trace.viewport_arrays(reference_camera(), 64, 48)
    passign = None if table is None else torch.from_numpy(table)
    f, u, scal, vpr, geom = trace.pack_state(
        ds, vp, backend="grid", band_h=48, width=64, y0=0, seed_y0=0,
        offset_x=0, spp=spp, number=0, pixels_per_lane=3, lane_pad=jgrid.TILE,
        n_calls=n_calls, spp_last=spp_last, passign=passign)
    assert torch.equal(u[gridkernel.U_LANE0], torch.arange(f.shape[1], dtype=torch.int32))
    kw = dict(geom, max_depth=12, skip_tmax=True, k_steps=k_steps, j_steps=2)
    acc0 = trace.home_accum(None, geom["p_total"], "cpu")
    f0 = _jax_layout(f, acc0, 3, geom["n_lanes"], table)
    g = book.grid
    u12 = np.zeros((12, f.shape[1]), np.uint32)  # JAX rows 8-11: call merge
    u12[:8] = u.numpy()[:8].view(np.uint32)
    u12[jgrid.U_CALL] = u.numpy()[gridkernel.U_CALL].view(np.uint32)
    u12[jgrid.U_PEND] = 1  # fresh-seed rows start stale, as JAX's _render_band_mega sets them
    fj, uj = jgrid.grid_megakernel_step(
        scal.numpy(), vpr.numpy(), g.gscal, g.gtab, g.gttab, g.ctab, g.atab,
        f0, u12, None, table, interpret=True, five=False, n_slots=4, **kw)
    fj = np.asarray(fj)
    uj = np.asarray(uj)[[*range(8), jgrid.U_CALL]].view(np.int32)
    before = gridkernel.grid_megakernel_step_plain.launches
    acc = acc0.clone()
    fp, up = gridkernel.grid_megakernel_step(scal, vpr, ds.grid, f, u, acc,
                                             passign=passign, **kw)
    assert gridkernel.grid_megakernel_step_plain.launches == before + 1
    assert torch.equal(up[gridkernel.U_LANE0], u[gridkernel.U_LANE0])
    fp = _jax_layout(fp, acc, 3, geom["n_lanes"], table)
    up = up.numpy()[[*range(8), gridkernel.U_CALL]]
    assert fp.shape == fj.shape and up.shape == uj.shape
    return fp, up, fj, uj, (f0, u.numpy()[[*range(8), gridkernel.U_CALL]]), geom["n_lanes"]


def _discrete_same(fp, up, fj, uj):
    return (up == uj).all(axis=0) & (fp[DISCRETE_F_ROWS] == fj[DISCRETE_F_ROWS]).all(axis=0)


def _close_share(a, b, tol):
    return float(np.isclose(a, b, rtol=tol, atol=tol, equal_nan=True).all(axis=0).mean())


GEOM_ROWS = {"o": slice(0, 3), "d": slice(3, 6), "t": slice(jgrid.R_TB, jgrid.R_BKEY)}


def _balanced_table():
    """A balanced table for the 64x48 band at M=3 from seeded costs, padded
    to one JAX TILE."""
    from raytrace_tpu_torch.runtime.balance import build_passign

    return build_passign(np.random.default_rng(11).random(64 * 48), 3, jgrid.TILE)


STEP_CASES = {
    # three 1-spp calls: the strided case's samples per lane and launch (at
    # 2 + 2 + 1 spp the lanes run 2.5x the samples in one launch, and XLA's
    # noise leaves 94.4% of them equal)
    "merged": dict(n_calls=3, spp=1, spp_last=1),
    "balanced": dict(table=_balanced_table()),
}


def test_step_matches_jax_interpret(book):
    """Book scene, one launch (K_STEPS iterations of j_steps=2 cells)."""
    _check_launch(book)


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_merged_and_balanced_steps_match_jax_interpret(book, case):
    """The same launch with the call merge (n_calls=3) or a balanced table;
    the call row is part of the discrete state (measured equal on 98.3% /
    98.5% of lanes)."""
    up = _check_launch(book, **STEP_CASES[case])
    if case == "merged":  # lanes moved on to later calls of their pixels
        assert up[-1].max() >= 1


def _check_launch(book, **case):
    fp, up, fj, uj, (f0, u0), n = _steps(book, gridkernel.K_STEPS, **case)
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
    cur = slice(jgrid.R_CUR, jgrid.R_CUR + 3)
    acc = slice(jgrid.R_ACC, jgrid.R_ACC + 9)
    assert np.array_equal(fp[jgrid.R_BKEY, same], fj[jgrid.R_BKEY, same])
    assert np.array_equal(fp[cur, same], fj[cur, same])
    assert (fp[acc, same] == fj[acc, same]).all(axis=0).mean() >= 0.96
    for name, rows in GEOM_ROWS.items():
        tol = 1e-2 if name == "t" else 1e-3
        assert _close_share(fp[rows, same], fj[rows, same], tol) >= 0.95, name
    return up


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
    geom = [0, 1, 2, 3, 4, 5, jgrid.R_TB]
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



def _bits(a):
    return np.ascontiguousarray(a, np.float32).view(np.uint32)


@pytest.mark.parametrize("name", list(SCENES))
def test_cell_major_tables_equal_block_major(name):
    """Every cell, slot and value of the cell records, and every sphere's
    attributes, is the block-major entry at row (c >> 7) * stride + v, lane
    c & 127 (attributes: row (i >> 7) * 8 + v), bit for bit; the record's
    other floats are 0."""
    g = SCENES[name]().grid
    ct = cell_major(g)
    five, n_slots, stride = gridkernel.layout(ct)
    w = 5 if five else 4
    assert five == (g.has_cy is not None)
    assert stride == -(-w * n_slots // 8) * 8 and stride % 4 == 0
    cells = np.arange(g.ctab.shape[0] // stride * 128)
    assert ct.cells.shape == (cells.size, stride)
    used = np.zeros(stride, bool)
    for slot in range(n_slots):
        for v in range(w):
            ref = g.ctab[(cells >> 7) * stride + slot * w + v, cells & 127]
            # 4-value: (cx, cz, kc, id) at 4s; 5-value: (cx, cy, cz, kc) at 4s
            # and the id at 4 * n_slots + s
            col = 4 * n_slots + slot if five and v == 4 else 4 * slot + v
            assert np.array_equal(_bits(ct.cells[:, col]), _bits(ref)), (slot, v)
            used[col] = True
    assert not ct.cells[:, ~used].any()
    ids = np.arange(ct.attrs.shape[0])
    assert ct.attrs.shape == (g.atab.shape[0] // 8 * 128, 8)
    for v in range(8):
        assert np.array_equal(_bits(ct.attrs[:, v]), _bits(g.atab[(ids >> 7) * 8 + v, ids & 127]))
    assert (ct.tattrs is None) == (g.ttab is None) == (name != "textured_field")
    if ct.tattrs is not None:
        for v in range(4):
            assert np.array_equal(_bits(ct.tattrs[:, v]),
                                  _bits(g.ttab[(ids >> 7) * 8 + v, ids & 127]))
    for field in ("gtab", "gttab", "gscal"):
        assert np.array_equal(_bits(getattr(ct, field)), _bits(getattr(g, field)))


def _grid_loop(ds_np, *, compact, k_steps, j_steps, m=2, depth=5, spp=2):
    """The grid step driven by hand: before every launch of ``k_steps``
    iterations the live lanes are compacted (``compact``), or never (every
    lane stays, in home order, until none is alive)."""
    ds = trace.device_scene_from_numpy(ds_np, "cpu")
    vp = trace.viewport_arrays(reference_camera(), W, H)
    f, u, scal, vpr, geom = trace.pack_state(
        ds, vp, backend="grid", band_h=H, width=W, y0=0, seed_y0=0,
        offset_x=0, spp=spp, number=0, pixels_per_lane=m)
    acc = trace.home_accum(None, geom["p_total"], "cpu")
    kw = dict(geom, max_depth=depth, skip_tmax=True, k_steps=k_steps, j_steps=j_steps)
    while bool((u[gridkernel.U_ALIVE] != 0).any()):
        if compact:
            f, u = trace.gather_lanes(f, u, trace.live_lanes(u[gridkernel.U_ALIVE]))
        f, u = gridkernel.grid_megakernel_step(scal, vpr, ds.grid, f, u, acc, **kw)
    return acc.reshape(H, W, 3).numpy()


LOOPS = {  # (compact, k_steps, j_steps)
    "never_compacted": (False, gridkernel.K_STEPS, 2),
    "compacted_every_iteration": (True, 1, 2),
    "one_cell_per_iteration": (True, gridkernel.K_STEPS, 1),
    "four_cells_per_iteration": (True, gridkernel.K_STEPS, 4),
    "march_until_the_segment_closes": (True, gridkernel.K_STEPS, 1 << 30),
}


@pytest.mark.parametrize("how", list(LOOPS))
def test_compaction_and_j_steps_leave_the_image(book, how):
    """The driver compacts the live lanes before every launch; never
    compacting, compacting before every single iteration, or marching 1, 4
    or any number of cells per iteration gives the same image bit for bit
    (M=2, depth 5)."""
    compact, k, j = LOOPS[how]
    ref = _render(book, "grid", depth=5, spp=2)
    assert np.array_equal(_grid_loop(book, compact=compact, k_steps=k, j_steps=j), ref)


def test_grid_state_has_no_accumulator_rows(book):
    """The grid band's state is 19 f32 + 10 int32 rows for any M, the last
    two int32 rows the lane's home index and its call within a merge;
    ``accum_init`` goes to the home-order accumulator, and the progressive
    sum equals two calls' sums."""
    ds = trace.device_scene_from_numpy(book, "cpu")
    vp = trace.viewport_arrays(reference_camera(), W, H)
    for m in (1, 5):
        f, u, *_ = trace.pack_state(ds, vp, backend="grid", band_h=H, width=W, y0=0,
                                    seed_y0=0, offset_x=0, spp=1, number=0,
                                    pixels_per_lane=m)
        assert f.shape[0] == gridkernel.F_ROWS == 19 and u.shape[0] == gridkernel.U_ROWS == 10
        assert torch.equal(u[gridkernel.U_LANE0], torch.arange(u.shape[1], dtype=torch.int32))
    with pytest.raises(ValueError, match="home_accum"):
        trace.pack_state(ds, vp, backend="grid", band_h=H, width=W, y0=0, seed_y0=0,
                         offset_x=0, spp=1, number=0, accum_init=torch.zeros((H, W, 3)))
    one = torch.from_numpy(_render(book, "grid", depth=4, spp=1))
    two = trace.render_band(ds, vp, band_h=H, width=W, y0=0, seed_y0=0, offset_x=0,
                            spp=1, number=0, accum_init=one, max_depth=4,
                            backend="grid", pixels_per_lane=2, skip_tmax=True)
    assert torch.equal(two, one + one)


def test_driver_launches_over_live_lanes_only(book, monkeypatch):
    """Every launch of the grid driver gets only lanes that are alive, fewer
    as the band drains, and the last launch leaves none alive."""
    seen = []
    step = gridkernel.grid_megakernel_step

    def spy(scal, vpr, grid, f, u, acc, **kw):
        seen.append((u.shape[1], int((u[gridkernel.U_ALIVE] != 0).sum())))
        out = step(scal, vpr, grid, f, u, acc, **kw)
        seen[-1] += (int((out[1][gridkernel.U_ALIVE] != 0).sum()),)
        return out

    monkeypatch.setattr(gridkernel, "grid_megakernel_step", spy)
    monkeypatch.setattr(gridkernel, "K_STEPS", 4)  # several launches at this size
    _render(book, "grid", depth=6, spp=2)
    n_pad = -(-(W * H // 2) // trace.LANE_PAD) * trace.LANE_PAD
    assert seen[0][0] == n_pad and len(seen) > 2
    assert all(n == alive for n, alive, _ in seen[1:])
    assert [n for n, _, _ in seen] == sorted((n for n, _, _ in seen), reverse=True)
    assert seen[-1][0] < seen[0][1] and seen[-1][2] == 0


# ---- call merge, balanced tables, iterstats --------------------------------

BW, BH = 48, 27


def _band(book, *, spp=2, number=0, depth=6, m=2, rr=None, **kw):
    ds = trace.device_scene_from_numpy(book, "cpu")
    vp = trace.viewport_arrays(reference_camera(), BW, BH)
    return trace.render_band(
        ds, vp, band_h=BH, width=BW, y0=0, seed_y0=0, offset_x=0, spp=spp,
        number=number, max_depth=depth, backend="grid", pixels_per_lane=m,
        skip_tmax=True, rr=rr, **kw)


def _table(seed, m=2):
    from raytrace_tpu_torch.runtime.balance import build_passign

    return build_passign(np.random.default_rng(seed).random(BW * BH), m, trace.LANE_PAD)


def _identity_table(m=2):
    p = BW * BH
    n = -(-p // m)
    tab = np.full((m, -(-n // trace.LANE_PAD) * trace.LANE_PAD), p, np.int32)
    for mm in range(m):
        idx = np.arange(n) + mm * n
        tab[mm, :n] = np.where(idx < p, idx, p)
    return tab


@pytest.mark.parametrize("rr", [None, (1, 16, 0.05)], ids=["exact", "fast"])
def test_merge_equals_host_loop(book, rr):
    """Calls of 2, 2 and 1 spp (numbers 0, 1, 2) merged into one band
    render equal the three calls issued one by one with the accumulator
    carried, bit for bit, at depth 6."""
    host = None
    for number, spp in enumerate((2, 2, 1)):
        host = _band(book, spp=spp, number=number, rr=rr, accum_init=host)
    merged = _band(book, spp=2, n_calls=3, spp_last=1, rr=rr)
    assert torch.equal(merged, host)


@pytest.mark.parametrize("which", ["identity", "random"])
def test_tables_leave_the_image(book, which):
    """The identity table and a seeded random one give the strided map's
    image bit for bit (fast mode)."""
    tab = _identity_table() if which == "identity" else _table(3)
    rr = (1, 16, 0.05)
    assert torch.equal(_band(book, rr=rr, passign=tab), _band(book, rr=rr))


def test_balanced_accum_carry_and_merge(book):
    """Two balanced calls chained through ``accum_init`` equal the sum of
    the calls, and one merged balanced dispatch of the two equals the
    chained calls, bit for bit."""
    tab = _table(7)
    a0 = _band(book, number=0, passign=tab)
    a1 = _band(book, number=1, passign=tab)
    chained = _band(book, number=1, passign=tab, accum_init=a0)
    assert torch.equal(chained, a0 + a1)
    merged = _band(book, number=0, passign=tab, n_calls=2, spp_last=2)
    assert torch.equal(merged, chained)


def test_iterstats_probe_keeps_green_and_blue(book):
    """The probe's red counts issued iterations (at least one per sample,
    more where paths march) and its green and blue are the normal render's
    bit for bit."""
    normal = _band(book)
    probe = _band(book, ablate=("iterstats",))
    assert torch.equal(probe[..., 1:], normal[..., 1:])
    red = probe[..., 0]
    assert bool((red >= 2).all()) and float(red.mean()) / 2 > 1.0
    assert torch.equal(red, red.round())


def test_merged_band_matches_jax(book):
    """The port's merged band (3 calls: 2, 2, 1 spp, fast mode, depth 6)
    against the JAX package's in interpret mode, within its own budget for
    the merge (tests/test_balance.py): <= 1% of pixels differ, the mean
    within 1% (measured: see ROADMAP)."""
    rr = (1, 16, 0.05)
    port = _band(book, spp=2, n_calls=3, spp_last=1, rr=rr).numpy()
    vp = jtrace.viewport_arrays(reference_camera(), BW, BH)
    ref = np.asarray(jtrace.render_band(
        book, vp, band_h=BH, width=BW, y0=np.int32(0), seed_y0=np.int32(0),
        offset_x=np.int32(0), spp=np.int32(2), number=np.uint32(0), max_depth=6,
        backend="grid", pixels_per_lane=2, skip_tmax=True, rr=rr,
        n_calls=np.int32(3), spp_last=np.int32(1)))
    diff = np.any(port != ref, axis=2)
    assert diff.mean() <= 0.01, f"{int(diff.sum())} pixels differ"
    assert abs(port.mean() - ref.mean()) / ref.mean() < 0.01
