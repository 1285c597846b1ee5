"""Port parity: the dense-scene path (models/paged_grid.py, ops/pagedkernel.py).

The paged-grid tables must be byte-equal to the JAX builder's.  On the CPU
the step wrapper runs the plain torch version; it is held against the JAX
``paged_megakernel_step`` in Pallas interpret mode from the same packed
state, and the port's paged renders against the port's brute-force
megakernel on the JAX package's own pins (tests/test_paged.py).  The CUDA
kernel itself is compared with the plain version on the card
(tests/test_torch_cuda.py and chip_smoke.py).

The port's paged state keeps the pixel sums apart, in a home-order
accumulator, and has no accumulator rows; ``_jax_layout`` rebuilds the JAX
state rows from the port's state and accumulator (lanes not re-bucketed, so
lane == lane0) for the step comparisons.

Tolerance of the step comparison: XLA:CPU contracts FMAs and rewrites
``x / sqrt(y)`` (ROADMAP queue 3), and the expanded quadratic's
cancellation turns that into t noise of ~1e-4 on the field's small spheres,
which the hit normal scales by 1/r into the bounce direction.  So the
discrete state (u32 rows incl. the cell and lane0, pixel coords, throughput)
is compared bit for bit on a stated share of lanes, the winner key, the
running sum, the accumulators and the carried attribute rows bit for bit on
those lanes (all but 2 of 4043 after five iterations), and o and d within
stated tolerances.  The JAX kernel is compiled once (k_steps=1, ~18 s in
interpret mode) and run five times for the five-iteration comparison: a
launch round-trips its whole state, so five one-iteration launches are one
five-iteration launch.
"""

import numpy as np
import pytest
import torch

from raytrace_tpu.models.paged_grid import build_paged_grid as j_build_paged
from raytrace_tpu.models.scene import CHECKERED as J_CHECKERED
from raytrace_tpu.models.scene import random_sphere_field as j_field
from raytrace_tpu.ops import pagedkernel as jpaged
from raytrace_tpu.ops import trace as jtrace
from raytrace_tpu.ops.pallas_intersect import sphere_table as j_sphere_table
from raytrace_tpu_torch.models.paged_grid import PagedGridTables, build_paged_grid
from raytrace_tpu_torch.models.scene import CHECKERED, random_sphere_field
from raytrace_tpu_torch.ops import intersect, pagedkernel, trace
from raytrace_tpu_torch.runtime.renderer import reference_camera, resolve_backend

torch.set_num_threads(1)

W, H = 48, 27
DISCRETE_F_ROWS = [pagedkernel.R_FX, pagedkernel.R_FY, pagedkernel.R_THR,
                   pagedkernel.R_THR + 1, pagedkernel.R_THR + 2]
J_ACC = 21  # the JAX state's acc rows: 21 + 3m + c, then the carried attrs


def _field(make, n=2000, extent=7.0, y_range=None, textured=False, checkered=CHECKERED):
    sc = make(n, seed=1, extent=extent, y_range=y_range)
    if textured:
        sc.texture[50:200] = checkered
        sc.color1[50:200] = (0.9, 0.2, 0.1)
    return sc


FIELDS = {
    "dense": dict(),
    "varied": dict(y_range=(0.2, 2.0)),
    "dense_textured": dict(textured=True),
    "varied_textured": dict(y_range=(0.2, 2.0), textured=True),
    "field100k": dict(n=100_000, extent=50.0),
}


@pytest.mark.parametrize("name", list(FIELDS))
def test_builder_byte_equal_to_jax(name):
    kw = FIELDS[name]
    own_sc = _field(random_sphere_field, **kw)
    ref_sc = _field(j_field, **kw, checkered=J_CHECKERED)
    own = build_paged_grid(own_sc, intersect.sphere_table(own_sc))
    ref = j_build_paged(ref_sc, j_sphere_table(ref_sc))
    assert own is not None and ref is not None
    assert PagedGridTables._fields == type(ref)._fields
    for field in PagedGridTables._fields:
        a, b = getattr(own, field), getattr(ref, field)
        assert (a is None) == (b is None), field
        if a is not None:
            a = a.numpy()
            assert a.dtype == b.dtype and a.shape == b.shape, field
            assert a.tobytes() == b.tobytes(), field
    assert (own.has_cy is not None) == ("y_range" in kw)
    assert (own.has_tex is not None) == bool(kw.get("textured"))


@pytest.fixture(scope="module")
def dense():
    return trace.prepare_scene(random_sphere_field(2000, seed=1, extent=7.0))


def _jax_layout(f, acc, m_slots, n_lanes, na):
    """The JAX package's f32 paged state rows from the port's state and
    home-order accumulator, for lanes in home order (lane k is lane0 k)."""
    f = f.numpy()
    rf = jpaged.pf_rows(m_slots, na)
    out = np.zeros((rf, f.shape[1]), np.float32)
    out[:J_ACC] = f[:J_ACC]
    pix = np.arange(m_slots)[:, None] * n_lanes + np.arange(n_lanes)[None, :]
    acc_pad = np.zeros((m_slots * n_lanes, 3), np.float32)
    acc_pad[: acc.shape[0]] = acc.numpy()
    out[J_ACC : J_ACC + 3 * m_slots, :n_lanes] = (
        acc_pad[pix.reshape(-1)].reshape(m_slots, n_lanes, 3)
        .transpose(0, 2, 1).reshape(3 * m_slots, n_lanes))
    a0 = J_ACC + 3 * m_slots
    out[a0 : a0 + na] = f[pagedkernel.R_ATT : pagedkernel.R_ATT + na]
    return out


@pytest.fixture(scope="module")
def steps(dense):
    """The JAX step from one packed state (one JAX TILE of 4096 lanes, M=2,
    depth 12): its states after one and after five one-iteration launches,
    and the port's plain steps of one and five iterations from the same
    state, in the JAX layout."""
    ds = trace.device_scene_from_numpy(dense, "cpu")
    vp = trace.viewport_arrays(reference_camera(), 128, 64)
    f, u, scal, vpr, geom = trace.pack_state(
        ds, vp, backend="paged", band_h=64, width=128, y0=0, seed_y0=0,
        offset_x=0, spp=2, number=0, pixels_per_lane=2, lane_pad=jpaged.TILE)
    assert f.shape[1] == jpaged.TILE == geom["n_lanes"]
    kw = dict(geom, max_depth=12, skip_tmax=True)
    na = pagedkernel.n_carry(False, False)
    g = dense.paged
    acc0 = trace.home_accum(None, geom["p_total"], "cpu")
    fj = _jax_layout(f, acc0, 2, geom["n_lanes"], na)
    uj = u.numpy().view(np.uint32)
    jax_states = []
    for _ in range(5):
        fj, uj = jpaged.paged_megakernel_step(
            scal.numpy(), vpr.numpy(), g.gscal, g.gtab, g.geom, g.lids, g.attrs,
            fj, uj, k_steps=1, interpret=True, five=False, textured=False,
            carry=True, **kw)
        fj, uj = np.asarray(fj), np.asarray(uj)
        jax_states.append((fj, uj.view(np.int32)))
    before = pagedkernel.paged_megakernel_step_plain.launches
    port = {}
    for k in (1, 5):
        acc = acc0.clone()
        fk, uk, _ = pagedkernel.paged_megakernel_step(
            scal, vpr, ds.paged, f, u, acc, k_steps=k, **kw)
        port[k] = (_jax_layout(fk, acc, 2, geom["n_lanes"], na), uk.numpy())
    assert pagedkernel.paged_megakernel_step_plain.launches == before + 2
    return {1: (*port[1], *jax_states[0]), 5: (*port[5], *jax_states[4])}


def _discrete_same(fp, up, fj, uj):
    return (up == uj).all(axis=0) & (fp[DISCRETE_F_ROWS] == fj[DISCRETE_F_ROWS]).all(axis=0)


def _close_share(a, b, tol):
    return float(np.isclose(a, b, rtol=tol, atol=tol, equal_nan=True).all(axis=0).mean())


def test_step_matches_jax_interpret(steps):
    """Five iterations: the discrete state on >= 97% of lanes (measured
    98.7%); on those lanes bkey, cur, the carried attribute rows and the
    accumulators bit for bit on >= 99.9% (measured 99.95%: two lanes found
    a grazing hit at different t), o within 1e-3 on >= 95% (measured
    99.0%), d within 1e-2 on >= 99% and within 1e-3 on >= 93% (measured
    99.5% and 94.4%)."""
    fp, up, fj, uj = steps[5]
    same = _discrete_same(fp, up, fj, uj)
    assert same.mean() >= 0.97, f"discrete state equal on {same.mean():.2%} of lanes"
    assert (up[pagedkernel.U_LANE0] == uj[pagedkernel.U_LANE0]).all()
    a0 = J_ACC + 3 * 2
    exact = [pagedkernel.R_BKEY, *range(pagedkernel.R_CUR, pagedkernel.R_CUR + 3),
             *range(J_ACC, a0 + pagedkernel.n_carry(False, False))]
    assert (fp[exact][:, same] == fj[exact][:, same]).all(axis=0).mean() >= 0.999
    assert _close_share(fp[0:3, same], fj[0:3, same], 1e-3) >= 0.95
    assert _close_share(fp[3:6, same], fj[3:6, same], 1e-2) >= 0.99
    assert _close_share(fp[3:6, same], fj[3:6, same], 1e-3) >= 0.93


def test_first_iteration_matches_jax_interpret(steps):
    """One iteration (segment start, globals, slab clip, fine-DDA init, one
    cell, lid and attribute fetch): the discrete state on >= 99% of lanes
    (measured 99.98%), and on those lanes every row but the geometry (o, d,
    t_best, t_nx, t_nz) bit for bit; o within 1e-3 on >= 99% (measured
    99.95%), d within 1e-2 on >= 99.5% and within 1e-3 on >= 96% (measured
    99.9% and 97.4%)."""
    fp, up, fj, uj = steps[1]
    same = _discrete_same(fp, up, fj, uj)
    assert same.mean() >= 0.99, f"discrete state equal on {same.mean():.2%} of lanes"
    geom = [0, 1, 2, 3, 4, 5, pagedkernel.R_TB, pagedkernel.R_TNX, pagedkernel.R_TNZ]
    rest = [r for r in range(fp.shape[0]) if r not in geom]
    assert np.array_equal(fp[rest][:, same], fj[rest][:, same])
    assert _close_share(fp[0:3, same], fj[0:3, same], 1e-3) >= 0.99
    assert _close_share(fp[3:6, same], fj[3:6, same], 1e-2) >= 0.995
    assert _close_share(fp[3:6, same], fj[3:6, same], 1e-3) >= 0.96


def _render(ds_np, backend, *, depth, spp, m=2):
    ds = trace.device_scene_from_numpy(ds_np, "cpu")
    vp = trace.viewport_arrays(reference_camera(), W, H)
    return trace.render_band(
        ds, vp, band_h=H, width=W, y0=0, seed_y0=0, offset_x=0, spp=spp,
        number=0, max_depth=depth, backend=backend, pixels_per_lane=m,
        skip_tmax=True).numpy()


PINS = {  # tests/test_paged.py's bit-identity pins
    "dense_d2": (dict(), dict(depth=2, spp=1, m=1)),
    "varied_d5": (dict(y_range=(0.2, 2.0)), dict(depth=5, spp=2)),
    "dense_textured_d5": (dict(textured=True), dict(depth=5, spp=2)),
    "varied_textured_d5": (dict(y_range=(0.2, 2.0), textured=True), dict(depth=5, spp=2)),
}


@pytest.mark.parametrize("name", list(PINS))
def test_paged_equals_mega(name):
    scene_kw, render_kw = PINS[name]
    ds = trace.prepare_scene(_field(random_sphere_field, **scene_kw))
    assert ds.grid is None and ds.paged is not None
    before = pagedkernel.paged_megakernel_step_plain.launches
    paged = _render(ds, "paged", **render_kw)
    assert pagedkernel.paged_megakernel_step_plain.launches > before
    assert np.array_equal(paged, _render(ds, "mega", **render_kw))


def test_paged_matches_mega_deep(dense):
    """Depth 6, 2 spp, M=2 (tests/test_paged.py:72-81): the JAX rule allows
    max(3 x (mega vs bruteforce pixels), 6) differing pixels; eager IEEE
    torch has no per-graph fp choices, and measures 0."""
    a = _render(dense, "mega", depth=6, spp=2)
    b = _render(dense, "paged", depth=6, spp=2)
    bf = _render(dense, "bruteforce", depth=6, spp=2)
    pm = int((np.abs(a - b).max(axis=2) > 0).sum())
    mb = int((np.abs(a - bf).max(axis=2) > 0).sum())
    assert pm <= max(3 * mb, 6), (pm, mb)
    assert abs(a.mean() - b.mean()) / a.mean() < 2e-3
    assert pm == 0, f"{pm} px differ (mega vs bruteforce: {mb})"


def test_pixels_per_lane_invariant(dense):
    """M=1 and M=3 change the lane count and the re-bucket interval; the
    image stays bit for bit the same."""
    assert np.array_equal(_render(dense, "paged", depth=5, spp=2, m=1),
                          _render(dense, "paged", depth=5, spp=2, m=3))


def _hand_loop(ds_np, *, k_steps, sort, m=2, depth=5, spp=2):
    """The paged step driven by hand: before every launch of ``k_steps``
    iterations the live lanes are sorted by key and compacted (``sort``),
    or never (every lane stays, in home order, until none is alive)."""
    ds = trace.device_scene_from_numpy(ds_np, "cpu")
    vp = trace.viewport_arrays(reference_camera(), W, H)
    f, u, scal, vpr, geom = trace.pack_state(
        ds, vp, backend="paged", band_h=H, width=W, y0=0, seed_y0=0,
        offset_x=0, spp=spp, number=0, pixels_per_lane=m)
    acc = trace.home_accum(None, geom["p_total"], "cpu")
    kw = dict(geom, max_depth=depth, skip_tmax=True, k_steps=k_steps)
    key = trace._rebucket_key(f, u, ds.paged.gscal)
    while bool((u[pagedkernel.U_ALIVE] != 0).any()):
        if sort:
            f, u = trace.gather_lanes(f, u, trace.live_order(key))
        f, u, key = pagedkernel.paged_megakernel_step(scal, vpr, ds.paged, f, u, acc, **kw)
    return acc.reshape(H, W, 3).numpy()


@pytest.mark.parametrize("how", ["never", "every_launch_k1"])
def test_sort_and_compaction_leave_the_image(dense, how):
    """The driver sorts and compacts the live lanes before every launch of
    ``scaled_k`` iterations; never sorting (all lanes in home order), or
    sorting before every single iteration, gives the same image bit for
    bit (M=2)."""
    ref = _render(dense, "paged", depth=5, spp=2)
    k = pagedkernel.scaled_k(-(-W * H // 2))
    got = (_hand_loop(dense, k_steps=k, sort=False) if how == "never"
           else _hand_loop(dense, k_steps=1, sort=True))
    assert np.array_equal(got, ref)


def test_step_key_and_live_order(dense):
    """The key a step returns is ``_rebucket_key`` of its new state: dead
    lanes get KEY_DEAD, and ``live_order`` keeps exactly the live lanes in
    key order.  The sentinels lie beyond every Morton page code (the 100k
    field's pages reach code 13,848, past the JAX key's 4096 / 4097)."""
    ds = trace.device_scene_from_numpy(dense, "cpu")
    vp = trace.viewport_arrays(reference_camera(), W, H)
    f, u, scal, vpr, geom = trace.pack_state(
        ds, vp, backend="paged", band_h=H, width=W, y0=0, seed_y0=0,
        offset_x=0, spp=1, number=0, pixels_per_lane=1)
    acc = trace.home_accum(None, geom["p_total"], "cpu")
    f2, u2, key = pagedkernel.paged_megakernel_step(
        scal, vpr, ds.paged, f, u, acc, max_depth=4, skip_tmax=True, k_steps=6, **geom)
    assert key.dtype == torch.int32
    assert torch.equal(key, trace._rebucket_key(f2, u2, ds.paged.gscal))
    alive = u2[pagedkernel.U_ALIVE] != 0
    assert bool(alive.any()) and bool((~alive).any())  # lanes past n_lanes are dead
    assert torch.equal(key == trace.KEY_DEAD, ~alive)
    perm = trace.live_order(key)
    assert torch.equal(torch.sort(perm).values, torch.nonzero(alive).reshape(-1))
    assert bool((key[perm][1:] >= key[perm][:-1]).all())
    page_max = int(trace._morton(torch.tensor(208 >> 3), torch.tensor(208 >> 3)))
    assert 4097 < page_max < trace.KEY_MISS < trace.KEY_DEAD


def test_jax_built_tables_give_the_same_image(dense):
    """Weight import: paged tables built by the JAX package, carried over by
    ``device_scene_from_numpy``, render the same image as the port's own."""
    from_jax = jtrace.prepare_scene(j_field(2000, seed=1, extent=7.0))
    assert from_jax.paged is not None
    ds = trace.device_scene_from_numpy(from_jax, "cpu")
    assert isinstance(ds.paged, PagedGridTables)
    assert torch.equal(ds.paged.geom, torch.from_numpy(dense.paged.geom))
    assert np.array_equal(_render(from_jax, "paged", depth=4, spp=2),
                          _render(dense, "paged", depth=4, spp=2))


def test_auto_backend_picks_paged_for_dense(dense):
    assert resolve_backend("auto", trace.device_scene_from_numpy(dense, "cpu")) == "paged"


def test_split_tables_raise():
    """The hot/overflow split (``govf``) is not ported: the step refuses it
    by name."""
    sc = random_sphere_field(2000, seed=1, extent=7.0)
    split = build_paged_grid(sc, intersect.sphere_table(sc), hot_slots=-1)
    assert split.govf is not None
    ds = trace.prepare_scene(sc)._replace(paged=split)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        _render(ds, "paged", depth=2, spp=1)
