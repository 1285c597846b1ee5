"""Grid-DDA wavefront megakernel: the acceleration-structure backend.

Port of ``raytrace_tpu/ops/gridkernel.py`` (``grid_megakernel_step``), the
renderer's main path for the book scene.  Per wavefront iteration each live
lane is in one of two modes:

  need_start (fresh segment): brute-force the <= 32 "global" spheres (ground,
      heroes, boundary-line spills), clip the ray against the grid's slab box
      and initialise a 2-D Amanatides-Woo DDA over the (x, z) cell lattice;
  marching: up to ``j_steps`` DDA cells — each cell's candidates (4-value
      slots with a shared cy, or <= 8 five-value slots) get the exact
      brute-force quadratic, and the march ends when the next cell cannot
      beat the best hit or the ray leaves the grid.

Lanes whose march completed resolve the winner by sphere id (one ``attrs``
record, plus ``tattrs`` or the textured-globals ``gttab`` chain), shade
(``shading_rows``), terminate or continue, flush the running pixel sum ``cur``
into the band's accumulator when a (pixel, call) chunk's samples are done,
and regenerate.
Results are identical to the brute-force megakernel: the same packed (cx,
cz, kc) values, the same quadratic op order, strict-< updates over
index-sorted candidates in ray-ordered cells (models/grid.py exactness
contract).  ``j_steps`` moves where a launch stops, never an output bit.

The tables are ``models.grid.CellTables``: the JAX package's block-major
tables re-laid once per scene (``cell_major``) so that a cell's slots and a
sphere's attributes are each one contiguous record.

The pixel sums do not ride in the lane state: a finished chunk's sum is
added into a separate [p_total, 3] f32 accumulator in home (pixel) order, at
pixel ``lane_pixel(m, lane0, ...)``, in place, and the ``U_LANE0`` row
carries the lane's home index, so the driver
(``ops/trace.py:_render_band_mega``) can drop dead lanes between launches.
``lane_pixel`` is M strided pixels per lane, or the balanced table
``passign`` [m_slots, n_pad] (``runtime/balance.py``): a lane renders the
pixels of its column in slot order.

The in-kernel call merge: a launch renders ``n_calls`` progressive calls
(scalar slots ``S_NCALLS``, ``S_SPPLAST``: numbers number..number+n_calls-1,
``spp`` samples each and ``spp_last`` in the last) of each pixel before the
lane moves on; ``cur`` is flushed at every call boundary, so the
accumulator receives the host loop's adds in its order, bit for bit.  The
JAX kernel's hoisted fresh-seed rows (its u32 rows 9-11, a Mosaic scheduling
device) are computed inline here: the same hash of the same operands.  The
port's u32 rows 0-7 are the JAX rows 0-7 and its row 9 (``U_CALL``) is the
JAX row 8.

``iterstats``: the JAX ``ablate=("iterstats",)`` probe: red counts the
issued iterations of the lane's current (pixel, call) chunk instead of
colour; green and blue stay colour.

The section-cost probes (``ablate``, the JAX kernel's switches for
``scripts/grid_ablate.py`` and ``grid_iterbench.py``; ``SWITCHES``): the
duplications (``DUPLICATIONS``, ``global2`` ... ``camera2``) run one section
a second time and discard it, so the image is bit-identical and the plain
version ignores them; the removals (``cut_*``) replace a section with a
passthrough of live values, with the JAX kernel's meaning (the image is
invalid); ``freeze`` (the JAX paged kernel's switch) pins the march: a
cell's advance is discarded and the cell stays, so a marching lane marches
forever.  On the card each switch set is a library of its own
(``_build.library(grid=mask)``), in which ``freeze`` makes every live lane run
every section each iteration.  ``ABLATE`` (empty) is read by
``runtime/renderer.py`` at call time.

``grid_megakernel_step`` launches the hand-written CUDA kernel
(``csrc/gridkernel.cu``) for CUDA state and the plain torch version
``grid_megakernel_step_plain`` for CPU state; each counts its launches in its
``launches`` attribute.

State layout (rows of [rows, lanes] tensors):
  f32:  0-2 o | 3-5 d | 6 fx | 7 fy | 8-10 thr | 11 t_best | 12 t_end
        | 13 t_nx | 14 t_nz | 15 bkey | 16-18 cur.rgb  (the JAX state's rows
        0-15 and 18-20; its rows 16-17 are unused and its acc rows are the
        accumulator)
  int32 (u32 bits): 0 seed | 1 m | 2 sidx | 3 depth | 4 alive | 5 marching
        | 6 icx | 7 icz | 8 lane0 | 9 call
bkey is the winner: the sphere id for grid hits, 4096 + id for global hits.
"""

from __future__ import annotations

import torch

from ..models.grid import (G_CMAXX, G_CMAXZ, G_CMINX, G_CMINZ, G_CY, G_INVS,
                           G_NCZ, G_S, G_XHI, G_XLO, G_YHI, G_YLO, G_ZHI,
                           G_ZLO)
from . import fp
from . import launches
from . import rng as rngops
from .intersect import BIG
from .megakernel import (S_NCALLS, S_NUMBER, S_OFFX, S_SEEDY0, S_SPP,
                         S_SPPLAST, S_Y0, SKY, TMAX, TMIN, _check_state,
                         _cuda_args, _rr_args, camera_rays_rows, count_work,
                         rr_probability)
from .shading_rows import norm3, shade_rows

K_STEPS = 40  # wavefront iterations per launch
J_STEPS = 2  # DDA cells per wavefront iteration at most

R_O, R_D, R_FX, R_FY, R_THR = 0, 3, 6, 7, 8
R_TB, R_TE, R_TNX, R_TNZ, R_BKEY = 11, 12, 13, 14, 15
R_CUR = 16
F_ROWS = R_CUR + 3
U_SEED, U_M, U_SIDX, U_DEPTH, U_ALIVE, U_MARCH, U_ICX, U_ICZ, U_LANE0, U_CALL = range(10)
U_ROWS = 10

TAG = 4096.0  # bkey values >= TAG are global-table winners (TAG + id)
MAX_G = 32  # rows of gtab / gttab the kernel stages (models/grid.py MAX_GTAB)

# the probe switches; bit i of a variant's mask is SWITCHES[i]
# (csrc/gridkernel.cu's constants)
SWITCHES = ("global2", "fetch2", "isect2", "dda2", "resolve2", "shade2", "camera2",
            "cut_tea", "cut_globals", "cut_init", "cut_fetch", "cut_quad", "cut_resolve",
            "cut_shade", "cut_sin", "cut_camera", "freeze")
DUPLICATIONS = SWITCHES[:7]
ABLATE: frozenset = frozenset()  # the renderer's switches (scripts/grid_ablate.py)


def switch_mask(ablate, switches=SWITCHES, kernel="grid") -> int:
    """The library mask of the switch set ``ablate``; a token the port does
    not have raises ``NotImplementedError``."""
    mask = 0
    for a in ablate:
        if a not in switches:
            raise NotImplementedError(
                f"ablate token {a!r}: the {kernel} kernel's probes are {switches} (the "
                "Mosaic switches are not ported: ROADMAP, 'Not ported, by design')")
        mask |= 1 << switches.index(a)
    return mask


def layout(grid):
    """(five, n_slots, stride) of a CellTables' cell records."""
    return bool(grid.five), int(grid.n_slots), int(grid.cells.shape[1])


def lane_pixel(m, lane0, n_lanes, passign=None, p_total=None):
    """The pixel of slot ``m`` of the lane with home index ``lane0``: M
    strided pixels per lane, or ``passign[m, lane0]`` (int64 tensors); a
    slot outside the table is ``p_total``, no pixel.  The kernel's
    ``lane_pixel`` is the same function."""
    if passign is None:
        return m * n_lanes + lane0
    m_slots = passign.shape[0]
    pix = passign[m.clamp(0, m_slots - 1), lane0].to(torch.int64)
    return torch.where((m >= 0) & (m < m_slots), pix, p_total)


def _check_passign(passign, m_slots, n_lanes, device):
    if passign is None:
        return
    if passign.dtype != torch.int32 or passign.device != device:
        raise TypeError(f"passign must be int32 on {device}, got {passign.dtype} "
                        f"on {passign.device}")
    if passign.dim() != 2 or passign.shape[0] != m_slots or passign.shape[1] < n_lanes:
        raise ValueError(f"passign {tuple(passign.shape)}, want ({m_slots}, >= {n_lanes})")


def _quadratic(ox, oy, oz, dx, dy, dz, a, od, oo, inv_a, cx, cy, cz, kc, *,
               skip_tmax, big):
    """shader.rint:44-60 — the exact op order of the brute-force table scan."""
    cd = cx * dx + cy * dy + cz * dz
    co = cx * ox + cy * oy + cz * oz
    b = od - cd
    c = oo - 2.0 * co + kc
    disc = b * b - a * c
    sq = fp.sqrt(disc)  # NaN on miss; comparisons below then stay False
    t1 = (-b - sq) * inv_a
    t2 = (-b + sq) * inv_a
    if skip_tmax:
        t1_ok, t2_ok = t1 >= TMIN, t2 >= TMIN
    else:
        t1_ok = (t1 >= TMIN) & (t1 <= TMAX)
        t2_ok = (t2 >= TMIN) & (t2 <= TMAX)
    return torch.where(t1_ok, t1, torch.where(t2_ok, t2, big))


def _slab_inv(o_c, d_c, inv, lo, hi, big):
    """Ray vs axis slab [lo, hi] -> (t_enter, t_exit) from a precomputed
    reciprocal; degenerate d: inside -> (-BIG, BIG), outside -> empty."""
    ta = (lo - o_c) * inv
    tb = (hi - o_c) * inv
    t0 = torch.minimum(ta, tb)
    t1 = torch.maximum(ta, tb)
    deg = d_c == 0.0
    inside = (o_c >= lo) & (o_c <= hi)
    t0 = torch.where(deg, torch.where(inside, -big, big), t0)
    t1 = torch.where(deg, torch.where(inside, big, -big), t1)
    return t0, t1


def grid_megakernel_step(scal, vpr, grid, fstate, ustate, acc, *, m_slots,
                         n_lanes, p_total, width, max_depth, k_steps=K_STEPS,
                         j_steps=J_STEPS, skip_tmax=False, rr=None,
                         passign=None, iterstats=False, ablate=()):
    """``k_steps`` grid-traced wavefront iterations over the state's lanes.

    ``grid``: CellTables of torch tensors on the state's device.  fstate
    [F_ROWS, n] f32, ustate [U_ROWS, n] int32, any n; ``acc`` [p_total, 3]
    f32, the band's pixel sums in home order, updated in place.
    ``passign``: None (M strided pixels per lane) or the balanced table,
    int32 [m_slots, n_pad] indexed by slot and ``U_LANE0``; ``iterstats``:
    the cost probe; ``ablate``: probe switches (``SWITCHES``).  Returns new
    (fstate, ustate).  CUDA tensors launch the kernel (the switch set's
    library); CPU tensors run ``grid_megakernel_step_plain``."""
    mask = switch_mask(ablate)
    _check_state(fstate, ustate, F_ROWS, U_ROWS)
    if acc.shape != (p_total, 3) or acc.dtype != torch.float32:
        raise ValueError(f"acc {tuple(acc.shape)} {acc.dtype}, want ({p_total}, 3) float32")
    if j_steps < 1:
        raise ValueError(f"j_steps must be >= 1, got {j_steps}")
    _check_passign(passign, m_slots, n_lanes, fstate.device)
    kw = dict(m_slots=m_slots, n_lanes=n_lanes, p_total=p_total, width=width,
              max_depth=max_depth, k_steps=k_steps, j_steps=j_steps,
              skip_tmax=skip_tmax, rr=rr, passign=passign, iterstats=iterstats,
              ablate=ablate)
    if fstate.device.type == "cpu":
        return grid_megakernel_step_plain(scal, vpr, grid, fstate, ustate, acc, **kw)
    if fstate.device.type != "cuda":
        raise ValueError(f"unsupported device {fstate.device}")
    from .. import _build

    five, n_slots, stride = layout(grid)
    g = grid
    n_ids = g.attrs.shape[0]
    if stride % 4 or stride < (5 if five else 4) * n_slots:
        raise ValueError(f"cells {tuple(g.cells.shape)} cannot hold {n_slots} slots")
    if g.attrs.shape != (n_ids, 8) or (g.tattrs is not None and g.tattrs.shape != (n_ids, 4)):
        raise ValueError("attrs must be [n, 8] and tattrs [n, 4]")
    if g.gtab.shape[1] != 16 or g.gttab.shape[1] != 16 or g.gscal.numel() < 16:
        raise ValueError("gtab/gttab must be [n, 16] and gscal hold 16 values")
    if g.gtab.shape[0] > MAX_G or g.gttab.shape[0] > MAX_G:
        raise ValueError(f"at most {MAX_G} global rows, got {g.gtab.shape[0]} / {g.gttab.shape[0]}")
    if scal.numel() < 8 or vpr.numel() < 24:
        raise ValueError("scal must hold 8 int32 and vpr 24 float32 values")
    f32, i32 = torch.float32, torch.int32
    tensors = dict(scal=scal, vpr=vpr, gscal=g.gscal, gtab=g.gtab, gttab=g.gttab,
                   cells=g.cells, attrs=g.attrs)
    dtypes = dict(scal=i32, vpr=f32, gscal=f32, gtab=f32, gttab=f32, cells=f32,
                  attrs=f32, tattrs=f32, passign=i32, fstate=f32, ustate=i32, acc=f32)
    if g.tattrs is not None:
        tensors["tattrs"] = g.tattrs
    if passign is not None:
        tensors["passign"] = passign
    tensors.update(fstate=fstate, ustate=ustate, acc=acc)
    ptrs = _cuda_args(tensors, dtypes, fstate.device)
    if g.tattrs is None:
        ptrs.insert(7, None)
    if passign is None:
        ptrs.insert(8, None)
    for name in ("cells", "attrs", "tattrs"):
        t = getattr(g, name)
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (read as float4)")
    fout = torch.empty_like(fstate)
    uout = torch.empty_like(ustate)
    err = _build.library(grid=mask).rt_grid_megakernel_step(
        *ptrs, fout.data_ptr(), uout.data_ptr(),
        g.gtab.shape[0], g.gttab.shape[0], int(five), n_slots, stride,
        fstate.shape[1], m_slots, n_lanes, p_total, width, max_depth, k_steps,
        j_steps, int(bool(skip_tmax)), 0 if passign is None else passign.shape[1],
        int(bool(iterstats)), 0, g.cells.shape[0], n_ids, *_rr_args(rr),
        fstate.device.index, torch.cuda.current_stream(fstate.device).cuda_stream)
    if err:
        raise RuntimeError(f"grid kernel launch failed: {_build.error_string(err)}")
    launches.count(grid_megakernel_step, "+".join(ablate))
    return fout, uout


grid_megakernel_step.launches = 0
grid_megakernel_step.variant_launches = {}  # per probe switch set


def grid_megakernel_step_plain(scal, vpr, grid, fstate, ustate, acc, **step):
    """The plain torch version of ``grid_megakernel_step``: the JAX
    ``_iterate`` vectorized over lanes, with the same operand order as the
    CUDA kernel, on the same CellTables; ``acc`` is updated in place.
    ``step``: the kernel's keywords, and ``work``: optional dict that
    receives the counts of ``megakernel.count_work``."""
    launches.count(grid_megakernel_step_plain)
    return _step_plain(scal, vpr, grid, fstate, ustate, acc, **step)


def grid_step_work(scal, vpr, grid, fstate, ustate, acc, **step) -> dict:
    """The ``megakernel.count_work`` tally of one launch on this state (the
    plain version's body, so a count, not a render: it adds nothing to
    either launch count); ``acc`` is updated in place."""
    work = {}
    _step_plain(scal, vpr, grid, fstate, ustate, acc, work=work, **step)
    return work


def _step_plain(scal, vpr, grid, fstate, ustate, acc, *, m_slots, n_lanes, p_total,
                width, max_depth, k_steps=K_STEPS, j_steps=J_STEPS, skip_tmax=False,
                rr=None, passign=None, iterstats=False, ablate=(), work=None):
    switch_mask(ablate)

    def cut(name):
        return "cut_" + name in ablate

    freeze = "freeze" in ablate
    dev = fstate.device
    f = fstate.clone()
    u = ustate.clone()
    sc = [int(x) for x in scal.reshape(-1)[:8].tolist()]
    spp, number = sc[S_SPP], sc[S_NUMBER] & rngops.MASK
    n_calls, spp_last = sc[S_NCALLS], sc[S_SPPLAST]
    y0, seed_y0, offx = sc[S_Y0], sc[S_SEEDY0], sc[S_OFFX]
    big = torch.tensor(BIG, dtype=torch.float32, device=dev)

    five, n_slots, stride = layout(grid)
    gs = grid.gscal.reshape(-1)
    cminx, cminz, cmaxx, cmaxz = gs[G_CMINX], gs[G_CMINZ], gs[G_CMAXX], gs[G_CMAXZ]
    icminx, icminz = int(cminx), int(cminz)
    icmaxx, icmaxz = int(cmaxx), int(cmaxz)
    ncz, cy_u, s_, inv_s = gs[G_NCZ], gs[G_CY], gs[G_S], gs[G_INVS]
    n_cells = grid.cells.shape[0]
    gtab = grid.gtab
    gttab = grid.gttab

    ox, oy, oz, dx, dy, dz = (f[R_O + i] for i in range(6))
    fx, fy = f[R_FX], f[R_FY]
    tx_, ty_, tz_ = f[R_THR], f[R_THR + 1], f[R_THR + 2]
    t_b, t_end, t_nx, t_nz, bkey = (f[r] for r in (R_TB, R_TE, R_TNX, R_TNZ, R_BKEY))
    cur = [f[R_CUR + i] for i in range(3)]
    seed = rngops.to_u32(u[U_SEED])
    mrow = u[U_M].to(torch.int64)
    sidx = u[U_SIDX].to(torch.int64)
    depth = u[U_DEPTH].to(torch.int64)
    alive = u[U_ALIVE] != 0
    marching = u[U_MARCH] != 0
    icx = u[U_ICX].to(torch.int64)
    icz = u[U_ICZ].to(torch.int64)
    lane0 = u[U_LANE0].to(torch.int64)
    cidx = u[U_CALL].to(torch.int64)
    alive_f = torch.zeros_like(t_b)

    for _ in range(k_steps):
        if not bool(alive.any()):
            break  # dead lanes are a fixed point of the iteration
        if iterstats:  # every issued iteration, marching ones too
            alive_f = alive.to(torch.float32)
        a = dx * dx + dy * dy + dz * dz
        od = ox * dx + oy * dy + oz * dz
        oo = ox * ox + oy * oy + oz * oz
        inv_a = 1.0 / a

        # ---- segment start: global spheres + grid clip + DDA init ---------
        need = alive & ~marching
        if work is not None:
            count_work(work, lane_iters=alive.sum(),
                       quadratics=need.sum() * (gtab[:, 3] < 1e30).sum())
        t_b = torch.where(need, big, t_b)
        bkey = torch.where(need, TAG, bkey)
        for k in range(0 if cut("globals") else gtab.shape[0]):
            tc = _quadratic(ox, oy, oz, dx, dy, dz, a, od, oo, inv_a,
                            gtab[k, 0], gtab[k, 1], gtab[k, 2], gtab[k, 3],
                            skip_tmax=skip_tmax, big=big)
            upd = need & (tc < t_b)
            t_b = torch.where(upd, tc, t_b)
            bkey = torch.where(upd, TAG + gtab[k, 4], bkey)

        # one reciprocal per axis, shared by the slab clip and the DDA steps
        inv_x = 1.0 / dx
        inv_y = 1.0 / dy
        inv_z = 1.0 / dz
        if not cut("init"):  # (cut: no lane starts a march)
            t0x, t1x = _slab_inv(ox, dx, inv_x, gs[G_XLO], gs[G_XHI], big)
            t0y, t1y = _slab_inv(oy, dy, inv_y, gs[G_YLO], gs[G_YHI], big)
            t0z, t1z = _slab_inv(oz, dz, inv_z, gs[G_ZLO], gs[G_ZHI], big)
            t_start = torch.maximum(torch.maximum(t0x, t0y),
                                    torch.clamp(t0z, min=TMIN))
            t_end_n = torch.minimum(torch.minimum(t1x, t1y), t1z)
            march0 = need & (t_start <= t_end_n) & (t_start < t_b)
            px0 = ox + t_start * dx
            pz0 = oz + t_start * dz
            icx_n = torch.minimum(torch.maximum(torch.floor(px0 * inv_s + 0.5), cminx), cmaxx)
            icz_n = torch.minimum(torch.maximum(torch.floor(pz0 * inv_s + 0.5), cminz), cmaxz)
            bx0 = (icx_n + torch.where(dx >= 0, 0.5, -0.5)) * s_
            bz0 = (icz_n + torch.where(dz >= 0, 0.5, -0.5)) * s_
            t_nx_n = torch.where(dx == 0.0, big, (bx0 - ox) * inv_x)
            t_nz_n = torch.where(dz == 0.0, big, (bz0 - oz) * inv_z)
            t_end = torch.where(need, t_end_n, t_end)
            t_nx = torch.where(march0, t_nx_n, t_nx)
            t_nz = torch.where(march0, t_nz_n, t_nz)
            icx = torch.where(march0, icx_n.to(torch.int64), icx)
            icz = torch.where(march0, icz_n.to(torch.int64), icz)
            marching = marching | march0

        # ---- DDA march: up to j_steps cells ---------------------------------
        step_x = torch.where(dx >= 0, 1, -1)
        step_z = torch.where(dz >= 0, 1, -1)
        dt_x = torch.where(dx == 0.0, big, torch.abs(inv_x) * s_)
        dt_z = torch.where(dz == 0.0, big, torch.abs(inv_z) * s_)
        for _j in range(j_steps):
            if not bool(marching.any()):
                break  # the cells below change no lane that is not marching
            cid = ((icx.to(torch.float32) - cminx) * ncz
                   + (icz.to(torch.float32) - cminz)).to(torch.int64)
            # non-marching lanes may hold a stale cell: clamp the fetch index
            # (their values are masked by ``marching`` below)
            rec = (ox.expand(stride, -1) if cut("fetch")  # (cut: every value is ox)
                   else grid.cells[cid.clamp(0, n_cells - 1)].T)  # [stride, n]
            if work is not None:  # the kernel loads a cell's n_slots float4 slots
                count_work(work, table_values=marching.sum() * 4 * n_slots)
            for s in range(n_slots):
                if five:
                    s_cx, s_cy, s_cz, s_kc = rec[4 * s : 4 * s + 4]
                    sid = rec[4 * n_slots + s]
                else:
                    s_cx, s_cz, s_kc, sid = rec[4 * s : 4 * s + 4]
                    s_cy = cy_u
                if work is not None:
                    count_work(work, quadratics=(marching & (s_kc < 1e30)).sum())
                tc = (s_cx + oy if cut("quad") else
                      _quadratic(ox, oy, oz, dx, dy, dz, a, od, oo, inv_a,
                                 s_cx, s_cy, s_cz, s_kc, skip_tmax=skip_tmax, big=big))
                upd = marching & (tc < t_b)
                if work is not None and five:  # the winning slot's id
                    count_work(work, table_values=upd.sum())
                t_b = torch.where(upd, tc, t_b)
                bkey = torch.where(upd, sid, bkey)
            if freeze:  # the cell stays
                continue
            t_exit = torch.minimum(t_nx, t_nz)
            cont = marching & (t_exit < t_b) & (t_exit < t_end)
            cross_x = t_nx <= t_nz
            adv_x = cont & cross_x
            adv_z = cont & ~cross_x
            icx = torch.where(adv_x, (icx + step_x).clamp(icminx, icmaxx), icx)
            icz = torch.where(adv_z, (icz + step_z).clamp(icminz, icmaxz), icz)
            t_nx = torch.where(adv_x, t_nx + dt_x, t_nx)
            t_nz = torch.where(adv_z, t_nz + dt_z, t_nz)
            marching = cont

        seg_done = alive & ~marching
        hit = t_b < big
        if work is not None:  # a segment's end loads the winner's attrs (and tattrs)
            count_work(work, segments=seg_done.sum(),
                       table_values=seg_done.sum() * (8 if grid.tattrs is None else 12))

        # ---- winner resolution: bkey (sphere id) -> attrs -------------------
        is_direct = bkey >= TAG
        bidx = torch.where(is_direct, bkey - TAG, bkey).to(torch.int64)
        # an id outside the table (made of ox under cut_fetch) reads entry
        # id & 127, as the JAX kernel's block-select gather does
        bidx = torch.where((bidx >= 0) & (bidx < grid.attrs.shape[0]), bidx, bidx & 127)
        # mat, c0.rgb, attr, center.xyz (cut: every one is bkey)
        at = bkey.expand(8, -1) if cut("resolve") else grid.attrs[bidx].T
        if grid.tattrs is not None:
            tex, c1x, c1y, c1z = grid.tattrs[bidx].T
        else:
            # tex / c1 exist only on textured globals (gttab rows)
            bidx_f = torch.where(is_direct, bkey - TAG, -1.0)
            zero = torch.zeros_like(t_b)
            tex, c1x, c1y, c1z = zero, zero, zero, zero
            for k in range(gttab.shape[0]):
                sel = bidx_f == gttab[k, 4]
                tex = torch.where(sel, gttab[k, 6], tex)
                c1x = torch.where(sel, gttab[k, 10], c1x)
                c1y = torch.where(sel, gttab[k, 11], c1y)
                c1z = torch.where(sel, gttab[k, 12], c1z)

        if cut("shade"):  # the ray passes through: point o, albedo and scatter d
            (px_, py_, pz_, ax, ay, az, sdx, sdy, sdz, does_scatter, seed_h) = (
                ox, oy, oz, dx, dy, dz, dx, dy, dz, t_b < big, seed)
        else:
            (px_, py_, pz_, ax, ay, az, sdx, sdy, sdz, does_scatter,
             seed_h) = shade_rows(ox, oy, oz, dx, dy, dz, t_b, seed,
                                  at[5], at[6], at[7], at[0], tex, at[1], at[2],
                                  at[3], c1x, c1y, c1z, at[4], cut_sin=cut("sin"))

        # ---- termination & accumulation (shader.rgen:70-89) ----------------
        scatters = hit & does_scatter
        deep = (depth + 1) >= max_depth
        cont_b = seg_done & scatters & ~deep
        ntx, nty, ntz = tx_ * ax, ty_ * ay, tz_ * az
        if rr is not None:
            dnext = depth + 1
            p = rr_probability(ntx, nty, ntz, dnext, rr)
            considered = cont_b & (dnext >= rr[0])
            seed_rr, u_rr = rngops.random_float(
                torch.where(seg_done & hit, seed_h, seed))
            cont_b = cont_b & ~(considered & (u_rr >= p))
            ntx = torch.where(considered, ntx / p, ntx)
            nty = torch.where(considered, nty / p, nty)
            ntz = torch.where(considered, ntz / p, ntz)
        term = seg_done & ~cont_b
        light = [torch.where(hit, torch.where(does_scatter, 0.0, al), sky)
                 for al, sky in zip((ax, ay, az), SKY)]
        red = cur[0] + alive_f if iterstats else None
        cur = [cv + torch.where(term, tc * lc, 0.0)
               for cv, tc, lc in zip(cur, (tx_, ty_, tz_), light)]
        if iterstats:
            cur[0] = red

        seed_a = torch.where(seg_done & hit, seed_h, seed)
        if rr is not None:
            seed_a = torch.where(considered, seed_rr, seed_a)

        # ---- flush the finished (pixel, call) chunk's sum into its slot --
        cur_spp = torch.where(cidx + 1 >= n_calls, spp_last, spp)
        more = term & (sidx < cur_spp)
        chunk_done = term & ~more
        pix = lane_pixel(mrow, lane0, n_lanes, passign, p_total)
        flush = chunk_done & (mrow >= 0) & (mrow < m_slots) & (pix < p_total)
        if work is not None:
            count_work(work, flushes=flush.sum())
        if bool(flush.any()):  # one lane per pixel: the indices are distinct
            idx = pix[flush]
            acc[idx] = acc[idx] + torch.stack(cur, dim=1)[flush]
        cur = [torch.where(chunk_done, 0.0, cv) for cv in cur]

        # ---- regen: next sample, next call of the pixel, or next pixel -----
        more_calls = chunk_done & (cidx + 1 < n_calls)
        pix_done = chunk_done & ~more_calls
        m2 = mrow + pix_done.to(torch.int64)
        pix2 = lane_pixel(m2, lane0, n_lanes, passign, p_total)
        adv = pix_done & (m2 < m_slots) & (pix2 < p_total)
        px2 = pix2 % width
        py2 = pix2 // width
        fx2 = (offx + px2).to(torch.float32)
        fy2 = (y0 + py2).to(torch.float32)
        # the fresh seeds: the next pixel's, the same pixel's next call's
        # (cut: the lane's seed)
        fresh_np = seed if cut("tea") else rngops.tea_hash(
            rngops.tea_hash(px2, seed_y0 + py2), torch.full_like(px2, number))
        seed_c = seed_a
        if n_calls > 1:  # the same pixel's next call (fx, fy hold its pixel)
            px_cur = (fx - float(offx)).to(torch.int64)
            py_cur = (fy - float(y0)).to(torch.int64)
            fresh_nc = seed if cut("tea") else rngops.tea_hash(
                rngops.tea_hash(px_cur, seed_y0 + py_cur), (number + cidx + 1) & rngops.MASK)
            seed_c = torch.where(more_calls, fresh_nc, seed_a)
        seed_c = torch.where(adv, fresh_np, seed_c)
        renew = more_calls | adv
        regen = more | renew
        fxn = torch.where(adv, fx2, fx)
        fyn = torch.where(adv, fy2, fy)
        if cut("camera"):  # the lane keeps its ray
            seed_r, (cox, coy, coz), (cdx, cdy, cdz) = seed_c, (ox, oy, oz), (dx, dy, dz)
        else:
            seed_r, (cox, coy, coz), (cdx, cdy, cdz) = camera_rays_rows(
                seed_c, fxn, fyn, vpr)
        bx, by, bz = norm3(sdx, sdy, sdz)

        ox = torch.where(cont_b, px_, torch.where(regen, cox, ox))
        oy = torch.where(cont_b, py_, torch.where(regen, coy, oy))
        oz = torch.where(cont_b, pz_, torch.where(regen, coz, oz))
        dx = torch.where(cont_b, bx, torch.where(regen, cdx, dx))
        dy = torch.where(cont_b, by, torch.where(regen, cdy, dy))
        dz = torch.where(cont_b, bz, torch.where(regen, cdz, dz))
        fx, fy = fxn, fyn
        tx_ = torch.where(cont_b, ntx, torch.where(regen, 1.0, tx_))
        ty_ = torch.where(cont_b, nty, torch.where(regen, 1.0, ty_))
        tz_ = torch.where(cont_b, ntz, torch.where(regen, 1.0, tz_))
        seed = torch.where(seg_done, torch.where(regen, seed_r, seed_a), seed)
        mrow = m2
        cidx = torch.where(pix_done, 0, cidx + more_calls.to(torch.int64))
        sidx = torch.where(renew, 1, sidx + more.to(torch.int64))
        depth = torch.where(cont_b, depth + 1, torch.where(regen, 0, depth))
        alive = marching | (seg_done & (cont_b | regen))

    for r, v in enumerate((ox, oy, oz, dx, dy, dz, fx, fy, tx_, ty_, tz_, t_b,
                           t_end, t_nx, t_nz, bkey, *cur)):
        f[r] = v
    u[U_SEED] = rngops.to_i32(seed)
    for r, v in ((U_M, mrow), (U_SIDX, sidx), (U_DEPTH, depth), (U_ALIVE, alive),
                 (U_MARCH, marching), (U_ICX, icx), (U_ICZ, icz), (U_CALL, cidx)):
        u[r] = v.to(torch.int32)
    return f, u


grid_megakernel_step_plain.launches = 0
