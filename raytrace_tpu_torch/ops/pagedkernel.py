"""Paged-grid wavefront megakernel: the backend for dense scenes.

Port of ``raytrace_tpu/ops/pagedkernel.py`` (``paged_megakernel_step``).  The
same state machine as the grid kernel (ops/gridkernel.py) -- segment start
with the brute-forced globals, slab clip and DDA init; march; shade, flush,
regenerate -- over the paged two-level grid of models/paged_grid.py:

- the DDA walks fine cells of size ``s``, ONE cell per wavefront iteration;
- a cell's candidates are read from its page, ``page = (icx >> 3) * nsczm +
  (icz >> 4)``, at column ``fc = ((icx & 7) << 4) | (icz & 15)``;
- where a lane's winner improved in this cell, the winning slot's page-local
  sphere id is read from ``lids`` and the winner's attributes from ``attrs``
  at once, and carried in state rows until the segment ends (the JAX
  package's production ``carry=True`` mode).

The JAX kernel's per-128-lane page-box loops (``_page_fetch``,
``_ab_select``) are Mosaic lane-gather machinery; here each lane reads only
where its mask is set (``marching`` for geometry, "winner improved" for lids
and attributes), exactly the values the box loop selects for it.

The pixel sums do not ride in the lane state: a finished pixel's sum is added
into a separate [p_total, 3] f32 accumulator in home (pixel) order, at pixel
``m * n_lanes + lane0``, in place.  The driver (``ops/trace.py:
_render_band_paged``) sorts the lanes by page and drops the dead ones between
launches; pixel identity rides in the ``U_LANE0`` row, and each step returns
the next sort key of every lane (``trace._rebucket_key`` of its output).

The section-cost probes (``ablate``, the JAX kernel's switches for
``scripts/paged_iterbench.py``; ``SWITCHES``): the removals (``cut_*``)
replace a section with a passthrough of live values, with the JAX kernel's
meaning (the image is invalid); ``freeze`` pins the march: the advance is
discarded and the cell stays.  On the card each switch set is a library of
its own (``_build.library(paged=mask)``), in which ``freeze`` makes every
live lane run every section each iteration.  ``ABLATE`` (empty) is read by
``runtime/renderer.py`` at call time.

``paged_megakernel_step`` launches the hand-written CUDA kernel
(``csrc/pagedkernel.cu``) for CUDA state and the plain torch version
``paged_megakernel_step_plain`` for CPU state; each counts its launches in its
``launches`` attribute.

State layout (rows of [rows, lanes] tensors; na carried attribute rows):
  f32:  0-2 o | 3-5 d | 6 fx | 7 fy | 8-10 thr | 11 t_best | 12 t_end
        | 13 t_nx | 14 t_nz | 15 bkey | 16 wcx | 17 wcz | 18-20 cur.rgb
        | 21+i carried attr i | pad to 8 rows
  int32 (u32 bits): 0 seed | 1 m | 2 sidx | 3 depth | 4 alive | 5 marching
        | 6 cell (icx << 12 | icz) | 7 lane0
bkey: (sx*32 + sz)*512 + lid for grid winners (page coords and page-local
sphere id), 2^23 + sphere id for global winners.  Carried attrs: (mat,
c0.rgb, fuzz[, center y][, tex, c1.rgb]).
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.paged_grid import (P_CY, P_FMAXX, P_FMAXZ, P_FMINX, P_FMINZ,
                                 P_INVS, P_NSCZM, P_S, P_XHI, P_XLO, P_YHI,
                                 P_YLO, P_ZHI, P_ZLO)
from . import launches
from . import rng as rngops
from .gridkernel import _quadratic, _slab_inv, switch_mask
from .intersect import BIG
from .megakernel import (S_NUMBER, S_OFFX, S_SEEDY0, S_SPP, S_Y0, SKY, TMIN,
                         _check_state, _cuda_args, _rr_args, camera_rays_rows,
                         count_work, rr_probability)
from .shading_rows import norm3, shade_rows

K_STEPS = 10  # iterations per launch at 32k lanes; scaled_k scales it
# K_AUTO (the JAX package's switch, read at call time): True scales K_STEPS
# with the lane count (scaled_k); scripts/paged_ksweep, its only user, sets
# False to launch exactly K_STEPS
K_AUTO = True
_TAG = float(np.float32(8388608.0))  # 2^23: bkey >= _TAG is a global winner
# the probe switches; bit i of a variant's mask is SWITCHES[i]
# (csrc/pagedkernel.cu's constants)
SWITCHES = ("cut_globals", "cut_init", "cut_fetch", "cut_quad", "cut_resolve", "cut_gsel",
            "cut_shade", "cut_tea", "cut_camera", "freeze")
ABLATE: frozenset = frozenset()  # the renderer's switches

R_O, R_D, R_FX, R_FY, R_THR = 0, 3, 6, 7, 8
R_TB, R_TE, R_TNX, R_TNZ, R_BKEY = 11, 12, 13, 14, 15
R_WCX, R_WCZ = 16, 17  # the winning grid candidate's center (x, z)
R_CUR, R_ATT = 18, 21  # running pixel sum; the carried attrs
U_SEED, U_M, U_SIDX, U_DEPTH, U_ALIVE, U_MARCH = range(6)
U_CELL, U_LANE0 = 6, 7
U_ROWS = 8

_TODO_GOVF = ("the hot/overflow slot split (govf) is not ported: it measured "
              "flat on the TPU and is not the default (ROADMAP queue 1, 'Not "
              "ported, by design')")


def n_carry(five: bool, textured: bool) -> int:
    """Carried attr rows: (mat, c0.rgb, fuzz) + center y (varying heights)
    + (tex, c1.rgb) (textured field)."""
    return (6 if five else 5) + (4 if textured else 0)


def pf_rows(nc: int) -> int:
    """f32 state rows incl. ``nc`` carried attr rows."""
    return -(-(R_ATT + nc) // 8) * 8


def scaled_k(n_lanes: int) -> int:
    """Re-bucket interval: K_STEPS per 32k lanes (the JAX package's K_AUTO
    rule; 80 at the 100k frame's 267k lanes, the best of 10/20/40/80 on the
    card).  With ``K_AUTO`` off it is K_STEPS, unscaled.  Output bits do
    not depend on it."""
    if not K_AUTO:
        return K_STEPS
    return K_STEPS * max(1, round(n_lanes / 32768))


def layout(paged):
    """(five, textured, n_slots, w, na, ab) of a PagedGridTables."""
    if paged.govf is not None:
        raise NotImplementedError(_TODO_GOVF)
    five = paged.has_cy is not None
    textured = paged.has_tex is not None
    n_slots = paged.lids.shape[1]
    w = 4 if five else 3
    na = n_carry(five, textured)
    if paged.geom.shape[1] != w * n_slots or paged.attrs.shape[1] % na:
        raise ValueError(f"geom {tuple(paged.geom.shape)} / attrs "
                         f"{tuple(paged.attrs.shape)} vs {n_slots} slots")
    return five, textured, n_slots, w, na, paged.attrs.shape[1] // na


def paged_megakernel_step(scal, vpr, paged, fstate, ustate, acc, *, m_slots,
                          n_lanes, p_total, width, max_depth, k_steps=K_STEPS,
                          skip_tmax=False, rr=None, ablate=()):
    """``k_steps`` paged-grid wavefront iterations over the state's lanes.

    ``paged``: PagedGridTables of torch tensors on the state's device (no
    ``govf``).  fstate [pf_rows(na), n] f32 (na carried attr rows), ustate
    [8, n] int32, any n; ``acc`` [p_total, 3] f32, the band's pixel sums in
    home order, updated in place.  ``ablate``: probe switches
    (``SWITCHES``).  Returns new (fstate, ustate, key): key [n] int32 is
    ``trace._rebucket_key`` of the new state.  CUDA tensors launch the
    kernel (the switch set's library); CPU tensors run
    ``paged_megakernel_step_plain``."""
    mask = switch_mask(ablate, SWITCHES, "paged")
    five, textured, n_slots, w, na, ab = layout(paged)
    rf = pf_rows(na)
    _check_state(fstate, ustate, rf, U_ROWS)
    if acc.shape != (p_total, 3) or acc.dtype != torch.float32:
        raise ValueError(f"acc {tuple(acc.shape)} {acc.dtype}, want ({p_total}, 3) float32")
    kw = dict(m_slots=m_slots, n_lanes=n_lanes, p_total=p_total, width=width,
              max_depth=max_depth, k_steps=k_steps, skip_tmax=skip_tmax, rr=rr,
              ablate=ablate)
    if fstate.device.type == "cpu":
        return paged_megakernel_step_plain(scal, vpr, paged, fstate, ustate, acc, **kw)
    if fstate.device.type != "cuda":
        raise ValueError(f"unsupported device {fstate.device}")
    from .. import _build

    g = paged
    n_pages = g.geom.shape[0]
    if g.lids.shape != (n_pages, n_slots, 128) or g.geom.shape[2] != 128 \
            or g.attrs.shape[0] != n_pages or g.attrs.shape[2] != 128:
        raise ValueError("geom / lids / attrs must be [pages, rows, 128] "
                         "over the same pages")
    if g.gtab.dim() != 2 or g.gtab.shape[1] != 16 or g.gscal.numel() < 16:
        raise ValueError("gtab must be [n, 16] and gscal hold 16 values")
    if scal.numel() < 8 or vpr.numel() < 24:
        raise ValueError("scal must hold 8 int32 and vpr 24 float32 values")
    f32, i32 = torch.float32, torch.int32
    ptrs = _cuda_args(
        dict(scal=scal, vpr=vpr, gscal=g.gscal, gtab=g.gtab, geom=g.geom,
             lids=g.lids, attrs=g.attrs, fstate=fstate, ustate=ustate, acc=acc),
        dict(scal=i32, vpr=f32, gscal=f32, gtab=f32, geom=f32, lids=f32,
             attrs=f32, fstate=f32, ustate=i32, acc=f32),
        fstate.device)
    fout = torch.empty_like(fstate)
    uout = torch.empty_like(ustate)
    n = fstate.shape[1]
    key = torch.empty(n, dtype=torch.int32, device=fstate.device)
    err = _build.library(paged=mask).rt_paged_megakernel_step(
        *ptrs, fout.data_ptr(), uout.data_ptr(), key.data_ptr(),
        g.gtab.shape[0], int(five), int(textured), n_slots, ab,
        n, rf, m_slots, n_lanes, p_total, width, max_depth, k_steps,
        int(bool(skip_tmax)), 0, *_rr_args(rr),
        fstate.device.index, torch.cuda.current_stream(fstate.device).cuda_stream)
    if err:
        raise RuntimeError(f"paged kernel launch failed: {_build.error_string(err)}")
    launches.count(paged_megakernel_step, "+".join(ablate))
    return fout, uout, key


paged_megakernel_step.launches = 0
paged_megakernel_step.variant_launches = {}  # per probe switch set


def paged_megakernel_step_plain(scal, vpr, paged, fstate, ustate, acc, *,
                                m_slots, n_lanes, p_total, width, max_depth,
                                k_steps=K_STEPS, skip_tmax=False, rr=None,
                                ablate=(), work=None):
    """The plain torch version of ``paged_megakernel_step``: the JAX
    ``_iterate`` (carry=True, no govf) vectorized over lanes, with the same
    operand order as the CUDA kernel; the page fetches are direct gathers at
    (page, row, fc), read where the JAX box loop would select them.
    ``work``: optional dict that receives the counts of
    ``megakernel.count_work``."""
    from .trace import _rebucket_key

    switch_mask(ablate, SWITCHES, "paged")

    def cut(name):
        return "cut_" + name in ablate

    launches.count(paged_megakernel_step_plain)
    five, textured, n_slots, w, na, ab = layout(paged)
    dev = fstate.device
    f = fstate.clone()
    u = ustate.clone()
    sc = [int(x) for x in scal.reshape(-1)[:8].tolist()]
    spp, number = sc[S_SPP], sc[S_NUMBER] & rngops.MASK
    y0, seed_y0, offx = sc[S_Y0], sc[S_SEEDY0], sc[S_OFFX]
    big = torch.tensor(BIG, dtype=torch.float32, device=dev)
    tmin = torch.tensor(TMIN, dtype=torch.float32, device=dev)
    fzero = torch.zeros((), dtype=torch.float32, device=dev)

    gs = paged.gscal.reshape(-1)
    fminx, fminz, fmaxx, fmaxz = gs[P_FMINX], gs[P_FMINZ], gs[P_FMAXX], gs[P_FMAXZ]
    ifmaxx, ifmaxz = int(fmaxx), int(fmaxz)
    cy_u, inv_s, cs = gs[P_CY], gs[P_INVS], gs[P_S]
    nsczm = int(gs[P_NSCZM])
    gtab = paged.gtab
    geom_rows = torch.arange(w * n_slots, device=dev)[:, None]

    ox, oy, oz, dx, dy, dz = (f[R_O + i] for i in range(6))
    fx, fy = f[R_FX], f[R_FY]
    tx_, ty_, tz_ = f[R_THR], f[R_THR + 1], f[R_THR + 2]
    t_b, t_end, t_nx, t_nz, bkey, wcx, wcz = (
        f[r] for r in (R_TB, R_TE, R_TNX, R_TNZ, R_BKEY, R_WCX, R_WCZ))
    cur = [f[R_CUR + i] for i in range(3)]
    att = [f[R_ATT + i] for i in range(na)]
    seed = rngops.to_u32(u[U_SEED])
    mrow = u[U_M].to(torch.int64)
    sidx = u[U_SIDX].to(torch.int64)
    depth = u[U_DEPTH].to(torch.int64)
    alive = u[U_ALIVE] != 0
    marching = u[U_MARCH] != 0
    cell = u[U_CELL].to(torch.int64)
    lane0 = u[U_LANE0].to(torch.int64)

    for _ in range(k_steps):
        if not bool(alive.any()):
            break  # dead lanes are a fixed point of the iteration
        a = dx * dx + dy * dy + dz * dz
        od = ox * dx + oy * dy + oz * dz
        oo = ox * ox + oy * oy + oz * oz
        inv_a = 1.0 / a

        # ---- segment start: globals + clip + fine-DDA init -----------------
        need = alive & ~marching
        if work is not None:
            count_work(work, lane_iters=alive.sum(),
                       quadratics=need.sum() * (gtab[:, 3] < 1e30).sum())
        t_b = torch.where(need, big, t_b)
        bkey = torch.where(need, _TAG, bkey)
        for k in range(0 if cut("globals") else gtab.shape[0]):
            tc = _quadratic(ox, oy, oz, dx, dy, dz, a, od, oo, inv_a,
                            gtab[k, 0], gtab[k, 1], gtab[k, 2], gtab[k, 3],
                            skip_tmax=skip_tmax, big=big)
            upd = need & (tc < t_b)
            t_b = torch.where(upd, tc, t_b)
            bkey = torch.where(upd, _TAG + gtab[k, 4], bkey)

        inv_x = 1.0 / dx
        inv_y = 1.0 / dy
        inv_z = 1.0 / dz
        if not cut("init"):  # (cut: no lane starts a march)
            t0x, t1x = _slab_inv(ox, dx, inv_x, gs[P_XLO], gs[P_XHI], big)
            t0y, t1y = _slab_inv(oy, dy, inv_y, gs[P_YLO], gs[P_YHI], big)
            t0z, t1z = _slab_inv(oz, dz, inv_z, gs[P_ZLO], gs[P_ZHI], big)
            t_start = torch.maximum(torch.maximum(t0x, t0y), torch.maximum(t0z, tmin))
            t_end_n = torch.minimum(torch.minimum(t1x, t1y), t1z)
            march0 = need & (t_start <= t_end_n) & (t_start < t_b)
            px0 = ox + t_start * dx
            pz0 = oz + t_start * dz
            icx_n = torch.minimum(torch.maximum(torch.floor((px0 - fminx) * inv_s), fzero),
                                  fmaxx)
            icz_n = torch.minimum(torch.maximum(torch.floor((pz0 - fminz) * inv_s), fzero),
                                  fmaxz)
            bx = fminx + (icx_n + torch.where(dx >= 0, 1.0, 0.0)) * cs
            bz = fminz + (icz_n + torch.where(dz >= 0, 1.0, 0.0)) * cs
            t_nx_n = torch.where(dx == 0.0, big, (bx - ox) * inv_x)
            t_nz_n = torch.where(dz == 0.0, big, (bz - oz) * inv_z)
            t_end = torch.where(need, t_end_n, t_end)
            t_nx = torch.where(march0, t_nx_n, t_nx)
            t_nz = torch.where(march0, t_nz_n, t_nz)
            cell_n = (torch.where(march0, icx_n, 0.0).to(torch.int64) << 12) \
                | torch.where(march0, icz_n, 0.0).to(torch.int64)
            cell = torch.where(march0, cell_n, cell)
            marching = marching | march0

        # ---- fine-DDA march: one cell per iteration -------------------------
        step_x = torch.where(dx >= 0, 1, -1)
        step_z = torch.where(dz >= 0, 1, -1)
        dt_x = torch.where(dx == 0.0, big, torch.abs(cs * inv_x))
        dt_z = torch.where(dz == 0.0, big, torch.abs(cs * inv_z))
        icx = cell >> 12
        icz = cell & 4095
        sxm = icx >> 3
        szm = icz >> 4
        fc = ((icx & 7) << 4) | (icz & 15)
        page = sxm * nsczm + szm
        # every lane's cell is a clipped lattice cell, so page/fc are in
        # range; lanes not marching read values nothing uses
        vals = (ox.expand(w * n_slots, -1) if cut("fetch")  # (cut: every value is ox)
                else paged.geom[page[None, :], geom_rows, fc[None, :]])  # [w*slots, n]
        pkey = (sxm * 32 + szm).to(torch.float32) * 512.0
        upd_any = torch.zeros_like(marching)
        wslot = torch.zeros_like(cell)
        if work is not None:  # the kernel loads cx, (cy,) cz, kc of each slot
            count_work(work, table_values=marching.sum() * n_slots * (4 if five else 3))
        for s in range(n_slots):
            b0 = w * s
            if work is not None:
                count_work(work, quadratics=(marching & (vals[b0 + w - 1] < 1e30)).sum())
            s_cy = vals[b0 + 1] if five else cy_u
            tc = (vals[b0] + oy if cut("quad") else
                  _quadratic(ox, oy, oz, dx, dy, dz, a, od, oo, inv_a,
                             vals[b0], s_cy, vals[b0 + w - 2], vals[b0 + w - 1],
                             skip_tmax=skip_tmax, big=big))
            upd = marching & (tc < t_b)
            t_b = torch.where(upd, tc, t_b)
            wslot = torch.where(upd, s, wslot)
            wcx = torch.where(upd, vals[b0], wcx)
            wcz = torch.where(upd, vals[b0 + w - 2], wcz)
            upd_any = upd_any | upd

        # winner improved in this cell: its lid, then its carried attrs
        if work is not None:
            count_work(work, table_values=upd_any.sum() * (1 + na))
        lid_w = ox if cut("fetch") else paged.lids[page, wslot, fc]
        bkey = torch.where(upd_any, pkey + lid_w, bkey)
        lid = torch.where(upd_any, bkey, 0.0).to(torch.int64) & 511
        # a block past the page's (a lid made of ox under cut_fetch) reads
        # block 0, as the JAX kernel's block select does
        blk = torch.where((lid >> 7) < ab, lid >> 7, 0)
        arow = blk[None, :] + ab * torch.arange(na, device=dev)[:, None]
        vnew = (bkey.expand(na, -1) if cut("resolve")  # (cut: every attr is bkey)
                else paged.attrs[page[None, :], arow, (lid & 127)[None, :]])  # [na, n]
        att = [torch.where(upd_any, vnew[i], att[i]) for i in range(na)]

        if "freeze" not in ablate:  # (freeze: the cell stays)
            t_exit = torch.minimum(t_nx, t_nz)
            cont = marching & (t_exit < t_b) & (t_exit < t_end)
            cross_x = t_nx <= t_nz
            adv_x = cont & cross_x
            adv_z = cont & ~cross_x
            icx = torch.where(adv_x, (icx + step_x).clamp(0, ifmaxx), icx)
            icz = torch.where(adv_z, (icz + step_z).clamp(0, ifmaxz), icz)
            t_nx = torch.where(adv_x, t_nx + dt_x, t_nx)
            t_nz = torch.where(adv_z, t_nz + dt_z, t_nz)
            cell = (icx << 12) | icz
            marching = cont

        seg_done = alive & ~marching
        hit = t_b < big
        if work is not None:
            count_work(work, segments=seg_done.sum())

        # ---- winner resolution: globals from gtab, grid winners carried ----
        is_direct = bkey >= _TAG
        if work is not None:  # a global winner's 12 attributes (its id scan left out)
            count_work(work, table_values=(seg_done & is_direct).sum() * 12)
        bidx_f = torch.where(is_direct, bkey - _TAG, -1.0)
        cols = (0, 1, 2, 5, 6, 7, 8, 9, 10, 11, 12, 13)
        gsel = [gtab[0, c].expand_as(t_b) for c in cols]
        for k in range(1, 1 if cut("gsel") else gtab.shape[0]):  # (cut: row 0)
            sel = bidx_f == gtab[k, 4]
            gsel = [torch.where(sel, gtab[k, c], g_) for c, g_ in zip(cols, gsel)]
        (gcx, gcy, gcz, gmat, gtex, gc0x, gc0y, gc0z,
         gc1x, gc1y, gc1z, gattr) = gsel
        zero = torch.zeros_like(t_b)
        ft = att[na - 4 : na] if textured else [zero] * 4
        cenx = torch.where(is_direct, gcx, wcx)
        ceny = torch.where(is_direct, gcy, att[5] if five else cy_u)
        cenz = torch.where(is_direct, gcz, wcz)
        tex = torch.where(is_direct, gtex, ft[0])
        c1x = torch.where(is_direct, gc1x, ft[1])
        c1y = torch.where(is_direct, gc1y, ft[2])
        c1z = torch.where(is_direct, gc1z, ft[3])
        mat = torch.where(is_direct, gmat, att[0])
        c0x = torch.where(is_direct, gc0x, att[1])
        c0y = torch.where(is_direct, gc0y, att[2])
        c0z = torch.where(is_direct, gc0z, att[3])
        fuzz = torch.where(is_direct, gattr, att[4])

        if cut("shade"):  # the ray passes through: point o, albedo and scatter d
            (px_, py_, pz_, ax, ay, az, sdx, sdy, sdz, does_scatter, seed_h) = (
                ox, oy, oz, dx, dy, dz, dx, dy, dz, t_b < big, seed)
        else:
            (px_, py_, pz_, ax, ay, az, sdx, sdy, sdz, does_scatter,
             seed_h) = shade_rows(ox, oy, oz, dx, dy, dz, t_b, seed,
                                  cenx, ceny, cenz, mat, tex, c0x, c0y, c0z,
                                  c1x, c1y, c1z, fuzz)

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
        cur = [cv + torch.where(term, tc * lc, 0.0)
               for cv, tc, lc in zip(cur, (tx_, ty_, tz_), light)]

        seed_a = torch.where(seg_done & hit, seed_h, seed)
        if rr is not None:
            seed_a = torch.where(considered, seed_rr, seed_a)

        # ---- flush the finished pixel's sum into its accumulator slot -----
        more = term & (sidx < spp)
        pix_done = term & ~more
        pix = mrow * n_lanes + lane0
        flush = pix_done & (mrow >= 0) & (mrow < m_slots) & (pix < p_total)
        if work is not None:
            count_work(work, flushes=flush.sum())
        if bool(flush.any()):  # one lane per pixel: the indices are distinct
            idx = pix[flush]
            acc[idx] = acc[idx] + torch.stack(cur, dim=1)[flush]
        cur = [torch.where(pix_done, 0.0, cv) for cv in cur]

        # ---- regen, addressed by lane0 (lanes get re-bucketed) -------------
        m2 = mrow + pix_done.to(torch.int64)
        pix2 = m2 * n_lanes + lane0
        adv = pix_done & (m2 < m_slots) & (pix2 < p_total)
        px2 = pix2 % width
        py2 = pix2 // width
        fx2 = (offx + px2).to(torch.float32)
        fy2 = (y0 + py2).to(torch.float32)
        fresh = seed if cut("tea") else rngops.tea_hash(  # (cut: the lane's seed)
            rngops.tea_hash(px2, seed_y0 + py2), torch.full_like(px2, number))
        regen = more | adv
        seed_c = torch.where(adv, fresh, seed_a)
        fxn = torch.where(adv, fx2, fx)
        fyn = torch.where(adv, fy2, fy)
        if cut("camera"):  # the lane keeps its ray
            seed_r, (cox, coy, coz), (cdx, cdy, cdz) = seed_c, (ox, oy, oz), (dx, dy, dz)
        else:
            seed_r, (cox, coy, coz), (cdx, cdy, cdz) = camera_rays_rows(
                seed_c, fxn, fyn, vpr)
        bx_, by_, bz_ = norm3(sdx, sdy, sdz)

        ox = torch.where(cont_b, px_, torch.where(regen, cox, ox))
        oy = torch.where(cont_b, py_, torch.where(regen, coy, oy))
        oz = torch.where(cont_b, pz_, torch.where(regen, coz, oz))
        dx = torch.where(cont_b, bx_, torch.where(regen, cdx, dx))
        dy = torch.where(cont_b, by_, torch.where(regen, cdy, dy))
        dz = torch.where(cont_b, bz_, torch.where(regen, cdz, dz))
        fx, fy = fxn, fyn
        tx_ = torch.where(cont_b, ntx, torch.where(regen, 1.0, tx_))
        ty_ = torch.where(cont_b, nty, torch.where(regen, 1.0, ty_))
        tz_ = torch.where(cont_b, ntz, torch.where(regen, 1.0, tz_))
        seed = torch.where(seg_done, torch.where(regen, seed_r, seed_a), seed)
        mrow = m2
        sidx = torch.where(adv, 1, sidx + more.to(torch.int64))
        depth = torch.where(cont_b, depth + 1, torch.where(regen, 0, depth))
        alive = marching | (seg_done & (cont_b | regen))

    for r, v in zip(range(R_ATT), (ox, oy, oz, dx, dy, dz, fx, fy, tx_, ty_,
                                   tz_, t_b, t_end, t_nx, t_nz, bkey, wcx, wcz,
                                   *cur)):
        f[r] = v
    for i in range(na):
        f[R_ATT + i] = att[i]
    u[U_SEED] = rngops.to_i32(seed)
    for r, v in ((U_M, mrow), (U_SIDX, sidx), (U_DEPTH, depth), (U_ALIVE, alive),
                 (U_MARCH, marching), (U_CELL, cell)):
        u[r] = v.to(torch.int32)
    return f, u, _rebucket_key(f, u, paged.gscal)


paged_megakernel_step_plain.launches = 0
