"""Grid-DDA wavefront megakernel: the acceleration-structure backend.

Port of ``raytrace_tpu/ops/gridkernel.py`` (``grid_megakernel_step``), the
renderer's main path for the book scene.  Per wavefront iteration each live
lane is in one of two modes:

  need_start (fresh segment): brute-force the <= 32 "global" spheres (ground,
      heroes, boundary-line spills), clip the ray against the grid's slab box
      and initialise a 2-D Amanatides-Woo DDA over the (x, z) cell lattice;
  marching: ``j_steps`` DDA cells — each cell's candidates (4-value slots
      with a shared cy, or <= 8 five-value slots) get the exact brute-force
      quadratic, and the march ends when the next cell cannot beat the best
      hit or the ray leaves the grid.

Lanes whose march completed resolve the winner by sphere id (one ``atab``
fetch, plus ``ttab`` or the textured-globals ``gttab`` chain), shade
(``shading_rows``), terminate or continue, flush the running pixel sum ``cur``
into the acc slot when a pixel's samples are done, and regenerate.  Results
are identical to the brute-force megakernel: the same packed (cx, cz, kc)
values, the same quadratic op order, strict-< updates over index-sorted
candidates in ray-ordered cells (models/grid.py exactness contract).

The tables keep the JAX package's block-major layout; a cell fetch reads row
``(c >> 7) * stride + v``, lane ``c & 127`` directly by index.

Not in this port yet: the JAX kernel's in-kernel call merge and its hoisted
fresh-seed rows (u32 rows 8-11: U_CALL, U_FNC, U_FNP, U_PEND) and the
balanced ``passign`` table.  The fresh TEA seed of a lane moving to its next
pixel is computed inline (the same hash of the same operands), so
``U_ROWS = 8`` and rows 0-7 match the JAX state row for row.

``grid_megakernel_step`` launches the hand-written CUDA kernel
(``csrc/gridkernel.cu``) for CUDA state and the plain torch version
``grid_megakernel_step_plain`` for CPU state; each counts its launches in its
``launches`` attribute.

State layout (rows of [rows, lanes] tensors; M = pixels_per_lane):
  f32:  0-2 o | 3-5 d | 6 fx | 7 fy | 8-10 thr | 11 t_best | 12 t_end
        | 13 t_nx | 14 t_nz | 15 bkey | 16-17 unused | 18-20 cur.rgb
        | 21+3m+c acc[m].rgb
  int32 (u32 bits): 0 seed | 1 m | 2 sidx | 3 depth | 4 alive | 5 marching
        | 6 icx | 7 icz
bkey is the winner: the sphere id for grid hits, 4096 + id for global hits.
"""

from __future__ import annotations

import torch

from ..models.grid import (G_CMAXX, G_CMAXZ, G_CMINX, G_CMINZ, G_CY, G_INVS,
                           G_NCZ, G_S, G_XHI, G_XLO, G_YHI, G_YLO, G_ZHI,
                           G_ZLO, N_SLOTS)
from . import fp
from . import rng as rngops
from .intersect import BIG
from .megakernel import (S_NUMBER, S_OFFX, S_SEEDY0, S_SPP, S_Y0, SKY, TMAX,
                         TMIN, _check_state, _cuda_args, _rr_args,
                         camera_rays_rows, count_work, rr_probability)
from .shading_rows import norm3, shade_rows

K_STEPS = 40  # wavefront iterations per launch
J_STEPS = 2  # DDA cells per wavefront iteration

R_O, R_D, R_FX, R_FY, R_THR = 0, 3, 6, 7, 8
R_TB, R_TE, R_TNX, R_TNZ, R_BKEY = 11, 12, 13, 14, 15
R_CUR, R_ACC = 18, 21
U_SEED, U_M, U_SIDX, U_DEPTH, U_ALIVE, U_MARCH, U_ICX, U_ICZ = range(8)
U_ROWS = 8

TAG = 4096.0  # bkey values >= TAG are global-table winners (TAG + id)


def f_rows(m_slots: int) -> int:
    r = R_ACC + 3 * m_slots
    return -(-r // 8) * 8


def layout(grid):
    """(five, n_slots, stride) of a GridTables' ctab."""
    five = grid.has_cy is not None
    n_slots = (grid.has_cy.shape[1] if five else
               grid.slots4.shape[1] if grid.slots4 is not None else N_SLOTS)
    w = 5 if five else 4
    return five, n_slots, -(-w * n_slots // 8) * 8


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


def grid_megakernel_step(scal, vpr, grid, fstate, ustate, *, m_slots, n_lanes,
                         p_total, width, max_depth, k_steps=K_STEPS,
                         j_steps=J_STEPS, skip_tmax=False, rr=None):
    """``k_steps`` grid-traced wavefront iterations over all lanes.

    ``grid``: GridTables of torch tensors on the state's device.  fstate
    [f_rows(M), n] f32, ustate [8, n] int32.  Returns new (fstate, ustate).
    CUDA tensors launch the kernel; CPU tensors run
    ``grid_megakernel_step_plain``."""
    rf = f_rows(m_slots)
    _check_state(fstate, ustate, rf, U_ROWS)
    kw = dict(m_slots=m_slots, n_lanes=n_lanes, p_total=p_total, width=width,
              max_depth=max_depth, k_steps=k_steps, j_steps=j_steps,
              skip_tmax=skip_tmax, rr=rr)
    if fstate.device.type == "cpu":
        return grid_megakernel_step_plain(scal, vpr, grid, fstate, ustate, **kw)
    if fstate.device.type != "cuda":
        raise ValueError(f"unsupported device {fstate.device}")
    from .. import _build

    five, n_slots, stride = layout(grid)
    g = grid
    if g.ctab.shape[1] != 128 or g.ctab.shape[0] % stride:
        raise ValueError(f"ctab shape {tuple(g.ctab.shape)} vs stride {stride}")
    if g.atab.shape[1] != 128 or g.atab.shape[0] % 8:
        raise ValueError(f"atab shape {tuple(g.atab.shape)}")
    if g.gtab.shape[1] != 16 or g.gttab.shape[1] != 16 or g.gscal.numel() < 16:
        raise ValueError("gtab/gttab must be [n, 16] and gscal hold 16 values")
    if g.ttab is not None and g.ttab.shape != g.atab.shape:
        raise ValueError("ttab must match atab's shape")
    f32, i32 = torch.float32, torch.int32
    tensors = dict(scal=scal, vpr=vpr, gscal=g.gscal, gtab=g.gtab,
                   gttab=g.gttab, ctab=g.ctab, atab=g.atab)
    dtypes = dict(scal=i32, vpr=f32, gscal=f32, gtab=f32, gttab=f32,
                  ctab=f32, atab=f32, ttab=f32, fstate=f32, ustate=i32)
    if g.ttab is not None:
        tensors["ttab"] = g.ttab
    tensors.update(fstate=fstate, ustate=ustate)
    ptrs = _cuda_args(tensors, dtypes, fstate.device)
    if g.ttab is None:
        ptrs.insert(7, None)
    fout = torch.empty_like(fstate)
    uout = torch.empty_like(ustate)
    n_pad = fstate.shape[1]
    err = _build.library().rt_grid_megakernel_step(
        *ptrs, fout.data_ptr(), uout.data_ptr(),
        g.gtab.shape[0], g.gttab.shape[0], int(five), n_slots, stride,
        n_pad, rf, m_slots, n_lanes, p_total, width, max_depth, k_steps,
        j_steps, int(bool(skip_tmax)), *_rr_args(rr),
        fstate.device.index, torch.cuda.current_stream(fstate.device).cuda_stream)
    if err:
        raise RuntimeError(f"grid kernel launch failed: {_build.error_string(err)}")
    grid_megakernel_step.launches += 1
    return fout, uout


grid_megakernel_step.launches = 0


def grid_megakernel_step_plain(scal, vpr, grid, fstate, ustate, *, m_slots,
                               n_lanes, p_total, width, max_depth,
                               k_steps=K_STEPS, j_steps=J_STEPS,
                               skip_tmax=False, rr=None, work=None):
    """The plain torch version of ``grid_megakernel_step``: the JAX
    ``_iterate`` (n_calls = 1, no passign) vectorized over lanes, with the
    same operand order as the CUDA kernel.  ``work``: optional dict that
    receives the counts of ``megakernel.count_work``."""
    grid_megakernel_step_plain.launches += 1
    dev = fstate.device
    f = fstate.clone()
    u = ustate.clone()
    n_pad = f.shape[1]
    lane = torch.arange(n_pad, dtype=torch.int64, device=dev)
    sc = [int(x) for x in scal.reshape(-1)[:8].tolist()]
    spp, number = sc[S_SPP], sc[S_NUMBER] & rngops.MASK
    y0, seed_y0, offx = sc[S_Y0], sc[S_SEEDY0], sc[S_OFFX]
    big = torch.tensor(BIG, dtype=torch.float32, device=dev)

    five, n_slots, stride = layout(grid)
    w = 5 if five else 4
    gs = grid.gscal.reshape(-1)
    cminx, cminz, cmaxx, cmaxz = gs[G_CMINX], gs[G_CMINZ], gs[G_CMAXX], gs[G_CMAXZ]
    icminx, icminz = int(cminx), int(cminz)
    icmaxx, icmaxz = int(cmaxx), int(cmaxz)
    ncz, cy_u, s_, inv_s = gs[G_NCZ], gs[G_CY], gs[G_S], gs[G_INVS]
    n_cells_pad = grid.ctab.shape[0] // stride * 128
    gtab = grid.gtab
    gttab = grid.gttab

    def fetch(tab, idx, n_vals, row_stride):
        """[n_vals, n] values of entries ``idx`` from a block-major table."""
        rows = (idx >> 7)[None, :] * row_stride + torch.arange(
            n_vals, device=dev)[:, None]
        return tab[rows, (idx & 127)[None, :].expand(n_vals, -1)]

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

    for _ in range(k_steps):
        if not bool(alive.any()):
            break  # dead lanes are a fixed point of the iteration
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
        for k in range(gtab.shape[0]):
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

        # ---- DDA march: j_steps cells --------------------------------------
        step_x = torch.where(dx >= 0, 1, -1)
        step_z = torch.where(dz >= 0, 1, -1)
        dt_x = torch.where(dx == 0.0, big, torch.abs(inv_x) * s_)
        dt_z = torch.where(dz == 0.0, big, torch.abs(inv_z) * s_)
        for _j in range(j_steps):
            cid = ((icx.to(torch.float32) - cminx) * ncz
                   + (icz.to(torch.float32) - cminz)).to(torch.int64)
            # non-marching lanes may hold a stale cell: clamp the fetch index
            # (their values are masked by ``marching`` below)
            vals = fetch(grid.ctab, cid.clamp(0, n_cells_pad - 1), w * n_slots, stride)
            for s in range(n_slots):
                b0 = w * s
                if work is not None:
                    count_work(work, quadratics=(marching & (vals[b0 + w - 2] < 1e30)).sum())
                s_cy = vals[b0 + 1] if five else cy_u
                tc = _quadratic(ox, oy, oz, dx, dy, dz, a, od, oo, inv_a,
                                vals[b0], s_cy, vals[b0 + w - 3],
                                vals[b0 + w - 2], skip_tmax=skip_tmax, big=big)
                upd = marching & (tc < t_b)
                t_b = torch.where(upd, tc, t_b)
                bkey = torch.where(upd, vals[b0 + w - 1], bkey)
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
        if work is not None:
            count_work(work, segments=seg_done.sum())

        # ---- winner resolution: bkey (sphere id) -> attrs -------------------
        is_direct = bkey >= TAG
        bidx = torch.where(is_direct, bkey - TAG, bkey).to(torch.int64)
        at = fetch(grid.atab, bidx, 8, 8)  # mat, c0.rgb, attr, center.xyz
        if grid.ttab is not None:
            tex, c1x, c1y, c1z = fetch(grid.ttab, bidx, 4, 8)
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

        (px_, py_, pz_, ax, ay, az, sdx, sdy, sdz, does_scatter,
         seed_h) = shade_rows(ox, oy, oz, dx, dy, dz, t_b, seed,
                              at[5], at[6], at[7], at[0], tex, at[1], at[2],
                              at[3], c1x, c1y, c1z, at[4])

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

        # ---- flush the finished pixel's sum into its acc slot --------------
        more = term & (sidx < spp)
        pix_done = term & ~more
        if bool(pix_done.any()):
            for m in range(m_slots):
                sel = pix_done & (mrow == m)
                for ch in range(3):
                    r = R_ACC + 3 * m + ch
                    f[r] = f[r] + torch.where(sel, cur[ch], 0.0)
        cur = [torch.where(pix_done, 0.0, cv) for cv in cur]

        # ---- regen: next sample or next pixel ------------------------------
        m2 = mrow + pix_done.to(torch.int64)
        pix2 = m2 * n_lanes + lane
        adv = pix_done & (m2 < m_slots) & (pix2 < p_total)
        px2 = pix2 % width
        py2 = pix2 // width
        fx2 = (offx + px2).to(torch.float32)
        fy2 = (y0 + py2).to(torch.float32)
        fresh = rngops.tea_hash(rngops.tea_hash(px2, seed_y0 + py2),
                                torch.full_like(px2, number))
        regen = more | adv
        seed_c = torch.where(adv, fresh, seed_a)
        fxn = torch.where(adv, fx2, fx)
        fyn = torch.where(adv, fy2, fy)
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
        sidx = torch.where(adv, 1, sidx + more.to(torch.int64))
        depth = torch.where(cont_b, depth + 1, torch.where(regen, 0, depth))
        alive = marching | (seg_done & (cont_b | regen))

    for r, v in zip(range(R_CUR), (ox, oy, oz, dx, dy, dz, fx, fy, tx_, ty_,
                                   tz_, t_b, t_end, t_nx, t_nz, bkey)):
        f[r] = v
    for i in range(3):
        f[R_CUR + i] = cur[i]
    u[U_SEED] = rngops.to_i32(seed)
    for r, v in ((U_M, mrow), (U_SIDX, sidx), (U_DEPTH, depth), (U_ALIVE, alive),
                 (U_MARCH, marching), (U_ICX, icx), (U_ICZ, icz)):
        u[r] = v.to(torch.int32)
    return f, u


grid_megakernel_step_plain.launches = 0
