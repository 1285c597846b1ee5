"""Brute-force wavefront megakernel: ``k_steps`` iterations per launch.

Port of ``raytrace_tpu/ops/megakernel.py`` (``megakernel_step``).  One launch
runs ``k_steps`` wavefront iterations for every lane: closest hit over the
valid rows of the packed sphere table (lowest index wins ties), the winner's
attributes, shader.rchit shading with speculative RNG draws, termination into
the lane's M accumulator slots, and regeneration with a TEA reseed and a new
camera ray.  It is the grid kernel's exactness anchor and the backend for
scenes the grid cannot hold.

``megakernel_step`` launches the hand-written CUDA kernel
(``csrc/megakernel.cu``) for a CUDA state tensor and the plain torch version
``megakernel_step_plain`` for a CPU tensor; each counts its launches in its
``launches`` attribute.

State layout (rows of [rows, lanes] tensors; M = pixels_per_lane):
  f32:  0-2 o | 3-5 d | 6 fx | 7 fy | 8-10 thr | 11 pad | 12+3m+c acc[m].rgb
  int32 (u32 bits): 0 seed | 1 m | 2 sidx | 3 depth | 4 alive | 5-7 pad
"""

from __future__ import annotations

import numpy as np
import torch

from .. import config
from . import fp
from . import launches
from . import rng as rngops
from .intersect import BIG
from .shading_rows import norm3, shade_rows

K_STEPS = 40  # wavefront iterations per launch (the best of 10/20/40 on the card)

# f32 state rows
R_O, R_D, R_FX, R_FY, R_THR, R_ACC = 0, 3, 6, 7, 8, 12
# u32 state rows
U_SEED, U_M, U_SIDX, U_DEPTH, U_ALIVE = 0, 1, 2, 3, 4
U_ROWS = 8

# scalar slots of the (1, 8) int32 ``scal`` tensor.  NCALLS/SPPLAST belong
# to the JAX grid kernel's in-kernel call merge; the port ignores them.
S_SPP, S_NUMBER, S_Y0, S_SEEDY0, S_OFFX, S_NCALLS, S_SPPLAST = range(7)

# viewport slots of the (1, 24) f32 ``vpr`` tensor
V_H, V_V, V_UL, V_UP, V_RIGHT, V_FROM, V_AP, V_W, V_HGT = 0, 3, 6, 9, 12, 15, 18, 19, 20

SKY = (0.7, 0.8, 1.0)  # shader.rmiss:15
TMIN = float(np.float32(config.T_MIN))
TMAX = float(np.float32(config.MAX_RAY_COLLISION_DISTANCE))


def f_rows(m_slots: int) -> int:
    r = R_ACC + 3 * m_slots
    return -(-r // 8) * 8


def camera_rays_rows(seed, fx, fy, vpr):
    """getCameraRay + uv jitter (shader.rgen:57,107-115) on lane rows, in
    the kernels' op order (megakernel._camera_rays_rows)."""
    v = vpr[0]
    seed, jx = rngops.random_float(seed)
    seed, jy = rngops.random_float(seed)
    u = (fx + jx) / v[V_W]
    w = (fy + jy) / v[V_HGT]
    seed, r1 = rngops.random_in_interval(seed, -1.0, 1.0)
    seed, r2 = rngops.random_in_interval(seed, -1.0, 1.0)
    inv_l = 1.0 / fp.sqrt(r1 * r1 + r2 * r2)
    ap = v[V_AP] * 0.5
    rx = ap * (r1 * inv_l)
    ry = ap * (r2 * inv_l)
    o = [v[V_FROM + i] + v[V_RIGHT + i] * rx + v[V_UP + i] * ry for i in range(3)]
    t = [v[V_UL + i] + v[V_H + i] * u - v[V_V + i] * w for i in range(3)]
    d = norm3(t[0] - o[0], t[1] - o[1], t[2] - o[2])
    return seed, o, d


def rr_probability(ntx, nty, ntz, dnext, rr):
    """Fast-mode survival probability p = clamp(max thr, pmin, 1), halved
    past depth d1 (same NaN-propagating max/min as jnp.maximum/minimum)."""
    _, d1, pmin = rr
    p = torch.clamp(torch.maximum(ntx, torch.maximum(nty, ntz)),
                    min=float(np.float32(pmin)))
    p = torch.clamp(p, max=1.0)
    if d1:
        p = torch.where(dnext >= d1, p * 0.5, p)
    return p


def _check_state(fstate, ustate, rf, u_rows):
    if fstate.dtype != torch.float32 or ustate.dtype != torch.int32:
        raise TypeError("state must be float32 / int32 tensors")
    if fstate.dim() != 2 or fstate.shape[0] != rf:
        raise ValueError(f"fstate shape {tuple(fstate.shape)}, want ({rf}, n)")
    if ustate.shape != (u_rows, fstate.shape[1]):
        raise ValueError(f"ustate shape {tuple(ustate.shape)}, "
                         f"want ({u_rows}, {fstate.shape[1]})")
    if fstate.device != ustate.device:
        raise ValueError("fstate and ustate must be on one device")


def _cuda_args(tensors, dtypes, device):
    """Validate kernel inputs (device, dtype, contiguity) -> pointer ints."""
    ptrs = []
    for name, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, state on {device}")
        if t.dtype != dtypes[name]:
            raise TypeError(f"{name} must be {dtypes[name]}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        ptrs.append(t.data_ptr())
    return ptrs


def _rr_args(rr):
    if rr is None:
        return 0, 0, 0, 0.0
    d0, d1, pmin = rr
    return 1, int(d0), int(d1), float(np.float32(pmin))


def megakernel_step(scal, vpr, table, atab, fstate, ustate, *, m_slots,
                    n_lanes, p_total, width, max_depth, k_steps=K_STEPS,
                    skip_tmax=False, rr=None, n_valid=None):
    """``k_steps`` brute-force wavefront iterations over all lanes.

    table [S, 24] f32 (ops/intersect.sphere_table), atab [16, S] f32 (its
    columns 8..23 transposed); fstate [f_rows(M), n] f32, ustate [8, n]
    int32.  ``n_valid``: the scene's sphere count, the table's valid prefix
    (None: all S rows); the rows after it are padding that cannot win, so
    scanning only the prefix changes no bit.  Returns new (fstate, ustate).
    CUDA tensors launch the kernel; CPU tensors run
    ``megakernel_step_plain``."""
    rf = f_rows(m_slots)
    _check_state(fstate, ustate, rf, U_ROWS)
    s_rows = table.shape[0]
    n_valid = s_rows if n_valid is None else int(n_valid)
    if not 0 <= n_valid <= s_rows:
        raise ValueError(f"n_valid {n_valid} outside the table's {s_rows} rows")
    kw = dict(m_slots=m_slots, n_lanes=n_lanes, p_total=p_total, width=width,
              max_depth=max_depth, k_steps=k_steps, skip_tmax=skip_tmax, rr=rr,
              n_valid=n_valid)
    if fstate.device.type == "cpu":
        return megakernel_step_plain(scal, vpr, table, atab, fstate, ustate, **kw)
    if fstate.device.type != "cuda":
        raise ValueError(f"unsupported device {fstate.device}")
    from .. import _build

    f32, i32 = torch.float32, torch.int32
    ptrs = _cuda_args(
        dict(scal=scal, vpr=vpr, table=table, atab=atab, fstate=fstate, ustate=ustate),
        dict(scal=i32, vpr=f32, table=f32, atab=f32, fstate=f32, ustate=i32),
        fstate.device)
    if table.shape != (s_rows, 24) or atab.shape != (16, s_rows):
        raise ValueError(f"table {tuple(table.shape)} / atab {tuple(atab.shape)}")
    if table.data_ptr() % 16:
        raise ValueError("table must be 16-byte aligned (rows are read as float4)")
    if scal.numel() < 8 or vpr.numel() < 24:
        raise ValueError("scal must hold 8 int32 and vpr 24 float32 values")
    fout = torch.empty_like(fstate)
    uout = torch.empty_like(ustate)
    n_pad = fstate.shape[1]
    err = _build.library().rt_megakernel_step(
        *ptrs, fout.data_ptr(), uout.data_ptr(),
        s_rows, n_valid, n_pad, rf, m_slots, n_lanes, p_total, width, max_depth,
        k_steps, int(bool(skip_tmax)), *_rr_args(rr),
        fstate.device.index, torch.cuda.current_stream(fstate.device).cuda_stream)
    if err:
        raise RuntimeError(f"megakernel launch failed: {_build.error_string(err)}")
    launches.count(megakernel_step)
    return fout, uout


megakernel_step.launches = 0


def count_work(work, **counts):
    """Add this iteration's counts to a plain version's ``work`` dict:
    ``lane_iters`` (live lanes), ``quadratics`` (ray-sphere tests the data
    needs: valid table rows, occupied cell slots, real globals) and
    ``segments`` (ray segments that ended).  chip_smoke.py derives a step's
    least time on the card from them."""
    for k, v in counts.items():
        work[k] = work.get(k, 0) + int(v)


def megakernel_step_plain(scal, vpr, table, atab, fstate, ustate, *, m_slots,
                          n_lanes, p_total, width, max_depth, k_steps=K_STEPS,
                          skip_tmax=False, rr=None, n_valid=None, work=None):
    """The plain torch version of ``megakernel_step``: the JAX ``_iterate``
    vectorized over lanes, with the same operand order as the CUDA kernel,
    over the first ``n_valid`` table rows (None: all).  ``work``: optional
    dict that receives the counts of ``count_work``."""
    launches.count(megakernel_step_plain)
    if n_valid is not None:
        rows = max(n_valid, 1)  # row 0 of an empty scene is padding: a miss
        table, atab = table[:rows], atab[:, :rows]
    dev = fstate.device
    f = fstate.clone()
    u = ustate.clone()
    n_pad = f.shape[1]
    lane = torch.arange(n_pad, dtype=torch.int64, device=dev)
    sc = [int(x) for x in scal.reshape(-1)[:8].tolist()]
    spp, number = sc[S_SPP], sc[S_NUMBER] & rngops.MASK
    y0, seed_y0, offx = sc[S_Y0], sc[S_SEEDY0], sc[S_OFFX]
    big = torch.tensor(BIG, dtype=torch.float32, device=dev)

    ox, oy, oz, dx, dy, dz = (f[R_O + i] for i in range(6))
    fx, fy = f[R_FX], f[R_FY]
    tx_, ty_, tz_ = f[R_THR], f[R_THR + 1], f[R_THR + 2]
    acc = [f[R_ACC + i] for i in range(3 * m_slots)]
    seed = rngops.to_u32(u[U_SEED])
    mrow = u[U_M].to(torch.int64)
    sidx = u[U_SIDX].to(torch.int64)
    depth = u[U_DEPTH].to(torch.int64)
    alive = u[U_ALIVE] != 0

    kc = table[:, 3:4]
    cx, cy, cz = table[:, 0:1], table[:, 1:2], table[:, 2:3]

    for _ in range(k_steps):
        if not bool(alive.any()):
            break  # dead lanes are a fixed point of the iteration
        if work is not None:
            n_alive = alive.sum()
            count_work(work, lane_iters=n_alive, segments=n_alive,
                       quadratics=n_alive * (table[:, 4] > 0).sum())
        # ---- intersect: shader.rint:44-60 over all spheres ----------------
        a = dx * dx + dy * dy + dz * dz
        od = ox * dx + oy * dy + oz * dz
        oo = ox * ox + oy * oy + oz * oz
        inv_a = 1.0 / a
        cd = cx * dx + cy * dy + cz * dz  # [S, n]
        co = cx * ox + cy * oy + cz * oz
        b = od - cd
        c = oo - 2.0 * co + kc
        disc = b * b - a * c
        sq = fp.sqrt(disc)  # NaN on miss: every comparison below is False
        t1 = (-b - sq) * inv_a
        t2 = (-b + sq) * inv_a
        if skip_tmax:
            t1_ok, t2_ok = t1 >= TMIN, t2 >= TMIN
        else:
            t1_ok = (t1 >= TMIN) & (t1 <= TMAX)
            t2_ok = (t2 >= TMIN) & (t2 <= TMAX)
        tall = torch.where(t1_ok, t1, torch.where(t2_ok, t2, big))
        t = torch.amin(tall, dim=0)
        idx = torch.argmin(tall, dim=0)  # lowest index wins ties
        hit = t < big
        at = atab[:, idx]  # [16, n]: center, mat, tex, c0, c1, fuzz

        (px_, py_, pz_, ax, ay, az, sdx, sdy, sdz, does_scatter,
         seed_h) = shade_rows(ox, oy, oz, dx, dy, dz, t, seed,
                              at[0], at[1], at[2], at[3], at[4],
                              at[5], at[6], at[7], at[8], at[9], at[10], at[11])

        # ---- termination & accumulation (shader.rgen:70-89) --------------
        scatters = hit & does_scatter
        deep = (depth + 1) >= max_depth
        cont = alive & scatters & ~deep
        ntx, nty, ntz = tx_ * ax, ty_ * ay, tz_ * az
        if rr is not None:
            dnext = depth + 1
            p = rr_probability(ntx, nty, ntz, dnext, rr)
            considered = cont & (dnext >= rr[0])
            seed_rr, u_rr = rngops.random_float(torch.where(hit, seed_h, seed))
            cont = cont & ~(considered & (u_rr >= p))
            ntx = torch.where(considered, ntx / p, ntx)
            nty = torch.where(considered, nty / p, nty)
            ntz = torch.where(considered, ntz / p, ntz)
        term = alive & ~cont
        light = [torch.where(hit, torch.where(does_scatter, 0.0, al), sky)
                 for al, sky in zip((ax, ay, az), SKY)]
        cb = [torch.where(term, tc * lc, 0.0)
              for tc, lc in zip((tx_, ty_, tz_), light)]
        for m in range(m_slots):
            sel = term & (mrow == m)
            for ch in range(3):
                acc[3 * m + ch] = acc[3 * m + ch] + torch.where(sel, cb[ch], 0.0)

        seed_a = torch.where(hit, seed_h, seed)
        if rr is not None:
            seed_a = torch.where(considered, seed_rr, seed_a)

        # ---- regen: next sample or next pixel ----------------------------
        more = term & (sidx < spp)
        pix_done = term & ~more
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
        bx, by, bz = norm3(sdx, sdy, sdz)  # normalized bounce (rgen:78)

        ox = torch.where(cont, px_, torch.where(regen, cox, ox))
        oy = torch.where(cont, py_, torch.where(regen, coy, oy))
        oz = torch.where(cont, pz_, torch.where(regen, coz, oz))
        dx = torch.where(cont, bx, torch.where(regen, cdx, dx))
        dy = torch.where(cont, by, torch.where(regen, cdy, dy))
        dz = torch.where(cont, bz, torch.where(regen, cdz, dz))
        fx, fy = fxn, fyn
        tx_ = torch.where(cont, ntx, torch.where(regen, 1.0, tx_))
        ty_ = torch.where(cont, nty, torch.where(regen, 1.0, ty_))
        tz_ = torch.where(cont, ntz, torch.where(regen, 1.0, tz_))
        seed = torch.where(alive, torch.where(regen, seed_r, seed_a), seed)
        mrow = m2
        sidx = torch.where(adv, 1, sidx + more.to(torch.int64))
        depth = torch.where(cont, depth + 1, torch.where(regen, 0, depth))
        alive = alive & (cont | regen)

    for i, v in enumerate((ox, oy, oz, dx, dy, dz, fx, fy, tx_, ty_, tz_)):
        f[i] = v
    for i in range(3 * m_slots):
        f[R_ACC + i] = acc[i]
    u[U_SEED] = rngops.to_i32(seed)
    u[U_M] = mrow.to(torch.int32)
    u[U_SIDX] = sidx.to(torch.int32)
    u[U_DEPTH] = depth.to(torch.int32)
    u[U_ALIVE] = alive.to(torch.int32)
    return f, u


megakernel_step_plain.launches = 0
