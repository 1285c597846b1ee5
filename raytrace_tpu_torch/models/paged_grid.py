"""Paged two-level grid: the acceleration structure for dense scenes.

Fine cells of size ``s`` are grouped into pages of 8x16 fine cells (128
cells, one table row of 128 columns per value).  Per page, ``geom`` holds the
candidate slots' (cx[, cy], cz, kc) values, ``lids`` each slot's page-local
sphere id, and ``attrs`` the shading attributes of the page's local sphere
list, so a winner is resolved by (page, lid) and nothing indexes the global
100k-sphere table per lane.  Global (large) spheres go to a small
brute-forced table exactly as in the flat grid (models/grid.py).

The pages were shaped by the TPU's 128-entry lane gather; the CUDA kernel
(csrc/pagedkernel.cu) keeps them because they cost nothing on a GPU: a thread
loads ``geom[page, row, fc]`` by index, as the grid kernel reads its
block-major cell table in place, and the tables stay byte-equal to the JAX
package's (the weight import and the row-by-row step parity rest on that).

Port copy of ``raytrace_tpu/models/paged_grid.py``, byte-for-byte in
behaviour (numpy only): the port never imports the JAX package, whose
``__init__`` imports jax.  ``hot_slots`` is kept so the builder stays
byte-equal; the kernels refuse the split tables it makes (``govf``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np

from .grid import DELTA, MAX_GLOBALS, POISON

PAGE_LANES = 128
F_AXIS = 8  # fine cells per page along x
F_AXIS_Z = 16  # fine cells per page along z
# Host-side knob on the auto cell size (applied only when the caller passes
# no cell_size): smaller cells -> fewer slots, more march steps.
CELL_SIZE_SCALE = 1.0
# Hot/overflow slot split (PagedGridTables.govf): hot_slots=-1 picks the
# HOT_QUANTILE quantile of per-(nonempty-)cell candidate counts.  Not the
# default (hot_slots=None) and not run by the port's kernels.
HOT_QUANTILE = 0.95
HOT_MIN_SAVE = 3  # don't split for fewer than this many overflow slots


class PagedGridTables(NamedTuple):
    """Paged tables (all f32; layout statics derive from shapes).

    geom:  [n_pages, w*n_slots, 128]: row (k*w + v) is value v of slot k,
           v in (cx, cz, kc) (w=3) or (cx, cy, cz, kc) (w=4, has_cy);
           columns are the page's fine cells ((ix%8)*16 + iz%16).
    lids:  [n_pages, n_slots, 128]: slot k's page-local sphere id.
    attrs: [n_pages, na*ab, 128]: row (v*ab + b) is attr v (mat, c0.rgb,
           attr[, cy][, tex, c1.rgb]) of the page's local spheres b*128..;
           lid < ab*128 <= 512.
    gtab:  [Gp, 16] global spheres (models/grid.py layout).
    gscal: [1, 16] f32 scalars (P_* slots below).
    """

    geom: np.ndarray
    lids: np.ndarray
    attrs: np.ndarray
    gtab: np.ndarray
    gscal: np.ndarray
    has_cy: Optional[np.ndarray] = None  # non-None: 4-value geom slots and
    #   a center-y attr value set (varying field heights)
    has_tex: Optional[np.ndarray] = None  # non-None: textured field spheres,
    #   attrs carry (tex, c1.rgb) value sets after the base ones
    govf: Optional[np.ndarray] = None  # hot/overflow split: overflow slots
    #   [n_pages, w*(n_slots-hot), 128]; geom then holds the hot slots only


# gscal slots (first 12 match models.grid G_* where meaningful)
P_XLO, P_XHI, P_YLO, P_YHI, P_ZLO, P_ZHI = 0, 1, 2, 3, 4, 5
P_FMINX, P_FMINZ, P_NSCZ, P_CY, P_FMAXX, P_FMAXZ = 6, 7, 8, 9, 10, 11
P_INVS, P_S = 12, 13
P_NSCZM = 14  # page count along z (8x16 pages)


def build_paged_grid(scene, table: np.ndarray, cell_size: Optional[float] = None,
                     max_slots: int = 32, max_ab: int = 4, pad_slots: int = 0,
                     hot_slots: Optional[int] = None):
    """Build paged tables or return None when the scene doesn't fit
    (crowded fine cells / oversized page sphere lists / too many pages).

    ``pad_slots``: raise n_slots to at least this (extra slots stay POISON).
    ``hot_slots``: hot/overflow split point (None: no split; -1: auto)."""
    centers = np.asarray(scene.centers, np.float32)
    radii = np.asarray(scene.radii, np.float32)
    n = int(scene.n_spheres)
    if n == 0:
        return None
    kc = np.asarray(table[:, 3], np.float32)

    small = radii[:n] <= 0.5 - DELTA
    idx_all = np.arange(n)
    g_idx = idx_all[~small]
    s_idx = idx_all[small]
    if len(g_idx) > MAX_GLOBALS or len(s_idx) == 0:
        return None
    cy = centers[s_idx, 1]
    # uniform field height keeps the 3-value geom slots with cy a gscal
    # scalar; varying heights switch to the 4-value layout (has_cy)
    uniform_y = bool(np.all(cy == cy[0]))
    textured = bool(np.any(np.asarray(scene.texture)[s_idx] != 0))

    cx, cz = centers[s_idx, 0], centers[s_idx, 2]
    r = radii[s_idx]
    if cell_size is None:
        # target ~8 expected candidates per cell:
        # density * (s + 2r + 2 DELTA)^2 ~ 8
        area = float((cx.max() - cx.min() + 1) * (cz.max() - cz.min() + 1))
        density = len(s_idx) / max(area, 1.0)
        reach = 2.0 * float(r.max()) + 2.0 * DELTA
        cell_size = max(0.25, np.sqrt(8.0 / density) - reach) * CELL_SIZE_SCALE
    s = np.float32(cell_size)

    # fine lattice: cell i covers [fmin + i*s, fmin + (i+1)*s)
    fmin_x = np.float32(np.floor((cx - r - DELTA).min() / s) * s)
    fmin_z = np.float32(np.floor((cz - r - DELTA).min() / s) * s)
    nfx = int(np.ceil(((cx + r + DELTA).max() - fmin_x) / s)) + 1
    nfz = int(np.ceil(((cz + r + DELTA).max() - fmin_z) / s)) + 1
    nsc_x = -(-nfx // F_AXIS)
    nsc_z8 = -(-nfz // F_AXIS)  # 8x8 z page count (kept in gscal)
    nsc_z = -(-nfz // F_AXIS_Z)
    n_pages = nsc_x * nsc_z
    if nsc_x > 64 or nsc_z > 32:
        return None  # bkey packs page coords in 6+5 bit fields

    # register spheres into fine cells (delta-enlarged AABB): one
    # (cell, sphere) pair per overlapped cell via span offsets
    fcx = np.floor((cx - r - DELTA - fmin_x) / s).astype(np.int64)
    fcx1 = np.floor((cx + r + DELTA - fmin_x) / s).astype(np.int64)
    fcz = np.floor((cz - r - DELTA - fmin_z) / s).astype(np.int64)
    fcz1 = np.floor((cz + r + DELTA - fmin_z) / s).astype(np.int64)
    span_x = fcx1 - fcx
    span_z = fcz1 - fcz
    sis, ixs, izs = [], [], []
    all_si = np.arange(len(s_idx), dtype=np.int64)
    for ox in range(int(span_x.max()) + 1):
        for oz in range(int(span_z.max()) + 1):
            m = (ox <= span_x) & (oz <= span_z)
            ix = fcx[m] + ox
            iz = fcz[m] + oz
            ok = (ix >= 0) & (ix < nfx) & (iz >= 0) & (iz < nfz)
            sis.append(all_si[m][ok])
            ixs.append(ix[ok])
            izs.append(iz[ok])
    sis = np.concatenate(sis)
    ixs = np.concatenate(ixs)
    izs = np.concatenate(izs)
    cell = ixs * nfz + izs
    # sort by (cell, sphere) -> per-cell slots in ascending global-index order
    order = np.lexsort((sis, cell))
    cell, sis, ixs, izs = cell[order], sis[order], ixs[order], izs[order]
    cell_start = np.r_[True, cell[1:] != cell[:-1]]
    start_pos = np.flatnonzero(cell_start)
    rank = np.arange(len(cell)) - np.repeat(start_pos, np.diff(np.r_[start_pos, len(cell)]))
    n_slots = int(rank.max()) + 1 if len(rank) else 1
    n_slots = max(n_slots, pad_slots)
    if n_slots > max_slots:
        return None
    if hot_slots is None:
        hot = n_slots
    elif hot_slots == -1:
        counts = np.diff(np.r_[start_pos, len(cell)])
        hot = (int(np.ceil(np.quantile(counts, HOT_QUANTILE)))
               if len(counts) else n_slots)
    else:
        hot = int(hot_slots)
    hot = min(max(hot, 1), n_slots)
    if n_slots - hot < HOT_MIN_SAVE:
        hot = n_slots
    page = (ixs // F_AXIS) * nsc_z + (izs // F_AXIS_Z)  # 8x16 page

    # page-local sphere ids: unique (page, sphere) ranked within page
    ps = np.unique(page * (len(s_idx) + 1) + sis)
    p_of = ps // (len(s_idx) + 1)
    s_of = ps % (len(s_idx) + 1)
    p_start = np.flatnonzero(np.r_[True, p_of[1:] != p_of[:-1]])
    lid_of = np.arange(len(ps)) - np.repeat(
        p_start, np.diff(np.r_[p_start, len(ps)]))
    max_local = int(lid_of.max()) + 1 if len(lid_of) else 1
    ab = -(-max_local // PAGE_LANES)
    if ab > max_ab:
        return None
    w = 3 if uniform_y else 4  # geom values per slot (cx[, cy], cz, kc)
    # attr value sets: (mat, c0.rgb, attr) + center y when heights vary
    # + (tex, c1.rgb) when field spheres are textured
    na = (5 if uniform_y else 6) + (4 if textured else 0)
    r0 = w * n_slots
    if n_pages * (r0 + n_slots + na * ab) * PAGE_LANES * 4 > 72 * 2**20:
        return None  # table budget (geom + lids + attrs)

    # lid lookup for each (page, sphere) registration pair
    lid_map = dict(zip(ps.tolist(), lid_of.tolist()))
    lids = np.array([lid_map[p * (len(s_idx) + 1) + si]
                     for p, si in zip(page.tolist(), sis.tolist())], np.int64)

    geom = np.zeros((n_pages * r0, PAGE_LANES), np.float32)
    geom[(w - 1) :: w, :] = POISON  # kc rows default to miss
    lidt = np.zeros((n_pages * n_slots, PAGE_LANES), np.float32)
    a0 = na * ab
    attrs = np.zeros((n_pages * a0, PAGE_LANES), np.float32)

    fc = (ixs % F_AXIS) * F_AXIS_Z + (izs % F_AXIS_Z)
    base = page * r0 + rank * w
    if uniform_y:
        geom[base + 0, fc] = cx[sis]
        geom[base + 1, fc] = cz[sis]
        geom[base + 2, fc] = kc[s_idx[sis]]
    else:
        geom[base + 0, fc] = cx[sis]
        geom[base + 1, fc] = cy[sis]
        geom[base + 2, fc] = cz[sis]
        geom[base + 3, fc] = kc[s_idx[sis]]
    lidt[page * n_slots + rank, fc] = lids.astype(np.float32)

    sph = s_idx[s_of]
    b_, c_ = np.divmod(lid_of, PAGE_LANES)
    attrs[p_of * a0 + 0 * ab + b_, c_] = table[sph, 11]  # mat
    attrs[p_of * a0 + 1 * ab + b_, c_] = table[sph, 13]  # c0.r
    attrs[p_of * a0 + 2 * ab + b_, c_] = table[sph, 14]
    attrs[p_of * a0 + 3 * ab + b_, c_] = table[sph, 15]
    attrs[p_of * a0 + 4 * ab + b_, c_] = table[sph, 19]  # attr
    if not uniform_y:
        attrs[p_of * a0 + 5 * ab + b_, c_] = centers[sph, 1]  # center y
    if textured:
        t0 = (5 if uniform_y else 6) * ab
        attrs[p_of * a0 + t0 + 0 * ab + b_, c_] = table[sph, 12]  # tex
        attrs[p_of * a0 + t0 + 1 * ab + b_, c_] = table[sph, 16]  # c1.r
        attrs[p_of * a0 + t0 + 2 * ab + b_, c_] = table[sph, 17]
        attrs[p_of * a0 + t0 + 3 * ab + b_, c_] = table[sph, 18]

    g_pad = max(4, len(g_idx))
    gtab = np.zeros((g_pad, 16), np.float32)
    gtab[:, 3] = POISON
    gtab[:, 4] = -2.0
    for k, sphere in enumerate(g_idx):
        gtab[k, 0:3] = centers[sphere]
        gtab[k, 3] = kc[sphere]
        gtab[k, 4] = np.float32(sphere)
        gtab[k, 5] = np.float32(scene.material[sphere])
        gtab[k, 6] = np.float32(scene.texture[sphere])
        gtab[k, 7:10] = np.asarray(scene.color0[sphere], np.float32)
        gtab[k, 10:13] = np.asarray(scene.color1[sphere], np.float32)
        gtab[k, 13] = np.float32(scene.attr[sphere])

    y_lo = np.float32((cy - radii[s_idx]).min() - DELTA)
    y_hi = np.float32((cy + radii[s_idx]).max() + DELTA)
    gscal = np.zeros((1, 16), np.float32)
    gscal[0, P_XLO] = fmin_x
    gscal[0, P_XHI] = np.float32(fmin_x + nfx * s)
    gscal[0, P_YLO] = y_lo
    gscal[0, P_YHI] = y_hi
    gscal[0, P_ZLO] = fmin_z
    gscal[0, P_ZHI] = np.float32(fmin_z + nfz * s)
    gscal[0, P_FMINX] = fmin_x
    gscal[0, P_FMINZ] = fmin_z
    gscal[0, P_NSCZ] = np.float32(nsc_z8)
    gscal[0, P_CY] = np.float32(cy[0])
    gscal[0, P_FMAXX] = np.float32(nfx - 1)  # max fine index, x
    gscal[0, P_FMAXZ] = np.float32(nfz - 1)
    gscal[0, P_INVS] = np.float32(1.0) / s
    gscal[0, P_S] = s
    gscal[0, P_NSCZM] = np.float32(nsc_z)

    geom3 = geom.reshape(n_pages, r0, PAGE_LANES)
    govf = None
    if hot < n_slots:
        govf = np.ascontiguousarray(geom3[:, w * hot :, :])
        geom3 = np.ascontiguousarray(geom3[:, : w * hot, :])

    return PagedGridTables(
        geom=geom3,
        govf=govf,
        lids=lidt.reshape(n_pages, n_slots, PAGE_LANES),
        attrs=attrs.reshape(n_pages, a0, PAGE_LANES),
        gtab=gtab, gscal=gscal,
        has_cy=None if uniform_y else np.zeros((1, 1), np.float32),
        has_tex=np.zeros((1, 1), np.float32) if textured else None)
