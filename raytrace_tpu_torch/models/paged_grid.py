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

``build_paged_grid`` makes the tables with torch ops on the device of the
sphere table it is given, so an animated scene's tables are built where they
are read and only the scene's own arrays cross to the card; on the CPU it
builds the host tables (``ops/trace.prepare_scene``).  Its tables are byte
for byte the JAX package's builder's, with the same ``None`` verdicts
(tests/test_torch_paged_build.py); the port never imports the JAX package,
whose ``__init__`` imports jax.  ``hot_slots`` is kept so the builder stays
byte-equal; the kernels refuse the split tables it makes (``govf``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

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
    """Paged tables (all f32, tensors or, from ``prepare_scene``, numpy
    arrays; layout statics derive from shapes).

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

    geom: object
    lids: object
    attrs: object
    gtab: object
    gscal: object
    has_cy: Optional[object] = None  # non-None: 4-value geom slots and
    #   a center-y attr value set (varying field heights)
    has_tex: Optional[object] = None  # non-None: textured field spheres,
    #   attrs carry (tex, c1.rgb) value sets after the base ones
    govf: Optional[object] = None  # hot/overflow split: overflow slots
    #   [n_pages, w*(n_slots-hot), 128]; geom then holds the hot slots only


# gscal slots (first 12 match models.grid G_* where meaningful)
P_XLO, P_XHI, P_YLO, P_YHI, P_ZLO, P_ZHI = 0, 1, 2, 3, 4, 5
P_FMINX, P_FMINZ, P_NSCZ, P_CY, P_FMAXX, P_FMAXZ = 6, 7, 8, 9, 10, 11
P_INVS, P_S = 12, 13
P_NSCZM = 14  # page count along z (8x16 pages)

_F32 = torch.float32
_I64 = torch.int64


class _Reads:
    """The builder's host reads of device values, counted: each is one
    wait for the device."""

    def __init__(self):
        self.syncs = 0

    def values(self, t: torch.Tensor) -> np.ndarray:
        self.syncs += 1
        return t.cpu().numpy()

    def select(self, t: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """``t[mask]``: its length is read from the device."""
        self.syncs += 1
        return t[mask]


def _rank_in_runs(keys: torch.Tensor) -> torch.Tensor:
    """Each element's position within its run of equal ``keys`` (sorted):
    its index less its run's first, found by binary search (a running
    maximum over the run starts is one block's sequential scan on CUDA)."""
    return torch.arange(keys.numel(), device=keys.device) - torch.searchsorted(keys, keys)


def _to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A small host array on ``device``: from pinned memory and without
    waiting on a CUDA device."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def build_paged_grid(scene, table, cell_size: Optional[float] = None,
                     max_slots: int = 32, max_ab: int = 4, pad_slots: int = 0,
                     hot_slots: Optional[int] = None, stats: Optional[dict] = None):
    """Build paged tables or return None when the scene doesn't fit
    (crowded fine cells / oversized page sphere lists / too many pages).

    ``table``: the scene's sphere table (``ops/intersect.py``), a tensor or
    a numpy array (then on the CPU); the tables are built on its device,
    from ``scene``'s arrays there (tensors, or numpy arrays for a CPU
    table).  Returns PagedGridTables of tensors on that device.
    ``pad_slots``: raise n_slots to at least this (extra slots stay POISON).
    ``hot_slots``: hot/overflow split point (None: no split; -1: auto).
    ``stats`` (a dict) receives ``syncs``, the host reads of device values,
    and ``pairs``, ``n_pages`` and ``n_slots`` as far as the build gets."""
    stats = {} if stats is None else stats
    reads = _Reads()
    table = torch.as_tensor(table)
    try:
        return _build(scene, table, cell_size, max_slots, max_ab, pad_slots, hot_slots,
                      stats, reads)
    finally:
        stats["syncs"] = reads.syncs


def _build(scene, table, cell_size, max_slots, max_ab, pad_slots, hot_slots, stats, reads):
    """No Python loop over spheres, pairs or cells: the spheres expand into
    (cell, sphere) pairs; one sort by that key and a binary search for each
    cell's first pair give every pair its slot, a sorted set of (page,
    sphere) keys the page-local ids, and scatters fill the tables.  The host
    reads the device only for the scalars that fix the tables' shapes (the
    extents, the span maxima, the pair and page-local list lengths, the slot
    and id maxima).  A scalar divisor is a device tensor, never a Python
    number: CUDA divides by a host scalar as a multiply by its reciprocal,
    which can differ from numpy's quotient in the last bit and move a sphere
    across a cell edge."""
    dev = table.device
    n = int(scene.n_spheres)
    if n == 0:
        return None

    def arr(a, dtype):
        return torch.as_tensor(a, dtype=dtype, device=dev)[:n]

    centers, radii = arr(scene.centers, _F32), arr(scene.radii, _F32)
    material, texture = arr(scene.material, torch.int32), arr(scene.texture, torch.int32)
    kc = table[:, 3]
    small = radii <= 0.5 - DELTA

    # one read: the counts, the flags and the float32 reductions that fix
    # the lattice, over the small spheres (masked reductions are exact)
    cx_a, cy_a, cz_a = centers[:, 0], centers[:, 1], centers[:, 2]
    inf = torch.full((), float("inf"), dtype=_F32, device=dev)

    def lo(v):
        return torch.where(small, v, inf).min()

    def hi(v):
        return torch.where(small, v, -inf).max()

    first = torch.argmax(small.to(torch.int32)).view(1)  # the first small sphere
    cy0 = cy_a.gather(0, first)[0]
    uniform = torch.where(small, cy_a == cy0, True).all()
    textured = (small & (texture != 0)).any()
    row = torch.stack([
        small.sum().to(torch.float64), uniform.to(torch.float64), textured.to(torch.float64),
        *(v.to(torch.float64) for v in (
            hi(cx_a), lo(cx_a), hi(cz_a), lo(cz_a), hi(radii),
            lo(cx_a - radii - DELTA), lo(cz_a - radii - DELTA),
            hi(cx_a + radii + DELTA), hi(cz_a + radii + DELTA),
            lo(cy_a - radii), hi(cy_a + radii), cy0))])
    (ns, uniform_y, textured, *f32) = reads.values(row).tolist()
    ns, uniform_y, textured = int(ns), bool(uniform_y), bool(textured)
    (cx_max, cx_min, cz_max, cz_min, r_max, lo_x, lo_z, hi_x, hi_z,
     ylo, yhi, cy_first) = (np.float32(v) for v in f32)
    if n - ns > MAX_GLOBALS or ns == 0:
        return None
    # small spheres first, then the globals, each in index order
    perm = torch.argsort((~small).to(torch.int32), stable=True)
    s_idx, g_idx = perm[:ns], perm[ns:]
    cx, cy, cz, r = cx_a[s_idx], cy_a[s_idx], cz_a[s_idx], radii[s_idx]

    # the lattice on the host, from the same float32 scalars as the JAX
    # builder's; target ~8 expected candidates per cell:
    # density * (s + 2r + 2 DELTA)^2 ~ 8
    if cell_size is None:
        area = float((cx_max - cx_min + 1) * (cz_max - cz_min + 1))
        density = ns / max(area, 1.0)
        reach = 2.0 * float(r_max) + 2.0 * DELTA
        cell_size = max(0.25, np.sqrt(8.0 / density) - reach) * CELL_SIZE_SCALE
    s = np.float32(cell_size)
    # fine lattice: cell i covers [fmin + i*s, fmin + (i+1)*s)
    fmin_x = np.float32(np.floor(lo_x / s) * s)
    fmin_z = np.float32(np.floor(lo_z / s) * s)
    nfx = int(np.ceil((hi_x - fmin_x) / s)) + 1
    nfz = int(np.ceil((hi_z - fmin_z) / s)) + 1
    nsc_x = -(-nfx // F_AXIS)
    nsc_z8 = -(-nfz // F_AXIS)  # 8x8 z page count (kept in gscal)
    nsc_z = -(-nfz // F_AXIS_Z)
    n_pages = nsc_x * nsc_z
    stats["n_pages"] = n_pages
    if nsc_x > 64 or nsc_z > 32:
        return None  # bkey packs page coords in 6+5 bit fields

    # register spheres into fine cells (delta-enlarged AABB)
    s_t = torch.full((), float(s), dtype=_F32, device=dev)
    fcx = torch.floor((cx - r - DELTA - float(fmin_x)) / s_t).to(_I64)
    fcx1 = torch.floor((cx + r + DELTA - float(fmin_x)) / s_t).to(_I64)
    fcz = torch.floor((cz - r - DELTA - float(fmin_z)) / s_t).to(_I64)
    fcz1 = torch.floor((cz + r + DELTA - float(fmin_z)) / s_t).to(_I64)
    span_x, span_z = fcx1 - fcx, fcz1 - fcz
    sx, sz = (int(v) for v in reads.values(torch.stack([span_x.max(), span_z.max()])))
    ox = torch.arange(sx + 1, device=dev).repeat_interleave(sz + 1)[:, None]
    oz = torch.arange(sz + 1, device=dev).repeat(sx + 1)[:, None]
    ix, iz = fcx[None] + ox, fcz[None] + oz
    ok = ((ox <= span_x[None]) & (oz <= span_z[None])
          & (ix >= 0) & (ix < nfx) & (iz >= 0) & (iz < nfz))
    si = torch.arange(ns, device=dev).expand_as(ix)
    # one (cell, sphere) key a pair, unique: sorted, the per-cell slots
    # come in ascending global-index order
    key = reads.select((ix * nfz + iz) * ns + si, ok)
    key = torch.sort(key).values
    stats["pairs"] = key.numel()
    cell, sis = key // ns, key % ns
    ixs, izs = cell // nfz, cell % nfz
    rank = _rank_in_runs(cell)
    page = (ixs // F_AXIS) * nsc_z + (izs // F_AXIS_Z)  # 8x16 page

    # page-local sphere ids: unique (page, sphere) ranked within page
    pkey = page * (ns + 1) + sis
    sorted_pkey = torch.sort(pkey).values
    new = torch.ones_like(sorted_pkey, dtype=torch.bool)
    new[1:] = sorted_pkey[1:] != sorted_pkey[:-1]
    ps = reads.select(sorted_pkey, new)
    p_of, s_of = ps // (ns + 1), ps % (ns + 1)
    lid_of = _rank_in_runs(p_of)
    if key.numel():
        top_rank, top_lid = (int(v) for v in reads.values(torch.stack([rank.max(),
                                                                       lid_of.max()])))
    else:
        top_rank = top_lid = 0
    n_slots = max(top_rank + 1, pad_slots)
    stats["n_slots"] = n_slots
    if n_slots > max_slots:
        return None
    if hot_slots is None:
        hot = n_slots
    elif hot_slots == -1:
        # a cell of c pairs holds ranks 0..c-1: the pairs of rank k count
        # the cells of more than k pairs
        above = torch.zeros(top_rank + 2, dtype=_I64, device=dev)
        above.scatter_add_(0, rank, torch.ones_like(rank))
        above = reads.values(above)
        counts = np.repeat(np.arange(1, top_rank + 2), above[:-1] - above[1:])
        hot = (int(np.ceil(np.quantile(counts, HOT_QUANTILE))) if len(counts) else n_slots)
    else:
        hot = int(hot_slots)
    hot = min(max(hot, 1), n_slots)
    if n_slots - hot < HOT_MIN_SAVE:
        hot = n_slots
    ab = -(-(top_lid + 1) // PAGE_LANES)
    if ab > max_ab:
        return None
    w = 3 if uniform_y else 4  # geom values per slot (cx[, cy], cz, kc)
    # attr value sets: (mat, c0.rgb, attr) + center y when heights vary
    # + (tex, c1.rgb) when field spheres are textured
    na = (5 if uniform_y else 6) + (4 if textured else 0)
    r0 = w * n_slots
    if n_pages * (r0 + n_slots + na * ab) * PAGE_LANES * 4 > 72 * 2**20:
        return None  # table budget (geom + lids + attrs)

    # each pair's page-local id: the place of its (page, sphere) key
    lids = lid_of[torch.searchsorted(ps, pkey)]

    geom = torch.zeros((n_pages * r0, PAGE_LANES), dtype=_F32, device=dev)
    geom[(w - 1) :: w, :] = float(POISON)  # kc rows default to miss
    lidt = torch.zeros((n_pages * n_slots, PAGE_LANES), dtype=_F32, device=dev)
    a0 = na * ab
    attrs = torch.zeros((n_pages * a0, PAGE_LANES), dtype=_F32, device=dev)

    fc = (ixs % F_AXIS) * F_AXIS_Z + (izs % F_AXIS_Z)
    base = page * r0 + rank * w
    vals = (cx, cz) if uniform_y else (cx, cy, cz)
    for v, col in enumerate(vals + (kc[s_idx],)):
        geom[base + v, fc] = col[sis]
    lidt[page * n_slots + rank, fc] = lids.to(_F32)

    sph = s_idx[s_of]
    b_, c_ = lid_of // PAGE_LANES, lid_of % PAGE_LANES
    rows = p_of * a0 + b_
    for v, col in enumerate((11, 13, 14, 15, 19)):  # mat, c0.rgb, attr
        attrs[rows + v * ab, c_] = table[sph, col]
    if not uniform_y:
        attrs[rows + 5 * ab, c_] = cy_a[sph]  # center y
    if textured:
        t0 = (5 if uniform_y else 6) * ab
        for v, col in enumerate((12, 16, 17, 18)):  # tex, c1.rgb
            attrs[rows + t0 + v * ab, c_] = table[sph, col]

    ng = n - ns
    gtab = torch.zeros((max(4, ng), 16), dtype=_F32, device=dev)
    gtab[:, 3] = float(POISON)
    gtab[:, 4] = -2.0
    gtab[:ng, 0:3] = centers[g_idx]
    gtab[:ng, 3] = kc[g_idx]
    gtab[:ng, 4] = g_idx.to(_F32)
    gtab[:ng, 5] = material[g_idx].to(_F32)
    gtab[:ng, 6] = texture[g_idx].to(_F32)
    gtab[:ng, 7:10] = arr(scene.color0, _F32)[g_idx]
    gtab[:ng, 10:13] = arr(scene.color1, _F32)[g_idx]
    gtab[:ng, 13] = arr(scene.attr, _F32)[g_idx]

    gscal = np.zeros((1, 16), np.float32)
    gscal[0, P_XLO] = fmin_x
    gscal[0, P_XHI] = np.float32(fmin_x + nfx * s)
    gscal[0, P_YLO] = np.float32(ylo - DELTA)
    gscal[0, P_YHI] = np.float32(yhi + DELTA)
    gscal[0, P_ZLO] = fmin_z
    gscal[0, P_ZHI] = np.float32(fmin_z + nfz * s)
    gscal[0, P_FMINX] = fmin_x
    gscal[0, P_FMINZ] = fmin_z
    gscal[0, P_NSCZ] = np.float32(nsc_z8)
    gscal[0, P_CY] = cy_first
    gscal[0, P_FMAXX] = np.float32(nfx - 1)  # max fine index, x
    gscal[0, P_FMAXZ] = np.float32(nfz - 1)
    gscal[0, P_INVS] = np.float32(1.0) / s
    gscal[0, P_S] = s
    gscal[0, P_NSCZM] = np.float32(nsc_z)

    geom3 = geom.reshape(n_pages, r0, PAGE_LANES)
    govf = None
    if hot < n_slots:
        govf = geom3[:, w * hot :, :].contiguous()
        geom3 = geom3[:, : w * hot, :].contiguous()
    flag = torch.zeros((1, 1), dtype=_F32, device=dev)
    return PagedGridTables(
        geom=geom3, govf=govf,
        lids=lidt.reshape(n_pages, n_slots, PAGE_LANES),
        attrs=attrs.reshape(n_pages, a0, PAGE_LANES),
        gtab=gtab, gscal=_to_device(gscal, dev),
        has_cy=None if uniform_y else flag,
        has_tex=flag.clone() if textured else None)
