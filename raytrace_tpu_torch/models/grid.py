"""Uniform-grid acceleration structure for the wavefront megakernel.

The TPU-native replacement for the reference's hardware BVH
(reference src/vulkan.h:395-554 BLAS/TLAS + :994 traceRaysKHR): instead
of per-ray tree traversal on RT cores, rays DDA-march a half-integer-aligned
uniform cell grid over the small-sphere field (the book scene lays its 484
field spheres on a 22x22 unit lattice, scene.h:118-125 — a uniform grid is
the *ideal* structure for it), testing <=4 candidate spheres per cell fetched
with per-lane Mosaic ``dynamic_gather`` ops.  Large spheres that would bloat
every cell's candidate list (ground, heroes) go to a small "global" table the
kernel brute-forces every segment — their hits also prune the march.

Exactness contract (grid backend must be bit-identical to brute force):
 - every sphere is registered in every cell its delta-enlarged AABB touches,
   so DDA fp slop (~1e-4 world units) cannot skip a hit (delta = 1e-2);
 - per-sphere quadratic uses the same packed (cx, cz, kc) values and the same
   op order as the brute-force table (kc is *gathered*, not recomputed, so
   the f64-precomputed value matches bit-for-bit);
 - candidates within a cell are sorted by sphere index and compared with
   strict ``<``, and cells are visited in ray order, reproducing the
   brute-force lowest-index-wins tie-break (up to exact-fp-tie collisions
   across cells, which have no representable-probability mass).

Gather layout (Mosaic dynamic_gather along lanes requires 128-wide tables):
cells are numbered (ix * ncz + iz) and split into CB blocks of 128; a fetch
gathers all (value, block) rows at the cell's low 7 bits, then selects the
block by the high bits.

Port of ``raytrace_tpu/models/grid.py`` (numpy only): the port never
imports the JAX package, whose ``__init__`` imports jax.  ``build_grid``
makes the same decisions (eligibility, the boundary-line spill search, the
layouts, the caps) and keeps the block-major layout above, but builds the
tables with array operations where the JAX builder loops in Python: the
spheres expand into (sphere, cell) pairs, one stable sort by cell and a
rank within each cell give every member its slot, and fancy-index scatters
and reshapes fill the slot, ctab, atab, ttab and gtab arrays (the build
runs on every animated frame, on the frame's critical path).  The tests hold
its tables byte-equal to the JAX builder's; ``cell_major`` re-lays those
tables once per scene into the layout the port's grid kernel reads
(``CellTables``): one contiguous record per cell and per sphere, read with
16-byte loads instead of one 4-byte load per value 512 bytes apart.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np

CELL_LANES = 128  # dynamic_gather lane-table width
N_SLOTS = 4  # candidate slots per cell, 4-value (uniform-height) layout
MAX_N_SLOTS = 8  # adaptive cap for the general 5-value layout: random
#                  fields crowd past 4 slots/cell almost surely (Poisson
#                  tail across hundreds of cells), so the general layout
#                  sizes n_slots to the worst cell, up to this cap
DELTA = 1e-2  # conservative AABB enlargement (>> DDA fp slop)
MAX_CELLS = 8 * CELL_LANES  # CB <= 8 keeps the fetch tables small
MAX_GLOBALS = 16  # genuinely-large spheres (each is a per-segment quadratic
#                  that does NOT prune the march the way cell tests do).
#                  The kernel's globals loop is scene-adaptive (gtab rows =
#                  the actual global count), so this cap only decides when
#                  to give up on the grid entirely; measured marginal cost
#                  ~0.075%/global on scenes that use the headroom, zero on
#                  scenes that don't (the book scene's gtab is its own size)
MAX_GTAB = 32  # global-table rows incl. boundary-line spills (below)
POISON = np.float32(3e30)  # kc sentinel: disc < 0 -> NaN sqrt -> miss
MAX_SPHERES = 4096  # gridkernel._TAG: build_grid refuses scenes this large


class GridTables(NamedTuple):
    """Device tables for the grid megakernel (all f32; see gridkernel.py)."""

    ctab: np.ndarray  # [CB*stride, 128] cell candidates, BLOCK-MAJOR.
    #                   Uniform-field-height scenes (the book scene) use the
    #                   4-value layout: row (cb*16 + v),
    #                   v = slot*4 + {0:cx, 1:cz, 2:kc, 3:global sphere id}
    #                   with cy a gscal scalar.  General scenes (has_cy set)
    #                   use the 5-value layout: n_slots = has_cy.shape[1]
    #                   (adaptive, 4..MAX_N_SLOTS), stride = pad8(5*n_slots),
    #                   v = slot*5 + {0:cx, 1:cy, 2:cz, 3:kc, 4:sphere id}.
    #                   The id rides the march fetch so winner resolution is
    #                   ONE atab gather instead of two dependent gathers
    #                   (the itab hop sat on the kernel's latency-bound
    #                   critical path; empty slots carry id 0 with kc
    #                   POISON, so they never win)
    atab: np.ndarray  # [AB*8, 128] per-sphere shading attrs, row (ab*8+v),
    #                   v in 0..4 (rows 5-7 of each block are alignment pad):
    #                   v in (mat, c0.rgb, attr).  Winner centers are carried
    #                   by the kernel (grid) or selected from gtab (globals);
    #                   tex/c1 exist only on globals (build_grid requirement)
    gtab: np.ndarray  # [Gp, 16] globals (SMEM):
    #                   cx,cy,cz,kc,idx,mat,tex,c0.rgb,c1.rgb,attr,0,0
    gttab: np.ndarray  # [Tp, 16] the TEXTURED rows of gtab only (same
    #                   layout): the winner-resolution tex/c1 select chain
    #                   loops over these — solid-color globals (and
    #                   boundary-line spills) get the chain's 0-defaults,
    #                   which is exactly what texture 0 means, so the chain
    #                   cost doesn't scale with the spill count
    gscal: np.ndarray  # [1, 16] f32 scalars: xlo,xhi,ylo,yhi,zlo,zhi,
    #                    cminx,cminz,ncz_f,cy_uniform,cmaxx,cmaxz
    # (cell/attr block counts are derived from ctab/atab shapes — the tuple
    # stays a pure array pytree so it can ride through jit untraced-free)
    has_cy: Optional[np.ndarray] = None  # non-None marks the 5-value ctab
    #                   layout (scenes with varying field-sphere heights
    #                   and/or cells crowded past 4 slots).  An Optional
    #                   FIELD whose SHAPE carries the slot count: pytree
    #                   structure and shapes are static under jit, so the
    #                   kernel reads ``five = has_cy is not None`` and
    #                   ``n_slots = has_cy.shape[1]`` without a traced value
    #                   (ctab's own row count is ambiguous — pad8(5*n)*cb
    #                   collides across (n, cb) pairs).  The zeros it holds
    #                   are never read.
    ttab: Optional[np.ndarray] = None  # [AB*8, 128] per-sphere tex + c1.rgb
    #                   (rows b*8 + {0:tex, 1-3:c1}, 4 pad rows/block) —
    #                   present only when a FIELD sphere is textured; the
    #                   kernel then resolves tex/c1 by one extra gather for
    #                   all winners instead of the globals-only gttab chain.
    slots4: Optional[np.ndarray] = None  # non-None marks a FOUR-value ctab
    #                   with n_slots != 4 (coarse-pitch uniform scenes);
    #                   shape (1, n_slots) carries the count the same way
    #                   has_cy does for the 5-value layout.


# gscal slot indices
G_XLO, G_XHI, G_YLO, G_YHI, G_ZLO, G_ZHI = 0, 1, 2, 3, 4, 5
G_CMINX, G_CMINZ, G_NCZ, G_CY, G_CMAXX, G_CMAXZ = 6, 7, 8, 9, 10, 11
G_S, G_INVS = 12, 13  # cell pitch (world units per cell) and its reciprocal


def build_grid(scene, table: np.ndarray, pitch: float = 1.0,
               max_slots: int = MAX_N_SLOTS) -> Optional[GridTables]:
    """Build grid tables from a SceneArrays + its packed sphere table
    (pallas_intersect.sphere_table — source of the bit-exact kc column).

    Returns None when the scene doesn't fit the structure (too many large
    spheres, too many cells, crowded cells, non-uniform field height) — the
    caller falls back to the brute-force megakernel.

    ``pitch``: cell size in world units.  The unit lattice (1.0) was tuned
    when the fetch dominated; coarser cells trade march steps (each costing
    a fixed-cost gather) for more candidate quadratics (cheap — 6.9% serial
    share).  Powers of two keep ALL the kernel's lattice arithmetic exact
    (x*0.5 / (c±0.5)*2 are exponent shifts), and for any pitch the
    delta-enlarged registration absorbs DDA fp slop, so grid==mega
    bit-identity is pitch-independent (tests/test_grid_pitch.py).
    """
    centers = np.asarray(scene.centers, np.float32)
    radii = np.asarray(scene.radii, np.float32)
    s_pitch = np.float32(pitch)
    n = int(scene.n_spheres)
    if n == 0:
        return None
    kc = np.asarray(table[:, 3], np.float32)  # _C_KC column, f64-precomputed

    # eligibility: a sphere is grid-eligible when its delta-enlarged AABB
    # spans <= 2 cells per axis, i.e. 2*(r+DELTA) <= pitch; everything else
    # goes to the brute-forced global table.  The absolute 0.5 cap keeps
    # genuinely-large spheres (heroes, ground) global at coarse pitches too:
    # promoting them into cells buys nothing (the globals loop is ~0.3%) and
    # a y=1 hero would flip a uniform-height field to the 5-value layout.
    idx_all = np.arange(n)
    small = radii[:n] <= min(pitch, 1.0) / 2 - DELTA
    g_idx = idx_all[~small]
    s_idx = idx_all[small]
    if len(g_idx) > MAX_GLOBALS or len(s_idx) == 0:
        return None
    # bkey tags global winners as _TAG + id and grid winners as the raw id;
    # a grid sphere id >= _TAG would be misread as a global hit, so scenes
    # with that many spheres fall back to brute force / the paged grid
    if n >= MAX_SPHERES:
        return None
    cy = centers[s_idx, 1]
    # Uniform field height (the book scene: every small sphere at y=0.2)
    # keeps the fast 4-value ctab layout with cy as a gscal scalar; varying
    # heights switch to the 5-value layout (cy fetched per candidate).  The
    # cell lattice stays 2-D either way — cells are y-columns clipped by the
    # y slab, so a tall scene costs extra candidate tests, not a 3-D DDA.
    uniform_y = bool(np.all(cy == cy[0]))

    cx, cz = centers[s_idx, 0], centers[s_idx, 2]
    r = radii[s_idx]
    # half-integer lattice at pitch s: cell c covers [(c-0.5)s, (c+0.5)s).
    # Per-sphere cell ranges of the delta-enlarged AABBs (the JAX builder's
    # f32 expression; /1.0 is exact):
    rr = r + np.float32(DELTA)
    ix0 = np.floor((cx - rr) / s_pitch + 0.5).astype(np.int64)
    ix1 = np.floor((cx + rr) / s_pitch + 0.5).astype(np.int64)
    iz0 = np.floor((cz - rr) / s_pitch + 0.5).astype(np.int64)
    iz1 = np.floor((cz + rr) / s_pitch + 0.5).astype(np.int64)

    # No guard ring (round 3): the delta-enlarged registration already
    # absorbs every interior DDA boundary case, and a ray entering through
    # a box FACE computes its entry cell at the face coordinate, where
    # floor+clip cannot land past the boundary cell — so the one-cell empty
    # ring only inflated the cell count (book scene: 625 -> 529 cells).
    #
    # Boundary-line SPILL: when dropping a whole boundary cell line lowers
    # the fetch block count cb = ceil(cells/128), every sphere registered in
    # that line is moved to the brute-forced globals table instead (measured
    # marginal cost ~0.075%/global vs ~5% per fetch block).  Greedy over the
    # four boundary lines, keeping the snapshot with the lowest (cb, spill
    # count); the book scene spills one ~15-sphere line: 529 -> 506 cells,
    # cb 5 -> 4.
    act = np.ones(len(s_idx), bool)

    def _cells(a):
        ncx = int(ix1[a].max() - ix0[a].min() + 1)
        ncz = int(iz1[a].max() - iz0[a].min() + 1)
        return ncx * ncz

    budget = MAX_GTAB - len(g_idx)
    best = (-(-_cells(act) // CELL_LANES), 0, act.copy())
    cur = act
    for _ in range(6):
        lo_x, hi_x = ix0[cur].min(), ix1[cur].max()
        lo_z, hi_z = iz0[cur].min(), iz1[cur].max()
        lines = [ix0 <= lo_x, ix1 >= hi_x, iz0 <= lo_z, iz1 >= hi_z]
        costs = [int((m & cur).sum()) for m in lines]
        pick = int(np.argmin(costs))
        spilled = (len(s_idx) - int(cur.sum())) + costs[pick]
        if spilled > budget:
            break
        nxt = cur & ~lines[pick]
        if not nxt.any():
            break
        cur = nxt
        cand = (-(-_cells(cur) // CELL_LANES), spilled, cur.copy())
        if cand[:2] < best[:2]:
            best = cand
    act = best[2]
    if not act.all():
        g_idx = np.concatenate([g_idx, s_idx[~act]])
        s_idx = s_idx[act]
        cx, cz, r = cx[act], cz[act], r[act]
        ix0, ix1, iz0, iz1 = ix0[act], ix1[act], iz0[act], iz1[act]
        cy = cy[act]

    cmin_x, cmax_x = int(ix0.min()), int(ix1.max())
    cmin_z, cmax_z = int(iz0.min()), int(iz1.max())
    ncx = cmax_x - cmin_x + 1
    ncz = cmax_z - cmin_z + 1
    n_cells = ncx * ncz
    if n_cells > MAX_CELLS:
        return None

    cb = -(-n_cells // CELL_LANES)
    cells_pad = cb * CELL_LANES

    # register each sphere in every cell its enlarged AABB overlaps: expand
    # the spheres into their (sphere, cell) pairs, ix outer and iz inner,
    # then stable-sort the pairs by cell — s_idx is ascending, so each
    # cell's members stay sorted by sphere index — and rank them within
    # their cell (the rank is the member's slot)
    nz = iz1 - iz0 + 1
    per_sphere = (ix1 - ix0 + 1) * nz
    sph = np.repeat(np.arange(len(s_idx)), per_sphere)
    j = np.arange(len(sph)) - np.repeat(np.cumsum(per_sphere) - per_sphere, per_sphere)
    ix = ix0[sph] + j // nz[sph]
    iz = iz0[sph] + j % nz[sph]
    cell = (ix - cmin_x) * ncz + (iz - cmin_z)
    order = np.argsort(cell, kind="stable")
    sph, cell = sph[order], cell[order]
    counts = np.bincount(cell, minlength=cells_pad)
    slot = np.arange(len(cell)) - (np.cumsum(counts) - counts)[cell]
    maxc = int(counts.max())

    # slot count: uniform-height scenes keep the 4-value layout (cy is a
    # gscal scalar) with n_slots adapted to the worst cell (4 at the book
    # scene's unit pitch; up to 8 at coarser pitches); varying heights use
    # the 5-value layout (per-candidate cy), n_slots adaptive the same way
    if uniform_y and maxc <= max_slots:
        five, n_slots = False, max(N_SLOTS, maxc)
    elif maxc <= max_slots:
        five, n_slots = True, max(N_SLOTS, maxc)
    else:
        return None  # crowded cell: grid not applicable

    slots_cx = np.zeros((n_slots, cells_pad), np.float32)
    slots_cy = np.zeros((n_slots, cells_pad), np.float32)
    slots_cz = np.zeros((n_slots, cells_pad), np.float32)
    slots_kc = np.full((n_slots, cells_pad), POISON, np.float32)
    slots_id = np.zeros((n_slots, cells_pad), np.float32)
    slots_cx[slot, cell] = cx[sph]
    slots_cy[slot, cell] = cy[sph]
    slots_cz[slot, cell] = cz[sph]
    ids = s_idx[sph]
    slots_kc[slot, cell] = kc[ids]
    slots_id[slot, cell] = ids.astype(np.float32)

    # ctab rows BLOCK-MAJOR: block*stride + (slot*vals + v) — the whole
    # block-select then runs as [stride, 128] ops, not stride x [1, 128]
    # (gridkernel._gather_rows).  Uniform-y: 4 values (cy is a scalar),
    # stride 16.  General: 5 values incl. cy, stride padded up to the next
    # multiple of 8 (block starts must be sublane-aligned for the chunk
    # lane-concat).
    if five:
        nv = 5 * n_slots
        stride = -(-nv // 8) * 8
        per = (slots_cx, slots_cy, slots_cz, slots_kc, slots_id)
    else:
        nv = 4 * n_slots
        stride = -(-nv // 8) * 8  # == nv except n_slots in {5, 7}
        per = (slots_cx, slots_cz, slots_kc, slots_id)
    ctab = np.zeros((cb, stride, CELL_LANES), np.float32)
    ctab[:, :nv] = (np.stack(per, 1).reshape(nv, cb, CELL_LANES)
                    .transpose(1, 0, 2))
    ctab = ctab.reshape(cb * stride, CELL_LANES)

    # attrs by global sphere id: mat, c0.rgb, attr, center.xyz — 8 values
    # in an 8-row stride per block.  The stride exists for Mosaic alignment
    # (blocks must start 8-aligned for the chunk lane-concat); rows 5-7
    # carry the sphere CENTER so winner resolution reads everything from
    # this one gather — no gtab center-select chain, no carried-center
    # dependence (the kernel still carries wcx/wcz for the paged backend's
    # shared state layout, but the grid resolve doesn't read them)
    s_tot = table.shape[0]
    ab = -(-s_tot // CELL_LANES)
    ids_pad = ab * CELL_LANES
    attrs = np.zeros((8, ids_pad), np.float32)
    attrs[0, :s_tot] = table[:, 11]  # mat
    attrs[1:4, :s_tot] = table[:, 13:16].T  # c0
    attrs[4, :s_tot] = table[:, 19]  # attr (fuzz / refraction index)
    attrs[5:8, :s_tot] = table[:, 0:3].T  # center (exact scene f32 values)
    atab = attrs.reshape(8, ab, CELL_LANES).transpose(1, 0, 2).reshape(8 * ab, CELL_LANES)

    # Textured FIELD spheres (checker on a small sphere): the fast path
    # reads tex/c1 from the tiny gttab select chain, which only covers
    # globals — scenes that texture field spheres get an extra per-sphere
    # ttab (tex, c1.rgb in an 8-row stride) resolved by one more gather.
    # Optional field: None costs nothing (the common case incl. the book).
    ttab = None
    if bool(np.any(np.asarray(scene.texture)[s_idx] != 0)):
        tvals = np.zeros((4, ids_pad), np.float32)
        tvals[0, :s_tot] = table[:, 12]  # tex
        tvals[1:4, :s_tot] = table[:, 16:19].T  # c1
        ttab = np.zeros((ab, 8, CELL_LANES), np.float32)
        ttab[:, :4] = tvals.reshape(4, ab, CELL_LANES).transpose(1, 0, 2)
        ttab = ttab.reshape(8 * ab, CELL_LANES)

    g_pad = max(4, len(g_idx))
    gtab = np.zeros((g_pad, 16), np.float32)
    gtab[:, 3] = POISON  # padding rows never hit
    gtab[:, 4] = -2.0  # padding idx matches no winner (real ids are >= 0)
    ng = len(g_idx)
    gtab[:ng, 0:3] = centers[g_idx]
    gtab[:ng, 3] = kc[g_idx]
    gtab[:ng, 4] = g_idx.astype(np.float32)
    gtab[:ng, 5] = np.asarray(scene.material)[g_idx].astype(np.float32)
    gtab[:ng, 6] = np.asarray(scene.texture)[g_idx].astype(np.float32)
    gtab[:ng, 7:10] = np.asarray(scene.color0, np.float32)[g_idx]
    gtab[:ng, 10:13] = np.asarray(scene.color1, np.float32)[g_idx]
    gtab[:ng, 13] = np.asarray(scene.attr)[g_idx].astype(np.float32)
    tex_rows = gtab[:ng][gtab[:ng, 6] != 0.0]
    gttab = np.zeros((max(1, tex_rows.shape[0]), 16), np.float32)
    gttab[:, 4] = -2.0  # padding idx matches no winner
    gttab[: tex_rows.shape[0]] = tex_rows

    y_lo = np.float32((cy - radii[s_idx]).min() - DELTA)
    y_hi = np.float32((cy + radii[s_idx]).max() + DELTA)
    gscal = np.zeros((1, 16), np.float32)
    gscal[0, G_XLO] = (np.float32(cmin_x) - 0.5) * s_pitch
    gscal[0, G_XHI] = (np.float32(cmax_x) + 0.5) * s_pitch
    gscal[0, G_YLO] = y_lo
    gscal[0, G_YHI] = y_hi
    gscal[0, G_ZLO] = (np.float32(cmin_z) - 0.5) * s_pitch
    gscal[0, G_ZHI] = (np.float32(cmax_z) + 0.5) * s_pitch
    gscal[0, G_CMINX] = np.float32(cmin_x)
    gscal[0, G_CMINZ] = np.float32(cmin_z)
    gscal[0, G_NCZ] = np.float32(ncz)
    gscal[0, G_CY] = np.float32(cy[0])
    gscal[0, G_CMAXX] = np.float32(cmax_x)
    gscal[0, G_CMAXZ] = np.float32(cmax_z)
    gscal[0, G_S] = s_pitch
    gscal[0, G_INVS] = np.float32(1.0) / s_pitch

    return GridTables(ctab=ctab, atab=atab, gtab=gtab, gttab=gttab,
                      gscal=gscal,
                      has_cy=np.zeros((1, n_slots), np.float32) if five
                      else None,
                      ttab=ttab,
                      slots4=(np.zeros((1, n_slots), np.float32)
                              if not five and n_slots != N_SLOTS else None))


class CellTables(NamedTuple):
    """The grid tables in the port's cell-major layout (``cell_major``).

    ``cells`` [cells_pad, stride] f32, one record per cell, a slot's values
    in one 16-byte group: the 4-value layout puts slot s at floats 4s..4s+3
    as (cx, cz, kc, sphere id), cy being the gscal scalar; the 5-value layout
    puts (cx, cy, cz, kc) there and the slot's sphere id at float
    4 * n_slots + s.  ``stride`` is the block-major one (pad8(w * n_slots)),
    which holds both; the floats past the used ones are 0.  ``attrs``
    [ids_pad, 8] f32 per sphere id: mat, c0.rgb, attr, center.xyz (atab's
    eight values); ``tattrs`` [ids_pad, 4]: tex, c1.rgb (ttab's four), or
    None.  ``gtab``, ``gttab`` and ``gscal`` are GridTables' own."""

    cells: object
    attrs: object
    gtab: object
    gttab: object
    gscal: object
    tattrs: object = None
    five: bool = False  # the 5-value slot layout (GridTables.has_cy set)
    n_slots: int = N_SLOTS


def cell_major(grid) -> CellTables:
    """``GridTables`` (the port's or the JAX package's, numpy fields) ->
    ``CellTables``, value for value."""
    five = grid.has_cy is not None
    n_slots = (grid.has_cy.shape[1] if five else
               grid.slots4.shape[1] if grid.slots4 is not None else N_SLOTS)
    w = 5 if five else 4
    stride = -(-w * n_slots // 8) * 8

    def per_entry(tab, rows):  # block-major [B * rows, 128] -> [B * 128, rows]
        tab = np.asarray(tab, np.float32)
        b = tab.shape[0] // rows
        return np.ascontiguousarray(
            tab.reshape(b, rows, CELL_LANES).transpose(0, 2, 1).reshape(b * CELL_LANES, rows))

    blk = per_entry(grid.ctab, stride)  # value v = slot * w + k of each cell
    if five:
        vals = blk[:, : 5 * n_slots].reshape(-1, n_slots, 5)
        cells = np.zeros_like(blk)
        cells[:, : 4 * n_slots] = vals[:, :, :4].reshape(-1, 4 * n_slots)
        cells[:, 4 * n_slots : 5 * n_slots] = vals[:, :, 4]
    else:
        cells = blk
    tattrs = None if grid.ttab is None else np.ascontiguousarray(per_entry(grid.ttab, 8)[:, :4])
    return CellTables(cells=cells, attrs=per_entry(grid.atab, 8),
                      gtab=np.asarray(grid.gtab, np.float32),
                      gttab=np.asarray(grid.gttab, np.float32),
                      gscal=np.asarray(grid.gscal, np.float32), tattrs=tattrs,
                      five=five, n_slots=int(n_slots))
