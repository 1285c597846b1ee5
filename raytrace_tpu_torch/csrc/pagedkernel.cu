// Paged-grid wavefront megakernel for Hopper (sm_90a): the dense-scene path.
//
// Replaces the Pallas TPU kernel `paged_megakernel_step` in
// raytrace_tpu/ops/pagedkernel.py (_kernel -> _kernel_body -> _iterate, with
// carry=True and no overflow table).  One thread owns one lane and runs
// `k_steps` iterations of the same per-lane state machine as the grid kernel,
// over the paged two-level grid (models/paged_grid.py): on a fresh segment
// the brute-forced globals, the slab clip and the fine-DDA init; then ONE
// fine cell per iteration -- its page is (icx >> 3) * nsczm + (icz >> 4), its
// column fc = ((icx & 7) << 4) | (icz & 15), and each candidate slot's values
// are loaded from geom[page][s * w + v][fc] and tested with the exact
// quadratic; where the winner improved, the winning slot's page-local id is
// loaded from lids[page][wslot][fc] and the winner's attributes from
// attrs[page][v * ab + (lid >> 7)][lid & 127] at once, and carried in
// registers until the segment ends; then shading, termination, and the
// running pixel sum `cur` flushed into the pixel's slot of the accumulator,
// and regeneration addressed by the lane's `lane0` row.
//
// The TPU kernel's per-128-lane page-box loops exist because a Mosaic lane
// gather addresses 128 entries; here every lane loads what it needs by
// index, so there is no box loop and no distinct-page walk.
//
// What bounds it on the card: dependent global loads -- up to n_slots x w
// candidate values per cell (the 100k-sphere field's tables are ~21 MB and
// stay in the 50 MB L2), then the lid and the attributes -- and divergence
// between lanes that march different cell counts or terminate at different
// depths; not FLOPs.  What the design does about it:
// - the driver (ops/trace.py:_render_band_paged) sorts the lanes by page
//   between launches and keeps only the live ones, so a warp's lanes read
//   few pages and no block is launched for dead lanes; this kernel writes
//   each lane's sort key (the Morton code of its page) in its epilogue, from
//   the registers that hold the ray and the cell;
// - the pixel sums live in a separate home-order accumulator, addressed by
//   pixel (m * n_lanes + lane0): a pixel has one lane and is flushed once,
//   so the add is the same f32 operation as a per-lane slot and needs no
//   atomics, and the lane state the driver moves is 40 rows, not 120;
// - the kernel is a template on the table layout (five values per slot,
//   textured field), so the carried attributes have a compile-time count and
//   live in registers, not in a stack frame.
//
// The section-cost probes (scripts/paged_iterbench.py): -DRT_ABLATE=<mask>
// builds a variant, the bits of ops/pagedkernel.py SWITCHES below; the
// production build has no mask and leaves every switch's code out.  The
// removals (CUT_*) replace a section with a passthrough of live values (the
// JAX package's meaning, which the plain version follows); FREEZE pins the
// march (the advance is consumed and the cell stays) and makes every live
// lane run every section each iteration -- the lid and attribute loads of
// every marching lane included, as the JAX kernel's freeze does -- with the
// results a lane's state does not take consumed through the launch's zero
// (rt::keep), where the production kernel skips them by branch.
//
// State: row-major [rows, n] tensors; f32 rows 0-2 o, 3-5 d, 6 fx, 7 fy, 8-10
// thr, 11 t_best, 12 t_end, 13 t_nx, 14 t_nz, 15 bkey, 16 wcx, 17 wcz, 18-20
// cur, 21 + i carried attr i, padding to rf; int32 rows (u32 bits) 0 seed,
// 1 m, 2 sidx, 3 depth, 4 alive, 5 marching, 6 cell (icx << 12 | icz),
// 7 lane0.  Output is written out of place; the accumulator [p_total, 3] is
// updated in place.
#include <cuda_runtime.h>

#include "wavefront.cuh"

namespace {

constexpr int R_TB = 11, R_TE = 12, R_TNX = 13, R_TNZ = 14, R_BKEY = 15;
constexpr int R_WCX = 16, R_WCZ = 17, R_CUR = 18, R_ATT = 21;
constexpr int U_MARCH = 5, U_CELL = 6, U_LANE0 = 7, U_ROWS = 8;
constexpr float TAG = 8388608.0f;  // 2^23: bkey >= TAG is a global winner
constexpr int BLOCK = 128;

#ifndef RT_ABLATE
#define RT_ABLATE 0
#endif
// the probe switches: bit i is ops/pagedkernel.py SWITCHES[i]
constexpr bool CUT_GLOBALS = RT_ABLATE & (1u << 0);
constexpr bool CUT_INIT = RT_ABLATE & (1u << 1);
constexpr bool CUT_FETCH = RT_ABLATE & (1u << 2);
constexpr bool CUT_QUAD = RT_ABLATE & (1u << 3);
constexpr bool CUT_RESOLVE = RT_ABLATE & (1u << 4);
constexpr bool CUT_GSEL = RT_ABLATE & (1u << 5);
constexpr bool CUT_SHADE = RT_ABLATE & (1u << 6);
constexpr bool CUT_TEA = RT_ABLATE & (1u << 7);
constexpr bool CUT_CAMERA = RT_ABLATE & (1u << 8);
constexpr bool FREEZE = RT_ABLATE & (1u << 9);

// the gscal slots and the sort key live in wavefront.cuh, where the band
// set-up (packstate.cu) computes the first key by the same function
using rt::P_XLO, rt::P_XHI, rt::P_YLO, rt::P_YHI, rt::P_ZLO, rt::P_ZHI;
using rt::P_FMINX, rt::P_FMINZ, rt::P_CY, rt::P_FMAXX, rt::P_FMAXZ;
using rt::P_INVS, rt::P_S, rt::P_NSCZM;
using rt::KEY_DEAD, rt::rebucket_key;

struct PagedParams {
  const int32_t* scal;
  const float* vpr;
  const float* gscal;  // [16]
  const float* gtab;  // [n_g, 16]: cx cy cz kc id mat tex c0.rgb c1.rgb attr
  const float* geom;  // [pages, w * n_slots, 128]
  const float* lids;  // [pages, n_slots, 128]
  const float* attrs;  // [pages, na * ab, 128]
  const float* fin;
  const int32_t* uin;
  float* acc;  // [p_total, 3], home (pixel) order
  float* fout;
  int32_t* uout;
  int32_t* key;  // [n]: the next re-bucket's sort key
  int n_g, n_slots, ab;
  int n, rf, m_slots, n_lanes, p_total, width, max_depth, k_steps;
  bool skip_tmax;
  rt::RR rr;
#if RT_ABLATE
  uint32_t zero;  // the probes' opaque zero (0 at run time)
#endif
};

__device__ __forceinline__ uint32_t probe_zero(const PagedParams& P) {
#if RT_ABLATE
  return P.zero;
#else
  return 0u;
#endif
}

__device__ __forceinline__ float ld(const float* p) { return __ldg(p); }

template <bool FIVE, bool TEXTURED>
__global__ void __launch_bounds__(BLOCK) paged_megakernel_step_kernel(PagedParams P) {
  constexpr int W = FIVE ? 4 : 3;  // values per candidate slot
  constexpr int NA = (FIVE ? 6 : 5) + (TEXTURED ? 4 : 0);  // carried attrs
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= P.n) return;
  const int n = P.n;
  if (P.uin[rt::U_ALIVE * n + lane] == 0) {
    for (int r = 0; r < P.rf; ++r) P.fout[r * n + lane] = P.fin[r * n + lane];
    for (int r = 0; r < U_ROWS; ++r) P.uout[r * n + lane] = P.uin[r * n + lane];
    P.key[lane] = KEY_DEAD;
    return;
  }

  const int spp = P.scal[rt::S_SPP];
  const uint32_t number = (uint32_t)P.scal[rt::S_NUMBER];
  const int y0 = P.scal[rt::S_Y0], seed_y0 = P.scal[rt::S_SEEDY0];
  const int offx = P.scal[rt::S_OFFX];
  const float* vpr = P.vpr;
  const float* gs = P.gscal;
  const float fminx = gs[P_FMINX], fminz = gs[P_FMINZ];
  const float fmaxx = gs[P_FMAXX], fmaxz = gs[P_FMAXZ];
  const int ifmaxx = (int)fmaxx, ifmaxz = (int)fmaxz;
  const float cy_u = gs[P_CY], inv_s = gs[P_INVS], cs = gs[P_S];
  const int nsczm = (int)gs[P_NSCZM];
  const int geom_rows = W * P.n_slots;
  const int attr_rows = NA * P.ab;

  float ox = P.fin[0 * n + lane], oy = P.fin[1 * n + lane], oz = P.fin[2 * n + lane];
  float dx = P.fin[3 * n + lane], dy = P.fin[4 * n + lane], dz = P.fin[5 * n + lane];
  float fx = P.fin[rt::R_FX * n + lane], fy = P.fin[rt::R_FY * n + lane];
  float tx = P.fin[(rt::R_THR + 0) * n + lane];
  float ty = P.fin[(rt::R_THR + 1) * n + lane];
  float tz = P.fin[(rt::R_THR + 2) * n + lane];
  float t_b = P.fin[R_TB * n + lane], t_end = P.fin[R_TE * n + lane];
  float t_nx = P.fin[R_TNX * n + lane], t_nz = P.fin[R_TNZ * n + lane];
  float bkey = P.fin[R_BKEY * n + lane];
  float wcx = P.fin[R_WCX * n + lane], wcz = P.fin[R_WCZ * n + lane];
  float cur_x = P.fin[(R_CUR + 0) * n + lane];
  float cur_y = P.fin[(R_CUR + 1) * n + lane];
  float cur_z = P.fin[(R_CUR + 2) * n + lane];
  float att[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) att[i] = P.fin[(R_ATT + i) * n + lane];
  uint32_t seed = (uint32_t)P.uin[rt::U_SEED * n + lane];
  int mrow = P.uin[rt::U_M * n + lane];
  int sidx = P.uin[rt::U_SIDX * n + lane];
  int depth = P.uin[rt::U_DEPTH * n + lane];
  bool alive = true;
  bool marching = P.uin[U_MARCH * n + lane] != 0;
  int cell = P.uin[U_CELL * n + lane];
  const int lane0 = P.uin[U_LANE0 * n + lane];
  [[maybe_unused]] const uint32_t z = probe_zero(P);

  for (int it = 0; it < P.k_steps && alive; ++it) {
    const rt::RayTerms q = rt::ray_terms(ox, oy, oz, dx, dy, dz);

    // ---- segment start: globals + clip + fine-DDA init --------------------
    const bool need = !marching;
    // FREEZE: a marching lane runs the segment start too and keeps none of it
    [[maybe_unused]] const float f_tb = t_b, f_bkey = bkey, f_te = t_end;
    [[maybe_unused]] const float f_tnx = t_nx, f_tnz = t_nz;
    [[maybe_unused]] const int f_cell = cell;
    if (FREEZE || need) {
      t_b = rt::BIG;
      bkey = TAG;
      if constexpr (!CUT_GLOBALS) {
        for (int k = 0; k < P.n_g; ++k) {
          const float* g = P.gtab + 16 * k;
          const float tc = rt::quadratic(q, ld(g + 0), ld(g + 1), ld(g + 2), ld(g + 3),
                                         P.skip_tmax);
          if (tc < t_b) {
            t_b = tc;
            bkey = TAG + ld(g + 4);
          }
        }
      }
    }
    // one reciprocal per axis, shared by the slab clip and the DDA steps
    const float inv_x = 1.0f / dx, inv_y = 1.0f / dy, inv_z = 1.0f / dz;
    if constexpr (!CUT_INIT) {
      if (FREEZE || need) {
        float t0x, t1x, t0y, t1y, t0z, t1z;
        rt::slab_inv(ox, dx, inv_x, gs[P_XLO], gs[P_XHI], t0x, t1x);
        rt::slab_inv(oy, dy, inv_y, gs[P_YLO], gs[P_YHI], t0y, t1y);
        rt::slab_inv(oz, dz, inv_z, gs[P_ZLO], gs[P_ZHI], t0z, t1z);
        const float t_start = rt::jmax(rt::jmax(t0x, t0y), rt::jmax(t0z, rt::T_MIN));
        const float t_end_n = rt::jmin(rt::jmin(t1x, t1y), t1z);
        t_end = t_end_n;
        if (t_start <= t_end_n && t_start < t_b) {  // march0
          const float px0 = ox + t_start * dx;
          const float pz0 = oz + t_start * dz;
          const float icx_n = rt::jmin(rt::jmax(floorf((px0 - fminx) * inv_s), 0.0f), fmaxx);
          const float icz_n = rt::jmin(rt::jmax(floorf((pz0 - fminz) * inv_s), 0.0f), fmaxz);
          const float bx = fminx + (icx_n + (dx >= 0.0f ? 1.0f : 0.0f)) * cs;
          const float bz = fminz + (icz_n + (dz >= 0.0f ? 1.0f : 0.0f)) * cs;
          t_nx = dx == 0.0f ? rt::BIG : (bx - ox) * inv_x;
          t_nz = dz == 0.0f ? rt::BIG : (bz - oz) * inv_z;
          cell = ((int)icx_n << 12) | (int)icz_n;
          marching = true;
        }
      }
    }
    if constexpr (FREEZE) {
      if (!need) {
        t_b = rt::keep(f_tb, t_b, z);
        bkey = rt::keep(f_bkey, bkey, z);
        t_end = rt::keep(f_te, t_end, z);
        t_nx = rt::keep(f_tnx, t_nx, z);
        t_nz = rt::keep(f_tnz, t_nz, z);
        cell = rt::keep(f_cell, cell, z);
      }
    }

    // ---- fine-DDA march: one cell ------------------------------------------
    // FREEZE: every lane marches, and a lane that was not marching keeps
    // its winner; every marching lane loads its winning slot's lid and
    // attributes; the advance is consumed and the cell stays
    const bool m0 = marching;
    [[maybe_unused]] const float m_tb = t_b, m_bkey = bkey, m_wcx = wcx, m_wcz = wcz;
    [[maybe_unused]] float m_att[NA];
    if constexpr (FREEZE) {
#pragma unroll
      for (int i = 0; i < NA; ++i) m_att[i] = att[i];
    }
    if (FREEZE || marching) {
      int icx = cell >> 12, icz = cell & 4095;
      const int sxm = icx >> 3, szm = icz >> 4;
      const int fc = ((icx & 7) << 4) | (icz & 15);
      const size_t page = (size_t)(sxm * nsczm + szm);
      const float* gp = P.geom + page * geom_rows * 128 + fc;
      bool upd_any = false;
      int wslot = 0;
      for (int s = 0; s < P.n_slots; ++s) {
        const int b0 = W * s;
        float s_cx, s_cy, s_cz, s_kc;
        if constexpr (CUT_FETCH) {  // no slot values: every one is ox
          s_cx = ox;
          s_cy = FIVE ? ox : cy_u;
          s_cz = ox;
          s_kc = ox;
        } else {
          s_cx = ld(gp + b0 * 128);
          s_cy = FIVE ? ld(gp + (b0 + 1) * 128) : cy_u;
          s_cz = ld(gp + (b0 + W - 2) * 128);
          s_kc = ld(gp + (b0 + W - 1) * 128);
        }
        float tc;
        if constexpr (CUT_QUAD)  // the slot's other values consumed
          tc = rt::keep(rt::keep(s_cx + oy, s_cy, z), s_kc, z);
        else
          tc = rt::quadratic(q, s_cx, s_cy, s_cz, s_kc, P.skip_tmax);
        if (tc < t_b) {
          t_b = tc;
          wslot = s;
          wcx = s_cx;
          wcz = s_cz;
          upd_any = true;
        }
      }
      [[maybe_unused]] const float u_bkey = bkey;
      [[maybe_unused]] float u_att[NA];
      if constexpr (FREEZE) {
#pragma unroll
        for (int i = 0; i < NA; ++i) u_att[i] = att[i];
      }
      if (FREEZE || upd_any) {  // the winner improved in this cell: lid, then attrs
        float lid_w;
        if constexpr (CUT_FETCH) lid_w = ox;
        else lid_w = ld(P.lids + (page * P.n_slots + wslot) * 128 + fc);
        const float pkey = (float)(sxm * 32 + szm) * 512.0f;
        bkey = pkey + lid_w;
        const int lid = (int)bkey & 511;
        int blk = lid >> 7;
        // outside the page's blocks the JAX block select reads block 0
        if constexpr (CUT_FETCH || FREEZE) blk = blk < P.ab ? blk : 0;
        const float* ap = P.attrs + page * attr_rows * 128 + (lid & 127);
#pragma unroll
        for (int v = 0; v < NA; ++v) {
          if constexpr (CUT_RESOLVE) att[v] = bkey;
          else att[v] = ld(ap + (v * P.ab + blk) * 128);
        }
        if constexpr (FREEZE) {
          if (!upd_any) {
            bkey = rt::keep(u_bkey, bkey, z);
#pragma unroll
            for (int i = 0; i < NA; ++i) att[i] = rt::keep(u_att[i], att[i], z);
          }
        }
      }
      const float dt_x = dx == 0.0f ? rt::BIG : fabsf(cs * inv_x);
      const float dt_z = dz == 0.0f ? rt::BIG : fabsf(cs * inv_z);
      const float t_exit = rt::jmin(t_nx, t_nz);
      const bool cont = t_exit < t_b && t_exit < t_end;
      [[maybe_unused]] const int a_icx = icx, a_icz = icz;
      [[maybe_unused]] const float a_tnx = t_nx, a_tnz = t_nz;
      if (cont) {
        if (t_nx <= t_nz) {
          icx = min(max(icx + (dx >= 0.0f ? 1 : -1), 0), ifmaxx);
          t_nx = t_nx + dt_x;
        } else {
          icz = min(max(icz + (dz >= 0.0f ? 1 : -1), 0), ifmaxz);
          t_nz = t_nz + dt_z;
        }
      }
      if constexpr (FREEZE) {
        icx = rt::keep(a_icx, icx, z);
        icz = rt::keep(a_icz, icz, z);
        t_nx = rt::keep(a_tnx, t_nx, z);
        t_nz = rt::keep(a_tnz, t_nz, z);
      }
      cell = (icx << 12) | icz;
      if constexpr (FREEZE) marching = rt::keep(marching, cont, z);
      else marching = cont;
    }
    if constexpr (FREEZE) {
      if (!m0) {
        t_b = rt::keep(m_tb, t_b, z);
        bkey = rt::keep(m_bkey, bkey, z);
        wcx = rt::keep(m_wcx, wcx, z);
        wcz = rt::keep(m_wcz, wcz, z);
#pragma unroll
        for (int i = 0; i < NA; ++i) att[i] = rt::keep(m_att[i], att[i], z);
      }
    }
    if (marching) {
      if constexpr (!FREEZE) continue;  // segment still open: nothing else changes
    }
    // FREEZE: a lane still marching runs the rest too and keeps none of it
    [[maybe_unused]] const bool frozen = marching;
    [[maybe_unused]] const float f_ox = ox, f_oy = oy, f_oz = oz;
    [[maybe_unused]] const float f_dx = dx, f_dy = dy, f_dz = dz;
    [[maybe_unused]] const float f_fx = fx, f_fy = fy, f_tx = tx, f_ty = ty, f_tz = tz;
    [[maybe_unused]] const float f_cx = cur_x, f_cy = cur_y, f_cz = cur_z;
    [[maybe_unused]] const uint32_t f_seed = seed;
    [[maybe_unused]] const int f_mrow = mrow, f_sidx = sidx, f_depth = depth;

    // ---- winner resolution: globals from gtab, grid winners carried -------
    const bool hit = t_b < rt::BIG;
    rt::Hit h;
    if constexpr (!FREEZE) {
      if (bkey >= TAG) {
        const float bidx_f = bkey - TAG;
        const float* g = P.gtab;  // row 0 unless a later row's id matches
        if constexpr (!CUT_GSEL) {
          for (int k = 1; k < P.n_g; ++k)
            if (bidx_f == ld(P.gtab + 16 * k + 4)) g = P.gtab + 16 * k;
        }
        h.cenx = ld(g + 0); h.ceny = ld(g + 1); h.cenz = ld(g + 2);
        h.mat = ld(g + 5); h.tex = ld(g + 6);
        h.c0x = ld(g + 7); h.c0y = ld(g + 8); h.c0z = ld(g + 9);
        h.c1x = ld(g + 10); h.c1y = ld(g + 11); h.c1z = ld(g + 12);
        h.fuzz = ld(g + 13);
      } else {
        h.cenx = wcx;
        h.ceny = FIVE ? att[FIVE ? 5 : 0] : cy_u;  // the center y of a varied field
        h.cenz = wcz;
        h.mat = att[0];
        h.c0x = att[1]; h.c0y = att[2]; h.c0z = att[3];
        h.fuzz = att[4];
        // tex, c1.rgb are the last four carried attrs of a textured field
        h.tex = TEXTURED ? att[NA - 4] : 0.0f;
        h.c1x = TEXTURED ? att[NA - 3] : 0.0f;
        h.c1y = TEXTURED ? att[NA - 2] : 0.0f;
        h.c1z = TEXTURED ? att[NA - 1] : 0.0f;
      }
    } else {  // FREEZE: every lane selects its global row too (CUT_GSEL: row 0)
      const float bidx_f = bkey - TAG;
      const float* g = P.gtab;
      if constexpr (!CUT_GSEL) {
        for (int k = 1; k < P.n_g; ++k)
          if (bidx_f == ld(P.gtab + 16 * k + 4)) g = P.gtab + 16 * k;
      }
      const bool direct = bkey >= TAG;
      const float gv[12] = {ld(g + 0), ld(g + 1), ld(g + 2), ld(g + 5), ld(g + 6), ld(g + 7),
                            ld(g + 8), ld(g + 9), ld(g + 10), ld(g + 11), ld(g + 12),
                            ld(g + 13)};
      const float cv[12] = {wcx, FIVE ? att[FIVE ? 5 : 0] : cy_u, wcz, att[0],
                            TEXTURED ? att[NA - 4] : 0.0f, att[1], att[2], att[3],
                            TEXTURED ? att[NA - 3] : 0.0f, TEXTURED ? att[NA - 2] : 0.0f,
                            TEXTURED ? att[NA - 1] : 0.0f, att[4]};
      float hv[12];
#pragma unroll
      for (int i = 0; i < 12; ++i) hv[i] = rt::keep(direct ? gv[i] : cv[i], gv[i], z);
      h.cenx = hv[0]; h.ceny = hv[1]; h.cenz = hv[2];
      h.mat = hv[3]; h.tex = hv[4];
      h.c0x = hv[5]; h.c0y = hv[6]; h.c0z = hv[7];
      h.c1x = hv[8]; h.c1y = hv[9]; h.c1z = hv[10];
      h.fuzz = hv[11];
    }
    rt::Shade s;
    if constexpr (CUT_SHADE) {  // the ray passes through: point o, albedo and scatter d
      // (the winner's attributes consumed, so their loads stay)
      s.px = rt::keep(ox, rt::keep(h.mat, rt::keep(h.c0x, rt::keep(h.c0y, h.c0z, z), z), z),
                      z);
      s.py = rt::keep(oy, rt::keep(h.fuzz, rt::keep(h.cenx, rt::keep(h.ceny, h.cenz, z), z), z),
                      z);
      s.pz = rt::keep(oz, rt::keep(h.tex, rt::keep(h.c1x, rt::keep(h.c1y, h.c1z, z), z), z),
                      z);
      s.ax = dx; s.ay = dy; s.az = dz;
      s.sdx = dx; s.sdy = dy; s.sdz = dz;
      s.does_scatter = hit;
      s.seed_h = seed;
    } else {
      s = rt::shade(q, t_b, seed, h);
    }

    // ---- termination & accumulation (shader.rgen:70-89) -------------------
    const bool deep = depth + 1 >= P.max_depth;
    bool cont = hit && s.does_scatter && !deep;
    float ntx = tx * s.ax, nty = ty * s.ay, ntz = tz * s.az;
    bool considered = false;
    uint32_t seed_rr = 0u;
    if (P.rr.on) {
      const int dnext = depth + 1;
      const float p = rt::rr_probability(ntx, nty, ntz, dnext, P.rr);
      considered = cont && dnext >= P.rr.d0;
      seed_rr = hit ? s.seed_h : seed;
      const float u_rr = rt::random_float(seed_rr);
      if (considered && u_rr >= p) cont = false;
      if (considered) {
        ntx = ntx / p;
        nty = nty / p;
        ntz = ntz / p;
      }
    }
    const bool term = !cont;
    if (term) {
      const float lx = hit ? (s.does_scatter ? 0.0f : s.ax) : rt::SKY_R;
      const float ly = hit ? (s.does_scatter ? 0.0f : s.ay) : rt::SKY_G;
      const float lz = hit ? (s.does_scatter ? 0.0f : s.az) : rt::SKY_B;
      cur_x = cur_x + tx * lx;
      cur_y = cur_y + ty * ly;
      cur_z = cur_z + tz * lz;
    }
    uint32_t seed_a = hit ? s.seed_h : seed;
    if (considered) seed_a = seed_rr;

    // ---- flush the finished pixel's sum into its accumulator slot --------
    const bool more = term && sidx < spp;
    const bool pix_done = term && !more;
    if (pix_done) {
      const int pix = mrow * P.n_lanes + lane0;
      if ((!FREEZE || !frozen) && mrow >= 0 && mrow < P.m_slots && pix < P.p_total) {
        float* a = P.acc + 3 * (size_t)pix;
        a[0] = a[0] + cur_x;
        a[1] = a[1] + cur_y;
        a[2] = a[2] + cur_z;
      }
      cur_x = 0.0f;
      cur_y = 0.0f;
      cur_z = 0.0f;
    }

    // ---- regen, addressed by lane0 ----------------------------------------
    const int m2 = mrow + (pix_done ? 1 : 0);
    const int pix2 = m2 * P.n_lanes + lane0;
    const bool adv = pix_done && m2 < P.m_slots && pix2 < P.p_total;
    const bool regen = more || adv;
    if constexpr (!FREEZE) {
      if (cont) {
        float bx = s.sdx, by = s.sdy, bz = s.sdz;
        rt::norm3(bx, by, bz);
        ox = s.px; oy = s.py; oz = s.pz;
        dx = bx; dy = by; dz = bz;
        tx = ntx; ty = nty; tz = ntz;
        seed = seed_a;
        depth = depth + 1;
      } else if (regen) {
        uint32_t seed_c = seed_a;
        if (adv) {
          const int px2 = pix2 % P.width, py2 = pix2 / P.width;
          fx = (float)(offx + px2);
          fy = (float)(y0 + py2);
          if constexpr (CUT_TEA) seed_c = seed;
          else seed_c = rt::pixel_seed(px2, seed_y0 + py2, number);
        }
        if constexpr (!CUT_CAMERA) {
          const rt::Ray r = rt::camera_ray(seed_c, fx, fy, vpr);
          ox = r.ox; oy = r.oy; oz = r.oz;
          dx = r.dx; dy = r.dy; dz = r.dz;
        }
        tx = 1.0f; ty = 1.0f; tz = 1.0f;
        seed = seed_c;
        depth = 0;
      } else {
        seed = seed_a;
      }
    } else {
      // FREEZE: every lane hashes its next pixel's seed and casts its camera
      // ray; each keeps what its branch takes
      const int px2 = pix2 % P.width, py2 = pix2 / P.width;
      const float fxn = adv ? (float)(offx + px2) : fx;
      const float fyn = adv ? (float)(y0 + py2) : fy;
      uint32_t fresh = seed;
      if constexpr (!CUT_TEA) fresh = rt::pixel_seed(px2, seed_y0 + py2, number);
      uint32_t seed_c = rt::keep(adv ? fresh : seed_a, fresh, z);
      rt::Ray r{ox, oy, oz, dx, dy, dz};
      if constexpr (!CUT_CAMERA) r = rt::camera_ray(seed_c, fxn, fyn, vpr);
      fx = fxn;
      fy = fyn;
      if (cont) {
        float bx = s.sdx, by = s.sdy, bz = s.sdz;
        rt::norm3(bx, by, bz);
        ox = s.px; oy = s.py; oz = s.pz;
        dx = bx; dy = by; dz = bz;
        tx = ntx; ty = nty; tz = ntz;
        seed = seed_a;
        depth = depth + 1;
      } else if (regen) {
        ox = r.ox; oy = r.oy; oz = r.oz;
        dx = r.dx; dy = r.dy; dz = r.dz;
        tx = 1.0f; ty = 1.0f; tz = 1.0f;
        seed = seed_c;
        depth = 0;
      } else {
        seed = seed_a;
      }
      ox = rt::keep(ox, r.ox, z); oy = rt::keep(oy, r.oy, z); oz = rt::keep(oz, r.oz, z);
      dx = rt::keep(dx, r.dx, z); dy = rt::keep(dy, r.dy, z); dz = rt::keep(dz, r.dz, z);
      seed = rt::keep(seed, seed_c, z);
    }
    mrow = m2;
    sidx = adv ? 1 : sidx + (more ? 1 : 0);
    alive = cont || regen;
    if constexpr (FREEZE) {
      if (frozen) {
        ox = rt::keep(f_ox, ox, z); oy = rt::keep(f_oy, oy, z); oz = rt::keep(f_oz, oz, z);
        dx = rt::keep(f_dx, dx, z); dy = rt::keep(f_dy, dy, z); dz = rt::keep(f_dz, dz, z);
        fx = rt::keep(f_fx, fx, z); fy = rt::keep(f_fy, fy, z);
        tx = rt::keep(f_tx, tx, z); ty = rt::keep(f_ty, ty, z); tz = rt::keep(f_tz, tz, z);
        cur_x = rt::keep(f_cx, cur_x, z); cur_y = rt::keep(f_cy, cur_y, z);
        cur_z = rt::keep(f_cz, cur_z, z);
        seed = rt::keep(f_seed, seed, z);
        mrow = rt::keep(f_mrow, mrow, z); sidx = rt::keep(f_sidx, sidx, z);
        depth = rt::keep(f_depth, depth, z);
        alive = rt::keep(true, alive, z);
      }
    }
  }

  P.fout[0 * n + lane] = ox; P.fout[1 * n + lane] = oy; P.fout[2 * n + lane] = oz;
  P.fout[3 * n + lane] = dx; P.fout[4 * n + lane] = dy; P.fout[5 * n + lane] = dz;
  P.fout[rt::R_FX * n + lane] = fx;
  P.fout[rt::R_FY * n + lane] = fy;
  P.fout[(rt::R_THR + 0) * n + lane] = tx;
  P.fout[(rt::R_THR + 1) * n + lane] = ty;
  P.fout[(rt::R_THR + 2) * n + lane] = tz;
  P.fout[R_TB * n + lane] = t_b;
  P.fout[R_TE * n + lane] = t_end;
  P.fout[R_TNX * n + lane] = t_nx;
  P.fout[R_TNZ * n + lane] = t_nz;
  P.fout[R_BKEY * n + lane] = bkey;
  P.fout[R_WCX * n + lane] = wcx;
  P.fout[R_WCZ * n + lane] = wcz;
  P.fout[(R_CUR + 0) * n + lane] = cur_x;
  P.fout[(R_CUR + 1) * n + lane] = cur_y;
  P.fout[(R_CUR + 2) * n + lane] = cur_z;
#pragma unroll
  for (int i = 0; i < NA; ++i) P.fout[(R_ATT + i) * n + lane] = att[i];
  for (int r = R_ATT + NA; r < P.rf; ++r) P.fout[r * n + lane] = P.fin[r * n + lane];
  P.uout[rt::U_SEED * n + lane] = (int32_t)seed;
  P.uout[rt::U_M * n + lane] = mrow;
  P.uout[rt::U_SIDX * n + lane] = sidx;
  P.uout[rt::U_DEPTH * n + lane] = depth;
  P.uout[rt::U_ALIVE * n + lane] = alive ? 1 : 0;
  P.uout[U_MARCH * n + lane] = marching ? 1 : 0;
  P.uout[U_CELL * n + lane] = cell;
  P.uout[U_LANE0 * n + lane] = lane0;
  P.key[lane] = rebucket_key(gs, alive, marching, cell, ox, oy, oz, dx, dy, dz);
}

}  // namespace

// Launches one step over the n lanes of the state on `stream`; returns
// cudaGetLastError() of the launch.  `zero` (always 0) is read by the probe
// variants only.
extern "C" int rt_paged_megakernel_step(
    const int32_t* scal, const float* vpr, const float* gscal, const float* gtab,
    const float* geom, const float* lids, const float* attrs,
    const float* fin, const int32_t* uin, float* acc, float* fout, int32_t* uout,
    int32_t* key, int n_g, int five, int textured, int n_slots, int ab,
    int n, int rf, int m_slots, int n_lanes, int p_total, int width,
    int max_depth, int k_steps, int skip_tmax, int zero,
    int rr_on, int rr_d0, int rr_d1, float rr_pmin, int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  if (n == 0) return 0;
  PagedParams P{scal, vpr, gscal, gtab, geom, lids, attrs, fin, uin, acc, fout, uout,
                key, n_g, n_slots, ab, n, rf, m_slots, n_lanes, p_total, width,
                max_depth, k_steps, skip_tmax != 0, rt::RR{rr_on, rr_d0, rr_d1, rr_pmin}};
#if RT_ABLATE
  P.zero = (uint32_t)zero;
#else
  (void)zero;
#endif
  const int grid = (n + BLOCK - 1) / BLOCK;
  const cudaStream_t st = (cudaStream_t)stream;
  if (five && textured)
    paged_megakernel_step_kernel<true, true><<<grid, BLOCK, 0, st>>>(P);
  else if (five)
    paged_megakernel_step_kernel<true, false><<<grid, BLOCK, 0, st>>>(P);
  else if (textured)
    paged_megakernel_step_kernel<false, true><<<grid, BLOCK, 0, st>>>(P);
  else
    paged_megakernel_step_kernel<false, false><<<grid, BLOCK, 0, st>>>(P);
  return (int)cudaGetLastError();
}
