// Grid-DDA wavefront megakernel for Hopper (sm_90a): the render main path.
//
// Replaces the Pallas TPU kernel `grid_megakernel_step` in
// raytrace_tpu/ops/gridkernel.py (_kernel -> _kernel_body -> _iterate).
// It computes what that kernel computes, not a block-by-block copy: one
// thread owns one lane and runs `k_steps` iterations of the same per-lane
// state machine -- on a fresh segment the brute-forced globals, the slab clip
// and the DDA init; then up to `j_steps` Amanatides-Woo cells per iteration,
// each cell's candidates tested with the exact quadratic; winner attributes
// by sphere id; shading, termination, the running pixel sum `cur` flushed
// into the pixel's slot of a home-order accumulator, and regeneration.
//
// What bounds it on the card: not FLOPs (its bound counts ~22 operations a
// quadratic) but executing a long, divergent per-lane program -- three
// phases (segment start with 18 book globals, the cell march, ~150
// operations of shading) that lanes of one warp reach in different
// iterations -- and the chains of dependent loads it waits on (a cell's
// candidates, then the winner's attributes).  What the design does:
// - tables in the cell-major layout of models/grid.py:cell_major: a cell's
//   slots are one record read with 16-byte loads (book: 64 B, four LDG.128,
//   all in flight before the first quadratic), a sphere's attributes two
//   16-byte loads (a textured field's tex/c1 one more), where the TPU's
//   block-major layout needed one 4-byte load per value 512 bytes apart;
// - the globals (and the textured globals' tex/c1) staged once per block
//   in shared memory, read as broadcast 16-byte loads;
// - a miss skips the root (`rt::quadratic`), and a miss's shading skips
//   the checker's sinf (wavefront.cuh);
// - no accumulator rows in the lane state: a finished pixel's sum is added
//   into `acc` [p_total, 3] at its home index (one writer per pixel, no
//   atomics), so a lane moves 19 + 9 rows in and out, and the driver
//   (ops/trace.py:_render_band_mega) launches over the live lanes only;
// - `__launch_bounds__(128, 8)` (the default block): 64 registers (and a
//   104-byte frame, 72 bytes of it spills) for 8 resident blocks per SM
//   instead of 84 registers for 5 -- the fastest of 1, 6, 7, 8 and 10
//   blocks on the card, and faster than staging the cells and attributes
//   (48 KB for the book) in shared memory (PERF.md).
// Left as it is: 14 of the book's 18 globals are the small spheres of one
// boundary cell line that models/grid.py:build_grid moves out of the grid
// to save the TPU kernel a fetch block; every segment start tests them, and
// they are ~85% of the quadratics the book needs (ROADMAP).
//
// In-kernel call merge: a launch renders `n_calls` progressive calls per
// pixel back to back (numbers number..number+n_calls-1, `spp` samples each,
// `spp_last` in the last), flushing `cur` into the accumulator at every call
// boundary, so the accumulator sees the host loop's adds in the host loop's
// order.  The fresh TEA seed of a renewed lane (next call of its pixel, or
// its next pixel) is computed inline where the TPU kernel hoists it into
// state rows: the same hash of the same operands.  A lane's pixels come
// from `lane_pixel`: M strided pixels, or the balanced table `passign`
// [m_slots, tab_n] (runtime/balance.py), indexed by slot and home index.
// ITER is the iterstats probe: red counts the issued iterations of the
// lane's current (pixel, call) chunk instead of colour.
//
// The section-cost probes (scripts/grid_ablate.py, grid_iterbench.py):
// -DRT_ABLATE=<mask> builds a variant, the bits of ops/gridkernel.py
// SWITCHES below; the production build has no mask, and every switch is a
// compile-time false that leaves its code out.  Duplications (GLOBAL2 ...
// CAMERA2) run a section a second time on inputs made opaque with the
// launch's zero `z` and consume the result with rt::keep, so the image is
// bit-identical; removals (CUT_*) replace a section with a passthrough of
// live values (the JAX package's meaning, which the plain version follows);
// FREEZE pins the march (a cell's advance is consumed and the cell stays)
// and makes every live lane run every section each iteration, the results a
// lane's state does not take consumed, where the production kernel skips
// them by branch.
//
// State: row-major [rows, n] tensors; f32 rows 0-2 o, 3-5 d, 6 fx, 7 fy,
// 8-10 thr, 11 t_best, 12 t_end, 13 t_nx, 14 t_nz, 15 bkey, 16-18 cur;
// int32 rows (u32 bits) 0 seed, 1 m, 2 sidx, 3 depth, 4 alive, 5 marching,
// 6 icx, 7 icz, 8 lane0 (the lane's home index), 9 call (the progressive
// call within the launch's merge).  Output is written out of place; the
// accumulator is updated in place.
#include <cuda_runtime.h>

#include "wavefront.cuh"

namespace {

constexpr int R_TB = 11, R_TE = 12, R_TNX = 13, R_TNZ = 14, R_BKEY = 15;
constexpr int R_CUR = 16, F_ROWS = 19;
constexpr int U_MARCH = 5, U_ICX = 6, U_ICZ = 7, U_LANE0 = 8, U_CALL = 9, U_ROWS = 10;
constexpr int S_NCALLS = 5, S_SPPLAST = 6;  // scal slots of the call merge
constexpr float TAG = 4096.0f;  // bkey >= TAG: global winner TAG + id
// Threads per block, a define of this translation unit (_build.py passes
// -DRT_GRID_BLOCK: the autotuner's block sweep builds one library per
// value).  BLOCK x MIN_BLOCKS stays 1024 threads per SM asked of ptxas, so a
// thread keeps 64 registers whatever the block.
#ifndef RT_GRID_BLOCK
#define RT_GRID_BLOCK 128
#endif
constexpr int BLOCK = RT_GRID_BLOCK;
static_assert(BLOCK >= 32 && BLOCK % 32 == 0 && 1024 % BLOCK == 0,
              "RT_GRID_BLOCK: a multiple of 32 dividing 1024");
constexpr int MIN_BLOCKS = 1024 / BLOCK;  // resident blocks per SM asked of ptxas
constexpr int MAX_G = 32;  // models/grid.py MAX_GTAB: rows of gtab and gttab

#ifndef RT_ABLATE
#define RT_ABLATE 0
#endif
// the probe switches: bit i is ops/gridkernel.py SWITCHES[i]
constexpr bool GLOBAL2 = RT_ABLATE & (1u << 0);
constexpr bool FETCH2 = RT_ABLATE & (1u << 1);
constexpr bool ISECT2 = RT_ABLATE & (1u << 2);
constexpr bool DDA2 = RT_ABLATE & (1u << 3);
constexpr bool RESOLVE2 = RT_ABLATE & (1u << 4);
constexpr bool SHADE2 = RT_ABLATE & (1u << 5);
constexpr bool CAMERA2 = RT_ABLATE & (1u << 6);
constexpr bool CUT_TEA = RT_ABLATE & (1u << 7);
constexpr bool CUT_GLOBALS = RT_ABLATE & (1u << 8);
constexpr bool CUT_INIT = RT_ABLATE & (1u << 9);
constexpr bool CUT_FETCH = RT_ABLATE & (1u << 10);
constexpr bool CUT_QUAD = RT_ABLATE & (1u << 11);
constexpr bool CUT_RESOLVE = RT_ABLATE & (1u << 12);
constexpr bool CUT_SHADE = RT_ABLATE & (1u << 13);
constexpr bool CUT_SIN = RT_ABLATE & (1u << 14);
constexpr bool CUT_CAMERA = RT_ABLATE & (1u << 15);
constexpr bool FREEZE = RT_ABLATE & (1u << 16);

struct Probe {  // a variant's launch values: the opaque zero, the table sizes
  uint32_t zero;
  int n_cells, n_ids;
};

// gscal slots (models/grid.py G_*)
constexpr int G_XLO = 0, G_XHI = 1, G_YLO = 2, G_YHI = 3, G_ZLO = 4, G_ZHI = 5;
constexpr int G_CMINX = 6, G_CMINZ = 7, G_NCZ = 8, G_CY = 9, G_CMAXX = 10,
              G_CMAXZ = 11, G_S = 12, G_INVS = 13;

struct GridParams {
  const int32_t* scal;
  const float* vpr;
  const float* gscal;  // [16]
  const float* gtab;  // [n_g, 16]: cx cy cz kc id ...
  const float* gttab;  // [n_gt, 16]: textured globals (id at 4, tex 6, c1 10-12)
  const float4* cells;  // [cells, stride4] cell records (models/grid.py CellTables)
  const float4* attrs;  // [ids, 2]: (mat, c0.rgb), (attr, center.xyz)
  const float4* tattrs;  // [ids]: (tex, c1.rgb) -- or null
  const int32_t* passign;  // [m_slots, tab_n] pixel of (slot, home index) -- or null
  const float* fin;
  const int32_t* uin;
  float* acc;  // [p_total, 3], home (pixel) order
  float* fout;
  int32_t* uout;
  int n_g, n_gt, n_slots, stride4;
  int n, m_slots, n_lanes, p_total, width, max_depth, k_steps, j_steps, tab_n;
  bool skip_tmax;
  rt::RR rr;
#if RT_ABLATE
  Probe pr;
#endif
};

__device__ __forceinline__ Probe probe(const GridParams& P) {
#if RT_ABLATE
  return P.pr;
#else
  return Probe{0u, 0, 0};
#endif
}

// The pixel of slot m of the lane with home index lane0: M strided pixels
// per lane (ops/trace.py), or the balanced table's entry; p_total (no
// pixel) for a slot past the last, which the table has no row for.
__device__ __forceinline__ int lane_pixel(const GridParams& P, int m, int lane0) {
  if (P.passign == nullptr) return m * P.n_lanes + lane0;
  if (m < 0 || m >= P.m_slots) return P.p_total;
  return __ldg(P.passign + (size_t)m * P.tab_n + lane0);
}

// FIVE: the 5-value slot layout; NS > 0: exactly NS slots per cell, loaded
// before the first test (else P.n_slots, one at a time); ITER: the
// iterstats probe.
template <bool FIVE, int NS, bool ITER>
__global__ void __launch_bounds__(BLOCK, MIN_BLOCKS) grid_megakernel_step_kernel(GridParams P) {
  __shared__ float4 s_g[MAX_G];  // globals: cx cy cz kc
  __shared__ float s_gid[MAX_G];
  __shared__ float4 s_gt[MAX_G];  // textured globals: tex c1.rgb
  __shared__ float s_gtid[MAX_G];
  // the launch's scalars, read where they are used (at a chunk's end and a
  // lane's renewal) rather than held in registers through the loop
  __shared__ int32_t s_scal[8];
  if (threadIdx.x < 8) s_scal[threadIdx.x] = P.scal[threadIdx.x];
  for (int k = threadIdx.x; k < P.n_g; k += BLOCK) {
    const float* g = P.gtab + 16 * k;
    s_g[k] = make_float4(g[0], g[1], g[2], g[3]);
    s_gid[k] = g[4];
  }
  for (int k = threadIdx.x; k < P.n_gt; k += BLOCK) {
    const float* g = P.gttab + 16 * k;
    s_gt[k] = make_float4(g[6], g[10], g[11], g[12]);
    s_gtid[k] = g[4];
  }
  __syncthreads();

  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= P.n) return;
  const int n = P.n;
  if (P.uin[rt::U_ALIVE * n + lane] == 0) {  // dead: the state passes through
    for (int r = 0; r < F_ROWS; ++r) P.fout[r * n + lane] = P.fin[r * n + lane];
    for (int r = 0; r < U_ROWS; ++r) P.uout[r * n + lane] = P.uin[r * n + lane];
    return;
  }

  const float* vpr = P.vpr;
  const float* gs = P.gscal;
  const float cminx = gs[G_CMINX], cminz = gs[G_CMINZ];
  const float cmaxx = gs[G_CMAXX], cmaxz = gs[G_CMAXZ];
  const int icminx = (int)cminx, icminz = (int)cminz;
  const int icmaxx = (int)cmaxx, icmaxz = (int)cmaxz;
  const float ncz = gs[G_NCZ], cy_u = gs[G_CY], s_ = gs[G_S], inv_s = gs[G_INVS];
  const int n_slots = NS > 0 ? NS : P.n_slots;

  float ox = P.fin[0 * n + lane], oy = P.fin[1 * n + lane], oz = P.fin[2 * n + lane];
  float dx = P.fin[3 * n + lane], dy = P.fin[4 * n + lane], dz = P.fin[5 * n + lane];
  float fx = P.fin[rt::R_FX * n + lane], fy = P.fin[rt::R_FY * n + lane];
  float tx = P.fin[(rt::R_THR + 0) * n + lane];
  float ty = P.fin[(rt::R_THR + 1) * n + lane];
  float tz = P.fin[(rt::R_THR + 2) * n + lane];
  float t_b = P.fin[R_TB * n + lane], t_end = P.fin[R_TE * n + lane];
  float t_nx = P.fin[R_TNX * n + lane], t_nz = P.fin[R_TNZ * n + lane];
  float bkey = P.fin[R_BKEY * n + lane];
  float cur_x = P.fin[(R_CUR + 0) * n + lane];
  float cur_y = P.fin[(R_CUR + 1) * n + lane];
  float cur_z = P.fin[(R_CUR + 2) * n + lane];
  uint32_t seed = (uint32_t)P.uin[rt::U_SEED * n + lane];
  int mrow = P.uin[rt::U_M * n + lane];
  int sidx = P.uin[rt::U_SIDX * n + lane];
  int depth = P.uin[rt::U_DEPTH * n + lane];
  bool alive = true;
  bool marching = P.uin[U_MARCH * n + lane] != 0;
  int icx = P.uin[U_ICX * n + lane];
  int icz = P.uin[U_ICZ * n + lane];
  const int lane0 = P.uin[U_LANE0 * n + lane];
  // the call within the merge, and its sample count, change only when a
  // chunk ends: off the path of every iteration
  auto chunk_spp = [&](int c) {
    return c + 1 >= s_scal[S_NCALLS] ? s_scal[S_SPPLAST] : s_scal[rt::S_SPP];
  };
  int cidx = P.uin[U_CALL * n + lane];
  int cur_spp = chunk_spp(cidx);
  [[maybe_unused]] const Probe pr = probe(P);
  [[maybe_unused]] const uint32_t z = pr.zero;

  for (int it = 0; it < P.k_steps && alive; ++it) {
    if (ITER) cur_x = cur_x + 1.0f;  // every issued iteration, marching ones too
    const rt::RayTerms q = rt::ray_terms(ox, oy, oz, dx, dy, dz);

    // ---- segment start: globals + grid clip + DDA init -------------------
    const bool need = !marching;
    // FREEZE: a marching lane runs the segment start too and keeps none of it
    [[maybe_unused]] const float f_tb = t_b, f_bkey = bkey, f_te = t_end;
    [[maybe_unused]] const float f_tnx = t_nx, f_tnz = t_nz;
    [[maybe_unused]] const int f_icx = icx, f_icz = icz;
    if (FREEZE || need) {
      t_b = rt::BIG;
      bkey = TAG;
      if constexpr (GLOBAL2) {  // the globals again, their minimum consumed
        float t2 = rt::BIG;
        for (int k = 0; k < P.n_g; ++k) {
          const float4 g = s_g[k];
          const float tc = rt::quadratic(q, rt::opaque(g.x, z), g.y, g.z, g.w, P.skip_tmax);
          if (tc < t2) t2 = tc;
        }
        t_b = rt::keep(t_b, t2, z);
      }
      if constexpr (!CUT_GLOBALS) {
        for (int k = 0; k < P.n_g; ++k) {
          const float4 g = s_g[k];
          const float tc = rt::quadratic(q, g.x, g.y, g.z, g.w, P.skip_tmax);
          if (tc < t_b) {
            t_b = tc;
            bkey = TAG + s_gid[k];
          }
        }
      }
    }
    // one reciprocal per axis, shared by the slab clip and the DDA steps
    const float inv_x = 1.0f / dx, inv_y = 1.0f / dy, inv_z = 1.0f / dz;
    if constexpr (!CUT_INIT) {
      if (FREEZE || need) {
        float t0x, t1x, t0y, t1y, t0z, t1z;
        rt::slab_inv(ox, dx, inv_x, gs[G_XLO], gs[G_XHI], t0x, t1x);
        rt::slab_inv(oy, dy, inv_y, gs[G_YLO], gs[G_YHI], t0y, t1y);
        rt::slab_inv(oz, dz, inv_z, gs[G_ZLO], gs[G_ZHI], t0z, t1z);
        const float t_start = rt::jmax(rt::jmax(t0x, t0y), rt::jmax(t0z, rt::T_MIN));
        const float t_end_n = rt::jmin(rt::jmin(t1x, t1y), t1z);
        t_end = t_end_n;
        if (t_start <= t_end_n && t_start < t_b) {  // march0
          const float px0 = ox + t_start * dx;
          const float pz0 = oz + t_start * dz;
          const float icx_n = rt::jmin(rt::jmax(floorf(px0 * inv_s + 0.5f), cminx), cmaxx);
          const float icz_n = rt::jmin(rt::jmax(floorf(pz0 * inv_s + 0.5f), cminz), cmaxz);
          const float bx = (icx_n + (dx >= 0.0f ? 0.5f : -0.5f)) * s_;
          const float bz = (icz_n + (dz >= 0.0f ? 0.5f : -0.5f)) * s_;
          t_nx = dx == 0.0f ? rt::BIG : (bx - ox) * inv_x;
          t_nz = dz == 0.0f ? rt::BIG : (bz - oz) * inv_z;
          icx = (int)icx_n;
          icz = (int)icz_n;
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
        icx = rt::keep(f_icx, icx, z);
        icz = rt::keep(f_icz, icz, z);
      }
    }

    // ---- DDA march: up to j_steps cells ------------------------------------
    // FREEZE: every lane marches, and a lane that was not marching keeps
    // its winner; the advance is consumed and the cell stays
    const bool m0 = marching;
    [[maybe_unused]] const float m_tb = t_b, m_bkey = bkey;
    if (FREEZE || marching) {
      const int step_x = dx >= 0.0f ? 1 : -1;
      const int step_z = dz >= 0.0f ? 1 : -1;
      const float dt_x = dx == 0.0f ? rt::BIG : fabsf(inv_x) * s_;
      const float dt_z = dz == 0.0f ? rt::BIG : fabsf(inv_z) * s_;
      for (int j = 0; j < P.j_steps && (FREEZE || marching); ++j) {
        int cid = (int)(((float)icx - cminx) * ncz + ((float)icz - cminz));
        if constexpr (FREEZE) cid = min(max(cid, 0), pr.n_cells - 1);  // a stale cell
        const float4* cell = P.cells + (size_t)cid * P.stride4;
        // slot s: (cx, cz, kc, id), or (cx, cy, cz, kc) with the id at float
        // 4 * n_slots + s of the record (read only when the slot wins);
        // CUT_FETCH: no record, every value is ox
        auto slot = [&](int s) {
          if constexpr (CUT_FETCH) return make_float4(ox, ox, ox, ox);
          else return __ldg(cell + s);
        };
        auto test = [&](const float4 g, int s) {
          float tc;
          if constexpr (CUT_QUAD) {  // the slot's other values consumed
            tc = rt::keep(rt::keep(g.x + oy, g.y, z), g.z, z);
          } else {
            tc = rt::quadratic(q, g.x, FIVE ? g.y : cy_u, FIVE ? g.z : g.y,
                               FIVE ? g.w : g.z, P.skip_tmax);
          }
          if (tc < t_b) {
            t_b = tc;
            if constexpr (CUT_FETCH) bkey = ox;
            else bkey = FIVE ? reinterpret_cast<const float*>(cell)[4 * n_slots + s] : g.w;
          }
        };
        // FETCH2: the next cell's record too; ISECT2: the slots' quadratics
        // again; each consumed
        const float4* cell2 = P.cells;
        if constexpr (FETCH2)
          cell2 += (size_t)(min(cid + 1, pr.n_cells - 1) ^ (int)z) * P.stride4;
        auto dup = [&](float4 g, int s) {
          if constexpr (FETCH2) {
            const float4 g2 = __ldg(cell2 + s);
            g.x = rt::keep(g.x, g2.x, z);
            g.y = rt::keep(g.y, g2.y, z);
            g.z = rt::keep(g.z, g2.z, z);
            g.w = rt::keep(g.w, g2.w, z);
          }
          return g;
        };
        float t2 = t_b;
        auto isect2 = [&](const float4 g) {
          const float tc = rt::quadratic(q, rt::opaque(g.x, z), FIVE ? g.y : cy_u,
                                         FIVE ? g.z : g.y, FIVE ? g.w : g.z, P.skip_tmax);
          if (tc < t2) t2 = tc;
        };
        if (NS > 0) {
          float4 g[NS > 0 ? NS : 1];
#pragma unroll
          for (int s = 0; s < NS; ++s) g[s] = dup(slot(s), s);
#pragma unroll
          for (int s = 0; s < NS; ++s) test(g[s], s);
          if constexpr (ISECT2) {
#pragma unroll
            for (int s = 0; s < NS; ++s) isect2(g[s]);
          }
        } else {
          for (int s = 0; s < n_slots; ++s) {
            const float4 g = dup(slot(s), s);
            test(g, s);
            if constexpr (ISECT2) isect2(g);
          }
        }
        if constexpr (ISECT2) t_b = rt::keep(t_b, t2, z);
        const float t_exit = rt::jmin(t_nx, t_nz);
        const bool cont = t_exit < t_b && t_exit < t_end;
        [[maybe_unused]] const int a_icx = icx, a_icz = icz;
        [[maybe_unused]] const float a_tnx = t_nx, a_tnz = t_nz;
        [[maybe_unused]] const bool a_march = marching;
        if (cont) {
          if (t_nx <= t_nz) {
            icx = min(max(icx + step_x, icminx), icmaxx);
            t_nx = t_nx + dt_x;
          } else {
            icz = min(max(icz + step_z, icminz), icmaxz);
            t_nz = t_nz + dt_z;
          }
        }
        marching = cont;
        if constexpr (DDA2) {  // the advance again from t_nx + 0.5, consumed
          const float tnx2 = rt::opaque(t_nx, z) + 0.5f;
          const float t_exit2 = rt::jmin(tnx2, t_nz);
          const bool cont2 = marching && t_exit2 < t_b && t_exit2 < t_end;
          int icx2 = icx, icz2 = icz;
          float tnx3 = t_nx, tnz3 = t_nz;
          if (cont2) {
            if (tnx2 <= t_nz) {
              icx2 = min(max(icx + step_x, icminx), icmaxx);
              tnx3 = t_nx + dt_x;
            } else {
              icz2 = min(max(icz + step_z, icminz), icmaxz);
              tnz3 = t_nz + dt_z;
            }
          }
          icx = rt::keep(icx, icx2, z);
          icz = rt::keep(icz, icz2, z);
          t_nx = rt::keep(t_nx, tnx3, z);
          t_nz = rt::keep(t_nz, tnz3, z);
          marching = rt::keep(marching, cont2, z);
        }
        if constexpr (FREEZE) {
          icx = rt::keep(a_icx, icx, z);
          icz = rt::keep(a_icz, icz, z);
          t_nx = rt::keep(a_tnx, t_nx, z);
          t_nz = rt::keep(a_tnz, t_nz, z);
          marching = rt::keep(a_march, marching, z);
        }
      }
    }
    if constexpr (FREEZE) {
      if (!m0) {
        t_b = rt::keep(m_tb, t_b, z);
        bkey = rt::keep(m_bkey, bkey, z);
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
    [[maybe_unused]] const int f_cidx = cidx, f_cspp = cur_spp;

    // ---- winner resolution: bkey (sphere id) -> attrs ----------------------
    const bool hit = t_b < rt::BIG;
    const bool is_direct = bkey >= TAG;
    int bidx = (int)(is_direct ? bkey - TAG : bkey);
    if constexpr (CUT_FETCH) {  // an id made of ox: outside the table, entry id & 127
      if ((unsigned)bidx >= (unsigned)pr.n_ids) bidx = bidx & 127;
    }
    float4 a0, a1;
    if constexpr (CUT_RESOLVE) {
      a0 = make_float4(bkey, bkey, bkey, bkey);
      a1 = a0;
    } else {
      a0 = __ldg(P.attrs + 2 * bidx);
      a1 = __ldg(P.attrs + 2 * bidx + 1);
    }
    if constexpr (RESOLVE2) {  // the next id's record too, consumed
      const int b2 = min(bidx + 1, pr.n_ids - 1) ^ (int)z;
      const float4 c0 = __ldg(P.attrs + 2 * b2), c1 = __ldg(P.attrs + 2 * b2 + 1);
      a0 = make_float4(rt::keep(a0.x, c0.x, z), rt::keep(a0.y, c0.y, z),
                       rt::keep(a0.z, c0.z, z), rt::keep(a0.w, c0.w, z));
      a1 = make_float4(rt::keep(a1.x, c1.x, z), rt::keep(a1.y, c1.y, z),
                       rt::keep(a1.z, c1.z, z), rt::keep(a1.w, c1.w, z));
    }
    rt::Hit h;
    h.mat = a0.x;
    h.c0x = a0.y; h.c0y = a0.z; h.c0z = a0.w;
    h.fuzz = a1.x;
    h.cenx = a1.y; h.ceny = a1.z; h.cenz = a1.w;
    if (P.tattrs != nullptr) {
      const float4 t = __ldg(P.tattrs + bidx);
      h.tex = t.x; h.c1x = t.y; h.c1y = t.z; h.c1z = t.w;
    } else {  // tex / c1 exist only on textured globals
      const float bidx_f = is_direct ? bkey - TAG : -1.0f;
      h.tex = 0.0f; h.c1x = 0.0f; h.c1y = 0.0f; h.c1z = 0.0f;
      for (int k = 0; k < P.n_gt; ++k) {
        if (bidx_f == s_gtid[k]) {
          const float4 t = s_gt[k];
          h.tex = t.x; h.c1x = t.y; h.c1y = t.z; h.c1z = t.w;
        }
      }
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
      s = rt::shade<CUT_SIN>(q, t_b, seed, h);
    }
    if constexpr (SHADE2) {  // the shading again at t_b + 1, consumed
      const rt::Shade s2 = rt::shade(q, rt::opaque(t_b, z) + 1.0f, seed, h);
      s.px = rt::keep(s.px, s2.px, z); s.py = rt::keep(s.py, s2.py, z);
      s.pz = rt::keep(s.pz, s2.pz, z);
      s.ax = rt::keep(s.ax, s2.ax, z); s.ay = rt::keep(s.ay, s2.ay, z);
      s.az = rt::keep(s.az, s2.az, z);
      s.sdx = rt::keep(s.sdx, s2.sdx, z); s.sdy = rt::keep(s.sdy, s2.sdy, z);
      s.sdz = rt::keep(s.sdz, s2.sdz, z);
      s.does_scatter = rt::keep(s.does_scatter, s2.does_scatter, z);
      s.seed_h = rt::keep(s.seed_h, s2.seed_h, z);
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
      if (!ITER) cur_x = cur_x + tx * lx;
      cur_y = cur_y + ty * ly;
      cur_z = cur_z + tz * lz;
    }
    uint32_t seed_a = hit ? s.seed_h : seed;
    if (considered) seed_a = seed_rr;

    // ---- flush the finished (pixel, call) chunk's sum into its slot -------
    const bool more = term && sidx < cur_spp;
    const bool chunk_done = term && !more;
    bool more_calls = false;
    if (chunk_done) {
      more_calls = cidx + 1 < s_scal[S_NCALLS];
      const int pix = lane_pixel(P, mrow, lane0);
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

    // ---- regen: next sample, next call of the pixel, or next pixel --------
    const bool pix_done = chunk_done && !more_calls;
    const int m2 = mrow + (pix_done ? 1 : 0);
    const int pix2 = pix_done ? lane_pixel(P, m2, lane0) : P.p_total;
    const bool adv = pix_done && m2 < P.m_slots && pix2 < P.p_total;
    const bool renew = more_calls || adv;
    const bool regen = more || renew;
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
        if (renew) {  // a fresh TEA seed: the next pixel, or the next call's number
          uint32_t number = (uint32_t)s_scal[rt::S_NUMBER];
          const int y0 = s_scal[rt::S_Y0], offx = s_scal[rt::S_OFFX];
          int px, py;
          if (adv) {
            px = pix2 % P.width;
            py = pix2 / P.width;
            fx = (float)(offx + px);
            fy = (float)(y0 + py);
          } else {
            px = (int)(fx - (float)offx);
            py = (int)(fy - (float)y0);
            number = number + (uint32_t)(cidx + 1);
          }
          if constexpr (CUT_TEA) seed_c = seed;
          else seed_c = rt::pixel_seed(px, s_scal[rt::S_SEEDY0] + py, number);
        }
        [[maybe_unused]] uint32_t seed2 = seed_c ^ z;
        if constexpr (!CUT_CAMERA) {
          const rt::Ray r = rt::camera_ray(seed_c, fx, fy, vpr);
          ox = r.ox; oy = r.oy; oz = r.oz;
          dx = r.dx; dy = r.dy; dz = r.dz;
        }
        if constexpr (CAMERA2) {  // a second camera ray from seed_c ^ z, consumed
          const rt::Ray r2 = rt::camera_ray(seed2, fx, fy, vpr);
          ox = rt::keep(ox, r2.ox, z); oy = rt::keep(oy, r2.oy, z);
          oz = rt::keep(oz, r2.oz, z); dx = rt::keep(dx, r2.dx, z);
          dy = rt::keep(dy, r2.dy, z); dz = rt::keep(dz, r2.dz, z);
          seed_c = rt::keep(seed_c, seed2, z);
        }
        tx = 1.0f; ty = 1.0f; tz = 1.0f;
        seed = seed_c;
        depth = 0;
      } else {
        seed = seed_a;
      }
    } else {
      // FREEZE: every lane hashes its fresh seed and casts its camera ray;
      // each keeps what its branch takes
      uint32_t number = (uint32_t)s_scal[rt::S_NUMBER];
      const int y0 = s_scal[rt::S_Y0], offx = s_scal[rt::S_OFFX];
      int px, py;
      if (adv) {
        px = pix2 % P.width;
        py = pix2 / P.width;
      } else {
        px = (int)(fx - (float)offx);
        py = (int)(fy - (float)y0);
        number = number + (uint32_t)(cidx + 1);
      }
      const float fxn = adv ? (float)(offx + px) : fx;
      const float fyn = adv ? (float)(y0 + py) : fy;
      uint32_t fresh = seed;
      if constexpr (!CUT_TEA) fresh = rt::pixel_seed(px, s_scal[rt::S_SEEDY0] + py, number);
      uint32_t seed_c = rt::keep(renew ? fresh : seed_a, fresh, z);
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
    if (chunk_done) {
      cidx = more_calls ? cidx + 1 : 0;
      cur_spp = chunk_spp(cidx);
    }
    sidx = renew ? 1 : sidx + (more ? 1 : 0);
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
        depth = rt::keep(f_depth, depth, z); cidx = rt::keep(f_cidx, cidx, z);
        cur_spp = rt::keep(f_cspp, cur_spp, z);
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
  P.fout[(R_CUR + 0) * n + lane] = cur_x;
  P.fout[(R_CUR + 1) * n + lane] = cur_y;
  P.fout[(R_CUR + 2) * n + lane] = cur_z;
  P.uout[rt::U_SEED * n + lane] = (int32_t)seed;
  P.uout[rt::U_M * n + lane] = mrow;
  P.uout[rt::U_SIDX * n + lane] = sidx;
  P.uout[rt::U_DEPTH * n + lane] = depth;
  P.uout[rt::U_ALIVE * n + lane] = alive ? 1 : 0;
  P.uout[U_MARCH * n + lane] = marching ? 1 : 0;
  P.uout[U_ICX * n + lane] = icx;
  P.uout[U_ICZ * n + lane] = icz;
  P.uout[U_LANE0 * n + lane] = lane0;
  P.uout[U_CALL * n + lane] = cidx;
}

typedef void (*KernelFn)(GridParams);

// The instance for a table layout: the book scene's 4-value, 4-slot cells,
// any other 4-value count, or the 5-value layout.  The 4-slot instance, its
// four loads in flight before the first test, measured ~4% faster on the
// book than the generic one, which loads a slot at a time (PERF.md).
template <bool ITER>
KernelFn pick_layout(int five, int n_slots) {
  if (five) return grid_megakernel_step_kernel<true, 0, ITER>;
  if (n_slots != 4) return grid_megakernel_step_kernel<false, 0, ITER>;
  return grid_megakernel_step_kernel<false, 4, ITER>;
}

KernelFn pick(int five, int n_slots, int iterstats) {
  return iterstats ? pick_layout<true>(five, n_slots) : pick_layout<false>(five, n_slots);
}

}  // namespace

// Launches one step over the n lanes of the state on `stream`; returns
// cudaGetLastError() of the launch.  `passign` may be null (M strided
// pixels per lane); `tab_n` is its row length.  `zero` (always 0), `n_cells`
// and `n_ids` (the rows of cells and attrs) are read by the probe variants
// only.
extern "C" int rt_grid_megakernel_step(
    const int32_t* scal, const float* vpr, const float* gscal, const float* gtab,
    const float* gttab, const float* cells, const float* attrs, const float* tattrs,
    const int32_t* passign, const float* fin, const int32_t* uin, float* acc,
    float* fout, int32_t* uout,
    int n_g, int n_gt, int five, int n_slots, int stride,
    int n, int m_slots, int n_lanes, int p_total, int width,
    int max_depth, int k_steps, int j_steps, int skip_tmax, int tab_n, int iterstats,
    int zero, int n_cells, int n_ids,
    int rr_on, int rr_d0, int rr_d1, float rr_pmin, int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  if (n == 0) return 0;
  GridParams P{scal, vpr, gscal, gtab, gttab,
               reinterpret_cast<const float4*>(cells),
               reinterpret_cast<const float4*>(attrs),
               reinterpret_cast<const float4*>(tattrs), passign,
               fin, uin, acc, fout, uout,
               n_g, n_gt, n_slots, stride / 4,
               n, m_slots, n_lanes, p_total, width, max_depth, k_steps,
               j_steps, tab_n, skip_tmax != 0, rt::RR{rr_on, rr_d0, rr_d1, rr_pmin}};
#if RT_ABLATE
  P.pr = Probe{(uint32_t)zero, n_cells, n_ids};
#else
  (void)zero, (void)n_cells, (void)n_ids;
#endif
  const KernelFn fn = pick(five, n_slots, iterstats);
  const int grid = (n + BLOCK - 1) / BLOCK;
  fn<<<grid, BLOCK, 0, (cudaStream_t)stream>>>(P);
  return (int)cudaGetLastError();
}

// What the card makes of one instance: out[0] resident blocks per SM,
// out[1] registers per thread, out[2] local memory per thread (spills and
// stack, bytes), out[3] static shared memory per block (bytes).  Returns a
// cudaError_t.
extern "C" int rt_grid_occupancy(int five, int n_slots, int iterstats, int device,
                                 int* out) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  const KernelFn fn = pick(five, n_slots, iterstats);
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, fn);
  if (e != cudaSuccess) return (int)e;
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, BLOCK, 0);
  if (e != cudaSuccess) return (int)e;
  out[0] = blocks;
  out[1] = attr.numRegs;
  out[2] = (int)attr.localSizeBytes;
  out[3] = (int)attr.sharedSizeBytes;
  return 0;
}
