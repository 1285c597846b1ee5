// Grid-DDA wavefront megakernel for Hopper (sm_90a): the render main path.
//
// Replaces the Pallas TPU kernel `grid_megakernel_step` in
// raytrace_tpu/ops/gridkernel.py (_kernel -> _kernel_body -> _iterate).
// It computes what that kernel computes, not a block-by-block copy: one
// thread owns one lane and runs `k_steps` iterations of the same per-lane
// state machine — on a fresh segment the brute-forced globals, the slab clip
// and the DDA init; then `j_steps` Amanatides-Woo cells per iteration, each
// cell's candidates tested with the exact quadratic; winner attributes by
// sphere id; shading, termination, the running pixel sum `cur` flushed into
// the lane's acc slot when its pixel is done, and regeneration.  A dead lane
// copies its state through and returns at once (the per-tile dead-skip).
//
// The tables keep the TPU kernel's block-major layout (models/grid.py), but
// the Mosaic gather machinery does not apply: a cell fetch is a plain load
// at row (c >> 7) * stride + v, lane c & 127, and the winner's attributes
// one load per value from atab (and ttab) at row (id >> 7) * 8 + v.
//
// What bounds it on the card: chains of dependent global loads (cell
// candidates, then the winner's attributes) and divergence between lanes
// that march different cell counts, hit different materials or terminate at
// different depths — not FLOPs.  This first version is deliberately simple:
// tables are read through the read-only cache, nothing is staged in shared
// memory, state lives in registers for the launch.
//
// Not in this version: the TPU kernel's in-kernel call merge (its u32 rows
// 8-11) and the balanced `passign` table; the fresh TEA seed of a lane that
// moves to its next pixel is computed inline.
//
// State: row-major [rows, n_pad] tensors; f32 rows 0-2 o, 3-5 d, 6 fx, 7 fy,
// 8-10 thr, 11 t_best, 12 t_end, 13 t_nx, 14 t_nz, 15 bkey, 16-17 unused,
// 18-20 cur, 21 + 3m + c acc[m]; int32 rows (u32 bits) 0 seed, 1 m, 2 sidx,
// 3 depth, 4 alive, 5 marching, 6 icx, 7 icz.  Output is written out of place.
#include <cuda_runtime.h>

#include "wavefront.cuh"

namespace {

constexpr int R_TB = 11, R_TE = 12, R_TNX = 13, R_TNZ = 14, R_BKEY = 15;
constexpr int R_CUR = 18, R_ACC = 21;
constexpr int U_MARCH = 5, U_ICX = 6, U_ICZ = 7, U_ROWS = 8;
constexpr float TAG = 4096.0f;  // bkey >= TAG: global winner TAG + id
constexpr int BLOCK = 128;

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
  const float* ctab;  // [CB * stride, 128] cell candidates, block-major
  const float* atab;  // [AB * 8, 128]: mat, c0.rgb, attr, center.xyz
  const float* ttab;  // [AB * 8, 128]: tex, c1.rgb — or null
  const float* fin;
  const int32_t* uin;
  float* fout;
  int32_t* uout;
  int n_g, n_gt, five, n_slots, stride;
  int n_pad, rf, m_slots, n_lanes, p_total, width, max_depth, k_steps, j_steps;
  bool skip_tmax;
  rt::RR rr;
};

__device__ __forceinline__ float ld(const float* p) { return __ldg(p); }

__global__ void __launch_bounds__(BLOCK) grid_megakernel_step_kernel(GridParams P) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= P.n_pad) return;
  const int n = P.n_pad;
  for (int r = 0; r < P.rf; ++r) P.fout[r * n + lane] = P.fin[r * n + lane];
  for (int r = 0; r < U_ROWS; ++r) P.uout[r * n + lane] = P.uin[r * n + lane];
  if (P.uin[rt::U_ALIVE * n + lane] == 0) return;

  const int spp = P.scal[rt::S_SPP];
  const uint32_t number = (uint32_t)P.scal[rt::S_NUMBER];
  const int y0 = P.scal[rt::S_Y0], seed_y0 = P.scal[rt::S_SEEDY0];
  const int offx = P.scal[rt::S_OFFX];
  const float* vpr = P.vpr;
  const float* gs = P.gscal;
  const float cminx = gs[G_CMINX], cminz = gs[G_CMINZ];
  const float cmaxx = gs[G_CMAXX], cmaxz = gs[G_CMAXZ];
  const int icminx = (int)cminx, icminz = (int)cminz;
  const int icmaxx = (int)cmaxx, icmaxz = (int)cmaxz;
  const float ncz = gs[G_NCZ], cy_u = gs[G_CY], s_ = gs[G_S], inv_s = gs[G_INVS];
  const int w = P.five ? 5 : 4;
  float* acc = P.fout + R_ACC * n + lane;

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

  for (int it = 0; it < P.k_steps && alive; ++it) {
    const rt::RayTerms q = rt::ray_terms(ox, oy, oz, dx, dy, dz);

    // ---- segment start: globals + grid clip + DDA init -------------------
    const bool need = !marching;
    if (need) {
      t_b = rt::BIG;
      bkey = TAG;
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
    // one reciprocal per axis, shared by the slab clip and the DDA steps
    const float inv_x = 1.0f / dx, inv_y = 1.0f / dy, inv_z = 1.0f / dz;
    if (need) {
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

    // ---- DDA march: j_steps cells -----------------------------------------
    if (marching) {
      const int step_x = dx >= 0.0f ? 1 : -1;
      const int step_z = dz >= 0.0f ? 1 : -1;
      const float dt_x = dx == 0.0f ? rt::BIG : fabsf(inv_x) * s_;
      const float dt_z = dz == 0.0f ? rt::BIG : fabsf(inv_z) * s_;
      for (int j = 0; j < P.j_steps && marching; ++j) {
        const int cid = (int)(((float)icx - cminx) * ncz + ((float)icz - cminz));
        const float* cell = P.ctab + (size_t)((cid >> 7) * P.stride) * 128 + (cid & 127);
        for (int s = 0; s < P.n_slots; ++s) {
          const int b0 = w * s;
          const float s_cx = ld(cell + b0 * 128);
          const float s_cy = P.five ? ld(cell + (b0 + 1) * 128) : cy_u;
          const float s_cz = ld(cell + (b0 + w - 3) * 128);
          const float s_kc = ld(cell + (b0 + w - 2) * 128);
          const float tc = rt::quadratic(q, s_cx, s_cy, s_cz, s_kc, P.skip_tmax);
          if (tc < t_b) {
            t_b = tc;
            bkey = ld(cell + (b0 + w - 1) * 128);
          }
        }
        const float t_exit = rt::jmin(t_nx, t_nz);
        const bool cont = t_exit < t_b && t_exit < t_end;
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
      }
    }
    if (marching) continue;  // segment still open: nothing else changes

    // ---- winner resolution: bkey (sphere id) -> attrs ----------------------
    const bool hit = t_b < rt::BIG;
    const bool is_direct = bkey >= TAG;
    const int bidx = (int)(is_direct ? bkey - TAG : bkey);
    const float* at = P.atab + (size_t)((bidx >> 7) * 8) * 128 + (bidx & 127);
    rt::Hit h;
    h.mat = ld(at + 0 * 128);
    h.c0x = ld(at + 1 * 128);
    h.c0y = ld(at + 2 * 128);
    h.c0z = ld(at + 3 * 128);
    h.fuzz = ld(at + 4 * 128);
    h.cenx = ld(at + 5 * 128);
    h.ceny = ld(at + 6 * 128);
    h.cenz = ld(at + 7 * 128);
    if (P.ttab != nullptr) {
      const float* tt = P.ttab + (size_t)((bidx >> 7) * 8) * 128 + (bidx & 127);
      h.tex = ld(tt + 0 * 128);
      h.c1x = ld(tt + 1 * 128);
      h.c1y = ld(tt + 2 * 128);
      h.c1z = ld(tt + 3 * 128);
    } else {  // tex / c1 exist only on textured globals
      const float bidx_f = is_direct ? bkey - TAG : -1.0f;
      h.tex = 0.0f; h.c1x = 0.0f; h.c1y = 0.0f; h.c1z = 0.0f;
      for (int k = 0; k < P.n_gt; ++k) {
        const float* g = P.gttab + 16 * k;
        if (bidx_f == ld(g + 4)) {
          h.tex = ld(g + 6);
          h.c1x = ld(g + 10);
          h.c1y = ld(g + 11);
          h.c1z = ld(g + 12);
        }
      }
    }
    const rt::Shade s = rt::shade(q, t_b, seed, h);

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

    // ---- flush the finished pixel's sum into its acc slot ---------------
    const bool more = term && sidx < spp;
    const bool pix_done = term && !more;
    if (pix_done) {
      if (mrow >= 0 && mrow < P.m_slots) {
        acc[(3 * mrow + 0) * n] += cur_x;
        acc[(3 * mrow + 1) * n] += cur_y;
        acc[(3 * mrow + 2) * n] += cur_z;
      }
      cur_x = 0.0f;
      cur_y = 0.0f;
      cur_z = 0.0f;
    }

    // ---- regen: next sample or next pixel ---------------------------------
    const int m2 = mrow + (pix_done ? 1 : 0);
    const int pix2 = m2 * P.n_lanes + lane;
    const bool adv = pix_done && m2 < P.m_slots && pix2 < P.p_total;
    const bool regen = more || adv;
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
        seed_c = rt::pixel_seed(px2, seed_y0 + py2, number);
      }
      const rt::Ray r = rt::camera_ray(seed_c, fx, fy, vpr);
      ox = r.ox; oy = r.oy; oz = r.oz;
      dx = r.dx; dy = r.dy; dz = r.dz;
      tx = 1.0f; ty = 1.0f; tz = 1.0f;
      seed = seed_c;
      depth = 0;
    } else {
      seed = seed_a;
    }
    mrow = m2;
    sidx = adv ? 1 : sidx + (more ? 1 : 0);
    alive = cont || regen;
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
}

}  // namespace

// Launches one step on `stream`; returns cudaGetLastError() of the launch.
extern "C" int rt_grid_megakernel_step(
    const int32_t* scal, const float* vpr, const float* gscal, const float* gtab,
    const float* gttab, const float* ctab, const float* atab, const float* ttab,
    const float* fin, const int32_t* uin, float* fout, int32_t* uout,
    int n_g, int n_gt, int five, int n_slots, int stride,
    int n_pad, int rf, int m_slots, int n_lanes, int p_total, int width,
    int max_depth, int k_steps, int j_steps, int skip_tmax,
    int rr_on, int rr_d0, int rr_d1, float rr_pmin, int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  GridParams P{scal, vpr, gscal, gtab, gttab, ctab, atab, ttab, fin, uin, fout, uout,
               n_g, n_gt, five, n_slots, stride,
               n_pad, rf, m_slots, n_lanes, p_total, width, max_depth, k_steps,
               j_steps, skip_tmax != 0, rt::RR{rr_on, rr_d0, rr_d1, rr_pmin}};
  const int grid = (n_pad + BLOCK - 1) / BLOCK;
  grid_megakernel_step_kernel<<<grid, BLOCK, 0, (cudaStream_t)stream>>>(P);
  return (int)cudaGetLastError();
}
