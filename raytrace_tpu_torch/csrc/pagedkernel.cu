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
// attrs[page][v * ab + (lid >> 7)][lid & 127] at once, and carried in state
// rows until the segment ends; then shading, termination, the running pixel
// sum `cur` flushed into the acc slot, and regeneration addressed by the
// lane's `lane0` row (the driver re-buckets lanes between launches).  A dead
// lane copies its state through and returns at once (the per-tile
// dead-skip).
//
// The TPU kernel's per-128-lane page-box loops exist because a Mosaic lane
// gather addresses 128 entries; here every lane loads what it needs by
// index, so there is no box loop, no distinct-page walk and no Morton logic
// in the kernel (the Morton re-bucket stays in the driver, where it keeps a
// warp's lanes on few pages so their loads share cache lines).
//
// What bounds it on the card: dependent global loads -- up to n_slots x w
// candidate values per cell (the 100k-sphere field's tables are ~21 MB, so
// they stay in the 50 MB L2, but lanes on different pages share no cache
// lines), then the lid and the attributes -- and divergence between lanes
// that march different cell counts or terminate at different depths; not
// FLOPs.  This first version is deliberately simple: tables through the
// read-only cache, nothing staged in shared memory, state in registers.
//
// State: row-major [rows, n_pad] tensors; f32 rows 0-2 o, 3-5 d, 6 fx, 7 fy,
// 8-10 thr, 11 t_best, 12 t_end, 13 t_nx, 14 t_nz, 15 bkey, 16 wcx, 17 wcz,
// 18-20 cur, 21 + 3m + c acc[m], 21 + 3M + i carried attr i; int32 rows (u32
// bits) 0 seed, 1 m, 2 sidx, 3 depth, 4 alive, 5 marching, 6 cell
// (icx << 12 | icz), 7 lane0.  Output is written out of place.
#include <cuda_runtime.h>

#include "wavefront.cuh"

namespace {

constexpr int R_TB = 11, R_TE = 12, R_TNX = 13, R_TNZ = 14, R_BKEY = 15;
constexpr int R_WCX = 16, R_WCZ = 17, R_CUR = 18, R_ACC = 21;
constexpr int U_MARCH = 5, U_CELL = 6, U_LANE0 = 7, U_ROWS = 8;
constexpr float TAG = 8388608.0f;  // 2^23: bkey >= TAG is a global winner
constexpr int MAX_CARRY = 10;  // (mat, c0.rgb, fuzz) + cy + (tex, c1.rgb)
constexpr int BLOCK = 128;

// gscal slots (models/paged_grid.py P_*)
constexpr int P_XLO = 0, P_XHI = 1, P_YLO = 2, P_YHI = 3, P_ZLO = 4, P_ZHI = 5;
constexpr int P_FMINX = 6, P_FMINZ = 7, P_CY = 9, P_FMAXX = 10, P_FMAXZ = 11;
constexpr int P_INVS = 12, P_S = 13, P_NSCZM = 14;

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
  float* fout;
  int32_t* uout;
  int n_g, five, textured, n_slots, ab;
  int n_pad, rf, m_slots, n_lanes, p_total, width, max_depth, k_steps;
  bool skip_tmax;
  rt::RR rr;
};

__device__ __forceinline__ float ld(const float* p) { return __ldg(p); }

__global__ void __launch_bounds__(BLOCK) paged_megakernel_step_kernel(PagedParams P) {
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
  const float fminx = gs[P_FMINX], fminz = gs[P_FMINZ];
  const float fmaxx = gs[P_FMAXX], fmaxz = gs[P_FMAXZ];
  const int ifmaxx = (int)fmaxx, ifmaxz = (int)fmaxz;
  const float cy_u = gs[P_CY], inv_s = gs[P_INVS], cs = gs[P_S];
  const int nsczm = (int)gs[P_NSCZM];
  const int w = P.five ? 4 : 3;
  const int na = (P.five ? 6 : 5) + (P.textured ? 4 : 0);
  const int geom_rows = w * P.n_slots;
  const int attr_rows = na * P.ab;
  const int a0 = R_ACC + 3 * P.m_slots;
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
  float wcx = P.fin[R_WCX * n + lane], wcz = P.fin[R_WCZ * n + lane];
  float cur_x = P.fin[(R_CUR + 0) * n + lane];
  float cur_y = P.fin[(R_CUR + 1) * n + lane];
  float cur_z = P.fin[(R_CUR + 2) * n + lane];
  float att[MAX_CARRY];
#pragma unroll
  for (int i = 0; i < MAX_CARRY; ++i) att[i] = i < na ? P.fin[(a0 + i) * n + lane] : 0.0f;
  uint32_t seed = (uint32_t)P.uin[rt::U_SEED * n + lane];
  int mrow = P.uin[rt::U_M * n + lane];
  int sidx = P.uin[rt::U_SIDX * n + lane];
  int depth = P.uin[rt::U_DEPTH * n + lane];
  bool alive = true;
  bool marching = P.uin[U_MARCH * n + lane] != 0;
  int cell = P.uin[U_CELL * n + lane];
  const int lane0 = P.uin[U_LANE0 * n + lane];

  for (int it = 0; it < P.k_steps && alive; ++it) {
    const rt::RayTerms q = rt::ray_terms(ox, oy, oz, dx, dy, dz);

    // ---- segment start: globals + clip + fine-DDA init --------------------
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

    // ---- fine-DDA march: one cell ------------------------------------------
    if (marching) {
      int icx = cell >> 12, icz = cell & 4095;
      const int sxm = icx >> 3, szm = icz >> 4;
      const int fc = ((icx & 7) << 4) | (icz & 15);
      const size_t page = (size_t)(sxm * nsczm + szm);
      const float* gp = P.geom + page * geom_rows * 128 + fc;
      bool upd_any = false;
      int wslot = 0;
      for (int s = 0; s < P.n_slots; ++s) {
        const int b0 = w * s;
        const float s_cx = ld(gp + b0 * 128);
        const float s_cy = P.five ? ld(gp + (b0 + 1) * 128) : cy_u;
        const float s_cz = ld(gp + (b0 + w - 2) * 128);
        const float s_kc = ld(gp + (b0 + w - 1) * 128);
        const float tc = rt::quadratic(q, s_cx, s_cy, s_cz, s_kc, P.skip_tmax);
        if (tc < t_b) {
          t_b = tc;
          wslot = s;
          wcx = s_cx;
          wcz = s_cz;
          upd_any = true;
        }
      }
      if (upd_any) {  // the winner improved in this cell: lid, then attrs
        const float lid_w = ld(P.lids + (page * P.n_slots + wslot) * 128 + fc);
        const float pkey = (float)(sxm * 32 + szm) * 512.0f;
        bkey = pkey + lid_w;
        const int lid = (int)bkey & 511;
        const float* ap = P.attrs + page * attr_rows * 128 + (lid & 127);
#pragma unroll
        for (int v = 0; v < MAX_CARRY; ++v)
          if (v < na) att[v] = ld(ap + (v * P.ab + (lid >> 7)) * 128);
      }
      const float dt_x = dx == 0.0f ? rt::BIG : fabsf(cs * inv_x);
      const float dt_z = dz == 0.0f ? rt::BIG : fabsf(cs * inv_z);
      const float t_exit = rt::jmin(t_nx, t_nz);
      const bool cont = t_exit < t_b && t_exit < t_end;
      if (cont) {
        if (t_nx <= t_nz) {
          icx = min(max(icx + (dx >= 0.0f ? 1 : -1), 0), ifmaxx);
          t_nx = t_nx + dt_x;
        } else {
          icz = min(max(icz + (dz >= 0.0f ? 1 : -1), 0), ifmaxz);
          t_nz = t_nz + dt_z;
        }
      }
      cell = (icx << 12) | icz;
      marching = cont;
    }
    if (marching) continue;  // segment still open: nothing else changes

    // ---- winner resolution: globals from gtab, grid winners carried -------
    const bool hit = t_b < rt::BIG;
    rt::Hit h;
    if (bkey >= TAG) {
      const float bidx_f = bkey - TAG;
      const float* g = P.gtab;  // row 0 unless a later row's id matches
      for (int k = 1; k < P.n_g; ++k)
        if (bidx_f == ld(P.gtab + 16 * k + 4)) g = P.gtab + 16 * k;
      h.cenx = ld(g + 0); h.ceny = ld(g + 1); h.cenz = ld(g + 2);
      h.mat = ld(g + 5); h.tex = ld(g + 6);
      h.c0x = ld(g + 7); h.c0y = ld(g + 8); h.c0z = ld(g + 9);
      h.c1x = ld(g + 10); h.c1y = ld(g + 11); h.c1z = ld(g + 12);
      h.fuzz = ld(g + 13);
    } else {
      h.cenx = wcx;
      h.ceny = P.five ? att[5] : cy_u;
      h.cenz = wcz;
      h.mat = att[0];
      h.c0x = att[1]; h.c0y = att[2]; h.c0z = att[3];
      h.fuzz = att[4];
      h.tex = 0.0f; h.c1x = 0.0f; h.c1y = 0.0f; h.c1z = 0.0f;
      if (P.textured) {  // tex, c1.rgb are the last four carried rows
        const int t0 = na - 4;
#pragma unroll
        for (int v = 5; v < MAX_CARRY; ++v) {  // constant indices: registers
          if (v == t0) h.tex = att[v];
          if (v == t0 + 1) h.c1x = att[v];
          if (v == t0 + 2) h.c1y = att[v];
          if (v == t0 + 3) h.c1z = att[v];
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

    // ---- regen, addressed by lane0 ----------------------------------------
    const int m2 = mrow + (pix_done ? 1 : 0);
    const int pix2 = m2 * P.n_lanes + lane0;
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
  P.fout[R_WCX * n + lane] = wcx;
  P.fout[R_WCZ * n + lane] = wcz;
  P.fout[(R_CUR + 0) * n + lane] = cur_x;
  P.fout[(R_CUR + 1) * n + lane] = cur_y;
  P.fout[(R_CUR + 2) * n + lane] = cur_z;
#pragma unroll
  for (int i = 0; i < MAX_CARRY; ++i)
    if (i < na) P.fout[(a0 + i) * n + lane] = att[i];
  P.uout[rt::U_SEED * n + lane] = (int32_t)seed;
  P.uout[rt::U_M * n + lane] = mrow;
  P.uout[rt::U_SIDX * n + lane] = sidx;
  P.uout[rt::U_DEPTH * n + lane] = depth;
  P.uout[rt::U_ALIVE * n + lane] = alive ? 1 : 0;
  P.uout[U_MARCH * n + lane] = marching ? 1 : 0;
  P.uout[U_CELL * n + lane] = cell;
}

}  // namespace

// Launches one step on `stream`; returns cudaGetLastError() of the launch.
extern "C" int rt_paged_megakernel_step(
    const int32_t* scal, const float* vpr, const float* gscal, const float* gtab,
    const float* geom, const float* lids, const float* attrs,
    const float* fin, const int32_t* uin, float* fout, int32_t* uout,
    int n_g, int five, int textured, int n_slots, int ab,
    int n_pad, int rf, int m_slots, int n_lanes, int p_total, int width,
    int max_depth, int k_steps, int skip_tmax,
    int rr_on, int rr_d0, int rr_d1, float rr_pmin, int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  PagedParams P{scal, vpr, gscal, gtab, geom, lids, attrs, fin, uin, fout, uout,
                n_g, five, textured, n_slots, ab,
                n_pad, rf, m_slots, n_lanes, p_total, width, max_depth, k_steps,
                skip_tmax != 0, rt::RR{rr_on, rr_d0, rr_d1, rr_pmin}};
  const int grid = (n_pad + BLOCK - 1) / BLOCK;
  paged_megakernel_step_kernel<<<grid, BLOCK, 0, (cudaStream_t)stream>>>(P);
  return (int)cudaGetLastError();
}
