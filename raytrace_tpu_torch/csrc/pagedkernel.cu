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
// sort keys beyond every Morton page code: a ray that misses the grid box,
// and a dead lane (sorted last, then dropped)
constexpr int KEY_MISS = 1 << 30, KEY_DEAD = 0x7fffffff;
constexpr float KEY_BIG = 3.0e30f;  // the key's degenerate-slab bound

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
  float* acc;  // [p_total, 3], home (pixel) order
  float* fout;
  int32_t* uout;
  int32_t* key;  // [n]: the next re-bucket's sort key
  int n_g, n_slots, ab;
  int n, rf, m_slots, n_lanes, p_total, width, max_depth, k_steps;
  bool skip_tmax;
  rt::RR rr;
};

__device__ __forceinline__ float ld(const float* p) { return __ldg(p); }

// trace.py:_morton: interleave two page coordinates
__device__ __forceinline__ int morton_part(int v) {
  v = (v | (v << 8)) & 0x00F00F;
  v = (v | (v << 4)) & 0x0C30C3;
  v = (v | (v << 2)) & 0x249249;
  return v;
}
__device__ __forceinline__ int morton(int sx, int sz) {
  return morton_part(sx) | (morton_part(sz) << 1);
}

__device__ __forceinline__ void key_clip(float o, float d, float lo, float hi,
                                         float& t0, float& t1) {
  const float inv = 1.0f / d;
  const float ta = (lo - o) * inv;
  const float tb = (hi - o) * inv;
  t0 = rt::jmin(ta, tb);
  t1 = rt::jmax(ta, tb);
  if (d == 0.0f) {
    const bool inside = o >= lo && o <= hi;
    t0 = inside ? -KEY_BIG : KEY_BIG;
    t1 = inside ? KEY_BIG : -KEY_BIG;
  }
}

// trace.py:_rebucket_key for one lane: a marching lane's page, a fresh
// lane's page where its ray enters the grid box
__device__ __forceinline__ int rebucket_key(const float* gs, bool alive, bool marching,
                                            int cell, float ox, float oy, float oz,
                                            float dx, float dy, float dz) {
  if (!alive) return KEY_DEAD;
  if (marching) return morton((cell >> 12) >> 3, (cell & 4095) >> 3);
  float t0x, t1x, t0y, t1y, t0z, t1z;
  key_clip(ox, dx, gs[P_XLO], gs[P_XHI], t0x, t1x);
  key_clip(oy, dy, gs[P_YLO], gs[P_YHI], t0y, t1y);
  key_clip(oz, dz, gs[P_ZLO], gs[P_ZHI], t0z, t1z);
  const float t_start = rt::jmax(rt::jmax(t0x, t0y), rt::jmax(t0z, 1e-3f));
  const float t_end = rt::jmin(rt::jmin(t1x, t1y), t1z);
  if (!(t_start <= t_end)) return KEY_MISS;
  const float pxw = ox + t_start * dx;
  const float pzw = oz + t_start * dz;
  const float icx = rt::jmin(rt::jmax(floorf((pxw - gs[P_FMINX]) * gs[P_INVS]), 0.0f),
                             gs[P_FMAXX]);
  const float icz = rt::jmin(rt::jmax(floorf((pzw - gs[P_FMINZ]) * gs[P_INVS]), 0.0f),
                             gs[P_FMAXZ]);
  return morton((int)icx >> 3, (int)icz >> 3);
}

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
        const int b0 = W * s;
        const float s_cx = ld(gp + b0 * 128);
        const float s_cy = FIVE ? ld(gp + (b0 + 1) * 128) : cy_u;
        const float s_cz = ld(gp + (b0 + W - 2) * 128);
        const float s_kc = ld(gp + (b0 + W - 1) * 128);
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
        for (int v = 0; v < NA; ++v) att[v] = ld(ap + (v * P.ab + (lid >> 7)) * 128);
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

    // ---- flush the finished pixel's sum into its accumulator slot --------
    const bool more = term && sidx < spp;
    const bool pix_done = term && !more;
    if (pix_done) {
      const int pix = mrow * P.n_lanes + lane0;
      if (mrow >= 0 && mrow < P.m_slots && pix < P.p_total) {
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
// cudaGetLastError() of the launch.
extern "C" int rt_paged_megakernel_step(
    const int32_t* scal, const float* vpr, const float* gscal, const float* gtab,
    const float* geom, const float* lids, const float* attrs,
    const float* fin, const int32_t* uin, float* acc, float* fout, int32_t* uout,
    int32_t* key, int n_g, int five, int textured, int n_slots, int ab,
    int n, int rf, int m_slots, int n_lanes, int p_total, int width,
    int max_depth, int k_steps, int skip_tmax,
    int rr_on, int rr_d0, int rr_d1, float rr_pmin, int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  if (n == 0) return 0;
  PagedParams P{scal, vpr, gscal, gtab, geom, lids, attrs, fin, uin, acc, fout, uout,
                key, n_g, n_slots, ab, n, rf, m_slots, n_lanes, p_total, width,
                max_depth, k_steps, skip_tmax != 0, rt::RR{rr_on, rr_d0, rr_d1, rr_pmin}};
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
