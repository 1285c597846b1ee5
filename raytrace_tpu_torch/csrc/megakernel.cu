// Brute-force wavefront megakernel for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `megakernel_step` in
// raytrace_tpu/ops/megakernel.py (_kernel -> _kernel_body -> _iterate).
// It computes what that kernel computes, not a block-by-block copy: one
// thread owns one lane and runs `k_steps` iterations of the same per-lane
// state machine — closest hit over the scene's valid table rows (strict <,
// so the lowest index wins ties), the winner's attributes by an indexed load
// of atab[:, idx] (the TPU's one-hot MXU contraction is not needed on a
// GPU), shading, termination into the lane's M accumulator slots, and
// regeneration.  A dead lane copies its state through and returns at once
// (the TPU kernel's per-tile dead-skip).
//
// What bounds it on the card: the per-ray scan over the table rows (a dozen
// dependent flops and a sqrt each), plus divergence between lanes that hit
// different materials or terminate at different depths.  Its design:
// - the scan stops at `n_valid`, the scene's sphere count: the valid rows
//   are the table's prefix, and a padding row (kc = 3e30) can never win, so
//   the winner and its index are the same bits as a scan of all S rows (on
//   the three-sphere scene 4 of 512 rows are valid);
// - a row's (cx, cy, cz, kc) is one 16-byte load (row i starts at byte 96 i)
//   that every lane of a warp shares;
// - a miss skips the root (rt::quadratic).
// Staging the rows in shared-memory tiles instead, loaded by the whole block
// in a block-uniform loop, measured slower on the card (PERF.md, PR 3).
//
// State: row-major [rows, n_pad] tensors; f32 rows 0-2 o, 3-5 d, 6 fx, 7 fy,
// 8-10 thr, 11 pad, 12 + 3m + c acc[m]; int32 rows (u32 bits) 0 seed, 1 m,
// 2 sidx, 3 depth, 4 alive, 5-7 pad.  Output is written out of place.
#include <cuda_runtime.h>

#include "wavefront.cuh"

namespace {

constexpr int R_ACC = 12;
constexpr int U_ROWS = 8;
constexpr int BLOCK = 128;

struct MegaParams {
  const int32_t* scal;
  const float* vpr;
  const float* table;  // [S, 24]: cx cy cz kc valid ... | 8-23 attrs
  const float* atab;  // [16, S]: center, mat, tex, c0, c1, fuzz
  const float* fin;
  const int32_t* uin;
  float* fout;
  int32_t* uout;
  int s_rows, n_valid, n_pad, rf, m_slots, n_lanes, p_total, width, max_depth, k_steps;
  bool skip_tmax;
  rt::RR rr;
};

__global__ void __launch_bounds__(BLOCK) megakernel_step_kernel(MegaParams P) {
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
  const float* atab = P.atab;
  const int S = P.s_rows;
  const float4* rows4 = reinterpret_cast<const float4*>(P.table);  // 6 per row
  float* acc = P.fout + R_ACC * n + lane;

  float ox = P.fin[0 * n + lane], oy = P.fin[1 * n + lane], oz = P.fin[2 * n + lane];
  float dx = P.fin[3 * n + lane], dy = P.fin[4 * n + lane], dz = P.fin[5 * n + lane];
  float fx = P.fin[rt::R_FX * n + lane], fy = P.fin[rt::R_FY * n + lane];
  float tx = P.fin[(rt::R_THR + 0) * n + lane];
  float ty = P.fin[(rt::R_THR + 1) * n + lane];
  float tz = P.fin[(rt::R_THR + 2) * n + lane];
  uint32_t seed = (uint32_t)P.uin[rt::U_SEED * n + lane];
  int mrow = P.uin[rt::U_M * n + lane];
  int sidx = P.uin[rt::U_SIDX * n + lane];
  int depth = P.uin[rt::U_DEPTH * n + lane];
  bool alive = true;

  for (int it = 0; it < P.k_steps && alive; ++it) {
    const rt::RayTerms q = rt::ray_terms(ox, oy, oz, dx, dy, dz);

    // ---- closest hit over the valid rows (shader.rint) -------------------
    float t = rt::BIG;
    int idx = 0;
    for (int i = 0; i < P.n_valid; ++i) {
      const float4 row = __ldg(rows4 + 6 * i);  // cx, cy, cz, kc
      const float tc = rt::quadratic(q, row.x, row.y, row.z, row.w, P.skip_tmax);
      if (tc < t) {
        t = tc;
        idx = i;
      }
    }
    const bool hit = t < rt::BIG;
    rt::Hit h;
    h.cenx = __ldg(atab + 0 * S + idx);
    h.ceny = __ldg(atab + 1 * S + idx);
    h.cenz = __ldg(atab + 2 * S + idx);
    h.mat = __ldg(atab + 3 * S + idx);
    h.tex = __ldg(atab + 4 * S + idx);
    h.c0x = __ldg(atab + 5 * S + idx);
    h.c0y = __ldg(atab + 6 * S + idx);
    h.c0z = __ldg(atab + 7 * S + idx);
    h.c1x = __ldg(atab + 8 * S + idx);
    h.c1y = __ldg(atab + 9 * S + idx);
    h.c1z = __ldg(atab + 10 * S + idx);
    h.fuzz = __ldg(atab + 11 * S + idx);
    const rt::Shade s = rt::shade(q, t, seed, h);

    // ---- termination & accumulation (shader.rgen:70-89) -----------------
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
    if (term && mrow >= 0 && mrow < P.m_slots) {
      const float lx = hit ? (s.does_scatter ? 0.0f : s.ax) : rt::SKY_R;
      const float ly = hit ? (s.does_scatter ? 0.0f : s.ay) : rt::SKY_G;
      const float lz = hit ? (s.does_scatter ? 0.0f : s.az) : rt::SKY_B;
      acc[(3 * mrow + 0) * n] += tx * lx;
      acc[(3 * mrow + 1) * n] += ty * ly;
      acc[(3 * mrow + 2) * n] += tz * lz;
    }
    uint32_t seed_a = hit ? s.seed_h : seed;
    if (considered) seed_a = seed_rr;

    // ---- regen: next sample or next pixel --------------------------------
    const bool more = term && sidx < spp;
    const bool pix_done = term && !more;
    const int m2 = mrow + (pix_done ? 1 : 0);
    const int pix2 = m2 * P.n_lanes + lane;
    const bool adv = pix_done && m2 < P.m_slots && pix2 < P.p_total;
    const bool regen = more || adv;
    if (cont) {
      float bx = s.sdx, by = s.sdy, bz = s.sdz;
      rt::norm3(bx, by, bz);  // normalized bounce (shader.rgen:78)
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
  P.uout[rt::U_SEED * n + lane] = (int32_t)seed;
  P.uout[rt::U_M * n + lane] = mrow;
  P.uout[rt::U_SIDX * n + lane] = sidx;
  P.uout[rt::U_DEPTH * n + lane] = depth;
  P.uout[rt::U_ALIVE * n + lane] = alive ? 1 : 0;
}

}  // namespace

// Launches one step on `stream`; returns cudaGetLastError() of the launch.
extern "C" int rt_megakernel_step(
    const int32_t* scal, const float* vpr, const float* table, const float* atab,
    const float* fin, const int32_t* uin, float* fout, int32_t* uout,
    int s_rows, int n_valid, int n_pad, int rf, int m_slots, int n_lanes, int p_total,
    int width, int max_depth, int k_steps, int skip_tmax,
    int rr_on, int rr_d0, int rr_d1, float rr_pmin, int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  MegaParams P{scal, vpr, table, atab, fin, uin, fout, uout,
               s_rows, n_valid, n_pad, rf, m_slots, n_lanes, p_total, width, max_depth,
               k_steps, skip_tmax != 0, rt::RR{rr_on, rr_d0, rr_d1, rr_pmin}};
  const int grid = (n_pad + BLOCK - 1) / BLOCK;
  megakernel_step_kernel<<<grid, BLOCK, 0, (cudaStream_t)stream>>>(P);
  return (int)cudaGetLastError();
}

extern "C" const char* rt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
