// Per-lane pieces of the wavefront state machine, shared by the three
// wavefront kernels (megakernel.cu, gridkernel.cu, pagedkernel.cu) and the
// band set-up (packstate.cu): the TEA + LCG random streams, the camera ray,
// the ray-sphere quadratic, the slab clip of the grid kernels, closest-hit
// shading with speculative draws, fast mode's Russian-roulette probability
// and the paged driver's sort key.
//
// Bit parity with the JAX package and the plain torch versions is the
// contract, so every expression keeps the JAX operand order: explicit
// x + y + z sums, no FMA contraction (built with --fmad=false), IEEE sqrt and
// divide (no fast math: sqrt.rn / div.rn, never rsqrt), `x * x` for `**2`,
// misses as BIG with strict-< winner updates, and NaN-propagating min/max
// (jnp.minimum/maximum), never fminf/fmaxf.  The canRefract sqrt is not
// clamped: its NaN is what makes total internal reflection draw no number.
#pragma once

#include <stdint.h>

namespace rt {

constexpr float BIG = 3.0e38f;  // "no hit" t
constexpr float T_MIN = 0.001f;  // traceRayEXT tMin, shader.rgen:75
constexpr float T_MAX = 10000.0f;  // MAX_RAY_COLLISION_DISTANCE
constexpr float SKY_R = 0.7f, SKY_G = 0.8f, SKY_B = 1.0f;  // shader.rmiss:15

// f32 state rows shared by both layouts
constexpr int R_O = 0, R_D = 3, R_FX = 6, R_FY = 7, R_THR = 8;
// u32 state rows shared by both layouts
constexpr int U_SEED = 0, U_M = 1, U_SIDX = 2, U_DEPTH = 3, U_ALIVE = 4;
// scalar slots of the int32 `scal` row
constexpr int S_SPP = 0, S_NUMBER = 1, S_Y0 = 2, S_SEEDY0 = 3, S_OFFX = 4;
// viewport slots of the f32 `vpr` row
constexpr int V_H = 0, V_V = 3, V_UL = 6, V_UP = 9, V_RIGHT = 12, V_FROM = 15,
              V_AP = 18, V_W = 19, V_HGT = 20;

struct RR {  // fast mode (Russian roulette); on == 0 is exact mode
  int on, d0, d1;
  float pmin;
};

// jnp.minimum / jnp.maximum: NaN in, NaN out
__device__ __forceinline__ float jmin(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : (a < b ? a : b);
}
__device__ __forceinline__ float jmax(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : (a > b ? a : b);
}

// ---- RNG (random.glsl) -----------------------------------------------------
__device__ __forceinline__ uint32_t tea_hash(uint32_t v0, uint32_t v1) {
  uint32_t s0 = 0u;
#pragma unroll
  for (int n = 0; n < 16; ++n) {
    s0 += 0x9E3779B9u;
    v0 += (((v1 << 4) + 0xA341316Cu) ^ (v1 + s0)) ^ ((v1 >> 5) + 0xC8013EA4u);
    v1 += (((v0 << 4) + 0xAD90777Du) ^ (v0 + s0)) ^ ((v0 >> 5) + 0x7E95761Eu);
  }
  return v0;
}

__device__ __forceinline__ float random_float(uint32_t& seed) {
  seed = seed * 1664525u + 1013904223u;
  return (float)(int32_t)(seed & 0x00FFFFFFu) / 16777216.0f;
}

__device__ __forceinline__ float random_pm1(uint32_t& seed) {  // [-1, 1)
  return random_float(seed) * 2.0f + -1.0f;
}

__device__ __forceinline__ void norm3(float& x, float& y, float& z) {
  float inv = 1.0f / sqrtf(x * x + y * y + z * z);
  x = x * inv;
  y = y * inv;
  z = z * inv;
}

// ---- camera (shader.rgen:57,107-115): exactly 4 draws ---------------------
struct Ray {
  float ox, oy, oz, dx, dy, dz;
};

__device__ __forceinline__ Ray camera_ray(uint32_t& seed, float fx, float fy,
                                          const float* __restrict__ vpr) {
  float jx = random_float(seed);
  float jy = random_float(seed);
  float u = (fx + jx) / vpr[V_W];
  float v = (fy + jy) / vpr[V_HGT];
  float r1 = random_pm1(seed);
  float r2 = random_pm1(seed);
  float inv_l = 1.0f / sqrtf(r1 * r1 + r2 * r2);
  float ap = vpr[V_AP] * 0.5f;
  float rx = ap * (r1 * inv_l);
  float ry = ap * (r2 * inv_l);
  Ray r;
  r.ox = vpr[V_FROM + 0] + vpr[V_RIGHT + 0] * rx + vpr[V_UP + 0] * ry;
  r.oy = vpr[V_FROM + 1] + vpr[V_RIGHT + 1] * rx + vpr[V_UP + 1] * ry;
  r.oz = vpr[V_FROM + 2] + vpr[V_RIGHT + 2] * rx + vpr[V_UP + 2] * ry;
  float tx = vpr[V_UL + 0] + vpr[V_H + 0] * u - vpr[V_V + 0] * v;
  float ty = vpr[V_UL + 1] + vpr[V_H + 1] * u - vpr[V_V + 1] * v;
  float tz = vpr[V_UL + 2] + vpr[V_H + 2] * u - vpr[V_V + 2] * v;
  r.dx = tx - r.ox;
  r.dy = ty - r.oy;
  r.dz = tz - r.oz;
  norm3(r.dx, r.dy, r.dz);
  return r;
}

// ---- ray-sphere quadratic (shader.rint:44-60) ------------------------------
// Per-ray terms a = d.d, od = o.d, oo = o.o, inv_a = 1/a are hoisted by the
// caller; kc = |c|^2 - r^2 comes precomputed in f64 from the tables.
struct RayTerms {
  float ox, oy, oz, dx, dy, dz, a, od, oo, inv_a;
};

__device__ __forceinline__ RayTerms ray_terms(float ox, float oy, float oz,
                                              float dx, float dy, float dz) {
  RayTerms q;
  q.ox = ox; q.oy = oy; q.oz = oz;
  q.dx = dx; q.dy = dy; q.dz = dz;
  q.a = dx * dx + dy * dy + dz * dz;
  q.od = ox * dx + oy * dy + oz * dz;
  q.oo = ox * ox + oy * oy + oz * oz;
  q.inv_a = 1.0f / q.a;
  return q;
}

// The root is taken only on a hit: a miss (disc < 0 or NaN) branches past
// the square root and returns BIG, the same bits as sqrt(disc)'s NaN failing
// both checks (and sqrt(-0) is -0).
__device__ __forceinline__ float quadratic(const RayTerms& q, float cx, float cy,
                                           float cz, float kc, bool skip_tmax) {
  const float cd = cx * q.dx + cy * q.dy + cz * q.dz;
  const float co = cx * q.ox + cy * q.oy + cz * q.oz;
  const float b = q.od - cd;
  const float c = q.oo - 2.0f * co + kc;
  const float disc = b * b - q.a * c;
  if (!(disc >= 0.0f)) return BIG;
  const float sq = sqrtf(disc);
  const float t1 = (-b - sq) * q.inv_a;
  const float t2 = (-b + sq) * q.inv_a;
  const bool t1_ok = skip_tmax ? (t1 >= T_MIN) : (t1 >= T_MIN && t1 <= T_MAX);
  const bool t2_ok = skip_tmax ? (t2 >= T_MIN) : (t2 >= T_MIN && t2 <= T_MAX);
  return t1_ok ? t1 : (t2_ok ? t2 : BIG);
}

// ray vs axis slab [lo, hi] from a precomputed reciprocal; degenerate d:
// inside -> (-BIG, BIG), outside -> empty
__device__ __forceinline__ void slab_inv(float o, float d, float inv, float lo,
                                         float hi, float& t0, float& t1) {
  const float ta = (lo - o) * inv;
  const float tb = (hi - o) * inv;
  t0 = jmin(ta, tb);
  t1 = jmax(ta, tb);
  if (d == 0.0f) {
    const bool inside = o >= lo && o <= hi;
    t0 = inside ? -BIG : BIG;
    t1 = inside ? BIG : -BIG;
  }
}

// ---- closest-hit shading (shader.rchit; ops/shading_rows.py) ---------------
struct Hit {  // winner attributes
  float cenx, ceny, cenz, mat, tex, c0x, c0y, c0z, c1x, c1y, c1z, fuzz;
};

struct Shade {
  float px, py, pz;  // hit point
  float ax, ay, az;  // albedo
  float sdx, sdy, sdz;  // scatter direction (not normalized)
  bool does_scatter;
  uint32_t seed_h;  // seed after the material's draws
};

// CUT_SIN: the cost probe's `cut_sin` (ops/gridkernel.py): the checker's
// three sines replaced by the product of their arguments.
template <bool CUT_SIN = false>
__device__ __forceinline__ Shade shade(const RayTerms& q, float t, uint32_t seed,
                                       const Hit& h) {
  Shade s;
  s.px = q.ox + t * q.dx;
  s.py = q.oy + t * q.dy;
  s.pz = q.oz + t * q.dz;
  float nx = s.px - h.cenx, ny = s.py - h.ceny, nz = s.pz - h.cenz;
  norm3(nx, ny, nz);
  float ddn = nx * q.dx + ny * q.dy + nz * q.dz;
  bool front = ddn < 0.0f;
  if (!front) {
    nx = -nx;
    ny = -ny;
    nz = -nz;
  }

  // 3-D sine checker, size 6 (shader.rchit:53-64).  Only a textured sphere
  // that was hit reads it: a plain sphere skips it, and so does a miss, whose
  // albedo nothing reads (t = BIG puts its point where sinf would take its
  // Payne-Hanek slow path).
  bool use_c1 = false;
  if (h.tex > 0.5f && t < BIG) {
    float sines = CUT_SIN ? (6.0f * s.px) * (6.0f * s.py) * (6.0f * s.pz)
                          : sinf(6.0f * s.px) * sinf(6.0f * s.py) * sinf(6.0f * s.pz);
    use_c1 = !(sines > 0.0f);
  }
  s.ax = use_c1 ? h.c1x : h.c0x;
  s.ay = use_c1 ? h.c1y : h.c0y;
  s.az = use_c1 ? h.c1z : h.c0z;

  // speculative draws keep the GLSL draw counts (diffuse/metal 3, glass 0/1)
  uint32_t seed3 = seed;
  float ux = random_pm1(seed3);
  float uy = random_pm1(seed3);
  float uz = random_pm1(seed3);
  norm3(ux, uy, uz);
  uint32_t seed1 = seed;
  float refr_rand = random_float(seed1);

  float sdx_d = nx + ux, sdy_d = ny + uy, sdz_d = nz + uz;
  bool near0 = fabsf(sdx_d) < 1e-8f && fabsf(sdy_d) < 1e-8f && fabsf(sdz_d) < 1e-8f;
  float ndd = front ? ddn : -ddn;  // == dot(d, flipped n) bitwise
  if (near0) {
    sdx_d = nx;
    sdy_d = ny;
    sdz_d = nz;
  }

  float rx = q.dx - 2.0f * ndd * nx;
  float ry = q.dy - 2.0f * ndd * ny;
  float rz = q.dz - 2.0f * ndd * nz;
  float mx = rx + h.fuzz * ux, my = ry + h.fuzz * uy, mz = rz + h.fuzz * uz;
  norm3(mx, my, mz);
  bool metal_scatters = (mx * nx + my * ny + mz * nz) > 0.0f;

  float eta = front ? 1.0f / h.fuzz : h.fuzz;
  float cos_t = -ndd;
  float omc2 = 1.0f - ndd * ndd;
  bool can_refract = (eta * sqrtf(omc2)) <= 1.0f;  // unclamped: NaN -> false
  float qf = (1.0f - eta) / (1.0f + eta);
  float r0 = qf * qf;
  float om = 1.0f - cos_t;
  float om2 = om * om;
  float reflectance = r0 + (1.0f - r0) * om2 * om2 * om;
  bool does_refract = can_refract && (reflectance < refr_rand);
  float k = 1.0f - eta * eta * omc2;
  float sqk = sqrtf(jmax(k, 0.0f));
  float gx = rx, gy = ry, gz = rz;
  if (does_refract) {
    gx = eta * q.dx - (eta * ndd + sqk) * nx;
    gy = eta * q.dy - (eta * ndd + sqk) * ny;
    gz = eta * q.dz - (eta * ndd + sqk) * nz;
  }

  bool is_metal = (h.mat > 0.5f) && (h.mat < 1.5f);
  bool is_refr = h.mat > 1.5f;
  s.sdx = is_metal ? mx : (is_refr ? gx : sdx_d);
  s.sdy = is_metal ? my : (is_refr ? gy : sdy_d);
  s.sdz = is_metal ? mz : (is_refr ? gz : sdz_d);
  s.does_scatter = metal_scatters || !is_metal;
  s.seed_h = is_refr ? (can_refract ? seed1 : seed) : seed3;
  return s;
}

// fast mode: survival p = clamp(max(new throughput), pmin, 1), halved past d1
__device__ __forceinline__ float rr_probability(float ntx, float nty, float ntz,
                                                int dnext, const RR& rr) {
  float p = jmin(1.0f, jmax(rr.pmin, jmax(ntx, jmax(nty, ntz))));
  if (rr.d1 && dnext >= rr.d1) p = p * 0.5f;
  return p;
}

// ---- the section-cost probes (RT_ABLATE builds of the grid and paged kernels)
// z is a launch argument that is 0 at run time and unknown to the compiler:
// keep(x, y, z) is x and consumes y, so y is computed in full and cannot be
// sunk into a branch; opaque(x, z) is x in a form the compiler cannot merge
// with another computation on x.  Bit operations only: any value, NaN
// included, comes back unchanged.
__device__ __forceinline__ float keep(float x, float y, uint32_t z) {
  return __uint_as_float(__float_as_uint(x) ^ (__float_as_uint(y) & z));
}
__device__ __forceinline__ int keep(int x, int y, uint32_t z) {
  return (int)((uint32_t)x ^ ((uint32_t)y & z));
}
__device__ __forceinline__ uint32_t keep(uint32_t x, uint32_t y, uint32_t z) {
  return x ^ (y & z);
}
__device__ __forceinline__ bool keep(bool x, bool y, uint32_t z) {
  return ((x ? 1u : 0u) ^ ((y ? 1u : 0u) & z)) != 0u;
}
__device__ __forceinline__ float opaque(float x, uint32_t z) {
  return __uint_as_float(__float_as_uint(x) ^ z);
}

// ---- the paged driver's sort key (ops/trace.py _rebucket_key) --------------
// The paged kernel writes it in its epilogue, the band set-up (packstate.cu)
// for the first launch.
// gscal slots (models/paged_grid.py P_*)
constexpr int P_XLO = 0, P_XHI = 1, P_YLO = 2, P_YHI = 3, P_ZLO = 4, P_ZHI = 5;
constexpr int P_FMINX = 6, P_FMINZ = 7, P_CY = 9, P_FMAXX = 10, P_FMAXZ = 11;
constexpr int P_INVS = 12, P_S = 13, P_NSCZM = 14;
// sort keys beyond every Morton page code: a ray that misses the grid box,
// and a dead lane (sorted last, then dropped)
constexpr int KEY_MISS = 1 << 30, KEY_DEAD = 0x7fffffff;
constexpr float KEY_BIG = 3.0e30f;  // the key's degenerate-slab bound

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

// first TEA seed of a pixel (shader.rgen:40)
__device__ __forceinline__ uint32_t pixel_seed(int px, int py_seed, uint32_t number) {
  return tea_hash(tea_hash((uint32_t)px, (uint32_t)py_seed), number);
}

}  // namespace rt
