// Fused closest-hit intersection + attribute fetch for Hopper (sm_90a): the
// `pallas` backend.
//
// Replaces the Pallas TPU kernel `_intersect_pallas_padded` in
// raytrace_tpu/ops/pallas_intersect.py (its `_kernel`).  Stateless: one
// thread per ray loops over the S rows of the packed sphere table
// (ops/intersect.sphere_table) in the TPU kernel's op order -- a, od, oo as
// x + y + z sums and one reciprocal of a; cd, co; b = od - cd;
// c = oo - 2 co + kc; sq = sqrt(disc >= 0 ? disc : 0); both roots checked
// against tMin and tMax; the valid column; BIG on a miss -- keeping the
// lowest index among the minima (strict < in index order, from best = BIG,
// idx = 0), then copies the winner's 16 attribute columns, table[idx, 8:24].
// The TPU kernel does that fetch as a one-hot matrix product at HIGHEST
// precision, which is exact, so the load gives the same bits; a ray that hits
// nothing gets row 0's attributes, as the one-hot contraction gives it.
//
// What bounds it on the card: the per-ray scan, about 25 flops and a sqrt per
// (ray, row) pair -- operations, not bytes (the table's five used columns are
// staged in shared memory once per block and chunk; each ray reads 24 bytes
// and writes 68).  This first version is deliberately simple: one ray per
// thread, no warp-level sharing beyond the staged table.
#include <cuda_runtime.h>

#include "wavefront.cuh"

namespace {

constexpr int BLOCK = 128;
constexpr int CHUNK = 512;  // table rows staged in shared memory per pass

__global__ void __launch_bounds__(BLOCK) intersect_shade_kernel(
    const float* __restrict__ o, const float* __restrict__ d,
    const float* __restrict__ table, float* __restrict__ t_out,
    float* __restrict__ attrs_out, int n, int s_rows) {
  __shared__ float s_cx[CHUNK], s_cy[CHUNK], s_cz[CHUNK], s_kc[CHUNK], s_vld[CHUNK];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = i < n;
  float ox = 0.0f, oy = 0.0f, oz = 0.0f, dx = 0.0f, dy = 0.0f, dz = 0.0f;
  if (active) {
    ox = o[3 * i + 0]; oy = o[3 * i + 1]; oz = o[3 * i + 2];
    dx = d[3 * i + 0]; dy = d[3 * i + 1]; dz = d[3 * i + 2];
  }
  const float a = dx * dx + dy * dy + dz * dz;
  const float od = ox * dx + oy * dy + oz * dz;
  const float oo = ox * ox + oy * oy + oz * oz;
  const float inv_a = 1.0f / a;
  float best = rt::BIG;
  int idx = 0;
  for (int base = 0; base < s_rows; base += CHUNK) {
    const int rows = min(CHUNK, s_rows - base);
    __syncthreads();  // the previous chunk is consumed
    for (int r = threadIdx.x; r < rows; r += blockDim.x) {
      const float* row = table + (size_t)(base + r) * 24;
      s_cx[r] = row[0]; s_cy[r] = row[1]; s_cz[r] = row[2];
      s_kc[r] = row[3]; s_vld[r] = row[4];
    }
    __syncthreads();
    if (!active) continue;
    for (int r = 0; r < rows; ++r) {
      const float cx = s_cx[r], cy = s_cy[r], cz = s_cz[r];
      const float cd = cx * dx + cy * dy + cz * dz;
      const float co = cx * ox + cy * oy + cz * oz;
      const float b = od - cd;
      const float c = oo - 2.0f * co + s_kc[r];
      const float disc = b * b - a * c;
      const bool ok = disc >= 0.0f;
      const float sq = sqrtf(ok ? disc : 0.0f);
      const float t1 = (-b - sq) * inv_a;
      const float t2 = (-b + sq) * inv_a;
      const bool t1_ok = ok && t1 >= rt::T_MIN && t1 <= rt::T_MAX;
      const bool t2_ok = ok && t2 >= rt::T_MIN && t2 <= rt::T_MAX;
      float t = t1_ok ? t1 : (t2_ok ? t2 : rt::BIG);
      if (!(s_vld[r] > 0.0f)) t = rt::BIG;
      if (t < best) {
        best = t;
        idx = base + r;
      }
    }
  }
  if (!active) return;
  t_out[i] = best;
  const float* src = table + (size_t)idx * 24 + 8;
#pragma unroll
  for (int j = 0; j < 16; ++j) attrs_out[(size_t)i * 16 + j] = __ldg(src + j);
}

}  // namespace

// Launches the kernel on `stream` for n rays against s_rows table rows;
// returns cudaGetLastError() of the launch.
extern "C" int rt_intersect_shade(const float* o, const float* d, const float* table,
                                  float* t_out, float* attrs_out, int n, int s_rows,
                                  int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  const int grid = (n + BLOCK - 1) / BLOCK;
  intersect_shade_kernel<<<grid, BLOCK, 0, (cudaStream_t)stream>>>(
      o, d, table, t_out, attrs_out, n, s_rows);
  return (int)cudaGetLastError();
}
