// Fused closest-hit intersection + attribute fetch for Hopper (sm_90a): the
// `pallas` backend.
//
// Replaces the Pallas TPU kernel `_intersect_pallas_padded` in
// raytrace_tpu/ops/pallas_intersect.py (its `_kernel`).  Stateless: each ray
// loops over the rows of the packed sphere table (ops/intersect.sphere_table)
// in the TPU kernel's op order -- a, od, oo as x + y + z sums and one
// reciprocal of a; cd, co; b = od - cd; c = oo - 2 co + kc; disc; both roots
// checked against tMin and tMax; the valid column; BIG on a miss -- keeping
// the lowest index among the minima (strict < in index order, from best =
// BIG, idx = 0), then copies the winner's 16 attribute columns, table[idx,
// 8:24].  The TPU kernel does that fetch as a one-hot matrix product at
// HIGHEST precision, which is exact, so the load gives the same bits; a ray
// that hits nothing gets row 0's attributes, as the one-hot contraction
// gives it.
//
// What bounds it on the card: the instruction count of the (ray, row) scan --
// about 17 fp32 operations and a compare per pair on a miss, the root and
// the range checks on a hit -- not bytes (each ray reads 24 bytes and writes
// 68).  A miss is ~22 instructions in the SASS (one 16-byte shared load, the
// 17 operations, the compare, the branch and its convergence barrier), and
// ptxas unrolls the row loop by 4.  What the design does about it:
// - the table is staged once per block and chunk in shared memory as one
//   16-byte record per row (cx, cy, cz, kc), and an invalid row's cx is
//   staged as NaN, which makes its disc NaN: the same miss as the valid
//   column's BIG, with no check in the scan;
// - one thread owns one ray: owning 2 or 4 (one shared-memory load feeding
//   2 or 4 quadratics) measured slower on the card (PERF.md), since
//   the extra registers cost more resident warps than the loads saved;
// - a miss (disc < 0 or NaN) takes neither the root nor the range checks;
// - the caller may give the table's valid prefix (`s_rows`): prepare_scene's
//   tables put the scene's spheres first, so the padding rows are not
//   scanned; a table whose valid rows are not a prefix is scanned whole;
// - the 16 attributes go out as four 16-byte stores.
#include <cuda_runtime.h>

#include "wavefront.cuh"

namespace {

constexpr int BLOCK = 128;
constexpr int CHUNK = 1024;  // table rows staged in shared memory per pass (16 KB)

__global__ void __launch_bounds__(BLOCK) intersect_shade_kernel(
    const float* __restrict__ o, const float* __restrict__ d,
    const float* __restrict__ table, float* __restrict__ t_out,
    float* __restrict__ attrs_out, int n, int s_rows) {
  __shared__ float4 s_row[CHUNK];
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
    for (int r = threadIdx.x; r < rows; r += BLOCK) {
      const float* row = table + (size_t)(base + r) * 24;
      float4 v = __ldg(reinterpret_cast<const float4*>(row));
      if (!(__ldg(row + 4) > 0.0f)) v.x = __int_as_float(0x7fc00000);  // invalid: a miss
      s_row[r] = v;
    }
    __syncthreads();
    if (!active) continue;
    for (int r = 0; r < rows; ++r) {  // ptxas unrolls this by 4
      const float4 c = s_row[r];
      const float cd = c.x * dx + c.y * dy + c.z * dz;
      const float co = c.x * ox + c.y * oy + c.z * oz;
      const float b = od - cd;
      const float cc = oo - 2.0f * co + c.w;
      const float disc = b * b - a * cc;
      if (disc >= 0.0f) {  // a miss's roots would fail both checks
        const float sq = sqrtf(disc);
        const float t1 = (-b - sq) * inv_a;
        const float t2 = (-b + sq) * inv_a;
        const bool t1_ok = t1 >= rt::T_MIN && t1 <= rt::T_MAX;
        const bool t2_ok = t2 >= rt::T_MIN && t2 <= rt::T_MAX;
        const float t = t1_ok ? t1 : (t2_ok ? t2 : rt::BIG);
        if (t < best) {
          best = t;
          idx = base + r;
        }
      }
    }
  }
  if (!active) return;
  t_out[i] = best;
  const float4* src = reinterpret_cast<const float4*>(table + (size_t)idx * 24 + 8);
  float4* dst = reinterpret_cast<float4*>(attrs_out + (size_t)i * 16);
#pragma unroll
  for (int j = 0; j < 4; ++j) dst[j] = __ldg(src + j);
}

}  // namespace

// Launches the kernel on `stream` for n rays against the first s_rows table
// rows; returns cudaGetLastError() of the launch.  The table must be 16-byte
// aligned.
extern "C" int rt_intersect_shade(const float* o, const float* d, const float* table,
                                  float* t_out, float* attrs_out, int n, int s_rows,
                                  int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  if (n == 0) return 0;
  const int grid = (n + BLOCK - 1) / BLOCK;
  intersect_shade_kernel<<<grid, BLOCK, 0, (cudaStream_t)stream>>>(o, d, table, t_out,
                                                                   attrs_out, n, s_rows);
  return (int)cudaGetLastError();
}

// out[0] resident blocks per SM, out[1] registers per thread, out[2] local
// memory per thread (bytes), out[3] static shared memory per block (bytes).
// Returns a cudaError_t.
extern "C" int rt_intersect_occupancy(int device, int* out) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  const auto fn = intersect_shade_kernel;
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
