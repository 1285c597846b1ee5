// The lane-gather probe and its loop baseline for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of scripts/bench_gather.py: `run`
// (body `_kernel`) and `run_base` (body `_kernel_base`).  Both take a
// [R, T] = [16, 1024] f32 table and [16, 1024] i32 indices and compute, for
// `iters` iterations summed in order from 0 (acc + g, no reassociation):
// - gather, axis 1: out[r, t] = sum_i tab[r, (idx[r, t] + i) mod T], a
//   per-lane gather along the row;
// - gather, axis 0: out[r, t] = sum_i tab[(idx[r, t] + i) mod T, t], a row
//   gather; a row index >= R is out of range and gives NaN, as JAX's
//   take_along_axis does in its default fill mode;
// - baseline: out[r, t] = sum_i tab[r, t] * 1.0000001f, the same loop with
//   no gather (the multiply and the add stay two roundings: --fmad=false).
// `mod` is floor modulo of the int32 sum as JAX computes it (wrapping on
// overflow); T is a power of two, so that is `& (T - 1)` of the sum's bits.
//
// The TPU program had the whole chip and its VMEM; here a block of T
// threads computes the whole [R, T] problem into its own slice of an
// [blocks, R, T] output, so one block measures one SM and one block per SM
// measures the card.  One thread owns lane t and keeps its R indices and R
// running sums in registers.  The table sits in dynamic shared memory (the
// counterpart of VMEM), over the 48 KB a block gets without
// cudaFuncAttributeMaxDynamicSharedMemorySize: row-major [R][T] (64 KB), and
// for axis 0 a row of NaN after it (68 KB), for axis 1 a record-major copy
// (192 KB in all).
//
// What bounds it on the card: shared memory, which serves one wavefront (32
// four-byte words, one per bank) per clock per SM, so one [16, 1024] gather
// takes at least R * T / 32 = 512 clocks on an SM, and more where the
// addresses of a warp's load share a bank: a 32-bit load takes as many
// wavefronts as its busiest bank has distinct words, and the card serves a
// 128-bit load per quarter-warp (8 lanes, 128 bytes), each quarter taking
// its busiest bank's distinct words.  `shared_wavefronts` in
// scripts/bench_gather.py counts them for given indices.  The paths:
// - axis 1, a warp whose lanes each have one index for all R rows (the
//   grid kernels' use: one cell id per lane, R attributes of that record):
//   the record path.  Record j, the column tab[:, j], fills the 128-byte
//   line j of the record-major copy twice, once in each half (copy 0 on
//   bank quads 0-3, copy 1 on bank quads 4-7: `record_slot`).  A lane reads
//   copy (t >> 2) & 1 with four 128-bit loads an iteration, quad
//   (k + t) & 3 at step k (`record_quad`), so the 8 lanes of a quarter-warp
//   hit the 8 bank quads once each whatever their records: 512 wavefronts
//   an iteration per SM, the bound.  (One copy, two records a line with an
//   XOR swizzle, counts 1336 on the seeded per-lane indices per
//   quarter-warp: the spread of 8 random records over 8 bank quads.)  Its
//   sums are kept in the order of the loads and stored to their rows at the
//   end;
// - axis 1, any other warp: the row path, one 32-bit load per row from the
//   row-major copy.  Random words of a row share banks (the seeded random
//   indices: 1741 wavefronts, the least that random words allow in any
//   layout; 1648 on the seeded per-lane indices, were they to take it);
// - axis 0: one 32-bit load per value, the index carried in the top bits of
//   a register so that one add wraps it mod T, and every row past R - 1
//   sent to the NaN row by one unsigned min (no select): conflict-free
//   (512 wavefronts), five instructions a value.
// Which axis-1 path a warp takes is decided on the card, per warp, by a
// vote at load time.  Both add the same values into the same sums in the
// same order, so the bits do not depend on the path.  The fp32 adds (one
// per gathered value) need 128 clocks per iteration at 128 per clock per
// SM; the baseline is bound by them.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int R = 16;
constexpr int T = 1024;
constexpr int LOG_T = 10;
constexpr int QUADS = R / 4;  // 16-byte slots of one record
constexpr int ROWS_BYTES = R * T * 4;
// axis 0: the rows and the NaN row; axis 1: the rows and the record copy
constexpr int SMEM_BYTES_AXIS0 = ROWS_BYTES + T * 4;
constexpr int SMEM_BYTES_AXIS1 = 3 * ROWS_BYTES;
// axis 0's carried index: j in the top LOG_T bits, the lane in the LOG_T
// bits below, so that u >> U_TO_BYTES is the byte offset j * 4T + 4t
constexpr int J_SHIFT = 32 - LOG_T;
constexpr int U_TO_BYTES = J_SHIFT - LOG_T - 2;
static_assert(T == 1 << LOG_T, "T must be 2^LOG_T (floor modulo as a mask)");
static_assert(R == 16 && R < T, "a record is four 16-byte quads; the NaN row is a row index");

// The 16-byte slot of quad q (rows 4q .. 4q + 3) of record j that lane
// `lane` reads in the record-major copy: record j fills line j (8 slots,
// the 32 banks once) twice, copy (lane >> 2) & 1 in slots 4c .. 4c + 3.
// Mirrors record_slot in scripts/bench_gather.py.
__device__ __forceinline__ uint32_t record_slot(uint32_t j, uint32_t q, uint32_t lane) {
  return 8 * j + 4 * ((lane >> 2) & 1) + q;
}

// The quad that lane `lane` loads at step k of an iteration, so that the
// four lanes of a quarter-warp on one copy load four different quads.
// Mirrors record_quad in scripts/bench_gather.py.
__device__ __forceinline__ uint32_t record_quad(uint32_t k, uint32_t lane) {
  return (k + lane) & 3;
}

template <int AXIS>
__global__ void __launch_bounds__(T) gather_bench_kernel(const float* __restrict__ tab,
                                                         const int32_t* __restrict__ idx,
                                                         float* __restrict__ out, int iters) {
  extern __shared__ float4 s_mem[];
  float* s_tab = reinterpret_cast<float*>(s_mem);  // [R][T], axis 0: [R + 1][T]
  float4* s_rec = s_mem + R * T / 4;               // axis 1: [T][2][QUADS]
  const int t = threadIdx.x;
  uint32_t m[R];
  float v[R], acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    v[r] = tab[r * T + t];
    s_tab[r * T + t] = v[r];
    m[r] = (uint32_t)idx[r * T + t];
    acc[r] = 0.0f;
  }
  if constexpr (AXIS == 0) {
    s_tab[R * T + t] = __int_as_float(0x7fc00000);  // the NaN row
  } else {
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int q = 0; q < QUADS; ++q)
        s_rec[record_slot(t, q, 4 * c)] =
            make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
  }
  __syncthreads();
  // sum a belongs to row 4 * record_quad(a / 4, rot) + a % 4: the record
  // path keeps its sums in the order of its loads (rot = t), the others
  // in the rows' (rot = 0)
  uint32_t rot = 0;
  if constexpr (AXIS == 0) {
    const uint32_t lane = (uint32_t)t << (J_SHIFT - LOG_T);
    const uint32_t nan_row = ((uint32_t)R << J_SHIFT) | lane;
    uint32_t u[R];
#pragma unroll
    for (int r = 0; r < R; ++r) u[r] = (m[r] << J_SHIFT) | lane;
    const char* base = reinterpret_cast<const char*>(s_tab);
    for (int i = 0; i < iters; ++i) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const uint32_t a = min(u[r], nan_row);
        acc[r] = acc[r] + *reinterpret_cast<const float*>(base + (a >> U_TO_BYTES));
        u[r] += 1u << J_SHIFT;
      }
    }
  } else {
    bool one = true;
#pragma unroll
    for (int r = 1; r < R; ++r) one = one && m[r] == m[0];
    if (__all_sync(0xffffffffu, one)) {
      for (int i = 0; i < iters; ++i) {
        const uint32_t j = (m[0] + (uint32_t)i) & (uint32_t)(T - 1);
#pragma unroll
        for (int k = 0; k < QUADS; ++k) {
          const float4 g = s_rec[record_slot(j, record_quad(k, t), t)];
          acc[4 * k] = acc[4 * k] + g.x;
          acc[4 * k + 1] = acc[4 * k + 1] + g.y;
          acc[4 * k + 2] = acc[4 * k + 2] + g.z;
          acc[4 * k + 3] = acc[4 * k + 3] + g.w;
        }
      }
      rot = t;
    } else {
      for (int i = 0; i < iters; ++i) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const uint32_t j = (m[r] + (uint32_t)i) & (uint32_t)(T - 1);
          acc[r] = acc[r] + s_tab[r * T + j];
        }
      }
    }
  }
  float* o = out + (size_t)blockIdx.x * R * T;
#pragma unroll
  for (int r = 0; r < R; ++r) o[(4 * record_quad(r / 4, rot) + r % 4) * T + t] = acc[r];
}

__global__ void __launch_bounds__(T) gather_base_kernel(const float* __restrict__ tab,
                                                        float* __restrict__ out, int iters) {
  const int t = threadIdx.x;
  float v[R], acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    v[r] = tab[r * T + t];
    acc[r] = 0.0f;
  }
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = acc[r] + v[r] * 1.0000001f;
  }
  float* o = out + (size_t)blockIdx.x * R * T;
#pragma unroll
  for (int r = 0; r < R; ++r) o[r * T + t] = acc[r];
}

}  // namespace

// Launches the gather kernel (axis 0 or 1) on `stream` over `blocks` blocks,
// each writing its [R, T] slice of `out` [blocks, R, T]; returns a
// cudaError_t (the attribute call's, or cudaGetLastError() of the launch).
extern "C" int rt_gather_bench(const float* tab, const int32_t* idx, float* out, int iters,
                               int axis, int blocks, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (axis != 0 && axis != 1) return (int)cudaErrorInvalidValue;
  const auto fn = axis == 1 ? gather_bench_kernel<1> : gather_bench_kernel<0>;
  const int smem = axis == 1 ? SMEM_BYTES_AXIS1 : SMEM_BYTES_AXIS0;
  e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  fn<<<blocks, T, smem, (cudaStream_t)stream>>>(tab, idx, out, iters);
  return (int)cudaGetLastError();
}

// Launches the baseline kernel the same way (it reads no indices).
extern "C" int rt_gather_base(const float* tab, float* out, int iters, int blocks, int device,
                              void* stream) {
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  gather_base_kernel<<<blocks, T, 0, (cudaStream_t)stream>>>(tab, out, iters);
  return (int)cudaGetLastError();
}
