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
// measures the card.  The table sits in dynamic shared memory (the
// counterpart of VMEM; 64 KB, over the 48 KB a block gets without
// cudaFuncAttributeMaxDynamicSharedMemorySize).  One thread owns lane t and
// keeps its R indices and R running sums in registers.
//
// What bounds it on the card: shared memory, which serves 32 four-byte words
// per clock per SM, so one [16, 1024] gather takes at least R * T / 32 = 512
// clocks on an SM, more where the 32 addresses of a warp share a bank
// (random lanes: ~3.5 words per bank at the worst bank of a warp on
// average).  The fp32 adds (one per gathered value) need 128 clocks per
// iteration at 128 per clock per SM; the baseline is bound by them.  The
// design keeps every other cost off that path: indices and sums in
// registers, the index arithmetic two integer operations a value, the axis
// a template parameter, no synchronisation inside the loop.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int R = 16;
constexpr int T = 1024;
constexpr int TAB_BYTES = R * T * 4;
static_assert((T & (T - 1)) == 0, "T must be a power of two (floor modulo as a mask)");

template <int AXIS>
__global__ void __launch_bounds__(T) gather_bench_kernel(const float* __restrict__ tab,
                                                         const int32_t* __restrict__ idx,
                                                         float* __restrict__ out, int iters) {
  extern __shared__ float s_tab[];  // [R][T]
  const int t = threadIdx.x;
  uint32_t m[R];
  float acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    s_tab[r * T + t] = tab[r * T + t];
    m[r] = (uint32_t)idx[r * T + t];
    acc[r] = 0.0f;
  }
  __syncthreads();
  const float nan = __int_as_float(0x7fc00000);
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const uint32_t j = (m[r] + (uint32_t)i) & (uint32_t)(T - 1);
      float g;
      if (AXIS == 1) {
        g = s_tab[r * T + j];
      } else {
        g = j < (uint32_t)R ? s_tab[j * T + t] : nan;
      }
      acc[r] = acc[r] + g;
    }
  }
  float* o = out + (size_t)blockIdx.x * R * T;
#pragma unroll
  for (int r = 0; r < R; ++r) o[r * T + t] = acc[r];
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
  e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, TAB_BYTES);
  if (e != cudaSuccess) return (int)e;
  fn<<<blocks, T, TAB_BYTES, (cudaStream_t)stream>>>(tab, idx, out, iters);
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
