// A band's set-up for Hopper (sm_90a): its initial wavefront state in one
// launch.
//
// Replaces no TPU kernel.  In the JAX package a band's initial state
// (raytrace_tpu/ops/trace.py pack_state) is one jitted XLA fusion; in
// PyTorch the same function (ops/trace.py pack_state_plain) is some 650
// small elementwise launches, most of them the two TEA hashes of each
// lane's seed in masked int64, each a few microseconds of device time behind
// tens of microseconds of host dispatch.  This kernel is the same function,
// per lane and bit for bit, from the device functions the wavefront kernels
// already use: pixel_seed, camera_ray and, on the paged path, rebucket_key
// (wavefront.cuh).
//
// One thread owns one lane of the n_pad lanes and writes every row of its
// state, row r of lane k at r * n_pad + k, so each row's writes are
// coalesced along the lane axis: the lane's first pixel (lane k, or
// passign[0][k] of the balanced table, whose p_total sentinel starts dead),
// fx and fy, the first camera ray (o, d) from the pixel's TEA seed and its
// four draws, throughput 1, zeros in every other f32 row; the seed after the
// draws, sidx 1, alive (the first pixel exists and spp > 0), lane0 = k where
// the layout has that row, zeros in every other u32 row; and, given a key
// row, the lane's first sort key.  The viewport and scalar slots come by
// value in the launch's parameters, and block 0 writes them out for the
// steps, so the set-up copies nothing from the host.
//
// What bounds it on the card: the stores (rf + u_rows rows of 4 bytes a
// lane: 120 MB for the grid's 29 rows at 1080p and M = 2, ~36 us at 3.35
// TB/s) and the two 16-round TEA hashes (~600 integer operations a lane),
// in about equal parts; the viewport slots sit in shared memory, and the
// grid scalars are the same address for every lane and come from the L1.
#include <cuda_runtime.h>
#include <string.h>

#include "wavefront.cuh"

namespace {

constexpr int BLOCK = 128;

struct PackParams {
  float vpr[24];  // the viewport slots (rt::V_*), by value
  int32_t scal[8];  // the scalar slots (rt::S_*), by value
  const int32_t* passign;  // row 0 of the balanced table [m_slots, n], or null
  const float* gscal;  // [16]: the paged grid's scalars, with a key row
  float* vpr_out;  // [24]: the steps' copy of the viewport slots
  int32_t* scal_out;  // [8]: the steps' copy of the scalar slots
  float* fout;  // [rf, n]
  int32_t* uout;  // [u_rows, n]
  int32_t* key;  // [n], or null
  int n, rf, u_rows, lane0_row;  // lane0_row < 0: the layout has none
  int n_lanes, p_total, width;
};

__global__ void __launch_bounds__(BLOCK) pack_state_kernel(PackParams P) {
  __shared__ float vpr[24];
  if (threadIdx.x < 24) vpr[threadIdx.x] = P.vpr[threadIdx.x];
  if (blockIdx.x == 0 && threadIdx.x < 24) P.vpr_out[threadIdx.x] = P.vpr[threadIdx.x];
  if (blockIdx.x == 0 && threadIdx.x < 8) P.scal_out[threadIdx.x] = P.scal[threadIdx.x];
  __syncthreads();
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= P.n) return;
  const int n = P.n;
  const int pix = P.passign ? P.passign[lane] : lane;
  const bool first = P.passign ? pix < P.p_total : lane < P.n_lanes;
  const bool alive = first && P.scal[rt::S_SPP] > 0;
  const int px = pix % P.width;
  const int py = pix / P.width;
  const float fx = (float)(P.scal[rt::S_OFFX] + px);
  const float fy = (float)(P.scal[rt::S_Y0] + py);
  uint32_t seed = rt::pixel_seed(px, P.scal[rt::S_SEEDY0] + py,
                                 (uint32_t)P.scal[rt::S_NUMBER]);
  const rt::Ray r = rt::camera_ray(seed, fx, fy, vpr);

  P.fout[(rt::R_O + 0) * n + lane] = r.ox;
  P.fout[(rt::R_O + 1) * n + lane] = r.oy;
  P.fout[(rt::R_O + 2) * n + lane] = r.oz;
  P.fout[(rt::R_D + 0) * n + lane] = r.dx;
  P.fout[(rt::R_D + 1) * n + lane] = r.dy;
  P.fout[(rt::R_D + 2) * n + lane] = r.dz;
  P.fout[rt::R_FX * n + lane] = fx;
  P.fout[rt::R_FY * n + lane] = fy;
  for (int c = 0; c < 3; ++c) P.fout[(rt::R_THR + c) * n + lane] = 1.0f;
  for (int row = rt::R_THR + 3; row < P.rf; ++row) P.fout[row * n + lane] = 0.0f;
  for (int row = 0; row < P.u_rows; ++row) {
    int32_t v = 0;
    if (row == rt::U_SEED) v = (int32_t)seed;
    else if (row == rt::U_SIDX) v = 1;
    else if (row == rt::U_ALIVE) v = alive ? 1 : 0;
    else if (row == P.lane0_row) v = lane;
    P.uout[row * n + lane] = v;
  }
  if (P.key)
    P.key[lane] = rt::rebucket_key(P.gscal, alive, false, 0, r.ox, r.oy, r.oz,
                                   r.dx, r.dy, r.dz);
}

}  // namespace

// Launches the set-up of n lanes on `stream`; returns cudaGetLastError() of
// the launch.  `vpr_host` [24] and `scal_host` [8] are host arrays, read
// here into the launch's parameters (the kernel writes them to `vpr` and
// `scal` on the device); `passign`, `gscal` and `key` may be NULL (no
// balanced table; no key row).
extern "C" int rt_pack_state(const float* vpr_host, const int32_t* scal_host,
                             const int32_t* passign, const float* gscal, float* vpr,
                             int32_t* scal, float* fout, int32_t* uout, int32_t* key,
                             int n, int rf, int u_rows, int lane0_row, int n_lanes,
                             int p_total, int width, int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  if (n == 0) return 0;
  PackParams P{};
  memcpy(P.vpr, vpr_host, sizeof(P.vpr));
  memcpy(P.scal, scal_host, sizeof(P.scal));
  P.passign = passign;
  P.gscal = gscal;
  P.vpr_out = vpr;
  P.scal_out = scal;
  P.fout = fout;
  P.uout = uout;
  P.key = key;
  P.n = n;
  P.rf = rf;
  P.u_rows = u_rows;
  P.lane0_row = lane0_row;
  P.n_lanes = n_lanes;
  P.p_total = p_total;
  P.width = width;
  const int grid = (n + BLOCK - 1) / BLOCK;
  pack_state_kernel<<<grid, BLOCK, 0, (cudaStream_t)stream>>>(P);
  return (int)cudaGetLastError();
}
