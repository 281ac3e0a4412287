// Heightfield physics control step for Hopper (sm_90a): `decimation`
// substeps per env in one launch, with the env's terrain patch resident.
//
// Replaces the Pallas TPU kernel
// `wheeledlab_tpu/ops/pallas_substep_hf.py::pallas_step_hf` (body `_kernel`,
// a fori_loop of `sim/soa_hf.py::substep_soa_hf`). Its plain PyTorch
// version, and the oracle it is tested against, is
// `wheeledlab_torch/ops/physics_step_hf.py::physics_step_hf_rows` (the
// `sim/soa_hf.py::substep_soa_hf` loop). The generic manager step runs it for
// heightfield tasks: elevation training at decimation 10 with the p = 12
// contact patch.
//
// Bound: per env it reads state 21, params 46, the patch p*p, its origin 2,
// steer targets 2 and wheel targets 4 words and writes state 21: 240 words,
// 960 bytes at p = 12, about 0.29 us for 1024 envs at 3.35 TB/s. Its
// arithmetic (the per-substep count stated in chip_smoke.py, times 10) is
// below the bytes' time at the card's float32 rate only for large batches;
// at 1024 envs the grid is 16 blocks on 16 of the 132 SMs and each thread's
// chain of ~10^4 dependent operations sets the time (latency-bound).
//
// Design: one thread per env over a 1-D grid of 64-thread blocks, tail
// masked. Rows are (rows, B) row-major, so thread b reads x[r*B + b] and a
// warp's loads are coalesced. State and params stay in registers through
// all substeps. The patch (144 floats at p = 12) is too large for registers:
// each thread copies its own patch column into shared memory once (coalesced
// row by row), laid out [row][thread], and the 16 corner reads of each
// substep are indexed loads from there. With the thread index fastest, any
// per-thread row index hits bank (row*64 + t) % 32 = t % 32: the gathers are
// free of bank conflicts. Each thread reads only what it wrote, so no barrier
// is needed. 64 threads x 144 x 4 B = 36,864 B stays under the 48 KB
// default; a larger patch (p <= 30) opts in to more dynamic shared memory.
#include <cuda_runtime.h>

#include "substep_hf.cuh"

namespace wl {

constexpr int kHfThreads = 64;
constexpr int kMaxSharedBytes = 232448;  // 227 KB a block may opt in to

__global__ void __launch_bounds__(kHfThreads) physics_step_hf_kernel(
    const HfConsts c, const float* __restrict__ state,
    const float* __restrict__ params, const float* __restrict__ patch,
    const float* __restrict__ org, const float* __restrict__ steer_t,
    const float* __restrict__ wheel_t, float* __restrict__ state_out, int B) {
  extern __shared__ float smem[];  // (p*p, kHfThreads)
  const int t = threadIdx.x;
  const int b = blockIdx.x * kHfThreads + t;
  if (b >= B) return;
  const size_t n = static_cast<size_t>(B);

  const int rows = c.p * c.p;
  for (int r = 0; r < rows; ++r) smem[r * kHfThreads + t] = patch[r * n + b];

  float s[kNumState];
  float p[kNumParam];
  float st[2], wt[4];
#pragma unroll
  for (int r = 0; r < kNumState; ++r) s[r] = state[r * n + b];
#pragma unroll
  for (int r = 0; r < kNumParam; ++r) p[r] = params[r * n + b];
#pragma unroll
  for (int k = 0; k < 2; ++k) st[k] = steer_t[k * n + b];
#pragma unroll
  for (int w = 0; w < 4; ++w) wt[w] = wheel_t[w * n + b];
  const float org_x = org[b], org_y = org[n + b];

  for (int i = 0; i < c.decimation; ++i)
    substep_hf(s, p, smem + t, kHfThreads, org_x, org_y, st, wt, c);

#pragma unroll
  for (int r = 0; r < kNumState; ++r) state_out[r * n + b] = s[r];
}

}  // namespace wl

// Launch on `stream`; returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for a patch too large for one block's shared memory.
// Every pointer is a device pointer to a contiguous (rows, B) float block.
extern "C" int physics_step_hf_launch(wl::HfConsts c, const float* state,
                                      const float* params, const float* patch,
                                      const float* org, const float* steer_t,
                                      const float* wheel_t, float* state_out,
                                      int B, void* stream) {
  if (B <= 0) return 0;
  const int smem = c.p * c.p * wl::kHfThreads * static_cast<int>(sizeof(float));
  if (c.p < 2 || smem > wl::kMaxSharedBytes)
    return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        wl::physics_step_hf_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int blocks = (B + wl::kHfThreads - 1) / wl::kHfThreads;
  wl::physics_step_hf_kernel<<<blocks, wl::kHfThreads, smem,
                               static_cast<cudaStream_t>(stream)>>>(
      c, state, params, patch, org, steer_t, wheel_t, state_out, B);
  return static_cast<int>(cudaGetLastError());
}
