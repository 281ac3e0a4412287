// The in-kernel generator's random blocks alone, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of `scripts/check_kernel_rng.py` (`run`,
// body `_kern`): the bit extraction and Box-Muller of the in-kernel-RNG drift
// step, written out as a (12, B) uniform block and a (14, B) normal block so
// that their distribution can be checked. Here the blocks are exactly the
// rows that `fused_drift_krng.cu` draws for the same seed: both use
// `philox.cuh::PhiloxRows`, so env b's draw j is the same word in both. Its
// plain PyTorch version, and the oracle it is tested against word for word,
// is `wheeledlab_torch/ops/kernel_rng.py::philox_blocks`.
//
// Bound: it reads one word and writes 26 words, 104 bytes, per env: 1.7 MB at
// 16384 envs, about 0.51 us at the H100's 3.35 TB/s. Per env it does 11
// Philox calls (1100 integer operations) and 14 Box-Muller normals, which
// stay below the card's rates, so bytes bound it.
//
// Design: one thread per env over a 1-D grid, tail masked; a warp's stores of
// one row are coalesced.
#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"

namespace wl {

__global__ void __launch_bounds__(128) rng_blocks_kernel(
    const int32_t* __restrict__ seed, float* __restrict__ uniforms,
    float* __restrict__ normals, int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const size_t n = static_cast<size_t>(B);
  PhiloxRows rows(static_cast<uint32_t>(__ldg(seed)),
                  static_cast<uint32_t>(b));
#pragma unroll
  for (int r = 0; r < kRngUniformRows; ++r)
    uniforms[r * n + b] = rows.uniform(r);
#pragma unroll
  for (int r = 0; r < kRngNormalRows; ++r) normals[r * n + b] = rows.normal(r);
}

}  // namespace wl

// Launch on `stream`; returns cudaGetLastError() (0 on success). `seed`
// points at one int32 on the device, `uniforms` at a (12, B) and `normals` at
// a (14, B) contiguous float block.
extern "C" int rng_blocks_launch(const int32_t* seed, float* uniforms,
                                 float* normals, int B, void* stream) {
  if (B <= 0) return 0;
  const int threads = 128;
  const int blocks = (B + threads - 1) / threads;
  wl::rng_blocks_kernel<<<blocks, threads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      seed, uniforms, normals, B);
  return static_cast<int>(cudaGetLastError());
}
