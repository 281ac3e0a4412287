// The in-kernel generator's random blocks alone, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of `scripts/check_kernel_rng.py` (`run`,
// body `_kern`): the bit extraction and Box-Muller of the in-kernel-RNG drift
// step, written out as a (12, B) uniform block and a (14, B) normal block so
// that their distribution can be checked. Here the blocks are exactly the
// rows that `fused_drift_krng.cu` draws for the same seed: both use
// `philox.cuh::PhiloxGroupRows`, so env b's draw j is the same word in both.
// Its plain PyTorch version, and the oracle it is tested against word for
// word, is `wheeledlab_torch/ops/kernel_rng.py::philox_blocks`.
//
// Bound: it reads one word and writes 26 words, 104 bytes, per env: 1.7 MB at
// 16384 envs, about 0.51 us at the H100's 3.35 TB/s. Per env it needs 10
// Philox calls (1000 integer operations) and 14 Box-Muller normals, which
// stay below the card's rates, so bytes bound it; at these widths a launch
// is a few us, the latency of one lane's chain above the launch floor.
//
// Design: 4 lanes an env, the group of `substep.cuh` (8 envs a warp, 128
// threads a block), so that 4 times the warps share an env's chain (one
// thread per env left 32 blocks on 32 of the 132 SMs at 4096 envs). The
// group draws in three rounds of one Philox call a lane
// (`PhiloxGroupRows`), and lane w stores uniform rows w, w + 4, w + 8 and
// normal rows 4 k + w, computing only those normals. A warp's store of one
// row index covers 8 consecutive envs: 4 rows x 32 bytes, whole sectors
// when B is a multiple of 8. A tail group draws for a copy of the last env
// and stores nothing, so every lane reaches every shuffle.
#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"

namespace wl {

constexpr int kUniformSlots = kRngUniformRows / kLanesPerEnv;
constexpr int kNormalSlots =
    (kRngNormalRows + kLanesPerEnv - 1) / kLanesPerEnv;
static_assert(kUniformSlots * kLanesPerEnv == kRngUniformRows &&
                  kNormalSlots <= kGroupSlots,
              "a lane's rows are 4 k + w");

__global__ void __launch_bounds__(kBlockThreads) rng_blocks_kernel(
    const int32_t* __restrict__ seed, float* __restrict__ uniforms,
    float* __restrict__ normals, int B) {
  const LaneId id = lane_id(B);
  const size_t n = static_cast<size_t>(B);
  PhiloxGroupRows rows(static_cast<uint32_t>(__ldg(seed)),
                       static_cast<uint32_t>(id.b), id.w);
  rows.draw_own_uniform();
  rows.draw_normals<kNormalSlots>();
  if (!id.live) return;
#pragma unroll
  for (int k = 0; k < kUniformSlots; ++k)
    uniforms[(kLanesPerEnv * k + id.w) * n + id.b] = rows.own_uniform(k);
#pragma unroll
  for (int k = 0; k < kNormalSlots; ++k) {
    const int row = kLanesPerEnv * k + id.w;
    if (row < kRngNormalRows) normals[row * n + id.b] = rows.own_normal(k);
  }
}

}  // namespace wl

// Launch on `stream`; returns cudaGetLastError() (0 on success). `seed`
// points at one int32 on the device, `uniforms` at a (12, B) and `normals` at
// a (14, B) contiguous float block.
extern "C" int rng_blocks_launch(const int32_t* seed, float* uniforms,
                                 float* normals, int B, void* stream) {
  if (B <= 0) return 0;
  wl::rng_blocks_kernel<<<wl::blocks_for(B), wl::kBlockThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      seed, uniforms, normals, B);
  return static_cast<int>(cudaGetLastError());
}
