// Fused drift control step with its random rows drawn in the kernel, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// `wheeledlab_tpu/tasks/drift/fused.py::fused_drift_pallas_krng` (body
// `_kernel_krng`): `fused_drift.cu`'s step, but the 12 uniform and 14 normal
// rows never exist in device memory. The kernel takes one int32 seed (read
// through its device pointer, so no host read and safe inside a CUDA graph)
// and draws each env's rows from Philox4x32-10 (`philox.cuh`): a draw depends
// only on (seed, env index, draw index). Its plain PyTorch version, and the
// oracle it is tested against word for word, is
// `wheeledlab_torch/ops/kernel_rng.py::philox_blocks` followed by
// `wheeledlab_torch/tasks/drift/fused.py::drift_step_rows`.
//
// Bound: against `fused_drift.cu` it reads 1 word of seed in place of the 22
// random words per env that the step uses, so 74 words in and 55 out, 516
// bytes per env: 8.5 MB at 16384 envs, about 2.5 us at the H100's 3.35 TB/s;
// 0.53 MB, about 0.16 us, at 1024 envs. On top of the step's ~3400 float
// operations an env needs 10 Philox calls (each 10 rounds of 2 wide
// multiplies, 2 low multiplies, 4 xors and 2 adds: 1000 integer operations)
// and 12 Box-Muller normals; both stay far below the card's rates, so bytes
// bound it, and like `fused_drift.cu` it runs at the latency of a lane's
// dependent chain at 1024 envs and at the rate its warps issue instructions
// at 16384.
//
// Design: `fused_drift.cu`'s (4 lanes per env, a wheel a lane, 4 warps a
// block), with `philox.cuh::PhiloxGroupRows` as the step's row source. The
// group draws its env's rows together, in three rounds of one Philox call a
// lane (uniform rows, `u1`, `u2`), so no lane repeats another's draws: a
// uniform row comes by one shuffle from the lane whose call holds it, so
// all 4 lanes hold the same bits for the pushes, timers and spawn; the
// normal draws are transposed within the group (4 shuffles a round) so that
// lane w holds the draws of observation rows 4 k + w, the rows it stores,
// and computes only those 3 normals. The rows are drawn before the step, in
// one straight block whose latency hides under the step's state and
// parameter loads and which the compiler inlines once (drawn where the step
// reads them, each reading site carried its own copy of the drawing code,
// which more than doubled the kernel's instructions and measured slower:
// PERF.md). With observation noise off only the uniform round runs, and the
// normals of the action rows, which carry no noise, are not drawn. The
// words, the extraction and Box-Muller are unchanged, so the rows are
// bit-equal to `rng_blocks.cu`'s.
#include <cuda_runtime.h>
#include <stdint.h>

#include "drift_step.cuh"
#include "philox.cuh"

namespace wl {

// Whether the step reads a normal row of slot k (rows 4 k .. 4 k + 3; a row
// with noise std 0 is not read).
__device__ __forceinline__ bool reads_normal_slot(const FusedDriftConsts& c,
                                                  int k) {
  bool any = false;
#pragma unroll
  for (int i = kLanesPerEnv * k; i < kLanesPerEnv * (k + 1); ++i)
    if (i < kObsRows) any = any || c.obs_std[i] != 0.f;
  return any;
}

__global__ void __launch_bounds__(kBlockThreads, kMinBlocksPerSm)
fused_drift_krng_kernel(
    const FusedDriftConsts c, const float* __restrict__ weights,
    const float* __restrict__ poses, const float* __restrict__ state,
    const float* __restrict__ params, const float* __restrict__ actions,
    const int32_t* __restrict__ seed, const int32_t* __restrict__ step_count,
    const int32_t* __restrict__ timers, const float* __restrict__ ep_return,
    const int32_t* __restrict__ ep_len, float* __restrict__ state_out,
    float* __restrict__ obs_out, float* __restrict__ out,
    int32_t* __restrict__ step_out, int32_t* __restrict__ timers_out,
    float* __restrict__ epret_out, int32_t* __restrict__ eplen_out, int B) {
  const LaneId id = lane_id(B);
  const size_t n = static_cast<size_t>(B);
  PhiloxGroupRows rows(static_cast<uint32_t>(__ldg(seed)),
                       static_cast<uint32_t>(id.b), id.w);
  // the rows are drawn before the step, while its state and parameter loads
  // are in flight; the last slot (the action rows, which carry no noise in
  // the drift tasks) only where it is read
  rows.draw_uniform();
  if (c.enable_corruption) {
    if (reads_normal_slot(c, kGroupSlots - 1))
      rows.draw_normals<kGroupSlots>();
    else
      rows.draw_normals<kGroupSlots - 1>();
  }
  fused_step_lane(c, weights, poses, state, params, actions, rows, step_count,
                  timers, ep_return, ep_len, state_out, obs_out, out, step_out,
                  timers_out, epret_out, eplen_out, id, n);
}

}  // namespace wl

// Launch on `stream`; returns cudaGetLastError() (0 on success). Every
// pointer is a device pointer: `seed` to one int32, the others to contiguous
// (rows, B) blocks.
extern "C" int fused_drift_krng_launch(
    wl::FusedDriftConsts c, const float* weights, const float* poses,
    const float* state, const float* params, const float* actions,
    const int32_t* seed, const int32_t* step_count, const int32_t* timers,
    const float* ep_return, const int32_t* ep_len, float* state_out,
    float* obs_out, float* out, int32_t* step_out, int32_t* timers_out,
    float* epret_out, int32_t* eplen_out, int B, void* stream) {
  if (B <= 0) return 0;
  wl::fused_drift_krng_kernel<<<wl::blocks_for(B), wl::kBlockThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      c, weights, poses, state, params, actions, seed, step_count, timers,
      ep_return, ep_len, state_out, obs_out, out, step_out, timers_out,
      epret_out, eplen_out, B);
  return static_cast<int>(cudaGetLastError());
}
