// Fused drift control step for Hopper (sm_90a): one whole env step per env.
//
// Replaces the Pallas TPU kernel
// `wheeledlab_tpu/tasks/drift/fused.py::fused_drift_pallas` (body `_kernel` ->
// `_kernel_epilogue` -> `drift_step_rows`). Its plain PyTorch version, and the
// oracle it is tested against, is
// `wheeledlab_torch/tasks/drift/fused.py::drift_step_rows`.
//
// Per env: action map -> 4 x flat-ground substep -> velocity pushes -> oval
// out-of-bounds and time-out terminations -> 7 weighted reward terms ->
// episode return/length -> masked auto-reset with spawn from the pose table
// -> 14-row observation with Gaussian noise.
//
// Bound: with push events and observation noise on, per env per step the
// kernel reads 96 words (state 21, params 46, actions 2, uniforms 10, normals
// 12, step count 1, push timers 2, episode return 1, episode length 1) and
// writes 55 (state 21, obs 14, info 15, step count 1, timers 2, return 1,
// length 1): 604 bytes. Two uniform rows are never read (the second push
// event moves only the yaw rate) and two normal rows neither (the action
// rows of the observation carry no noise). At 16384 envs that is 9.9 MB,
// about 2.95 us at the H100's 3.35 TB/s; at the 1024 envs of the training
// config it is 0.62 MB, about 0.18 us. Its arithmetic (about 3400 float
// operations per env) is below the card's float32 rate, so bytes bound it.
// The kernel is far from that bound at either size: what it waits for is
// the latency of each thread's chain of dependent float operations, IEEE
// divisions and precise sinf/cosf/tanhf included (times in PERF.md). The
// design below shortens the chain and gives every warp scheduler more than
// one warp to choose from; the bound counts an env's work once, not the
// lanes that repeat it.
//
// Design: 4 adjacent lanes per env, lane w owning wheel w (`substep.cuh`
// says who computes what and why the six force sums are taken in wheel
// order); 4 warps, 32 envs, a block over a 1-D grid, the tail groups masked
// at their stores (B need not be a multiple of anything). 1024 envs are 32
// blocks on 32 of the card's 132 SMs, a warp a scheduler; 16384 envs are 512
// blocks, 15 or 16 warps an SM (4 a scheduler), all resident at once since
// a thread is held to 128 registers (`kMinBlocksPerSm`). A lane keeps 16 of
// the 21 state rows and 28 of the 46 parameter rows in registers through the
// 4 substeps and the epilogue: state touches device memory once in and once
// out. Rows are (rows, B) row-major: a warp's load of a row its groups share
// is 8 consecutive floats, one 32-byte sector (the 4 lanes of a group read
// one address, which the hardware broadcasts); a per-wheel row is 4 sectors;
// each output row is stored once, by one lane of the group
// (`drift_step.cuh::fused_step_lane`). The 7 curriculum weights and the
// (N, 4) pose table are small device buffers read through the read-only
// cache. Compile-time constants of the step arrive by value in
// `FusedDriftConsts`. The step itself is `drift_step.cuh::drift_step`,
// shared with `fused_drift_krng.cu` and `multi_step.cu`; here its random
// rows are read from device memory (`GlobalRows`).
#include <cuda_runtime.h>
#include <stdint.h>

#include "drift_step.cuh"

namespace wl {

__global__ void __launch_bounds__(kBlockThreads, kMinBlocksPerSm)
fused_drift_kernel(
    const FusedDriftConsts c, const float* __restrict__ weights,
    const float* __restrict__ poses, const float* __restrict__ state,
    const float* __restrict__ params, const float* __restrict__ actions,
    const float* __restrict__ uniforms, const float* __restrict__ normals,
    const int32_t* __restrict__ step_count, const int32_t* __restrict__ timers,
    const float* __restrict__ ep_return, const int32_t* __restrict__ ep_len,
    float* __restrict__ state_out, float* __restrict__ obs_out,
    float* __restrict__ out, int32_t* __restrict__ step_out,
    int32_t* __restrict__ timers_out, float* __restrict__ epret_out,
    int32_t* __restrict__ eplen_out, int B) {
  const LaneId id = lane_id(B);
  const size_t n = static_cast<size_t>(B);
  GlobalRows rows{uniforms, normals, n, id.b};
  fused_step_lane(c, weights, poses, state, params, actions, rows, step_count,
                  timers, ep_return, ep_len, state_out, obs_out, out, step_out,
                  timers_out, epret_out, eplen_out, id, n);
}

}  // namespace wl

// Launch on `stream`; returns cudaGetLastError() (0 on success). Every
// pointer is a device pointer to a contiguous (rows, B) block.
extern "C" int fused_drift_launch(
    wl::FusedDriftConsts c, const float* weights, const float* poses,
    const float* state, const float* params, const float* actions,
    const float* uniforms, const float* normals, const int32_t* step_count,
    const int32_t* timers, const float* ep_return, const int32_t* ep_len,
    float* state_out, float* obs_out, float* out, int32_t* step_out,
    int32_t* timers_out, float* epret_out, int32_t* eplen_out, int B,
    void* stream) {
  if (B <= 0) return 0;
  wl::fused_drift_kernel<<<wl::blocks_for(B), wl::kBlockThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      c, weights, poses, state, params, actions, uniforms, normals,
      step_count, timers, ep_return, ep_len, state_out, obs_out, out,
      step_out, timers_out, epret_out, eplen_out, B);
  return static_cast<int>(cudaGetLastError());
}
