// K drift control steps in one launch, for Hopper (sm_90a): an open-loop
// rollout with the state resident.
//
// Replaces the Pallas TPU kernel `scripts/limiter_probe.py::
// multi_step_pallas` (body `_multi_kernel`): the control step of
// `fused_drift.cu` runs K times inside one launch. Step i reads rows
// [2i, 2i+2) of the stacked actions, [12i, 12i+12) of the uniforms and
// [14i, 14i+14) of the normals; the vehicle state, params, push timers and
// episode accumulators never leave registers between steps, and no
// observation or info block is written. It is the measurement that separates
// the cost of a step's arithmetic from the cost of being launched, and of
// taking the state through device memory, once per control step; it is also
// the shape of an open-loop rollout for sampling planners. Its plain PyTorch
// version, and the oracle it is tested against, is
// `wheeledlab_torch/ops/multi_step.py::multi_step_rows` (K chained
// `drift_step_rows` calls on the sliced rows).
//
// Bound: per env it reads state 21, params 46, counters 5 and, per step,
// actions 2, uniforms 10 and normals 0 (no observation is made, so no noise
// row is read) = 72 + 12 K words, and writes state 21 and counters 5 = 26
// words. At K = 8 and 16384 envs that is 194 words, 12.7 MB, about 3.8 us at
// the H100's 3.35 TB/s; its arithmetic is K x ~3200 float operations per env
// (the step's ~3400 less the observation), 6.2 us at K = 8 and 16384 envs at
// 67 TFLOP/s: operations bind from K = 5 on. Like `fused_drift.cu` one launch
// is a single wave, so its time is K times the latency of a lane's dependent
// chain (times in PERF.md).
//
// Design: `fused_drift.cu`'s grouping (4 lanes per env, a wheel a lane, 4
// warps a block, the tail groups masked at their stores; any B); the K steps
// are a runtime loop over `drift_step.cuh::drift_step` with its outputs
// switched off, so the step's code exists once whatever K is. Built without
// FMA contraction (`ops/build.py::NVCC_FLAGS`), so that K chained steps
// match the plain version bit for bit: the six force sums of a substep are
// taken in wheel order in every lane (`substep.cuh::wheel_sum`).
#include <cuda_runtime.h>
#include <stdint.h>

#include "drift_step.cuh"

namespace wl {

__global__ void __launch_bounds__(kBlockThreads, kMinBlocksPerSm)
multi_step_kernel(
    const FusedDriftConsts c, const float* __restrict__ weights,
    const float* __restrict__ poses, const float* __restrict__ state,
    const float* __restrict__ params, const float* __restrict__ actions,
    const float* __restrict__ uniforms, const float* __restrict__ normals,
    const int32_t* __restrict__ step_count, const int32_t* __restrict__ timers,
    const float* __restrict__ ep_return, const int32_t* __restrict__ ep_len,
    float* __restrict__ state_out, int32_t* __restrict__ step_out,
    int32_t* __restrict__ timers_out, float* __restrict__ epret_out,
    int32_t* __restrict__ eplen_out, int B, int K) {
  const LaneId id = lane_id(B);
  const int b = id.b;
  const size_t n = static_cast<size_t>(B);

  LaneState s;
  LaneParams p;
  load_lane_state(state, n, id, s);
  load_lane_params(params, n, id, p);
  int sc = step_count[b];
  int tm[kMaxPush] = {0, 0};
#pragma unroll
  for (int i = 0; i < kMaxPush; ++i)
    if (i < timer_rows(c)) tm[i] = timers[i * n + b];
  float er = ep_return[b];
  int el = ep_len[b];

  DriftStepOut unused;
#pragma unroll 1
  for (int k = 0; k < K; ++k) {
    const float a0 = actions[(2 * k) * n + b];
    const float a1 = actions[(2 * k + 1) * n + b];
    GlobalRows rows{uniforms + static_cast<size_t>(kNumUniform) * k * n,
                    normals + static_cast<size_t>(kObsRows) * k * n, n, b};
    drift_step<false>(c, weights, poses, s, p, id.w, a0, a1, rows, sc, tm, er,
                      el, unused);
  }

  store_lane_state(state_out, n, id, s);
  if (!id.live) return;
  store_lane_counters(c, id, n, sc, tm, er, el, step_out, timers_out,
                      epret_out, eplen_out);
}

}  // namespace wl

// Launch on `stream`; returns cudaGetLastError() (0 on success). Every
// pointer is a device pointer to a contiguous block: actions (2K, B),
// uniforms (12K, B), normals (14K, B), the others as for the fused step.
extern "C" int multi_step_launch(
    wl::FusedDriftConsts c, const float* weights, const float* poses,
    const float* state, const float* params, const float* actions,
    const float* uniforms, const float* normals, const int32_t* step_count,
    const int32_t* timers, const float* ep_return, const int32_t* ep_len,
    float* state_out, int32_t* step_out, int32_t* timers_out,
    float* epret_out, int32_t* eplen_out, int B, int K, void* stream) {
  if (B <= 0) return 0;
  wl::multi_step_kernel<<<wl::blocks_for(B), wl::kBlockThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      c, weights, poses, state, params, actions, uniforms, normals,
      step_count, timers, ep_return, ep_len, state_out, step_out, timers_out,
      epret_out, eplen_out, B, K);
  return static_cast<int>(cudaGetLastError());
}
