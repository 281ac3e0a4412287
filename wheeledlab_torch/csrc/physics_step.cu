// Flat-ground physics control step for Hopper (sm_90a): `decimation`
// substeps per env in one launch.
//
// Replaces the Pallas TPU kernel
// `wheeledlab_tpu/ops/pallas_substep.py::pallas_step` (body `_kernel`, a
// fori_loop of `sim/soa.py::substep_soa`). Its plain PyTorch version, and the
// oracle it is tested against, is
// `wheeledlab_torch/ops/physics_step.py::physics_step_rows` (the
// `sim/soa.py::substep_soa` loop). The generic manager step runs it for flat
// tasks without a fused step: the drift play variants at decimation 4 and the
// visual task at decimation 20. It is built without FMA contraction
// (`ops/build.py::NVCC_FLAGS`) and matches its plain version bit for bit.
//
// Bound: per env it reads state 21, params 46, steer targets 2 and wheel
// targets 4 words and writes state 21: 94 words, 376 bytes. Its arithmetic is
// decimation x 738 float operations (the count of `substep_flat` stated in
// chip_smoke.py), 7.9 operations per byte at decimation 4 and 39 at 20 —
// below the H100's float32 ridge of 67e12 / 3.35e12 = 20 at decimation 4
// (bytes bind), above it at 20 (operations bind). At the play width (16
// envs) and at widths of one wave neither bound is near: a lane's chain of
// dependent operations sets the time (latency-bound), as for the fused
// drift step.
//
// Design: the fused drift step's grouping (`substep.cuh`): 4 adjacent lanes
// per env, lane w owning wheel w, 4 warps (32 envs) a block over a 1-D grid,
// the tail groups masked at their stores. Rows are (rows, B) row-major: a row
// the group shares is one 32-byte sector a warp, a per-wheel row four, each
// state row is stored once. A lane's share of state, params and targets
// stays in registers through all substeps: state touches device memory once
// in and once out. The substep is `substep.cuh::substep_flat`, shared with
// the fused drift step.
#include <cuda_runtime.h>

#include "substep.cuh"

namespace wl {

__global__ void __launch_bounds__(kBlockThreads, kMinBlocksPerSm)
physics_step_kernel(
    const float* __restrict__ state, const float* __restrict__ params,
    const float* __restrict__ steer_t, const float* __restrict__ wheel_t,
    float* __restrict__ state_out, int B, float dt, float dt2, float half_dt,
    int decimation) {
  const LaneId id = lane_id(B);
  const size_t n = static_cast<size_t>(B);

  LaneState s;
  LaneParams p;
  load_lane_state(state, n, id, s);
  load_lane_params(params, n, id, p);
  const float st = steer_t[(id.w & 1) * n + id.b];
  const float wt = wheel_t[id.w * n + id.b];

  for (int i = 0; i < decimation; ++i)
    substep_flat(s, p, id.w, st, wt, dt, dt2, half_dt);

  store_lane_state(state_out, n, id, s);
}

}  // namespace wl

// Launch on `stream`; returns cudaGetLastError() (0 on success). Every
// pointer is a device pointer to a contiguous (rows, B) float block. dt, dt2
// and half_dt are float32(dt), float32(dt*dt) and float32(0.5*dt).
extern "C" int physics_step_launch(const float* state, const float* params,
                                   const float* steer_t, const float* wheel_t,
                                   float* state_out, int B, float dt,
                                   float dt2, float half_dt, int decimation,
                                   void* stream) {
  if (B <= 0) return 0;
  wl::physics_step_kernel<<<wl::blocks_for(B), wl::kBlockThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      state, params, steer_t, wheel_t, state_out, B, dt, dt2, half_dt,
      decimation);
  return static_cast<int>(cudaGetLastError());
}
