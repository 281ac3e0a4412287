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
// below the bytes' time at the card's float32 rate only for large batches.
// The kernel is far from either: what it waits for is the latency of a
// lane's chain of dependent operations over the 10 substeps (times in
// PERF.md). The bound counts an env's work once, not the lanes that repeat
// it.
//
// Design: 4 adjacent lanes per env, lane w owning wheel w (`substep.cuh`
// says who computes what and why the six force sums are taken in wheel
// order); 4 warps, 32 envs, a block, the tail groups masked at their stores.
// 1024 envs are 32 blocks on 32 of the card's 132 SMs, a warp a scheduler;
// 16384 envs are 512 blocks, 15 or 16 warps an SM, all resident (a thread is
// held to 128 registers, a block's patches take 21,504 bytes at p = 12). A
// lane's share of state and params stays in registers through all substeps.
//
// The patch (144 floats an env at p = 12) lives in shared memory, each
// warp's 8 patches in a region of their own. A warp stages its 8 patches
// together with 4-byte `cp.async` copies, started before the state and
// parameter loads and waited for after them, so the copy overlaps them and
// no lane holds a patch value in a register: one copy instruction moves 4
// patch rows x 8 envs, four 32-byte sectors of device memory into 32
// consecutive words of shared memory (conflict-free). Lanes then read what
// other lanes copied, so the wait is followed by a `__syncwarp()`; no warp
// reads another warp's region, so nothing wider is needed.
//
// Layout and banks: cell (ix, iy) of env e of the warp lies at word
// (ix * pitch + iy) * 8 + e of the warp's region: bank
// 8 * ((ix * pitch + iy) % 4) + e, up to a shift that is the region's own.
// Two lanes of different envs never share a bank. The 4 lanes of an env read
// one corner of their wheels' cells at a time: lanes on the same cell read one
// address (a broadcast), and lanes on different cells collide only when
// their ix * pitch + iy agree modulo 4. The pitch is the patch side rounded
// up to 2 modulo 4 (`patch_pitch`; 14 at p = 12, 30 at p = 30), so the cell's
// residue is (2 ix + iy) % 4: the four cells of a 2 x 2 block, which is what
// the wheels of a car 0.3 m long on 0.25 m cells usually stand on, fall into
// four different residues, and a warp's read touches 32 different banks.
// Worst case: all four wheels on different cells of one residue (a car
// spanning 3 cells along x, say), a 4-way conflict on 16 of a substep's loads;
// it cannot be worse, whatever the data.
//
// Shared memory a block: p * pitch * 32 floats, 21,504 bytes at p = 12. From
// p = 19 on that is more than the 48 KB every block may have, and the
// launcher opts in to what it needs, up to the 227 KB an SM gives one block:
// 115,200 bytes at p = 30, 225,792 at p = 42, the largest patch that fits
// (the wrapper's `MAX_P`; it and the launcher refuse a larger one).
#include <cuda_runtime.h>

#include "substep_hf.cuh"

namespace wl {

constexpr int kMaxSharedBytes = 232448;  // 227 KB a block may opt in to

__host__ __device__ __forceinline__ int patch_words(int p) {
  return p * patch_pitch(p) * kEnvsPerBlock;
}

// 4-byte asynchronous copy from device to shared memory (LDGSTS).
__device__ __forceinline__ void copy_async_4(float* shared_dst,
                                             const float* global_src) {
  const unsigned dst =
      static_cast<unsigned>(__cvta_generic_to_shared(shared_dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(global_src)
               : "memory");
}

__device__ __forceinline__ void copy_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__global__ void __launch_bounds__(kBlockThreads, kMinBlocksPerSm)
physics_step_hf_kernel(
    const HfConsts c, const float* __restrict__ state,
    const float* __restrict__ params, const float* __restrict__ patch,
    const float* __restrict__ org, const float* __restrict__ steer_t,
    const float* __restrict__ wheel_t, float* __restrict__ state_out, int B) {
  extern __shared__ float smem[];  // (warps, p * pitch, kWarpEnvs)
  const LaneId id = lane_id(B);
  const size_t n = static_cast<size_t>(B);
  const int pitch = patch_pitch(c.p);

  // stage the warp's 8 patches into its region: this lane copies env
  // (lane % 8) of the warp, cells iy = lane / 8, lane / 8 + 4, ... of every ix
  const int lane = threadIdx.x % 32;
  float* const region =
      smem + (threadIdx.x / 32) * (c.p * pitch * kWarpEnvs);
  {
    const int e = lane % kWarpEnvs;
    const int env = (blockIdx.x * kBlockThreads + threadIdx.x - lane) /
                        kLanesPerEnv + e;
    const int be = env < B ? env : B - 1;
    for (int ix = 0; ix < c.p; ++ix)
      for (int iy = lane / kWarpEnvs; iy < c.p; iy += 32 / kWarpEnvs)
        copy_async_4(region + (ix * pitch + iy) * kWarpEnvs + e,
                     patch + static_cast<size_t>(ix * c.p + iy) * n + be);
  }

  LaneState s;
  LaneParams p;
  load_lane_state(state, n, id, s);
  load_lane_params(params, n, id, p);
  const float st = steer_t[(id.w & 1) * n + id.b];
  const float wt = wheel_t[id.w * n + id.b];
  const float org_x = org[id.b], org_y = org[n + id.b];

  copy_async_wait_all();
  __syncwarp();

  const float* my_patch = region + lane / kLanesPerEnv;
  for (int i = 0; i < c.decimation; ++i)
    substep_hf(s, p, id.w, my_patch, kWarpEnvs, pitch, org_x, org_y, st, wt,
               c);

  store_lane_state(state_out, n, id, s);
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
  if (c.p < 2) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = wl::patch_words(c.p) * static_cast<int>(sizeof(float));
  if (smem > wl::kMaxSharedBytes)
    return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        wl::physics_step_hf_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  wl::physics_step_hf_kernel<<<wl::blocks_for(B), wl::kBlockThreads, smem,
                               static_cast<cudaStream_t>(stream)>>>(
      c, state, params, patch, org, steer_t, wheel_t, state_out, B);
  return static_cast<int>(cudaGetLastError());
}
