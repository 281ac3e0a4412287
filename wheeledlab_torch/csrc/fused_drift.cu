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
// Measured on an H100 SXM at 700 W, it takes about 29 us at both sizes:
// either grid is a single wave with at most 4 warps per SM, so each thread's
// long chain of dependent float operations sets the time (latency-bound).
// Splitting an env's work across lanes (e.g. one wheel per lane) is the
// lever for a later change.
//
// Design: one thread per env over a 1-D grid, tail masked (B need not be a
// multiple of anything). Rows are (rows, B) row-major, so thread b reads
// x[r*B + b] and a warp's loads and stores are coalesced. The 21 state rows
// and 46 parameter rows stay in registers through the 4 substeps and the
// epilogue: state touches device memory once in and once out. The 7
// curriculum weights and the (N, 4) pose table are small device buffers read
// through the read-only cache. Compile-time constants of the step arrive by
// value in `FusedDriftConsts`.
#include <cuda_runtime.h>
#include <stdint.h>

#include "substep.cuh"

namespace wl {

constexpr int kMaxPush = 2;
constexpr int kNumUniform = 12;
constexpr int kObsRows = 14;
constexpr int kNumOut = 15;
constexpr int kNumTerms = 7;

// Uniform-block rows
constexpr int U_PUSH = 0;      // 2 events x [lin_x, lin_y, yaw]
constexpr int U_INTERVAL = 6;  // push interval resample
constexpr int U_SPAWN = 8;     // spawn [idx, dx, dy, dyaw]

// Output-block rows
constexpr int O_REWARD = 0, O_DONE = 1, O_TIMEOUT = 2, O_EPRET = 3,
              O_EPLEN = 4, O_TERMS = 5, O_OOB = 12, O_SLIP_DEG = 13,
              O_SPEED = 14;

// Mirrored field for field by `FusedDriftConstsC` in
// wheeledlab_torch/tasks/drift/fused.py. Every float is already rounded to
// float32 from the Python double the plain version uses.
struct FusedDriftConsts {
  float dt, dt2, half_dt;
  int decimation;
  float step_dt;
  int max_episode_length;
  float straight, track_radius;
  float corner_in_radius, corner_out_radius, corner_in_sq, corner_out_sq;
  float slip_threshold, max_speed, max_speed_sq;
  int num_reset_points;
  float pos_noise, yaw_noise, spawn_z;
  int enable_corruption, terminations_enabled;
  int n_push;
  int push_lo[kMaxPush], push_hi[kMaxPush];
  int push_active[kMaxPush][3];
  float push_base[kMaxPush][3], push_span[kMaxPush][3];
  int drivetrain;  // 0 rwd, 1 4wd
  int bounding;    // 0 clip, 1 tanh, 2 none
  int no_reverse;
  float scale_throttle, scale_steer, offset_throttle, offset_steer;
  float wheel_radius, base_length, half_width, base_length_sq;
  float obs_std[kObsRows];
  float rad_to_deg;
};

// World->body rotation of a velocity vector: R^T v.
__device__ __forceinline__ void body_frame(const float s[kNumState], float vx,
                                           float vy, float vz, float out[3]) {
  const float qw = s[S_QW], qx = s[S_QX], qy = s[S_QY], qz = s[S_QZ];
  const float r00 = 1.f - 2.f * (qy * qy + qz * qz);
  const float r01 = 2.f * (qx * qy - qw * qz);
  const float r02 = 2.f * (qx * qz + qw * qy);
  const float r10 = 2.f * (qx * qy + qw * qz);
  const float r11 = 1.f - 2.f * (qx * qx + qz * qz);
  const float r12 = 2.f * (qy * qz - qw * qx);
  const float r20 = 2.f * (qx * qz - qw * qy);
  const float r21 = 2.f * (qy * qz + qw * qx);
  const float r22 = 1.f - 2.f * (qx * qx + qy * qy);
  out[0] = r00 * vx + r10 * vy + r20 * vz;
  out[1] = r01 * vx + r11 * vy + r21 * vz;
  out[2] = r02 * vx + r12 * vy + r22 * vz;
}

__global__ void __launch_bounds__(128) fused_drift_kernel(
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
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const size_t n = static_cast<size_t>(B);

  float s[kNumState];
  float p[kNumParam];
#pragma unroll
  for (int r = 0; r < kNumState; ++r) s[r] = state[r * n + b];
#pragma unroll
  for (int r = 0; r < kNumParam; ++r) p[r] = params[r * n + b];
  const float a0 = actions[b], a1 = actions[n + b];

  // 1. action manager (row form of sim/actions.py; tan via sin/cos)
  float v, st;
  if (c.bounding == 0) {
    v = clipp(a0, -1.f, 1.f) * c.scale_throttle + c.offset_throttle;
    st = clipp(a1, -1.f, 1.f) * c.scale_steer + c.offset_steer;
  } else if (c.bounding == 1) {
    v = tanhf(a0) * c.scale_throttle + c.offset_throttle;
    st = tanhf(a1) * c.scale_steer + c.offset_steer;
  } else {
    v = a0 * c.scale_throttle + c.offset_throttle;
    st = a1 * c.scale_steer + c.offset_steer;
  }
  if (c.no_reverse) v = maxp(v, 0.f);
  const float tan_steering = sinf(st) / cosf(st);
  const float r = c.wheel_radius;
  float steer_t[2] = {tan_steering, tan_steering};
  float wheel_t[4];
  if (c.drivetrain == 0) {
    const float tgt = v / r;
    wheel_t[0] = tgt;
    wheel_t[1] = tgt;
    wheel_t[2] = 0.f;
    wheel_t[3] = 0.f;
  } else {
    const float R =
        tan_steering == 0.f ? 1e6f : c.base_length / tan_steering;
    const float hw = c.half_width, L2 = c.base_length_sq;
    wheel_t[0] = v * fabsf((R - hw) / (R * r));
    wheel_t[1] = v * fabsf((R + hw) / (R * r));
    wheel_t[2] = v * fabsf(sqrtf((R - hw) * (R - hw) + L2) / (R * r));
    wheel_t[3] = v * fabsf(sqrtf((R + hw) * (R + hw) + L2) / (R * r));
  }

  // 2. physics decimation
  for (int i = 0; i < c.decimation; ++i)
    substep_flat(s, p, steer_t, wheel_t, c.dt, c.dt2, c.half_dt);

  // 3. interval events: velocity pushes
  int new_timer[kMaxPush] = {0, 0};
  const int timer_rows = c.n_push > 0 ? c.n_push : 1;
#pragma unroll
  for (int i = 0; i < kMaxPush; ++i) {
    if (i >= c.n_push) continue;
    const int timer = timers[i * n + b] - 1;
    const bool fire = timer <= 0;
    const float firef = fire ? 1.f : 0.f;
    const int vrow[3] = {S_VX, S_VY, S_WZ};
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      if (c.push_active[i][j]) {
        const float u = uniforms[(U_PUSH + 3 * i + j) * n + b];
        s[vrow[j]] = s[vrow[j]] +
                     firef * (c.push_base[i][j] + u * c.push_span[i][j]);
      }
    }
    const float ui = uniforms[(U_INTERVAL + i) * n + b];
    const int resample =
        c.push_lo[i] +
        static_cast<int>(floorf(ui * static_cast<float>(c.push_hi[i] -
                                                        c.push_lo[i])));
    new_timer[i] = fire ? resample : timer;
  }

  // 4. counters
  const int sc = step_count[b] + 1;

  // 5. terminations (pre-reset state)
  const float px = s[S_PX], py = s[S_PY];
  const bool on_straights = fabsf(py) < c.straight;
  const float cy = py > 0.f ? py - c.straight : py + c.straight;
  const float corner_sq = cy * cy + px * px;
  const bool off_b = on_straights ? fabsf(px) > c.corner_out_radius
                                  : corner_sq > c.corner_out_sq;
  const bool in_b = on_straights ? fabsf(px) < c.corner_in_radius
                                 : corner_sq < c.corner_in_sq;
  const bool oob = c.terminations_enabled && (off_b || in_b);
  const bool time_out = sc >= c.max_episode_length;
  const bool done = oob || time_out;

  // 6. rewards (pre-reset state; weight * value * step_dt)
  float bv[3], bw[3];
  body_frame(s, s[S_VX], s[S_VY], s[S_VZ], bv);
  body_frame(s, s[S_WX], s[S_WY], s[S_WZ], bw);
  const float slip = fabsf(atan2_approx(bv[1], bv[0]));
  const float gated =
      (fabsf(bv[0]) < 1.f || slip > c.slip_threshold) ? 0.f : slip;
  float terms[kNumTerms];
  terms[0] = gated < 0.25f ? 0.f : gated;                       // side_slip
  const float ground_sq = bv[0] * bv[0] + bv[1] * bv[1];
  const float ground_speed = sqrtf(ground_sq);
  const float dv = ground_speed - c.max_speed;
  terms[1] = dv * dv - c.max_speed_sq;                           // vel
  terms[2] = s[S_WZ];                                            // progress
  const float steer_mean = 0.5f * (s[S_STEER_POS] + s[S_STEER_POS + 1]);
  const float aw = clipp(bw[2], -1.f, 1.f);
  terms[3] = maxp(steer_mean * aw * -1.f, 0.f);                  // tlgr
  terms[4] = fabsf(py) > c.straight ? ground_sq + bv[2] * bv[2] : 0.f;
  const float line_d =
      on_straights ? (px > 0.f ? fabsf(px - c.track_radius)
                               : fabsf(px + c.track_radius))
                   : fabsf(sqrtf(corner_sq) - c.track_radius);
  terms[5] = line_d - 1.f;                                       // cross_track
  const float t_pens = oob ? 1.f : 0.f;
  terms[6] = t_pens;                                             // term_pens
  float reward = 0.f;
  float weighted[kNumTerms];
#pragma unroll
  for (int i = 0; i < kNumTerms; ++i) {
    weighted[i] = __ldg(weights + i) * terms[i] * c.step_dt;
    reward = reward + weighted[i];
  }
  const float ep_return_pre = ep_return[b] + reward;
  const int ep_len_pre = ep_len[b] + 1;
  const float m_slip_deg = fabsf(bv[0]) >= 1.f ? slip * c.rad_to_deg : 0.f;

  // 7. auto-reset: spawn sampling along the track + masked blend
  const int nrp = c.num_reset_points;
  int idx = static_cast<int>(uniforms[U_SPAWN * n + b] *
                             static_cast<float>(nrp));
  idx = idx < nrp - 1 ? idx : nrp - 1;
  const float sp_x = __ldg(poses + 4 * idx) +
                     (2.f * uniforms[(U_SPAWN + 1) * n + b] - 1.f) *
                         c.pos_noise;
  const float sp_y = __ldg(poses + 4 * idx + 1) +
                     (2.f * uniforms[(U_SPAWN + 2) * n + b] - 1.f) *
                         c.pos_noise;
  const float sp_yaw = __ldg(poses + 4 * idx + 3) +
                       (2.f * uniforms[(U_SPAWN + 3) * n + b] - 1.f) *
                           c.yaw_noise;
  const float donef = done ? 1.f : 0.f;
  const float keep = 1.f - donef;
#pragma unroll
  for (int r2 = 0; r2 < kNumState; ++r2) {
    float spawn = 0.f;
    bool spawn_row = true;
    switch (r2) {
      case S_PX: spawn = sp_x; break;
      case S_PY: spawn = sp_y; break;
      case S_PZ: spawn = c.spawn_z; break;
      case S_QW: spawn = cosf(0.5f * sp_yaw); break;
      case S_QZ: spawn = sinf(0.5f * sp_yaw); break;
      default: spawn_row = false;
    }
    s[r2] = spawn_row ? donef * spawn + keep * s[r2] : keep * s[r2];
  }

  // 9. observations (post-reset state; BlindObs layout + Gaussian noise)
  const float qw = s[S_QW], qx = s[S_QX], qy = s[S_QY], qz = s[S_QZ];
  float obs[kObsRows];
  obs[0] = s[S_PX];
  obs[1] = s[S_PY];
  obs[2] = s[S_PZ];
  obs[3] = atan2_approx(2.f * (qw * qx + qy * qz),
                        1.f - 2.f * (qx * qx + qy * qy));
  obs[4] = asin_approx(2.f * (qw * qy - qz * qx));
  obs[5] = atan2_approx(2.f * (qw * qz + qx * qy),
                        1.f - 2.f * (qy * qy + qz * qz));
  body_frame(s, s[S_VX], s[S_VY], s[S_VZ], obs + 6);
  body_frame(s, s[S_WX], s[S_WY], s[S_WZ], obs + 9);
  obs[12] = clipp(keep * a0, -1.f, 1.f);
  obs[13] = clipp(keep * a1, -1.f, 1.f);
  if (c.enable_corruption) {
#pragma unroll
    for (int i = 0; i < kObsRows; ++i)
      if (c.obs_std[i] != 0.f)
        obs[i] = obs[i] + normals[i * n + b] * c.obs_std[i];
  }

  // stores
#pragma unroll
  for (int r2 = 0; r2 < kNumState; ++r2) state_out[r2 * n + b] = s[r2];
#pragma unroll
  for (int i = 0; i < kObsRows; ++i) obs_out[i * n + b] = obs[i];
  out[O_REWARD * n + b] = reward;
  out[O_DONE * n + b] = donef;
  out[O_TIMEOUT * n + b] = time_out ? 1.f : 0.f;
  out[O_EPRET * n + b] = ep_return_pre;
  out[O_EPLEN * n + b] = static_cast<float>(ep_len_pre);
#pragma unroll
  for (int i = 0; i < kNumTerms; ++i) out[(O_TERMS + i) * n + b] = weighted[i];
  out[O_OOB * n + b] = t_pens;
  out[O_SLIP_DEG * n + b] = m_slip_deg;
  out[O_SPEED * n + b] = ground_speed;
  step_out[b] = done ? 0 : sc;
  // unrolled over the compile-time bound so new_timer stays in registers
#pragma unroll
  for (int i = 0; i < kMaxPush; ++i) {
    if (i < c.n_push)
      timers_out[i * n + b] = new_timer[i];
    else if (i < timer_rows)
      timers_out[i * n + b] = timers[i * n + b];
  }
  epret_out[b] = keep * ep_return_pre;
  eplen_out[b] = done ? 0 : ep_len_pre;
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
  const int threads = 128;
  const int blocks = (B + threads - 1) / threads;
  wl::fused_drift_kernel<<<blocks, threads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      c, weights, poses, state, params, actions, uniforms, normals,
      step_count, timers, ep_return, ep_len, state_out, obs_out, out,
      step_out, timers_out, epret_out, eplen_out, B);
  return static_cast<int>(cudaGetLastError());
}
