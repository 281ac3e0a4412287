// One drift control step of one env on register-resident rows, worked by a
// group of 4 adjacent lanes (lane w owns wheel w; see `substep.cuh`): the
// device code shared by the fused drift step (`fused_drift.cu`), its
// in-kernel-RNG variant (`fused_drift_krng.cu`) and the K-step resident
// rollout (`multi_step.cu`).
//
// It is the row math of `wheeledlab_tpu/tasks/drift/fused.py::
// drift_step_rows`; its plain PyTorch version, and the oracle the kernels are
// tested against, is `wheeledlab_torch/tasks/drift/fused.py::
// drift_step_rows`. Per env: action map -> `decimation` x flat-ground substep
// -> velocity pushes -> oval out-of-bounds and time-out terminations -> 7
// weighted reward terms -> episode return/length -> masked auto-reset with
// spawn from the pose table -> 14-row observation with Gaussian noise.
//
// The random rows come from a "row source" the step is templated on:
// `GlobalRows` reads the (12, B) uniform and (14, B) normal blocks from
// device memory, `philox.cuh::PhiloxGroupRows` draws them in registers, the
// 4 lanes of a group together. A uniform row must hold the same bits in all
// 4 lanes; normal row i need only be right in lane i & 3, the one lane that
// stores observation row i. A row is asked for only where the step uses it:
// two uniform rows (the second push event moves only the yaw rate) and two
// normal rows (the action rows of the observation carry no noise) are never
// touched.
//
// Design (who computes what). The substeps are `substep.cuh`'s: a wheel a
// lane. The action map gives each lane the target of its own wheel and of
// its own steering axis (selects on the lane's wheel index, no branch). The
// rest of the step (pushes, terminations, rewards, reset, observation: an
// eighth of the step's operations) reads only rows that all 4 lanes hold
// with the same bits, apart from the two steering angles, which the reward
// fetches from lanes 0 and 1; every lane computes it, so the group never
// diverges and the step's integers stay uniform in the group, and each
// output row is stored by one lane (`fused_step_lane`).
#pragma once

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

// Row source over blocks in device memory: `uniforms` and `normals` point at
// the first row of this step's (12, B) and (14, B) blocks.
struct GlobalRows {
  const float* __restrict__ uniforms;
  const float* __restrict__ normals;
  size_t n;
  int b;
  __device__ __forceinline__ float uniform(int row) const {
    return uniforms[row * n + b];
  }
  __device__ __forceinline__ float normal(int row) const {
    return normals[row * n + b];
  }
};

// What a step hands to the policy and the logger (the obs and info blocks).
struct DriftStepOut {
  float obs[kObsRows];
  float out[kNumOut];
};

// World->body rotation of a velocity vector: R^T v, with R from rows
// S_QW .. S_QZ of `s`.
__device__ __forceinline__ void body_frame(const float s[kNumBody], float vx,
                                           float vy, float vz, float out[3]) {
  const Rot R = rotation(s[S_QW], s[S_QX], s[S_QY], s[S_QZ]);
  out[0] = R.r00 * vx + R.r10 * vy + R.r20 * vz;
  out[1] = R.r01 * vx + R.r11 * vy + R.r21 * vz;
  out[2] = R.r02 * vx + R.r12 * vy + R.r22 * vz;
}

// One control step of one env by its 4 lanes; `w` is this lane's wheel.
// `ls`, `step_count`, `timer`, `ep_return` and `ep_len` are updated in place
// (post-reset values); `p` is read. With `kOutputs` the obs and info blocks
// are written to `o` (all of them, in every lane); without, they are not
// computed.
template <bool kOutputs, class Rows>
__device__ __forceinline__ void drift_step(
    const FusedDriftConsts& c, const float* __restrict__ weights,
    const float* __restrict__ poses, LaneState& ls, const LaneParams& p,
    int w, float a0, float a1, Rows& rows, int& step_count,
    int timer[kMaxPush], float& ep_return, int& ep_len, DriftStepOut& o) {
  float* const s = ls.body;
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
  const float tan_steering = divz(sinf(st), cosf(st));
  const float r = c.wheel_radius;
  // both steering axes take the same target; this lane's wheel its own:
  // wheels 0, 1 are the rear (driven under rwd), 2, 3 the front; odd wheels
  // are on the +half_width side of the turn
  const float steer_t = tan_steering;
  float wheel_t;
  if (c.drivetrain == 0) {
    const float tgt = divz(v, r);
    wheel_t = w < 2 ? tgt : 0.f;
  } else {
    const float R =
        tan_steering == 0.f ? 1e6f : c.base_length / tan_steering;
    const float hw = c.half_width, L2 = c.base_length_sq;
    const float side = (w & 1) ? R + hw : R - hw;
    const float reach = w < 2 ? side : sqrtf(side * side + L2);
    wheel_t = v * fabsf(reach / (R * r));
  }

  // 2. physics decimation
  for (int i = 0; i < c.decimation; ++i)
    substep_flat(ls, p, w, steer_t, wheel_t, c.dt, c.dt2, c.half_dt);

  // 3. interval events: velocity pushes
#pragma unroll
  for (int i = 0; i < kMaxPush; ++i) {
    if (i >= c.n_push) continue;
    const int t = timer[i] - 1;
    const bool fire = t <= 0;
    const float firef = fire ? 1.f : 0.f;
    const int vrow[3] = {S_VX, S_VY, S_WZ};
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      if (c.push_active[i][j]) {
        const float u = rows.uniform(U_PUSH + 3 * i + j);
        s[vrow[j]] = s[vrow[j]] +
                     firef * (c.push_base[i][j] + u * c.push_span[i][j]);
      }
    }
    const float ui = rows.uniform(U_INTERVAL + i);
    const int resample =
        c.push_lo[i] +
        static_cast<int>(floorf(ui * static_cast<float>(c.push_hi[i] -
                                                        c.push_lo[i])));
    timer[i] = fire ? resample : t;
  }

  // 4. counters
  const int sc = step_count + 1;

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
  const float steer_0 = __shfl_sync(kFullMask, ls.sp, 0, kLanesPerEnv);
  const float steer_1 = __shfl_sync(kFullMask, ls.sp, 1, kLanesPerEnv);
  const float steer_mean = 0.5f * (steer_0 + steer_1);
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
  const float ep_return_pre = ep_return + reward;
  const int ep_len_pre = ep_len + 1;

  // 7. auto-reset: spawn sampling along the track + masked blend
  const int nrp = c.num_reset_points;
  int idx = static_cast<int>(rows.uniform(U_SPAWN) * static_cast<float>(nrp));
  idx = idx < nrp - 1 ? idx : nrp - 1;
  const float sp_x = __ldg(poses + 4 * idx) +
                     (2.f * rows.uniform(U_SPAWN + 1) - 1.f) * c.pos_noise;
  const float sp_y = __ldg(poses + 4 * idx + 1) +
                     (2.f * rows.uniform(U_SPAWN + 2) - 1.f) * c.pos_noise;
  const float sp_yaw = __ldg(poses + 4 * idx + 3) +
                       (2.f * rows.uniform(U_SPAWN + 3) - 1.f) * c.yaw_noise;
  const float donef = done ? 1.f : 0.f;
  const float keep = 1.f - donef;
#pragma unroll
  for (int r2 = 0; r2 < kNumBody; ++r2) {
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
  // the wheel rates and the steering rows carry no spawn value
  ls.om = keep * ls.om;
  ls.sp = keep * ls.sp;
  ls.sv = keep * ls.sv;
  step_count = done ? 0 : sc;
  ep_return = keep * ep_return_pre;
  ep_len = done ? 0 : ep_len_pre;

  if constexpr (kOutputs) {
    // 9. observations (post-reset state; BlindObs layout + Gaussian noise)
    const float qw = s[S_QW], qx = s[S_QX], qy = s[S_QY], qz = s[S_QZ];
    float* obs = o.obs;
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
          obs[i] = obs[i] + rows.normal(i) * c.obs_std[i];
    }

    // info block
    o.out[O_REWARD] = reward;
    o.out[O_DONE] = donef;
    o.out[O_TIMEOUT] = time_out ? 1.f : 0.f;
    o.out[O_EPRET] = ep_return_pre;
    o.out[O_EPLEN] = static_cast<float>(ep_len_pre);
#pragma unroll
    for (int i = 0; i < kNumTerms; ++i) o.out[O_TERMS + i] = weighted[i];
    o.out[O_OOB] = t_pens;
    o.out[O_SLIP_DEG] = fabsf(bv[0]) >= 1.f ? slip * c.rad_to_deg : 0.f;
    o.out[O_SPEED] = ground_speed;
  }
}

// Number of rows of the push-timer block: one per event, at least one.
__device__ __forceinline__ int timer_rows(const FusedDriftConsts& c) {
  return c.n_push > 0 ? c.n_push : 1;
}

// The step's counters, which all 4 lanes hold alike, stored once: the step
// count by lane 0, the push timers by lane 1, the episode return by lane 2
// and its length by lane 3. The caller has checked `id.live`.
__device__ __forceinline__ void store_lane_counters(
    const FusedDriftConsts& c, const LaneId id, size_t n, int sc,
    const int tm[kMaxPush], float er, int el, int32_t* __restrict__ step_out,
    int32_t* __restrict__ timers_out, float* __restrict__ epret_out,
    int32_t* __restrict__ eplen_out) {
  const int b = id.b;
  if (id.w == 0) step_out[b] = sc;
  // unrolled over the compile-time bound so the timers stay in registers
#pragma unroll
  for (int i = 0; i < kMaxPush; ++i)
    if (id.w == 1 && i < timer_rows(c)) timers_out[i * n + b] = tm[i];
  if (id.w == 2) epret_out[b] = er;
  if (id.w == 3) eplen_out[b] = el;
}

// One lane's share of a whole fused step: load the env's rows, step, store.
// The body of the fused drift kernel and of its in-kernel-RNG variant, which
// differ only in the row source. Rows are (rows, B) row-major; a row the
// group shares is loaded by its 4 lanes from one address (a warp's load is 8
// consecutive floats, one 32-byte sector when B is a multiple of 8), and
// every output row is stored by one lane of the group: state as
// `store_lane_state` says, obs and info row i by lane i & 3
// (`store_shared_rows`), the step count, timers, return and length by lanes
// 0, 1, 2 and 3.
template <class Rows>
__device__ __forceinline__ void fused_step_lane(
    const FusedDriftConsts& c, const float* __restrict__ weights,
    const float* __restrict__ poses, const float* __restrict__ state,
    const float* __restrict__ params, const float* __restrict__ actions,
    Rows& rows, const int32_t* __restrict__ step_count,
    const int32_t* __restrict__ timers, const float* __restrict__ ep_return,
    const int32_t* __restrict__ ep_len, float* __restrict__ state_out,
    float* __restrict__ obs_out, float* __restrict__ out,
    int32_t* __restrict__ step_out, int32_t* __restrict__ timers_out,
    float* __restrict__ epret_out, int32_t* __restrict__ eplen_out,
    const LaneId id, size_t n) {
  const int b = id.b;
  LaneState s;
  LaneParams p;
  load_lane_state(state, n, id, s);
  load_lane_params(params, n, id, p);
  const float a0 = actions[b], a1 = actions[n + b];
  int sc = step_count[b];
  int tm[kMaxPush] = {0, 0};
#pragma unroll
  for (int i = 0; i < kMaxPush; ++i)
    if (i < timer_rows(c)) tm[i] = timers[i * n + b];
  float er = ep_return[b];
  int el = ep_len[b];

  DriftStepOut o;
  drift_step<true>(c, weights, poses, s, p, id.w, a0, a1, rows, sc, tm, er,
                   el, o);

  store_lane_state(state_out, n, id, s);
  if (!id.live) return;
  store_shared_rows(obs_out, n, id, o.obs);
  store_shared_rows(out, n, id, o.out);
  store_lane_counters(c, id, n, sc, tm, er, el, step_out, timers_out,
                      epret_out, eplen_out);
}

}  // namespace wl
