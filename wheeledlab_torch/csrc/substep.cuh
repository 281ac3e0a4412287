// Flat-ground vehicle substep for one env, worked by a group of 4 adjacent
// lanes: lane w owns wheel w.
//
// CUDA copy of `wheeledlab_torch/sim/soa.py::substep_soa` (itself the port of
// `wheeledlab_tpu/sim/soa.py::substep_soa`), written as __device__ functions
// shared by every kernel that steps flat-ground physics (the fused drift
// step and its two variants, the physics-only step) and, piece by piece, by
// the heightfield substep (`substep_hf.cuh`).
//
// Design (who computes what). One thread walking an env's substep is a chain
// of dependent instructions of which the four wheels are three quarters, and
// a grid of one thread per env leaves each warp scheduler a single warp: the
// chain's latency is the kernel's time. So an env is given to 4 adjacent
// lanes (lane = 4 * env + wheel; 8 envs a warp, 4 warps a block):
//   - lane w computes wheel w alone: contact, suspension, tire frame, slip,
//     motor, the wheel's new rate, its world force and its arm. It holds
//     only that wheel's 6 parameter rows and its own wheel rate;
//   - the rotation matrix and the rigid-body and quaternion update are
//     computed by all four lanes on the same values, so every lane holds the
//     same bits and nothing is sent back;
//   - lane w steps steering axis w & 1 (lanes 2 and 3, the steered wheels,
//     thereby own the axis they turn with);
//   - the six force and torque totals are the reference's sums
//     (((0 + wheel 0) + wheel 1) + wheel 2) + wheel 3: each lane fetches the
//     four wheels' values with `__shfl_sync(..., width 4)` and adds them in
//     wheel order (`wheel_sum`). A butterfly (xor) reduction would add in
//     another order and round differently; the order is what keeps the
//     kernels bit-equal, or within a few ulp, to the plain version.
// Nothing in a group diverges: the steered wheels' heading is a per-lane
// select, not a branch. No barrier is needed: a shuffle synchronises the
// lanes it names, and no lane reads memory that another lane wrote.
//
// Loads and stores. Rows are (rows, B) row-major. A row that the whole group
// needs (13 body rows, 22 shared parameters) is loaded by all 4 lanes from
// one address: a warp's load then touches 8 consecutive floats, one 32-byte
// sector when B is a multiple of 8, and the hardware broadcasts it. A
// per-wheel row is loaded by its lane: 4 rows x 8 envs, four sectors. Every
// output row is stored once: body row r by lane r & 3 (`store_shared_rows`),
// the wheel rates by their lanes, steering axis k by lane k. A tail group
// (env >= B) works on a copy of the last env and stores nothing, so every
// lane of a warp reaches every shuffle.
//
// Float behaviour: precise sinf/cosf/tanhf/sqrtf and IEEE division (no
// --use_fast_math). Expressions keep the reference's order of operations, and
// every source is built without FMA contraction (`ops/build.py::NVCC_FLAGS`),
// so a kernel matches its plain version bit for bit.
#pragma once

#include <math.h>

namespace wl {

constexpr int kNumState = 21;
constexpr int kNumParam = 46;

// Rows of the packed (kNumState, B) state matrix.
enum StateRow {
  S_PX = 0, S_PY = 1, S_PZ = 2,
  S_QW = 3, S_QX = 4, S_QY = 5, S_QZ = 6,
  S_VX = 7, S_VY = 8, S_VZ = 9,
  S_WX = 10, S_WY = 11, S_WZ = 12,
  S_WHEEL = 13,       // 4 rows
  S_STEER_POS = 17,   // 2 rows
  S_STEER_VEL = 19,   // 2 rows
};

// Rows of the packed (kNumParam, B) parameter matrix.
enum ParamRow {
  P_MASS = 0, P_IXX = 1, P_IYY = 2, P_IZZ = 3, P_GRAVITY = 4,
  P_WHEEL_RADIUS = 5, P_WHEEL_POS = 6,  // 4 wheels x xyz
  P_STEER_KP = 18, P_STEER_KD = 19, P_STEER_EFFORT = 20,
  P_STEER_VEL_LIMIT = 21, P_STEER_INERTIA = 22, P_STEER_LIMIT = 23,
  P_MOTOR_DAMPING = 24,  // 4 rows
  P_SAT_EFFORT = 28, P_EFFORT_LIMIT = 29, P_VEL_LIMIT = 30,
  P_DRIVE_MASK = 31,     // 4 rows
  P_WHEEL_INERTIA = 35,
  P_TIRE_MU = 36,        // 4 rows
  P_TIRE_B = 40, P_TIRE_C = 41, P_ROLL_RES = 42,
  P_SUSP_K = 43, P_SUSP_D = 44, P_SUSP_FRIC = 45,
};

constexpr double kPi = 3.14159265358979323846;
constexpr float kPiF = static_cast<float>(kPi);
constexpr float kHalfPiF = static_cast<float>(kPi / 2);
constexpr float kQuarterPiF = static_cast<float>(kPi / 4);

// The grouping: 4 lanes an env, 8 envs a warp, 4 warps a block (measured on
// an H100 against blocks of 1 and 2 warps: times in PERF.md). The
// heightfield wrapper mirrors `kEnvsPerBlock` for its shared-memory check
// (`ops/physics_step_hf.py`).
constexpr int kLanesPerEnv = 4;
constexpr int kWarpEnvs = 32 / kLanesPerEnv;
constexpr int kBlockThreads = 128;
constexpr int kEnvsPerBlock = kBlockThreads / kLanesPerEnv;
constexpr int kMinBlocksPerSm = 4;  // caps a thread at 128 registers
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kNumBody = 13;  // state rows S_PX .. S_WZ, shared by a group

// Which env and wheel a thread works on. `b` is clamped to the last env, so
// a tail group loads valid rows; `live` gates its stores.
struct LaneId {
  int b, w;
  bool live;
};

__device__ __forceinline__ LaneId lane_id(int B) {
  const int t = blockIdx.x * kBlockThreads + threadIdx.x;
  const int env = t / kLanesPerEnv;
  return {env < B ? env : B - 1, t % kLanesPerEnv, env < B};
}

inline int blocks_for(int B) {
  return (B + kEnvsPerBlock - 1) / kEnvsPerBlock;
}

// One lane's share of an env's 21 state rows.
struct LaneState {
  float body[kNumBody];  // rows S_PX .. S_WZ, the same bits in all 4 lanes
  float om;              // row S_WHEEL + w
  float sp, sv;          // rows S_STEER_POS + (w & 1), S_STEER_VEL + (w & 1)
};

// One lane's share of an env's 46 parameter rows: the 22 shared ones and
// the 6 of wheel w.
struct LaneParams {
  float mass, ixx, iyy, izz, gravity, radius;
  float wheel_x, wheel_y, wheel_z;
  float steer_kp, steer_kd, steer_effort, steer_vel_limit, steer_inertia,
      steer_limit;
  float motor_damping;
  float sat_effort, effort_limit, vel_limit;
  float drive_mask;
  float wheel_inertia;
  float mu;
  float tire_b, tire_c, roll_res;
  float susp_k, susp_d, susp_fric;
};

__device__ __forceinline__ void load_lane_state(
    const float* __restrict__ state, size_t n, const LaneId id,
    LaneState& s) {
#pragma unroll
  for (int r = 0; r < kNumBody; ++r) s.body[r] = state[r * n + id.b];
  s.om = state[(S_WHEEL + id.w) * n + id.b];
  s.sp = state[(S_STEER_POS + (id.w & 1)) * n + id.b];
  s.sv = state[(S_STEER_VEL + (id.w & 1)) * n + id.b];
}

// Store rows 0 .. N-1 of a block that all 4 lanes of a group hold alike,
// each row once: lane w picks rows w, w + 4, ... out of every four (selects
// on its wheel index) and stores them, so a warp's store covers 4 rows x 8
// envs. The caller has checked `id.live`.
template <int N>
__device__ __forceinline__ void store_shared_rows(float* __restrict__ out,
                                                  size_t n, const LaneId id,
                                                  const float (&v)[N]) {
#pragma unroll
  for (int j = 0; j < N; j += kLanesPerEnv) {
    float mine = v[j];
#pragma unroll
    for (int k = 1; k < kLanesPerEnv; ++k)
      if (j + k < N) mine = id.w == k ? v[j + k] : mine;
    if (j + id.w < N) out[(j + id.w) * n + id.b] = mine;
  }
}

__device__ __forceinline__ void store_lane_state(float* __restrict__ out,
                                                 size_t n, const LaneId id,
                                                 const LaneState& s) {
  if (!id.live) return;
  store_shared_rows(out, n, id, s.body);
  out[(S_WHEEL + id.w) * n + id.b] = s.om;
  if (id.w < 2) {
    out[(S_STEER_POS + id.w) * n + id.b] = s.sp;
    out[(S_STEER_VEL + id.w) * n + id.b] = s.sv;
  }
}

__device__ __forceinline__ void load_lane_params(
    const float* __restrict__ params, size_t n, const LaneId id,
    LaneParams& p) {
  const int b = id.b, w = id.w;
  p.mass = params[P_MASS * n + b];
  p.ixx = params[P_IXX * n + b];
  p.iyy = params[P_IYY * n + b];
  p.izz = params[P_IZZ * n + b];
  p.gravity = params[P_GRAVITY * n + b];
  p.radius = params[P_WHEEL_RADIUS * n + b];
  p.wheel_x = params[(P_WHEEL_POS + 3 * w) * n + b];
  p.wheel_y = params[(P_WHEEL_POS + 3 * w + 1) * n + b];
  p.wheel_z = params[(P_WHEEL_POS + 3 * w + 2) * n + b];
  p.steer_kp = params[P_STEER_KP * n + b];
  p.steer_kd = params[P_STEER_KD * n + b];
  p.steer_effort = params[P_STEER_EFFORT * n + b];
  p.steer_vel_limit = params[P_STEER_VEL_LIMIT * n + b];
  p.steer_inertia = params[P_STEER_INERTIA * n + b];
  p.steer_limit = params[P_STEER_LIMIT * n + b];
  p.motor_damping = params[(P_MOTOR_DAMPING + w) * n + b];
  p.sat_effort = params[P_SAT_EFFORT * n + b];
  p.effort_limit = params[P_EFFORT_LIMIT * n + b];
  p.vel_limit = params[P_VEL_LIMIT * n + b];
  p.drive_mask = params[(P_DRIVE_MASK + w) * n + b];
  p.wheel_inertia = params[P_WHEEL_INERTIA * n + b];
  p.mu = params[(P_TIRE_MU + w) * n + b];
  p.tire_b = params[P_TIRE_B * n + b];
  p.tire_c = params[P_TIRE_C * n + b];
  p.roll_res = params[P_ROLL_RES * n + b];
  p.susp_k = params[P_SUSP_K * n + b];
  p.susp_d = params[P_SUSP_D * n + b];
  p.susp_fric = params[P_SUSP_FRIC * n + b];
}

// The reference's running sum over the wheels, ((0 + w0) + w1) + w2) + w3,
// of a value each lane of the group holds for its own wheel. All 4 lanes
// return the same bits.
__device__ __forceinline__ float wheel_sum(float x) {
  const float x0 = __shfl_sync(kFullMask, x, 0, kLanesPerEnv);
  const float x1 = __shfl_sync(kFullMask, x, 1, kLanesPerEnv);
  const float x2 = __shfl_sync(kFullMask, x, 2, kLanesPerEnv);
  const float x3 = __shfl_sync(kFullMask, x, 3, kLanesPerEnv);
  return (((0.f + x0) + x1) + x2) + x3;
}

// NaN-propagating max/min/clip with the semantics of torch.maximum /
// torch.minimum / torch.clamp (fmaxf/fminf would drop a NaN): the card's
// max and min with the NaN modifier, one instruction each.
__device__ __forceinline__ float maxp(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float minp(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float clipp(float x, float lo, float hi) {
  return minp(maxp(x, lo), hi);
}
__device__ __forceinline__ float signp(float x) {
  return x > 0.f ? 1.f : (x < 0.f ? -1.f : x);
}

// x / y, bit for bit, without the slow path that the card's IEEE division
// takes when its numerator is zero (4 to 5 times the fast path's latency on
// an H100; a car at rest divides zeros all through its step, and one such
// lane holds up its warp). A zero numerator is replaced by 1 for the
// division and the exactly known quotient is selected afterwards: +-0 with
// the sign of x times the sign of y for any y that is neither zero nor NaN,
// else x * (1 / y), which is NaN as 0 / 0 and 0 / NaN are. The selects sit
// beside the division's own latency, not on top of it.
__device__ __forceinline__ float divz(float x, float y) {
  const bool zero = x == 0.f;
  const float q = (zero ? 1.f : x) / y;
  const float z = fabsf(y) > 0.f ? x * copysignf(1.f, y) : x * q;
  return zero ? z : q;
}

// Full-range arctan approximation (max err ~0.0038 rad), as sim/soa.py.
__device__ __forceinline__ float atan_approx(float x) {
  const float a = fabsf(x);
  const bool small = a <= 1.f;
  const float z = small ? a : 1.f / maxp(a, 1e-30f);
  const float p = z * (kQuarterPiF + 0.273f * (1.f - z));
  const float r = small ? p : kHalfPiF - p;
  return signp(x) * r;
}

// Quadrant-corrected atan2 on atan_approx, with the sign-preserving clamp
// of the denominator.
__device__ __forceinline__ float atan2_approx(float y, float x) {
  const float safe_x = fabsf(x) < 1e-30f ? (x < 0.f ? -1e-30f : 1e-30f) : x;
  const float base = atan_approx(divz(y, safe_x));
  if (x > 0.f) return base;
  if (x < 0.f) return base + (y >= 0.f ? kPiF : -kPiF);
  return signp(y) * kHalfPiF;
}

__device__ __forceinline__ float asin_approx(float x) {
  const float xc = clipp(x, -1.f, 1.f);
  return atan2_approx(xc, sqrtf(maxp(1.f - xc * xc, 0.f)));
}

// Rotation matrix (body->world) of a unit quaternion.
struct Rot {
  float r00, r01, r02, r10, r11, r12, r20, r21, r22;
};

__device__ __forceinline__ Rot rotation(float qw, float qx, float qy,
                                        float qz) {
  Rot R;
  R.r00 = 1.f - 2.f * (qy * qy + qz * qz);
  R.r01 = 2.f * (qx * qy - qw * qz);
  R.r02 = 2.f * (qx * qz + qw * qy);
  R.r10 = 2.f * (qx * qy + qw * qz);
  R.r11 = 1.f - 2.f * (qx * qx + qz * qz);
  R.r12 = 2.f * (qy * qz - qw * qx);
  R.r20 = 2.f * (qx * qz - qw * qy);
  R.r21 = 2.f * (qy * qz + qw * qx);
  R.r22 = 1.f - 2.f * (qx * qx + qy * qy);
  return R;
}

// Steering servo (implicit PD) of this lane's axis, in place on s.sp, s.sv.
__device__ __forceinline__ void servo_step(LaneState& s, const LaneParams& p,
                                           float steer_t, float dt,
                                           float dt2) {
  const float s_inertia = p.steer_inertia;
  const float s_kp = p.steer_kp, s_kd = p.steer_kd;
  const float denom = 1.f + dt * s_kd / s_inertia + dt2 * s_kp / s_inertia;
  const float lim = p.steer_effort;
  const float vlim = p.steer_vel_limit;
  const float theta_lim = p.steer_limit;
  const float sp = s.sp, sv = s.sv;
  const float omega_impl =
      divz(sv + dt * (s_kp / s_inertia) * (steer_t - sp), denom);
  float torque = divz(s_inertia * (omega_impl - sv), dt);
  torque = clipp(torque, -lim, lim);
  float nv = sv + divz(dt * torque, s_inertia);
  nv = clipp(nv, -vlim, vlim);
  const float theta_new = sp + dt * nv;
  const float theta_cl = clipp(theta_new, -theta_lim, theta_lim);
  s.sv = theta_new == theta_cl ? nv : divz(theta_cl - sp, dt);
  s.sp = theta_cl;
}

// Where this lane's wheel is: its center in the world, the arm of its
// contact point (center - r * ez) from the body origin, and that point's
// velocity v + omega x arm.
struct WheelPose {
  float cwx, cwy, cwz;
  float ax, ay, az;
  float vcx, vcy, vcz;
};

__device__ __forceinline__ WheelPose wheel_pose(const LaneState& s,
                                                const LaneParams& p,
                                                const Rot& R) {
  const float px = s.body[S_PX], py = s.body[S_PY], pz = s.body[S_PZ];
  const float vx = s.body[S_VX], vy = s.body[S_VY], vz = s.body[S_VZ];
  const float wx = s.body[S_WX], wy = s.body[S_WY], wz = s.body[S_WZ];
  const float wpx = p.wheel_x, wpy = p.wheel_y, wpz = p.wheel_z;
  WheelPose k;
  k.cwx = px + R.r00 * wpx + R.r01 * wpy + R.r02 * wpz;
  k.cwy = py + R.r10 * wpx + R.r11 * wpy + R.r12 * wpz;
  k.cwz = pz + R.r20 * wpx + R.r21 * wpy + R.r22 * wpz;
  k.ax = k.cwx - px;
  k.ay = k.cwy - py;
  k.az = k.cwz - p.radius - pz;
  k.vcx = vx + wy * k.az - wz * k.ay;
  k.vcy = vy + wz * k.ax - wx * k.az;
  k.vcz = vz + wx * k.ay - wy * k.ax;
  return k;
}

// Tire slip forces in the tire frame and the wheel's new rate (implicit
// velocity drive + DC saturation clip, slip torque treated implicitly).
__device__ __forceinline__ void tire_and_motor(const LaneParams& p, float om,
                                               float wheel_t, float v_long,
                                               float v_lat, float fz, float dt,
                                               float& fx_tire, float& fy_tire,
                                               float& new_om) {
  const float radius = p.radius;
  const float w_inertia = p.wheel_inertia;
  const float mu = p.mu;
  const float sdenom = maxp(fabsf(v_long), 0.6f);
  const float sx = divz(om * radius - v_long, sdenom);
  const float sy = divz(-v_lat, sdenom);
  const float sl = sqrtf(sx * sx + sy * sy + 1e-9f);
  const float f_norm = sinf(p.tire_c * atan_approx(p.tire_b * sl));
  const float scale = divz(mu * fz * f_norm, sl);
  fx_tire = scale * sx;
  fy_tire = scale * sy;
  const float dfx_dom =
      divz(mu * fz * p.tire_b * p.tire_c * radius, sdenom);

  const float alpha = dt * p.motor_damping / w_inertia;
  const float om_impl = divz(om + alpha * wheel_t, 1.f + alpha);
  float tau = divz(w_inertia * (om_impl - om), dt);
  const float sat = p.sat_effort, elim = p.effort_limit;
  const float om_rel = divz(om, p.vel_limit);
  const float tau_max = clipp(sat * (1.f - om_rel), 0.f, elim);
  const float tau_min = clipp(sat * (-1.f - om_rel), -elim, 0.f);
  tau = clipp(tau, tau_min, tau_max) * p.drive_mask;

  const float tau_slip = -fx_tire * radius;
  const float tau_roll = -p.roll_res * om;
  const float impl_denom = 1.f + divz(dt * dfx_dom * radius, w_inertia);
  new_om = om + divz(divz(dt * (tau + tau_slip + tau_roll), w_inertia),
                     impl_denom);
}

// Sum this lane's wheel force (fwx, fwy, fwz) at arm (ax, ay, az) with the
// group's other three in wheel order, then step the rigid body: linear and
// angular velocity (diagonal inertia, gyroscopic term), position, and the
// quaternion (q += 0.5 dt omega_quat * q, renormalized). All 4 lanes compute
// the same update, in place on s.body.
__device__ __forceinline__ void rigid_body_step(LaneState& s,
                                                const LaneParams& p,
                                                const Rot& R,
                                                const WheelPose& k, float fwx,
                                                float fwy, float fwz, float dt,
                                                float half_dt) {
  const float fx_tot = wheel_sum(fwx);
  const float fy_tot = wheel_sum(fwy);
  float fz_tot = wheel_sum(fwz);
  const float tx_tot = wheel_sum(k.ay * fwz - k.az * fwy);
  const float ty_tot = wheel_sum(k.az * fwx - k.ax * fwz);
  const float tz_tot = wheel_sum(k.ax * fwy - k.ay * fwx);

  const float px = s.body[S_PX], py = s.body[S_PY], pz = s.body[S_PZ];
  const float qw = s.body[S_QW], qx = s.body[S_QX];
  const float qy = s.body[S_QY], qz = s.body[S_QZ];
  const float vx = s.body[S_VX], vy = s.body[S_VY], vz = s.body[S_VZ];
  const float wx = s.body[S_WX], wy = s.body[S_WY], wz = s.body[S_WZ];
  const float mass = p.mass;
  const float ixx = p.ixx, iyy = p.iyy, izz = p.izz;

  fz_tot = fz_tot - mass * p.gravity;

  const float new_vx = vx + divz(dt * fx_tot, mass);
  const float new_vy = vy + divz(dt * fy_tot, mass);
  const float new_vz = vz + divz(dt * fz_tot, mass);

  float obx = R.r00 * wx + R.r10 * wy + R.r20 * wz;
  float oby = R.r01 * wx + R.r11 * wy + R.r21 * wz;
  float obz = R.r02 * wx + R.r12 * wy + R.r22 * wz;
  const float tbx = R.r00 * tx_tot + R.r10 * ty_tot + R.r20 * tz_tot;
  const float tby = R.r01 * tx_tot + R.r11 * ty_tot + R.r21 * tz_tot;
  const float tbz = R.r02 * tx_tot + R.r12 * ty_tot + R.r22 * tz_tot;
  const float gx = oby * (izz * obz) - obz * (iyy * oby);
  const float gy = obz * (ixx * obx) - obx * (izz * obz);
  const float gz = obx * (iyy * oby) - oby * (ixx * obx);
  obx = obx + divz(dt * (tbx - gx), ixx);
  oby = oby + divz(dt * (tby - gy), iyy);
  obz = obz + divz(dt * (tbz - gz), izz);
  const float new_wx = R.r00 * obx + R.r01 * oby + R.r02 * obz;
  const float new_wy = R.r10 * obx + R.r11 * oby + R.r12 * obz;
  const float new_wz = R.r20 * obx + R.r21 * oby + R.r22 * obz;

  const float dqw = half_dt * (-new_wx * qx - new_wy * qy - new_wz * qz);
  const float dqx = half_dt * (new_wx * qw + new_wy * qz - new_wz * qy);
  const float dqy = half_dt * (-new_wx * qz + new_wy * qw + new_wz * qx);
  const float dqz = half_dt * (new_wx * qy - new_wy * qx + new_wz * qw);
  const float nqw = qw + dqw, nqx = qx + dqx, nqy = qy + dqy, nqz = qz + dqz;
  const float qn =
      maxp(sqrtf(nqw * nqw + nqx * nqx + nqy * nqy + nqz * nqz), 1e-9f);

  s.body[S_PX] = px + dt * new_vx;
  s.body[S_PY] = py + dt * new_vy;
  s.body[S_PZ] = pz + dt * new_vz;
  s.body[S_QW] = divz(nqw, qn);
  s.body[S_QX] = divz(nqx, qn);
  s.body[S_QY] = divz(nqy, qn);
  s.body[S_QZ] = divz(nqz, qn);
  s.body[S_VX] = new_vx;
  s.body[S_VY] = new_vy;
  s.body[S_VZ] = new_vz;
  s.body[S_WX] = new_wx;
  s.body[S_WY] = new_wy;
  s.body[S_WZ] = new_wz;
}

// One flat-ground substep of one env by its 4 lanes, in place on each
// lane's share of the state. `steer_t` is the target of axis w & 1,
// `wheel_t` the target of wheel w. dt, dt2 and half_dt are float32(dt),
// float32(dt*dt) and float32(0.5*dt), each rounded once from double, as the
// plain version's Python scalars are.
__device__ __forceinline__ void substep_flat(LaneState& s,
                                             const LaneParams& p, int w,
                                             float steer_t, float wheel_t,
                                             float dt, float dt2,
                                             float half_dt) {
  const Rot R = rotation(s.body[S_QW], s.body[S_QX], s.body[S_QY],
                         s.body[S_QZ]);
  servo_step(s, p, steer_t, dt, dt2);

  // --- this lane's wheel (flat ground) ---
  const WheelPose k = wheel_pose(s, p, R);
  const float penetration = p.radius - k.cwz;
  const bool in_contact = penetration > 0.f;
  float fz = p.susp_k * penetration + p.susp_d * (-k.vcz) +
             p.susp_fric * tanhf(-k.vcz * 20.f);
  fz = in_contact ? maxp(fz, 0.f) : 0.f;

  // tire frame: wheel heading on the ground plane; rear wheels (0, 1) never
  // steer, wheel w >= 2 turns with axis w - 2 == w & 1, this lane's own
  const bool steered = w >= 2;
  const float cd = cosf(s.sp);
  const float sd = sinf(s.sp);
  const float hx = steered ? R.r00 * cd + R.r01 * sd : R.r00;
  const float hy = steered ? R.r10 * cd + R.r11 * sd : R.r10;
  const float hnorm = maxp(sqrtf(hx * hx + hy * hy), 1e-6f);
  const float tlx = divz(hx, hnorm), tly = divz(hy, hnorm);
  const float v_long = k.vcx * tlx + k.vcy * tly;
  const float v_lat = -k.vcx * tly + k.vcy * tlx;

  float fx_tire, fy_tire, new_om;
  tire_and_motor(p, s.om, wheel_t, v_long, v_lat, fz, dt, fx_tire, fy_tire,
                 new_om);
  s.om = new_om;

  // world force of this wheel; torque about the body origin in the sum
  const float fwx = fx_tire * tlx - fy_tire * tly;
  const float fwy = fx_tire * tly + fy_tire * tlx;
  const float fwz = fz;
  rigid_body_step(s, p, R, k, fwx, fwy, fwz, dt, half_dt);
}

}  // namespace wl
