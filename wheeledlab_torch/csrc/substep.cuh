// Flat-ground vehicle substep for one env, on values held in registers.
//
// CUDA copy of `wheeledlab_torch/sim/soa.py::substep_soa` (itself the port of
// `wheeledlab_tpu/sim/soa.py::substep_soa`), written as a __device__ function
// so that every kernel stepping flat-ground physics can share it: the fused
// drift step now, the physics-only substep kernel later.
//
// Float behaviour: precise sinf/cosf/tanhf/sqrtf and IEEE division (no
// --use_fast_math). Expressions keep the reference's order of operations; the
// one difference left is nvcc's default FMA contraction, which moves results
// by a few ulp against the plain version.
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

// NaN-propagating max/min/clip with the semantics of torch.maximum /
// torch.minimum / torch.clamp (fmaxf/fminf would drop a NaN).
__device__ __forceinline__ float maxp(float a, float b) {
  return (a != a || b != b) ? a + b : fmaxf(a, b);
}
__device__ __forceinline__ float minp(float a, float b) {
  return (a != a || b != b) ? a + b : fminf(a, b);
}
__device__ __forceinline__ float clipp(float x, float lo, float hi) {
  return minp(maxp(x, lo), hi);
}
__device__ __forceinline__ float signp(float x) {
  return x > 0.f ? 1.f : (x < 0.f ? -1.f : x);
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
  const float base = atan_approx(y / safe_x);
  if (x > 0.f) return base;
  if (x < 0.f) return base + (y >= 0.f ? kPiF : -kPiF);
  return signp(y) * kHalfPiF;
}

__device__ __forceinline__ float asin_approx(float x) {
  const float xc = clipp(x, -1.f, 1.f);
  return atan2_approx(xc, sqrtf(maxp(1.f - xc * xc, 0.f)));
}

// One flat-ground substep of one env, in place on s[kNumState].
// dt, dt2 and half_dt are float32(dt), float32(dt*dt) and float32(0.5*dt),
// each rounded once from double, as the plain version's Python scalars are.
__device__ __forceinline__ void substep_flat(
    float s[kNumState], const float p[kNumParam], const float steer_t[2],
    const float wheel_t[4], float dt, float dt2, float half_dt) {
  const float px = s[S_PX], py = s[S_PY], pz = s[S_PZ];
  const float qw = s[S_QW], qx = s[S_QX], qy = s[S_QY], qz = s[S_QZ];
  const float vx = s[S_VX], vy = s[S_VY], vz = s[S_VZ];
  const float wx = s[S_WX], wy = s[S_WY], wz = s[S_WZ];

  const float mass = p[P_MASS];
  const float ixx = p[P_IXX], iyy = p[P_IYY], izz = p[P_IZZ];
  const float gravity = p[P_GRAVITY];
  const float radius = p[P_WHEEL_RADIUS];

  // rotation matrix (body->world) from quaternion
  const float r00 = 1.f - 2.f * (qy * qy + qz * qz);
  const float r01 = 2.f * (qx * qy - qw * qz);
  const float r02 = 2.f * (qx * qz + qw * qy);
  const float r10 = 2.f * (qx * qy + qw * qz);
  const float r11 = 1.f - 2.f * (qx * qx + qz * qz);
  const float r12 = 2.f * (qy * qz - qw * qx);
  const float r20 = 2.f * (qx * qz - qw * qy);
  const float r21 = 2.f * (qy * qz + qw * qx);
  const float r22 = 1.f - 2.f * (qx * qx + qy * qy);

  // --- steering servo (implicit PD) ---
  const float s_inertia = p[P_STEER_INERTIA];
  const float s_kp = p[P_STEER_KP], s_kd = p[P_STEER_KD];
  const float denom = 1.f + dt * s_kd / s_inertia + dt2 * s_kp / s_inertia;
  const float lim = p[P_STEER_EFFORT];
  const float vlim = p[P_STEER_VEL_LIMIT];
  const float theta_lim = p[P_STEER_LIMIT];
  float new_steer_pos[2], new_steer_vel[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const float sp = s[S_STEER_POS + k], sv = s[S_STEER_VEL + k];
    const float omega_impl =
        (sv + dt * (s_kp / s_inertia) * (steer_t[k] - sp)) / denom;
    float torque = s_inertia * (omega_impl - sv) / dt;
    torque = clipp(torque, -lim, lim);
    float nv = sv + dt * torque / s_inertia;
    nv = clipp(nv, -vlim, vlim);
    const float theta_new = sp + dt * nv;
    const float theta_cl = clipp(theta_new, -theta_lim, theta_lim);
    new_steer_vel[k] = theta_new == theta_cl ? nv : (theta_cl - sp) / dt;
    new_steer_pos[k] = theta_cl;
  }

  // --- per-wheel forces (flat ground) ---
  float fx_tot = 0.f, fy_tot = 0.f, fz_tot = 0.f;
  float tx_tot = 0.f, ty_tot = 0.f, tz_tot = 0.f;
  float new_om[4];

  const float w_inertia = p[P_WHEEL_INERTIA];
  const float tire_b = p[P_TIRE_B], tire_c = p[P_TIRE_C];
  const float susp_k = p[P_SUSP_K], susp_d = p[P_SUSP_D];
  const float susp_fric = p[P_SUSP_FRIC];
  const float sat = p[P_SAT_EFFORT];
  const float elim = p[P_EFFORT_LIMIT];
  const float vlim_m = p[P_VEL_LIMIT];

#pragma unroll
  for (int w = 0; w < 4; ++w) {
    const float wpx = p[P_WHEEL_POS + 3 * w];
    const float wpy = p[P_WHEEL_POS + 3 * w + 1];
    const float wpz = p[P_WHEEL_POS + 3 * w + 2];
    // wheel center world position
    const float cwx = px + r00 * wpx + r01 * wpy + r02 * wpz;
    const float cwy = py + r10 * wpx + r11 * wpy + r12 * wpz;
    const float cwz = pz + r20 * wpx + r21 * wpy + r22 * wpz;
    // contact point = wheel center - r * ez; arm from body origin
    const float ax = cwx - px;
    const float ay = cwy - py;
    const float az = cwz - radius - pz;
    // contact point velocity: v + omega x arm
    const float vcx = vx + wy * az - wz * ay;
    const float vcy = vy + wz * ax - wx * az;
    const float vcz = vz + wx * ay - wy * ax;

    const float penetration = radius - cwz;
    const bool in_contact = penetration > 0.f;
    float fz = susp_k * penetration + susp_d * (-vcz) +
               susp_fric * tanhf(-vcz * 20.f);
    fz = in_contact ? maxp(fz, 0.f) : 0.f;

    // tire frame: wheel heading on the ground plane; rear wheels never steer
    float hx, hy;
    if (w >= 2) {
      const float steer_w = new_steer_pos[w - 2];
      const float cd = cosf(steer_w);
      const float sd = sinf(steer_w);
      hx = r00 * cd + r01 * sd;
      hy = r10 * cd + r11 * sd;
    } else {
      hx = r00;
      hy = r10;
    }
    const float hnorm = maxp(sqrtf(hx * hx + hy * hy), 1e-6f);
    const float tlx = hx / hnorm, tly = hy / hnorm;
    const float v_long = vcx * tlx + vcy * tly;
    const float v_lat = -vcx * tly + vcy * tlx;

    const float mu = p[P_TIRE_MU + w];
    const float om = s[S_WHEEL + w];
    const float sdenom = maxp(fabsf(v_long), 0.6f);
    const float sx = (om * radius - v_long) / sdenom;
    const float sy = -v_lat / sdenom;
    const float sl = sqrtf(sx * sx + sy * sy + 1e-9f);
    const float f_norm = sinf(tire_c * atan_approx(tire_b * sl));
    const float scale = mu * fz * f_norm / sl;
    const float fx_tire = scale * sx;
    const float fy_tire = scale * sy;
    const float dfx_dom = mu * fz * tire_b * tire_c * radius / sdenom;

    // motor torque (implicit velocity drive + DC saturation clip)
    const float d_m = p[P_MOTOR_DAMPING + w];
    const float alpha = dt * d_m / w_inertia;
    const float om_impl = (om + alpha * wheel_t[w]) / (1.f + alpha);
    float tau = w_inertia * (om_impl - om) / dt;
    const float tau_max = clipp(sat * (1.f - om / vlim_m), 0.f, elim);
    const float tau_min = clipp(sat * (-1.f - om / vlim_m), -elim, 0.f);
    tau = clipp(tau, tau_min, tau_max) * p[P_DRIVE_MASK + w];

    const float tau_slip = -fx_tire * radius;
    const float tau_roll = -p[P_ROLL_RES] * om;
    const float impl_denom = 1.f + dt * dfx_dom * radius / w_inertia;
    new_om[w] =
        om + dt * (tau + tau_slip + tau_roll) / w_inertia / impl_denom;

    // accumulate world force + torque about body origin
    const float fwx = fx_tire * tlx - fy_tire * tly;
    const float fwy = fx_tire * tly + fy_tire * tlx;
    const float fwz = fz;
    fx_tot = fx_tot + fwx;
    fy_tot = fy_tot + fwy;
    fz_tot = fz_tot + fwz;
    tx_tot = tx_tot + (ay * fwz - az * fwy);
    ty_tot = ty_tot + (az * fwx - ax * fwz);
    tz_tot = tz_tot + (ax * fwy - ay * fwx);
  }

  fz_tot = fz_tot - mass * gravity;

  const float new_vx = vx + dt * fx_tot / mass;
  const float new_vy = vy + dt * fy_tot / mass;
  const float new_vz = vz + dt * fz_tot / mass;

  // angular dynamics in body frame (diagonal inertia, gyroscopic term)
  float obx = r00 * wx + r10 * wy + r20 * wz;
  float oby = r01 * wx + r11 * wy + r21 * wz;
  float obz = r02 * wx + r12 * wy + r22 * wz;
  const float tbx = r00 * tx_tot + r10 * ty_tot + r20 * tz_tot;
  const float tby = r01 * tx_tot + r11 * ty_tot + r21 * tz_tot;
  const float tbz = r02 * tx_tot + r12 * ty_tot + r22 * tz_tot;
  const float gx = oby * (izz * obz) - obz * (iyy * oby);
  const float gy = obz * (ixx * obx) - obx * (izz * obz);
  const float gz = obx * (iyy * oby) - oby * (ixx * obx);
  obx = obx + dt * (tbx - gx) / ixx;
  oby = oby + dt * (tby - gy) / iyy;
  obz = obz + dt * (tbz - gz) / izz;
  const float new_wx = r00 * obx + r01 * oby + r02 * obz;
  const float new_wy = r10 * obx + r11 * oby + r12 * obz;
  const float new_wz = r20 * obx + r21 * oby + r22 * obz;

  // quaternion integration: q += 0.5 dt (omega_quat * q), renormalize
  const float dqw = half_dt * (-new_wx * qx - new_wy * qy - new_wz * qz);
  const float dqx = half_dt * (new_wx * qw + new_wy * qz - new_wz * qy);
  const float dqy = half_dt * (-new_wx * qz + new_wy * qw + new_wz * qx);
  const float dqz = half_dt * (new_wx * qy - new_wy * qx + new_wz * qw);
  const float nqw = qw + dqw, nqx = qx + dqx, nqy = qy + dqy, nqz = qz + dqz;
  const float qn =
      maxp(sqrtf(nqw * nqw + nqx * nqx + nqy * nqy + nqz * nqz), 1e-9f);

  s[S_PX] = px + dt * new_vx;
  s[S_PY] = py + dt * new_vy;
  s[S_PZ] = pz + dt * new_vz;
  s[S_QW] = nqw / qn;
  s[S_QX] = nqx / qn;
  s[S_QY] = nqy / qn;
  s[S_QZ] = nqz / qn;
  s[S_VX] = new_vx;
  s[S_VY] = new_vy;
  s[S_VZ] = new_vz;
  s[S_WX] = new_wx;
  s[S_WY] = new_wy;
  s[S_WZ] = new_wz;
#pragma unroll
  for (int w = 0; w < 4; ++w) s[S_WHEEL + w] = new_om[w];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    s[S_STEER_POS + k] = new_steer_pos[k];
    s[S_STEER_VEL + k] = new_steer_vel[k];
  }
}

}  // namespace wl
