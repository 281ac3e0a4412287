// Heightfield vehicle substep for one env, on values held in registers and
// the env's terrain patch held in shared memory.
//
// CUDA copy of `wheeledlab_torch/sim/soa_hf.py::substep_soa_hf` (itself the
// port of `wheeledlab_tpu/sim/soa_hf.py::substep_soa_hf`): bilinear height
// and analytic normal under each wheel from the resident (p, p) patch, then
// the sloped-normal contact (suspension along the surface normal, tire frame
// projected on the contact plane). Expressions keep the reference's order of
// operations. The four bilinear corners are direct indexed loads; the
// reference's masked sums over the patch rows are a TPU workaround for the
// missing gather and give the same values.
#pragma once

#include "substep.cuh"

namespace wl {

// Static constants of a heightfield control step, mirrored field for field
// by `HfConstsC` in wheeledlab_torch/ops/physics_step_hf.py. Every float is
// rounded to float32 once on the host from the Python double the plain
// version applies.
struct HfConsts {
  float dt, dt2, half_dt;  // dt, dt*dt, 0.5*dt
  int decimation;
  int p;                   // patch side, in cells
  float cell;              // grid spacing (m)
  float half_nx, half_ny;  // (nx - 1) / 2, (ny - 1) / 2
  float uv_max;            // p - 1.001: the clip of patch coordinates
};

// Height and outward normal at world (qx, qy). `patch` points at this env's
// row 0; row r lies at patch[r * stride].
__device__ __forceinline__ void query_patch(const float* patch, int stride,
                                            float org_x, float org_y,
                                            float qx, float qy,
                                            const HfConsts c, float& h,
                                            float& n_x, float& n_y,
                                            float& n_z) {
  float u = qx / c.cell + c.half_nx - org_x;
  float v = qy / c.cell + c.half_ny - org_y;
  u = clipp(u, 0.f, c.uv_max);
  v = clipp(v, 0.f, c.uv_max);
  const float x0 = floorf(u);
  const float y0 = floorf(v);
  const float fx = u - x0;
  const float fy = v - y0;
  // clamped after the float clip, so a NaN state never reads out of bounds
  const int ix = min(max(static_cast<int>(x0), 0), c.p - 2);
  const int iy = min(max(static_cast<int>(y0), 0), c.p - 2);
  const int idx = ix * c.p + iy;
  const float h00 = patch[idx * stride];
  const float h01 = patch[(idx + 1) * stride];
  const float h10 = patch[(idx + c.p) * stride];
  const float h11 = patch[(idx + c.p + 1) * stride];
  const float hr0 = (1.f - fx) * h00 + fx * h10;  // row interp at y0
  const float hr1 = (1.f - fx) * h01 + fx * h11;  // row interp at y1
  h = hr0 * (1.f - fy) + hr1 * fy;
  const float dhdx = ((h10 - h00) * (1.f - fy) + (h11 - h01) * fy) / c.cell;
  const float dhdy = (hr1 - hr0) / c.cell;
  const float inv = 1.f / sqrtf(dhdx * dhdx + dhdy * dhdy + 1.f);
  n_x = -dhdx * inv;
  n_y = -dhdy * inv;
  n_z = inv;
}

// One heightfield substep of one env, in place on s[kNumState].
__device__ __forceinline__ void substep_hf(
    float s[kNumState], const float p[kNumParam], const float* patch,
    int stride, float org_x, float org_y, const float steer_t[2],
    const float wheel_t[4], const HfConsts c) {
  const float dt = c.dt;
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

  // --- steering servo (implicit PD; identical to substep_flat) ---
  const float s_inertia = p[P_STEER_INERTIA];
  const float s_kp = p[P_STEER_KP], s_kd = p[P_STEER_KD];
  const float denom = 1.f + dt * s_kd / s_inertia + c.dt2 * s_kp / s_inertia;
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

  // --- per-wheel contact on the sloped local terrain ---
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
    // terrain height + normal under the wheel (resident patch)
    float gh, n_x, n_y, n_z;
    query_patch(patch, stride, org_x, org_y, cwx, cwy, c, gh, n_x, n_y, n_z);
    const float penetration = gh + radius - cwz;
    const bool in_contact = penetration > 0.f;

    // contact point = wheel center - r * ez; arm from body origin
    const float ax = cwx - px;
    const float ay = cwy - py;
    const float az = cwz - radius - pz;
    // contact point velocity: v + omega x arm
    const float vcx = vx + wy * az - wz * ay;
    const float vcy = vy + wz * ax - wx * az;
    const float vcz = vz + wx * ay - wy * ax;

    // --- suspension force along the surface normal ---
    const float pen_rate = -(vcx * n_x + vcy * n_y + vcz * n_z);
    float fz = susp_k * penetration + susp_d * pen_rate +
               susp_fric * tanhf(pen_rate * 20.f);
    fz = in_contact ? maxp(fz, 0.f) : 0.f;

    // --- tire frame: wheel heading projected on the contact plane ---
    float hx, hy, hz;
    if (w >= 2) {
      const float steer_w = new_steer_pos[w - 2];
      const float cd = cosf(steer_w);
      const float sd = sinf(steer_w);
      hx = r00 * cd + r01 * sd;
      hy = r10 * cd + r11 * sd;
      hz = r20 * cd + r21 * sd;
    } else {
      hx = r00;
      hy = r10;
      hz = r20;
    }
    const float hdn = hx * n_x + hy * n_y + hz * n_z;
    float tlx = hx - hdn * n_x;
    float tly = hy - hdn * n_y;
    float tlz = hz - hdn * n_z;
    const float tnorm = maxp(sqrtf(tlx * tlx + tly * tly + tlz * tlz), 1e-6f);
    tlx = tlx / tnorm;
    tly = tly / tnorm;
    tlz = tlz / tnorm;
    // lateral = n x t_long
    const float ttx = n_y * tlz - n_z * tly;
    const float tty = n_z * tlx - n_x * tlz;
    const float ttz = n_x * tly - n_y * tlx;

    const float v_long = vcx * tlx + vcy * tly + vcz * tlz;
    const float v_lat = vcx * ttx + vcy * tty + vcz * ttz;

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
    const float fwx = fz * n_x + fx_tire * tlx + fy_tire * ttx;
    const float fwy = fz * n_y + fx_tire * tly + fy_tire * tty;
    const float fwz = fz * n_z + fx_tire * tlz + fy_tire * ttz;
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
  const float half_dt = c.half_dt;
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
