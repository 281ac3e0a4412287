// Heightfield vehicle substep for one env, worked by a group of 4 adjacent
// lanes (lane w owns wheel w; see `substep.cuh`), with the env's terrain
// patch held in shared memory.
//
// CUDA copy of `wheeledlab_torch/sim/soa_hf.py::substep_soa_hf` (itself the
// port of `wheeledlab_tpu/sim/soa_hf.py::substep_soa_hf`): bilinear height
// and analytic normal under each wheel from the resident (p, p) patch, then
// the sloped-normal contact (suspension along the surface normal, tire frame
// projected on the contact plane). Expressions keep the reference's order of
// operations. The four bilinear corners are direct indexed loads; the
// reference's masked sums over the patch rows are a TPU workaround for the
// missing gather and give the same values.
//
// Design: `substep.cuh`'s. Lane w queries the patch under wheel w and
// computes that wheel's contact; rotation, steering servo, tire and motor
// model and the rigid-body update are `substep.cuh`'s own functions, the
// six totals its wheel-order sums. The patch's layout in shared memory
// (`patch_pitch`, who reads which bank) is described in
// `physics_step_hf.cu`, which stages it.
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

// Row pitch of a patch in shared memory: the smallest pitch >= p that is 2
// modulo 4 (see `physics_step_hf.cu` for the bank arithmetic). Mirrored by
// `patch_pitch` in wheeledlab_torch/ops/physics_step_hf.py.
__host__ __device__ __forceinline__ int patch_pitch(int p) {
  return p + ((2 - p) & 3);
}

// Height and outward normal at world (qx, qy). `patch` points at this env's
// cell (0, 0); cell (ix, iy) lies at patch[(ix * pitch + iy) * stride].
__device__ __forceinline__ void query_patch(const float* patch, int stride,
                                            int pitch, float org_x,
                                            float org_y, float qx, float qy,
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
  const int idx = ix * pitch + iy;
  const float h00 = patch[idx * stride];
  const float h01 = patch[(idx + 1) * stride];
  const float h10 = patch[(idx + pitch) * stride];
  const float h11 = patch[(idx + pitch + 1) * stride];
  const float hr0 = (1.f - fx) * h00 + fx * h10;  // row interp at y0
  const float hr1 = (1.f - fx) * h01 + fx * h11;  // row interp at y1
  h = hr0 * (1.f - fy) + hr1 * fy;
  const float dhdx =
      divz((h10 - h00) * (1.f - fy) + (h11 - h01) * fy, c.cell);
  const float dhdy = divz(hr1 - hr0, c.cell);
  const float inv = 1.f / sqrtf(dhdx * dhdx + dhdy * dhdy + 1.f);
  n_x = -dhdx * inv;
  n_y = -dhdy * inv;
  n_z = inv;
}

// One heightfield substep of one env by its 4 lanes, in place on each
// lane's share of the state. `steer_t` is the target of axis w & 1,
// `wheel_t` the target of wheel w.
__device__ __forceinline__ void substep_hf(LaneState& s, const LaneParams& p,
                                           int w, const float* patch,
                                           int stride, int pitch, float org_x,
                                           float org_y, float steer_t,
                                           float wheel_t, const HfConsts c) {
  const float dt = c.dt;
  const Rot R = rotation(s.body[S_QW], s.body[S_QX], s.body[S_QY],
                         s.body[S_QZ]);
  servo_step(s, p, steer_t, dt, c.dt2);

  // --- this lane's wheel on the sloped local terrain ---
  const WheelPose k = wheel_pose(s, p, R);
  // terrain height + normal under the wheel (resident patch)
  float gh, n_x, n_y, n_z;
  query_patch(patch, stride, pitch, org_x, org_y, k.cwx, k.cwy, c, gh, n_x,
              n_y, n_z);
  const float penetration = gh + p.radius - k.cwz;
  const bool in_contact = penetration > 0.f;

  // suspension force along the surface normal
  const float pen_rate = -(k.vcx * n_x + k.vcy * n_y + k.vcz * n_z);
  float fz = p.susp_k * penetration + p.susp_d * pen_rate +
             p.susp_fric * tanhf(pen_rate * 20.f);
  fz = in_contact ? maxp(fz, 0.f) : 0.f;

  // tire frame: wheel heading projected on the contact plane; rear wheels
  // (0, 1) never steer, wheel w >= 2 turns with this lane's own axis
  const bool steered = w >= 2;
  const float cd = cosf(s.sp);
  const float sd = sinf(s.sp);
  const float hx = steered ? R.r00 * cd + R.r01 * sd : R.r00;
  const float hy = steered ? R.r10 * cd + R.r11 * sd : R.r10;
  const float hz = steered ? R.r20 * cd + R.r21 * sd : R.r20;
  const float hdn = hx * n_x + hy * n_y + hz * n_z;
  float tlx = hx - hdn * n_x;
  float tly = hy - hdn * n_y;
  float tlz = hz - hdn * n_z;
  const float tnorm = maxp(sqrtf(tlx * tlx + tly * tly + tlz * tlz), 1e-6f);
  tlx = divz(tlx, tnorm);
  tly = divz(tly, tnorm);
  tlz = divz(tlz, tnorm);
  // lateral = n x t_long
  const float ttx = n_y * tlz - n_z * tly;
  const float tty = n_z * tlx - n_x * tlz;
  const float ttz = n_x * tly - n_y * tlx;

  const float v_long = k.vcx * tlx + k.vcy * tly + k.vcz * tlz;
  const float v_lat = k.vcx * ttx + k.vcy * tty + k.vcz * ttz;

  float fx_tire, fy_tire, new_om;
  tire_and_motor(p, s.om, wheel_t, v_long, v_lat, fz, dt, fx_tire, fy_tire,
                 new_om);
  s.om = new_om;

  // world force of this wheel; torque about the body origin in the sum
  const float fwx = fz * n_x + fx_tire * tlx + fy_tire * ttx;
  const float fwy = fz * n_y + fx_tire * tly + fy_tire * tty;
  const float fwz = fz * n_z + fx_tire * tlz + fy_tire * ttz;
  rigid_body_step(s, p, R, k, fwx, fwy, fwz, dt, c.half_dt);
}

}  // namespace wl
