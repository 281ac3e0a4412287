"""Structure-of-arrays vehicle substep — the port of
`wheeledlab_tpu/sim/soa.py`.

Everything operates on (rows, B) row matrices, with the 4-wheel loop
unrolled in Python. This is the plain PyTorch version of the flat-ground
substep; the CUDA kernel's copy of the same math is `csrc/substep.cuh`, and
`tasks/drift/fused.py::drift_step_rows` runs this one on the CPU and as the
kernel's test oracle. Operation order follows the reference line for line so
that the float results stay aligned.
"""

from __future__ import annotations

import math

import torch

from .types import VehicleParams, VehicleState


def atan_approx(x: torch.Tensor) -> torch.Tensor:
    """Full-range arctan approximation (max err ~0.0038 rad) from the
    classic quadratic minimax on [0, 1] + reciprocal identity. The reference
    uses it in every path, so the port keeps it rather than `torch.atan`."""
    a = torch.abs(x)
    small = a <= 1.0
    z = torch.where(small, a, 1.0 / torch.clamp(a, min=1e-30))
    p = z * (math.pi / 4 + 0.273 * (1.0 - z))
    r = torch.where(small, p, math.pi / 2 - p)
    return torch.sign(x) * r


def atan2_approx(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Quadrant-corrected atan2 built on `atan_approx` (max err ~0.0038
    rad; `torch.atan2` differs from it by up to that much)."""
    # sign-preserving clamp: for tiny NEGATIVE x the denominator must stay
    # negative, or base lands in the wrong quadrant and the +-pi correction
    # overshoots to ~+-3pi/2 (outside [-pi, pi])
    safe_x = torch.where(torch.abs(x) < 1e-30,
                         torch.where(x < 0, -1e-30, 1e-30), x)
    base = atan_approx(y / safe_x)
    return torch.where(
        x > 0.0, base,
        torch.where(x < 0.0,
                    base + torch.where(y >= 0.0, math.pi, -math.pi),
                    torch.sign(y) * (math.pi / 2)))


def asin_approx(x: torch.Tensor) -> torch.Tensor:
    """arcsin via atan2 (same approximation budget); input clipped to
    [-1, 1]."""
    xc = torch.clamp(x, -1.0, 1.0)
    return atan2_approx(xc, torch.sqrt(torch.clamp(1.0 - xc * xc, min=0.0)))


# State packing: rows of the (NUM_STATE, B) matrix
POS = slice(0, 3)
QUAT = slice(3, 7)
LINVEL = slice(7, 10)
ANGVEL = slice(10, 13)
WHEEL = slice(13, 17)
STEER_POS = slice(17, 19)
STEER_VEL = slice(19, 21)
NUM_STATE = 21


def pack_state(s: VehicleState) -> torch.Tensor:
    """(B, ...) VehicleState -> (NUM_STATE, B) row matrix."""
    return torch.cat([
        s.pos.T, s.quat.T, s.lin_vel.T, s.ang_vel.T,
        s.wheel_omega.T, s.steer_pos.T, s.steer_vel.T], dim=0).contiguous()


def unpack_state(m: torch.Tensor) -> VehicleState:
    return VehicleState(
        pos=m[POS].T, quat=m[QUAT].T, lin_vel=m[LINVEL].T,
        ang_vel=m[ANGVEL].T, wheel_omega=m[WHEEL].T,
        steer_pos=m[STEER_POS].T, steer_vel=m[STEER_VEL].T)


# Param packing: rows of the (NUM_PARAM, B) matrix
P_MASS = 0
P_INERTIA = slice(1, 4)
P_GRAVITY = 4
P_WHEEL_RADIUS = 5
P_WHEEL_POS = slice(6, 18)       # 4 wheels x xyz
P_STEER_KP = 18
P_STEER_KD = 19
P_STEER_EFFORT = 20
P_STEER_VEL_LIMIT = 21
P_STEER_INERTIA = 22
P_STEER_LIMIT = 23
P_MOTOR_DAMPING = slice(24, 28)
P_SAT_EFFORT = 28
P_EFFORT_LIMIT = 29
P_VEL_LIMIT = 30
P_DRIVE_MASK = slice(31, 35)
P_WHEEL_INERTIA = 35
P_TIRE_MU = slice(36, 40)
P_TIRE_B = 40
P_TIRE_C = 41
P_ROLL_RES = 42
P_SUSP_K = 43
P_SUSP_D = 44
P_SUSP_FRIC = 45
NUM_PARAM = 46


def pack_params(p: VehicleParams, ground_friction) -> torch.Tensor:
    """Batched VehicleParams -> (NUM_PARAM, B). Ground friction is folded
    into tire_mu (combine mode: multiply)."""
    b = p.mass.shape[0]
    row = lambda x: x.expand(b)[None, :]
    rows3 = lambda x: x.expand(b, 3).T
    rows4 = lambda x: x.expand(b, 4).T
    return torch.cat([
        row(p.mass), rows3(p.inertia), row(p.gravity), row(p.wheel_radius),
        p.wheel_pos_b.expand(b, 4, 3).reshape(b, 12).T,
        row(p.steer_kp), row(p.steer_kd), row(p.steer_effort_limit),
        row(p.steer_vel_limit), row(p.steer_inertia), row(p.steer_limit),
        rows4(p.motor_damping), row(p.motor_sat_effort),
        row(p.motor_effort_limit), row(p.motor_vel_limit),
        rows4(p.drive_mask), row(p.wheel_inertia),
        rows4(p.tire_mu * ground_friction),
        row(p.tire_stiffness), row(p.tire_shape), row(p.rolling_resistance),
        row(p.susp_stiffness), row(p.susp_damping), row(p.susp_friction),
    ], dim=0).contiguous()


def substep_soa(state: torch.Tensor, params: torch.Tensor,
                steer_t: torch.Tensor, wheel_t: torch.Tensor,
                dt: float) -> torch.Tensor:
    """One flat-ground substep on packed rows.

    state: (NUM_STATE, B); params: (NUM_PARAM, B); steer_t: (2, B);
    wheel_t: (4, B) -> new state (NUM_STATE, B)."""
    px, py, pz = state[0], state[1], state[2]
    qw, qx, qy, qz = state[3], state[4], state[5], state[6]
    vx, vy, vz = state[7], state[8], state[9]
    wx, wy, wz = state[10], state[11], state[12]
    steer_pos = state[STEER_POS]
    steer_vel = state[STEER_VEL]
    wheel_om = state[WHEEL]

    mass = params[P_MASS]
    ixx, iyy, izz = params[1], params[2], params[3]
    gravity = params[P_GRAVITY]
    radius = params[P_WHEEL_RADIUS]

    # rotation matrix (body->world) from quaternion
    r00 = 1 - 2 * (qy * qy + qz * qz)
    r01 = 2 * (qx * qy - qw * qz)
    r02 = 2 * (qx * qz + qw * qy)
    r10 = 2 * (qx * qy + qw * qz)
    r11 = 1 - 2 * (qx * qx + qz * qz)
    r12 = 2 * (qy * qz - qw * qx)
    r20 = 2 * (qx * qz - qw * qy)
    r21 = 2 * (qy * qz + qw * qx)
    r22 = 1 - 2 * (qx * qx + qy * qy)

    # --- steering servo (implicit PD) ---
    s_inertia = params[P_STEER_INERTIA]
    s_kp, s_kd = params[P_STEER_KP], params[P_STEER_KD]
    denom = 1.0 + dt * s_kd / s_inertia + dt * dt * s_kp / s_inertia
    omega_impl = (steer_vel + dt * (s_kp / s_inertia)
                  * (steer_t - steer_pos)) / denom
    torque = s_inertia * (omega_impl - steer_vel) / dt
    lim = params[P_STEER_EFFORT]
    torque = torch.clamp(torque, -lim, lim)
    new_steer_vel = steer_vel + dt * torque / s_inertia
    vlim = params[P_STEER_VEL_LIMIT]
    new_steer_vel = torch.clamp(new_steer_vel, -vlim, vlim)
    theta_new = steer_pos + dt * new_steer_vel
    theta_lim = params[P_STEER_LIMIT]
    theta_cl = torch.clamp(theta_new, -theta_lim, theta_lim)
    new_steer_vel = torch.where(theta_new == theta_cl, new_steer_vel,
                                (theta_cl - steer_pos) / dt)
    new_steer_pos = theta_cl

    # --- per-wheel forces (flat ground) ---
    fx_tot = torch.zeros_like(px)
    fy_tot = torch.zeros_like(px)
    fz_tot = torch.zeros_like(px)
    tx_tot = torch.zeros_like(px)
    ty_tot = torch.zeros_like(px)
    tz_tot = torch.zeros_like(px)
    new_wheel_rows = []

    w_inertia = params[P_WHEEL_INERTIA]
    tire_b, tire_c = params[P_TIRE_B], params[P_TIRE_C]
    susp_k, susp_d = params[P_SUSP_K], params[P_SUSP_D]
    susp_fric = params[P_SUSP_FRIC]

    for w in range(4):
        wpx = params[6 + 3 * w]
        wpy = params[7 + 3 * w]
        wpz = params[8 + 3 * w]
        # wheel center world position
        cwx = px + r00 * wpx + r01 * wpy + r02 * wpz
        cwy = py + r10 * wpx + r11 * wpy + r12 * wpz
        cwz = pz + r20 * wpx + r21 * wpy + r22 * wpz
        # contact point = wheel center - r * ez; arm from body origin
        ax = cwx - px
        ay = cwy - py
        az = cwz - radius - pz
        # contact point velocity: v + omega x arm
        vcx = vx + wy * az - wz * ay
        vcy = vy + wz * ax - wx * az
        vcz = vz + wx * ay - wy * ax

        penetration = radius - cwz
        in_contact = penetration > 0.0
        # spring + damper + tanh-smoothed suspension-joint dry friction
        fz = (susp_k * penetration + susp_d * (-vcz)
              + susp_fric * torch.tanh(-vcz * 20.0))
        fz = torch.where(in_contact, torch.clamp(fz, min=0.0), 0.0)

        # tire frame: wheel heading projected on the ground plane; rear
        # wheels (0, 1) never steer
        if w in (2, 3):
            steer_w = new_steer_pos[0] if w == 2 else new_steer_pos[1]
            cd = torch.cos(steer_w)
            sd = torch.sin(steer_w)
            hx = r00 * cd + r01 * sd
            hy = r10 * cd + r11 * sd
        else:
            hx, hy = r00, r10
        hnorm = torch.clamp(torch.sqrt(hx * hx + hy * hy), min=1e-6)
        tlx, tly = hx / hnorm, hy / hnorm
        v_long = vcx * tlx + vcy * tly
        v_lat = -vcx * tly + vcy * tlx

        mu = params[36 + w]
        om = wheel_om[w]
        sdenom = torch.clamp(torch.abs(v_long), min=0.6)
        sx = (om * radius - v_long) / sdenom
        sy = -v_lat / sdenom
        s = torch.sqrt(sx * sx + sy * sy + 1e-9)
        f_norm = torch.sin(tire_c * atan_approx(tire_b * s))
        scale = mu * fz * f_norm / s
        fx_tire = scale * sx
        fy_tire = scale * sy
        dfx_dom = mu * fz * tire_b * tire_c * radius / sdenom

        # motor torque (implicit velocity drive + DC saturation clip)
        d_m = params[24 + w]
        alpha = dt * d_m / w_inertia
        om_impl = (om + alpha * wheel_t[w]) / (1.0 + alpha)
        tau = w_inertia * (om_impl - om) / dt
        sat = params[P_SAT_EFFORT]
        elim = params[P_EFFORT_LIMIT]
        vlim_m = params[P_VEL_LIMIT]
        tau_max = torch.minimum(torch.clamp(sat * (1.0 - om / vlim_m),
                                            min=0.0), elim)
        tau_min = torch.minimum(torch.maximum(sat * (-1.0 - om / vlim_m),
                                              -elim), torch.zeros_like(om))
        tau = torch.minimum(torch.maximum(tau, tau_min), tau_max) \
            * params[31 + w]

        tau_slip = -fx_tire * radius
        tau_roll = -params[P_ROLL_RES] * om
        impl_denom = 1.0 + dt * dfx_dom * radius / w_inertia
        new_om = om + dt * (tau + tau_slip + tau_roll) / w_inertia / impl_denom
        new_wheel_rows.append(new_om)

        # accumulate world force + torque about body origin
        fwx = fx_tire * tlx - fy_tire * tly
        fwy = fx_tire * tly + fy_tire * tlx
        fwz = fz
        fx_tot = fx_tot + fwx
        fy_tot = fy_tot + fwy
        fz_tot = fz_tot + fwz
        tx_tot = tx_tot + (ay * fwz - az * fwy)
        ty_tot = ty_tot + (az * fwx - ax * fwz)
        tz_tot = tz_tot + (ax * fwy - ay * fwx)

    fz_tot = fz_tot - mass * gravity

    new_vx = vx + dt * fx_tot / mass
    new_vy = vy + dt * fy_tot / mass
    new_vz = vz + dt * fz_tot / mass

    # angular dynamics in body frame (diagonal inertia, gyroscopic term)
    obx = r00 * wx + r10 * wy + r20 * wz
    oby = r01 * wx + r11 * wy + r21 * wz
    obz = r02 * wx + r12 * wy + r22 * wz
    tbx = r00 * tx_tot + r10 * ty_tot + r20 * tz_tot
    tby = r01 * tx_tot + r11 * ty_tot + r21 * tz_tot
    tbz = r02 * tx_tot + r12 * ty_tot + r22 * tz_tot
    gx = oby * (izz * obz) - obz * (iyy * oby)
    gy = obz * (ixx * obx) - obx * (izz * obz)
    gz = obx * (iyy * oby) - oby * (ixx * obx)
    obx = obx + dt * (tbx - gx) / ixx
    oby = oby + dt * (tby - gy) / iyy
    obz = obz + dt * (tbz - gz) / izz
    new_wx = r00 * obx + r01 * oby + r02 * obz
    new_wy = r10 * obx + r11 * oby + r12 * obz
    new_wz = r20 * obx + r21 * oby + r22 * obz

    new_px = px + dt * new_vx
    new_py = py + dt * new_vy
    new_pz = pz + dt * new_vz

    # quaternion integration: q += 0.5 dt (omega_quat * q), renormalize
    dqw = 0.5 * dt * (-new_wx * qx - new_wy * qy - new_wz * qz)
    dqx = 0.5 * dt * (new_wx * qw + new_wy * qz - new_wz * qy)
    dqy = 0.5 * dt * (-new_wx * qz + new_wy * qw + new_wz * qx)
    dqz = 0.5 * dt * (new_wx * qy - new_wy * qx + new_wz * qw)
    nqw, nqx, nqy, nqz = qw + dqw, qx + dqx, qy + dqy, qz + dqz
    qn = torch.clamp(
        torch.sqrt(nqw * nqw + nqx * nqx + nqy * nqy + nqz * nqz), min=1e-9)
    nqw, nqx, nqy, nqz = nqw / qn, nqx / qn, nqy / qn, nqz / qn

    return torch.stack([
        new_px, new_py, new_pz,
        nqw, nqx, nqy, nqz,
        new_vx, new_vy, new_vz,
        new_wx, new_wy, new_wz,
        new_wheel_rows[0], new_wheel_rows[1], new_wheel_rows[2],
        new_wheel_rows[3],
        new_steer_pos[0], new_steer_pos[1],
        new_steer_vel[0], new_steer_vel[1],
    ], dim=0)
