"""Heightfield structure-of-arrays vehicle substep — the port of
`wheeledlab_tpu/sim/soa_hf.py`, and the plain PyTorch version of kernel K3
(`csrc/substep_hf.cuh`, `ops/physics_step_hf.py`).

Terrain comes in as a per-env local patch: `patch` holds the env's (p, p)
height window flattened to p*p rows of the packed layout, and `org` its grid
origin (sx, sy), as `PatchAtlas.extract_rows` gives them. Bilinear height
and the analytic normal come from a direct gather of the four corner rows
(`sim/terrain.py::patch_corners`); the interpolation and the sloped-normal
contact keep the reference's operand order line for line. Divisions by `dt`
and `cell` go through `utils.math.div`, so that on the card this version
divides as the kernel does.
"""

from __future__ import annotations

import torch

from ..utils.math import div
from .soa import (
    P_EFFORT_LIMIT, P_GRAVITY, P_MASS, P_ROLL_RES, P_SAT_EFFORT,
    P_STEER_EFFORT, P_STEER_INERTIA, P_STEER_KD, P_STEER_KP, P_STEER_LIMIT,
    P_STEER_VEL_LIMIT, P_SUSP_D, P_SUSP_FRIC, P_SUSP_K, P_TIRE_B, P_TIRE_C,
    P_VEL_LIMIT, P_WHEEL_INERTIA, P_WHEEL_RADIUS, STEER_POS, STEER_VEL, WHEEL,
    atan_approx,
)
from .terrain import patch_corners


def _query_patch(patch, org, qx, qy, *, p: int, nx: int, ny: int,
                 cell: float):
    """Height and outward normal at world (qx, qy) from the resident patch:
    rows are interpolated along x first, then along y."""
    u = div(qx, cell) + (nx - 1) / 2.0 - org[0]
    v = div(qy, cell) + (ny - 1) / 2.0 - org[1]
    u = torch.clamp(u, 0.0, p - 1.001)
    v = torch.clamp(v, 0.0, p - 1.001)
    h00, h01, h10, h11, fx, fy = patch_corners(patch, u, v, p)
    hr0 = (1.0 - fx) * h00 + fx * h10              # row interp at y0
    hr1 = (1.0 - fx) * h01 + fx * h11              # row interp at y1
    h = hr0 * (1.0 - fy) + hr1 * fy
    dhdx = div((h10 - h00) * (1.0 - fy) + (h11 - h01) * fy, cell)
    dhdy = div(hr1 - hr0, cell)
    inv = 1.0 / torch.sqrt(dhdx * dhdx + dhdy * dhdy + 1.0)
    return h, -dhdx * inv, -dhdy * inv, inv        # h, nx, ny, nz


def substep_soa_hf(state: torch.Tensor, params: torch.Tensor,
                   patch: torch.Tensor, org: torch.Tensor,
                   steer_t: torch.Tensor, wheel_t: torch.Tensor, dt: float,
                   *, p: int, nx: int, ny: int, cell: float) -> torch.Tensor:
    """One rough-terrain substep on packed rows.

    state: (NUM_STATE, B); params: (NUM_PARAM, B); patch: (p*p, B);
    org: (2, B) f32; steer_t: (2, B); wheel_t: (4, B) -> new state
    (NUM_STATE, B)."""
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

    # --- steering servo (implicit PD; identical to substep_soa) ---
    s_inertia = params[P_STEER_INERTIA]
    s_kp, s_kd = params[P_STEER_KP], params[P_STEER_KD]
    denom = 1.0 + dt * s_kd / s_inertia + dt * dt * s_kp / s_inertia
    omega_impl = (steer_vel + dt * (s_kp / s_inertia)
                  * (steer_t - steer_pos)) / denom
    torque = div(s_inertia * (omega_impl - steer_vel), dt)
    lim = params[P_STEER_EFFORT]
    torque = torch.clamp(torque, -lim, lim)
    new_steer_vel = steer_vel + dt * torque / s_inertia
    vlim = params[P_STEER_VEL_LIMIT]
    new_steer_vel = torch.clamp(new_steer_vel, -vlim, vlim)
    theta_new = steer_pos + dt * new_steer_vel
    theta_lim = params[P_STEER_LIMIT]
    theta_cl = torch.clamp(theta_new, -theta_lim, theta_lim)
    new_steer_vel = torch.where(theta_new == theta_cl, new_steer_vel,
                                div(theta_cl - steer_pos, dt))
    new_steer_pos = theta_cl

    # --- per-wheel contact on the sloped local terrain ---
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
        # terrain height + normal under the wheel (resident patch)
        gh, n_x, n_y, n_z = _query_patch(
            patch, org, cwx, cwy, p=p, nx=nx, ny=ny, cell=cell)
        penetration = gh + radius - cwz
        in_contact = penetration > 0.0

        # contact point = wheel center - r * ez; arm from body origin
        ax = cwx - px
        ay = cwy - py
        az = cwz - radius - pz
        # contact point velocity: v + omega x arm
        vcx = vx + wy * az - wz * ay
        vcy = vy + wz * ax - wx * az
        vcz = vz + wx * ay - wy * ax

        # --- suspension force along the surface normal ---
        pen_rate = -(vcx * n_x + vcy * n_y + vcz * n_z)
        fz = (susp_k * penetration + susp_d * pen_rate
              + susp_fric * torch.tanh(pen_rate * 20.0))
        fz = torch.where(in_contact, torch.clamp(fz, min=0.0), 0.0)

        # --- tire frame: wheel heading projected on the contact plane ---
        if w in (2, 3):
            steer_w = new_steer_pos[0] if w == 2 else new_steer_pos[1]
            cd = torch.cos(steer_w)
            sd = torch.sin(steer_w)
            hx = r00 * cd + r01 * sd
            hy = r10 * cd + r11 * sd
            hz = r20 * cd + r21 * sd
        else:
            hx, hy, hz = r00, r10, r20
        hdn = hx * n_x + hy * n_y + hz * n_z
        tlx = hx - hdn * n_x
        tly = hy - hdn * n_y
        tlz = hz - hdn * n_z
        tnorm = torch.clamp(
            torch.sqrt(tlx * tlx + tly * tly + tlz * tlz), min=1e-6)
        tlx, tly, tlz = tlx / tnorm, tly / tnorm, tlz / tnorm
        # lateral = n x t_long
        ttx = n_y * tlz - n_z * tly
        tty = n_z * tlx - n_x * tlz
        ttz = n_x * tly - n_y * tlx

        v_long = vcx * tlx + vcy * tly + vcz * tlz
        v_lat = vcx * ttx + vcy * tty + vcz * ttz

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
        tau = div(w_inertia * (om_impl - om), dt)
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
        fwx = fz * n_x + fx_tire * tlx + fy_tire * ttx
        fwy = fz * n_y + fx_tire * tly + fy_tire * tty
        fwz = fz * n_z + fx_tire * tlz + fy_tire * ttz
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
