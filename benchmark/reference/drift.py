"""Plain reference of the drift task's training env (MushrDriftRL-v0, MuSHR
with rear drive): reset, the control step and the curriculum, in plain
PyTorch on (rows, B) tensors.

A frozen copy of the plain code that the fused step (kernel K1) is held to:
the reference WheeledLab drift env (`mushr_drift_env_cfg.py`,
`drifting/mdp/events.py`) as the port's plain path computes it, operation
for operation, so that on one device it gives the kernel's bits. It imports
nothing of the program. Every random draw comes from the env generator this
module is handed, in the order and shapes of the program's env, so the same
seed gives the same draws on both sides.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple

import torch

# ------------------------------------------------------------------ maths


def div(x: torch.Tensor, c: float) -> torch.Tensor:
    """`x / c` divided exactly (on CUDA a tensor over a Python float is a
    multiply by the reciprocal)."""
    if x.is_cuda:
        return x / torch.full_like(x, c)
    return x / c


def atan_approx(x):
    a = torch.abs(x)
    small = a <= 1.0
    z = torch.where(small, a, 1.0 / torch.clamp(a, min=1e-30))
    p = z * (math.pi / 4 + 0.273 * (1.0 - z))
    r = torch.where(small, p, math.pi / 2 - p)
    return torch.sign(x) * r


def atan2_approx(y, x):
    safe_x = torch.where(torch.abs(x) < 1e-30,
                         torch.where(x < 0, -1e-30, 1e-30), x)
    base = atan_approx(y / safe_x)
    return torch.where(
        x > 0.0, base,
        torch.where(x < 0.0,
                    base + torch.where(y >= 0.0, math.pi, -math.pi),
                    torch.sign(y) * (math.pi / 2)))


def asin_approx(x):
    xc = torch.clamp(x, -1.0, 1.0)
    return atan2_approx(xc, torch.sqrt(torch.clamp(1.0 - xc * xc, min=0.0)))


def quat_from_yaw(yaw):
    zeros = torch.zeros_like(yaw)
    roll, pitch = zeros, zeros
    cr, sr = torch.cos(roll * 0.5), torch.sin(roll * 0.5)
    cp, sp = torch.cos(pitch * 0.5), torch.sin(pitch * 0.5)
    cy, sy = torch.cos(yaw * 0.5), torch.sin(yaw * 0.5)
    return torch.stack([cy * cp * cr + sy * sp * sr,
                        cy * cp * sr - sy * sp * cr,
                        cy * sp * cr + sy * cp * sr,
                        sy * cp * cr - cy * sp * sr], dim=-1)


def quat_rotate_inverse(q, v):
    q = q * q.new_tensor([1.0, -1.0, -1.0, -1.0])
    qw, qv = q[..., 0:1], q[..., 1:4]
    t = 2.0 * torch.linalg.cross(qv, v, dim=-1)
    return v + qw * t + torch.linalg.cross(qv, t, dim=-1)


def euler_xyz_from_quat(q):
    w, x, y, z = q.unbind(-1)
    roll = torch.atan2(2.0 * (w * x + y * z), 1.0 - 2.0 * (x * x + y * y))
    pitch = torch.asin(torch.clamp(2.0 * (w * y - z * x), -1.0, 1.0))
    yaw = torch.atan2(2.0 * (w * z + x * y), 1.0 - 2.0 * (y * y + z * z))
    return torch.stack([roll, pitch, yaw], dim=-1)


# ------------------------------------------------------------ the vehicle

NUM_STATE, NUM_PARAM = 21, 46
# MuSHR with the rear-drive actuator group (wheelbase 0.325 m, track 0.2 m,
# wheel radius 0.05 m, mass 3.8 kg)
MUSHR = dict(L=0.325, W=0.2, r=0.05, m=3.8, h=0.06, steer_kp=100.0,
             steer_kd=10.0, steer_effort=3.2, steer_vel_limit=10.0,
             steer_inertia=2e-3, steer_limit=0.55, motor_damping=1000.0,
             sat_effort=1.05, effort_limit=0.5, vel_limit=450.0,
             drive_mask=(1.0, 1.0, 0.0, 0.0), wheel_inertia=2.5e-4,
             tire_b=9.0, tire_c=1.5, roll_res=1e-4, susp_fric=0.5,
             gravity=9.81)


def suspension_for_mass(mass, omega_n: float = 70.0, zeta: float = 0.8):
    quarter = mass / 4.0
    return quarter * omega_n**2, 2.0 * zeta * quarter * omega_n


def base_params(v: dict) -> Dict[str, torch.Tensor]:
    """Single-vehicle parameters as float32 tensors."""
    f = lambda x: torch.tensor(x, dtype=torch.float32)
    L, W, r, m, h = v["L"], v["W"], v["r"], v["m"], v["h"]
    lx, wy = L / 2.0, W / 2.0
    k, d = suspension_for_mass(m)
    return dict(
        mass=f(m), inertia=f([m / 12.0 * (W**2 + 0.01) * 3.0,
                              m / 12.0 * (L**2 + 0.01) * 3.0,
                              m / 12.0 * (L**2 + W**2) * 1.5]),
        gravity=f(v["gravity"]),
        wheel_pos_b=f([[-lx, +wy, -h + r], [-lx, -wy, -h + r],
                       [+lx, +wy, -h + r], [+lx, -wy, -h + r]]),
        wheel_radius=f(r), steer_kp=f(v["steer_kp"]),
        steer_kd=f(v["steer_kd"]), steer_effort_limit=f(v["steer_effort"]),
        steer_vel_limit=f(v["steer_vel_limit"]),
        steer_inertia=f(v["steer_inertia"]), steer_limit=f(v["steer_limit"]),
        motor_damping=f([v["motor_damping"]] * 4),
        motor_sat_effort=f(v["sat_effort"]),
        motor_effort_limit=f(v["effort_limit"]),
        motor_vel_limit=f(v["vel_limit"]), drive_mask=f(list(v["drive_mask"])),
        wheel_inertia=f(v["wheel_inertia"]), tire_mu=f([1.0] * 4),
        tire_stiffness=f(v["tire_b"]), tire_shape=f(v["tire_c"]),
        rolling_resistance=f(v["roll_res"]), susp_stiffness=f(k),
        susp_damping=f(d), susp_friction=f(v["susp_fric"]))


def batch(p: Dict[str, torch.Tensor], n: int, device) -> Dict[str, torch.Tensor]:
    return {k: x.to(device).expand((n,) + tuple(x.shape)).contiguous()
            for k, x in p.items()}


def with_mass(p: Dict[str, torch.Tensor], mass) -> Dict[str, torch.Tensor]:
    k, d = suspension_for_mass(mass)
    return {**p, "mass": mass.to(torch.float32), "susp_stiffness": k,
            "susp_damping": d}


def pack_params(p: Dict[str, torch.Tensor], ground_friction) -> torch.Tensor:
    b = p["mass"].shape[0]
    row = lambda x: x.expand(b)[None, :]
    rows3 = lambda x: x.expand(b, 3).T
    rows4 = lambda x: x.expand(b, 4).T
    return torch.cat([
        row(p["mass"]), rows3(p["inertia"]), row(p["gravity"]),
        row(p["wheel_radius"]),
        p["wheel_pos_b"].expand(b, 4, 3).reshape(b, 12).T,
        row(p["steer_kp"]), row(p["steer_kd"]), row(p["steer_effort_limit"]),
        row(p["steer_vel_limit"]), row(p["steer_inertia"]),
        row(p["steer_limit"]), rows4(p["motor_damping"]),
        row(p["motor_sat_effort"]), row(p["motor_effort_limit"]),
        row(p["motor_vel_limit"]), rows4(p["drive_mask"]),
        row(p["wheel_inertia"]), rows4(p["tire_mu"] * ground_friction),
        row(p["tire_stiffness"]), row(p["tire_shape"]),
        row(p["rolling_resistance"]), row(p["susp_stiffness"]),
        row(p["susp_damping"]), row(p["susp_friction"]),
    ], dim=0).contiguous()


def pack_state(pos, quat, lin_vel, ang_vel, wheel, steer_pos, steer_vel):
    return torch.cat([pos.T, quat.T, lin_vel.T, ang_vel.T, wheel.T,
                      steer_pos.T, steer_vel.T], dim=0).contiguous()


def substep(state, params, steer_t, wheel_t, dt: float):
    """One flat-ground substep on packed rows (the rigid chassis, four
    spring-contact wheels with a Pacejka-like tire, servo steering, DC
    motors)."""
    px, py, pz = state[0], state[1], state[2]
    qw, qx, qy, qz = state[3], state[4], state[5], state[6]
    vx, vy, vz = state[7], state[8], state[9]
    wx, wy, wz = state[10], state[11], state[12]
    steer_pos, steer_vel, wheel_om = state[17:19], state[19:21], state[13:17]
    mass = params[0]
    ixx, iyy, izz = params[1], params[2], params[3]
    gravity, radius = params[4], params[5]
    r00 = 1 - 2 * (qy * qy + qz * qz)
    r01 = 2 * (qx * qy - qw * qz)
    r02 = 2 * (qx * qz + qw * qy)
    r10 = 2 * (qx * qy + qw * qz)
    r11 = 1 - 2 * (qx * qx + qz * qz)
    r12 = 2 * (qy * qz - qw * qx)
    r20 = 2 * (qx * qz - qw * qy)
    r21 = 2 * (qy * qz + qw * qx)
    r22 = 1 - 2 * (qx * qx + qy * qy)

    s_inertia, s_kp, s_kd = params[22], params[18], params[19]
    denom = 1.0 + dt * s_kd / s_inertia + dt * dt * s_kp / s_inertia
    omega_impl = (steer_vel + dt * (s_kp / s_inertia)
                  * (steer_t - steer_pos)) / denom
    torque = div(s_inertia * (omega_impl - steer_vel), dt)
    lim = params[20]
    torque = torch.clamp(torque, -lim, lim)
    new_steer_vel = steer_vel + dt * torque / s_inertia
    vlim = params[21]
    new_steer_vel = torch.clamp(new_steer_vel, -vlim, vlim)
    theta_new = steer_pos + dt * new_steer_vel
    theta_lim = params[23]
    theta_cl = torch.clamp(theta_new, -theta_lim, theta_lim)
    new_steer_vel = torch.where(theta_new == theta_cl, new_steer_vel,
                                div(theta_cl - steer_pos, dt))
    new_steer_pos = theta_cl

    fx_tot = torch.zeros_like(px)
    fy_tot = torch.zeros_like(px)
    fz_tot = torch.zeros_like(px)
    tx_tot = torch.zeros_like(px)
    ty_tot = torch.zeros_like(px)
    tz_tot = torch.zeros_like(px)
    new_wheel = []
    w_inertia, tire_b, tire_c = params[35], params[40], params[41]
    susp_k, susp_d, susp_fric = params[43], params[44], params[45]
    for w in range(4):
        wpx, wpy, wpz = params[6 + 3 * w], params[7 + 3 * w], params[8 + 3 * w]
        cwx = px + r00 * wpx + r01 * wpy + r02 * wpz
        cwy = py + r10 * wpx + r11 * wpy + r12 * wpz
        cwz = pz + r20 * wpx + r21 * wpy + r22 * wpz
        ax = cwx - px
        ay = cwy - py
        az = cwz - radius - pz
        vcx = vx + wy * az - wz * ay
        vcy = vy + wz * ax - wx * az
        vcz = vz + wx * ay - wy * ax
        penetration = radius - cwz
        in_contact = penetration > 0.0
        fz = (susp_k * penetration + susp_d * (-vcz)
              + susp_fric * torch.tanh(-vcz * 20.0))
        fz = torch.where(in_contact, torch.clamp(fz, min=0.0), 0.0)
        if w in (2, 3):
            steer_w = new_steer_pos[0] if w == 2 else new_steer_pos[1]
            cd, sd = torch.cos(steer_w), torch.sin(steer_w)
            hx = r00 * cd + r01 * sd
            hy = r10 * cd + r11 * sd
        else:
            hx, hy = r00, r10
        hnorm = torch.clamp(torch.sqrt(hx * hx + hy * hy), min=1e-6)
        tlx, tly = hx / hnorm, hy / hnorm
        v_long = vcx * tlx + vcy * tly
        v_lat = -vcx * tly + vcy * tlx
        mu, om = params[36 + w], wheel_om[w]
        sdenom = torch.clamp(torch.abs(v_long), min=0.6)
        sx = (om * radius - v_long) / sdenom
        sy = -v_lat / sdenom
        s = torch.sqrt(sx * sx + sy * sy + 1e-9)
        f_norm = torch.sin(tire_c * atan_approx(tire_b * s))
        scale = mu * fz * f_norm / s
        fx_tire = scale * sx
        fy_tire = scale * sy
        dfx_dom = mu * fz * tire_b * tire_c * radius / sdenom
        d_m = params[24 + w]
        alpha = dt * d_m / w_inertia
        om_impl = (om + alpha * wheel_t[w]) / (1.0 + alpha)
        tau = div(w_inertia * (om_impl - om), dt)
        sat, elim, vlim_m = params[28], params[29], params[30]
        tau_max = torch.minimum(torch.clamp(sat * (1.0 - om / vlim_m),
                                            min=0.0), elim)
        tau_min = torch.minimum(torch.maximum(sat * (-1.0 - om / vlim_m),
                                              -elim), torch.zeros_like(om))
        tau = torch.minimum(torch.maximum(tau, tau_min), tau_max) \
            * params[31 + w]
        tau_slip = -fx_tire * radius
        tau_roll = -params[42] * om
        impl_denom = 1.0 + dt * dfx_dom * radius / w_inertia
        new_wheel.append(om + dt * (tau + tau_slip + tau_roll) / w_inertia
                         / impl_denom)
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
    dqw = 0.5 * dt * (-new_wx * qx - new_wy * qy - new_wz * qz)
    dqx = 0.5 * dt * (new_wx * qw + new_wy * qz - new_wz * qy)
    dqy = 0.5 * dt * (-new_wx * qz + new_wy * qw + new_wz * qx)
    dqz = 0.5 * dt * (new_wx * qy - new_wy * qx + new_wz * qw)
    nqw, nqx, nqy, nqz = qw + dqw, qx + dqx, qy + dqy, qz + dqz
    qn = torch.clamp(torch.sqrt(nqw * nqw + nqx * nqx + nqy * nqy
                                + nqz * nqz), min=1e-9)
    nqw, nqx, nqy, nqz = nqw / qn, nqx / qn, nqy / qn, nqz / qn
    return torch.stack([
        new_px, new_py, new_pz, nqw, nqx, nqy, nqz, new_vx, new_vy, new_vz,
        new_wx, new_wy, new_wz, new_wheel[0], new_wheel[1], new_wheel[2],
        new_wheel[3], new_steer_pos[0], new_steer_pos[1], new_steer_vel[0],
        new_steer_vel[1]], dim=0)


def body_vels(ns):
    qw, qx, qy, qz = ns[3], ns[4], ns[5], ns[6]
    r00 = 1 - 2 * (qy * qy + qz * qz)
    r01 = 2 * (qx * qy - qw * qz)
    r02 = 2 * (qx * qz + qw * qy)
    r10 = 2 * (qx * qy + qw * qz)
    r11 = 1 - 2 * (qx * qx + qz * qz)
    r12 = 2 * (qy * qz - qw * qx)
    r20 = 2 * (qx * qz - qw * qy)
    r21 = 2 * (qy * qz + qw * qx)
    r22 = 1 - 2 * (qx * qx + qy * qy)
    vx, vy, vz = ns[7], ns[8], ns[9]
    wx, wy, wz = ns[10], ns[11], ns[12]
    bv = (r00 * vx + r10 * vy + r20 * vz, r01 * vx + r11 * vy + r21 * vz,
          r02 * vx + r12 * vy + r22 * vz)
    bw = (r00 * wx + r10 * wy + r20 * wz, r01 * wx + r11 * wy + r21 * wz,
          r02 * wx + r12 * wy + r22 * wz)
    return bv, bw


# --------------------------------------------------------------- the task

# oval track: straights at x = +-0.8 for |y| < 0.8, semicircles of radius
# 0.8 about (0, +-0.8)
STRAIGHT, TRACK_RADIUS = 0.8, 0.8
CORNER_IN, CORNER_OUT = 0.3, 2.0
SLIP_THRESHOLD, MAX_SPEED = 0.55, 3.0
NUM_RESET_POINTS, POS_NOISE, YAW_NOISE, SPAWN_Z = 20, 0.5, 1.0, 0.06
TASK_SEED = 42
SIM_DT, DECIMATION, EPISODE_S = 0.005, 4, 5.0
STEP_DT = SIM_DT * DECIMATION
MAX_EPISODE = int(round(EPISODE_S / STEP_DT))
# pushes: (interval s, ranges of lin x, lin y, yaw rate)
PUSHES = (((0.1, 0.4), ((-0.1, 0.1), (-0.03, 0.03), (-0.3, 0.3))),
          ((0.8, 1.2), ((0.0, 0.0), (0.0, 0.0), (-0.6, 0.6))))
# reward terms' initial weights, in the step's order, and the curriculum:
# (term index, increase, episodes per increase, max increases)
WEIGHTS = (10.0, -5.0, 40.0, 0.0, 20.0, -50.0, -5000.0)
CURRICULUM = ((0, 20.0, 20, 10), (3, 10.0, 20, 5), (6, -1000.0, 50, 5))
OBS_STD = [0.1] * 6 + [0.5] * 3 + [0.4] * 3 + [0.0, 0.0]
FRICTION_RANGE, FRICTION_BUCKETS = (0.3, 0.5), 20
MASS_DELTA_RANGE, DAMPING_RANGE = (0.3, 0.5), (10.0, 50.0)
OBS_DIM = 14


def push_steps(interval):
    lo = max(int(round(interval[0] / STEP_DT)), 1)
    hi = max(int(round(interval[1] / STEP_DT)), lo + 1)
    return lo, hi


def track_poses() -> torch.Tensor:
    """The (20, 4) spawn poses (x, y, z, yaw), by arc length along the
    oval at fractions drawn from the task seed."""
    u = torch.rand((NUM_RESET_POINTS,),
                   generator=torch.Generator().manual_seed(TASK_SEED + 17))
    radius, straight, n = TRACK_RADIUS, STRAIGHT, NUM_RESET_POINTS
    dists = u * (2.0 * math.pi * radius + 4.0 * straight)
    full = lambda v: torch.full((n,), v, dtype=torch.float32)
    c1_pos = torch.stack([full(radius), dists - straight], -1)
    c1_yaw = full(90.0)
    a = (dists - 2 * straight) / radius
    c2_pos = torch.stack([radius * torch.cos(a),
                          straight + radius * torch.sin(a)], -1)
    c2_yaw = 90.0 + a * 180.0 / math.pi
    rem = dists - 2 * straight - math.pi * radius
    c3_pos = torch.stack([full(-radius), straight - rem], -1)
    c3_yaw = full(270.0)
    a2 = (dists - 4 * straight - math.pi * radius) / radius
    c4_pos = torch.stack([-radius * torch.cos(a2),
                          -straight - radius * torch.sin(a2)], -1)
    c4_yaw = 270.0 + a2 * 180.0 / math.pi
    in1 = (dists < 2 * straight)[:, None]
    in2 = (dists < 2 * straight + math.pi * radius)[:, None]
    in3 = (dists < 4 * straight + math.pi * radius)[:, None]
    pos = torch.where(in1, c1_pos, torch.where(
        in2, c2_pos, torch.where(in3, c3_pos, c4_pos)))
    yaw = torch.where(in1[:, 0], c1_yaw, torch.where(
        in2[:, 0], c2_yaw, torch.where(in3[:, 0], c3_yaw, c4_yaw)))
    return torch.cat([pos, full(SPAWN_Z)[:, None],
                      torch.deg2rad(yaw)[:, None]], -1)


class State(NamedTuple):
    rows: torch.Tensor        # (21, B) vehicle rows
    params: torch.Tensor      # (46, B)
    step_count: torch.Tensor  # (B,) int32
    timers: torch.Tensor      # (2, B) int32
    ep_return: torch.Tensor
    ep_len: torch.Tensor
    weights: torch.Tensor     # (7,)
    common_step: int


class StepOut(NamedTuple):
    obs: torch.Tensor
    reward: torch.Tensor
    done: torch.Tensor
    time_out: torch.Tensor


def curriculum_weights(common_step: int) -> tuple:
    """The reward weights after `common_step` control steps, in float32
    arithmetic."""
    episodes = common_step // MAX_EPISODE
    new = list(WEIGHTS)
    f32 = lambda x: torch.tensor(x, dtype=torch.float32)
    for idx, inc, per, most in CURRICULUM:
        n_inc = min((episodes + 1) // per, most + 1)
        new[idx] = float(f32(WEIGHTS[idx]) + f32(inc) * f32(float(n_inc)))
    return tuple(new)


class DriftEnv:
    """The drift task's env at `num_envs`, drawing from `generator`."""

    obs_dim, action_dim = OBS_DIM, 2

    def __init__(self, num_envs: int, generator: torch.Generator, device):
        self.n, self.g, self.device = num_envs, generator, device
        self.poses = track_poses().to(device)
        self._weights = {}

    def weights(self, values: tuple) -> torch.Tensor:
        """A device tensor of `values`, made once per distinct tuple."""
        if values not in self._weights:
            self._weights[values] = torch.tensor(values, dtype=torch.float32,
                                                 device=self.device)
        return self._weights[values]

    def _uniform(self, shape, lo, hi):
        return (torch.rand(shape, generator=self.g, device=self.device)
                * (hi - lo) + lo)

    def reset(self):
        n, g, dev = self.n, self.g, self.device
        p = batch(base_params(MUSHR), n, dev)
        buckets = self._uniform((FRICTION_BUCKETS,), *FRICTION_RANGE)
        assign = torch.randint(0, FRICTION_BUCKETS, (n, 4), generator=g,
                               device=dev)
        p["tire_mu"] = buckets[assign]
        damping = self._uniform((n, 1), *DAMPING_RANGE)
        p["motor_damping"] = damping.expand(n, 4).contiguous()
        dmass = self._uniform((n,), *MASS_DELTA_RANGE)
        p = with_mass(p, p["mass"] + dmass)
        idx = torch.randint(0, NUM_RESET_POINTS, (n,), generator=g, device=dev)
        ref = self.poses[idx]
        xy = (torch.rand((n, 2), generator=g, device=dev) * 2 - 1) * POS_NOISE
        yaw = (torch.rand((n,), generator=g, device=dev) * 2 - 1) * YAW_NOISE
        pos = torch.stack([ref[:, 0] + xy[:, 0], ref[:, 1] + xy[:, 1],
                           ref[:, 2]], -1)
        quat = quat_from_yaw(ref[:, 3] + yaw)
        z = lambda k: torch.zeros((n, k), dtype=torch.float32, device=dev)
        rows = pack_state(pos, quat, z(3), z(3), z(4), z(2), z(2))
        timers = torch.stack([
            torch.randint(*push_steps(interval), (n,), generator=g,
                          device=dev, dtype=torch.int32)
            for interval, _ in PUSHES])
        # the reset observation, with the exact angles
        pos_v, quat_v = rows[0:3].T, rows[3:7].T
        obs = torch.cat([
            pos_v, euler_xyz_from_quat(quat_v),
            quat_rotate_inverse(quat_v, rows[7:10].T),
            quat_rotate_inverse(quat_v, rows[10:13].T),
            torch.clamp(z(2), -1.0, 1.0)], dim=-1)
        noise = torch.randn(obs.shape, generator=g, device=dev)
        obs = obs + noise * obs.new_tensor(OBS_STD)
        state = State(rows=rows, params=pack_params(p, 1.0),
                      step_count=torch.zeros((n,), dtype=torch.int32,
                                             device=dev),
                      timers=timers, ep_return=torch.zeros((n,), device=dev),
                      ep_len=torch.zeros((n,), dtype=torch.int32, device=dev),
                      weights=self.weights(WEIGHTS),
                      common_step=0)
        return state, obs

    def step(self, s: State, action: torch.Tensor):
        n, g, dev = self.n, self.g, self.device
        uniforms = torch.rand((12, n), generator=g, device=dev)
        normals = torch.randn((OBS_DIM, n), generator=g, device=dev)
        a = action.T.contiguous()
        nsr, obs_rows, reward, done, time_out, sc, tm, er, el = control_step(
            s.rows, s.params, a[0], a[1], uniforms, normals, s.weights,
            self.poses, s.step_count, s.timers, s.ep_return, s.ep_len)
        common = s.common_step + 1
        new = State(rows=nsr, params=s.params, step_count=sc, timers=tm,
                    ep_return=er, ep_len=el,
                    weights=self.weights(curriculum_weights(common)),
                    common_step=common)
        return new, StepOut(obs=obs_rows.T, reward=reward, done=done,
                            time_out=time_out)


def control_step(state, params, a0, a1, uniforms, normals, weights, poses,
                 step_count, timers, ep_return, ep_len):
    """One control step: action map, 4 substeps, pushes, terminations,
    rewards, auto-reset, observation. Returns (rows, obs rows (14, B),
    reward, done, time_out, step_count, timers, ep_return, ep_len)."""
    # action map: clip, scale (3.0, 0.488), no reverse; rear drive
    v = torch.clamp(a0, -1.0, 1.0) * 3.0 + 0.0
    st = torch.clamp(a1, -1.0, 1.0) * 0.488 + 0.0
    v = torch.clamp(v, min=0.0)
    tan_steering = torch.sin(st) / torch.cos(st)
    tgt = div(v, MUSHR["r"])
    zeros = torch.zeros_like(tgt)
    steer_t = torch.stack([tan_steering, tan_steering])
    wheel_t = torch.stack([tgt, tgt, zeros, zeros])

    ns = state
    for _ in range(DECIMATION):
        ns = substep(ns, params, steer_t, wheel_t, SIM_DT)

    vx, vy, wz = ns[7], ns[8], ns[12]
    new_timers = []
    for i, (interval, ranges) in enumerate(PUSHES):
        lo_steps, hi_steps = push_steps(interval)
        timer = timers[i] - 1
        fire = timer <= 0
        firef = fire.to(torch.float32)
        (xlo, xhi), (ylo, yhi), (wlo, whi) = ranges
        u = uniforms[3 * i:3 * i + 3]
        if xhi != xlo or xlo != 0.0:
            vx = vx + firef * (xlo + u[0] * (xhi - xlo))
        if yhi != ylo or ylo != 0.0:
            vy = vy + firef * (ylo + u[1] * (yhi - ylo))
        if whi != wlo or wlo != 0.0:
            wz = wz + firef * (wlo + u[2] * (whi - wlo))
        resample = lo_steps + torch.floor(
            uniforms[6 + i] * (hi_steps - lo_steps)).to(torch.int32)
        new_timers.append(torch.where(fire, resample, timer))
    ns = torch.cat([ns[:7], vx[None], vy[None], ns[9:12], wz[None], ns[13:]])
    new_timers = torch.stack(new_timers)

    step_count = step_count + 1
    px, py = ns[0], ns[1]
    on_straights = torch.abs(py) < STRAIGHT
    cy = torch.where(py > 0, py - STRAIGHT, py + STRAIGHT)
    corner_sq = cy * cy + px * px
    off_b = ((on_straights & (torch.abs(px) > CORNER_OUT))
             | (~on_straights & (corner_sq > CORNER_OUT**2)))
    in_b = ((on_straights & (torch.abs(px) < CORNER_IN))
            | (~on_straights & (corner_sq < CORNER_IN**2)))
    oob = off_b | in_b
    time_out = step_count >= MAX_EPISODE
    done = oob | time_out

    bv, bw = body_vels(ns)
    bvx, bvy, bvz = bv
    slip = torch.abs(atan2_approx(bvy, bvx))
    gated = torch.where((torch.abs(bvx) < 1.0) | (slip > SLIP_THRESHOLD),
                        0.0, slip)
    t_side_slip = torch.where(gated < 0.25, 0.0, gated)
    ground_sq = bvx * bvx + bvy * bvy
    t_vel = (torch.sqrt(ground_sq) - MAX_SPEED) ** 2 - MAX_SPEED**2
    t_progress = ns[12]
    steer_mean = 0.5 * (ns[17] + ns[18])
    aw = torch.clamp(bw[2], -1.0, 1.0)
    t_tlgr = torch.clamp(steer_mean * aw * -1.0, min=0.0)
    t_energy = torch.where(torch.abs(py) > STRAIGHT, ground_sq + bvz * bvz,
                           0.0)
    line_d = torch.where(on_straights,
                         torch.where(px > 0, torch.abs(px - TRACK_RADIUS),
                                     torch.abs(px + TRACK_RADIUS)),
                         torch.abs(torch.sqrt(corner_sq) - TRACK_RADIUS))
    t_cross = line_d - 1.0
    t_pens = oob.to(torch.float32)
    reward = torch.zeros_like(px)
    for i, t in enumerate((t_side_slip, t_vel, t_progress, t_tlgr, t_energy,
                           t_cross, t_pens)):
        reward = reward + weights[i] * t * STEP_DT
    ep_return_pre = ep_return + reward
    ep_len_pre = ep_len + 1

    idx = torch.clamp((uniforms[8] * NUM_RESET_POINTS).to(torch.int32),
                      max=NUM_RESET_POINTS - 1)
    pose = poses[idx.long()]
    sp_x = pose[:, 0] + (2.0 * uniforms[9] - 1.0) * POS_NOISE
    sp_y = pose[:, 1] + (2.0 * uniforms[10] - 1.0) * POS_NOISE
    sp_yaw = pose[:, 3] + (2.0 * uniforms[11] - 1.0) * YAW_NOISE
    donef = done.to(torch.float32)
    keep = 1.0 - donef
    spawn = {0: sp_x, 1: sp_y, 2: torch.full_like(px, SPAWN_Z),
             3: torch.cos(0.5 * sp_yaw), 6: torch.sin(0.5 * sp_yaw)}
    nsr = torch.stack([donef * spawn[r] + keep * ns[r] if r in spawn
                       else keep * ns[r] for r in range(NUM_STATE)])
    step_count = torch.where(done, 0, step_count)

    qw, qx, qy, qz = nsr[3], nsr[4], nsr[5], nsr[6]
    roll = atan2_approx(2 * (qw * qx + qy * qz), 1 - 2 * (qx * qx + qy * qy))
    pitch = asin_approx(2 * (qw * qy - qz * qx))
    yaw = atan2_approx(2 * (qw * qz + qx * qy), 1 - 2 * (qy * qy + qz * qz))
    bvr, bwr = body_vels(nsr)
    la0 = torch.clamp(keep * a0, -1.0, 1.0)
    la1 = torch.clamp(keep * a1, -1.0, 1.0)
    obs_rows = [nsr[0], nsr[1], nsr[2], roll, pitch, yaw, bvr[0], bvr[1],
                bvr[2], bwr[0], bwr[1], bwr[2], la0, la1]
    obs_rows = [o + normals[i] * OBS_STD[i] if OBS_STD[i] else o
                for i, o in enumerate(obs_rows)]
    return (nsr, torch.stack(obs_rows), reward, done, time_out, step_count,
            new_timers, keep * ep_return_pre, torch.where(done, 0, ep_len_pre))


def make_env(num_envs: int, generator: torch.Generator, device):
    return DriftEnv(num_envs, generator, device)
