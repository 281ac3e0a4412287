"""Plain reference of the elevation task's training env (MushrElevationRL-v0,
MuSHR with four-wheel drive on a heightfield): terrain, reset, the generic
manager step (action map, 10 heightfield substeps, goal commands,
terminations, weighted rewards, auto-reset, curriculum) and the 26 x 26
height-scan observation, in plain PyTorch.

A frozen copy of the plain code that the generic step and kernel K3 are
held to: the reference WheeledLab elevation env
(`mushr_elevation_env_cfg.py`) with the procedural heightfield that stands
in for its USD terrain, as the port's plain path computes them, operation
for operation. It imports nothing of the program. Every random draw comes
from the env generator it is handed, in the program's order and shapes.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from .drift import (
    atan_approx, base_params, batch, div, euler_xyz_from_quat, pack_params,
    pack_state, quat_from_yaw, quat_rotate_inverse, with_mass,
)

# MuSHR with the four-wheel-drive suspension actuator group
MUSHR_4WD = dict(L=0.325, W=0.2, r=0.05, m=3.8, h=0.06, steer_kp=100.0,
                 steer_kd=10.0, steer_effort=3.2, steer_vel_limit=10.0,
                 steer_inertia=2e-3, steer_limit=0.55, motor_damping=1000.0,
                 sat_effort=1.05, effort_limit=0.25, vel_limit=450.0,
                 drive_mask=(1.0, 1.0, 1.0, 1.0), wheel_inertia=2.5e-4,
                 tire_b=9.0, tire_c=1.5, roll_res=1e-4, susp_fric=0.5,
                 gravity=9.81)
TASK_SEED = 42
EXTENT, CELL, MOUNDS = 44.0, 0.25, 60
SIM_DT, DECIMATION, EPISODE_S = 0.01, 10, 20.0
STEP_DT = SIM_DT * DECIMATION
MAX_EPISODE = int(round(EPISODE_S / STEP_DT))
REST_H = 0.06
SCAN_N, SCAN_RES = 26, 0.1
GOAL_RANGE, GOAL_RESAMPLE_S, HEADING = 19.0, 10.0, (-3.14, 3.14)
SPAWN_RANGE, SPAWN_VEL = 19.0, (0.1, 0.2)
MASS_DELTA_RANGE = (0.2, 0.5)
# reward terms' initial weights (vel_towards_goal, height_z,
# falling_penalty, termination_penalty) and the curriculum: (term, increase,
# episodes per increase, max increases)
WEIGHTS = (200.0, 5000.0, 0.0, -200.0)
CURRICULUM = ((0, 5.0, 50, 5), (2, 1.0, 50, 10))
COS_ROLLOVER = float(torch.cos(torch.deg2rad(torch.tensor(60.0))))
OBS_DIM = 2 + 3 + 3 + 3 + 2 + SCAN_N * SCAN_N


# ---------------------------------------------------------------- terrain


def heightfield() -> torch.Tensor:
    """The (177, 177) field of 60 Gaussian mounds drawn from the task seed,
    each mound's height capped at 0.55 x its radius, max-combined."""
    g = torch.Generator().manual_seed(TASK_SEED + 23)
    n = int(round(EXTENT / CELL)) + 1
    u = lambda shape, lo, hi: torch.rand(shape, generator=g) * (hi - lo) + lo
    centers = u((MOUNDS, 2), -EXTENT / 2 * 0.9, EXTENT / 2 * 0.9)
    heights = u((MOUNDS,), 0.2, 0.9)
    radii = u((MOUNDS,), 1.5, 4.0)
    heights = torch.minimum(heights, 0.55 * radii)
    axis = (torch.arange(n, dtype=torch.float32) - (n - 1) / 2.0) * CELL
    gx, gy = torch.meshgrid(axis, axis, indexing="ij")
    d2 = ((gx[None] - centers[:, 0, None, None]) ** 2
          + (gy[None] - centers[:, 1, None, None]) ** 2)
    mounds = heights[:, None, None] * torch.exp(
        -d2 / (2.0 * radii[:, None, None] ** 2))
    return mounds.max(dim=0).values


class Atlas:
    """Every (p, p) window of the field at `stride`-cell anchors, one flat
    row each; an env's window is one row gather."""

    def __init__(self, height: torch.Tensor, p: int, stride: int, device):
        nx, ny = height.shape
        self.p, self.stride, self.nx, self.ny = p, stride, nx, ny
        self.nax = max((nx - p + stride - 1) // stride + 1, 1)
        self.nay = max((ny - p + stride - 1) // stride + 1, 1)
        sxs = np.minimum(np.arange(self.nax) * stride, nx - p)
        sys_ = np.minimum(np.arange(self.nay) * stride, ny - p)
        win = np.lib.stride_tricks.sliding_window_view(height.numpy(), (p, p))
        rows = win[sxs[:, None], sys_[None, :]].reshape(self.nax * self.nay,
                                                        p * p)
        self.rows = torch.as_tensor(np.ascontiguousarray(rows, np.float32),
                                    device=device)

    def extract_rows(self, px, py):
        """(patch rows (p*p, B), grid origins (2, B)) of world centers."""
        p, s, nx, ny = self.p, self.stride, self.nx, self.ny
        gx = div(px, CELL) + (nx - 1) / 2.0
        gy = div(py, CELL) + (ny - 1) / 2.0
        ix = torch.clamp(torch.round(div(gx - p / 2.0, s)).to(torch.int64),
                         0, self.nax - 1)
        iy = torch.clamp(torch.round(div(gy - p / 2.0, s)).to(torch.int64),
                         0, self.nay - 1)
        sx = torch.clamp(ix * s, max=nx - p)
        sy = torch.clamp(iy * s, max=ny - p)
        rows = self.rows[ix * self.nay + iy]
        return rows.T.contiguous(), torch.stack([sx, sy]).to(torch.float32)

    def lookup(self, xy):
        """Bilinear height at world points (B, 2)."""
        p = self.p
        rows, org = self.extract_rows(xy[:, 0], xy[:, 1])
        u = div(xy[:, 0], CELL) + (self.nx - 1) / 2.0 - org[0]
        v = div(xy[:, 1], CELL) + (self.ny - 1) / 2.0 - org[1]
        u = torch.clamp(u, 0.0, p - 1.001)
        v = torch.clamp(v, 0.0, p - 1.001)
        h00, h01, h10, h11, fx, fy = corners(rows, u, v, p)
        hr0 = (1.0 - fx) * h00 + fx * h10
        hr1 = (1.0 - fx) * h01 + fx * h11
        return hr0 * (1.0 - fy) + hr1 * fy


def corners(patch, u, v, p: int):
    """Bilinear corners (h00, h01, h10, h11) and fractions of the queries
    (u, v) in patch rows (p*p, B)."""
    x0 = torch.floor(u)
    y0 = torch.floor(v)
    fx = u - x0
    fy = v - y0
    ix = torch.clamp(x0.to(torch.int64), 0, p - 2)
    iy = torch.clamp(y0.to(torch.int64), 0, p - 2)
    idx = (ix * p + iy)[None]
    corner = lambda off: torch.gather(patch, 0, idx + off)[0]
    return corner(0), corner(1), corner(p), corner(p + 1), fx, fy


# ----------------------------------------------------- heightfield physics


def query(patch, org, qx, qy, p, nx, ny):
    u = div(qx, CELL) + (nx - 1) / 2.0 - org[0]
    v = div(qy, CELL) + (ny - 1) / 2.0 - org[1]
    u = torch.clamp(u, 0.0, p - 1.001)
    v = torch.clamp(v, 0.0, p - 1.001)
    h00, h01, h10, h11, fx, fy = corners(patch, u, v, p)
    hr0 = (1.0 - fx) * h00 + fx * h10
    hr1 = (1.0 - fx) * h01 + fx * h11
    h = hr0 * (1.0 - fy) + hr1 * fy
    dhdx = div((h10 - h00) * (1.0 - fy) + (h11 - h01) * fy, CELL)
    dhdy = div(hr1 - hr0, CELL)
    inv = 1.0 / torch.sqrt(dhdx * dhdx + dhdy * dhdy + 1.0)
    return h, -dhdx * inv, -dhdy * inv, inv


def substep_hf(state, params, patch, org, steer_t, wheel_t, dt, p, nx, ny):
    """One rough-terrain substep on packed rows: contact along the local
    surface normal, the tire frame projected on the contact plane."""
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
        gh, n_x, n_y, n_z = query(patch, org, cwx, cwy, p, nx, ny)
        penetration = gh + radius - cwz
        in_contact = penetration > 0.0
        ax = cwx - px
        ay = cwy - py
        az = cwz - radius - pz
        vcx = vx + wy * az - wz * ay
        vcy = vy + wz * ax - wx * az
        vcz = vz + wx * ay - wy * ax
        pen_rate = -(vcx * n_x + vcy * n_y + vcz * n_z)
        fz = (susp_k * penetration + susp_d * pen_rate
              + susp_fric * torch.tanh(pen_rate * 20.0))
        fz = torch.where(in_contact, torch.clamp(fz, min=0.0), 0.0)
        if w in (2, 3):
            steer_w = new_steer_pos[0] if w == 2 else new_steer_pos[1]
            cd, sd = torch.cos(steer_w), torch.sin(steer_w)
            hx = r00 * cd + r01 * sd
            hy = r10 * cd + r11 * sd
            hz = r20 * cd + r21 * sd
        else:
            hx, hy, hz = r00, r10, r20
        hdn = hx * n_x + hy * n_y + hz * n_z
        tlx = hx - hdn * n_x
        tly = hy - hdn * n_y
        tlz = hz - hdn * n_z
        tnorm = torch.clamp(torch.sqrt(tlx * tlx + tly * tly + tlz * tlz),
                            min=1e-6)
        tlx, tly, tlz = tlx / tnorm, tly / tnorm, tlz / tnorm
        ttx = n_y * tlz - n_z * tly
        tty = n_z * tlx - n_x * tlz
        ttz = n_x * tly - n_y * tlx
        v_long = vcx * tlx + vcy * tly + vcz * tlz
        v_lat = vcx * ttx + vcy * tty + vcz * ttz
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


def decimated_substeps(rows, params, patch, org, steer_t, wheel_t, p, nx,
                       ny):
    """The `DECIMATION` substeps of one control step."""
    for _ in range(DECIMATION):
        rows = substep_hf(rows, params, patch, org, steer_t, wheel_t, SIM_DT,
                          p, nx, ny)
    return rows


class SubstepGraph:
    """`decimated_substeps` captured once as a CUDA graph and replayed: the
    same kernels in the same order on the same shapes as the eager loop,
    so the same bits, with one launch in place of some 6,500 (the eager
    loop is paced by the host's launches)."""

    def __init__(self, fn):
        self.fn, self.graph = fn, None

    def __call__(self, *args):
        if self.graph is None:
            self.inputs = [a.clone() for a in args]
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                self.fn(*self.inputs)
            torch.cuda.current_stream().wait_stream(side)
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph):
                self.out = self.fn(*self.inputs)
        for dst, src in zip(self.inputs, args):
            dst.copy_(src)
        self.graph.replay()
        return self.out.clone()


# ------------------------------------------------------------------ the env

FIELDS = ("pos", "quat", "lin_vel", "ang_vel", "wheel", "steer_pos",
          "steer_vel")
SLICES = ((0, 3), (3, 7), (7, 10), (10, 13), (13, 17), (17, 19), (19, 21))


def unpack(rows):
    """(21, B) rows -> the vehicle's (B, k) fields, as views."""
    return {f: rows[a:b].T for f, (a, b) in zip(FIELDS, SLICES)}


class State(NamedTuple):
    rows: torch.Tensor
    params: torch.Tensor
    step_count: torch.Tensor
    common_step: int
    weights: torch.Tensor
    last_action: torch.Tensor
    command: torch.Tensor
    command_timer: torch.Tensor
    ep_return: torch.Tensor
    ep_len: torch.Tensor


class StepOut(NamedTuple):
    obs: torch.Tensor
    reward: torch.Tensor
    done: torch.Tensor
    time_out: torch.Tensor


def curriculum_weights(common_step: int) -> tuple:
    episodes = common_step // MAX_EPISODE
    new = list(WEIGHTS)
    f32 = lambda x: torch.tensor(x, dtype=torch.float32)
    for idx, inc, per, most in CURRICULUM:
        n_inc = min((episodes + 1) // per, most + 1)
        new[idx] = float(f32(WEIGHTS[idx]) + f32(inc) * f32(float(n_inc)))
    return tuple(new)


class ElevationEnv:
    """The elevation task's env at `num_envs`, drawing from `generator`."""

    obs_dim, action_dim = OBS_DIM, 2

    def __init__(self, num_envs: int, generator: torch.Generator, device):
        self.n, self.g, self.device = num_envs, generator, device
        height = heightfield()
        self.scan_atlas = Atlas(height, 24, 6, device)
        self.contact_atlas = Atlas(height, 12, 2, device)
        ca = self.contact_atlas
        substeps = functools.partial(decimated_substeps, p=ca.p, nx=ca.nx,
                                     ny=ca.ny)
        self.substeps = (SubstepGraph(substeps)
                         if torch.device(device).type == "cuda" else substeps)
        axis = (torch.arange(SCAN_N, dtype=torch.float32)
                - (SCAN_N - 1) / 2.0) * SCAN_RES
        ox, oy = torch.meshgrid(axis, axis, indexing="ij")
        self.offs = (ox.reshape(1, -1).to(device), oy.reshape(1, -1).to(device))
        self.command_steps = max(int(round(GOAL_RESAMPLE_S / STEP_DT)), 1)
        self._weights = {}

    def weights(self, values: tuple) -> torch.Tensor:
        if values not in self._weights:
            self._weights[values] = torch.tensor(values, dtype=torch.float32,
                                                 device=self.device)
        return self._weights[values]

    def _u(self, shape, lo, hi):
        return (torch.rand(shape, generator=self.g, device=self.device)
                * (hi - lo) + lo)

    def spawn(self):
        n, dev = self.n, self.device
        xy = self._u((n, 2), -SPAWN_RANGE, SPAWN_RANGE)
        yaw = self._u((n,), -torch.pi, torch.pi)
        vel_xy = self._u((n, 2), *SPAWN_VEL)
        ground = self.contact_atlas.lookup(xy)
        z = lambda k: torch.zeros((n, k), dtype=torch.float32, device=dev)
        return {"pos": torch.cat([xy, (ground + REST_H + 0.02)[:, None]], -1),
                "quat": quat_from_yaw(yaw),
                "lin_vel": torch.cat([vel_xy, z(1)], -1), "ang_vel": z(3),
                "wheel": z(4), "steer_pos": z(2), "steer_vel": z(2)}

    def command(self):
        n = self.n
        return torch.stack([self._u((n,), -GOAL_RANGE, GOAL_RANGE),
                            self._u((n,), -GOAL_RANGE, GOAL_RANGE),
                            self._u((n,), *HEADING)], -1)

    def reset(self):
        n, dev = self.n, self.device
        p = batch(base_params(MUSHR_4WD), n, dev)
        lo, hi = MASS_DELTA_RANGE
        dmass = torch.rand((n,), generator=self.g, device=dev) * (hi - lo) + lo
        p = with_mass(p, p["mass"] + dmass)
        v = self.spawn()
        rows = pack_state(*(v[f] for f in FIELDS))
        state = State(
            rows=rows, params=pack_params(p, 1.0),
            step_count=torch.zeros((n,), dtype=torch.int32, device=dev),
            common_step=0, weights=self.weights(WEIGHTS),
            last_action=torch.zeros((n, 2), device=dev),
            command=self.command(),
            command_timer=torch.full((n,), self.command_steps,
                                     dtype=torch.int32, device=dev),
            ep_return=torch.zeros((n,), device=dev),
            ep_len=torch.zeros((n,), dtype=torch.int32, device=dev))
        return state, self.observe(unpack(rows), state.command,
                                   state.last_action)

    def observe(self, v, command, last_action):
        """Goal, attitude, body rates, last action and the yaw-aligned
        height scan relative to the car, each clipped."""
        a = self.scan_atlas
        p = a.p
        offs_x, offs_y = self.offs
        goal_rel = torch.nan_to_num(command[..., :2] - v["pos"][..., :2])
        euler = euler_xyz_from_quat(v["quat"])
        yaw = euler[..., 2]
        pos2 = v["pos"][..., :2]
        rows, org = a.extract_rows(pos2[:, 0], pos2[:, 1])
        patch = rows.T
        c, s = torch.cos(yaw)[:, None], torch.sin(yaw)[:, None]
        qx = pos2[:, 0, None] + offs_x * c - offs_y * s
        qy = pos2[:, 1, None] + offs_x * s + offs_y * c
        u = torch.clamp(div(qx, CELL) + (a.nx - 1) / 2.0 - org[0][:, None],
                        0.0, p - 1.001)
        w = torch.clamp(div(qy, CELL) + (a.ny - 1) / 2.0 - org[1][:, None],
                        0.0, p - 1.001)
        x0 = torch.floor(u)
        y0 = torch.floor(w)
        fx, fy = u - x0, w - y0
        idx = (torch.clamp(x0.to(torch.int64), 0, p - 2) * p
               + torch.clamp(y0.to(torch.int64), 0, p - 2))
        corner = lambda off: torch.gather(patch, 1, idx + off)
        r0 = (1.0 - fx) * corner(0) + fx * corner(p)
        r1 = (1.0 - fx) * corner(1) + fx * corner(p + 1)
        scan = r0 * (1.0 - fy) + r1 * fy
        rel_scan = scan - (v["pos"][..., 2] - REST_H)[..., None]
        body_lin = quat_rotate_inverse(v["quat"], v["lin_vel"])
        body_ang = quat_rotate_inverse(v["quat"], v["ang_vel"])
        return torch.cat([
            goal_rel, euler, torch.clamp(body_lin, -10.0, 10.0),
            torch.clamp(body_ang, -10.0, 10.0),
            torch.clamp(last_action, -1.0, 1.0),
            torch.clamp(rel_scan, -10.0, 10.0)], dim=-1)

    def step(self, s: State, action: torch.Tensor):
        n, dev = self.n, self.device
        # action map: clip, scale (3.0, 0.488), no reverse; four-wheel
        # drive with the Ackermann-adjusted wheel targets
        out = (torch.clamp(action, -1.0, 1.0) * action.new_tensor((3.0, 0.488))
               + action.new_tensor((0.0, 0.0)))
        out = torch.cat([torch.clamp(out[..., :1], min=0.0), out[..., 1:]],
                        dim=-1)
        v, steer = out[..., 0], out[..., 1]
        L, W, r = MUSHR_4WD["L"], MUSHR_4WD["W"], MUSHR_4WD["r"]
        tan_steering = torch.tan(steer)
        R = torch.where(tan_steering == 0.0, 1e6,
                        torch.full_like(tan_steering, L) / tan_steering)
        r_rear_left = torch.sqrt((R - W / 2) ** 2 + L**2)
        r_rear_right = torch.sqrt((R + W / 2) ** 2 + L**2)
        vfl = v * torch.abs(r_rear_left / (R * r))
        vfr = v * torch.abs(r_rear_right / (R * r))
        vbl = v * torch.abs((R - W / 2) / (R * r))
        vbr = v * torch.abs((R + W / 2) / (R * r))
        steer_t = torch.stack([tan_steering, tan_steering], dim=-1)
        wheel_t = torch.stack([vbl, vbr, vfl, vfr], dim=-1)

        ca = self.contact_atlas
        patch, org = ca.extract_rows(s.rows[0], s.rows[1])
        st, wt = steer_t.T.contiguous(), wheel_t.T.contiguous()
        veh = unpack(self.substeps(s.rows, s.params, patch, org, st, wt))
        step_count = s.step_count + 1
        common = s.common_step + 1
        timer = s.command_timer - 1
        fire = timer <= 0
        command = torch.where(fire[:, None], self.command(), s.command)
        timer = torch.where(fire, self.command_steps, timer)

        body_lin = quat_rotate_inverse(veh["quat"], veh["lin_vel"])
        time_out = step_count >= MAX_EPISODE
        goal_dist = torch.linalg.vector_norm(
            command[..., :2] - veh["pos"][..., :2], dim=-1)
        below = ((veh["pos"][..., 2] - ca.lookup(veh["pos"][..., :2]))
                 < (REST_H - 0.04))
        stuck = ((torch.clamp(body_lin[..., 0], max=1.2) < 0.02)
                 & (torch.sum(veh["wheel"], dim=-1) > 5.0))
        qx, qy = veh["quat"][..., 1], veh["quat"][..., 2]
        rollover = (1 - 2 * (qx * qx + qy * qy)) < COS_ROLLOVER
        at_goal = goal_dist < 0.5
        terminated = torch.zeros((n,), dtype=torch.bool, device=dev)
        for flag in (below, stuck, rollover, at_goal):
            terminated = terminated | flag
        done = terminated | time_out

        pos, vel = veh["pos"][..., :2], veh["lin_vel"][..., :2]
        goal_vec = command[..., :2] - pos
        norm = torch.clamp(torch.linalg.vector_norm(goal_vec, dim=-1),
                           min=1e-6)
        t_goal = 5.0 + torch.sum(vel * goal_vec, dim=-1) / norm
        z = veh["pos"][..., 2] - REST_H
        t_height = torch.clamp(torch.where((z > 0.1) & (body_lin[..., 0] > 0.1),
                                           z, 0.0), 0.0, 1.0)
        t_fall = (body_lin[..., 2] > 0.10).to(torch.float32)
        t_stuck = stuck.to(torch.float32)
        reward = torch.zeros((n,), device=dev)
        for i, t in enumerate((t_goal, t_height, t_fall, t_stuck)):
            reward = reward + s.weights[i] * t * STEP_DT
        ep_return = s.ep_return + reward
        ep_len = s.ep_len + 1

        spawn = self.spawn()
        d1 = done[:, None]
        veh = {f: torch.where(d1, spawn[f], veh[f]) for f in FIELDS}
        step_count = torch.where(done, 0, step_count)
        command = torch.where(d1, self.command(), command)
        timer = torch.where(done, self.command_steps, timer)
        last_action = torch.where(d1, 0.0, action)
        new = State(rows=pack_state(*(veh[f] for f in FIELDS)),
                    params=s.params, step_count=step_count,
                    common_step=common,
                    weights=self.weights(curriculum_weights(common)),
                    last_action=last_action, command=command,
                    command_timer=timer,
                    ep_return=torch.where(done, 0.0, ep_return),
                    ep_len=torch.where(done, 0, ep_len))
        obs = self.observe(veh, command, last_action)
        return new, StepOut(obs=obs, reward=reward, done=done,
                            time_out=time_out)


def make_env(num_envs: int, generator: torch.Generator, device):
    return ElevationEnv(num_envs, generator, device)
