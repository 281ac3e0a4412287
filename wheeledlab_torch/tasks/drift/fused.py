"""Fused drift control step — the whole env step as one CUDA kernel.

Port of `wheeledlab_tpu/tasks/drift/fused.py`. One control step per env:
action map -> 4 x `substep_soa` -> velocity-push events -> oval OOB and
time-out terminations -> the seven weighted drift reward terms -> episode
return/length -> masked auto-reset with spawn sampling from the pose table ->
post-reset observations with Gaussian noise.

The pieces, as for every kernel of the port:

- `drift_step_rows`: the plain PyTorch version on (rows, B) tensors. It
  follows the reference `drift_step_rows` line for line (including
  `tan = sin/cos` and the integer casts) and is both the CPU path and the
  kernels' oracle.
- `fused_drift_step`: the wrapper of the step with streamed random rows.
  CPU tensors go to `drift_step_rows`; CUDA tensors launch the kernel of
  `csrc/fused_drift.cu` (built at first use) or raise. It counts its kernel
  launches in `LAUNCHES`. The kernel replaces
  `wheeledlab_tpu/tasks/drift/fused.py::fused_drift_pallas`.
- `fused_drift_step_krng`: the wrapper of the step that draws its random
  rows itself from one int32 seed. CPU tensors run `ops/kernel_rng.py::
  philox_blocks` and then `drift_step_rows`; CUDA tensors launch the kernel
  of `csrc/fused_drift_krng.cu` or raise. It counts its launches in
  `LAUNCHES_KRNG`. The kernel replaces `fused_drift_pallas_krng` there.
- `make_fused_drift_step`: the env-facing closure that draws the per-step
  random blocks (or, with `WHEELEDLAB_KERNEL_RNG=1` in the environment when
  the env is built, the per-step seed), calls the wrapper and builds the
  info dict.

See `csrc/fused_drift.cu` and `csrc/fused_drift_krng.cu` for the kernels'
bounds and design, and `PERF.md` for their times.
"""

from __future__ import annotations

import ctypes
import functools
import math as pymath
import os

import numpy as np
import torch

from ...ops.checks import check_rows
from ...ops.kernel_rng import check_seed, philox_blocks
from ...parallel.mesh import int32_shard_offset
from ...utils.math import div
from ...utils.profiling import span
from ...sim.soa import (
    NUM_PARAM, NUM_STATE, asin_approx, atan2_approx, substep_soa,
)

# Row indices into the packed (NUM_STATE, B) matrix (sim/soa.py layout)
_PX, _PY, _PZ = 0, 1, 2
_QW, _QX, _QY, _QZ = 3, 4, 5, 6
_VX, _VY, _VZ = 7, 8, 9
_WX, _WY, _WZ = 10, 11, 12
_SL, _SR = 17, 18  # steer_pos rows

# Uniform-block row allocation: one (12, B) uniform draw per control step
# covers both push events and the spawn sampler.
U_PUSH = 0       # rows 0-5: push deltas (2 events x [lin_x, lin_y, yaw])
U_INTERVAL = 6   # rows 6-7: push interval resample
U_SPAWN = 8      # rows 8-11: spawn [idx, dx, dy, dyaw]
NUM_UNIFORM = 12

OBS_ROWS = 14    # BlindObs layout (tasks/common/observations.py)
# Gaussian noise stds per obs row (== _NOISE_STD there)
_OBS_STD = [0.1] * 6 + [0.5] * 3 + [0.4] * 3 + [0.0, 0.0]

# Output-block row map (the "out" output)
O_REWARD, O_DONE, O_TIMEOUT, O_EPRET, O_EPLEN = 0, 1, 2, 3, 4
O_TERMS = 5          # rows 5-11: the 7 weighted per-term rewards
O_OOB = 12           # done/out_of_bounds flag
O_SLIP_DEG = 13      # metrics/slip_deg
O_SPEED = 14         # metrics/speed
NUM_OUT = 15
NUM_TERMS = 7
MAX_PUSH = 2         # push events a kernel launch can carry

REWARD_NAMES = ("side_slip", "vel", "progress", "tlgr", "turn_energy",
                "cross_track", "term_pens")

# Kernel launches made by `fused_drift_step` and by `fused_drift_step_krng`
# (CUDA tensors only).
LAUNCHES = 0
LAUNCHES_KRNG = 0


def _action_targets_rows(a0, a1, acfg):
    """Policy [throttle, steer] rows -> (steer_targets (2, B), wheel
    targets (4, B)); tan via sin/cos, as the reference kernel does."""
    s_throttle, s_steer = acfg.scale
    o_throttle, o_steer = acfg.offset
    if acfg.bounding_strategy == "clip":
        v = torch.clamp(a0, -1.0, 1.0) * s_throttle + o_throttle
        st = torch.clamp(a1, -1.0, 1.0) * s_steer + o_steer
    elif acfg.bounding_strategy == "tanh":
        v = torch.tanh(a0) * s_throttle + o_throttle
        st = torch.tanh(a1) * s_steer + o_steer
    else:
        v = a0 * s_throttle + o_throttle
        st = a1 * s_steer + o_steer
    if acfg.no_reverse:
        v = torch.clamp(v, min=0.0)

    tan_steering = torch.sin(st) / torch.cos(st)
    r = acfg.wheel_radius
    if acfg.drivetrain == "rwd":
        tgt = div(v, r)
        zeros = torch.zeros_like(tgt)
        steer_t = torch.stack([tan_steering, tan_steering])
        wheel_t = torch.stack([tgt, tgt, zeros, zeros])
    elif acfg.drivetrain == "4wd":
        L, W = acfg.base_length, acfg.base_width
        # full_like: `float / tensor` would round twice (reciprocal, then
        # multiply) where the reference divides once
        R = torch.where(tan_steering == 0.0, 1e6,
                        torch.full_like(tan_steering, L) / tan_steering)
        vbl = v * torch.abs((R - W / 2) / (R * r))
        vbr = v * torch.abs((R + W / 2) / (R * r))
        vfl = v * torch.abs(torch.sqrt((R - W / 2) ** 2 + L**2) / (R * r))
        vfr = v * torch.abs(torch.sqrt((R + W / 2) ** 2 + L**2) / (R * r))
        steer_t = torch.stack([tan_steering, tan_steering])
        wheel_t = torch.stack([vbl, vbr, vfl, vfr])
    else:
        raise NotImplementedError(acfg.drivetrain)
    return steer_t, wheel_t


def _body_vels(ns):
    """World->body rotation of lin/ang velocity rows: body_v = R^T v."""
    qw, qx, qy, qz = ns[_QW], ns[_QX], ns[_QY], ns[_QZ]
    r00 = 1 - 2 * (qy * qy + qz * qz)
    r01 = 2 * (qx * qy - qw * qz)
    r02 = 2 * (qx * qz + qw * qy)
    r10 = 2 * (qx * qy + qw * qz)
    r11 = 1 - 2 * (qx * qx + qz * qz)
    r12 = 2 * (qy * qz - qw * qx)
    r20 = 2 * (qx * qz - qw * qy)
    r21 = 2 * (qy * qz + qw * qx)
    r22 = 1 - 2 * (qx * qx + qy * qy)
    vx, vy, vz = ns[_VX], ns[_VY], ns[_VZ]
    wx, wy, wz = ns[_WX], ns[_WY], ns[_WZ]
    bv = (r00 * vx + r10 * vy + r20 * vz,
          r01 * vx + r11 * vy + r21 * vz,
          r02 * vx + r12 * vy + r22 * vz)
    bw = (r00 * wx + r10 * wy + r20 * wz,
          r01 * wx + r11 * wy + r21 * wz,
          r02 * wx + r12 * wy + r22 * wz)
    return bv, bw


def drift_step_rows(state, params, a0, a1, uniforms, normals, weights,
                    poses, step_count, timers, ep_return, ep_len, *, cfg):
    """One full drift control step on (rows, B) tensors — the plain PyTorch
    version of the kernel.

    `cfg` is a `FusedDriftConsts`; `weights` the (7,) curriculum weights;
    `poses` the (num_reset_points, 4) reference pose table; `step_count`,
    `ep_len` (B,) int32; `timers` (n_push, B) int32; `ep_return` (B,).

    Returns (new_state (21, B), obs (OBS_ROWS, B), out (NUM_OUT, B),
    new_step_count, new_timers, new_ep_return, new_ep_len).
    """
    # 1. action manager
    steer_t, wheel_t = _action_targets_rows(a0, a1, cfg.action)

    # 2. physics decimation — the shared substep math
    ns = state
    for _ in range(cfg.decimation):
        ns = substep_soa(ns, params, steer_t, wheel_t, cfg.sim_dt)

    # 3. interval events: velocity pushes
    if cfg.pushes:
        vx, vy, wz = ns[_VX], ns[_VY], ns[_WZ]
        new_timers = []
        for i, (lo_steps, hi_steps, ranges) in enumerate(cfg.pushes):
            timer = timers[i] - 1
            fire = timer <= 0
            firef = fire.to(torch.float32)
            (xlo, xhi), (ylo, yhi), (wlo, whi) = ranges
            u = uniforms[U_PUSH + 3 * i:U_PUSH + 3 * i + 3]
            if xhi != xlo or xlo != 0.0:
                vx = vx + firef * (xlo + u[0] * (xhi - xlo))
            if yhi != ylo or ylo != 0.0:
                vy = vy + firef * (ylo + u[1] * (yhi - ylo))
            if whi != wlo or wlo != 0.0:
                wz = wz + firef * (wlo + u[2] * (whi - wlo))
            resample = lo_steps + torch.floor(
                uniforms[U_INTERVAL + i] * (hi_steps - lo_steps)
            ).to(torch.int32)
            new_timers.append(torch.where(fire, resample, timer))
        ns = torch.cat([ns[:_VX], vx[None], vy[None], ns[_VZ:_WZ],
                        wz[None], ns[_WZ + 1:]])
        new_timers = torch.stack(new_timers)
    else:
        new_timers = timers

    # 4. counters
    step_count = step_count + 1

    # 5. terminations (pre-reset state)
    px, py = ns[_PX], ns[_PY]
    on_straights = torch.abs(py) < cfg.straight
    cy = torch.where(py > 0, py - cfg.straight, py + cfg.straight)
    corner_sq = cy * cy + px * px
    off_b = ((on_straights & (torch.abs(px) > cfg.corner_out_radius))
             | (~on_straights & (corner_sq > cfg.corner_out_radius**2)))
    in_b = ((on_straights & (torch.abs(px) < cfg.corner_in_radius))
            | (~on_straights & (corner_sq < cfg.corner_in_radius**2)))
    oob = off_b | in_b
    if not cfg.terminations_enabled:
        oob = torch.zeros_like(oob)
    time_out = step_count >= cfg.max_episode_length
    done = oob | time_out

    # 6. rewards (pre-reset state; weight * value * step_dt)
    bv, bw = _body_vels(ns)
    bvx, bvy, bvz = bv
    slip = torch.abs(atan2_approx(bvy, bvx))
    gated = torch.where((torch.abs(bvx) < 1.0) | (slip > cfg.slip_threshold),
                        0.0, slip)
    t_side_slip = torch.where(gated < 0.25, 0.0, gated)

    ground_sq = bvx * bvx + bvy * bvy
    ground_speed = torch.sqrt(ground_sq)
    t_vel = (ground_speed - cfg.max_speed) ** 2 - cfg.max_speed**2

    t_progress = ns[_WZ]                      # world yaw rate

    steer_mean = 0.5 * (ns[_SL] + ns[_SR])
    aw = torch.clamp(bw[2], -1.0, 1.0)
    t_tlgr = torch.clamp(steer_mean * aw * -1.0, min=0.0)

    t_energy = torch.where(torch.abs(py) > cfg.straight,
                           ground_sq + bvz * bvz, 0.0)

    line_d = torch.where(on_straights,
                         torch.where(px > 0, torch.abs(px - cfg.track_radius),
                                     torch.abs(px + cfg.track_radius)),
                         torch.abs(torch.sqrt(corner_sq) - cfg.track_radius))
    t_cross = line_d - 1.0

    t_pens = oob.to(torch.float32)

    terms = (t_side_slip, t_vel, t_progress, t_tlgr, t_energy, t_cross,
             t_pens)
    reward = torch.zeros_like(px)
    weighted = []
    for i, t in enumerate(terms):
        r = weights[i] * t * cfg.step_dt
        weighted.append(r)
        reward = reward + r

    ep_return_pre = ep_return + reward
    ep_len_pre = ep_len + 1

    # metrics (slip_deg, speed)
    m_slip_deg = torch.where(torch.abs(bvx) >= 1.0,
                             slip * (180.0 / pymath.pi), 0.0)
    m_speed = ground_speed

    # 7. auto-reset: spawn sampling along the track + masked blend
    idx = torch.clamp((uniforms[U_SPAWN] * cfg.num_reset_points)
                      .to(torch.int32), max=cfg.num_reset_points - 1)
    pose = poses[idx.long()]
    sp_x = pose[:, 0] + (2.0 * uniforms[U_SPAWN + 1] - 1.0) * cfg.pos_noise
    sp_y = pose[:, 1] + (2.0 * uniforms[U_SPAWN + 2] - 1.0) * cfg.pos_noise
    sp_yaw = pose[:, 3] + (2.0 * uniforms[U_SPAWN + 3] - 1.0) * cfg.yaw_noise

    donef = done.to(torch.float32)
    keep = 1.0 - donef
    spawn_rows = {
        _PX: sp_x, _PY: sp_y,
        _PZ: torch.full_like(px, cfg.spawn_z),
        _QW: torch.cos(0.5 * sp_yaw), _QZ: torch.sin(0.5 * sp_yaw),
    }
    blended = []
    for r in range(NUM_STATE):
        if r in spawn_rows:
            blended.append(donef * spawn_rows[r] + keep * ns[r])
        else:
            blended.append(keep * ns[r])   # spawn value is 0 for these rows
    nsr = torch.stack(blended)
    step_count = torch.where(done, 0, step_count)

    # 8. (curriculum runs outside — host closed form of the step counter)

    # 9. observations (post-reset state; BlindObs layout + Gaussian noise)
    qw, qx, qy, qz = nsr[_QW], nsr[_QX], nsr[_QY], nsr[_QZ]
    roll = atan2_approx(2 * (qw * qx + qy * qz), 1 - 2 * (qx * qx + qy * qy))
    pitch = asin_approx(2 * (qw * qy - qz * qx))
    yaw = atan2_approx(2 * (qw * qz + qx * qy), 1 - 2 * (qy * qy + qz * qz))
    bvr, bwr = _body_vels(nsr)
    la0 = torch.clamp(keep * a0, -1.0, 1.0)
    la1 = torch.clamp(keep * a1, -1.0, 1.0)
    obs_rows = [nsr[_PX], nsr[_PY], nsr[_PZ], roll, pitch, yaw,
                bvr[0], bvr[1], bvr[2], bwr[0], bwr[1], bwr[2], la0, la1]
    if cfg.enable_corruption:
        obs_rows = [o + normals[i] * _OBS_STD[i] if _OBS_STD[i] else o
                    for i, o in enumerate(obs_rows)]
    obs = torch.stack(obs_rows)

    out = torch.stack([
        reward, donef, time_out.to(torch.float32),
        ep_return_pre, ep_len_pre.to(torch.float32),
        *weighted, t_pens, m_slip_deg, m_speed,
    ])
    return (nsr, obs, out, step_count, new_timers,
            keep * ep_return_pre, torch.where(done, 0, ep_len_pre))


class FusedDriftConsts:
    """Static constants of the fused step (the reference class of the same
    name, field for field). `c_struct` is the POD struct the kernel takes
    by value."""

    def __init__(self, task_cfg, env_cfg):
        self.action = env_cfg.action
        self.sim_dt = env_cfg.sim_dt
        self.decimation = env_cfg.decimation
        self.step_dt = env_cfg.step_dt
        self.max_episode_length = env_cfg.max_episode_length
        self.straight = task_cfg.track_straight_dist
        self.track_radius = task_cfg.track_radius
        self.corner_in_radius = 0.3     # CORNER_IN_RADIUS
        self.corner_out_radius = 2.0    # CORNER_OUT_RADIUS
        self.slip_threshold = 0.55      # SLIP_THRESHOLD
        self.max_speed = 3.0            # MAX_SPEED
        self.num_reset_points = task_cfg.num_reset_points
        self.pos_noise = task_cfg.pos_noise
        self.yaw_noise = task_cfg.yaw_noise
        self.spawn_z = 0.06             # SPAWN_Z
        self.enable_corruption = task_cfg.enable_corruption
        self.terminations_enabled = task_cfg.terminations_enabled
        # push events in control steps:
        # ((lo, hi, ((xlo,xhi),(ylo,yhi),(wlo,whi))), ...)
        pushes = []
        if task_cfg.events_enabled:
            for p in ((0.1, 0.4, ((-0.1, 0.1), (-0.03, 0.03), (-0.3, 0.3))),
                      (0.8, 1.2, ((0.0, 0.0), (0.0, 0.0), (-0.6, 0.6)))):
                lo = max(int(round(p[0] / self.step_dt)), 1)
                hi = max(int(round(p[1] / self.step_dt)), lo + 1)
                pushes.append((lo, hi, p[2]))
        self.pushes = tuple(pushes)

    @property
    def n_push(self) -> int:
        """Rows of the push-timer block: one per event, at least one."""
        return max(len(self.pushes), 1)

    @functools.cached_property
    def c_struct(self) -> "FusedDriftConstsC":
        """The kernel's constant block. Every value that the reference
        computes in Python (double) and then applies to a float32 array is
        rounded to float32 here once, so the kernel sees the same operands
        as the plain version."""
        f = lambda x: float(np.float32(x))
        a = self.action
        c = FusedDriftConstsC()
        c.dt, c.dt2, c.half_dt = (f(self.sim_dt), f(self.sim_dt * self.sim_dt),
                                  f(0.5 * self.sim_dt))
        c.decimation = self.decimation
        c.step_dt = f(self.step_dt)
        c.max_episode_length = self.max_episode_length
        c.straight, c.track_radius = f(self.straight), f(self.track_radius)
        c.corner_in_radius = f(self.corner_in_radius)
        c.corner_out_radius = f(self.corner_out_radius)
        c.corner_in_sq = f(self.corner_in_radius**2)
        c.corner_out_sq = f(self.corner_out_radius**2)
        c.slip_threshold, c.max_speed = f(self.slip_threshold), f(self.max_speed)
        c.max_speed_sq = f(self.max_speed**2)
        c.num_reset_points = self.num_reset_points
        c.pos_noise, c.yaw_noise = f(self.pos_noise), f(self.yaw_noise)
        c.spawn_z = f(self.spawn_z)
        c.enable_corruption = int(bool(self.enable_corruption))
        c.terminations_enabled = int(bool(self.terminations_enabled))
        if len(self.pushes) > MAX_PUSH:
            raise ValueError(f"at most {MAX_PUSH} push events per kernel")
        c.n_push = len(self.pushes)
        for i, (lo, hi, ranges) in enumerate(self.pushes):
            c.push_lo[i], c.push_hi[i] = lo, hi
            for j, (rlo, rhi) in enumerate(ranges):
                c.push_active[i][j] = int(rhi != rlo or rlo != 0.0)
                c.push_base[i][j] = f(rlo)
                c.push_span[i][j] = f(rhi - rlo)
        drivetrains = {"rwd": 0, "4wd": 1}
        if a.drivetrain not in drivetrains:
            raise NotImplementedError(a.drivetrain)
        c.drivetrain = drivetrains[a.drivetrain]
        c.bounding = {"clip": 0, "tanh": 1}.get(a.bounding_strategy, 2)
        c.no_reverse = int(bool(a.no_reverse))
        c.scale_throttle, c.scale_steer = f(a.scale[0]), f(a.scale[1])
        c.offset_throttle, c.offset_steer = f(a.offset[0]), f(a.offset[1])
        c.wheel_radius = f(a.wheel_radius)
        c.base_length = f(a.base_length)
        c.half_width = f(a.base_width / 2)
        c.base_length_sq = f(a.base_length**2)
        c.obs_std[:] = [f(s) for s in _OBS_STD]
        c.rad_to_deg = f(180.0 / pymath.pi)
        return c


class FusedDriftConstsC(ctypes.Structure):
    """Mirror of `struct FusedDriftConsts` in csrc/drift_step.cuh (same
    field order and types)."""

    _fields_ = [
        ("dt", ctypes.c_float), ("dt2", ctypes.c_float),
        ("half_dt", ctypes.c_float), ("decimation", ctypes.c_int),
        ("step_dt", ctypes.c_float), ("max_episode_length", ctypes.c_int),
        ("straight", ctypes.c_float), ("track_radius", ctypes.c_float),
        ("corner_in_radius", ctypes.c_float),
        ("corner_out_radius", ctypes.c_float),
        ("corner_in_sq", ctypes.c_float), ("corner_out_sq", ctypes.c_float),
        ("slip_threshold", ctypes.c_float), ("max_speed", ctypes.c_float),
        ("max_speed_sq", ctypes.c_float), ("num_reset_points", ctypes.c_int),
        ("pos_noise", ctypes.c_float), ("yaw_noise", ctypes.c_float),
        ("spawn_z", ctypes.c_float), ("enable_corruption", ctypes.c_int),
        ("terminations_enabled", ctypes.c_int), ("n_push", ctypes.c_int),
        ("push_lo", ctypes.c_int * MAX_PUSH),
        ("push_hi", ctypes.c_int * MAX_PUSH),
        ("push_active", (ctypes.c_int * 3) * MAX_PUSH),
        ("push_base", (ctypes.c_float * 3) * MAX_PUSH),
        ("push_span", (ctypes.c_float * 3) * MAX_PUSH),
        ("drivetrain", ctypes.c_int), ("bounding", ctypes.c_int),
        ("no_reverse", ctypes.c_int),
        ("scale_throttle", ctypes.c_float), ("scale_steer", ctypes.c_float),
        ("offset_throttle", ctypes.c_float), ("offset_steer", ctypes.c_float),
        ("wheel_radius", ctypes.c_float), ("base_length", ctypes.c_float),
        ("half_width", ctypes.c_float), ("base_length_sq", ctypes.c_float),
        ("obs_std", ctypes.c_float * OBS_ROWS),
        ("rad_to_deg", ctypes.c_float),
    ]


@functools.lru_cache(maxsize=None)
def _kernel_fn(name: str, n_in: int):
    """The ctypes launcher `<name>_launch` of `csrc/<name>.cu`, built and
    loaded on first use: the constant block, `n_in` input and 7 output
    pointers, the batch size, the stream."""
    from ...ops.build import load_library

    fn = getattr(load_library(name), f"{name}_launch")
    fn.argtypes = ([FusedDriftConstsC] + [ctypes.c_void_p] * (n_in + 7)
                   + [ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def check_step_inputs(cfg, weights, poses, state, params, action_rows,
                      step_count, timers, ep_return, ep_len, action_k=1):
    """Device, dtype, shape and contiguity of what every drift kernel takes;
    `action_rows` holds `action_k` stacked (2, B) blocks."""
    device = state.device
    b = state.shape[-1]
    f32, i32 = torch.float32, torch.int32
    check_rows("weights", weights.view(1, -1), 1, NUM_TERMS, device)
    check_rows("poses", poses, cfg.num_reset_points, 4, device)
    for name, x, rows, dt in (
            ("state", state, NUM_STATE, f32),
            ("params", params, NUM_PARAM, f32),
            ("action_rows", action_rows, 2 * action_k, f32),
            ("step_count", step_count, 1, i32),
            ("timers", timers, cfg.n_push, i32),
            ("ep_return", ep_return, 1, f32), ("ep_len", ep_len, 1, i32)):
        check_rows(name, x, rows, b, device, dt)
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"the drift step runs on cpu or cuda, not {device}")


def _launch_step(name, cfg, ins, b, device):
    """Allocate the 7 outputs of a fused step and launch `csrc/<name>.cu` on
    the current stream; raises if the launch is refused."""
    f32, i32 = torch.float32, torch.int32
    outs = (torch.empty((NUM_STATE, b), dtype=f32, device=device),
            torch.empty((OBS_ROWS, b), dtype=f32, device=device),
            torch.empty((NUM_OUT, b), dtype=f32, device=device),
            torch.empty((1, b), dtype=i32, device=device),
            torch.empty((cfg.n_push, b), dtype=i32, device=device),
            torch.empty((1, b), dtype=f32, device=device),
            torch.empty((1, b), dtype=i32, device=device))
    launch = _kernel_fn(name, len(ins))
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = launch(cfg.c_struct, *(x.data_ptr() for x in ins + outs), b,
                     stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    return outs


def _plain_step(cfg, weights, poses, state, params, action_rows, uniforms,
                normals, step_count, timers, ep_return, ep_len):
    """`drift_step_rows` in the wrappers' layout."""
    nsr, obs, out, sc, tm, er, el = drift_step_rows(
        state, params, action_rows[0], action_rows[1], uniforms, normals,
        weights, poses, step_count[0], timers, ep_return[0], ep_len[0],
        cfg=cfg)
    return nsr, obs, out, sc[None], tm, er[None], el[None]


def fused_drift_step(weights, poses, state, params, action_rows, uniforms,
                     normals, step_count, timers, ep_return, ep_len,
                     cfg: FusedDriftConsts):
    """One fused control step: (NUM_STATE, B) in -> everything out — the
    counterpart of the reference `fused_drift_pallas`.

    weights (7,) f32; poses (N, 4) f32; state (21, B), params (46, B),
    action_rows (2, B), uniforms (12, B), normals (14, B), ep_return (1, B)
    f32; step_count (1, B), timers (n_push, B), ep_len (1, B) int32.

    Returns (state (21, B), obs (14, B), out (15, B), step_count (1, B),
    timers (n_push, B), ep_return (1, B), ep_len (1, B)). CPU tensors run
    `drift_step_rows`; CUDA tensors launch the kernel, asynchronously on the
    current stream."""
    global LAUNCHES
    device, b = state.device, state.shape[-1]
    check_step_inputs(cfg, weights, poses, state, params, action_rows,
                      step_count, timers, ep_return, ep_len)
    check_rows("uniforms", uniforms, NUM_UNIFORM, b, device)
    check_rows("normals", normals, OBS_ROWS, b, device)
    if device.type == "cpu":
        return _plain_step(cfg, weights, poses, state, params, action_rows,
                           uniforms, normals, step_count, timers, ep_return,
                           ep_len)
    outs = _launch_step(
        "fused_drift", cfg,
        (weights, poses, state, params, action_rows, uniforms, normals,
         step_count, timers, ep_return, ep_len), b, device)
    LAUNCHES += 1
    return outs


def fused_drift_step_krng(weights, poses, state, params, action_rows, seed,
                          step_count, timers, ep_return, ep_len,
                          cfg: FusedDriftConsts):
    """`fused_drift_step` with the random rows drawn from `seed`, a (1,)
    int32 tensor on the state's device — the counterpart of the reference
    `fused_drift_pallas_krng`. The rows are those of `ops/kernel_rng.py::
    philox_blocks(seed, B, cfg.enable_corruption)`. CPU tensors compute them
    and run `drift_step_rows`; CUDA tensors launch the kernel of
    `csrc/fused_drift_krng.cu`, which reads the seed through its pointer (no
    host read) and draws the rows in registers."""
    global LAUNCHES_KRNG
    device, b = state.device, state.shape[-1]
    check_step_inputs(cfg, weights, poses, state, params, action_rows,
                      step_count, timers, ep_return, ep_len)
    check_seed(seed)
    if seed.device != device:
        raise ValueError(f"seed is on {seed.device}, expected {device}")
    if device.type == "cpu":
        uniforms, normals = philox_blocks(seed, b, cfg.enable_corruption)
        return _plain_step(cfg, weights, poses, state, params, action_rows,
                           uniforms, normals, step_count, timers, ep_return,
                           ep_len)
    outs = _launch_step(
        "fused_drift_krng", cfg,
        (weights, poses, state, params, action_rows, seed, step_count,
         timers, ep_return, ep_len), b, device)
    LAUNCHES_KRNG += 1
    return outs


def make_fused_drift_step(task_cfg, env_cfg, ref_poses):
    """Build the fused step closure stored on TaskModel.fused_step.

    Returns fused_step(env, state: EnvState, action (B, 2)) -> (EnvState,
    StepOutput), with the reference's semantics and info keys."""
    from ...envs.env import EnvState, StepOutput

    cfg = FusedDriftConsts(task_cfg, env_cfg)
    poses_cpu = torch.as_tensor(np.asarray(ref_poses, np.float32))
    poses_on = {}
    # Opt-in, read once: the step draws its random rows in the kernel from
    # one seed per step (`fused_drift_step_krng`). The reference ignores the
    # variable where its kernel cannot run (the CPU); the port honours it on
    # both devices, CPU tensors taking the plain version.
    kernel_rng = os.environ.get("WHEELEDLAB_KERNEL_RNG") == "1"

    def fused_step(env, state, action):
        n = env.num_envs
        dev = env.device
        if dev not in poses_on:
            poses_on[dev] = poses_cpu.to(dev)
        if kernel_rng:
            # one draw of the env's generator per step, so a checkpoint's
            # generator state resumes a run exactly
            with span("drift.draw"):
                seed = torch.randint(0, 2**31 - 1, (1,), dtype=torch.int32,
                                     generator=env.generator, device=dev)
                # the env of rank r of a job of several ranks offsets the
                # seed by r * 0x3779B1 (int32 wrap), so no two ranks share
                # a Philox stream even with equal generators (reference
                # fused.py:600-604). The K1 route draws from the rank's own
                # generator and needs nothing.
                if env.shard:
                    seed = seed + int32_shard_offset(env.shard)
            with span("drift.launch"):
                res = fused_drift_step_krng(
                    state.reward_weights, poses_on[dev], state.vehicle_mem,
                    state.packed_params, action.T.contiguous(), seed,
                    state.step_count[None], state.push_timers,
                    state.ep_return[None], state.ep_len[None], cfg)
        else:
            with span("drift.draw"):
                uniforms = torch.rand((NUM_UNIFORM, n),
                                      generator=env.generator, device=dev)
                normals = (torch.randn((OBS_ROWS, n),
                                       generator=env.generator, device=dev)
                           if cfg.enable_corruption
                           else torch.zeros((OBS_ROWS, n), device=dev))
            with span("drift.launch"):
                res = fused_drift_step(
                    state.reward_weights, poses_on[dev], state.vehicle_mem,
                    state.packed_params, action.T.contiguous(), uniforms,
                    normals, state.step_count[None], state.push_timers,
                    state.ep_return[None], state.ep_len[None], cfg)
        with span("drift.outputs"):
            packed, obs_rows, out, step_count, timers, ep_return, ep_len = res

            obs = obs_rows.T
            reward = out[O_REWARD]
            done = out[O_DONE] > 0.5
            time_out = out[O_TIMEOUT] > 0.5
            common_step = state.common_step + 1
            info = {
                "episode_return": out[O_EPRET],
                "episode_length": out[O_EPLEN],
            }
            for i, name in enumerate(REWARD_NAMES):
                info[f"rew/{name}"] = out[O_TERMS + i]
            info["done/out_of_bounds"] = out[O_OOB] > 0.5
            info["done/time_out"] = time_out
            info["metrics/slip_deg"] = out[O_SLIP_DEG]
            info["metrics/speed"] = out[O_SPEED]

            new_state = EnvState(
                vehicle_mem=packed, packed_params=state.packed_params,
                step_count=step_count[0], common_step=common_step,
                reward_weights=env._curriculum_weights(state.reward_weights,
                                                       common_step),
                last_action=torch.where(done[:, None], 0.0, action),
                command=state.command, command_timer=state.command_timer,
                push_timers=timers, ep_return=ep_return[0], ep_len=ep_len[0])
            return new_state, StepOutput(obs=obs, reward=reward, done=done,
                                         time_out=time_out, info=info)

    return fused_step
