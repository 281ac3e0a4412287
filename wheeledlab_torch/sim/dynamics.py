"""Per-vehicle wheeled-vehicle dynamics — the port of
`wheeledlab_tpu/sim/dynamics.py`.

Model: one rigid chassis; four wheels on stiff spring-damper contacts (the
suspension); servo steering with an implicit PD and an effort clamp; DC-motor
wheel drives with the saturation-curve torque clip; a combined-slip
Pacejka-lite tire whose saturating lateral force makes drifting possible.
Semi-implicit Euler at the physics rate, the stiff couplings integrated with
one-step implicit linearizations.

This is the per-vehicle ("array of structures") formulation: each field of
`VehicleState` and `VehicleParams` keeps its own tensor, batched over a
leading env axis (the reference writes one vehicle and `vmap`s it). It is
the physics of `EnvCfg.use_kernels="off"` and of a heightfield task without
a patch atlas (`envs/env.py`); it runs in plain PyTorch on the env's device.
The packed-row formulations (`sim/soa.py`, `sim/soa_hf.py`) and their
kernels K2 and K3 compute the same model, and this one rounds as they do:
where the reference's per-vehicle and packed-row versions associate a sum
differently (the wheel position, the contact-point velocity, the terrain
normal scaled by 1 / its norm), this module takes the packed-row order, so
that it and K2/K3 agree bit for bit on the same inputs. Elsewhere the
operation order follows the reference line for line. Over ten stiff
substeps on a heightfield, the reference's own orders put 2 % of the envs
beyond 1e-4 + 1e-4 |x| of each other: the suspension force is a
difference of a spring and a damper term of some 50 N each, which turns an
ulp of a wheel height or of the normal into a force change that the next
substeps amplify. Divisions by `dt` and by the grid cell go through
`utils.math.div`, so that on the card they divide as the CPU does.
"""

from __future__ import annotations

from typing import NamedTuple, Union

import torch

from ..utils import math as wmath
from ..utils.math import div
from .soa import atan_approx
from .terrain import Heightfield, TerrainPatch
from .types import VehicleParams, VehicleState


class ContactAux(NamedTuple):
    """Per-substep diagnostics, per wheel: (B, 4) each."""

    normal_force: torch.Tensor
    long_force: torch.Tensor
    lat_force: torch.Tensor
    contact: torch.Tensor        # bool


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis (3) in index order."""
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]
            + a[..., 2] * b[..., 2])


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a0, a1, a2 = a.unbind(-1)
    b0, b1, b2 = b.unbind(-1)
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], dim=-1)


def _rotate(rot: torch.Tensor, v: torch.Tensor,
            origin=None) -> torch.Tensor:
    """rot (B, 3, 3) applied to v (B, W, 3) (the reference's
    einsum("ab,wb->wa")), added to `origin` term by term."""
    r = rot[:, None]
    out = r[..., 0] * v[..., 0:1]
    if origin is not None:
        out = origin + out
    return out + r[..., 1] * v[..., 1:2] + r[..., 2] * v[..., 2:3]


def _matvec(rot: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """rot @ x for rot (B, 3, 3), x (B, 3)."""
    return (rot[..., 0] * x[:, 0:1] + rot[..., 1] * x[:, 1:2]
            + rot[..., 2] * x[:, 2:3])


def _matvec_t(rot: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """rot.T @ x for rot (B, 3, 3), x (B, 3)."""
    return (rot[:, 0] * x[:, 0:1] + rot[:, 1] * x[:, 1:2]
            + rot[:, 2] * x[:, 2:3])


def _steering_update(state: VehicleState, params: VehicleParams,
                     steer_targets: torch.Tensor, dt: float):
    """Implicit PD servo with effort, velocity and angle limits (PhysX's
    implicit joint drive with the reference's steering gains)."""
    inertia = params.steer_inertia[:, None]
    kp, kd = params.steer_kp[:, None], params.steer_kd[:, None]
    theta, omega = state.steer_pos, state.steer_vel
    denom = 1.0 + dt * kd / inertia + dt * dt * kp / inertia
    omega_impl = (omega + dt * (kp / inertia)
                  * (steer_targets - theta)) / denom
    torque = div(inertia * (omega_impl - omega), dt)
    lim = params.steer_effort_limit[:, None]
    torque = torch.clamp(torque, -lim, lim)
    omega_new = omega + dt * torque / inertia
    vlim = params.steer_vel_limit[:, None]
    omega_new = torch.clamp(omega_new, -vlim, vlim)
    theta_new = theta + dt * omega_new
    tlim = params.steer_limit[:, None]
    theta_clamped = torch.clamp(theta_new, -tlim, tlim)
    omega_new = torch.where(theta_new == theta_clamped, omega_new,
                            div(theta_clamped - theta, dt))
    return theta_clamped, omega_new


def _motor_torque(params: VehicleParams, wheel_omega: torch.Tensor,
                  wheel_targets: torch.Tensor, dt: float) -> torch.Tensor:
    """DC-motor velocity drive, integrated implicitly, then clipped by the
    motor saturation curve (the torque limit shrinks linearly with speed)."""
    inertia = params.wheel_inertia[:, None]
    alpha = dt * params.motor_damping / inertia
    omega_impl = (wheel_omega + alpha * wheel_targets) / (1.0 + alpha)
    torque = div(inertia * (omega_impl - wheel_omega), dt)
    sat = params.motor_sat_effort[:, None]
    vlim = params.motor_vel_limit[:, None]
    elim = params.motor_effort_limit[:, None]
    tau_max = torch.minimum(
        torch.clamp(sat * (1.0 - wheel_omega / vlim), min=0.0), elim)
    tau_min = torch.minimum(
        torch.maximum(sat * (-1.0 - wheel_omega / vlim), -elim),
        torch.zeros_like(wheel_omega))
    torque = torch.minimum(torch.maximum(torque, tau_min), tau_max)
    return torque * params.drive_mask


def _tire_forces(v_long: torch.Tensor, v_lat: torch.Tensor,
                 wheel_omega: torch.Tensor, fz: torch.Tensor,
                 mu: torch.Tensor, params: VehicleParams):
    """Combined-slip Pacejka-lite: F = mu Fz sin(C atan(B s)) along the slip
    direction. Returns (fx, fy, dfx_domega): the last bounds |d fx / d
    wheel_omega| for the implicit wheel-spin update."""
    r = params.wheel_radius[:, None]
    b, c = params.tire_stiffness[:, None], params.tire_shape[:, None]
    denom = torch.clamp(torch.abs(v_long), min=0.6)
    sx = (wheel_omega * r - v_long) / denom
    sy = -v_lat / denom
    s = torch.sqrt(sx * sx + sy * sy + 1e-9)
    f_norm = torch.sin(c * atan_approx(b * s))
    scale = mu * fz * f_norm / s
    fx = scale * sx
    fy = scale * sy
    dfx_domega = mu * fz * b * c * r / denom     # small-slip stiffness bound
    return fx, fy, dfx_domega


Terrain = Union[Heightfield, TerrainPatch]


def substep(state: VehicleState, params: VehicleParams, terrain: Terrain,
            steer_targets: torch.Tensor, wheel_targets: torch.Tensor,
            dt: float):
    """One physics substep of every vehicle. state, params: batched over B;
    steer_targets (B, 2); wheel_targets (B, 4) -> (new state, ContactAux)."""
    rot = wmath.matrix_from_quat(state.quat)            # (B, 3, 3) body->world
    radius = params.wheel_radius[:, None]              # (B, 1)

    # --- steering servo ---
    steer_pos, steer_vel = _steering_update(state, params, steer_targets, dt)

    # --- wheel kinematics ---
    pos = state.pos[:, None, :]
    wheel_world = _rotate(rot, params.wheel_pos_b, pos)         # (B, 4, 3)
    contact_pts = torch.cat([wheel_world[..., :2],
                             wheel_world[..., 2:] - radius[..., None]], -1)

    ground_h, normals = terrain.lookup_and_normal(wheel_world[..., :2])
    penetration = ground_h + radius - wheel_world[..., 2]
    in_contact = penetration > 0.0

    # contact-point velocity (world): v + omega x arm
    arm = contact_pts - pos
    ax, ay, az = arm.unbind(-1)
    (vx, vy, vz), (wx, wy, wz) = (v[:, None].unbind(-1) for v in (
        state.lin_vel, state.ang_vel))
    v_contact = torch.stack([vx + wy * az - wz * ay, vy + wz * ax - wx * az,
                             vz + wx * ay - wy * ax], -1)

    # --- normal (suspension) force: spring + damper + the suspension
    # joint's dry friction, tanh-smoothed ---
    pen_rate = -_dot(v_contact, normals)
    fz = (params.susp_stiffness[:, None] * penetration
          + params.susp_damping[:, None] * pen_rate
          + params.susp_friction[:, None] * torch.tanh(pen_rate * 20.0))
    fz = torch.where(in_contact, torch.clamp(fz, min=0.0), 0.0)

    # --- tire frame: heading of each wheel projected on the contact plane;
    # wheels [back_left, back_right, front_left, front_right] ---
    steer_angles = torch.cat([torch.zeros_like(steer_pos), steer_pos], -1)
    cos_d, sin_d = torch.cos(steer_angles), torch.sin(steer_angles)
    heading_b = torch.stack([cos_d, sin_d, torch.zeros_like(cos_d)], -1)
    heading_w = _rotate(rot, heading_b)
    t_long = heading_w - _dot(heading_w, normals)[..., None] * normals
    t_long = t_long / torch.clamp(
        torch.sqrt(_dot(t_long, t_long))[..., None], min=1e-6)
    t_lat = _cross(normals, t_long)

    v_long = _dot(v_contact, t_long)
    v_lat = _dot(v_contact, t_lat)

    # --- tire forces ---
    mu = params.tire_mu * terrain.friction
    fx, fy, dfx_domega = _tire_forces(
        v_long, v_lat, state.wheel_omega, fz, mu, params)

    # --- wheel spin integration (motor + slip reaction, implicit) ---
    tau_motor = _motor_torque(params, state.wheel_omega, wheel_targets, dt)
    tau_slip = -fx * radius
    tau_roll = -params.rolling_resistance[:, None] * state.wheel_omega
    inertia_w = params.wheel_inertia[:, None]
    impl_denom = 1.0 + dt * dfx_domega * radius / inertia_w
    wheel_omega = state.wheel_omega + dt * (
        tau_motor + tau_slip + tau_roll) / inertia_w / impl_denom

    # --- chassis forces / torques, the wheels added in order ---
    f_wheels = (fz[..., None] * normals + fx[..., None] * t_long
                + fy[..., None] * t_lat)                     # (B, 4, 3)
    tau_wheels = _cross(arm, f_wheels)
    f_sum = f_wheels[:, 0] + f_wheels[:, 1] + f_wheels[:, 2] + f_wheels[:, 3]
    f_total = torch.cat([f_sum[:, :2], f_sum[:, 2:] - (
        params.mass * params.gravity)[:, None]], -1)
    tau_total = (tau_wheels[:, 0] + tau_wheels[:, 1] + tau_wheels[:, 2]
                 + tau_wheels[:, 3])

    mass = params.mass[:, None]
    lin_vel = state.lin_vel + dt * f_total / mass

    # angular update in the body frame (diagonal inertia)
    omega_b = _matvec_t(rot, state.ang_vel)
    tau_b = _matvec_t(rot, tau_total)
    inertia = params.inertia
    omega_b = omega_b + dt * (
        tau_b - _cross(omega_b, inertia * omega_b)) / inertia
    ang_vel = _matvec(rot, omega_b)

    new_state = VehicleState(
        pos=state.pos + dt * lin_vel,
        quat=wmath.quat_integrate(state.quat, ang_vel, dt),
        lin_vel=lin_vel, ang_vel=ang_vel, wheel_omega=wheel_omega,
        steer_pos=steer_pos, steer_vel=steer_vel)
    aux = ContactAux(normal_force=fz, long_force=fx, lat_force=fy,
                     contact=in_contact)
    return new_state, aux


def step(state: VehicleState, params: VehicleParams, terrain: Heightfield,
         steer_targets: torch.Tensor, wheel_targets: torch.Tensor,
         dt: float, decimation: int, atlas=None):
    """`decimation` substeps with held joint targets (the decimation loop of
    ManagerBasedRLEnv.step). With an `atlas` (PatchAtlas) and a heightfield,
    each env's (p, p) window is extracted once per control step and every
    substep's wheel contact reads it (`TerrainPatch`); without one the
    substeps read the full grid. Returns (state, the last substep's
    ContactAux)."""
    local = terrain
    if atlas is not None and not terrain.is_flat:
        local = atlas.extract(state.pos[:, :2])
    aux = None
    for _ in range(decimation):
        state, aux = substep(state, params, local, steer_targets,
                             wheel_targets, dt)
    return state, aux
