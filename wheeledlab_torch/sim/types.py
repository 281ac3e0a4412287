"""Vehicle state / parameter containers — the port of
`wheeledlab_tpu/sim/types.py`.

A chassis rigid body + 4 spring-contact wheels + servo steering, stored as
dataclasses of tensors with a leading env axis when batched.

Wheel order everywhere: [back_left, back_right, front_left, front_right];
steering order [left, right]. Quaternions are (w, x, y, z); linear/angular
velocity are world-frame.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class VehicleState:
    pos: torch.Tensor          # (..., 3) world position of body origin
    quat: torch.Tensor         # (..., 4) world orientation (w,x,y,z)
    lin_vel: torch.Tensor      # (..., 3) world linear velocity
    ang_vel: torch.Tensor      # (..., 3) world angular velocity
    wheel_omega: torch.Tensor  # (..., 4) wheel spin rates (rad/s)
    steer_pos: torch.Tensor    # (..., 2) steering joint angles (rad)
    steer_vel: torch.Tensor    # (..., 2) steering joint rates (rad/s)

    @classmethod
    def zero(cls, batch: tuple = (), device="cpu") -> "VehicleState":
        f = lambda *s: torch.zeros(batch + s, dtype=torch.float32,
                                   device=device)
        quat = f(4)
        quat[..., 0] = 1.0
        return cls(pos=f(3), quat=quat, lin_vel=f(3), ang_vel=f(3),
                   wheel_omega=f(4), steer_pos=f(2), steer_vel=f(2))

    def replace(self, **kwargs) -> "VehicleState":
        return dataclasses.replace(self, **kwargs)


@dataclasses.dataclass
class VehicleParams:
    """Per-vehicle dynamics parameters; every field is a float32 tensor so
    that domain randomization is per-env state."""

    mass: torch.Tensor            # () kg
    inertia: torch.Tensor         # (3,) body-frame diagonal inertia
    com_height: torch.Tensor      # () body origin height above contact at rest
    gravity: torch.Tensor         # () m/s^2 (positive magnitude)
    wheel_pos_b: torch.Tensor     # (4, 3) wheel attachment points, body frame
    wheel_radius: torch.Tensor    # ()
    steer_kp: torch.Tensor
    steer_kd: torch.Tensor
    steer_effort_limit: torch.Tensor
    steer_vel_limit: torch.Tensor
    steer_inertia: torch.Tensor
    steer_limit: torch.Tensor
    motor_damping: torch.Tensor       # (4,)
    motor_sat_effort: torch.Tensor
    motor_effort_limit: torch.Tensor
    motor_vel_limit: torch.Tensor
    drive_mask: torch.Tensor          # (4,) 1.0 where motor-driven
    wheel_inertia: torch.Tensor
    tire_mu: torch.Tensor             # (4,)
    tire_stiffness: torch.Tensor      # Pacejka B
    tire_shape: torch.Tensor          # Pacejka C
    rolling_resistance: torch.Tensor
    susp_stiffness: torch.Tensor
    susp_damping: torch.Tensor
    susp_friction: torch.Tensor

    def replace(self, **kwargs) -> "VehicleParams":
        return dataclasses.replace(self, **kwargs)


def _f32(x) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def suspension_for_mass(mass, omega_n: float = 70.0, zeta: float = 0.8):
    """Per-wheel spring/damper tuned to the sprung mass: k = (m/4) w_n^2,
    d = 2 zeta (m/4) w_n."""
    quarter = mass / 4.0
    return quarter * omega_n**2, 2.0 * zeta * quarter * omega_n


def default_mushr_params() -> VehicleParams:
    """MuSHR-class RC car (wheelbase 0.325 m, track 0.2 m, wheel radius
    0.05 m; actuator constants of HOUND_SUS_2WD)."""
    L, W, r = 0.325, 0.2, 0.05
    m = 3.8
    lx, wy = L / 2.0, W / 2.0
    h = 0.06
    ixx = m / 12.0 * (W**2 + 0.01) * 3.0
    iyy = m / 12.0 * (L**2 + 0.01) * 3.0
    izz = m / 12.0 * (L**2 + W**2) * 1.5
    wheel_pos = [[-lx, +wy, -h + r], [-lx, -wy, -h + r],
                 [+lx, +wy, -h + r], [+lx, -wy, -h + r]]
    k, d = suspension_for_mass(m)
    return VehicleParams(
        mass=_f32(m), inertia=_f32([ixx, iyy, izz]), com_height=_f32(h),
        gravity=_f32(9.81), wheel_pos_b=_f32(wheel_pos), wheel_radius=_f32(r),
        steer_kp=_f32(100.0), steer_kd=_f32(10.0),
        steer_effort_limit=_f32(3.2), steer_vel_limit=_f32(10.0),
        steer_inertia=_f32(2e-3), steer_limit=_f32(0.55),
        motor_damping=_f32([1000.0] * 4), motor_sat_effort=_f32(1.05),
        motor_effort_limit=_f32(0.5), motor_vel_limit=_f32(450.0),
        drive_mask=_f32([1.0, 1.0, 0.0, 0.0]), wheel_inertia=_f32(2.5e-4),
        tire_mu=_f32([1.0] * 4), tire_stiffness=_f32(9.0),
        tire_shape=_f32(1.5), rolling_resistance=_f32(1e-4),
        susp_stiffness=_f32(k), susp_damping=_f32(d),
        susp_friction=_f32(0.5),
    )


def default_f1tenth_params() -> VehicleParams:
    """F1Tenth (wheelbase 0.365 m, track 0.284 m; 4WD actuators)."""
    p = default_mushr_params()
    L, W = 0.365, 0.284
    lx, wy = L / 2.0, W / 2.0
    m = 4.5
    h = 0.06
    r = 0.05
    wheel_pos = [[-lx, +wy, -h + r], [-lx, -wy, -h + r],
                 [+lx, +wy, -h + r], [+lx, -wy, -h + r]]
    k, d = suspension_for_mass(m)
    return p.replace(
        mass=_f32(m),
        inertia=_f32([m / 12 * (W**2 + 0.01) * 3.0,
                      m / 12 * (L**2 + 0.01) * 3.0,
                      m / 12 * (L**2 + W**2) * 1.5]),
        wheel_pos_b=_f32(wheel_pos),
        steer_kp=_f32(120.0), steer_kd=_f32(8.0),
        steer_effort_limit=_f32(2.5),
        motor_damping=_f32([1100.0] * 4), motor_sat_effort=_f32(1.0),
        motor_effort_limit=_f32(0.25), motor_vel_limit=_f32(400.0),
        drive_mask=_f32([1.0] * 4),
        susp_stiffness=_f32(k), susp_damping=_f32(d),
    )


def with_mass(params: VehicleParams, mass: torch.Tensor) -> VehicleParams:
    """Set (possibly batched) chassis mass, retuning suspension to match."""
    k, d = suspension_for_mass(mass)
    return params.replace(mass=mass.to(torch.float32), susp_stiffness=k,
                          susp_damping=d)


def batch_params(params: VehicleParams, num_envs: int,
                 device="cpu") -> VehicleParams:
    """Broadcast single-vehicle params to a batch (leading env axis)."""
    return dataclasses.replace(params, **{
        f.name: getattr(params, f.name).to(device).expand(
            (num_envs,) + tuple(getattr(params, f.name).shape)).contiguous()
        for f in dataclasses.fields(params)})
