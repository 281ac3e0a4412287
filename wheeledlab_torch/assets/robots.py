"""Robot asset configs — the port of `wheeledlab_tpu/assets/robots.py`.

Actuator constants from reference hound.py:4-52 and f1tenth.py:9-27;
geometry from common/actions.py:17-69."""

from __future__ import annotations

import torch

from ..sim.actions import ActionMapCfg
from ..sim.types import (
    VehicleParams, default_f1tenth_params, default_mushr_params,
)
from ..utils.config import configclass


@configclass
class ActuatorGroupCfg:
    """Declarative actuator parameters (IsaacLab ImplicitActuatorCfg /
    DCMotorCfg as used in reference hound.py)."""

    steer_stiffness: float = 100.0
    steer_damping: float = 10.0
    steer_effort_limit: float = 3.2
    steer_velocity_limit: float = 10.0
    throttle_saturation_effort: float = 1.05
    throttle_effort_limit: float = 0.25
    throttle_velocity_limit: float = 450.0
    throttle_damping: float = 1000.0
    drive: str = "4wd"   # "4wd" | "2wd"


HOUND_ACTUATOR_CFG = ActuatorGroupCfg()
HOUND_SUS_ACTUATOR_CFG = ActuatorGroupCfg()
HOUND_SUS_2WD_ACTUATOR_CFG = ActuatorGroupCfg(
    throttle_effort_limit=0.5, drive="2wd")
F1TENTH_4WD_ACTUATOR_CFG = ActuatorGroupCfg(
    steer_stiffness=120.0, steer_damping=8.0, steer_effort_limit=2.5,
    throttle_saturation_effort=1.0, throttle_effort_limit=0.25,
    throttle_velocity_limit=400.0, throttle_damping=1100.0, drive="4wd")


def apply_actuators(params: VehicleParams,
                    act: ActuatorGroupCfg) -> VehicleParams:
    f32 = lambda x: torch.tensor(x, dtype=torch.float32)
    drive_mask = [1.0, 1.0, 0.0, 0.0] if act.drive == "2wd" else [1.0] * 4
    return params.replace(
        steer_kp=f32(act.steer_stiffness),
        steer_kd=f32(act.steer_damping),
        steer_effort_limit=f32(act.steer_effort_limit),
        steer_vel_limit=f32(act.steer_velocity_limit),
        motor_sat_effort=f32(act.throttle_saturation_effort),
        motor_effort_limit=f32(act.throttle_effort_limit),
        motor_vel_limit=f32(act.throttle_velocity_limit),
        motor_damping=f32([act.throttle_damping] * 4),
        drive_mask=f32(drive_mask),
    )


MUSHR_CFG = apply_actuators(default_mushr_params(), HOUND_ACTUATOR_CFG)
MUSHR_SUS_CFG = apply_actuators(default_mushr_params(),
                                HOUND_SUS_ACTUATOR_CFG)   # 4WD, elevation
MUSHR_SUS_2WD_CFG = apply_actuators(default_mushr_params(),
                                    HOUND_SUS_2WD_ACTUATOR_CFG)
F1TENTH_CFG = apply_actuators(default_f1tenth_params(),
                              F1TENTH_4WD_ACTUATOR_CFG)

# Action-map configs shared by tasks (reference common/actions.py)
MUSHR_RWD_ACTION = ActionMapCfg(
    drivetrain="rwd", scale=(3.0, 0.488), bounding_strategy="clip",
    no_reverse=True, base_length=0.325, base_width=0.2, wheel_radius=0.05)
MUSHR_4WD_ACTION = MUSHR_RWD_ACTION.replace(drivetrain="4wd")
F1TENTH_4WD_ACTION = ActionMapCfg(
    drivetrain="4wd", scale=(3.0, 0.488), bounding_strategy="clip",
    no_reverse=True, base_length=0.365, base_width=0.284, wheel_radius=0.05)
