"""Drivetrain action maps: policy [throttle, steer] -> joint targets — the
port of `wheeledlab_tpu/sim/actions.py` (reference ackermann_actions.py:
119-200 and rc_car_actions.py:6-64).

Wheel-target order: [back_left, back_right, front_left, front_right];
steer order [left, right]. Undriven wheels get target 0 and are masked by
`drive_mask` downstream. A tensor is divided by a constant through
`utils/math.py::div`, so that CUDA divides as the CPU and JAX do.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..utils.config import configclass
from ..utils.math import div


@configclass
class ActionMapCfg:
    """Parity with AckermannActionCfg (reference actions_cfg.py:14-67)."""

    drivetrain: str = "rwd"                 # "ackermann" | "rwd" | "4wd"
    scale: Tuple[float, float] = (3.0, 0.488)
    offset: Tuple[float, float] = (0.0, 0.0)
    bounding_strategy: Optional[str] = "clip"   # "clip" | "tanh" | None
    no_reverse: bool = True
    base_length: float = 0.325
    base_width: float = 0.2
    wheel_radius: float = 0.05


def process_actions(raw: torch.Tensor, cfg: ActionMapCfg) -> torch.Tensor:
    """Bound + scale + offset + no-reverse clamp
    (ackermann_actions.py:119-133)."""
    scale = raw.new_tensor(cfg.scale)
    offset = raw.new_tensor(cfg.offset)
    if cfg.bounding_strategy == "clip":
        out = torch.clamp(raw, -1.0, 1.0) * scale + offset
    elif cfg.bounding_strategy == "tanh":
        out = torch.tanh(raw) * scale + offset
    else:
        out = raw * scale + offset
    if cfg.no_reverse:
        out = torch.cat([torch.clamp(out[..., :1], min=0.0), out[..., 1:]],
                        dim=-1)
    return out


def _ackermann_geometry(v, steer, cfg: ActionMapCfg):
    """Shared turn-radius terms (ackermann_actions.py:179-196)."""
    L, W, r = cfg.base_length, cfg.base_width, cfg.wheel_radius
    tan_steering = torch.tan(steer)
    R = torch.where(tan_steering == 0.0, 1e6,
                    torch.full_like(tan_steering, L) / tan_steering)
    r_rear_left = torch.sqrt((R - W / 2) ** 2 + L**2)
    r_rear_right = torch.sqrt((R + W / 2) ** 2 + L**2)
    v_front_left = v * torch.abs(r_rear_left / (R * r))
    v_front_right = v * torch.abs(r_rear_right / (R * r))
    v_back_left = v * torch.abs((R - W / 2) / (R * r))
    v_back_right = v * torch.abs((R + W / 2) / (R * r))
    return (R, tan_steering, v_back_left, v_back_right, v_front_left,
            v_front_right)


def ackermann_map(processed: torch.Tensor, cfg: ActionMapCfg):
    """Full Ackermann steering geometry (ackermann_actions.py:150-200)."""
    v, steer = processed[..., 0], processed[..., 1]
    L, W = cfg.base_length, cfg.base_width
    R, _, vbl, vbr, vfl, vfr = _ackermann_geometry(v, steer, cfg)
    delta_left = torch.atan(torch.full_like(R, L) / (R - W / 2))
    delta_right = torch.atan(torch.full_like(R, L) / (R + W / 2))
    steer_targets = torch.stack([delta_left, delta_right], dim=-1)
    wheel_targets = torch.stack([vbl, vbr, vfl, vfr], dim=-1)
    return steer_targets, wheel_targets


def rwd_map(processed: torch.Tensor, cfg: ActionMapCfg):
    """MuSHR RWD: tan steering + uniform rear throttle
    (rc_car_actions.py:12-29)."""
    v, steer = processed[..., 0], processed[..., 1]
    tan_steering = torch.tan(steer)
    target_ang_vel = div(v, cfg.wheel_radius)
    steer_targets = torch.stack([tan_steering, tan_steering], dim=-1)
    zeros = torch.zeros_like(target_ang_vel)
    wheel_targets = torch.stack(
        [target_ang_vel, target_ang_vel, zeros, zeros], dim=-1)
    return steer_targets, wheel_targets


def four_wd_map(processed: torch.Tensor, cfg: ActionMapCfg):
    """4WD: tan steering + open-diff Ackermann-adjusted throttle
    (rc_car_actions.py:33-64)."""
    v, steer = processed[..., 0], processed[..., 1]
    _, tan_steering, vbl, vbr, vfl, vfr = _ackermann_geometry(v, steer, cfg)
    steer_targets = torch.stack([tan_steering, tan_steering], dim=-1)
    wheel_targets = torch.stack([vbl, vbr, vfl, vfr], dim=-1)
    return steer_targets, wheel_targets


_MAPS = {"ackermann": ackermann_map, "rwd": rwd_map, "4wd": four_wd_map}


def action_to_targets(raw: torch.Tensor, cfg: ActionMapCfg):
    """raw policy action (..., 2) -> (steer_targets (..., 2),
    wheel_targets (..., 4))."""
    return _MAPS[cfg.drivetrain](process_actions(raw, cfg), cfg)
