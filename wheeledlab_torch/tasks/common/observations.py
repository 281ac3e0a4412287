"""Shared observation terms — the port of
`wheeledlab_tpu/tasks/common/observations.py` (reference BlindObsCfg,
common/observations.py:19-56).

Obs layout (14-D): root_pos_w(3) | root_euler_xyz(3) | base_lin_vel(3) |
base_ang_vel(3) | last_action(2). Used at reset; the fused drift step builds
the same rows itself (with the approximate euler angles)."""

from __future__ import annotations

from typing import Optional

import torch

from ...sim.types import VehicleState
from ...utils import math as wmath

BLIND_OBS_DIM = 14
_NOISE_STD = (
    [0.1] * 3     # root_pos_w       (Gnoise std 0.1)
    + [0.1] * 3   # root_euler_xyz   (Gnoise std 0.1)
    + [0.5] * 3   # base_lin_vel     (Gnoise std 0.5)
    + [0.4] * 3   # base_ang_vel     (Gnoise std 0.4)
    + [0.0] * 2   # last_action      (clipped, no noise)
)


def blind_obs(vehicle: VehicleState, last_action: torch.Tensor,
              enable_corruption: bool,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """(B, 14) observation of a batched vehicle state; Gaussian noise from
    `generator` when `enable_corruption`."""
    euler = wmath.euler_xyz_from_quat(vehicle.quat)
    body_lin = wmath.quat_rotate_inverse(vehicle.quat, vehicle.lin_vel)
    body_ang = wmath.quat_rotate_inverse(vehicle.quat, vehicle.ang_vel)
    obs = torch.cat([
        vehicle.pos, euler, body_lin, body_ang,
        torch.clamp(last_action, -1.0, 1.0),
    ], dim=-1)
    if enable_corruption:
        noise = torch.randn(obs.shape, generator=generator,
                            device=obs.device)
        obs = obs + noise * obs.new_tensor(_NOISE_STD)
    return obs
