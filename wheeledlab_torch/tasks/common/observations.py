"""Shared observation terms — the port of
`wheeledlab_tpu/tasks/common/observations.py` (reference BlindObsCfg,
common/observations.py:19-56).

Obs layout (14-D): root_pos_w(3) | root_euler_xyz(3) | base_lin_vel(3) |
base_ang_vel(3) | last_action(2). Used at reset and by the generic step;
the fused drift step builds the same rows itself (with the approximate
euler angles)."""

from __future__ import annotations

from typing import Optional

import torch

from ...envs.env import StepCtx
from ...utils import math as wmath

BLIND_OBS_DIM = 14
_NOISE_STD = (
    [0.1] * 3     # root_pos_w       (Gnoise std 0.1)
    + [0.1] * 3   # root_euler_xyz   (Gnoise std 0.1)
    + [0.5] * 3   # base_lin_vel     (Gnoise std 0.5)
    + [0.4] * 3   # base_ang_vel     (Gnoise std 0.4)
    + [0.0] * 2   # last_action      (clipped, no noise)
)
_noise_std_on = {}   # device -> (14,) tensor, made once: no copy per step


def blind_obs(ctx: StepCtx, generator: Optional[torch.Generator],
              enable_corruption: bool) -> torch.Tensor:
    """(B, 14) observation of a step context; Gaussian noise from
    `generator` when `enable_corruption`."""
    v = ctx.vehicle
    obs = torch.cat([
        v.pos, wmath.euler_xyz_from_quat(v.quat), ctx.body_lin_vel,
        ctx.body_ang_vel, torch.clamp(ctx.last_action, -1.0, 1.0),
    ], dim=-1)
    if enable_corruption:
        noise = torch.randn(obs.shape, generator=generator,
                            device=obs.device)
        if obs.device not in _noise_std_on:
            _noise_std_on[obs.device] = obs.new_tensor(_NOISE_STD)
        obs = obs + noise * _noise_std_on[obs.device]
    return obs
