"""Env wrappers — the port of `wheeledlab_tpu/envs/wrappers.py` (reference
ClipAction: wheeledlab_rl/utils/clip_action.py:5-26; the gymnasium-style
vector adapter).

The core env is already batched and functional, so `ClipActionEnv` is a
function composition, and `GymVecEnv` is a thin stateful shell for parity
tests and external tooling, not the hot path: it copies every step's outputs
to the host."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .env import StepOutput, WheeledEnv


class ClipActionEnv:
    """Clips incoming actions to [low, high] before the env sees them
    (reference clip_action.py clips to the action-space bounds)."""

    def __init__(self, env: WheeledEnv, low: float = -1.0, high: float = 1.0):
        self.env = env
        self.low, self.high = low, high
        self.device = env.device
        self.num_envs = env.num_envs
        self.obs_dim = env.obs_dim
        self.action_dim = env.action_dim
        self.max_episode_length = env.max_episode_length

    def reset(self):
        return self.env.reset()

    def step(self, state, action) -> Tuple[object, StepOutput]:
        return self.env.step(state, torch.clamp(action, self.low, self.high))


class GymVecEnv:
    """Stateful gymnasium-style vector adapter over the functional env:
    `reset(seed) -> (obs, info)`, `step(actions) -> (obs, rew, terminated,
    truncated, info)`, all numpy. Auto-reset semantics are the functional
    core's (observations are returned post-reset)."""

    def __init__(self, env: WheeledEnv, seed: int = 0):
        self.env = env
        self.num_envs = env.num_envs
        self._state = None
        self._seed = seed

    def reset(self, seed: Optional[int] = None):
        self.env.generator.manual_seed(self._seed if seed is None else seed)
        self._state, obs = self.env.reset()
        return obs.cpu().numpy(), {}

    @torch.no_grad()
    def step(self, actions):
        action = torch.as_tensor(np.asarray(actions), dtype=torch.float32,
                                 device=self.env.device)
        self._state, out = self.env.step(self._state, action)
        done, time_out = out.done.cpu().numpy(), out.time_out.cpu().numpy()
        return (out.obs.cpu().numpy(), out.reward.cpu().numpy(),
                done & ~time_out, time_out,
                {k: v.cpu().numpy() for k, v in out.info.items()})

    @property
    def single_action_space_shape(self):
        return (self.env.action_dim,)

    @property
    def single_observation_space_shape(self):
        return (self.env.obs_dim,)
