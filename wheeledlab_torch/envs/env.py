"""The env runtime — the port of `wheeledlab_tpu/envs/env.py` for the drift
slice.

`WheeledEnv.reset` builds the packed (rows, B) carry and `WheeledEnv.step`
dispatches to the task's fused step (one kernel per control step on CUDA).
Manager ordering mirrors the reference: rewards and terminations on the
post-physics state before reset, observations after reset, reward terms
scaled by `weight * step_dt`.

The generic manager step (reference env.py:289-441) is not ported yet: a
task without a fused step (the play variants) raises in `step`.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..sim.actions import ActionMapCfg
from ..sim.soa import pack_params, pack_state, unpack_state
from ..sim.types import VehicleParams, VehicleState
from ..utils.config import configclass
from ..utils.device import resolve_device


@configclass
class EnvCfg:
    """Static env-level config (ManagerBasedRLEnvCfg fields used by the
    reference, e.g. mushr_drift_env_cfg.py:369-404)."""

    num_envs: int = 1024
    sim_dt: float = 0.005
    decimation: int = 4
    episode_length_s: float = 5.0
    action: ActionMapCfg = ActionMapCfg()
    enable_corruption: bool = True  # observation noise on/off (play: off)
    events_enabled: bool = True     # DR + pushes on/off (play variants)

    @property
    def step_dt(self) -> float:
        return self.sim_dt * self.decimation

    @property
    def max_episode_length(self) -> int:
        return int(round(self.episode_length_s / self.step_dt))


class RewardTerm(NamedTuple):
    name: str
    weight: float                  # initial weight (curriculum may change it)


class CurriculumTerm(NamedTuple):
    """Parity: increase_reward_weight_over_time
    (reference wheeledlab/envs/mdp/curriculums.py:10-35)."""

    reward_term_name: str
    increase: float
    episodes_per_increase: int
    max_increases: int


class PushEvent(NamedTuple):
    """Interval push event (reference mushr_drift_env_cfg.py:121-143)."""

    interval_range_s: Tuple[float, float]
    lin_x: Tuple[float, float] = (0.0, 0.0)
    lin_y: Tuple[float, float] = (0.0, 0.0)
    yaw: Tuple[float, float] = (0.0, 0.0)


class TaskModel(NamedTuple):
    """A task = functions + constants (the drift slice's subset of the
    reference TaskModel)."""

    cfg: EnvCfg
    obs_dim: int
    ground_friction: float
    init_params: Callable[[torch.Generator, int, torch.device], VehicleParams]
    sample_spawn: Callable[[torch.Generator, int, torch.device], VehicleState]
    reward_terms: Tuple[RewardTerm, ...]
    observe: Callable[[VehicleState, torch.Tensor, torch.Generator],
                      torch.Tensor]   # reset obs (vehicle, last_action, rng)
    curriculum: Tuple[CurriculumTerm, ...] = ()
    pushes: Tuple[PushEvent, ...] = ()
    fused_step: Optional[Callable] = None


@dataclasses.dataclass
class EnvState:
    vehicle_mem: torch.Tensor      # (NUM_STATE, B) packed vehicle rows
    packed_params: torch.Tensor    # (NUM_PARAM, B) DR'd params, packed once
                                   # at reset (startup DR only)
    step_count: torch.Tensor       # [B] int32
    common_step: int               # global step counter, kept on the host
    reward_weights: torch.Tensor   # [n_terms] f32 — curriculum state
    last_action: torch.Tensor      # [B, 2]
    push_timers: torch.Tensor      # [n_push, B] int32
    ep_return: torch.Tensor        # [B]
    ep_len: torch.Tensor           # [B] int32

    @property
    def vehicle(self) -> VehicleState:
        """AoS view of the packed vehicle rows."""
        return unpack_state(self.vehicle_mem)


class StepOutput(NamedTuple):
    obs: torch.Tensor
    reward: torch.Tensor
    done: torch.Tensor            # terminated | time_out
    time_out: torch.Tensor        # for rsl_rl-style bootstrap
    info: Dict[str, torch.Tensor]


class WheeledEnv:
    """`reset() -> (state, obs)`, `step(state, action) -> (state,
    StepOutput)`. Batched over `cfg.num_envs` on `device`; every random
    draw comes from `self.generator`."""

    def __init__(self, task: TaskModel, device="cuda", seed: int = 0):
        self.task = task
        self.cfg = task.cfg
        self.device = resolve_device(device)
        self.num_envs = task.cfg.num_envs
        self.obs_dim = task.obs_dim
        self.action_dim = 2
        self.max_episode_length = task.cfg.max_episode_length
        self._reward_names = [t.name for t in task.reward_terms]
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self._weights_cache: Dict[Tuple[float, ...], torch.Tensor] = {}

    # ------------------------------------------------------------------ reset

    def reset(self) -> Tuple[EnvState, torch.Tensor]:
        task, g, dev = self.task, self.generator, self.device
        n = self.num_envs
        params = task.init_params(g, n, dev)
        vehicle = task.sample_spawn(g, n, dev)
        push_timers = self._init_push_timers(n)
        state = EnvState(
            vehicle_mem=pack_state(vehicle),
            packed_params=pack_params(params, task.ground_friction),
            step_count=torch.zeros((n,), dtype=torch.int32, device=dev),
            common_step=0,
            reward_weights=self._weights_tensor(
                tuple(float(t.weight) for t in task.reward_terms)),
            last_action=torch.zeros((n, 2), device=dev),
            push_timers=push_timers,
            ep_return=torch.zeros((n,), device=dev),
            ep_len=torch.zeros((n,), dtype=torch.int32, device=dev),
        )
        obs = task.observe(vehicle, state.last_action, g)
        return state, obs

    # ------------------------------------------------------------------- step

    def step(self, state: EnvState,
             action: torch.Tensor) -> Tuple[EnvState, StepOutput]:
        if self.task.fused_step is None:
            raise NotImplementedError(
                "this task has no fused step, and the generic manager step "
                "is not ported yet")
        return self.task.fused_step(self, state, action)

    # ---------------------------------------------------------------- helpers

    def _weights_tensor(self, weights: Tuple[float, ...]) -> torch.Tensor:
        """Device tensor of the given weights, made once per distinct value
        (they change a few times per run), so a step copies nothing from
        the host."""
        if weights not in self._weights_cache:
            self._weights_cache[weights] = torch.tensor(
                weights, dtype=torch.float32, device=self.device)
        return self._weights_cache[weights]

    def _curriculum_weights(self, weights: torch.Tensor,
                            common_step: int) -> torch.Tensor:
        """Weights in closed form of the host step counter — exact closed
        form of the reference's mutation loop (which fires at the start of
        every `episodes_per`-th episode, "discounting the first episode", and
        performs up to `max_increases + 1` increases):
        n_inc(e) = min((e + 1) // episodes_per, max_increases + 1)."""
        task = self.task
        if not task.curriculum:
            return weights
        episodes = common_step // self.max_episode_length
        new = [float(t.weight) for t in task.reward_terms]
        for cur in task.curriculum:
            idx = self._reward_names.index(cur.reward_term_name)
            n_inc = min((episodes + 1) // cur.episodes_per_increase,
                        cur.max_increases + 1)
            # float32 arithmetic, as the reference's traced update
            new[idx] = float(np.float32(task.reward_terms[idx].weight)
                             + np.float32(cur.increase) * np.float32(n_inc))
        return self._weights_tensor(tuple(new))

    def _init_push_timers(self, n: int) -> torch.Tensor:
        pushes = self.task.pushes
        if not pushes or not self.cfg.events_enabled:
            return torch.zeros((max(len(pushes), 1), n), dtype=torch.int32,
                               device=self.device)
        return torch.stack([self._sample_interval(p, n) for p in pushes])

    def _sample_interval(self, push: PushEvent, n: int) -> torch.Tensor:
        lo = max(int(round(push.interval_range_s[0] / self.cfg.step_dt)), 1)
        hi = max(int(round(push.interval_range_s[1] / self.cfg.step_dt)),
                 lo + 1)
        return torch.randint(lo, hi, (n,), generator=self.generator,
                             device=self.device, dtype=torch.int32)
