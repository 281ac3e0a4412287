"""The env runtime — the port of `wheeledlab_tpu/envs/env.py`.

`WheeledEnv.reset` builds the vehicle carry: packed (rows, B) on the
kernel routes, a per-vehicle `VehicleState` on the per-vehicle route.
`WheeledEnv.step` runs the task's fused step where it has one (drift
training: one kernel per control step on CUDA), and otherwise the generic
manager step (reference env.py:283-441): action map -> physics -> push
events -> timed command resample -> terminations -> weighted rewards ->
episode stats -> masked auto-reset -> curriculum -> post-reset
observations. The physics is kernel K2 (flat ground) or K3 (heightfield),
or `sim/dynamics.py::step` in plain PyTorch with
`EnvCfg.use_kernels="off"` and for a heightfield task without a patch atlas
(the reference's `use_pallas` routes, env.py:226-241). Manager ordering
mirrors the reference: rewards and terminations on the post-physics state
before reset, observations after reset, reward terms scaled by
`weight * step_dt`. Every random draw comes
from the env's generator, and a step reads nothing back from the device:
the global step counter is a host int.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from ..ops.physics_step import physics_step
from ..ops.physics_step_hf import physics_step_hf
from ..sim import dynamics
from ..sim.actions import ActionMapCfg, action_to_targets
from ..sim.soa import pack_params, pack_state, unpack_state
from ..sim.terrain import Heightfield
from ..sim.types import VehicleParams, VehicleState
from ..utils import math as wmath
from ..utils.config import configclass
from ..utils.device import resolve_device
from ..utils.profiling import span, spanned


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
    use_kernels: str = "auto"       # "auto" | "on" | "off" (the reference's
    # use_pallas): "auto" and "on" run the task's fused step (K1/K4) and
    # the K2/K3 physics; "off" the generic step on sim/dynamics.py

    @property
    def step_dt(self) -> float:
        return self.sim_dt * self.decimation

    @property
    def max_episode_length(self) -> int:
        return int(round(self.episode_length_s / self.step_dt))


class StepCtx(NamedTuple):
    """Everything a term function may read — the counterpart of the `env`
    handle the reference passes to its mdp term fns."""

    vehicle: VehicleState          # batched [B]
    params: object                 # (NUM_PARAM, B) packed params; the
                                   # batched VehicleParams on the
                                   # per-vehicle route
    terrain: Heightfield
    body_lin_vel: torch.Tensor     # [B, 3] base_lin_vel (body frame)
    body_ang_vel: torch.Tensor     # [B, 3] base_ang_vel (body frame)
    last_action: torch.Tensor      # [B, 2] raw policy action
    prev_vehicle: VehicleState     # state before this step's physics
    command: torch.Tensor          # [B, C] task commands (zeros if unused)
    step_count: torch.Tensor       # [B] episode step counter
    common_step: int               # global step counter (host)
    terminated: Optional[torch.Tensor] = None  # [B] non-timeout dones
    time_out: Optional[torch.Tensor] = None    # [B]
    term_flags: Optional[Dict[str, torch.Tensor]] = None
    aux: Optional[dynamics.ContactAux] = None
    # ^ the last substep's contact data on the per-vehicle route; None on
    # the kernel routes, whose kernels return none (as in the reference)


class RewardTerm(NamedTuple):
    name: str
    weight: float                  # initial weight (curriculum may change it)
    fn: Callable[[StepCtx], torch.Tensor]


class CurriculumTerm(NamedTuple):
    """Parity: increase_reward_weight_over_time
    (reference wheeledlab/envs/mdp/curriculums.py:10-35)."""

    reward_term_name: str
    increase: float
    episodes_per_increase: int
    max_increases: int


class PushEvent(NamedTuple):
    """Interval push event (reference mushr_drift_env_cfg.py:121-143): adds
    a uniform random delta to the root velocity every `interval_range_s`."""

    interval_range_s: Tuple[float, float]
    lin_x: Tuple[float, float] = (0.0, 0.0)
    lin_y: Tuple[float, float] = (0.0, 0.0)
    yaw: Tuple[float, float] = (0.0, 0.0)


class CommandCfg(NamedTuple):
    """Uniform 2D goal command, resampled on a timer (parity:
    UniformPose2dCommandCfg, reference mushr_elevation_env_cfg.py:425-435)."""

    pos_x: Tuple[float, float]
    pos_y: Tuple[float, float]
    heading: Tuple[float, float]
    resampling_time_s: float


class TaskModel(NamedTuple):
    """A task = functions + constants (the reference TaskModel)."""

    cfg: EnvCfg
    terrain: Heightfield
    obs_dim: int
    init_params: Callable[[torch.Generator, int, torch.device], VehicleParams]
    sample_spawn: Callable[[torch.Generator, int, torch.device], VehicleState]
    reward_terms: Tuple[RewardTerm, ...]
    termination_fns: Dict[str, Callable[[StepCtx], torch.Tensor]]
    observe: Callable[[StepCtx, torch.Generator], torch.Tensor]
    curriculum: Tuple[CurriculumTerm, ...] = ()
    pushes: Tuple[PushEvent, ...] = ()
    command: Optional[CommandCfg] = None
    command_dim: int = 3
    terrain_atlas: Optional[object] = None  # PatchAtlas (scan-sized)
    contact_atlas: Optional[object] = None  # smaller PatchAtlas for wheel
    # contact; None -> terrain_atlas serves both
    metric_fns: Dict[str, Callable[[StepCtx], torch.Tensor]] = {}
    # ^ task-success metrics ([B] floats) in `info["metrics/<name>"]`,
    # evaluated on the post-termination, pre-reset ctx
    fused_step: Optional[Callable] = None
    # ^ (env, EnvState, action) -> (EnvState, StepOutput), the generic
    # step's semantics in one kernel
    render_grid: Optional[Tuple[np.ndarray, float]] = None
    # ^ (grid (rows, cols), cell) background of the top-down renderer; None
    # -> the drift oval
    colormap: Optional[object] = None
    # ^ the visual task's world ColorMap (tasks/visual/camera.py), for the
    # policy-view clips of training and playback


@dataclasses.dataclass
class EnvState:
    vehicle_mem: Union[torch.Tensor, VehicleState]
    # ^ the vehicle carry: (NUM_STATE, B) packed rows on the kernel routes,
    # a batched VehicleState on the per-vehicle route
    packed_params: Optional[torch.Tensor]  # (NUM_PARAM, B) DR'd params,
    # packed once at reset (startup DR only); None on the per-vehicle route
    step_count: torch.Tensor       # [B] int32
    common_step: int               # global step counter, kept on the host
    reward_weights: torch.Tensor   # [n_terms] f32 — curriculum state
    last_action: torch.Tensor      # [B, 2]
    command: torch.Tensor          # [B, C]
    command_timer: torch.Tensor    # [B] int32 steps until resample
    push_timers: torch.Tensor      # [n_push, B] int32
    ep_return: torch.Tensor        # [B]
    ep_len: torch.Tensor           # [B] int32
    params: Optional[VehicleParams] = None  # batched DR'd params of the
    # per-vehicle route

    @property
    def vehicle(self) -> VehicleState:
        """AoS view of the vehicle state, whatever the carry."""
        if isinstance(self.vehicle_mem, VehicleState):
            return self.vehicle_mem
        return unpack_state(self.vehicle_mem)

    def with_vehicle(self, vehicle: VehicleState) -> "EnvState":
        """This state with `vehicle` in place of its own, in the carry's
        representation."""
        if isinstance(self.vehicle_mem, VehicleState):
            return dataclasses.replace(self, vehicle_mem=vehicle)
        return dataclasses.replace(self, vehicle_mem=pack_state(vehicle))

    def to_dict(self) -> dict:
        """The fields as tensors and dicts of tensors, which
        `torch.load(..., weights_only=True)` restores (`from_dict`)."""
        tree = lambda x: ({f.name: getattr(x, f.name)
                           for f in dataclasses.fields(x)}
                          if dataclasses.is_dataclass(x) else x)
        return {f.name: tree(getattr(self, f.name))
                for f in dataclasses.fields(self)}

    @classmethod
    def from_dict(cls, d: dict) -> "EnvState":
        d = dict(d)
        if isinstance(d["vehicle_mem"], dict):
            d["vehicle_mem"] = VehicleState(**d["vehicle_mem"])
        if isinstance(d.get("params"), dict):
            d["params"] = VehicleParams(**d["params"])
        return cls(**d)


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
        # this env's rank in a job of several (`tasks.make_env(shard=)`)
        self.shard = 0
        self._weights_cache: Dict[Tuple[float, ...], torch.Tensor] = {}
        self._contact_atlas = task.contact_atlas or task.terrain_atlas
        if task.cfg.use_kernels not in ("auto", "on", "off"):
            raise ValueError(f"use_kernels={task.cfg.use_kernels!r}: "
                             "expected 'auto', 'on' or 'off'")
        # the per-vehicle physics (sim/dynamics.py): asked for, or the only
        # physics of a heightfield without a patch atlas (K3 reads patches)
        self.per_vehicle = (task.cfg.use_kernels == "off"
                            or (not task.terrain.is_flat
                                and self._contact_atlas is None))

    # ------------------------------------------------------------------ reset

    def reset(self) -> Tuple[EnvState, torch.Tensor]:
        task, g, dev = self.task, self.generator, self.device
        n = self.num_envs
        params = task.init_params(g, n, dev)
        vehicle = task.sample_spawn(g, n, dev)
        per_vehicle = self.per_vehicle
        state = EnvState(
            vehicle_mem=vehicle if per_vehicle else pack_state(vehicle),
            packed_params=(None if per_vehicle
                           else pack_params(params, task.terrain.friction)),
            params=params if per_vehicle else None,
            step_count=torch.zeros((n,), dtype=torch.int32, device=dev),
            common_step=0,
            reward_weights=self._weights_tensor(
                tuple(float(t.weight) for t in task.reward_terms)),
            last_action=torch.zeros((n, 2), device=dev),
            command=self._sample_command(n),
            command_timer=torch.full((n,), self._command_steps(),
                                     dtype=torch.int32, device=dev),
            push_timers=self._init_push_timers(n),
            ep_return=torch.zeros((n,), device=dev),
            ep_len=torch.zeros((n,), dtype=torch.int32, device=dev),
        )
        obs = task.observe(self._make_ctx(state, vehicle), g)
        return state, obs

    # ------------------------------------------------------------------- step

    @spanned("env.step")
    def step(self, state: EnvState,
             action: torch.Tensor) -> Tuple[EnvState, StepOutput]:
        if self.task.fused_step is not None and not self.per_vehicle:
            return self.task.fused_step(self, state, action)
        return self._generic_step(state, action)

    def _generic_step(self, state: EnvState, action: torch.Tensor
                      ) -> Tuple[EnvState, StepOutput]:
        task, cfg, g = self.task, self.cfg, self.generator
        n = self.num_envs
        prev_vehicle = state.vehicle

        # 1. action -> joint targets (action manager)
        steer_t, wheel_t = action_to_targets(action, cfg.action)

        # 2. physics decimation: kernel K2 (flat) or K3 (heightfield), or
        # the per-vehicle physics with its contact data
        with span("env.physics"):
            if self.per_vehicle:
                vehicle, aux = dynamics.step(
                    prev_vehicle, state.params, task.terrain, steer_t, wheel_t,
                    cfg.sim_dt, cfg.decimation, self._contact_atlas)
            else:
                mem = self._physics(state.vehicle_mem, state.packed_params,
                                    steer_t.T.contiguous(),
                                    wheel_t.T.contiguous())
                vehicle, aux = unpack_state(mem), None

        # 3. interval events: velocity pushes
        with span("env.events"):
            vehicle, push_timers = self._apply_pushes(vehicle,
                                                      state.push_timers)

            step_count = state.step_count + 1
            common_step = state.common_step + 1

            # 4. commands: timed resample
            command, command_timer = self._update_command(state.command,
                                                          state.command_timer)

        # reward/termination ctx sees the action applied THIS step as
        # last_action (IsaacLab action_manager semantics)
        with span("env.terms"):
            ctx = self._make_ctx(dataclasses.replace(
                state, command=command, step_count=step_count,
                common_step=common_step, last_action=action),
                prev_vehicle, vehicle, aux)

            # 5. terminations (before reset; parity with termination_manager)
            time_out = step_count >= self.max_episode_length
            term_flags = {name: fn(ctx)
                          for name, fn in task.termination_fns.items()}
            terminated = torch.zeros((n,), dtype=torch.bool,
                                     device=self.device)
            for v in term_flags.values():
                terminated = terminated | v
            done = terminated | time_out
            ctx = ctx._replace(terminated=terminated, time_out=time_out,
                               term_flags=term_flags)

            # 6. rewards (pre-reset state, weights * step_dt)
            reward = torch.zeros((n,), device=self.device)
            per_term = {}
            for i, t in enumerate(task.reward_terms):
                r = state.reward_weights[i] * t.fn(ctx) * cfg.step_dt
                per_term[f"rew/{t.name}"] = r
                reward = reward + r

            # episode stats (before reset zeroes them)
            ep_return = state.ep_return + reward
            ep_len = state.ep_len + 1

        # 7. auto-reset: masked blend of fresh spawns into done envs
        with span("env.reset"):
            spawn = task.sample_spawn(g, n, self.device)
            d1 = done[:, None]
            vehicle = VehicleState(**{
                f.name: torch.where(d1, getattr(spawn, f.name),
                                    getattr(vehicle, f.name))
                for f in dataclasses.fields(VehicleState)})
            step_count = torch.where(done, 0, step_count)
            command = torch.where(d1, self._sample_command(n), command)
            command_timer = torch.where(done, self._command_steps(),
                                        command_timer)
            last_action = torch.where(d1, 0.0, action)

            # 8. curriculum: closed form of the host step counter
            reward_weights = self._curriculum_weights(state.reward_weights,
                                                      common_step)

            new_state = EnvState(
                vehicle_mem=(vehicle if self.per_vehicle
                             else pack_state(vehicle)),
                packed_params=state.packed_params, params=state.params,
                step_count=step_count, common_step=common_step,
                reward_weights=reward_weights, last_action=last_action,
                command=command, command_timer=command_timer,
                push_timers=push_timers,
                ep_return=torch.where(done, 0.0, ep_return),
                ep_len=torch.where(done, 0, ep_len),
            )

        # 9. observations (post-reset; parity with observation_manager order)
        with span("env.observe"):
            obs = task.observe(self._make_ctx(new_state, prev_vehicle, vehicle,
                                              aux), g)

        info = {
            "episode_return": ep_return,      # valid where done
            "episode_length": ep_len.to(torch.float32),
            **per_term,
        }
        for name, v in term_flags.items():
            info[f"done/{name}"] = v
        info["done/time_out"] = time_out
        for name, fn in task.metric_fns.items():
            info[f"metrics/{name}"] = fn(ctx)
        return new_state, StepOutput(obs=obs, reward=reward, done=done,
                                     time_out=time_out, info=info)

    # ---------------------------------------------------------------- helpers

    def _physics(self, mem, params, steer_t, wheel_t) -> torch.Tensor:
        cfg = self.cfg
        if self.task.terrain.is_flat:
            return physics_step(mem, params, steer_t, wheel_t,
                                dt=cfg.sim_dt, decimation=cfg.decimation)
        atlas = self._contact_atlas
        # patch extraction (an atlas row gather) stays in plain PyTorch; the
        # kernel holds the patch for all `decimation` substeps
        patch, org = atlas.extract_rows(mem[0], mem[1])
        nx, ny = atlas.grid_shape
        return physics_step_hf(mem, params, patch, org, steer_t, wheel_t,
                               dt=cfg.sim_dt, decimation=cfg.decimation,
                               p=atlas.p, nx=nx, ny=ny, cell=atlas.cell)

    def _make_ctx(self, state: EnvState, prev_vehicle: VehicleState,
                  vehicle: Optional[VehicleState] = None,
                  aux: Optional[dynamics.ContactAux] = None) -> StepCtx:
        v = state.vehicle if vehicle is None else vehicle
        return StepCtx(
            vehicle=v, terrain=self.task.terrain,
            params=state.params if self.per_vehicle else state.packed_params,
            body_lin_vel=wmath.quat_rotate_inverse(v.quat, v.lin_vel),
            body_ang_vel=wmath.quat_rotate_inverse(v.quat, v.ang_vel),
            last_action=state.last_action, prev_vehicle=prev_vehicle,
            command=state.command, step_count=state.step_count,
            common_step=state.common_step, aux=aux)

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

    def _uniform(self, shape, lo: float, hi: float) -> torch.Tensor:
        return (torch.rand(shape, generator=self.generator,
                           device=self.device) * (hi - lo) + lo)

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

    def _apply_pushes(self, vehicle: VehicleState, timers: torch.Tensor):
        pushes = self.task.pushes
        if not pushes or not self.cfg.events_enabled:
            return vehicle, timers
        n = self.num_envs
        lin_vel, ang_vel = vehicle.lin_vel, vehicle.ang_vel
        new_timers = []
        for i, push in enumerate(pushes):
            timer = timers[i] - 1
            fire = (timer <= 0)[:, None]
            dx = self._uniform((n,), *push.lin_x)
            dy = self._uniform((n,), *push.lin_y)
            dyaw = self._uniform((n,), *push.yaw)
            zeros = torch.zeros_like(dx)
            delta_lin = torch.stack([dx, dy, zeros], -1)
            delta_ang = torch.stack([zeros, zeros, dyaw], -1)
            lin_vel = torch.where(fire, lin_vel + delta_lin, lin_vel)
            ang_vel = torch.where(fire, ang_vel + delta_ang, ang_vel)
            new_timers.append(torch.where(fire[:, 0],
                                          self._sample_interval(push, n),
                                          timer))
        vehicle = vehicle.replace(lin_vel=lin_vel, ang_vel=ang_vel)
        return vehicle, torch.stack(new_timers)

    def _command_steps(self) -> int:
        cmd = self.task.command
        if cmd is None:
            return 1
        return max(int(round(cmd.resampling_time_s / self.cfg.step_dt)), 1)

    def _sample_command(self, n: int) -> torch.Tensor:
        cmd = self.task.command
        if cmd is None:
            return torch.zeros((n, self.task.command_dim),
                               device=self.device)
        return torch.stack([self._uniform((n,), *cmd.pos_x),
                            self._uniform((n,), *cmd.pos_y),
                            self._uniform((n,), *cmd.heading)], -1)

    def _update_command(self, command: torch.Tensor, timer: torch.Tensor):
        if self.task.command is None:
            return command, timer
        timer = timer - 1
        fire = timer <= 0
        command = torch.where(fire[:, None], self._sample_command(
            self.num_envs), command)
        timer = torch.where(fire, self._command_steps(), timer)
        return command, timer
