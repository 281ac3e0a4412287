"""Elevation task — the port of `wheeledlab_tpu/tasks/elevation/task.py`
(reference elevation/mushr_elevation_env_cfg.py).

A procedural heightfield replaces the reference's USD terrain, and a
yaw-aligned bilinear grid scan of it replaces the RayCaster height scanner.
Goal commands, rewards, terminations, events and curriculum reproduce the
reference terms. Physics runs through the generic manager step and kernel
K3 on the small (p = 12) contact atlas; the height scan reads the p = 24
atlas with a direct gather of bilinear corners (the reference's one-hot
einsum is a TPU workaround for the missing gather)."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ...assets.robots import MUSHR_4WD_ACTION, MUSHR_SUS_CFG
from ...envs.env import (
    CommandCfg, CurriculumTerm, EnvCfg, RewardTerm, StepCtx, TaskModel,
    WheeledEnv,
)
from ...sim.terrain import Heightfield
from ...sim.types import VehicleState, batch_params, with_mass
from ...utils import math as wmath
from ...utils.config import configclass
from ...utils.device import resolve_device
from .terrain_gen import generate_elevation_terrain

REST_H = 0.06          # body-origin rest height above local ground
SCAN_SIZE = 2.5        # GridPatternCfg(size=[2.5, 2.5]) (:139)
SCAN_RES = 0.1
SCAN_N = int(round(SCAN_SIZE / SCAN_RES)) + 1   # 26 x 26 grid
ELEV_OBS_DIM = 2 + 3 + 3 + 3 + 2 + SCAN_N * SCAN_N


@configclass
class ElevationTaskCfg:
    """Parity: MushrElevationRLEnvCfg (mushr_elevation_env_cfg.py:438-469)."""

    num_envs: int = 512
    seed: int = 42
    sim_dt: float = 0.01          # 100 Hz
    decimation: int = 10          # 10 Hz control
    episode_length_s: float = 20.0
    # terrain generation (replaces huge_compact.usd)
    terrain_extent: float = 44.0
    terrain_cell: float = 0.25
    num_mounds: int = 60
    # goal command (:425-435)
    goal_range: float = 19.0
    goal_resample_s: float = 10.0
    # spawn (set_goal event, :409-419)
    spawn_range: float = 19.0
    spawn_vel_range: Tuple[float, float] = (0.1, 0.2)
    # DR (:383-407)
    mass_delta_range: Tuple[float, float] = (0.2, 0.5)
    wheel_friction: float = 1.0   # dynamic friction fixed at 1.0 (:391-393)
    events_enabled: bool = True
    terminations_enabled: bool = True  # Play strips terminations
    rewards_enabled: bool = True       # Play strips rewards + curriculum
    enable_corruption: bool = False  # reference ConcatObs disables corruption
    # Reward weights; the defaults are the reference's ElevationRewardsCfg
    # (mushr_elevation_env_cfg.py:283-305). ELEV_GOAL_CONFIG reweights them.
    goal_weight: float = 200.0
    height_weight: float = 5000.0
    at_goal_bonus: float = 0.0   # weight on the at_goal termination flag


# ---------------------------------------------------------------------------
# Reward terms (ElevationRewardsCfg, mushr_elevation_env_cfg.py:283-305)
# ---------------------------------------------------------------------------


def goal_progress_rate(ctx: StepCtx) -> torch.Tensor:
    """5 + projection of world velocity onto the goal direction (:239-249)."""
    pos = ctx.vehicle.pos[..., :2]
    vel = ctx.vehicle.lin_vel[..., :2]
    goal_vec = ctx.command[..., :2] - pos
    norm = torch.clamp(torch.linalg.vector_norm(goal_vec, dim=-1), min=1e-6)
    proj = torch.sum(vel * goal_vec, dim=-1) / norm
    return 5.0 + proj


def higher_elevation(ctx: StepCtx) -> torch.Tensor:
    """clip(z_above_base where climbing, 0, 1) (:166-173). The reference's
    0.19 base offset is our rest height REST_H."""
    z = ctx.vehicle.pos[..., 2] - REST_H
    vx = ctx.body_lin_vel[..., 0]
    rew = torch.where((z > 0.1) & (vx > 0.1), z, 0.0)
    return torch.clamp(rew, 0.0, 1.0)


def is_falling_penalty(ctx: StepCtx,
                       max_body_z_vel: float = 0.10) -> torch.Tensor:
    """body z velocity above threshold (:251-254)."""
    return (ctx.body_lin_vel[..., 2] > max_body_z_vel).to(torch.float32)


def _term_flag(ctx: StepCtx, name: str) -> torch.Tensor:
    """is_terminated_term on `name` (zeros without that termination)."""
    if ctx.term_flags is None or name not in ctx.term_flags:
        return torch.zeros(ctx.vehicle.pos.shape[0],
                           device=ctx.vehicle.pos.device)
    return ctx.term_flags[name].to(torch.float32)


def stuck_term_penalty(ctx: StepCtx) -> torch.Tensor:
    """is_terminated_term on 'stuck' (:301-305)."""
    return _term_flag(ctx, "stuck")


def at_goal_bonus_term(ctx: StepCtx) -> torch.Tensor:
    """is_terminated_term on 'at_goal': the terminal goal bonus of the
    goal-seeking variant (at_goal_bonus > 0)."""
    return _term_flag(ctx, "at_goal")


# ---------------------------------------------------------------------------
# Terminations (ElevationTerminationsCfg, :349-376)
# ---------------------------------------------------------------------------


def make_below_height(atlas):
    """root_height_below_minimum 0.15 with base 0.19 -> 4 cm below rest,
    relative to the local terrain height (:356-359), from the contact
    atlas."""

    def below_height(ctx: StepCtx) -> torch.Tensor:
        ground = atlas.lookup(ctx.vehicle.pos[..., :2])
        return (ctx.vehicle.pos[..., 2] - ground) < (REST_H - 0.04)

    return below_height


def stuck(ctx: StepCtx, min_vel: float = 0.02,
          wheel_spin_thr: float = 5.0) -> torch.Tensor:
    """not moving + spinning wheels (:342-347)."""
    not_moving = torch.clamp(ctx.body_lin_vel[..., 0], max=1.2) < min_vel
    spinning = torch.sum(ctx.vehicle.wheel_omega, dim=-1) > wheel_spin_thr
    return not_moving & spinning


# cos(60 deg) in float32, as the reference computes it
_COS_ROLLOVER = float(torch.cos(torch.deg2rad(torch.tensor(60.0))))


def rollover(ctx: StepCtx) -> torch.Tensor:
    """tilt angle beyond 60 deg (upright_bool, :339-340)."""
    return wmath.up_dot(ctx.vehicle.quat) < _COS_ROLLOVER


def at_goal(ctx: StepCtx, dist: float = 0.5) -> torch.Tensor:
    """close_to_goal (:268-273)."""
    return goal_distance(ctx) < dist


# ---------------------------------------------------------------------------
# Task-success metrics
# ---------------------------------------------------------------------------


def goal_distance(ctx: StepCtx) -> torch.Tensor:
    return torch.linalg.vector_norm(
        ctx.command[..., :2] - ctx.vehicle.pos[..., :2], dim=-1)


def make_elevation_gain(atlas):
    """Height of the local ground under the robot (rises as policies
    climb), from the contact atlas."""

    def elevation_gain(ctx: StepCtx) -> torch.Tensor:
        return atlas.lookup(ctx.vehicle.pos[..., :2])

    return elevation_gain


# ---------------------------------------------------------------------------
# Observations (ElevationObsCfg, :57-88)
# ---------------------------------------------------------------------------


def make_elevation_obs(atlas):
    """Obs fn over the scan-sized PatchAtlas: per env, one atlas row gather,
    then the 26 x 26 yaw-aligned grid as a gather of the four bilinear
    corners of every sample from the env's patch — the values of the
    reference's one-hot contraction (exact bilinear sampling on the native
    grid), in its order: along x first, then along y."""
    p = atlas.p
    nx, ny = atlas.grid_shape
    n = SCAN_N
    axis = (torch.arange(n, dtype=torch.float32) - (n - 1) / 2.0) * SCAN_RES
    ox, oy = torch.meshgrid(axis, axis, indexing="ij")
    offs = {}   # device -> (offs_x, offs_y), each (1, n*n)

    def elevation_obs(ctx: StepCtx, generator) -> torch.Tensor:
        v = ctx.vehicle
        dev = v.pos.device
        if dev not in offs:
            offs[dev] = (ox.reshape(1, -1).to(dev), oy.reshape(1, -1).to(dev))
        offs_x, offs_y = offs[dev]
        goal_rel = torch.nan_to_num(ctx.command[..., :2] - v.pos[..., :2])
        euler = wmath.euler_xyz_from_quat(v.quat)
        yaw = euler[..., 2]
        pos2 = v.pos[..., :2]
        # world-corrected height map (:44-48): terrain height around the
        # robot relative to its actual z, so suspension travel and airborne
        # states stay visible
        rows, org = atlas.extract_rows(pos2[:, 0], pos2[:, 1])
        patch = rows.T                                        # (B, p*p)
        c, s = torch.cos(yaw)[:, None], torch.sin(yaw)[:, None]
        qx = pos2[:, 0, None] + offs_x * c - offs_y * s
        qy = pos2[:, 1, None] + offs_x * s + offs_y * c
        u = torch.clamp(wmath.div(qx, atlas.cell) + (nx - 1) / 2.0
                        - org[0][:, None], 0.0, p - 1.001)
        w = torch.clamp(wmath.div(qy, atlas.cell) + (ny - 1) / 2.0
                        - org[1][:, None], 0.0, p - 1.001)
        x0 = torch.floor(u)
        y0 = torch.floor(w)
        fx, fy = u - x0, w - y0
        idx = (torch.clamp(x0.to(torch.int64), 0, p - 2) * p
               + torch.clamp(y0.to(torch.int64), 0, p - 2))
        corner = lambda off: torch.gather(patch, 1, idx + off)
        r0 = (1.0 - fx) * corner(0) + fx * corner(p)          # row y0
        r1 = (1.0 - fx) * corner(1) + fx * corner(p + 1)      # row y0 + 1
        scan = r0 * (1.0 - fy) + r1 * fy                      # (B, n*n)
        rel_scan = scan - (v.pos[..., 2] - REST_H)[..., None]
        return torch.cat([
            goal_rel,
            euler,
            torch.clamp(ctx.body_lin_vel, -10.0, 10.0),
            torch.clamp(ctx.body_ang_vel, -10.0, 10.0),
            torch.clamp(ctx.last_action, -1.0, 1.0),
            torch.clamp(rel_scan, -10.0, 10.0),
        ], dim=-1)

    return elevation_obs


# ---------------------------------------------------------------------------
# Task assembly
# ---------------------------------------------------------------------------


def make_elevation_task(cfg: ElevationTaskCfg, device="cpu",
                        terrain: Optional[Heightfield] = None) -> TaskModel:
    """The task on `device`. `terrain` replaces the generated heightfield
    (the parity tests pass the JAX package's, see
    `convert.heightfield_from_jax`)."""
    if terrain is None:
        terrain = generate_elevation_terrain(
            torch.Generator().manual_seed(cfg.seed + 23),
            extent=cfg.terrain_extent, cell=cfg.terrain_cell,
            num_mounds=cfg.num_mounds, friction=cfg.wheel_friction,
            device=device)
    else:
        terrain = Heightfield(height=terrain.height.to(device),
                              cell=terrain.cell, friction=terrain.friction)
    # p=24/stride=6 covers the 2.5 m scan; the small p=12/stride=2 atlas
    # covers wheel reach plus one control step of travel, for contact and
    # the step path's ground lookups
    atlas = terrain.build_atlas(p=24, stride=6)
    contact_atlas = terrain.build_atlas(p=12, stride=2)

    env_cfg = EnvCfg(
        num_envs=cfg.num_envs, sim_dt=cfg.sim_dt, decimation=cfg.decimation,
        episode_length_s=cfg.episode_length_s, action=MUSHR_4WD_ACTION,
        enable_corruption=cfg.enable_corruption,
        events_enabled=cfg.events_enabled)

    def init_params(g, num, dev):
        """Startup DR (:383-407): friction fixed 1.0, mass add U(0.2, 0.5)."""
        params = batch_params(MUSHR_SUS_CFG, num, dev)
        if not cfg.events_enabled:
            return params
        lo, hi = cfg.mass_delta_range
        dmass = torch.rand((num,), generator=g, device=dev) * (hi - lo) + lo
        return with_mass(params, params.mass + dmass)

    def sample_spawn(g, num, dev):
        """reset_root_state_uniform over +-19 m, yaw +-pi, small forward vel
        (:409-419); z snapped to the local terrain height."""
        u = lambda shape, lo, hi: (torch.rand(shape, generator=g, device=dev)
                                   * (hi - lo) + lo)
        xy = u((num, 2), -cfg.spawn_range, cfg.spawn_range)
        yaw = u((num,), -torch.pi, torch.pi)
        vel_xy = u((num, 2), *cfg.spawn_vel_range)
        ground = contact_atlas.lookup(xy)
        pos = torch.cat([xy, (ground + REST_H + 0.02)[:, None]], -1)
        lin_vel = torch.cat([vel_xy, torch.zeros((num, 1), device=dev)], -1)
        return VehicleState.zero((num,), dev).replace(
            pos=pos, quat=wmath.quat_from_yaw(yaw), lin_vel=lin_vel)

    reward_terms = (
        RewardTerm("vel_towards_goal", cfg.goal_weight, goal_progress_rate),
        RewardTerm("height_z", cfg.height_weight, higher_elevation),
        RewardTerm("falling_penalty", 0.0, is_falling_penalty),
        RewardTerm("termination_penalty", -200.0, stuck_term_penalty),
    ) if cfg.rewards_enabled else ()
    if cfg.rewards_enabled and cfg.at_goal_bonus:
        reward_terms = reward_terms + (
            RewardTerm("at_goal_bonus", cfg.at_goal_bonus,
                       at_goal_bonus_term),)

    curriculum = (
        CurriculumTerm("vel_towards_goal", 5.0, 50, 5),
        CurriculumTerm("falling_penalty", 1.0, 50, 10),
    ) if cfg.rewards_enabled else ()

    return TaskModel(
        cfg=env_cfg,
        terrain=terrain,
        obs_dim=ELEV_OBS_DIM,
        init_params=init_params,
        sample_spawn=sample_spawn,
        reward_terms=reward_terms,
        termination_fns=({
            "cart_out_of_bounds": make_below_height(contact_atlas),
            "stuck": stuck,
            "rollover": rollover,
            "at_goal": at_goal,
        } if cfg.terminations_enabled else {}),
        observe=make_elevation_obs(atlas),
        curriculum=curriculum,
        command=CommandCfg(
            pos_x=(-cfg.goal_range, cfg.goal_range),
            pos_y=(-cfg.goal_range, cfg.goal_range),
            heading=(-3.14, 3.14),
            resampling_time_s=cfg.goal_resample_s),
        terrain_atlas=atlas,
        contact_atlas=contact_atlas,
        metric_fns={"goal_dist": goal_distance,
                    "ground_height": make_elevation_gain(contact_atlas)},
        render_grid=(terrain.height.T.cpu().numpy(), float(terrain.cell)),
    )


def make_elevation_env(cfg: ElevationTaskCfg = ElevationTaskCfg(),
                       device="cuda", seed: int = 0,
                       terrain: Optional[Heightfield] = None) -> WheeledEnv:
    dev = resolve_device(device)
    return WheeledEnv(make_elevation_task(cfg, dev, terrain), device=dev,
                      seed=seed)
