"""Drift task — the port of `wheeledlab_tpu/tasks/drift/task.py` (reference
drifting/mushr_drift_env_cfg.py).

Oval track: two straights at x = ±LINE_RADIUS (|y| <= STRAIGHT) joined by
semicircles of radius LINE_RADIUS centered at (0, ±STRAIGHT). In the
training variant the reward terms, terminations and reset are computed by
the fused step (`tasks/drift/fused.py`); with `EnvCfg.use_kernels="off"`
the generic manager step computes them from the term functions below
(reference task.py:161-213), on the per-vehicle physics. The play variants
strip rewards, curriculum and terminations and go through the generic step,
whose physics is kernel K2; they report the `slip_deg` and `speed`
metrics."""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from ...assets.robots import (
    F1TENTH_4WD_ACTION, F1TENTH_CFG, MUSHR_RWD_ACTION, MUSHR_SUS_2WD_CFG,
)
from ...envs.env import (
    CurriculumTerm, EnvCfg, PushEvent, RewardTerm, StepCtx, TaskModel,
    WheeledEnv,
)
from ...sim.terrain import Heightfield
from ...sim.types import VehicleState, batch_params, with_mass
from ...utils import math as wmath
from ...utils.config import configclass
from ..common.observations import BLIND_OBS_DIM, blind_obs

# Common constants (reference mushr_drift_env_cfg.py:27-32)
CORNER_IN_RADIUS = 0.3
CORNER_OUT_RADIUS = 2.0
LINE_RADIUS = 0.8
STRAIGHT = 0.8
SLIP_THRESHOLD = 0.55
MAX_SPEED = 3.0

SPAWN_Z = 0.06  # body-origin rest height (params.com_height)


# ---------------------------------------------------------------------------
# Reward terms (DriftRewardsCfg, mushr_drift_env_cfg.py:242-299)
# ---------------------------------------------------------------------------


def _cross_track_sq(pos: torch.Tensor, straight: float,
                    radius: float) -> torch.Tensor:
    """Squared distance to the track line of the given radius — the
    piecewise oval metric (cross_track_dist, mushr_drift_env_cfg.py:
    173-193)."""
    x, y = pos[..., 0], pos[..., 1]
    return torch.where(
        torch.abs(y) < straight,
        torch.where(x > 0, (x - radius) ** 2, (x + radius) ** 2),
        torch.where(
            y > 0,
            (torch.sqrt((y - straight) ** 2 + x**2) - radius) ** 2,
            (torch.sqrt((y + straight) ** 2 + x**2) - radius) ** 2))


def track_progress_rate(ctx: StepCtx) -> torch.Tensor:
    """World-frame yaw angular velocity (:160-165)."""
    return ctx.vehicle.ang_vel[..., 2]


def vel_dist(ctx: StepCtx, speed_target: float = MAX_SPEED,
             offset: float = -MAX_SPEED**2) -> torch.Tensor:
    """(ground_speed - target)^2 + offset (:167-171)."""
    return (ground_speed(ctx) - speed_target) ** 2 + offset


def cross_track_dist(ctx: StepCtx, straight: float = STRAIGHT,
                     track_radius: float = LINE_RADIUS,
                     offset: float = -1.0, p: float = 1.0) -> torch.Tensor:
    """sqrt(piecewise squared distance) + offset, to the power p
    (:173-193)."""
    ctd = torch.sqrt(_cross_track_sq(ctx.vehicle.pos, straight,
                                     track_radius)) + offset
    return torch.sign(ctd) * torch.abs(ctd) ** p if p != 1.0 else ctd


def energy_through_turn(ctx: StepCtx,
                        straight: float = STRAIGHT) -> torch.Tensor:
    """speed^2 while in the corners (:195-199)."""
    speed = torch.linalg.vector_norm(ctx.body_lin_vel, dim=-1)
    return torch.where(torch.abs(ctx.vehicle.pos[..., 1]) > straight,
                       speed**2, 0.0)


def side_slip(ctx: StepCtx, min_thresh: float = 0.25,
              max_thresh: float = SLIP_THRESHOLD,
              min_vel_x: float = 1.0) -> torch.Tensor:
    """|atan2(v_y, v_x)| gated by the forward speed and thresholds
    (:219-230)."""
    vel = ctx.body_lin_vel
    slip_angle = torch.abs(torch.atan2(vel[..., 1], vel[..., 0]))
    valid = torch.where(
        (torch.abs(vel[..., 0]) < min_vel_x) | (slip_angle > max_thresh),
        0.0, slip_angle)
    return torch.where(valid < min_thresh, 0.0, valid)


def turn_left_go_right(ctx: StepCtx,
                       ang_vel_thresh: float = 1.0) -> torch.Tensor:
    """Counter-steer reward: -mean(steer) * clamp(yaw rate), at least 0
    (:232-240)."""
    steer_mean = ctx.vehicle.steer_pos.mean(dim=-1)
    ang_vel = torch.clamp(ctx.body_ang_vel[..., 2], -ang_vel_thresh,
                          ang_vel_thresh)
    return torch.clamp(steer_mean * ang_vel * -1.0, min=0.0)


def term_pens(ctx: StepCtx) -> torch.Tensor:
    """is_terminated_term on out_of_bounds (:295-299)."""
    return ctx.term_flags["out_of_bounds"].to(torch.float32)


# The reward terms with their initial weights, in the fused step's row order
REWARD_TERMS = (
    RewardTerm("side_slip", 10.0, side_slip),
    RewardTerm("vel", -5.0, vel_dist),
    RewardTerm("progress", 40.0, track_progress_rate),
    RewardTerm("tlgr", 0.0, turn_left_go_right),
    RewardTerm("turn_energy", 20.0, energy_through_turn),
    RewardTerm("cross_track", -50.0, cross_track_dist),
    RewardTerm("term_pens", -5000.0, term_pens),
)
CURRICULUM = (
    CurriculumTerm("side_slip", 20.0, 20, 10),
    CurriculumTerm("tlgr", 10.0, 20, 5),
    CurriculumTerm("term_pens", -1000.0, 50, 5),
)
PUSHES = (
    PushEvent(interval_range_s=(0.1, 0.4), lin_x=(-0.1, 0.1),
              lin_y=(-0.03, 0.03), yaw=(-0.3, 0.3)),
    PushEvent(interval_range_s=(0.8, 1.2), yaw=(-0.6, 0.6)),
)


@configclass
class DriftTaskCfg:
    """Parity: MushrDriftRLEnvCfg (mushr_drift_env_cfg.py:369-404)."""

    num_envs: int = 1024
    seed: int = 42
    robot: str = "mushr"             # "mushr" | "f1tenth"
    sim_dt: float = 0.005            # 200 Hz
    decimation: int = 4              # 50 Hz control
    episode_length_s: float = 5.0
    # reset event (DriftEventsCfg, :82-93)
    track_radius: float = LINE_RADIUS
    track_straight_dist: float = STRAIGHT
    num_reset_points: int = 20
    pos_noise: float = 0.5
    yaw_noise: float = 1.0
    # DR events (DriftEventsRandomCfg, :96-154)
    friction_range: Tuple[float, float] = (0.3, 0.5)
    friction_buckets: int = 20
    mass_delta_range: Tuple[float, float] = (0.3, 0.5)
    motor_damping_range: Tuple[float, float] = (10.0, 50.0)
    enable_corruption: bool = True
    events_enabled: bool = True
    terminations_enabled: bool = True  # Play strips terminations
    rewards_enabled: bool = True       # Play strips rewards + curriculum too
    ground_friction: float = 1.0     # carpet dynamic friction (:45-50)


def reference_track_poses(cfg: DriftTaskCfg, u: torch.Tensor) -> torch.Tensor:
    """`num_reset_points` poses by arc-length parameterization of the oval
    (generate_reference_poses, drifting/mdp/events.py:33-100), at track
    fractions `u` (N,) in [0, 1). Returns (N, 4): x, y, z, yaw_rad."""
    radius, straight = cfg.track_radius, cfg.track_straight_dist
    n = u.shape[0]
    dist_track = 2.0 * math.pi * radius + 4.0 * straight
    dists = u * dist_track
    full = lambda v: torch.full((n,), v, dtype=torch.float32)

    # Case 1: right straight, heading +y (90 deg)
    c1_pos = torch.stack([full(radius), dists - straight], -1)
    c1_yaw = full(90.0)
    # Case 2: top semicircle
    a = (dists - 2 * straight) / radius
    c2_pos = torch.stack([radius * torch.cos(a),
                          straight + radius * torch.sin(a)], -1)
    c2_yaw = 90.0 + a * 180.0 / math.pi
    # Case 3: left straight, heading -y (270 deg)
    rem = dists - 2 * straight - math.pi * radius
    c3_pos = torch.stack([full(-radius), straight - rem], -1)
    c3_yaw = full(270.0)
    # Case 4: bottom semicircle
    a2 = (dists - 4 * straight - math.pi * radius) / radius
    c4_pos = torch.stack([-radius * torch.cos(a2),
                          -straight - radius * torch.sin(a2)], -1)
    c4_yaw = 270.0 + a2 * 180.0 / math.pi

    in1 = (dists < 2 * straight)[:, None]
    in2 = (dists < 2 * straight + math.pi * radius)[:, None]
    in3 = (dists < 4 * straight + math.pi * radius)[:, None]
    pos = torch.where(in1, c1_pos, torch.where(
        in2, c2_pos, torch.where(in3, c3_pos, c4_pos)))
    yaw = torch.where(in1[:, 0], c1_yaw, torch.where(
        in2[:, 0], c2_yaw, torch.where(in3[:, 0], c3_yaw, c4_yaw)))
    return torch.cat([pos, full(SPAWN_Z)[:, None],
                      torch.deg2rad(yaw)[:, None]], -1)


def _off_or_in(pos: torch.Tensor, straight: float) -> torch.Tensor:
    """Outside the outer boundary or inside the infield
    (mushr_drift_env_cfg.py:201-217)."""
    x, y = pos[..., 0], pos[..., 1]
    on_straights = torch.abs(y) < straight
    corner_sq = torch.where(y > 0, (y - straight) ** 2,
                            (y + straight) ** 2) + x**2
    off = torch.where(on_straights, torch.abs(x) > CORNER_OUT_RADIUS,
                      corner_sq > CORNER_OUT_RADIUS**2)
    inside = torch.where(on_straights, torch.abs(x) < CORNER_IN_RADIUS,
                         corner_sq < CORNER_IN_RADIUS**2)
    return off | inside


def cart_off_track(ctx: StepCtx) -> torch.Tensor:
    """The out_of_bounds termination (DriftTerminationsCfg, :350-362)."""
    return _off_or_in(ctx.vehicle.pos, STRAIGHT)


def slip_deg(ctx: StepCtx, min_vel_x: float = 1.0) -> torch.Tensor:
    """|slip angle| in degrees where the car moves forward at >= 1 m/s
    (gated like the side_slip reward, mushr_drift_env_cfg.py:219-230)."""
    vel = ctx.body_lin_vel
    slip = torch.abs(torch.atan2(vel[..., 1], vel[..., 0]))
    return torch.where(torch.abs(vel[..., 0]) >= min_vel_x,
                       torch.rad2deg(slip), 0.0)


def ground_speed(ctx: StepCtx) -> torch.Tensor:
    return torch.linalg.vector_norm(ctx.body_lin_vel[..., :2], dim=-1)


def _uniform(g, shape, lo, hi, device):
    return torch.rand(shape, generator=g, device=device) * (hi - lo) + lo


def make_drift_task(cfg: DriftTaskCfg,
                    ref_poses: Optional[torch.Tensor] = None) -> TaskModel:
    """The drift task. `ref_poses` replaces the (num_reset_points, 4) pose
    table, which is otherwise a host constant drawn from the task seed (the
    parity tests hand over the reference's table)."""
    if ref_poses is None:
        track_gen = torch.Generator().manual_seed(cfg.seed + 17)
        ref_poses = reference_track_poses(
            cfg, torch.rand((cfg.num_reset_points,), generator=track_gen))
    ref_poses = torch.as_tensor(ref_poses, dtype=torch.float32).cpu()
    if tuple(ref_poses.shape) != (cfg.num_reset_points, 4):
        raise ValueError(f"ref_poses has shape {tuple(ref_poses.shape)}, "
                         f"expected {(cfg.num_reset_points, 4)}")

    if cfg.robot == "mushr":
        base_params, action = MUSHR_SUS_2WD_CFG, MUSHR_RWD_ACTION
    elif cfg.robot == "f1tenth":
        base_params, action = F1TENTH_CFG, F1TENTH_4WD_ACTION
    else:
        raise ValueError(cfg.robot)

    env_cfg = EnvCfg(
        num_envs=cfg.num_envs, sim_dt=cfg.sim_dt, decimation=cfg.decimation,
        episode_length_s=cfg.episode_length_s, action=action,
        enable_corruption=cfg.enable_corruption,
        events_enabled=cfg.events_enabled)

    def init_params(g, num, device):
        """Startup DR (DriftEventsRandomCfg :96-154): per-wheel friction from
        buckets, motor damping uniform-abs, base mass add uniform."""
        params = batch_params(base_params, num, device)
        if not cfg.events_enabled:
            return params
        buckets = _uniform(g, (cfg.friction_buckets,), *cfg.friction_range,
                           device)
        assign = torch.randint(0, cfg.friction_buckets, (num, 4),
                               generator=g, device=device)
        tire_mu = buckets[assign]
        damping = _uniform(g, (num, 1), *cfg.motor_damping_range, device)
        motor_damping = damping.expand(num, 4).contiguous()
        dmass = _uniform(g, (num,), *cfg.mass_delta_range, device)
        params = params.replace(tire_mu=tire_mu, motor_damping=motor_damping)
        return with_mass(params, params.mass + dmass)

    def sample_spawn(g, num, device):
        """Reset along track (reset_root_state_along_track,
        drifting/mdp/events.py:102-133)."""
        idx = torch.randint(0, cfg.num_reset_points, (num,), generator=g,
                            device=device)
        ref = ref_poses.to(device)[idx]
        xy_noise = (torch.rand((num, 2), generator=g, device=device) * 2
                    - 1) * cfg.pos_noise
        yaw_noise = (torch.rand((num,), generator=g, device=device) * 2
                     - 1) * cfg.yaw_noise
        pos = torch.stack([ref[:, 0] + xy_noise[:, 0],
                           ref[:, 1] + xy_noise[:, 1], ref[:, 2]], -1)
        quat = wmath.quat_from_yaw(ref[:, 3] + yaw_noise)
        return VehicleState.zero((num,), device).replace(pos=pos, quat=quat)

    def observe(ctx, g):
        return blind_obs(ctx, g, cfg.enable_corruption)

    def term_pens_safe(ctx):
        if not cfg.terminations_enabled:
            return torch.zeros(ctx.vehicle.pos.shape[0],
                               device=ctx.vehicle.pos.device)
        return term_pens(ctx)

    reward_terms = REWARD_TERMS[:-1] + (
        REWARD_TERMS[-1]._replace(fn=term_pens_safe),)

    fused_step = None
    if cfg.rewards_enabled:
        from .fused import make_fused_drift_step

        fused_step = make_fused_drift_step(cfg, env_cfg, ref_poses)

    return TaskModel(
        cfg=env_cfg,
        terrain=Heightfield.flat(friction=cfg.ground_friction),
        obs_dim=BLIND_OBS_DIM,
        init_params=init_params,
        sample_spawn=sample_spawn,
        reward_terms=reward_terms if cfg.rewards_enabled else (),
        termination_fns=({"out_of_bounds": cart_off_track}
                         if cfg.terminations_enabled else {}),
        observe=observe,
        curriculum=CURRICULUM if cfg.rewards_enabled else (),
        pushes=PUSHES if cfg.events_enabled else (),
        metric_fns={"slip_deg": slip_deg, "speed": ground_speed},
        fused_step=fused_step,
    )


def make_drift_env(cfg: DriftTaskCfg = DriftTaskCfg(), device="cuda",
                   seed: int = 0,
                   ref_poses: Optional[torch.Tensor] = None) -> WheeledEnv:
    return WheeledEnv(make_drift_task(cfg, ref_poses), device=device,
                      seed=seed)
