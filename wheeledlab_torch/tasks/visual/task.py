"""Visual task — the port of `wheeledlab_tpu/tasks/visual/task.py`
(reference visual/mushr_visual_env_cfg.py).

World: procedurally carved traversability corridors (white on black) on a
flat plane; the policy sees the 80 x 60 onboard camera (camera.py),
augmented and flattened (augment.py). Physics runs through the generic
manager step and kernel K2 (flat ground, 20 substeps a control step).
Rewards, terminations and events reproduce the reference terms."""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ...assets.robots import MUSHR_4WD_ACTION, MUSHR_SUS_CFG
from ...envs.env import EnvCfg, RewardTerm, StepCtx, TaskModel, WheeledEnv
from ...sim.terrain import Heightfield
from ...sim.types import VehicleState, batch_params, with_mass
from ...utils import math as wmath
from ...utils.config import configclass
from ...utils.device import resolve_device
from .augment import augment_images
from .camera import (
    HEIGHT, LUMA, WIDTH, ColorMap, ColorMapAtlas, camera_rgb_flattened,
    render, render_fast,
)
from .map_gen import generate_traversability_map

REST_H = 0.06
CAMERA_OBS = (HEIGHT - HEIGHT // 3) * WIDTH  # 40 x 80 = 3200
VISUAL_OBS_DIM = CAMERA_OBS + 3 + 3 + 2


@configclass
class VisualTaskCfg:
    """Parity: MushrVisualRLEnvCfg (mushr_visual_env_cfg.py:412-448)."""

    num_envs: int = 1024
    seed: int = 42
    # reference: sim.dt 0.02, decimation 10 (5 Hz control); physics runs at
    # 100 Hz with decimation 20: the same control rate
    sim_dt: float = 0.01
    decimation: int = 20
    episode_length_s: float = 10.0
    # map (VisualTerrainImporterCfg :68-112)
    map_rows: int = 500
    map_cols: int = 500
    cell: float = 0.5
    env_rows: int = 100
    env_cols: int = 100
    group_rows: int = 50
    group_cols: int = 50
    num_walkers: int = 1
    ground_friction: float = 2.0     # static/dynamic 2.0 (:130-135)
    # DR (VisualEventsRandomCfg :267-299)
    friction_range: Tuple[float, float] = (0.4, 0.6)
    friction_buckets: int = 10
    base_mass_range: Tuple[float, float] = (1.0, 3.0)    # abs
    wheel_mass_range: Tuple[float, float] = (0.01, 0.3)  # abs -> spin inertia
    events_enabled: bool = True
    terminations_enabled: bool = True  # Play strips terminations (:455-470)
    rewards_enabled: bool = True       # Play strips rewards too (:469)
    enable_corruption: bool = True   # Unoise on vel/action obs (:46-52)
    exact_render: bool = False       # True: per-pixel map lookups (exact
                                     # far field); False: the window atlas
                                     # (exact inside ~7.5 m, border-clamped
                                     # beyond, camera.py::ColorMapAtlas)
    obs_variant: str = "aug_grayscale"
    # ^ camera obs term: "aug_grayscale" is the registered reference task's
    # camera_data_rgb_flattened_aug (crop, jitter + blur, grayscale,
    # normalize, flatten, observations.py:75-87); "rgb_flattened" is
    # camera_data_rgb_flattened (:64-73), the non-augmented term through
    # the RGB render (camera.py::camera_rgb_flattened)
    color_sampling: bool = False     # world-side color DR (reference
                                     # color_sampler, visual/utils/
                                     # __init__.py:35-49, default False at
                                     # mushr_visual_env_cfg.py:110): per-class
                                     # gray levels plus per-cell jitter


# ---------------------------------------------------------------------------
# Rewards (VisualRewardsCfg :374-385) and terminations (:390-409)
# ---------------------------------------------------------------------------


def make_terms(colormap: ColorMap):
    def traversable_reward(ctx: StepCtx) -> torch.Tensor:
        """+1 on a corridor, -1 off it (traversable_reward :309-312)."""
        t = colormap.sample(ctx.vehicle.pos[..., :2])
        return torch.where(t > 0.5, 1.0, -1.0)

    def forward_vel(ctx: StepCtx) -> torch.Tensor:
        """Body-frame forward velocity (:370-371)."""
        return ctx.body_lin_vel[..., 0]

    def out_of_map(ctx: StepCtx) -> torch.Tensor:
        """Outside the map's extent (:390-398)."""
        x, y = ctx.vehicle.pos[..., 0], ctx.vehicle.pos[..., 1]
        return ((torch.abs(x) > colormap.width / 2)
                | (torch.abs(y) > colormap.height / 2))

    return traversable_reward, forward_vel, out_of_map


# ---------------------------------------------------------------------------
# World
# ---------------------------------------------------------------------------


def visual_world(cfg: VisualTaskCfg):
    """The traversability grid and the world's colors, as the reference
    builds them from the task seed (numpy): (traversable (rows, cols) bool,
    gray (rows, cols) f32, RGB (rows, cols, 3) f32 or None).

    With `color_sampling`, per-class RGB draws like the reference's
    color_sampler (visual/utils/__init__.py:35-49: per channel U(level - 15,
    level + 15) / 255, black level 30, white 220) plus per-cell jitter of the
    same size; the gray world is the RGB world's luma and stays on either
    side of 0.5, so every traversability check is unchanged."""
    trav = generate_traversability_map(
        cfg.seed, map_size=(cfg.map_rows, cfg.map_cols),
        env_size=(cfg.env_rows, cfg.env_cols),
        sub_group_size=(cfg.group_rows, cfg.group_cols),
        num_walkers=cfg.num_walkers)
    gray = np.asarray(trav, np.float32)
    rgb = None
    if cfg.color_sampling:
        rng = np.random.default_rng(np.uint32(cfg.seed) * 7919 + 13)
        black_rgb = rng.uniform(15.0, 45.0, 3) / 255.0
        white_rgb = rng.uniform(205.0, 235.0, 3) / 255.0
        jitter = rng.uniform(-15.0, 15.0, trav.shape + (3,)) / 255.0
        rgb = (np.where(trav[..., None], white_rgb, black_rgb)
               + jitter).astype(np.float32)
        gray = (rgb @ LUMA).astype(np.float32)
    return trav, gray, rgb


# ---------------------------------------------------------------------------
# Task assembly
# ---------------------------------------------------------------------------


def make_visual_task(cfg: VisualTaskCfg, device="cpu") -> TaskModel:
    """The task on `device`."""
    trav, gray, rgb = visual_world(cfg)
    colormap = ColorMap(
        grid=torch.as_tensor(gray, device=device),
        cell=float(np.float32(cfg.cell)),
        rows=cfg.map_rows, cols=cfg.map_cols,
        grid_rgb=None if rgb is None else torch.as_tensor(rgb, device=device))

    # spawn cells (reference generate_random_poses, visual/utils/
    # __init__.py:190-205): every traversable cell, in np.nonzero order
    rows_idx, cols_idx = np.nonzero(trav)
    spawn_xy = torch.as_tensor(np.stack([
        (cols_idx - cfg.map_cols // 2) * cfg.cell,   # x from col
        (rows_idx - cfg.map_rows // 2) * cfg.cell,   # y from row
    ], axis=-1).astype(np.float32), device=device)

    env_cfg = EnvCfg(
        num_envs=cfg.num_envs, sim_dt=cfg.sim_dt, decimation=cfg.decimation,
        episode_length_s=cfg.episode_length_s,
        action=MUSHR_4WD_ACTION,     # MuSHR + suspension, 4WD (:226)
        enable_corruption=cfg.enable_corruption,
        events_enabled=cfg.events_enabled)

    terrain = Heightfield.flat(friction=cfg.ground_friction, device=device)
    traversable_reward, forward_vel, out_of_map = make_terms(colormap)

    def init_params(g, num, dev):
        """Startup DR (:267-299): per-wheel friction buckets, absolute base
        mass, absolute wheel mass -> spin inertia."""
        params = batch_params(MUSHR_SUS_CFG, num, dev)
        if not cfg.events_enabled:
            return params
        u = lambda shape, lo, hi: (torch.rand(shape, generator=g, device=dev)
                                   * (hi - lo) + lo)
        buckets = u((cfg.friction_buckets,), *cfg.friction_range)
        assign = torch.randint(0, cfg.friction_buckets, (num, 4),
                               generator=g, device=dev)
        base_mass = u((num,), *cfg.base_mass_range)
        wheel_mass = u((num,), *cfg.wheel_mass_range)
        wheel_inertia = 0.5 * wheel_mass * 0.05**2
        params = params.replace(tire_mu=buckets[assign],
                                wheel_inertia=wheel_inertia)
        return with_mass(params, base_mass)

    def sample_spawn(g, num, dev):
        """A random traversable cell with a random heading
        (visual/mdp/events.py:11-45)."""
        idx = torch.randint(0, spawn_xy.shape[0], (num,), generator=g,
                            device=dev)
        yaw = torch.rand((num,), generator=g, device=dev) * (2 * torch.pi)
        pos = torch.cat([spawn_xy[idx],
                         torch.full((num, 1), REST_H + 0.04, device=dev)], -1)
        return VehicleState.zero((num,), dev).replace(
            pos=pos, quat=wmath.quat_from_yaw(yaw))

    atlas = ColorMapAtlas.build(colormap)
    crop_top = HEIGHT // 3   # the reference crops the top third first
                             # (mdp_sensors/observations.py:78)

    def observe(ctx: StepCtx, g) -> torch.Tensor:
        v = ctx.vehicle
        if cfg.obs_variant == "rgb_flattened":
            cam = camera_rgb_flattened(colormap, v.pos, v.quat)
        else:
            if cfg.exact_render:
                imgs = render(colormap, v.pos, v.quat)[:, crop_top:, :]
            else:
                imgs = render_fast(atlas, v.pos, v.quat, crop_top=crop_top)
            if cfg.enable_corruption:
                imgs = augment_images(imgs, g)             # (B, 40, 80)
            cam = wmath.div(imgs - 0.5, 0.5).reshape(imgs.shape[0], -1)
        lin = ctx.body_lin_vel
        ang = ctx.body_ang_vel
        act = torch.clamp(ctx.last_action, -1.0, 1.0)
        if cfg.enable_corruption:
            u = lambda x: x + (torch.rand(x.shape, generator=g,
                                          device=x.device) * 0.2 - 0.1)
            lin, ang, act = u(lin), u(ang), u(act)
        return torch.cat([cam, lin, ang, act], dim=-1)

    reward_terms = (
        RewardTerm("traversability", 5.0, traversable_reward),
        RewardTerm("vel_rew", 7.0, forward_vel),
    ) if cfg.rewards_enabled else ()

    def traversable_frac(ctx: StepCtx) -> torch.Tensor:
        """Envs on a traversable cell — the task's success metric
        (is_traversable, mushr_visual_env_cfg.py:303-306)."""
        return (colormap.sample(ctx.vehicle.pos[..., :2]) > 0.5).to(
            torch.float32)

    def forward_vel_metric(ctx: StepCtx) -> torch.Tensor:
        return ctx.body_lin_vel[..., 0]

    return TaskModel(
        cfg=env_cfg,
        terrain=terrain,
        obs_dim=VISUAL_OBS_DIM,
        init_params=init_params,
        sample_spawn=sample_spawn,
        reward_terms=reward_terms,
        termination_fns=({"out_range": out_of_map}
                         if cfg.terminations_enabled else {}),
        observe=observe,
        metric_fns={"traversable_frac": traversable_frac,
                    "forward_vel": forward_vel_metric},
        render_grid=(np.asarray(trav, np.float32), float(cfg.cell)),
        colormap=colormap,
    )


def make_visual_env(cfg: VisualTaskCfg = VisualTaskCfg(), device="cuda",
                    seed: int = 0) -> WheeledEnv:
    dev = resolve_device(device)
    return WheeledEnv(make_visual_task(cfg, dev), device=dev, seed=seed)
