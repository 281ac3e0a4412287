"""Task registry — the port of `wheeledlab_tpu/tasks/__init__.py`: the
drift, elevation and visual tasks. Task ids keep the reference names minus the
"Isaac-" vendor prefix; the old ids are accepted as aliases."""

from __future__ import annotations

from typing import Any, Dict, Optional

from ..envs.env import WheeledEnv
from ..utils.config import TASKS, apply_overrides
from .drift.task import DriftTaskCfg, make_drift_env
from .elevation.task import ElevationTaskCfg, make_elevation_env
from .visual.task import VisualTaskCfg, make_visual_env


def _register_all():
    if "MushrDriftRL-v0" in TASKS:
        return
    # Play variants mirror the reference (mushr_drift_env_cfg.py:410-430):
    # rewards, curriculum and terminations stripped, deterministic resets;
    # DR events and obs corruption stay on. They run the generic step.
    TASKS.register("MushrDriftRL-v0", {
        "cfg": DriftTaskCfg(),
        "play_cfg": DriftTaskCfg(pos_noise=0.0, yaw_noise=0.0,
                                 terminations_enabled=False,
                                 rewards_enabled=False),
        "make": make_drift_env,
    })
    TASKS.register("F1TenthDriftRL-v0", {
        "cfg": DriftTaskCfg(robot="f1tenth", num_envs=256),
        "play_cfg": DriftTaskCfg(robot="f1tenth", num_envs=256,
                                 pos_noise=0.0, yaw_noise=0.0,
                                 terminations_enabled=False,
                                 rewards_enabled=False),
        "make": make_drift_env,
    })
    # the reference's MushrElevationPlayEnvCfg (:472-474) strips nothing;
    # terminations and rewards are stripped as in the other play variants
    TASKS.register("MushrElevationRL-v0", {
        "cfg": ElevationTaskCfg(),
        "play_cfg": ElevationTaskCfg(terminations_enabled=False,
                                     rewards_enabled=False),
        "make": make_elevation_env,
    })
    # the camera policy; its play variant strips terminations and rewards
    # (mushr_visual_env_cfg.py:455-470)
    TASKS.register("MushrVisualRL-v0", {
        "cfg": VisualTaskCfg(),
        "play_cfg": VisualTaskCfg(terminations_enabled=False,
                                  rewards_enabled=False),
        "make": make_visual_env,
    })


def resolve_task(task_name: str) -> Dict[str, Any]:
    _register_all()
    return TASKS.get(task_name.removeprefix("Isaac-"))


def make_env(task_name: str, num_envs: Optional[int] = None,
             overrides: Optional[Dict[str, Any]] = None, play: bool = False,
             device="cuda", seed: int = 0, shard: int = 0,
             use_kernels: Optional[str] = None):
    """Build a task's env (its play variant if `play`) on `device` (CUDA
    unless the caller asks for the CPU); its random draws come from a
    generator seeded with `seed`. `shard` is the env's rank in a job of
    several ranks, which offsets its in-kernel random stream.
    `use_kernels` sets `EnvCfg.use_kernels` ("off": the per-vehicle
    physics of `sim/dynamics.py` through the generic step)."""
    entry = resolve_task(task_name)
    cfg = entry["play_cfg"] if play else entry["cfg"]
    if num_envs is not None:
        cfg = cfg.replace(num_envs=num_envs)
    if overrides:
        cfg = apply_overrides(cfg, dict(overrides))
    env = entry["make"](cfg, device=device, seed=seed)
    if use_kernels is not None:
        task = env.task._replace(
            cfg=env.task.cfg.replace(use_kernels=use_kernels))
        env = WheeledEnv(task, device=device, seed=seed)
    env.task_cfg = cfg  # the resolved task-level cfg, for introspection
    env.shard = shard
    return env
