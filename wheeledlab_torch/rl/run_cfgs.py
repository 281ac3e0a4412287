"""Named run configs — the port of `wheeledlab_tpu/rl/run_cfgs.py` for the
drift slice (reference configs/runs/rss_cfgs.py:8-53,
runs/f1tenth_cfgs.py:7-21). RSS_ELEV_CONFIG, RSS_VISUAL_CONFIG,
ELEV_GOAL_CONFIG, RSS_DRIFT_RNN_CONFIG and POD_DRIFT_CONFIG are registered
when their tasks, learner and multi-process training are ported."""

from __future__ import annotations

from ..utils.config import RUN_CONFIGS
from .ppo import PPOCfg
from .runner import LogCfg, RunConfig, TrainCfg

DRIFT_PPO = PPOCfg(activation="elu")

RSS_DRIFT_CONFIG = RunConfig(
    task_name="MushrDriftRL-v0",
    num_envs=1024,
    train=TrainCfg(num_iterations=5000, log=LogCfg()),
    agent=DRIFT_PPO,
)

F1TENTH_DRIFT_CONFIG = RunConfig(
    task_name="F1TenthDriftRL-v0",
    num_envs=1024,
    train=TrainCfg(num_iterations=1500, log=LogCfg()),
    agent=DRIFT_PPO,
)

for _name in ("RSS_DRIFT_CONFIG", "F1TENTH_DRIFT_CONFIG"):
    RUN_CONFIGS.register(_name, globals()[_name])
