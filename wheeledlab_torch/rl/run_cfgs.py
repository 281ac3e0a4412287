"""Named run configs — the port of `wheeledlab_tpu/rl/run_cfgs.py` for the
drift, elevation and visual tasks (reference configs/runs/rss_cfgs.py:8-53,
runs/f1tenth_cfgs.py:7-21), the recurrent drift variant and the
multi-process POD_DRIFT_CONFIG."""

from __future__ import annotations

from ..utils.config import RUN_CONFIGS
from .ppo import PPOCfg
from .runner import LogCfg, RunConfig, TrainCfg

DRIFT_PPO = PPOCfg(activation="elu")
# the wide-observation tasks run the actor's and the critic's first layers
# as one product (`networks.fused_actor_critic_apply`); drift keeps the
# plain apply, whose bits its goldens pin
ELEV_PPO = PPOCfg(activation="relu", fuse_input_layer=True)
VISUAL_PPO = PPOCfg(activation="relu", fuse_input_layer=True)

RSS_DRIFT_CONFIG = RunConfig(
    task_name="MushrDriftRL-v0",
    num_envs=1024,
    train=TrainCfg(num_iterations=5000, log=LogCfg()),
    agent=DRIFT_PPO,
)

RSS_ELEV_CONFIG = RunConfig(
    task_name="MushrElevationRL-v0",
    num_envs=1024,
    train=TrainCfg(num_iterations=4000, log=LogCfg()),
    agent=ELEV_PPO,
)

RSS_VISUAL_CONFIG = RunConfig(
    task_name="MushrVisualRL-v0",
    num_envs=512,
    train=TrainCfg(num_iterations=4000, log=LogCfg()),
    agent=VISUAL_PPO,
    # world-side color DR on for the named run; the task's default stays
    # off, as the reference's registered cfg (mushr_visual_env_cfg.py:110)
    env_overrides={"color_sampling": True},
)

# Goal-seeking elevation variant (beyond the reference's registered
# surface): the same task reweighted so that reaching the goal pays
ELEV_GOAL_CONFIG = RunConfig(
    task_name="MushrElevationRL-v0",
    num_envs=1024,
    train=TrainCfg(num_iterations=1500, log=LogCfg()),
    agent=ELEV_PPO,
    env_overrides={"goal_weight": 200.0, "height_weight": 500.0,
                   "at_goal_bonus": 200000.0},
)

F1TENTH_DRIFT_CONFIG = RunConfig(
    task_name="F1TenthDriftRL-v0",
    num_envs=1024,
    train=TrainCfg(num_iterations=1500, log=LogCfg()),
    agent=DRIFT_PPO,
)

# Recurrent drift variant: the rsl_rl ActorCriticRecurrent family (beyond
# the reference's registered configs, which all use the plain ActorCritic,
# rsl_rl_ppo_cfg.py:12); LSTM-256, one layer, separate actor and critic
# chains
RSS_DRIFT_RNN_CONFIG = RunConfig(
    task_name="MushrDriftRL-v0",
    num_envs=1024,
    train=TrainCfg(num_iterations=1500, log=LogCfg()),
    agent=DRIFT_PPO.replace(policy_class="ActorCriticRecurrent"),
)

# Data-parallel drift at 65,536 envs, split over the ranks of a
# torch.distributed job; `distributed="on"` makes one command launch it
# (reference parity: train_rl.py:33-116 runs any named config):
#     python -m wheeledlab_torch.cli.train -r POD_DRIFT_CONFIG
#     torchrun --nproc_per_node N -m wheeledlab_torch.cli.train -r POD_DRIFT_CONFIG
POD_DRIFT_CONFIG = RunConfig(
    task_name="MushrDriftRL-v0",
    num_envs=65536,
    train=TrainCfg(num_iterations=5000, distributed="on", log=LogCfg()),
    agent=DRIFT_PPO,
)

for _name in ("RSS_DRIFT_CONFIG", "RSS_ELEV_CONFIG", "RSS_VISUAL_CONFIG",
              "ELEV_GOAL_CONFIG", "F1TENTH_DRIFT_CONFIG",
              "RSS_DRIFT_RNN_CONFIG", "POD_DRIFT_CONFIG"):
    RUN_CONFIGS.register(_name, globals()[_name])
