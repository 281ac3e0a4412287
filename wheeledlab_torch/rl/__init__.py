from .networks import ActorCritic  # noqa: F401
from .ppo import PPO, PPOCfg, TrainState, make_learner  # noqa: F401
from .recurrent import ActorCriticRecurrent  # noqa: F401
from .runner import LogCfg, RunConfig, TrainCfg, train  # noqa: F401
from . import run_cfgs  # noqa: F401  (registers the run configs)
