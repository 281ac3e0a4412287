from .env import (  # noqa: F401
    CommandCfg, CurriculumTerm, EnvCfg, EnvState, PushEvent, RewardTerm,
    StepCtx, StepOutput, TaskModel, WheeledEnv,
)
