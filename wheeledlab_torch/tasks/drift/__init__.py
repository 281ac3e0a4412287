from .task import DriftTaskCfg, make_drift_env, make_drift_task  # noqa: F401
