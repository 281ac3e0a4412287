from .task import ElevationTaskCfg, make_elevation_env, make_elevation_task  # noqa: F401
from .terrain_gen import generate_elevation_terrain  # noqa: F401
