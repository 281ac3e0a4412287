from .task import VisualTaskCfg, make_visual_env, make_visual_task  # noqa: F401
from .camera import ColorMap, render  # noqa: F401
from .map_gen import generate_traversability_map  # noqa: F401
