from .actions import ActionMapCfg, action_to_targets, process_actions  # noqa: F401
from .dynamics import ContactAux, step, substep  # noqa: F401
from .terrain import Heightfield, PatchAtlas, TerrainPatch  # noqa: F401
from .types import (  # noqa: F401
    VehicleParams, VehicleState, batch_params, default_f1tenth_params,
    default_mushr_params,
)
