from .observations import BLIND_OBS_DIM, blind_obs  # noqa: F401
