from .topdown import render_drift_frames, save_video  # noqa: F401
