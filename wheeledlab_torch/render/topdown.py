"""Top-down trajectory rendering — the port of
`wheeledlab_tpu/render/topdown.py` (the training-video equivalent of the
reference's CustomRecordVideo, custom_video_recorder.py:12-75). Video frames
are rasterized on the host from logged trajectories: by the port's native
C++ library (`wheeledlab_torch/native`: trails, disks, headings) where a C++
toolchain builds it, else by numpy, as the JAX package does. Encoded with
PyAV (H.264) or OpenCV (MPEG-4) where one is installed, else saved as a .npy
frame stack: there is no hard video dependency."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from .. import native


def _draw_disk(img: np.ndarray, cx: float, cy: float, r: float, color) -> None:
    h, w, _ = img.shape
    y0, y1 = max(int(cy - r), 0), min(int(cy + r) + 1, h)
    x0, x1 = max(int(cx - r), 0), min(int(cx + r) + 1, w)
    if y0 >= y1 or x0 >= x1:
        return
    ys, xs = np.mgrid[y0:y1, x0:x1]
    mask = (ys - cy) ** 2 + (xs - cx) ** 2 <= r * r
    img[y0:y1, x0:x1][mask] = color


def render_drift_frames(
    positions: np.ndarray,           # (T, B, 2) world xy
    yaws: Optional[np.ndarray] = None,  # (T, B)
    size: int = 400,
    extent: float = 3.0,
    track: Tuple[float, float, float, float] = (0.8, 0.8, 0.3, 2.0),
    max_cars: int = 16,
    trail: int = 25,
) -> np.ndarray:
    """Rasterize (T, size, size, 3) uint8 frames: oval track + car trails.

    `track` = (line_radius, straight, corner_in, corner_out) — the reference
    drift constants (mushr_drift_env_cfg.py:27-32)."""
    line_r, straight, r_in, r_out = track
    T, B = positions.shape[:2]
    B = min(B, max_cars)
    scale = size / (2 * extent)

    def to_px(xy):
        return (xy[..., 0] * scale + size / 2, size / 2 - xy[..., 1] * scale)

    # static background: track boundaries + center line
    bg = np.full((size, size, 3), 30, np.uint8)
    ys, xs = np.mgrid[0:size, 0:size].astype(np.float32)
    wx = (xs - size / 2) / scale
    wy = (size / 2 - ys) / scale
    on_straight = np.abs(wy) < straight
    d_corner = np.where(
        wy > 0,
        np.sqrt(wx**2 + (wy - straight) ** 2),
        np.sqrt(wx**2 + (wy + straight) ** 2))
    d = np.where(on_straight, np.abs(wx), d_corner)
    band = lambda r, w: np.abs(d - r) < w
    bg[band(r_in, 0.03)] = (90, 60, 60)
    bg[band(r_out, 0.03)] = (90, 60, 60)
    bg[band(line_r, 0.015)] = (70, 70, 110)

    colors = (np.stack([
        64 + 191 * np.abs(np.sin(np.arange(B))),
        64 + 191 * np.abs(np.sin(np.arange(B) * 1.7 + 1)),
        64 + 191 * np.abs(np.sin(np.arange(B) * 2.3 + 2)),
    ], -1)).astype(np.uint8)

    frames = np.empty((T, size, size, 3), np.uint8)
    frames[:] = bg

    # the native C++ rasterizer, where it builds
    px = positions[:, :B, 0] * scale + size / 2
    py = size / 2 - positions[:, :B, 1] * scale
    pos_px = np.stack([px, py], axis=-1).astype(np.float32)
    if native.rasterize_trajectories(
            frames, pos_px, None if yaws is None else yaws[:, :B],
            colors, trail):
        return frames

    for t in range(T):
        frame = bg.copy()
        for b in range(B):
            t0 = max(0, t - trail)
            px, py = to_px(positions[t0:t + 1, b])
            for i in range(len(px) - 1):
                _draw_disk(frame, px[i], py[i], 1.0, colors[b] // 2)
            cx, cy = to_px(positions[t, b])
            _draw_disk(frame, cx, cy, 3.5, colors[b])
            if yaws is not None:
                hx = cx + 6 * np.cos(yaws[t, b])
                hy = cy - 6 * np.sin(yaws[t, b])
                _draw_disk(frame, hx, hy, 1.5, colors[b])
        frames[t] = frame
    return frames


def render_map_frames(
    positions: np.ndarray,            # (T, B, 2) world xy
    background_grid: np.ndarray,      # (rows, cols) intensity or height
    cell: float,
    yaws: Optional[np.ndarray] = None,
    goals: Optional[np.ndarray] = None,   # (T, B, 2) goal xy (elevation task)
    size: int = 480,
    max_cars: int = 16,
    trail: int = 40,
) -> np.ndarray:
    """Top-down frames over a grid-world background (visual task map or
    elevation heightfield): the cars and, when given, the goals. Grid
    convention: world x -> cols, y -> rows, centered at the origin. The
    native rasterizer draws each car's trail and heading too; the numpy
    fallback draws the car disks alone, as the reference's does."""
    rows, cols = background_grid.shape
    extent = max(rows, cols) * cell / 2
    scale = size / (2 * extent)
    T, B = positions.shape[:2]
    B = min(B, max_cars)

    # background: sample grid under each pixel
    ys, xs = np.mgrid[0:size, 0:size].astype(np.float32)
    wx = (xs - size / 2) / scale
    wy = (size / 2 - ys) / scale
    ci = np.clip(((wx + cols * cell / 2) / cell).astype(int), 0, cols - 1)
    ri = np.clip(((wy + rows * cell / 2) / cell).astype(int), 0, rows - 1)
    g = background_grid[ri, ci].astype(np.float32)
    g = (g - g.min()) / max(g.max() - g.min(), 1e-6)
    bg = np.stack([30 + 160 * g] * 3, axis=-1).astype(np.uint8)

    colors = (np.stack([
        64 + 191 * np.abs(np.sin(np.arange(B))),
        64 + 191 * np.abs(np.sin(np.arange(B) * 1.7 + 1)),
        64 + 191 * np.abs(np.sin(np.arange(B) * 2.3 + 2)),
    ], -1)).astype(np.uint8)

    frames = np.empty((T, size, size, 3), np.uint8)
    frames[:] = bg

    px = positions[:, :B, 0] * scale + size / 2
    py = size / 2 - positions[:, :B, 1] * scale
    pos_px = np.stack([px, py], axis=-1).astype(np.float32)
    if not native.rasterize_trajectories(
            frames, pos_px, None if yaws is None else yaws[:, :B], colors,
            trail):
        for t in range(T):
            for b in range(B):
                _draw_disk(frames[t], pos_px[t, b, 0], pos_px[t, b, 1], 3.5,
                           colors[b])
    if goals is not None:
        for t in range(T):
            for b in range(B):
                gx = goals[t, b, 0] * scale + size / 2
                gy = size / 2 - goals[t, b, 1] * scale
                _draw_disk(frames[t], gx, gy, 2.5, (255, 255, 255))
    return frames


def render_task_frames(
    env,
    task_name: str,
    positions: np.ndarray,                # (T, B, 2)
    yaws: Optional[np.ndarray] = None,    # (T, B)
    goals: Optional[np.ndarray] = None,   # (T, B, 2) command xy
) -> np.ndarray:
    """Render with the renderer that matches the task's world (parity with
    the reference's per-env RTX recordings, custom_video_recorder.py:44-75):
    oval track for drift, heightfield/traversability-map background (with
    goal markers when the task has commands) for elevation/visual. Used by
    both the training-time recorder (rl/runner.py) and the play CLI
    (cli/play.py)."""
    del task_name  # dispatch is on the task model, not the name
    if env.task.render_grid is not None:
        grid, cell = env.task.render_grid
        if env.task.command is None:
            goals = None
        return render_map_frames(positions, np.asarray(grid, np.float32),
                                 float(cell), yaws=yaws, goals=goals)
    return render_drift_frames(positions, yaws)


def save_video(frames: np.ndarray, path: str, fps: int = 50,
               resolution: Optional[Tuple[int, int]] = None,
               crf: int = 30) -> str:
    """Encode (T, H, W, 3) uint8 frames to a video file (parity: the
    reference's CustomRecordVideo PyAV H.264 encode,
    custom_video_recorder.py:12-75). Encoder preference: PyAV H.264 ->
    OpenCV MPEG-4 (.mp4) -> raw .npy dump as the last resort.

    `resolution` (W, H) resizes the frames before encoding (reference
    LogConfig.video_resolution, common_cfg.py:28); `crf` is the H.264
    constant rate factor (common_cfg.py:29) — honored on the PyAV path
    only (MPEG-4/npy fallbacks have no CRF)."""
    if resolution and tuple(resolution) != frames.shape[2:0:-1]:
        w_out, h_out = int(resolution[0]), int(resolution[1])
        yi = (np.arange(h_out) * frames.shape[1] // h_out).astype(np.intp)
        xi = (np.arange(w_out) * frames.shape[2] // w_out).astype(np.intp)
        frames = frames[:, yi[:, None], xi[None, :], :]
    try:
        import av  # noqa: F401

        container = av.open(path, "w")
        stream = container.add_stream("h264", rate=fps)
        stream.height, stream.width = frames.shape[1:3]
        stream.pix_fmt = "yuv420p"
        stream.options = {"crf": str(crf)}
        for f in frames:
            for packet in stream.encode(
                    av.VideoFrame.from_ndarray(f, format="rgb24")):
                container.mux(packet)
        for packet in stream.encode():
            container.mux(packet)
        container.close()
        return path
    except ImportError:
        pass
    try:
        import cv2

        alt = path.rsplit(".", 1)[0] + ".mp4"
        h, w = frames.shape[1:3]
        writer = cv2.VideoWriter(
            alt, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
        if writer.isOpened():
            for f in frames:
                writer.write(f[:, :, ::-1])  # RGB -> BGR
            writer.release()
            return alt
        writer.release()
    except ImportError:
        pass
    alt = path.rsplit(".", 1)[0] + ".npy"
    np.save(alt, frames)
    return alt
