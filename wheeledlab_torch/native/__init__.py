"""ctypes loader of the port's host C++ library (`wheeledlab_native.cpp`:
traversability map generation, trajectory rasterization) — the port of
`wheeledlab_tpu/native/__init__.py`, with its own copy of the source.

The library is compiled with the host C++ compiler at first use into
`wheeledlab_torch/_build/` (`ops/build.py::build_host`). Its callers
(`tasks/visual/map_gen.py`, `render/topdown.py`) draw with numpy where no
C++ toolchain builds it, as the reference's do."""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "wheeledlab_native.cpp")
_lib: Optional[ctypes.CDLL] = None
_tried = False


def load() -> Optional[ctypes.CDLL]:
    """The library, built on the first call; None without a toolchain."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    from ..ops.build import build_host

    path = build_host(SOURCE)
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(path)
    except OSError:
        return None
    lib.wl_generate_traversability_map.argtypes = [
        ctypes.c_uint64] + [ctypes.c_int64] * 7 + [
        ctypes.POINTER(ctypes.c_uint8)]
    lib.wl_rasterize_trajectories.argtypes = [
        ctypes.c_int64] * 4 + [
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8)]
    _lib = lib
    return _lib


def available() -> bool:
    return load() is not None


def generate_traversability_map(seed: int, map_size, env_size,
                                sub_group_size, num_walkers: int
                                ) -> Optional[np.ndarray]:
    """Native map generation; None if the library is unavailable.
    Deterministic in `seed`, from the library's own SplitMix64 stream: a
    different sample of the same map distribution as the numpy path."""
    lib = load()
    if lib is None:
        return None
    rows, cols = map_size
    grid = np.zeros((rows, cols), dtype=np.uint8)
    lib.wl_generate_traversability_map(
        ctypes.c_uint64(seed), rows, cols, env_size[0], env_size[1],
        sub_group_size[0], sub_group_size[1], num_walkers,
        grid.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return grid.astype(bool)


def rasterize_trajectories(frames: np.ndarray, positions_px: np.ndarray,
                           yaws: Optional[np.ndarray],
                           colors: np.ndarray, trail: int) -> bool:
    """Draw trails, disks and heading dots in place onto background-filled
    frames (T, size, size, 3) uint8 from pixel positions (T, B, 2), yaws
    (T, B) and colors (B, 3). False when the library is unavailable (the
    caller draws with numpy)."""
    lib = load()
    if lib is None:
        return False
    T, size = frames.shape[0], frames.shape[1]
    B = positions_px.shape[1]
    pos = np.ascontiguousarray(positions_px, dtype=np.float32)
    yaw_ptr = None
    if yaws is not None:
        yaws = np.ascontiguousarray(yaws, dtype=np.float32)
        yaw_ptr = yaws.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
    colors = np.ascontiguousarray(colors, dtype=np.uint8)
    lib.wl_rasterize_trajectories(
        T, B, size, trail,
        pos.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        yaw_ptr, colors.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        frames.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return True
