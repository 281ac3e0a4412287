"""Procedural traversability map — the port of
`wheeledlab_tpu/tasks/visual/map_gen.py` (reference visual/utils/
__init__.py:78-147: random-walker corridor carving and an asymmetric L1
binary dilation).

Host-side numpy at task-build time, keyed by seed: the same seed gives the
JAX package's grid bit for bit (`np.random.default_rng(seed)`, the same
draws in the same order); or the native C++ generator (`backend="native"`),
whose grid for a seed equals the JAX package's native grid. A [num_rows,
num_cols] bool grid; world x maps to columns and world y to rows
(traversability_utils.py:68-88)."""

from __future__ import annotations

import numpy as np

from ... import native


def generate_path(start_row, start_col, end_row, end_col, grid, rng):
    """Random-order manhattan walk carving 1s (reference :123-147)."""
    row_diff = end_row - start_row
    col_diff = end_col - start_col
    actions = ([(-1, 0) if row_diff < 0 else (1, 0)] * abs(row_diff)
               + [(0, -1) if col_diff < 0 else (0, 1)] * abs(col_diff))
    order = rng.permutation(len(actions))
    r, c = start_row, start_col
    grid[r, c] = True
    for i in order:
        dr, dc = actions[i]
        r += dr
        c += dc
        grid[r, c] = True


def generate_env_map(env_size, sub_group_size, num_walkers, rng):
    """One sub-env worth of corridors (reference :95-121)."""
    rows, cols = env_size
    g_rows, g_cols = sub_group_size
    grid = np.zeros((rows, cols), dtype=bool)
    starts = []
    for i in range(rows // g_rows):
        for j in range(cols // g_cols):
            starts.append((rng.integers(0, g_rows) + i * g_rows,
                           rng.integers(0, g_cols) + j * g_cols))
    for sr, sc in starts:
        for _ in range(num_walkers):
            er, ec = rng.integers(0, rows), rng.integers(0, cols)
            while grid[er, ec]:
                er, ec = rng.integers(0, rows), rng.integers(0, cols)
            generate_path(sr, sc, er, ec, grid, rng)
    return grid


def _binary_dilate(grid: np.ndarray, structure: np.ndarray) -> np.ndarray:
    """Binary dilation (structure origin at its center)."""
    out = np.zeros_like(grid)
    sr, sc = structure.shape
    cr, cc = sr // 2, sc // 2
    for i in range(sr):
        for j in range(sc):
            if not structure[i, j]:
                continue
            dr, dc = i - cr, j - cc
            shifted = np.roll(np.roll(grid, dr, axis=0), dc, axis=1)
            if dr > 0:
                shifted[:dr, :] = False
            elif dr < 0:
                shifted[dr:, :] = False
            if dc > 0:
                shifted[:, :dc] = False
            elif dc < 0:
                shifted[:, dc:] = False
            out |= shifted
    return out


def generate_traversability_map(
    seed: int,
    map_size=(500, 500),
    env_size=(100, 100),
    sub_group_size=(50, 50),
    num_walkers: int = 1,
    backend: str = "numpy",
) -> np.ndarray:
    """Full map: a grid of sub-envs, each carved independently, then dilated
    with the reference's asymmetric L1 structure (visual/utils/
    __init__.py:78-86). backend="native" runs the host C++ generator
    (`wheeledlab_torch/native`): the same algorithm with its own
    deterministic stream, where a C++ toolchain builds it, else the numpy
    path; "numpy" (the default) is the reference-aligned implementation."""
    if backend not in ("numpy", "native"):
        raise ValueError(f"map backend {backend!r}: expected 'numpy' or "
                         "'native'")
    if backend == "native":
        grid = native.generate_traversability_map(
            seed, map_size, env_size, sub_group_size, num_walkers)
        if grid is not None:
            return grid
    rng = np.random.default_rng(seed)
    rows, cols = map_size
    e_rows, e_cols = env_size
    if rows % e_rows or cols % e_cols:
        raise ValueError("map size must be a multiple of the sub-env size")
    grid = np.zeros(map_size, dtype=bool)
    for i in range(rows // e_rows):
        for j in range(cols // e_cols):
            grid[i * e_rows:(i + 1) * e_rows, j * e_cols:(j + 1) * e_cols] = (
                generate_env_map(env_size, sub_group_size, num_walkers, rng))
    structure = np.array([[0, 1, 0], [0, 1, 1], [0, 0, 0]], dtype=bool)
    return _binary_dilate(grid, structure)
