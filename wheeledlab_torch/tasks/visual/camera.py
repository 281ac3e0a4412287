"""Batched camera of the visual task — the port of
`wheeledlab_tpu/tasks/visual/camera.py` (the replacement for the reference's
RTX TiledCamera).

The visual world is a flat colored grid (white traversable corridors on
black), so each pixel is one ray-ground intersection and one map lookup.
Camera model (reference mushr_visual_env_cfg.py:230-246): PinholeCameraCfg
focal length 1.93 mm, apertures 3.896 x 2.453 mm, 80 x 60, mounted 8 cm
forward and 10 cm up on the chassis, facing +x.

Every renderer takes batched poses (B, 3) and (B, 4), or one pose, on the
device of its map. The arithmetic keeps the reference's operand order, so a
pixel can differ from the JAX package's only where a hit point lies within an
ulp of a cell edge.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from ...utils import math as wmath

WIDTH, HEIGHT = 80, 60
FOCAL = 1.9299999475479126
APERTURE_H = 3.8959999084472656
APERTURE_V = 2.453000068664551
CAM_OFFSET_B = np.array([0.08, 0.0, 0.10], np.float32)  # camera_link, body
LUMA = np.array([0.299, 0.587, 0.114], np.float32)      # torchvision gray


def _pixel_rays() -> np.ndarray:
    """Unit ray directions in the camera frame (x forward, y left, z up),
    (HEIGHT, WIDTH, 3), pixel (0, 0) top-left; float32 numpy, computed as
    the reference computes them, so the table is the same bits."""
    us = ((np.arange(WIDTH, dtype=np.float32) + 0.5) / WIDTH - 0.5).astype(
        np.float32)
    vs = ((np.arange(HEIGHT, dtype=np.float32) + 0.5) / HEIGHT - 0.5).astype(
        np.float32)
    # forward x = focal dir; left y = -u * aperture; up z = -v * aperture
    y = -(us * np.float32(APERTURE_H))[None, :].repeat(HEIGHT, 0)
    z = -(vs * np.float32(APERTURE_V))[:, None].repeat(WIDTH, 1)
    x = np.full((HEIGHT, WIDTH), FOCAL, np.float32)
    d = np.stack([x, y, z], axis=-1)
    norm = np.sqrt((d * d).sum(-1, keepdims=True, dtype=np.float32))
    return (d / norm).astype(np.float32)


_RAYS = _pixel_rays()


@functools.lru_cache(maxsize=None)
def _rays(device: torch.device, crop_top: int = 0) -> torch.Tensor:
    """The ray table from row `crop_top` down, on `device`."""
    return torch.as_tensor(_RAYS[crop_top:], device=device).contiguous()


@functools.lru_cache(maxsize=None)
def _const(device: torch.device, name: str) -> torch.Tensor:
    return torch.as_tensor({"offset": CAM_OFFSET_B, "luma": LUMA}[name],
                           device=device)


def _batched(fn):
    """Let a renderer take one pose ((3,), (4,)) as well as a batch."""

    @functools.wraps(fn)
    def wrapper(source, pos, quat, *args, **kwargs):
        if pos.ndim == 1:
            return fn(source, pos[None], quat[None], *args, **kwargs)[0]
        return fn(source, pos, quat, *args, **kwargs)

    return wrapper


def camera_position(pos: torch.Tensor, quat: torch.Tensor) -> torch.Tensor:
    """World position of the camera for body poses (B, 3), (B, 4)."""
    offset = _const(pos.device, "offset").expand(pos.shape)
    return pos + wmath.quat_rotate(quat, offset)


@dataclasses.dataclass(frozen=True)
class ColorMap:
    """World-grid color source: grid[row, col] in [0, 1]; world x -> col,
    y -> row (reference traversability_utils.py:68-88)."""

    grid: torch.Tensor            # (rows, cols) f32 intensity
    cell: float                   # spacing (a float32 value), 0.5 m
    rows: int = 500
    cols: int = 500
    grid_rgb: Optional[torch.Tensor] = None   # (rows, cols, 3) RGB world

    @property
    def width(self) -> float:
        return self.cols * float(self.cell)   # world x extent

    @property
    def height(self) -> float:
        return self.rows * float(self.cell)   # world y extent

    def cell_index(self, x: torch.Tensor, y: torch.Tensor):
        """Nearest-cell (row, col) of world points, clamped to the map: the
        reference's order, floor((x + width/2) / cell), then the clamp
        (TraversabilityHashmapUtil.get_map_id)."""
        col = torch.floor(wmath.div(x + self.width / 2, self.cell)).long()
        row = torch.floor(wmath.div(y + self.height / 2, self.cell)).long()
        return (torch.clamp(row, 0, self.rows - 1),
                torch.clamp(col, 0, self.cols - 1))

    def sample(self, xy: torch.Tensor) -> torch.Tensor:
        """Nearest-cell intensity at world xy: (..., 2) -> (...)."""
        row, col = self.cell_index(xy[..., 0], xy[..., 1])
        return self.grid[row, col]

    def sample_rgb(self, xy: torch.Tensor) -> torch.Tensor:
        """Nearest-cell RGB at world xy: (..., 2) -> (..., 3); the grayscale
        grid replicated when no RGB world was built."""
        row, col = self.cell_index(xy[..., 0], xy[..., 1])
        if self.grid_rgb is None:
            g = self.grid[row, col]
            return torch.stack([g, g, g], dim=-1)
        return self.grid_rgb[row, col]


@dataclasses.dataclass(frozen=True)
class ColorMapAtlas:
    """The (p, p) color-map windows at `stride`-cell anchors that the fast
    renderer samples. Pixels whose hit falls outside the env's window (the
    2-3 pixel rows nearest the horizon on a level pose) clamp to the window's
    border: the reference's deliberate far-field approximation, kept so that
    the images are the same. The windows are read in place from `grid`."""

    grid: torch.Tensor            # (map_rows, map_cols) the map itself
    cell: float
    p: int = 40
    stride: int = 8
    nar: int = 1                  # window anchors along rows
    nac: int = 1                  # and along columns
    map_rows: int = 500
    map_cols: int = 500

    @classmethod
    def build(cls, colormap: ColorMap, p: int = 40,
              stride: int = 8) -> "ColorMapAtlas":
        R, C = colormap.grid.shape
        nar = max((R - p + stride - 1) // stride + 1, 1)
        nac = max((C - p + stride - 1) // stride + 1, 1)
        return cls(grid=colormap.grid.contiguous(), cell=colormap.cell, p=p,
                   stride=stride, nar=nar, nac=nac, map_rows=R, map_cols=C)

    @property
    def width(self) -> float:
        return self.map_cols * float(self.cell)

    @property
    def height(self) -> float:
        return self.map_rows * float(self.cell)

    def extract(self, x: torch.Tensor, y: torch.Tensor):
        """Window anchors (sr, sc) of the windows at world points (B,):
        the anchor index rounds half to even, clamps to the atlas, and the
        last window is shifted to end at the map's edge."""
        p, s = self.p, self.stride
        col_f = wmath.div(x + self.width / 2, self.cell)
        row_f = wmath.div(y + self.height / 2, self.cell)
        ir = torch.clamp(torch.round(wmath.div(row_f - p / 2.0, s)).long(),
                         0, self.nar - 1)
        ic = torch.clamp(torch.round(wmath.div(col_f - p / 2.0, s)).long(),
                         0, self.nac - 1)
        return (torch.clamp(ir * s, max=self.map_rows - p),
                torch.clamp(ic * s, max=self.map_cols - p))

    def sample_patch_xy(self, sr: torch.Tensor, sc: torch.Tensor,
                        x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """`ColorMap.sample` restricted to the window at (sr, sc) (B,), of
        points x, y (B, ...); points outside the window clamp to its border.
        The reference selects the cell with one-hot row and column
        contractions (camera.py:151-162), a workaround for the TPU's slow
        gather; a gather of the same cell gives the same value."""
        p = self.p
        shape = (-1,) + (1,) * (x.ndim - 1)
        sr, sc = sr.reshape(shape), sc.reshape(shape)
        col = torch.floor(wmath.div(x + self.width / 2, self.cell)).long()
        row = torch.floor(wmath.div(y + self.height / 2, self.cell)).long()
        row = sr + torch.clamp(row - sr, 0, p - 1)
        col = sc + torch.clamp(col - sc, 0, p - 1)
        return self.grid.reshape(-1)[row * self.map_cols + col]


def near_split_row(crop_top: int, near_slack_m: float,
                   cam_z_max: float = 0.25, margin_deg: float = 5.0) -> int:
    """First cropped-image row whose whole row hits the ground within
    `near_slack_m` of the camera for any attitude within `margin_deg` of
    level: the static far/near split of the two-window renderer."""
    rz = _RAYS[crop_top:, :, 2]
    dep = -np.arcsin(np.clip(rz, -1.0, 1.0))          # depression, rad
    dep_worst = dep - np.deg2rad(margin_deg)
    row_min = dep_worst.min(axis=1)
    safe = np.tan(np.maximum(row_min, 1e-3)) >= cam_z_max / near_slack_m
    idx = np.nonzero(safe)[0]
    return int(idx[0]) if idx.size else rz.shape[0]


def ground_hits_planar(pos: torch.Tensor, quat: torch.Tensor,
                       crop_top: int = 0):
    """Ground hits of the rays from row `crop_top` down for poses (B, 3),
    (B, 4), with the rays rotated by the planar rotation of the fast
    renderer: (camera position (B, 3), hit x, hit y, ray z (B, h, W))."""
    cam = camera_position(pos, quat)
    rays = _rays(pos.device, crop_top)
    rx, ry, rz = rays[..., 0], rays[..., 1], rays[..., 2]
    q = quat[:, :, None, None]
    qw, qx, qy, qz = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    r00 = 1 - 2 * (qy * qy + qz * qz)
    r01 = 2 * (qx * qy - qw * qz)
    r02 = 2 * (qx * qz + qw * qy)
    r10 = 2 * (qx * qy + qw * qz)
    r11 = 1 - 2 * (qx * qx + qz * qz)
    r12 = 2 * (qy * qz - qw * qx)
    r20 = 2 * (qx * qz - qw * qy)
    r21 = 2 * (qy * qz + qw * qx)
    r22 = 1 - 2 * (qx * qx + qy * qy)
    dx = r00 * rx + r01 * ry + r02 * rz               # (B, h, W)
    dy = r10 * rx + r11 * ry + r12 * rz
    dz = r20 * rx + r21 * ry + r22 * rz
    c = cam[:, :, None, None]
    t = -c[:, 2] / torch.where(dz < -1e-6, dz, -1e-6)
    return cam, c[:, 0] + t * dx, c[:, 1] + t * dy, dz


@_batched
def render_fast(atlas: ColorMapAtlas, pos: torch.Tensor, quat: torch.Tensor,
                crop_top: int = 0,
                near_atlas: Optional[ColorMapAtlas] = None) -> torch.Tensor:
    """Window-atlas render: (B, HEIGHT - crop_top, WIDTH) grayscale, the
    top `crop_top` rows dropped (the visual obs discards the top third,
    reference mdp_sensors/observations.py:78). With `near_atlas`, the rows
    that surely hit the ground near the camera sample its smaller window."""
    cam, hx, hy, dz = ground_hits_planar(pos, quat, crop_top)
    sr, sc = atlas.extract(cam[:, 0], cam[:, 1])
    split = (near_split_row(
        crop_top, (near_atlas.p / 2 - near_atlas.stride / 2 - 1)
        * float(near_atlas.cell)) if near_atlas is not None else None)
    if split is None or split >= hx.shape[1]:
        color = atlas.sample_patch_xy(sr, sc, hx, hy)
    else:
        nsr, nsc = near_atlas.extract(cam[:, 0], cam[:, 1])
        color = torch.cat([
            atlas.sample_patch_xy(sr, sc, hx[:, :split], hy[:, :split]),
            near_atlas.sample_patch_xy(nsr, nsc, hx[:, split:],
                                       hy[:, split:]),
        ], dim=1)
    return torch.where(dz < -1e-6, color, 0.0)


def ground_hits(pos: torch.Tensor, quat: torch.Tensor):
    """Ground hits of every ray for poses (B, 3), (B, 4), the rays rotated
    by `quat_rotate` as the exact renderers do: (hit xy (B, H, W, 2), ray
    length to the ground t, ray z (B, H, W))."""
    cam = camera_position(pos, quat)
    d = wmath.quat_rotate(quat[:, None, None, :], _rays(pos.device)[None])
    dz = d[..., 2]
    t = -cam[:, None, None, 2] / torch.where(dz < -1e-6, dz, -1e-6)
    return cam[:, None, None, :2] + t[..., None] * d[..., :2], t, dz


@_batched
def render(colormap: ColorMap, pos: torch.Tensor,
           quat: torch.Tensor) -> torch.Tensor:
    """Exact grayscale render (B, HEIGHT, WIDTH): t = -o_z / d_z for rays
    that point down; pixels above the horizon are 0 (the black world edge)."""
    hit, _, dz = ground_hits(pos, quat)
    return torch.where(dz < -1e-6, colormap.sample(hit), 0.0)


@_batched
def render_rgb(colormap: ColorMap, pos: torch.Tensor,
               quat: torch.Tensor) -> torch.Tensor:
    """Exact RGB render (B, HEIGHT, WIDTH, 3), the `camera_data_rgb` sensor
    output (reference visual/mdp_sensors/observations.py:60-62)."""
    hit, _, dz = ground_hits(pos, quat)
    return torch.where((dz < -1e-6)[..., None], colormap.sample_rgb(hit),
                       0.0)


def camera_rgb_flattened(colormap: ColorMap, pos: torch.Tensor,
                         quat: torch.Tensor) -> torch.Tensor:
    """Non-augmented flattened camera obs through the RGB path — the
    reference's camera_data_rgb_flattened (observations.py:64-73): crop the
    top third, grayscale, (x - 0.5) / 0.5, flatten."""
    crop = HEIGHT // 3
    rgb = render_rgb(colormap, pos, quat)[..., crop:, :, :]
    gray = rgb @ _const(rgb.device, "luma")
    norm = wmath.div(gray - 0.5, 0.5)
    return norm.reshape(norm.shape[:-2] + (-1,))


def render_depth(pos: torch.Tensor, quat: torch.Tensor) -> torch.Tensor:
    """Distance along each ray to the ground plane (B, HEIGHT, WIDTH), the
    `camera_data_depth` obs variant (reference observations.py:89-91);
    pixels above the horizon clamp to the far clip (100 m)."""
    if pos.ndim == 1:
        return render_depth(pos[None], quat[None])[0]
    far = 100.0
    _, t, dz = ground_hits(pos, quat)
    return torch.where(dz < -1e-6, torch.clamp(t, max=far), far)


def _linspace(start: float, stop: float, num: int,
              endpoint: bool = True) -> np.ndarray:
    """float32 `jnp.linspace`'s formula: start * (1 - step) + stop * step
    with step = iota / div (XLA rounds some entries an ulp apart)."""
    div = num - 1 if endpoint else num
    step = np.arange(div, dtype=np.float32) / np.float32(div)
    out = (np.float32(start) * (np.float32(1) - step)
           + np.float32(stop) * step)
    if endpoint:
        out = np.concatenate([out, [np.float32(stop)]])
    return out.astype(np.float32)


@_batched
def lidar_ranges(colormap: ColorMap, pos: torch.Tensor, quat: torch.Tensor,
                 num_beams: int = 360,
                 max_range: float = 10.0) -> torch.Tensor:
    """Planar lidar ranges to non-traversable cells (B, num_beams) — the
    `lidar_ranges` obs term (reference observations.py:25-33, unused by the
    registered tasks): the first of 64 samples along a beam whose cell is
    not traversable, else `max_range`."""
    dev = pos.device
    angles = torch.as_tensor(_linspace(0.0, 2 * np.pi, num_beams,
                                       endpoint=False), device=dev)
    ts = torch.as_tensor(_linspace(0.1, max_range, 64), device=dev)
    a = wmath.yaw_from_quat(quat)[:, None] + angles       # (B, beams)
    px = pos[:, 0, None, None] + ts * torch.cos(a)[..., None]
    py = pos[:, 1, None, None] + ts * torch.sin(a)[..., None]
    blocked = colormap.sample(torch.stack([px, py], -1)) <= 0.5
    first = torch.argmax(blocked.to(torch.uint8), dim=-1)
    return torch.where(blocked.any(-1), ts[first], max_range)


def lidar_ranges_normalized(colormap: ColorMap, pos: torch.Tensor,
                            quat: torch.Tensor, generator: torch.Generator,
                            num_beams: int = 360, max_range: float = 10.0,
                            noise_std: float = 0.1) -> torch.Tensor:
    """Noisy normalized lidar (reference observations.py:35-59)."""
    r = lidar_ranges(colormap, pos, quat, num_beams, max_range)
    r = r + noise_std * torch.randn(r.shape, generator=generator,
                                    device=r.device)
    return wmath.div(torch.clamp(r, 0.0, max_range), max_range)
