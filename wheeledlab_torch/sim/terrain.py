"""Terrain as a batched height function — the port of
`wheeledlab_tpu/sim/terrain.py` (`Heightfield`, `TerrainPatch`,
`PatchAtlas`).

A terrain is a regular heightfield on the device; a flat plane is the
degenerate (1, 1) grid. The atlas of (p, p) windows is built once on the
host with numpy, exactly as the reference builds it, and moved to the
device. A `TerrainPatch` is one (p, p) window per env, batched over a
leading env axis (the reference's is one env's, under `vmap`). The
reference's one-hot contractions and masked corner sums are TPU workarounds
for the missing hardware gather; here every lookup is a direct gather of
the four bilinear corners, with the same interpolation expressions in the
same operand order.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ..utils.math import div


@dataclasses.dataclass
class Heightfield:
    """Regular-grid heightfield centered at the origin: height[i, j] is the
    terrain height at x = (i - (nx-1)/2) * cell, y = (j - (ny-1)/2) * cell.
    `cell` and `friction` are float32 values held as Python floats."""

    height: torch.Tensor     # (nx, ny) f32 heights in meters
    cell: float              # grid spacing in meters
    friction: float          # ground friction multiplier (combine: multiply)

    @classmethod
    def flat(cls, friction: float = 1.0, device="cpu") -> "Heightfield":
        return cls(height=torch.zeros((1, 1), device=device), cell=1.0,
                   friction=float(np.float32(friction)))

    @property
    def is_flat(self) -> bool:
        return tuple(self.height.shape) == (1, 1)

    def _corners(self, xy: torch.Tensor):
        nx, ny = self.height.shape
        gx = torch.clamp(div(xy[..., 0], self.cell) + (nx - 1) / 2.0,
                         0.0, nx - 1.001)
        gy = torch.clamp(div(xy[..., 1], self.cell) + (ny - 1) / 2.0,
                         0.0, ny - 1.001)
        x0 = torch.floor(gx).long()
        y0 = torch.floor(gy).long()
        x1 = torch.clamp(x0 + 1, max=nx - 1)
        y1 = torch.clamp(y0 + 1, max=ny - 1)
        fx, fy = gx - x0, gy - y0
        hm = self.height
        return hm[x0, y0], hm[x0, y1], hm[x1, y0], hm[x1, y1], fx, fy

    def lookup(self, xy: torch.Tensor) -> torch.Tensor:
        """Bilinear height at world xy. xy: (..., 2) -> (...)."""
        if self.is_flat:
            return torch.zeros(xy.shape[:-1], dtype=xy.dtype,
                               device=xy.device)
        h00, h01, h10, h11, fx, fy = self._corners(xy)
        hr0 = (1.0 - fx) * h00 + fx * h10
        hr1 = (1.0 - fx) * h01 + fx * h11
        return hr0 * (1.0 - fy) + hr1 * fy

    def lookup_and_normal(self, xy: torch.Tensor):
        """Height and outward normal from one 4-corner bilinear sample.
        xy: (..., 2) -> ((...), (..., 3))."""
        if self.is_flat:
            h = torch.zeros(xy.shape[:-1], dtype=xy.dtype, device=xy.device)
            n = torch.zeros(xy.shape[:-1] + (3,), dtype=xy.dtype,
                            device=xy.device)
            n[..., 2] = 1.0
            return h, n
        return bilinear_and_normal(*self._corners(xy), self.cell)

    def normal(self, xy: torch.Tensor) -> torch.Tensor:
        """Outward surface normal at world xy. xy: (..., 2) -> (..., 3)."""
        return self.lookup_and_normal(xy)[1]

    def extract_patch(self, center_xy: torch.Tensor,
                      p: int) -> "TerrainPatch":
        """The (p, p) window of the grid around each env's world center
        (B, 2): its origin is the nearest cell less p // 2, clamped so that
        the window stays on the grid."""
        nx, ny = self.height.shape
        gx = div(center_xy[:, 0], self.cell) + (nx - 1) / 2.0
        gy = div(center_xy[:, 1], self.cell) + (ny - 1) / 2.0
        sx = torch.clamp(torch.round(gx).long() - p // 2, 0, max(nx - p, 0))
        sy = torch.clamp(torch.round(gy).long() - p // 2, 0, max(ny - p, 0))
        ar = torch.arange(p, device=self.height.device)
        patch = self.height[(sx[:, None] + ar)[:, :, None],
                            (sy[:, None] + ar)[:, None, :]]
        return TerrainPatch(height=patch, sx=sx, sy=sy, cell=self.cell,
                            friction=self.friction, grid_shape=(nx, ny))

    def grid_scan(self, center_xy: torch.Tensor, yaw: torch.Tensor,
                  size: float, resolution: float) -> torch.Tensor:
        """Yaw-aligned grid of height samples around center (the RayCaster
        height scanner, reference mushr_elevation_env_cfg.py:132-142).
        center_xy (..., 2), yaw (...) -> (..., n*n) heights,
        n = round(size / resolution) + 1."""
        ox, oy = _scan_offsets(size, resolution, center_xy.device)
        c, s = torch.cos(yaw)[..., None], torch.sin(yaw)[..., None]
        rot_x = ox * c - oy * s
        rot_y = ox * s + oy * c
        pts = torch.stack([center_xy[..., 0:1] + rot_x,
                           center_xy[..., 1:2] + rot_y], dim=-1)
        return self.lookup(pts)

    def build_atlas(self, p: int = 24, stride: int = 6) -> "PatchAtlas":
        """Every (p, p) window at `stride`-cell anchor spacing, as flat
        contiguous rows (p*p,), built once on the host with numpy (the
        reference's construction, `terrain.py:120-145`) and moved to the
        height's device."""
        nx, ny = self.height.shape
        if self.is_flat:
            raise ValueError("a flat field has no atlas")
        if p > min(nx, ny):
            raise ValueError(f"patch {p} exceeds the grid {(nx, ny)}")
        nax = max((nx - p + stride - 1) // stride + 1, 1)
        nay = max((ny - p + stride - 1) // stride + 1, 1)
        sxs = np.minimum(np.arange(nax) * stride, nx - p)
        sys_ = np.minimum(np.arange(nay) * stride, ny - p)
        h = self.height.detach().cpu().numpy()
        win = np.lib.stride_tricks.sliding_window_view(h, (p, p))
        rows = win[sxs[:, None], sys_[None, :]].reshape(nax * nay, p * p)
        return PatchAtlas(
            rows=torch.as_tensor(np.ascontiguousarray(rows, np.float32),
                                 device=self.height.device),
            cell=self.cell, friction=self.friction, p=p, stride=stride,
            nax=nax, nay=nay, grid_shape=(nx, ny))


def bilinear_and_normal(h00, h01, h10, h11, fx, fy, cell: float):
    """Height and outward normal of the bilinear cell with corners h<x><y>
    at fractions (fx, fy): rows interpolated along x, then along y; the
    normal (-dh/dx, -dh/dy, 1) scaled by 1 / its norm. These are kernel K3's
    expressions (`sim/soa_hf.py::_query_patch`), on the full grid as on a
    patch, so that the per-vehicle physics and K3 round alike. The
    reference's full grid sums the four corner products and divides by the
    norm: within an ulp or two of these."""
    hr0 = (1.0 - fx) * h00 + fx * h10
    hr1 = (1.0 - fx) * h01 + fx * h11
    h = hr0 * (1.0 - fy) + hr1 * fy
    dhdx = div((h10 - h00) * (1.0 - fy) + (h11 - h01) * fy, cell)
    dhdy = div(hr1 - hr0, cell)
    inv = 1.0 / torch.sqrt(dhdx * dhdx + dhdy * dhdy + 1.0)
    return h, torch.stack([-dhdx * inv, -dhdy * inv, inv], dim=-1)


def patch_corners(patch: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                  p: int):
    """Bilinear corner values (h00, h01, h10, h11) and fractions (fx, fy) of
    the query (u, v), in patch-local grid units, by a direct gather of rows
    idx, idx+1, idx+p, idx+p+1 of `patch` (p*p, B). u, v: (B,) clipped to
    [0, p-1.001], so exactly these rows are the ones the reference's masked
    sums pick. The integer cell is clamped to [0, p-2] so that a NaN query
    never indexes out of bounds (the CUDA kernel does the same)."""
    x0 = torch.floor(u)
    y0 = torch.floor(v)
    fx = u - x0
    fy = v - y0
    ix = torch.clamp(x0.to(torch.int64), 0, p - 2)
    iy = torch.clamp(y0.to(torch.int64), 0, p - 2)
    idx = (ix * p + iy)[None]
    corner = lambda off: torch.gather(patch, 0, idx + off)[0]
    return corner(0), corner(1), corner(p), corner(p + 1), fx, fy


def _scan_offsets(size: float, resolution: float, device):
    """The scan grid's (n*n,) x and y offsets, row-major over x."""
    n = int(round(size / resolution)) + 1
    axis = (torch.arange(n, dtype=torch.float32, device=device)
            - (n - 1) / 2.0) * resolution
    ox, oy = torch.meshgrid(axis, axis, indexing="ij")
    return ox.reshape(-1), oy.reshape(-1)


@dataclasses.dataclass
class TerrainPatch:
    """One static (p, p) terrain window per env (see
    `Heightfield.extract_patch`, `PatchAtlas.extract`), with the query
    surface of `Heightfield` (`lookup_and_normal`, `friction`), so that the
    physics substep reads either. Queries are clamped to the patch, which is
    sized so that in-bounds dynamics never clamp."""

    height: torch.Tensor        # (B, p, p)
    sx: torch.Tensor            # (B,) int64 patch origin (grid index)
    sy: torch.Tensor            # (B,) int64
    cell: float
    friction: float
    grid_shape: Tuple[int, int] = (1, 1)

    @property
    def is_flat(self) -> bool:
        return False

    def _uv(self, pts: torch.Tensor):
        """World points (B, m, 2) -> patch-local grid coordinates (B, m),
        clamped to [0, p - 1.001]."""
        p = self.height.shape[1]
        nx, ny = self.grid_shape
        u = (div(pts[..., 0], self.cell) + (nx - 1) / 2.0
             - self.sx[:, None].to(pts.dtype))
        v = (div(pts[..., 1], self.cell) + (ny - 1) / 2.0
             - self.sy[:, None].to(pts.dtype))
        return (torch.clamp(u, 0.0, p - 1.001),
                torch.clamp(v, 0.0, p - 1.001))

    def _corners(self, u: torch.Tensor, v: torch.Tensor):
        """Each query's bilinear corners (h00, h01, h10, h11) in its env's
        patch and its fractions (fx, fy): the values the reference's one-hot
        contractions select."""
        b, p = self.height.shape[:2]
        x0 = torch.floor(u)
        y0 = torch.floor(v)
        fx, fy = u - x0, v - y0
        ix = torch.clamp(x0.long(), 0, p - 2)
        iy = torch.clamp(y0.long(), 0, p - 2)
        idx = ix * p + iy
        flat = self.height.reshape(b, p * p)
        corner = lambda off: torch.gather(flat, 1, idx + off)
        return corner(0), corner(1), corner(p), corner(p + 1), fx, fy

    def lookup_and_normal(self, xy: torch.Tensor):
        """Bilinear height and analytic normal inside each env's patch.
        xy: (B, ..., 2) world -> ((B, ...), (B, ..., 3))."""
        shape = xy.shape[:-1]
        u, v = self._uv(xy.reshape(shape[0], -1, 2))
        h, n = bilinear_and_normal(*self._corners(u, v), self.cell)
        return h.reshape(shape), n.reshape(shape + (3,))

    def grid_scan(self, center_xy: torch.Tensor, yaw: torch.Tensor,
                  size: float, resolution: float) -> torch.Tensor:
        """Yaw-aligned bilinear height scan from each env's patch.
        center_xy (B, 2), yaw (B,) -> (B, n*n) heights."""
        ox, oy = _scan_offsets(size, resolution, center_xy.device)
        c, s = torch.cos(yaw)[:, None], torch.sin(yaw)[:, None]
        pts = torch.stack([center_xy[:, 0:1] + ox * c - oy * s,
                           center_xy[:, 1:2] + ox * s + oy * c], dim=-1)
        h00, h01, h10, h11, fx, fy = self._corners(*self._uv(pts))
        hr0 = (1.0 - fx) * h00 + fx * h10
        hr1 = (1.0 - fx) * h01 + fx * h11
        return hr0 * (1.0 - fy) + hr1 * fy


@dataclasses.dataclass
class PatchAtlas:
    """All (p, p) terrain windows at `stride`-cell anchors, flattened to
    contiguous rows, so that per-env extraction is one row gather.

    Coverage: a query point stays inside its extracted patch iff
    |point - center| <= (p/2 - stride/2 - 1) * cell in each axis."""

    rows: torch.Tensor          # (nax*nay, p*p) f32
    cell: float
    friction: float
    p: int = 24
    stride: int = 6
    nax: int = 1
    nay: int = 1
    grid_shape: Tuple[int, int] = (1, 1)

    def _anchors(self, px: torch.Tensor, py: torch.Tensor):
        """Nearest anchor (ix, iy) of world centers (B,), (B,) and its grid
        origin (sx, sy)."""
        p, s = self.p, self.stride
        nx, ny = self.grid_shape
        gx = div(px, self.cell) + (nx - 1) / 2.0
        gy = div(py, self.cell) + (ny - 1) / 2.0
        ix = torch.clamp(torch.round(div(gx - p / 2.0, s)).to(torch.int64),
                         0, self.nax - 1)
        iy = torch.clamp(torch.round(div(gy - p / 2.0, s)).to(torch.int64),
                         0, self.nay - 1)
        return ix, iy, torch.clamp(ix * s, max=nx - p), torch.clamp(
            iy * s, max=ny - p)

    def extract_rows(self, px: torch.Tensor, py: torch.Tensor):
        """World centers (B,), (B,) -> (patch rows (p*p, B) f32, contiguous;
        org (2, B) f32 grid origins): one row gather from the atlas and a
        transpose into the packed layout."""
        ix, iy, sx, sy = self._anchors(px, py)
        rows = self.rows[ix * self.nay + iy]                    # (B, p*p)
        org = torch.stack([sx, sy]).to(torch.float32)           # (2, B)
        return rows.T.contiguous(), org

    def extract(self, center_xy: torch.Tensor) -> TerrainPatch:
        """Each env's nearest-anchor patch for world centers (B, 2)."""
        ix, iy, sx, sy = self._anchors(center_xy[:, 0], center_xy[:, 1])
        patch = self.rows[ix * self.nay + iy].reshape(-1, self.p, self.p)
        return TerrainPatch(height=patch, sx=sx, sy=sy, cell=self.cell,
                            friction=self.friction,
                            grid_shape=self.grid_shape)

    def lookup(self, xy: torch.Tensor) -> torch.Tensor:
        """Batched bilinear height via the atlas. xy: (B, 2) -> (B,)."""
        p = self.p
        nx, ny = self.grid_shape
        rows, org = self.extract_rows(xy[:, 0], xy[:, 1])
        u = div(xy[:, 0], self.cell) + (nx - 1) / 2.0 - org[0]
        v = div(xy[:, 1], self.cell) + (ny - 1) / 2.0 - org[1]
        u = torch.clamp(u, 0.0, p - 1.001)
        v = torch.clamp(v, 0.0, p - 1.001)
        h00, h01, h10, h11, fx, fy = patch_corners(rows, u, v, p)
        hr0 = (1.0 - fx) * h00 + fx * h10
        hr1 = (1.0 - fx) * h01 + fx * h11
        return hr0 * (1.0 - fy) + hr1 * fy
