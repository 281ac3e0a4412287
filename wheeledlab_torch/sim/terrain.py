"""Terrain as a batched height function — the port of
`wheeledlab_tpu/sim/terrain.py` (`Heightfield`, `PatchAtlas`).

A terrain is a regular heightfield on the device; a flat plane is the
degenerate (1, 1) grid. The atlas of (p, p) windows is built once on the
host with numpy, exactly as the reference builds it, and moved to the
device. The reference's one-hot contractions and masked corner sums are TPU
workarounds for the missing hardware gather; here every lookup is a direct
gather of the four bilinear corners, with the same interpolation
expressions in the same operand order.
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
        return (h00 * (1 - fx) * (1 - fy) + h01 * (1 - fx) * fy
                + h10 * fx * (1 - fy) + h11 * fx * fy)

    def lookup_and_normal(self, xy: torch.Tensor):
        """Height and outward normal from one 4-corner bilinear sample.
        xy: (..., 2) -> ((...), (..., 3))."""
        if self.is_flat:
            h = torch.zeros(xy.shape[:-1], dtype=xy.dtype, device=xy.device)
            n = torch.zeros(xy.shape[:-1] + (3,), dtype=xy.dtype,
                            device=xy.device)
            n[..., 2] = 1.0
            return h, n
        h00, h01, h10, h11, fx, fy = self._corners(xy)
        h = (h00 * (1 - fx) * (1 - fy) + h01 * (1 - fx) * fy
             + h10 * fx * (1 - fy) + h11 * fx * fy)
        dhdx = div((h10 - h00) * (1 - fy) + (h11 - h01) * fy, self.cell)
        dhdy = div((h01 - h00) * (1 - fx) + (h11 - h10) * fx, self.cell)
        n = torch.stack([-dhdx, -dhdy, torch.ones_like(dhdx)], dim=-1)
        n = n / torch.linalg.vector_norm(n, dim=-1, keepdim=True)
        return h, n

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

    def extract_rows(self, px: torch.Tensor, py: torch.Tensor):
        """World centers (B,), (B,) -> (patch rows (p*p, B) f32, contiguous;
        org (2, B) f32 grid origins): one row gather from the atlas and a
        transpose into the packed layout."""
        p, s = self.p, self.stride
        nx, ny = self.grid_shape
        gx = div(px, self.cell) + (nx - 1) / 2.0
        gy = div(py, self.cell) + (ny - 1) / 2.0
        ix = torch.clamp(torch.round(div(gx - p / 2.0, s)).to(torch.int64),
                         0, self.nax - 1)
        iy = torch.clamp(torch.round(div(gy - p / 2.0, s)).to(torch.int64),
                         0, self.nay - 1)
        sx = torch.clamp(ix * s, max=nx - p)
        sy = torch.clamp(iy * s, max=ny - p)
        rows = self.rows[ix * self.nay + iy]                    # (B, p*p)
        org = torch.stack([sx, sy]).to(torch.float32)           # (2, B)
        return rows.T.contiguous(), org

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
