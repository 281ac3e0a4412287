"""Procedural elevation terrain — the port of
`wheeledlab_tpu/tasks/elevation/terrain_gen.py` (which replaces the
reference's `huge_compact.usd`).

The same field of Gaussian mounds on a flat base with the same slope cap,
drawn from a `torch.Generator` on the host. JAX's threefry streams cannot be
reproduced, so a seed gives a different field than the reference's; the
parity tests feed the JAX heightfield to both packages instead
(`convert.heightfield_from_jax`)."""

from __future__ import annotations

import torch

from ...sim.terrain import Heightfield


def generate_elevation_terrain(
    generator: torch.Generator,
    extent: float = 44.0,        # meters per side (goals sampled over +-19)
    cell: float = 0.25,
    num_mounds: int = 60,
    height_range: tuple = (0.2, 0.9),
    radius_range: tuple = (1.5, 4.0),
    friction: float = 1.0,
    device="cpu",
) -> Heightfield:
    """Build the field on the host (CPU generator) and move it to
    `device`."""
    n = int(round(extent / cell)) + 1
    u = lambda shape, lo, hi: (torch.rand(shape, generator=generator)
                               * (hi - lo) + lo)
    centers = u((num_mounds, 2), -extent / 2 * 0.9, extent / 2 * 0.9)
    heights = u((num_mounds,), *height_range)
    radii = u((num_mounds,), *radius_range)
    # cap slope: max gradient of h*exp(-d^2/2r^2) is ~0.61 h/r; keep < 0.35
    heights = torch.minimum(heights, 0.55 * radii)

    axis = (torch.arange(n, dtype=torch.float32) - (n - 1) / 2.0) * cell
    gx, gy = torch.meshgrid(axis, axis, indexing="ij")
    d2 = ((gx[None] - centers[:, 0, None, None]) ** 2
          + (gy[None] - centers[:, 1, None, None]) ** 2)
    mounds = heights[:, None, None] * torch.exp(
        -d2 / (2.0 * radii[:, None, None] ** 2))
    height = mounds.max(dim=0).values  # max-combine keeps mound shapes crisp
    return Heightfield(height=height.to(device), cell=cell,
                       friction=friction)
