"""Parity of the port's terrain (`wheeledlab_torch/sim/terrain.py`) with the
JAX reference (`wheeledlab_tpu/sim/terrain.py`) on the same heightfield, and
the port's terrain generator against the reference's bounds.

The heightfield is the JAX elevation task's at a small size
(ElevationTaskCfg(terrain_extent=20.0, num_mounds=10)), carried across with
`convert.heightfield_from_jax`. The port's lookups gather the four bilinear
corners directly where the reference selects them with masks; the values
are the same up to float rounding of the same expressions."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wheeledlab_tpu.sim import soa_hf as jsoa_hf
from wheeledlab_tpu.tasks.elevation.task import (
    ElevationTaskCfg as JElevationTaskCfg,
)
from wheeledlab_tpu.tasks.elevation.task import make_elevation_task as j_task
from wheeledlab_torch.convert import heightfield_from_jax
from wheeledlab_torch.sim.terrain import Heightfield, patch_corners
from wheeledlab_torch.tasks.elevation.terrain_gen import (
    generate_elevation_terrain,
)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def terrains():
    """(JAX Heightfield, the port's copy of it)."""
    jt = j_task(JElevationTaskCfg(num_envs=8, terrain_extent=20.0,
                                  num_mounds=10)).terrain
    return jt, heightfield_from_jax(jax.tree_util.tree_map(np.asarray, jt))


def query_points(seed, n=256):
    """Points over the field, past its borders and on its edges."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-9.5, 9.5, (n, 2)).astype(np.float32)
    edges = np.float32([[-12.0, -12.0], [12.0, 12.0], [0.0, 12.0],
                        [-10.0, 3.0], [10.0, -10.0], [0.125, -0.25]])
    return np.concatenate([pts, edges])


class TestHeightfield:
    def test_carried_across_exactly(self, terrains):
        jt, tt = terrains
        np.testing.assert_array_equal(tt.height.numpy(),
                                      np.asarray(jt.height))
        assert tt.cell == float(jt.cell) and tt.friction == 1.0
        assert not tt.is_flat

    def test_lookup_matches_jax(self, terrains):
        """Same corners, same expression: within 1e-6 m."""
        jt, tt = terrains
        pts = query_points(0)
        got = tt.lookup(torch.from_numpy(pts)).numpy()
        np.testing.assert_allclose(got, np.asarray(jt.lookup(pts)),
                                   atol=1e-6)

    def test_lookup_and_normal_matches_jax(self, terrains):
        """Heights within 1e-6 m, normals within 1e-6 (the norm is taken by
        each package's own reduction)."""
        jt, tt = terrains
        pts = query_points(1).reshape(-1, 2, 2)   # leading batch dims too
        h, n = tt.lookup_and_normal(torch.from_numpy(pts))
        jh, jn = jt.lookup_and_normal(jnp.asarray(pts))
        np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=1e-6)
        np.testing.assert_allclose(n.numpy(), np.asarray(jn), atol=1e-6)

    def test_flat(self):
        flat = Heightfield.flat(friction=0.7)
        assert flat.is_flat and flat.friction == pytest.approx(0.7)
        xy = torch.zeros((5, 2))
        assert (flat.lookup(xy) == 0).all()
        h, n = flat.lookup_and_normal(xy)
        assert (h == 0).all() and (n == torch.tensor([0.0, 0.0, 1.0])).all()
        with pytest.raises(ValueError):
            flat.build_atlas()


class TestPatchAtlas:
    @pytest.mark.parametrize("p,stride", [(24, 6), (12, 2)])
    def test_build_atlas_rows_match_jax(self, terrains, p, stride):
        """The atlas is built on the host with the reference's numpy code:
        exactly the same rows."""
        jt, tt = terrains
        ja = jt.build_atlas(p=p, stride=stride)
        ta = tt.build_atlas(p=p, stride=stride)
        assert (ta.nax, ta.nay, ta.grid_shape) == (ja.nax, ja.nay,
                                                   ja.grid_shape)
        np.testing.assert_array_equal(ta.rows.numpy(), np.asarray(ja.rows))

    @pytest.mark.parametrize("p,stride", [(24, 6), (12, 2)])
    def test_extract_rows_matches_jax(self, terrains, p, stride):
        """Anchor choice (round half to even) and the row gather: exact."""
        jt, tt = terrains
        pts = query_points(2)
        rows, org = tt.build_atlas(p=p, stride=stride).extract_rows(
            torch.from_numpy(pts[:, 0]), torch.from_numpy(pts[:, 1]))
        jrows, jorg = jt.build_atlas(p=p, stride=stride).extract_rows(
            jnp.asarray(pts[:, 0]), jnp.asarray(pts[:, 1]))
        assert rows.is_contiguous() and rows.shape == (p * p, len(pts))
        np.testing.assert_array_equal(rows.numpy(), np.asarray(jrows))
        np.testing.assert_array_equal(org.numpy(), np.asarray(jorg))

    def test_atlas_lookup_matches_jax_and_global(self, terrains):
        """The contact atlas's lookup against JAX's (1e-6 m) and against the
        full-grid bilinear (1e-5 m, the reference's own bar)."""
        jt, tt = terrains
        pts = query_points(3)
        got = tt.build_atlas(p=12, stride=2).lookup(torch.from_numpy(pts))
        want = jt.build_atlas(p=12, stride=2).lookup(jnp.asarray(pts))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
        np.testing.assert_allclose(
            got.numpy(), tt.lookup(torch.from_numpy(pts)).numpy(), atol=1e-5)

    def test_patch_corners_equal_masked_sums(self):
        """The direct corner gather gives exactly the reference's masked
        reductions (one matching row per corner)."""
        rng = np.random.default_rng(4)
        p, b = 12, 64
        patch = rng.uniform(0, 1, (p * p, b)).astype(np.float32)
        u = np.float32(rng.uniform(0, p - 1.001, b))
        v = np.float32(rng.uniform(0, p - 1.001, b))
        u[:3] = [0.0, p - 1.001, 5.0]
        got = patch_corners(torch.from_numpy(patch), torch.from_numpy(u),
                            torch.from_numpy(v), p)
        want = jsoa_hf.patch_corners(jnp.asarray(patch), jnp.asarray(u),
                                     jnp.asarray(v), p)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))

    def test_nan_query_stays_in_bounds(self):
        """A NaN coordinate reads a valid row instead of out of bounds."""
        patch = torch.arange(16.0).reshape(16, 1)
        nan = torch.tensor([float("nan")])
        h00, h01, h10, h11, _, _ = patch_corners(patch, nan, nan, 4)
        assert all(0 <= float(h) < 16 for h in (h00, h01, h10, h11))


class TestTerrainGen:
    """The port's generator draws from a torch.Generator (the reference's
    threefry stream cannot be reproduced), so it is held to the reference's
    bounds (tests/test_elevation_env.py::TestTerrainGen)."""

    def make(self, seed):
        return generate_elevation_terrain(torch.Generator().manual_seed(seed),
                                          extent=20.0, num_mounds=10)

    def test_deterministic_and_bounded(self):
        t1, t2 = self.make(7), self.make(7)
        np.testing.assert_array_equal(t1.height.numpy(), t2.height.numpy())
        assert not np.array_equal(t1.height.numpy(),
                                  self.make(8).height.numpy())
        h = t1.height.numpy()
        assert h.shape == (81, 81) and h.dtype == np.float32
        assert h.min() >= 0.0 and h.max() <= 0.9 + 1e-6
        assert h.max() > 0.1  # actually has mounds

    @pytest.mark.parametrize("seed", [7, 8, 9])
    def test_slope_capped(self, seed):
        t = self.make(seed)
        h = t.height.numpy()
        gx = np.abs(np.diff(h, axis=0)) / t.cell
        gy = np.abs(np.diff(h, axis=1)) / t.cell
        assert max(gx.max(), gy.max()) < 0.45  # climbable grade


if __name__ == "__main__":
    import sys

    sys.exit(pytest.main([__file__, "-x", "-q"]))
