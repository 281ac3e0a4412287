"""The port's host C++ library (`wheeledlab_torch/native`) against the JAX
package's (`wheeledlab_tpu/native`), both built here: the native map
generator's grids for the same seeds, and the top-down renderers' frames
with the library on in both packages (trails and headings drawn), pixel for
pixel. Also the loader: a hashed build in `_build/`, and the numpy fallback
of every caller without a toolchain."""

import os
import time

import numpy as np
import pytest

from wheeledlab_tpu import native as jnative
from wheeledlab_tpu.render import topdown as jtopdown
from wheeledlab_tpu.tasks.visual import map_gen as jmap
from wheeledlab_torch import native as tnative
from wheeledlab_torch.ops import build
from wheeledlab_torch.render import topdown
from wheeledlab_torch.tasks.visual import map_gen as tmap

from test_torch_drift_family import trajectories


@pytest.fixture(scope="module", autouse=True)
def libraries():
    """Both libraries loaded. The JAX package's loader builds its library
    in place, so a test process that loads it while another one writes it
    fails; that load is retried."""
    for _ in range(10):
        if jnative.load() is not None:
            break
        jnative._tried = False
        time.sleep(1.0)
    assert jnative.available(), "the JAX package's native library"
    assert tnative.available(), "the port's native library"


@pytest.fixture
def no_toolchain(monkeypatch):
    """The port's loader as it is where no C++ compiler builds the
    library."""
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "_tried", False)
    monkeypatch.setattr(build, "HOST_CXX", ("no-such-c++",))
    monkeypatch.setattr(build, "host_library_path",
                        lambda src: os.path.join(build.BUILD_DIR, "absent"))


class TestMaps:
    @pytest.mark.parametrize("seed", [0, 1, 7])
    @pytest.mark.parametrize("size", [(100, 100), (200, 300)])
    def test_native_grid_equals_jax(self, seed, size):
        kw = dict(map_size=size, env_size=(50, 50), sub_group_size=(25, 25),
                  backend="native")
        got = tmap.generate_traversability_map(seed, **kw)
        want = jmap.generate_traversability_map(seed, **kw)
        assert got.dtype == bool and got.shape == size
        np.testing.assert_array_equal(got, want)
        # the native stream is not numpy's
        numpy_grid = tmap.generate_traversability_map(
            seed, **{**kw, "backend": "numpy"})
        assert (got != numpy_grid).any()

    def test_without_toolchain_native_falls_back_to_numpy(self,
                                                           no_toolchain):
        kw = dict(map_size=(100, 100), env_size=(50, 50),
                  sub_group_size=(25, 25))
        assert not tnative.available()
        np.testing.assert_array_equal(
            tmap.generate_traversability_map(3, backend="native", **kw),
            tmap.generate_traversability_map(3, backend="numpy", **kw))

    def test_unknown_backend_raises(self):
        with pytest.raises(ValueError, match="backend"):
            tmap.generate_traversability_map(0, backend="cuda")


class TestFrames:
    def test_map_frames_equal_jax(self):
        """30 frames, 8 cars, size 480, with yaws and 40-frame trails: the
        port draws the JAX package's pixels, trails and headings included
        (the numpy fallback draws the disks alone)."""
        pos, yaw = trajectories(6, t=30, b=8)
        grid = np.random.default_rng(7).random((24, 30)).astype(np.float32)
        goals = pos[::-1].copy()
        got = topdown.render_map_frames(pos, grid, 0.25, yaws=yaw,
                                        goals=goals)
        want = jtopdown.render_map_frames(pos, grid, 0.25, yaws=yaw,
                                          goals=goals)
        assert got.shape == (30, 480, 480, 3)
        np.testing.assert_array_equal(got, want)
        assert (got[-1] != got[0]).any()

    def test_map_frames_draw_trails_and_headings(self, monkeypatch):
        pos, yaw = trajectories(8, t=12, b=4)
        grid = np.zeros((24, 30), np.float32)
        native = topdown.render_map_frames(pos, grid, 0.25, yaws=yaw)
        monkeypatch.setattr(tnative, "rasterize_trajectories",
                            lambda *a, **k: False)
        disks = topdown.render_map_frames(pos, grid, 0.25, yaws=yaw)
        drawn = (native != disks).any(-1)
        assert drawn[1:].sum() > 0 and not drawn[0].all()
        # the native frames hold every pixel the disks cover
        assert ((disks != disks[0, 0, 0]).any(-1)
                <= (native != native[0, 0, 0]).any(-1)).all()

    @pytest.mark.parametrize("with_yaw", [True, False])
    def test_drift_frames_equal_jax(self, with_yaw):
        pos, yaw = trajectories(9, t=30, b=8)
        yaw = yaw if with_yaw else None
        got = topdown.render_drift_frames(pos, yaw, trail=25)
        np.testing.assert_array_equal(
            got, jtopdown.render_drift_frames(pos, yaw, trail=25))
        assert got.shape == (30, 400, 400, 3)

    def test_without_toolchain_frames_fall_back(self, no_toolchain):
        pos, yaw = trajectories(10, t=5, b=3)
        assert not tnative.rasterize_trajectories(
            np.zeros((1, 8, 8, 3), np.uint8), np.zeros((1, 1, 2), np.float32),
            None, np.zeros((1, 3), np.uint8), 1)
        got = topdown.render_drift_frames(pos, yaw, size=96, trail=3)
        assert got.shape == (5, 96, 96, 3)


class TestBuild:
    def test_hashed_build_in_the_build_dir(self):
        path = build.build_host(tnative.SOURCE)
        assert path == build.host_library_path(tnative.SOURCE)
        assert os.path.dirname(path) == build.BUILD_DIR
        assert os.path.basename(path).startswith("wheeledlab_native-")
        assert build.build_host(tnative.SOURCE) == path    # cached

    def test_source_is_the_port_s_own_copy(self):
        """The same C++ body as the JAX package's, so both draw the same
        maps and frames; the port loads its own file."""
        with open(tnative.SOURCE) as f:
            ours = f.read()
        with open(os.path.join(os.path.dirname(jnative.__file__),
                               "wheeledlab_native.cpp")) as f:
            theirs = f.read()
        body = lambda src: src[src.index("#include <algorithm>"):]
        assert body(ours) == body(theirs)
        assert "wheeledlab_tpu" not in ours
