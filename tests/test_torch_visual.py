"""Parity of the port's visual task (`wheeledlab_torch/tasks/visual/`) with
the JAX package's on the CPU: the map, the camera, the augmentation, the
observation, 8 steps through the generic manager step (kernel K2's plain
version against the JAX env's `pallas_step` in interpret mode), the rollout
statistics of tests/golden_visual.json, and the harness around the task
(registration, RSS_VISUAL_CONFIG, the policy-view clips).

Renders are compared by the pixel rule: at most 1e-3 of the pixels may
differ, and only where the hit point lies within 1e-4 m of a cell edge,
where an ulp of the ray arithmetic picks the cell. JAX threefry streams
cannot be reproduced, so the port is fed the JAX env state
(`convert.env_state_from_jax`) and, for the augmentation, JAX's draws."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wheeledlab_tpu.tasks.visual import augment as jaug
from wheeledlab_tpu.tasks.visual import camera as jcam
from wheeledlab_tpu.tasks.visual import map_gen as jmap
from wheeledlab_tpu.tasks.visual.task import VisualTaskCfg as JVisualTaskCfg
from wheeledlab_tpu.tasks.visual.task import make_visual_env as j_env
from wheeledlab_tpu.tasks.visual.task import make_visual_task as j_task
from wheeledlab_torch.convert import env_state_from_jax
from wheeledlab_torch.tasks import make_env
from wheeledlab_torch.tasks.visual import augment as taug
from wheeledlab_torch.tasks.visual import camera as tcam
from wheeledlab_torch.tasks.visual import map_gen as tmap
from wheeledlab_torch.tasks.visual.task import (
    CAMERA_OBS, VISUAL_OBS_DIM, VisualTaskCfg, make_visual_env,
    make_visual_task,
)

torch.set_num_threads(1)

SMALL = dict(map_rows=100, map_cols=100, env_rows=20, env_cols=20,
             group_rows=5, group_cols=5)
N = 32
PIXEL_FRAC = 1e-3     # most pixels that may differ
EDGE_M = 1e-4         # a differing pixel's hit lies this close to an edge
# Tolerances of the step-by-step comparison: the same float32 operations in
# the same order, up to libm ulps amplified by 20 stiff substeps a step
# (measured over 8 steps at 32 envs: state 8.8e-5, reward 2.9e-6, metrics
# 1.3e-5, obs 6.3e-6; 1 camera pixel of 768,000 differed, at a cell edge)
STATE_TOL = dict(rtol=1e-5, atol=1e-3)
REWARD_TOL = dict(rtol=1e-5, atol=1e-4)
OBS_TOL = dict(rtol=1e-5, atol=1e-4)


def to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def t(x):
    return torch.as_tensor(np.array(x))


@pytest.fixture(scope="module")
def worlds():
    """{color_sampling: (JAX task, port task)} on the small map."""
    return {cs: (j_task(JVisualTaskCfg(num_envs=N, color_sampling=cs,
                                       **SMALL)),
                 make_visual_task(VisualTaskCfg(num_envs=N, color_sampling=cs,
                                                **SMALL)))
            for cs in (False, True)}


def poses(seed=3, n=N):
    """n poses on the small map, as numpy: half level on spawn cells, half
    anywhere (some off the map) with roll and pitch up to 0.3 rad and
    heights 0.05-0.3 m."""
    rng = np.random.default_rng(seed)
    trav = tmap.generate_traversability_map(42, (100, 100), (20, 20), (5, 5))
    rows, cols = np.nonzero(trav)
    idx = rng.integers(0, rows.size, n // 2)
    xy = np.concatenate([
        np.stack([(cols[idx] - 50) * 0.5, (rows[idx] - 50) * 0.5], -1),
        rng.uniform(-30, 30, (n - n // 2, 2))])
    z = np.concatenate([np.full(n // 2, 0.1), rng.uniform(0.05, 0.3,
                                                          n - n // 2)])
    tilt = np.concatenate([np.zeros((n // 2, 2)),
                           rng.uniform(-0.3, 0.3, (n - n // 2, 2))])
    roll, pitch = tilt[:, 0], tilt[:, 1]
    yaw = rng.uniform(-np.pi, np.pi, n)
    cr, sr = np.cos(roll / 2), np.sin(roll / 2)
    cp, sp = np.cos(pitch / 2), np.sin(pitch / 2)
    cy, sy = np.cos(yaw / 2), np.sin(yaw / 2)
    quat = np.stack([cy * cp * cr + sy * sp * sr, cy * cp * sr - sy * sp * cr,
                     cy * sp * cr + sy * cp * sr, sy * cp * cr - cy * sp * sr],
                    -1)
    pos = np.concatenate([xy, z[:, None]], -1)
    return pos.astype(np.float32), quat.astype(np.float32)


def at_cell_edge(x, y, cell=0.5, width=50.0, height=50.0):
    """Hit points within EDGE_M of a cell edge along x or y."""
    u = (np.asarray(x, np.float64) + width / 2) / cell
    v = (np.asarray(y, np.float64) + height / 2) / cell
    return ((np.abs(u - np.round(u)) * cell < EDGE_M)
            | (np.abs(v - np.round(v)) * cell < EDGE_M))


def assert_pixel_rule(got, want, hx, hy, name, atol=0.0):
    """At most PIXEL_FRAC of the pixels differ (by more than `atol`), each
    where its hit lies within EDGE_M of a cell edge. Returns the fraction."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    differ = np.abs(got - want) > atol
    if differ.ndim > np.ndim(hx):                       # RGB channels
        differ = differ.any(-1)
    frac = differ.mean()
    assert frac <= PIXEL_FRAC, f"{name}: {frac} of the pixels differ"
    edge = at_cell_edge(hx, hy)
    assert edge[differ].all(), \
        f"{name}: {int((differ & ~edge).sum())} differing pixels off the edges"
    return frac


# ---------------------------------------------------------------------------
# map
# ---------------------------------------------------------------------------


class TestMap:
    @pytest.mark.parametrize("seed", [0, 7, 42])
    def test_small_map_is_bit_equal(self, seed):
        args = (seed, (100, 100), (20, 20), (5, 5), 1)
        np.testing.assert_array_equal(
            tmap.generate_traversability_map(*args),
            jmap.generate_traversability_map(*args))

    def test_default_map_is_bit_equal(self):
        want = jmap.generate_traversability_map(42)
        got = tmap.generate_traversability_map(42)
        assert got.shape == (500, 500) and 0.02 < got.mean() < 0.9
        np.testing.assert_array_equal(got, want)

    @pytest.mark.parametrize("color_sampling", [False, True])
    def test_world_colors_are_bit_equal(self, worlds, color_sampling):
        jt, tt = worlds[color_sampling]
        np.testing.assert_array_equal(tt.colormap.grid.numpy(),
                                      np.asarray(jt.colormap.grid))
        if color_sampling:
            np.testing.assert_array_equal(tt.colormap.grid_rgb.numpy(),
                                          np.asarray(jt.colormap.grid_rgb))
        else:
            assert tt.colormap.grid_rgb is None
            assert jt.colormap.grid_rgb is None
        np.testing.assert_array_equal(tt.render_grid[0], jt.render_grid[0])


# ---------------------------------------------------------------------------
# camera
# ---------------------------------------------------------------------------


class TestCamera:
    def test_constants_and_rays_are_bit_equal(self):
        for name in ("WIDTH", "HEIGHT", "FOCAL", "APERTURE_H", "APERTURE_V"):
            assert getattr(tcam, name) == getattr(jcam, name), name
        for name in ("CAM_OFFSET_B", "LUMA", "_RAYS"):
            np.testing.assert_array_equal(getattr(tcam, name),
                                          getattr(jcam, name))
        assert tcam._RAYS.dtype == np.float32
        for crop, slack in ((20, 5.0), (0, 3.0), (20, 1.0)):
            assert (tcam.near_split_row(crop, slack)
                    == jcam.near_split_row(crop, slack))

    @pytest.mark.parametrize("color_sampling", [False, True])
    def test_sample_matches_jax_on_and_off_the_map(self, worlds,
                                                   color_sampling):
        jt, tt = worlds[color_sampling]
        xy = np.random.default_rng(5).uniform(-40, 40, (4096, 2)).astype(
            np.float32)
        assert (np.abs(xy) > 25).any(1).mean() > 0.3   # many off the map
        np.testing.assert_array_equal(tt.colormap.sample(t(xy)).numpy(),
                                      np.asarray(jt.colormap.sample(xy)))
        np.testing.assert_array_equal(tt.colormap.sample_rgb(t(xy)).numpy(),
                                      np.asarray(jt.colormap.sample_rgb(xy)))
        assert tt.colormap.width == jt.colormap.width == 50.0

    def test_atlas_anchors_and_gather_match_the_one_hot_contraction(
            self, worlds):
        """The window anchors of random camera points (the last window
        shifted to the map's edge: 100 - 40 is no multiple of 8) and the
        gathered cells, against the reference's one-hot row/column
        contraction, exactly."""
        jt, tt = worlds[True]
        jatlas = jcam.ColorMapAtlas.build(jt.colormap)
        tatlas = tcam.ColorMapAtlas.build(tt.colormap)
        assert (tatlas.nar, tatlas.nac) == (jatlas.nar, jatlas.nac) == (9, 9)
        rng = np.random.default_rng(9)
        cams = rng.uniform(-27, 27, (64, 2)).astype(np.float32)
        pts = (cams[:, None] + rng.uniform(-15, 15, (64, 300, 2))).astype(
            np.float32)
        sr, sc = tatlas.extract(t(cams[:, 0]), t(cams[:, 1]))
        got = tatlas.sample_patch_xy(sr, sc, t(pts[..., 0]), t(pts[..., 1]))

        def one(c, p):
            patch, jsr, jsc = jatlas.extract(c)
            return jatlas.sample_patch(patch, jsr, jsc, p), jsr, jsc

        want, jsr, jsc = jax.vmap(one)(jnp.asarray(cams), jnp.asarray(pts))
        np.testing.assert_array_equal(sr.numpy(), np.asarray(jsr))
        np.testing.assert_array_equal(sc.numpy(), np.asarray(jsc))
        assert set(np.asarray(jsr).tolist()) >= {0, 60}
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    @pytest.mark.parametrize("color_sampling", [False, True])
    def test_renders_match_jax_by_the_pixel_rule(self, worlds,
                                                 color_sampling):
        """render_fast (cropped), render, render_rgb and the flattened RGB
        obs by the pixel rule, depth within rtol 1e-5 (measured: every
        render bit-equal on these poses; the flattened obs within 2.4e-7,
        the luma dot product's rounding)."""
        jt, tt = worlds[color_sampling]
        jcm, tcm = jt.colormap, tt.colormap
        pos, quat = poses()
        tp, tq = t(pos), t(quat)
        crop = tcam.HEIGHT // 3
        jatlas = jcam.ColorMapAtlas.build(jcm)
        tatlas = tcam.ColorMapAtlas.build(tcm)
        _, fx, fy, _ = tcam.ground_hits_planar(tp, tq, crop)
        hit, depth_t, _ = tcam.ground_hits(tp, tq)
        hx, hy = hit[..., 0].numpy(), hit[..., 1].numpy()
        jp, jq = jnp.asarray(pos), jnp.asarray(quat)
        fast = tcam.render_fast(tatlas, tp, tq, crop_top=crop)
        assert fast.shape == (N, 40, 80)
        assert_pixel_rule(
            fast, jcam.render_fast(jatlas, jp, jq, crop_top=crop),
            fx.numpy(), fy.numpy(), "render_fast")
        assert_pixel_rule(tcam.render(tcm, tp, tq), jcam.render(jcm, jp, jq),
                          hx, hy, "render")
        assert_pixel_rule(tcam.render_rgb(tcm, tp, tq),
                          jcam.render_rgb(jcm, jp, jq), hx, hy, "render_rgb")
        flat = tcam.camera_rgb_flattened(tcm, tp, tq)
        assert flat.shape == (N, CAMERA_OBS)
        assert_pixel_rule(
            flat.reshape(N, 40, 80),
            np.asarray(jcam.camera_rgb_flattened(jcm, jp, jq)).reshape(
                N, 40, 80), hx[:, crop:], hy[:, crop:],
            "camera_rgb_flattened", atol=1e-6)
        # one pose at a time, as the reference also takes it
        np.testing.assert_array_equal(
            tcam.render(tcm, tp[0], tq[0]).numpy(),
            tcam.render(tcm, tp, tq)[0].numpy())
        depth = tcam.render_depth(tp, tq)
        np.testing.assert_allclose(depth.numpy(),
                                   np.asarray(jcam.render_depth(jp, jq)),
                                   rtol=1e-5)
        assert (depth.numpy() == 100.0).any() and (depth.numpy() < 5).any()

    def test_two_window_render_matches_jax(self, worlds):
        """`render_fast` with a near window atlas (p = 24): the rows from
        the static split down sample the small window, as in the
        reference."""
        jt, tt = worlds[True]
        pos, quat = poses(seed=6)
        crop = tcam.HEIGHT // 3
        jfar, tfar = (m.ColorMapAtlas.build(w.colormap)
                      for m, w in ((jcam, jt), (tcam, tt)))
        jnear = jcam.ColorMapAtlas.build(jt.colormap, p=24, stride=4)
        tnear = tcam.ColorMapAtlas.build(tt.colormap, p=24, stride=4)
        split = tcam.near_split_row(crop, (24 / 2 - 4 / 2 - 1) * 0.5)
        assert 0 < split < 40
        got = tcam.render_fast(tfar, t(pos), t(quat), crop, tnear)
        _, fx, fy, _ = tcam.ground_hits_planar(t(pos), t(quat), crop)
        assert_pixel_rule(
            got, jcam.render_fast(jfar, jnp.asarray(pos), jnp.asarray(quat),
                                  crop, jnear), fx.numpy(), fy.numpy(),
            "render_fast, two windows")
        one = tcam.render_fast(tfar, t(pos), t(quat), crop)
        assert (got != one).any()          # the near window clamps sooner

    def test_lidar_matches_jax(self, worlds):
        """Beam ranges: the sample tables within an ulp of the reference's
        (XLA rounds some entries apart); at most 1 % of the beams stop at
        another sample (the beams go through cos and sin, whose ulps
        differ, so a sample at a cell edge can fall on either side; measured
        0 of 2880)."""
        jt, tt = worlds[False]
        pos, quat = poses(seed=4, n=8)
        got = tcam.lidar_ranges(tt.colormap, t(pos), t(quat)).numpy()
        want = np.asarray(jcam.lidar_ranges(jt.colormap, jnp.asarray(pos),
                                            jnp.asarray(quat)))
        assert got.shape == (8, 360)
        for args in ((0.1, 10.0, 64), (0.0, 2 * np.pi, 360, False)):
            np.testing.assert_allclose(
                tcam._linspace(*args),
                np.asarray(jax.jit(lambda: jnp.linspace(*args))()),
                rtol=2e-7, atol=1e-6)
        assert (got < 10.0).mean() > 0.3
        other_sample = ~np.isclose(got, want, rtol=1e-6, atol=0)
        assert other_sample.mean() <= 1e-2, other_sample.mean()
        g = torch.Generator().manual_seed(0)
        noisy = tcam.lidar_ranges_normalized(tt.colormap, t(pos), t(quat), g)
        assert noisy.shape == (8, 360)
        assert 0.0 <= float(noisy.min()) and float(noisy.max()) <= 1.0


# ---------------------------------------------------------------------------
# augmentation
# ---------------------------------------------------------------------------


class TestAugment:
    def test_augmentation_with_jax_draws_matches(self):
        rng = np.random.default_rng(2)
        imgs = rng.random((16, 40, 80)).astype(np.float32)
        imgs[:4] = (imgs[:4] > 0.5)          # binary worlds too
        key = jax.random.PRNGKey(11)
        want = np.asarray(jaug.augment_images(jnp.asarray(imgs), key))
        k_b, k_c, k_s = jax.random.split(key, 3)
        draws = (jax.random.uniform(k_b, (16,), minval=0.2, maxval=1.8),
                 jax.random.uniform(k_c, (16,), minval=0.8, maxval=1.2),
                 jax.random.uniform(k_s, (16,), minval=0.1, maxval=5.0))
        got = taug.augment_images_with(t(imgs), *map(t, draws))
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6)

    def test_draws_in_range_and_crop(self):
        g = torch.Generator().manual_seed(1)
        bf, cf, sigma = taug.augmentation_draws(1000, g, "cpu")
        for x, lo, hi in ((bf, 0.2, 1.8), (cf, 0.8, 1.2), (sigma, 0.1, 5.0)):
            assert lo <= float(x.min()) and float(x.max()) <= hi
        out = taug.augment_images(torch.full((4, 60, 80), 0.5), g)
        assert out.shape == (4, 60, 80)
        flat = taug.crop_gray_normalize_flatten(torch.ones((4, 60, 80)))
        np.testing.assert_array_equal(
            flat.numpy(), np.asarray(jaug.crop_gray_normalize_flatten(
                jnp.ones((4, 60, 80)))))


# ---------------------------------------------------------------------------
# env
# ---------------------------------------------------------------------------


def pair(n=N, key=0, **kw):
    """(JAX env on its K2 path in interpret mode, its reset state and obs,
    the port's env, the port's copy of the state)."""
    cfg = dict(num_envs=n, **SMALL, **kw)
    jenv = j_env(JVisualTaskCfg(**cfg))
    jenv._use_pallas = True          # the flat kernel ...
    jenv._pallas_interpret = True    # ... in interpreter mode
    js, jobs = jax.jit(jenv.reset)(jax.random.PRNGKey(key))
    tenv = make_visual_env(VisualTaskCfg(**cfg), device="cpu")
    return jenv, js, jobs, tenv, env_state_from_jax(to_np(js))


def actions(step, n=N):
    return np.stack([np.full((n,), 0.6, np.float32),
                     np.full((n,), 0.8 * np.sin(0.7 * step), np.float32)], -1)


class TestEnvParity:
    @pytest.mark.parametrize("variant", [
        {}, {"exact_render": True},
        {"obs_variant": "rgb_flattened", "color_sampling": True}])
    def test_reset_obs_matches_jax(self, variant):
        """The 3208-wide observation of the carried-over reset state, noise
        off (no draws), for the window-atlas render, the exact render and
        the RGB variant: the camera by the pixel rule (to 1e-6 for the RGB
        variant's luma), the rest within 1e-6."""
        _, js, jobs, tenv, ts = pair(key=1, enable_corruption=False,
                                     **variant)
        obs = tenv.task.observe(tenv._make_ctx(ts, ts.vehicle), None)
        jobs = np.asarray(jobs)
        assert obs.shape == (N, VISUAL_OBS_DIM) == jobs.shape
        v = ts.vehicle
        if variant:
            hit = tcam.ground_hits(v.pos, v.quat)[0][:, 20:]
            hx, hy = hit[..., 0], hit[..., 1]
        else:
            _, hx, hy, _ = tcam.ground_hits_planar(v.pos, v.quat, 20)
        assert_pixel_rule(obs[:, :CAMERA_OBS].reshape(N, 40, 80),
                          jobs[:, :CAMERA_OBS].reshape(N, 40, 80),
                          hx.numpy(), hy.numpy(), f"reset obs {variant}",
                          atol=1e-6)
        np.testing.assert_allclose(obs[:, CAMERA_OBS:].numpy(),
                                   jobs[:, CAMERA_OBS:], atol=1e-6)

    def test_eight_steps_match_jax(self):
        """8 steps with the same actions, DR on (the params are carried
        over), noise off: every rew/*, done/*, metrics/* value, reward, done
        and time-out on envs that have not reset, and the post-step state
        and observation (the camera by the pixel rule)."""
        jenv, js, _, tenv, ts = pair(key=2, enable_corruption=False)
        jstep = jax.jit(jenv.step)
        xy0 = np.asarray(js.vehicle_mem)[0:2].copy()
        alive = np.ones((N,), bool)
        for step in range(8):
            a = actions(step)
            js, jout = jstep(js, jnp.asarray(a))
            ts, tout = tenv.step(ts, torch.from_numpy(a))
            assert sorted(tout.info) == sorted(jout.info)
            for name, got, want in (
                    ("done", tout.done, jout.done),
                    ("time_out", tout.time_out, jout.time_out),
                    *((k, tout.info[k], jout.info[k]) for k in jout.info
                      if k.startswith("done/"))):
                np.testing.assert_array_equal(
                    got.numpy()[alive], np.asarray(want)[alive],
                    err_msg=f"{name} step {step}")
            for name, got, want in (
                    ("reward", tout.reward, jout.reward),
                    *((k, tout.info[k], jout.info[k]) for k in jout.info
                      if not k.startswith("done/"))):
                np.testing.assert_allclose(
                    got.numpy().astype(np.float32)[alive],
                    np.asarray(want, np.float32)[alive], **REWARD_TOL,
                    err_msg=f"{name} step {step}")
            alive &= ~np.asarray(jout.done)
            np.testing.assert_allclose(
                ts.vehicle_mem.numpy()[:, alive],
                np.asarray(js.vehicle_mem)[:, alive], **STATE_TOL,
                err_msg=f"state step {step}")
            obs, jobs = tout.obs.numpy()[alive], np.asarray(jout.obs)[alive]
            v = ts.vehicle
            _, hx, hy, _ = tcam.ground_hits_planar(v.pos, v.quat, 20)
            assert_pixel_rule(
                obs[:, :CAMERA_OBS].reshape(-1, 40, 80),
                jobs[:, :CAMERA_OBS].reshape(-1, 40, 80),
                hx.numpy()[alive], hy.numpy()[alive], f"obs step {step}")
            np.testing.assert_allclose(obs[:, CAMERA_OBS:],
                                       jobs[:, CAMERA_OBS:], **OBS_TOL,
                                       err_msg=f"obs step {step}")
        assert alive.sum() >= N // 2
        moved = np.abs(np.asarray(js.vehicle_mem)[0:2] - xy0).max()
        assert moved > 0.5, "the cars did not move"
        assert ts.common_step == int(js.common_step) == 8

    def test_convert_carries_ground_friction_without_packed_params(self):
        """A JAX state of the XLA path has no packed params: the port packs
        them with the visual ground friction 2.0, as the kernel path did."""
        jenv = j_env(JVisualTaskCfg(num_envs=8, **SMALL))
        js, _ = jax.jit(jenv.reset)(jax.random.PRNGKey(3))
        _, kjs, _, _, _ = pair(n=8, key=3)
        assert js.packed_params is None
        np.testing.assert_array_equal(
            env_state_from_jax(to_np(js), ground_friction=2.0)
            .packed_params.numpy(), np.asarray(kjs.packed_params))


# The JAX env's own spread of the golden statistics: the largest
# |stat - golden| over 8 (reset, action) seed pairs of
# tests/test_golden.py::compute_visual_stats, (2468, 1357) and (1, 2) ...
# (13, 14), the fast/exact render compared on the reset of key 99 and of
# the pair's first seed, measured on the CPU.
JAX_SPREAD = {
    "reward_mean": 0.2416, "reward_std": 0.1756, "speed_mean": 0.06850,
    "speed_max": 0.2714, "xy_abs_mean": 3.560, "z_mean": 0.000379,
    "done_frac": 0.009375, "cam_mean": 0.1519, "cam_std": 0.03546,
    "fast_exact_diff_frac": 0.002422,
}
SPREAD_MARGIN = 1.25


def test_golden_statistics_within_jax_spread():
    """A port rollout of the golden visual config (8 envs, 40 steps of
    uniform random actions, tests/test_golden.py:77-113): every statistic
    within SPREAD_MARGIN x the JAX env's own spread of the golden value."""
    env = make_visual_env(VisualTaskCfg(num_envs=8, **SMALL), device="cpu",
                          seed=0)
    g = torch.Generator().manual_seed(1000)
    state, _ = env.reset()
    rew, pos, vel, done, obs = [], [], [], [], []
    for _ in range(40):
        state, out = env.step(state, torch.rand((8, 2), generator=g) * 2 - 1)
        v = state.vehicle
        for acc, x in ((rew, out.reward), (pos, v.pos), (vel, v.lin_vel),
                       (done, out.done), (obs, out.obs)):
            acc.append(x)
    rew, pos, vel, done, obs = map(torch.stack, (rew, pos, vel, done, obs))
    speed = torch.linalg.vector_norm(vel[..., :2], dim=-1)
    cam = obs[..., :CAMERA_OBS]
    v = env.reset()[0].vehicle
    crop = tcam.HEIGHT // 3
    cm = env.task.colormap
    exact = tcam.render(cm, v.pos, v.quat)[:, crop:, :]
    fast = tcam.render_fast(tcam.ColorMapAtlas.build(cm), v.pos, v.quat,
                            crop_top=crop)
    got = {
        "reward_mean": rew.mean(), "reward_std": rew.std(correction=0),
        "speed_mean": speed.mean(), "speed_max": speed.max(),
        "xy_abs_mean": pos[..., :2].abs().mean(), "z_mean": pos[..., 2].mean(),
        "done_frac": done.float().mean(), "cam_mean": cam.mean(),
        "cam_std": cam.std(correction=0),
        "fast_exact_diff_frac": ((exact - fast).abs() > 0.5).float().mean(),
    }
    golden = json.load(open(os.path.join(os.path.dirname(__file__),
                                         "golden_visual.json")))
    assert sorted(golden) == sorted(got) == sorted(JAX_SPREAD)
    for k, ref in golden.items():
        assert abs(float(got[k]) - ref) <= SPREAD_MARGIN * JAX_SPREAD[k], \
            f"{k}: port {float(got[k])}, golden {ref}"


# ---------------------------------------------------------------------------
# harness
# ---------------------------------------------------------------------------


class TestHarness:
    def test_task_and_run_config_are_registered(self):
        import wheeledlab_torch.rl  # noqa: F401  registers run configs
        from wheeledlab_tpu.rl import run_cfgs as jcfgs
        from wheeledlab_torch.tasks import resolve_task
        from wheeledlab_torch.utils.config import RUN_CONFIGS

        entry = resolve_task("Isaac-MushrVisualRL-v0")
        assert entry["cfg"] == VisualTaskCfg()
        assert entry["play_cfg"] == VisualTaskCfg(terminations_enabled=False,
                                                  rewards_enabled=False)
        cfg = RUN_CONFIGS.get("RSS_VISUAL_CONFIG")
        want = jcfgs.RSS_VISUAL_CONFIG
        assert (cfg.task_name, cfg.num_envs, cfg.train.num_iterations,
                cfg.env_overrides, cfg.agent.activation,
                cfg.agent.fuse_input_layer) == (
            want.task_name, want.num_envs, want.train.num_iterations,
            want.env_overrides, want.agent.activation,
            want.agent.fuse_input_layer) == (
            "MushrVisualRL-v0", 512, 4000, {"color_sampling": True}, "relu",
            True)
        import dataclasses

        assert dataclasses.asdict(VisualTaskCfg()) == dataclasses.asdict(
            JVisualTaskCfg())
        env = make_env("MushrVisualRL-v0", num_envs=4, play=True,
                       overrides=SMALL, device="cpu")
        state, obs = env.reset()
        state, out = env.step(state, torch.zeros((4, 2)))
        assert (out.reward == 0).all() and torch.isfinite(out.obs).all()
        assert sorted(out.info) == [
            "done/time_out", "episode_length", "episode_return",
            "metrics/forward_vel", "metrics/traversable_frac"]
        assert env.task.terrain.is_flat and env.task.terrain.friction == 2.0

    def test_visual_iteration_and_policy_view_clips(self, tmp_path):
        """One RSS_VISUAL_CONFIG iteration at 8 envs on a 100 x 100 map:
        finite, `traj/quat` captured, and the policy-view clip written by
        training and by `cli/play.py --video`."""
        import wheeledlab_torch.rl  # noqa: F401
        from wheeledlab_torch.cli import play
        from wheeledlab_torch.rl.ppo import traj_captures
        from wheeledlab_torch.rl.runner import train
        from wheeledlab_torch.utils.config import RUN_CONFIGS, override

        cfg = RUN_CONFIGS.get("RSS_VISUAL_CONFIG")
        cfg = cfg.replace(env_overrides={**cfg.env_overrides, **SMALL})
        for k, v in (("num_envs", 8), ("train.num_iterations", 1),
                     ("train.log.logs_dir", str(tmp_path)),
                     ("train.log.run_name", "vis"),
                     ("train.log.log_every", 1), ("train.log.video", True),
                     ("train.log.video_interval", 1),
                     ("train.log.video_length", 6), ("device", "cpu")):
            cfg = override(cfg, k, v)
        state, last = train(cfg, verbose=False)
        assert state.obs.shape == (8, VISUAL_OBS_DIM)
        assert torch.isfinite(state.obs).all()
        for k in ("loss/total", "loss/surrogate", "loss/value",
                  "metrics/traversable_frac"):
            assert np.isfinite(last[k]), k
        cap = traj_captures(state.env_state)
        np.testing.assert_array_equal(cap["traj/quat"].numpy(),
                                      state.env_state.vehicle.quat[:8].numpy())
        vids = os.listdir(tmp_path / "vis" / "videos")
        assert sorted(v.split(".")[0] for v in vids) == [
            "iter_1", "iter_1-policyview"]
        clip = [v for v in vids if "policyview" in v][0]
        if clip.endswith(".npy"):
            frames = np.load(tmp_path / "vis" / "videos" / clip)
            assert frames.shape == (6, 240, 320, 3)
        play.main(["--run", "vis", "--logs-dir", str(tmp_path), "--steps",
                   "4", "--num-envs", "2", "--video", "--device", "cpu"])
        names = [f.split(".")[0] for f in os.listdir(tmp_path / "vis"
                                                     / "play")]
        assert "vis-policyview" in names and "vis" in names
        npz = np.load(tmp_path / "vis" / "play" / "vis-rollouts.npz")
        assert npz["observations"].shape == (4, 2, VISUAL_OBS_DIM)
        assert "quats" not in npz.files


# ---------------------------------------------------------------------------
# repairs
# ---------------------------------------------------------------------------


class TestRepairs:
    def test_video_help_matches_jax(self):
        from wheeledlab_tpu.cli import train as jtrain
        from wheeledlab_torch.cli import train as ttrain

        helps = [{a.dest: a.help for a in m.build_parser()._actions}["video"]
                 for m in (ttrain, jtrain)]
        assert helps[0] == helps[1] and "not ported" not in helps[0]

    def test_rwd_wheel_targets_divide_by_the_radius(self):
        """The rwd map's wheel targets are the scaled throttle divided by
        0.05 in float32 (not multiplied by 20), bit for bit."""
        from wheeledlab_torch.assets.robots import MUSHR_RWD_ACTION
        from wheeledlab_torch.sim.actions import action_to_targets

        raw = np.random.default_rng(0).uniform(-1, 1, (10000, 2)).astype(
            np.float32)
        _, wheel = action_to_targets(torch.from_numpy(raw), MUSHR_RWD_ACTION)
        v = np.maximum(raw[:, 0] * np.float32(3.0), np.float32(0.0))
        want = v / np.float32(0.05)
        assert (want != v * np.float32(20.0)).any()
        np.testing.assert_array_equal(wheel[:, 0].numpy(), want)
        np.testing.assert_array_equal(wheel[:, 1].numpy(), want)
        assert (wheel[:, 2:] == 0).all()


if __name__ == "__main__":
    import sys

    sys.exit(pytest.main([__file__, "-x", "-q"]))
