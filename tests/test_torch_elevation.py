"""Parity of the port's elevation task through the generic manager step
(`wheeledlab_torch/envs/env.py`, kernel K3's plain version on the CPU) with
the JAX elevation env on its heightfield kernel path (`pallas_step_hf` in
interpret mode), and the port's rollout statistics against
tests/golden_elevation.json.

JAX threefry streams cannot be reproduced, so the port is fed the JAX
heightfield (`convert.heightfield_from_jax`) and a JAX env state
(`convert.env_state_from_jax`). With DR events off (observation noise is off
by default) neither env draws a random number until a reset fires, so envs
that have not reset must agree step for step."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wheeledlab_tpu.tasks.elevation.task import (
    ElevationTaskCfg as JElevationTaskCfg,
)
from wheeledlab_tpu.tasks.elevation.task import make_elevation_env as j_env
from wheeledlab_tpu.tasks.elevation import task as jtask
from wheeledlab_torch.convert import env_state_from_jax, heightfield_from_jax
from wheeledlab_torch.tasks import make_env
from wheeledlab_torch.tasks.elevation import task as ttask
from wheeledlab_torch.tasks.elevation.task import (
    ELEV_OBS_DIM, SCAN_N, ElevationTaskCfg, make_elevation_env,
)

torch.set_num_threads(1)

N = 32
SMALL = dict(terrain_extent=20.0, num_mounds=10)
# Tolerances of the step-by-step comparison: the same float32 operations in
# the same order, up to the packages' libm ulps amplified by 10 stiff
# substeps a step (measured over 8 steps: state 7e-4 on wheel rates ~80,
# reward 2.4e-4 on rewards ~100, obs 1e-4, metrics 4e-6)
STATE_TOL = dict(rtol=1e-5, atol=2e-3)
REWARD_TOL = dict(rtol=1e-5, atol=2e-3)
OBS_TOL = dict(rtol=1e-5, atol=1e-3)


def to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def pair(n=N, key=0, **kw):
    """(JAX env on its heightfield kernel path, its reset state and obs,
    the port's env on the same terrain, the port's copy of the state)."""
    cfg = dict(num_envs=n, **SMALL, **kw)
    jenv = j_env(JElevationTaskCfg(**cfg))
    jenv._use_pallas_hf = True        # the heightfield kernel ...
    jenv._pallas_interpret = True     # ... in interpreter mode
    js, jobs = jax.jit(jenv.reset)(jax.random.PRNGKey(key))
    tenv = make_elevation_env(
        ElevationTaskCfg(**cfg), device="cpu",
        terrain=heightfield_from_jax(to_np(jenv.task.terrain)))
    return jenv, js, jobs, tenv, env_state_from_jax(to_np(js))


def actions(t, n=N):
    return np.stack([np.full((n,), 0.5, np.float32),
                     np.full((n,), 0.3 * np.sin(0.5 * t), np.float32)], -1)


class TestEnvParity:
    def test_reset_obs_matches_jax(self):
        """The 689-wide observation of the carried-over reset state: the
        26 x 26 scan by corner gather equals the reference's one-hot
        contraction (measured max difference 3e-7)."""
        _, js, jobs, tenv, ts = pair(key=1)
        obs = tenv.task.observe(tenv._make_ctx(ts, ts.vehicle), None)
        assert obs.shape == (N, ELEV_OBS_DIM) == np.asarray(jobs).shape
        np.testing.assert_allclose(obs.numpy(), np.asarray(jobs), atol=1e-5)

    def test_eight_steps_match_jax(self):
        """8 steps with the same actions. Half the envs start with their
        goal under them, so the at_goal termination and the auto-reset fire
        there. Every rew/*, done/*, metrics/* value, reward, done and
        time_out agrees on every env that has not reset before; the
        post-reset obs and state on those that did not reset now."""
        jenv, js, _, tenv, _ = pair(events_enabled=False)
        pos = np.asarray(js.vehicle.pos)
        command = np.asarray(js.command).copy()
        command[: N // 2, :2] = pos[: N // 2, :2]
        js = js.replace(command=jnp.asarray(command))
        ts = env_state_from_jax(to_np(js))
        jstep = jax.jit(jenv.step)
        alive = np.ones((N,), bool)
        fired = 0
        for t in range(8):
            a = actions(t)
            js, jout = jstep(js, jnp.asarray(a))
            ts, tout = tenv.step(ts, torch.from_numpy(a))
            assert sorted(tout.info) == sorted(jout.info)
            done = np.asarray(jout.done)
            for name, got, want in (
                    ("done", tout.done, jout.done),
                    ("time_out", tout.time_out, jout.time_out),
                    *((k, tout.info[k], jout.info[k]) for k in jout.info
                      if k.startswith("done/"))):
                np.testing.assert_array_equal(
                    got.numpy()[alive], np.asarray(want)[alive],
                    err_msg=f"{name} step {t}")
            for name, got, want in (
                    ("reward", tout.reward, jout.reward),
                    *((k, tout.info[k], jout.info[k]) for k in jout.info
                      if not k.startswith("done/"))):
                np.testing.assert_allclose(
                    got.numpy().astype(np.float32)[alive],
                    np.asarray(want, np.float32)[alive], **REWARD_TOL,
                    err_msg=f"{name} step {t}")
            fired += int(done[alive].sum())
            alive &= ~done
            np.testing.assert_allclose(
                tout.obs.numpy()[alive], np.asarray(jout.obs)[alive],
                **OBS_TOL, err_msg=f"obs step {t}")
            np.testing.assert_allclose(
                ts.vehicle_mem.numpy()[:, alive],
                np.asarray(js.vehicle_mem)[:, alive], **STATE_TOL,
                err_msg=f"state step {t}")
            for name in ("step_count", "command_timer", "ep_len"):
                np.testing.assert_array_equal(
                    getattr(ts, name).numpy()[alive],
                    np.asarray(getattr(js, name))[alive], err_msg=name)
        assert fired >= N // 4, "the at_goal resets did not fire"
        assert alive.sum() >= N // 4, "too many resets for a parity check"
        assert ts.common_step == int(js.common_step) == 8

    def test_curriculum_weights_match_jax_across_an_increase(self):
        """From global step 9795, 10 steps cross the first increase
        (episode 49 of 200 steps ends at 9800): the port's host closed form
        gives the reference's traced weights at every step."""
        jenv, js, _, tenv, ts = pair(n=8, events_enabled=False)
        js = js.replace(common_step=jnp.int32(9795))
        ts = dataclasses.replace(ts, common_step=9795)
        jstep = jax.jit(jenv.step)
        seen = set()
        for t in range(10):
            a = actions(t, 8)
            js, _ = jstep(js, jnp.asarray(a))
            ts, _ = tenv.step(ts, torch.from_numpy(a))
            np.testing.assert_array_equal(ts.reward_weights.numpy(),
                                          np.asarray(js.reward_weights))
            seen.add(tuple(ts.reward_weights.tolist()))
        assert len(seen) == 2, "no increase was crossed"


class TestTerms:
    @pytest.fixture(scope="class")
    def envs(self):
        return pair(n=8, key=2)

    def edge_ctx(self, envs):
        """Both packages' step contexts on the same edge states: flipped,
        tilted, still with spinning wheels, at the goal, below the ground."""
        jenv, js, _, tenv, _ = envs
        v = to_np(js.vehicle)
        quat = np.asarray(v.quat).copy()
        quat[0] = [0.0, 1.0, 0.0, 0.0]                    # rolled over
        quat[1] = [np.cos(0.55), np.sin(0.55), 0.0, 0.0]  # 63 deg roll
        lin_vel = np.asarray(v.lin_vel).copy()
        lin_vel[2:4] = 0.0
        lin_vel[4] = [0.0, 0.0, 0.5]                      # falling
        wheel = np.asarray(v.wheel_omega).copy()
        wheel[2:4] = 10.0                                 # stuck, spinning
        pos = np.asarray(v.pos).copy()
        pos[5, 2] -= 0.08                                 # below height
        command = np.asarray(js.command).copy()
        command[6, :2] = pos[6, :2] + 0.3                 # at goal
        veh = js.vehicle.replace(
            pos=jnp.asarray(pos), quat=jnp.asarray(quat),
            lin_vel=jnp.asarray(lin_vel), wheel_omega=jnp.asarray(wheel))
        js = js.with_vehicle(veh).replace(command=jnp.asarray(command))
        jctx = jenv._make_ctx(js, js.vehicle, None)
        ts = env_state_from_jax(to_np(js))
        return jctx, tenv._make_ctx(ts, ts.vehicle)

    def test_terminations_match_jax(self, envs):
        jctx, tctx = self.edge_ctx(envs)
        jfns, tfns = envs[0].task.termination_fns, envs[3].task.termination_fns
        assert sorted(jfns) == sorted(tfns)
        for name in jfns:
            want = np.asarray(jfns[name](jctx))
            np.testing.assert_array_equal(tfns[name](tctx).numpy(), want,
                                          err_msg=name)
            assert want.any(), f"{name} never fires on the edge states"

    def test_rewards_and_metrics_match_jax(self, envs):
        jctx, tctx = self.edge_ctx(envs)
        flags = {k: f(jctx) for k, f in envs[0].task.termination_fns.items()}
        jctx = jctx._replace(term_flags=flags)
        tctx = tctx._replace(term_flags={
            k: f(tctx) for k, f in envs[3].task.termination_fns.items()})
        for jt, tt in zip(envs[0].task.reward_terms,
                          envs[3].task.reward_terms):
            assert (jt.name, jt.weight) == (tt.name, tt.weight)
            np.testing.assert_allclose(tt.fn(tctx).numpy(),
                                       np.asarray(jt.fn(jctx)), atol=1e-5,
                                       err_msg=jt.name)
        for name, fn in envs[0].task.metric_fns.items():
            np.testing.assert_allclose(
                envs[3].task.metric_fns[name](tctx).numpy(),
                np.asarray(fn(jctx)), atol=1e-5, err_msg=name)

    def test_goal_variant_adds_the_bonus_term(self):
        cfg = ElevationTaskCfg(num_envs=4, at_goal_bonus=200000.0, **SMALL)
        names = [t.name for t in make_elevation_env(
            cfg, device="cpu").task.reward_terms]
        assert names[-1] == "at_goal_bonus" and len(names) == 5
        assert ttask.ElevationTaskCfg() == ttask.ElevationTaskCfg(
            **dataclasses.asdict(jtask.ElevationTaskCfg()))


class TestMath:
    def test_quaternion_helpers_match_jax(self):
        """up_dot (rollover), yaw_from_quat (playback), matrix_from_quat
        and wrap_to_pi against the reference's on random quaternions."""
        from wheeledlab_tpu.utils import math as jmath
        from wheeledlab_torch.utils import math as tmath

        rng = np.random.default_rng(11)
        q = rng.standard_normal((64, 4)).astype(np.float32)
        q /= np.linalg.norm(q, axis=-1, keepdims=True)
        angle = rng.uniform(-20, 20, 64).astype(np.float32)
        tq, jq = torch.from_numpy(q), jnp.asarray(q)
        for name, tx, jx in (("up_dot", tq, jq), ("yaw_from_quat", tq, jq),
                             ("matrix_from_quat", tq, jq),
                             ("wrap_to_pi", torch.from_numpy(angle),
                              jnp.asarray(angle))):
            np.testing.assert_allclose(
                getattr(tmath, name)(tx).numpy(),
                np.asarray(getattr(jmath, name)(jx)), atol=1e-6,
                err_msg=name)


class TestPlayVariant:
    def test_play_variant_steps_without_rewards(self):
        env = make_env("MushrElevationRL-v0", num_envs=4, play=True,
                       overrides=SMALL, device="cpu")
        state, obs = env.reset()
        assert obs.shape == (4, ELEV_OBS_DIM)
        for _ in range(3):
            state, out = env.step(state, torch.zeros((4, 2)))
        assert (out.reward == 0).all() and torch.isfinite(out.obs).all()
        assert sorted(out.info) == [
            "done/time_out", "episode_length", "episode_return",
            "metrics/goal_dist", "metrics/ground_height"]


# The JAX env's own spread of the golden statistics: the largest
# |stat - golden| over 8 (reset, action) seed pairs of
# tests/test_golden.py::compute_elevation_stats, (4321, 8765) and (1, 2) ...
# (13, 14), measured on the CPU. The golden's own seed pair is at the low
# end of the reward distribution (8-seed mean 233.6, std 22.3).
JAX_SPREAD = {
    "reward_mean": 77.57, "reward_std": 33.10, "speed_mean": 0.1037,
    "speed_max": 0.4258, "xy_abs_mean": 0.7395, "z_mean": 0.1467,
    "done_frac": 0.001042, "scan_mean": 0.01318, "scan_std": 0.01312,
    "scan_absmax": 0.01282,
}
# one more rollout may fall a little outside 8 samples' range
SPREAD_MARGIN = 1.25


def test_golden_statistics_within_jax_spread():
    """A port rollout of the golden elevation config (16 envs, 60 steps of
    uniform random actions, tests/test_golden.py:59-74) on the JAX
    heightfield: every statistic within SPREAD_MARGIN x the JAX env's own
    spread of the golden value."""
    from wheeledlab_tpu.tasks.elevation.task import make_elevation_task

    kw = dict(num_envs=16, spawn_range=8.0, goal_range=8.0, **SMALL)
    terrain = heightfield_from_jax(
        to_np(make_elevation_task(JElevationTaskCfg(**kw)).terrain))
    env = make_elevation_env(ElevationTaskCfg(**kw), device="cpu", seed=0,
                             terrain=terrain)
    g = torch.Generator().manual_seed(1000)
    state, _ = env.reset()
    rew, pos, vel, done, obs = [], [], [], [], []
    for _ in range(60):
        state, out = env.step(state, torch.rand((16, 2), generator=g) * 2 - 1)
        v = state.vehicle
        for acc, x in ((rew, out.reward), (pos, v.pos), (vel, v.lin_vel),
                       (done, out.done), (obs, out.obs)):
            acc.append(x)
    rew, pos, vel, done, obs = map(torch.stack, (rew, pos, vel, done, obs))
    speed = torch.linalg.vector_norm(vel[..., :2], dim=-1)
    scan = obs[..., -SCAN_N * SCAN_N:]
    got = {
        "reward_mean": rew.mean(), "reward_std": rew.std(correction=0),
        "speed_mean": speed.mean(), "speed_max": speed.max(),
        "xy_abs_mean": pos[..., :2].abs().mean(), "z_mean": pos[..., 2].mean(),
        "done_frac": done.float().mean(), "scan_mean": scan.mean(),
        "scan_std": scan.std(correction=0), "scan_absmax": scan.abs().max(),
    }
    golden = json.load(open(os.path.join(os.path.dirname(__file__),
                                         "golden_elevation.json")))
    assert sorted(golden) == sorted(got) == sorted(JAX_SPREAD)
    for k, ref in golden.items():
        assert abs(float(got[k]) - ref) <= SPREAD_MARGIN * JAX_SPREAD[k], \
            f"{k}: port {float(got[k])}, golden {ref}"


if __name__ == "__main__":
    import sys

    sys.exit(pytest.main([__file__, "-x", "-q"]))
