"""Parity of the port's drift env (`wheeledlab_torch/envs/env.py` with the
fused step) with the JAX fused path on the CPU.

A JAX env state is carried across with `convert.env_state_from_jax`; both
envs then step with the same actions. With events and observation noise
off, the paths draw no randomness until a reset fires, so never-reset envs
must agree (tolerances of tests/test_fused_drift.py:55-71)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wheeledlab_tpu.tasks.drift.task import DriftTaskCfg as JTaskCfg
from wheeledlab_tpu.tasks.drift.task import make_drift_env as j_make_env
from wheeledlab_tpu.tasks.drift.task import (
    reference_track_poses as j_track_poses,
)
from wheeledlab_torch.convert import env_state_from_jax
from wheeledlab_torch.tasks import make_env
from wheeledlab_torch.tasks.common.observations import blind_obs
from wheeledlab_torch.tasks.drift.task import (
    DriftTaskCfg, make_drift_env, reference_track_poses,
)

torch.set_num_threads(1)


def jax_fused_env(**kw):
    env = j_make_env(JTaskCfg(**kw))
    env._use_pallas = True           # the fused kernel ...
    env._pallas_interpret = True     # ... in interpreter mode
    return env


def to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def pair(n=32, key=0, **kw):
    """(JAX env, JAX state, JAX reset obs, port env, port state)."""
    jenv = jax_fused_env(num_envs=n, **kw)
    js, jobs = jax.jit(jenv.reset)(jax.random.PRNGKey(key))
    tenv = make_drift_env(DriftTaskCfg(num_envs=n, **kw), device="cpu")
    return jenv, js, jobs, tenv, env_state_from_jax(to_np(js))


class TestEnvParity:
    @pytest.mark.parametrize("robot", ["mushr", "f1tenth"])
    def test_short_horizon_matches_jax(self, robot):
        jenv, js, _, tenv, ts = pair(robot=robot, events_enabled=False,
                                     enable_corruption=False)
        jstep = jax.jit(jenv.step)
        alive = np.ones((32,), bool)
        for t in range(10):
            a = np.stack([np.full((32,), 0.6, np.float32),
                          np.full((32,), 0.4 * np.sin(0.7 * t), np.float32)],
                         -1)
            js, jout = jstep(js, jnp.asarray(a))
            ts, tout = tenv.step(ts, torch.from_numpy(a))
            np.testing.assert_array_equal(
                tout.done.numpy()[alive], np.asarray(jout.done)[alive])
            alive &= ~np.asarray(jout.done)
            assert alive.sum() >= 16, "too many resets for a parity check"
            np.testing.assert_allclose(
                ts.vehicle.pos.numpy()[alive],
                np.asarray(js.vehicle.pos)[alive], atol=1e-3,
                err_msg=f"pos step {t}")
            np.testing.assert_allclose(
                ts.vehicle.lin_vel.numpy()[alive],
                np.asarray(js.vehicle.lin_vel)[alive], atol=5e-3,
                err_msg=f"vel step {t}")
            np.testing.assert_allclose(
                tout.reward.numpy()[alive], np.asarray(jout.reward)[alive],
                atol=3e-2, err_msg=f"reward step {t}")
            np.testing.assert_allclose(
                tout.obs.numpy()[alive], np.asarray(jout.obs)[alive],
                atol=1e-2, err_msg=f"obs step {t}")
            np.testing.assert_array_equal(
                ts.step_count.numpy()[alive],
                np.asarray(js.step_count)[alive])

    def test_info_keys_and_counters_match(self):
        jenv, js, _, tenv, ts = pair(key=3, events_enabled=False,
                                     enable_corruption=False)
        a = np.zeros((32, 2), np.float32)
        js, jout = jax.jit(jenv.step)(js, jnp.asarray(a))
        ts, tout = tenv.step(ts, torch.from_numpy(a))
        assert sorted(tout.info) == sorted(jout.info)
        assert ts.common_step == int(js.common_step) == 1
        for k in jout.info:
            np.testing.assert_allclose(
                tout.info[k].numpy().astype(np.float32),
                np.asarray(jout.info[k], np.float32), atol=3e-2, err_msg=k)

    def test_curriculum_weights_match_after_45_steps(self):
        """After 45 steps (2 episodes of 20) the port's host closed form of
        the curriculum gives the reference's traced weights, and agrees out
        to where every increase has fired."""
        jenv, js, _, tenv, ts = pair(n=8, episode_length_s=0.4)
        jstep = jax.jit(jenv.step)
        a = np.zeros((8, 2), np.float32)
        for _ in range(45):
            js, _ = jstep(js, jnp.asarray(a))
            ts, _ = tenv.step(ts, torch.from_numpy(a))
        np.testing.assert_array_equal(ts.reward_weights.numpy(),
                                      np.asarray(js.reward_weights))
        assert ts.common_step == 45
        for step in (399, 400, 4000, 21000, 10**6):
            np.testing.assert_array_equal(
                tenv._curriculum_weights(ts.reward_weights, step).numpy(),
                np.asarray(jenv._curriculum_weights(js.reward_weights,
                                                    jnp.int32(step))),
                err_msg=str(step))

    def test_reset_obs_matches_blind_obs(self):
        """The reset observation (exact euler angles, no noise) of the
        port on the carried-over state equals JAX's."""
        _, js, jobs, tenv, ts = pair(key=1, enable_corruption=False)
        got = blind_obs(tenv._make_ctx(ts, ts.vehicle), None, False)
        np.testing.assert_allclose(got.numpy(), np.asarray(jobs), atol=1e-6)

    def test_converts_either_carry_layout(self):
        """The generic-path (AoS VehicleState) and fused-path (packed rows)
        JAX states of the same reset convert to the same port state."""
        cfg = JTaskCfg(num_envs=16)
        generic = j_make_env(cfg)
        fused = jax_fused_env(num_envs=16)
        key = jax.random.PRNGKey(2)
        sa = env_state_from_jax(to_np(jax.jit(generic.reset)(key)[0]))
        sp = env_state_from_jax(to_np(jax.jit(fused.reset)(key)[0]))
        np.testing.assert_array_equal(sa.vehicle_mem.numpy(),
                                      sp.vehicle_mem.numpy())
        np.testing.assert_array_equal(sa.packed_params.numpy(),
                                      sp.packed_params.numpy())
        assert sa.push_timers.dtype == torch.int32


class TestTask:
    def test_track_poses_match_jax(self):
        cfg = JTaskCfg()
        key = jax.random.PRNGKey(5)
        u = np.asarray(jax.random.uniform(key, (cfg.num_reset_points,)))
        got = reference_track_poses(DriftTaskCfg(), torch.tensor(u))
        np.testing.assert_allclose(got.numpy(),
                                   np.asarray(j_track_poses(key, cfg)),
                                   atol=1e-5)

    def test_reset_and_random_rollout_on_cpu(self):
        """Events and noise on: finite obs of the right shape, int32
        counters, resets along the track."""
        env = make_env("MushrDriftRL-v0", num_envs=64, device="cpu")
        state, obs = env.reset()
        assert obs.shape == (64, 14) and torch.isfinite(obs).all()
        g = torch.Generator().manual_seed(0)
        dones = 0
        for _ in range(60):
            a = torch.rand((64, 2), generator=g) * 2 - 1
            state, out = env.step(state, a)
            dones += int(out.done.sum())
            assert torch.isfinite(out.obs).all()
        assert dones > 0
        for name in ("step_count", "push_timers", "ep_len"):
            assert getattr(state, name).dtype == torch.int32, name
        assert state.push_timers.shape == (2, 64)

    def test_play_variant_resets_and_steps(self):
        """The play variant runs the generic step: no rewards, no
        terminations, the slip and speed metrics, finite observations."""
        env = make_env("MushrDriftRL-v0", num_envs=8, play=True, device="cpu")
        assert env.task.fused_step is None and not env.task.reward_terms
        state, obs = env.reset()
        assert obs.shape == (8, 14) and torch.isfinite(obs).all()
        for _ in range(5):
            state, out = env.step(state, torch.full((8, 2), 0.5))
            assert torch.isfinite(out.obs).all()
        assert sorted(out.info) == ["done/time_out", "episode_length",
                                    "episode_return", "metrics/slip_deg",
                                    "metrics/speed"]
        assert (out.reward == 0).all() and not out.done.any()
        assert state.common_step == 5 and (state.step_count == 5).all()


if __name__ == "__main__":
    import sys

    sys.exit(pytest.main([__file__, "-x", "-q"]))
