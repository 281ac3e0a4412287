"""The rest of the drift family of the port on the CPU, against the JAX
package: the env wrappers, the policy export, the top-down renderer with the
videos of `cli/play.py --video` and of training, and the MPPI demo."""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from test_torch_play import tiny_run
from wheeledlab_tpu import native as jnative
from wheeledlab_tpu.cli.export import flatten_actor_critic as j_flatten
from wheeledlab_tpu.render import topdown as jtopdown
from wheeledlab_tpu.rl.networks import ActorCritic as JActorCritic
from wheeledlab_torch import native as tnative
from wheeledlab_torch.cli import export, play
from wheeledlab_torch.convert import actor_critic_from_jax
from wheeledlab_torch.envs.wrappers import ClipActionEnv, GymVecEnv
from wheeledlab_torch.render import topdown
from wheeledlab_torch.rl.runner import checkpoint_steps
from wheeledlab_torch.scripts import mppi_demo
from wheeledlab_torch.tasks import make_env

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class TestWrappers:
    def test_gym_vec_env(self):
        """As tests/test_harness.py::TestGymAdapter for the JAX adapter."""
        env = GymVecEnv(make_env("MushrDriftRL-v0", num_envs=4, device="cpu"))
        obs, info = env.reset(seed=0)
        assert obs.shape == (4, 14) and info == {}
        obs, rew, term, trunc, info = env.step(np.zeros((4, 2)))
        assert isinstance(obs, np.ndarray) and obs.shape == (4, 14)
        assert rew.shape == (4,)
        assert term.dtype == bool and trunc.dtype == bool
        assert not (term & trunc).any()
        assert info["episode_return"].shape == (4,)
        assert env.single_action_space_shape == (2,)
        assert env.single_observation_space_shape == (14,)
        # reset(seed) reseeds the env's generator: same seed, same episode
        again, _ = env.reset(seed=0)
        first, _ = GymVecEnv(make_env("MushrDriftRL-v0", num_envs=4,
                                      device="cpu")).reset(seed=0)
        np.testing.assert_array_equal(again, first)

    def test_clip_action_env(self):
        env = make_env("MushrDriftRL-v0", num_envs=4, device="cpu", seed=1)
        clipped = ClipActionEnv(make_env("MushrDriftRL-v0", num_envs=4,
                                         device="cpu", seed=1))
        assert (clipped.num_envs, clipped.obs_dim, clipped.action_dim,
                clipped.max_episode_length) == (4, 14, 2,
                                                env.max_episode_length)
        state, _ = env.reset()
        cstate, _ = clipped.reset()
        wild = torch.tensor([[5.0, -7.0], [0.3, 0.2], [-1.5, 9.0],
                             [1.0, -1.0]])
        _, want = env.step(state, torch.clamp(wild, -1.0, 1.0))
        _, got = clipped.step(cstate, wild)
        assert torch.equal(got.obs, want.obs)
        assert torch.equal(got.reward, want.reward)

    def test_default_device_needs_cuda(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present: the default runs there")
        with pytest.raises(RuntimeError, match="CUDA"):
            GymVecEnv(make_env("MushrDriftRL-v0", num_envs=4))


def jax_params(seed, obs_dim=14):
    """flax ActorCritic params with numpy leaves, values from a numpy
    seed."""
    model = JActorCritic(action_dim=2, actor_hidden=(64, 64),
                         critic_hidden=(64, 64), activation="elu",
                         init_noise_std=1.0)
    params = model.init(jax.random.PRNGKey(0), np.zeros((1, obs_dim),
                                                        np.float32))
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: rng.normal(0, 0.5, np.shape(a)).astype(np.float32), params)


class TestExport:
    def test_export_matches_the_jax_export(self, tmp_path):
        """JAX params -> the port's model -> a port checkpoint -> cli/export:
        the .pt and .npz hold the keys and values of the JAX package's
        `flatten_actor_critic` of the same params, and the same metadata
        keys."""
        tiny_run(tmp_path, "RSS_DRIFT_CONFIG", "exp")
        params = jax_params(seed=3)
        model = actor_critic_from_jax(params)
        run_dir = str(tmp_path / "exp")
        step = checkpoint_steps(run_dir)[-1]
        path = os.path.join(run_dir, "checkpoints", f"{step}.pt")
        ck = torch.load(path, weights_only=True)
        ck["learner"]["model"] = model.state_dict()
        torch.save(ck, path)

        written = export.main(["--run", "exp", "--logs-dir", str(tmp_path),
                               "--device", "cpu"])
        out_dir = os.path.join(run_dir, "export")
        assert written == [os.path.join(out_dir, f"model_{step}.pt"),
                           os.path.join(out_dir, "exp-policy.npz")]

        jmeta = {}
        want = j_flatten(params, jmeta)
        assert sorted(want) == sorted(
            [f"{h}.{i}.{p}" for h in ("actor", "critic") for i in (0, 2, 4)
             for p in ("weight", "bias")] + ["std"])
        pt = torch.load(written[0], weights_only=True)
        assert sorted(pt) == ["infos", "iter", "model_state_dict",
                              "optimizer_state_dict"]
        assert pt["iter"] == step and pt["optimizer_state_dict"] == {}
        assert list(pt["model_state_dict"]) == list(want)
        npz = np.load(written[1])
        assert sorted(npz.files) == sorted(["__meta__", *want])
        for k, w in want.items():
            np.testing.assert_array_equal(pt["model_state_dict"][k].numpy(),
                                          w, err_msg=k)
            np.testing.assert_array_equal(npz[k], w, err_msg=k)
        # std is what the policy acts with
        np.testing.assert_array_equal(
            want["std"], np.exp(np.clip(params["params"]["log_std"], -5, 2)))

        meta = json.loads(bytes(npz["__meta__"]).decode())
        assert sorted(meta) == sorted([
            "task", "iteration", "obs_dim", "action_dim", "activation",
            "actor_hidden", "critic_hidden", "action_scale", "action_offset",
            "policy_class", "actor_layers", "critic_layers"])
        assert {k: meta[k] for k in jmeta} == jmeta
        assert (meta["task"], meta["obs_dim"], meta["action_dim"]) == (
            "MushrDriftRL-v0", 14, 2)
        assert meta["action_scale"] == [3.0, 0.488]

    def test_formats_and_errors(self, tmp_path):
        tiny_run(tmp_path, "RSS_DRIFT_CONFIG", "exp")
        common = ["--run", "exp", "--logs-dir", str(tmp_path), "--device",
                  "cpu", "--out", str(tmp_path / "o")]
        assert [os.path.basename(w) for w in
                export.main(common + ["--format", "npz"])] == [
            "exp-policy.npz"]
        assert [os.path.basename(w) for w in
                export.main(common + ["--format", "pt"])] == ["model_1.pt"]
        # a recurrent run has no rsl_rl layout: the default `both` writes
        # the npz alone, as the JAX export does
        tiny_run(tmp_path, "RSS_DRIFT_RNN_CONFIG", "rnn",
                 **{"agent.rnn_hidden_size": 8})
        assert [os.path.basename(w) for w in export.main([
            "--run", "rnn", "--logs-dir", str(tmp_path), "--device", "cpu",
            "--out", str(tmp_path / "o")])] == ["rnn-policy.npz"]
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="CUDA"):
                export.main(["--run", "exp", "--logs-dir", str(tmp_path)])


@pytest.fixture
def numpy_rasterizer(monkeypatch):
    """Both packages' numpy rasterizers: their native C++ ones (held
    against each other in test_torch_native.py) are switched off."""
    monkeypatch.setattr(jnative, "rasterize_trajectories",
                        lambda *a, **k: False)
    monkeypatch.setattr(tnative, "rasterize_trajectories",
                        lambda *a, **k: False)


def trajectories(seed, t=7, b=5):
    rng = np.random.default_rng(seed)
    pos = np.cumsum(rng.normal(0, 0.15, (t, b, 2)), 0) + rng.uniform(
        -2, 2, (1, b, 2))
    return (pos.astype(np.float32),
            rng.uniform(-np.pi, np.pi, (t, b)).astype(np.float32))


class TestRenderer:
    @pytest.mark.parametrize("with_yaw", [True, False])
    def test_drift_frames_equal_the_jax_renderer(self, numpy_rasterizer,
                                                 with_yaw):
        pos, yaw = trajectories(1)
        yaw = yaw if with_yaw else None
        got = topdown.render_drift_frames(pos, yaw, size=160, trail=3)
        want = jtopdown.render_drift_frames(pos, yaw, size=160, trail=3)
        assert got.dtype == np.uint8 and got.shape == (7, 160, 160, 3)
        np.testing.assert_array_equal(got, want)
        assert (got[-1] != got[0]).any()          # the cars are drawn

    @pytest.mark.parametrize("with_goals", [True, False])
    def test_map_frames_equal_the_jax_renderer(self, numpy_rasterizer,
                                               with_goals):
        pos, yaw = trajectories(2)
        grid = np.random.default_rng(3).random((24, 30)).astype(np.float32)
        goals = pos[::-1].copy() if with_goals else None
        kw = dict(yaws=yaw, goals=goals, size=128)
        got = topdown.render_map_frames(pos, grid, 0.25, **kw)
        np.testing.assert_array_equal(
            got, jtopdown.render_map_frames(pos, grid, 0.25, **kw))

    def test_task_frames_follow_the_task(self, numpy_rasterizer):
        pos, yaw = trajectories(4, t=3, b=4)
        drift = make_env("MushrDriftRL-v0", num_envs=4, device="cpu")
        np.testing.assert_array_equal(
            topdown.render_task_frames(drift, "MushrDriftRL-v0", pos, yaw),
            jtopdown.render_drift_frames(pos, yaw))
        elev = make_env("MushrElevationRL-v0", num_envs=4, device="cpu",
                        overrides={"terrain_extent": 20.0, "num_mounds": 10})
        grid, cell = elev.task.render_grid
        assert grid.shape == tuple(elev.task.terrain.height.T.shape)
        np.testing.assert_array_equal(
            topdown.render_task_frames(elev, "MushrElevationRL-v0", pos, yaw,
                                       goals=pos),
            jtopdown.render_map_frames(pos, grid, cell, yaws=yaw, goals=pos))

    def test_save_video_falls_back_to_npy_and_resizes(self, tmp_path):
        frames = topdown.render_drift_frames(*trajectories(5, t=2), size=64)
        out = topdown.save_video(frames, str(tmp_path / "v.avi"),
                                 resolution=(32, 16))
        assert os.path.exists(out)
        if out.endswith(".npy"):                   # no PyAV, no OpenCV
            saved = np.load(out)
            assert saved.shape == (2, 16, 32, 3) and saved.dtype == np.uint8


class TestVideos:
    def test_play_video_writes_a_file(self, tmp_path):
        tiny_run(tmp_path, "RSS_DRIFT_CONFIG", "drift")
        play.main(["--run", "drift", "--logs-dir", str(tmp_path), "--steps",
                   "6", "--num-envs", "3", "--device", "cpu", "--video"])
        videos = [f for f in os.listdir(tmp_path / "drift" / "play")
                  if f.startswith("drift.")]
        assert len(videos) == 1
        if videos[0].endswith(".npy"):
            frames = np.load(tmp_path / "drift" / "play" / videos[0])
            assert frames.shape == (6, 400, 400, 3)

    def test_training_video_writes_a_file(self, tmp_path):
        """`train.log.video` renders the rollout of every
        `video_interval`-th iteration, and the metrics stay scalars."""
        tiny_run(tmp_path, "RSS_DRIFT_CONFIG", "vid", **{
            "train.num_iterations": 2, "train.log.video": True,
            "train.log.video_interval": 2, "train.log.video_length": 3,
            "train.log.log_every": 1, "train.log.video_resolution": (80, 60)})
        videos = os.listdir(tmp_path / "vid" / "videos")
        assert len(videos) == 1 and videos[0].startswith("iter_2.")
        if videos[0].endswith(".npy"):
            frames = np.load(tmp_path / "vid" / "videos" / videos[0])
            assert frames.shape == (3, 60, 80, 3)
        rows = [json.loads(line) for line in
                open(tmp_path / "vid" / "metrics.jsonl")]
        assert [r["iteration"] for r in rows] == [1, 2]
        assert not any(k.startswith("traj/") for r in rows for k in r)
        assert "time/video_s" in rows[-1]


class TestMppiDemo:
    def test_mppi_demo_smoke(self, tmp_path):
        """As tests/test_harness.py::TestMppiDemo for the JAX script: the
        planning loop runs end to end at toy scale."""
        out = tmp_path / "mppi.json"
        r = subprocess.run(
            [sys.executable, "-m", "wheeledlab_torch.scripts.mppi_demo",
             "--samples", "64", "--horizon", "4", "--steps", "12", "--out",
             str(out), "--device", "cpu"],
            capture_output=True, text=True, timeout=600, cwd=ROOT)
        assert r.returncode == 0, r.stderr[-2000:]
        d = json.load(open(out))
        assert d["env_steps_per_control_step"] == 64 * 4
        assert np.isfinite(d["mppi/reward_mean"])
        assert np.isfinite(d["nominal_only/reward_mean"])
        # the reference script's output keys
        assert sorted(d) == sorted(
            ["metric", "samples", "horizon", "steps",
             "env_steps_per_control_step",
             "ms_per_control_step_incl_compile"]
            + [f"{k}/{m}" for k in ("nominal_only", "mppi")
               for m in ("slip_deg_mean", "speed_mean", "reward_mean",
                         "wall_s")])

    def test_broadcast_state_copies_lane_zero(self):
        env = make_env("MushrDriftRL-v0", num_envs=6, device="cpu")
        state, _ = env.reset()
        wide = mppi_demo.broadcast_state(state, 6)
        assert wide.vehicle_mem.shape == state.vehicle_mem.shape
        assert wide.vehicle_mem.is_contiguous()
        assert (wide.vehicle_mem == state.vehicle_mem[:, :1]).all()
        assert (wide.last_action == state.last_action[:1]).all()
        assert torch.equal(wide.reward_weights, state.reward_weights)
        assert wide.common_step == state.common_step

    def test_default_device_needs_cuda(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present: the default runs there")
        with pytest.raises(RuntimeError, match="CUDA"):
            mppi_demo.main(["--samples", "8", "--horizon", "2", "--steps",
                            "1"])


if __name__ == "__main__":
    sys.exit(pytest.main([__file__, "-x", "-q"]))
