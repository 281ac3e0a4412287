"""The drift play variant through the port's generic manager step (kernel
K2's plain version on the CPU) against the JAX play env on its flat kernel
path (`pallas_step` in interpret mode), and the port's play CLI
(`wheeledlab_torch/cli/play.py`) against the JAX play CLI's outputs.

With DR events and observation noise off (the play variant keeps both on;
they are overridden here) and terminations stripped, neither env draws a
random number within 8 steps, so every env must agree step for step."""

import ast
import json
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import wheeledlab_tpu.cli.play as jplay
from wheeledlab_tpu.tasks.drift.task import DriftTaskCfg as JTaskCfg
from wheeledlab_tpu.tasks.drift.task import cart_off_track as j_off_track
from wheeledlab_tpu.tasks.drift.task import make_drift_env as j_make_env
import wheeledlab_torch.rl  # noqa: F401  registers run configs
from wheeledlab_torch.cli import play
from wheeledlab_torch.convert import env_state_from_jax
from wheeledlab_torch.ops import physics_step
from wheeledlab_torch.rl.runner import train
from wheeledlab_torch.tasks import make_env
from wheeledlab_torch.tasks.drift.task import cart_off_track
from wheeledlab_torch.utils.config import RUN_CONFIGS, apply_overrides

torch.set_num_threads(1)

N = 32
QUIET = {"events_enabled": False, "enable_corruption": False}


def to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


class TestDriftPlayParity:
    @pytest.mark.parametrize("task,robot", [
        ("MushrDriftRL-v0", "mushr"), ("F1TenthDriftRL-v0", "f1tenth")])
    def test_eight_steps_match_jax(self, task, robot):
        """Obs, reward, done, time_out, every done/* and metrics/* value and
        the state, on every env, for 8 steps. Tolerances of
        tests/test_torch_soa.py's substep, 1e-5 relative + 1e-4 absolute
        (measured max difference 6e-6 on the state, 2e-6 on the obs); the
        slip metric is in degrees (1e-3)."""
        jenv = j_make_env(JTaskCfg(
            num_envs=N, robot=robot, pos_noise=0.0, yaw_noise=0.0,
            terminations_enabled=False, rewards_enabled=False, **QUIET))
        jenv._use_pallas = True          # the flat kernel ...
        jenv._pallas_interpret = True    # ... in interpreter mode
        assert jenv.task.fused_step is None
        js, _ = jax.jit(jenv.reset)(jax.random.PRNGKey(3))
        tenv = make_env(task, num_envs=N, play=True, overrides=QUIET,
                        device="cpu")
        ts = env_state_from_jax(to_np(js))
        jstep = jax.jit(jenv.step)
        launches = physics_step.LAUNCHES
        for t in range(8):
            a = np.stack([np.full((N,), 0.7, np.float32),
                          np.full((N,), 0.4 * np.sin(0.7 * t), np.float32)],
                         -1)
            js, jout = jstep(js, jnp.asarray(a))
            ts, tout = tenv.step(ts, torch.from_numpy(a))
            assert sorted(tout.info) == sorted(jout.info)
            for k in ("done", "time_out"):
                np.testing.assert_array_equal(getattr(tout, k).numpy(),
                                              np.asarray(getattr(jout, k)))
            np.testing.assert_array_equal(tout.reward.numpy(),
                                          np.asarray(jout.reward))
            for k in jout.info:
                tol = 1e-3 if k == "metrics/slip_deg" else 1e-4
                np.testing.assert_allclose(
                    tout.info[k].numpy().astype(np.float32),
                    np.asarray(jout.info[k], np.float32), rtol=1e-5,
                    atol=tol, err_msg=f"{k} step {t}")
            np.testing.assert_allclose(tout.obs.numpy(), np.asarray(jout.obs),
                                       rtol=1e-5, atol=1e-4,
                                       err_msg=f"obs step {t}")
            np.testing.assert_allclose(ts.vehicle_mem.numpy(),
                                       np.asarray(js.vehicle_mem), rtol=1e-5,
                                       atol=1e-4, err_msg=f"state step {t}")
        assert physics_step.LAUNCHES == launches   # CPU: no kernel launched
        assert float(np.asarray(jout.info["metrics/speed"]).min()) > 0.3


def test_out_of_bounds_termination_matches_jax():
    """The generic path's drift termination (play variants with
    terminations kept) on positions all over and beyond the oval."""
    pos = np.random.default_rng(0).uniform(-3, 3, (4096, 3)).astype(
        np.float32)
    ctx = lambda p: SimpleNamespace(vehicle=SimpleNamespace(pos=p))
    got = cart_off_track(ctx(torch.from_numpy(pos))).numpy()
    want = np.asarray(j_off_track(ctx(jnp.asarray(pos))))
    np.testing.assert_array_equal(got, want)
    assert 0.2 < got.mean() < 0.8


def jax_play_keys():
    """The keys the JAX play CLI writes: the keyword names of its
    `np.savez_compressed` call and the keys of its `play_metrics` dict."""
    tree = ast.parse(open(jplay.__file__).read())
    npz, metrics = set(), set()
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call)
                and getattr(node.func, "attr", "") == "savez_compressed"):
            npz |= {kw.arg for kw in node.keywords}
        if isinstance(node, ast.Assign):
            target = node.targets[0]
            if (isinstance(target, ast.Name)
                    and target.id == "play_metrics"
                    and isinstance(node.value, ast.Dict)):
                metrics |= {k.value for k in node.value.keys}
            if (isinstance(target, ast.Subscript)
                    and getattr(target.value, "id", "") == "play_metrics"):
                metrics.add(target.slice.value)
    return npz, metrics


def tiny_run(logs, config, run_name, **extra):
    cfg = apply_overrides(RUN_CONFIGS.get(config), {
        "num_envs": 8, "agent.num_steps_per_env": 4,
        "agent.num_learning_epochs": 1, "agent.num_mini_batches": 2,
        "train.num_iterations": 1, "train.log.logs_dir": str(logs),
        "train.log.run_name": run_name, "device": "cpu", **extra})
    train(cfg, verbose=False)


class TestPlayCLI:
    def test_drift_play_writes_the_jax_keys(self, tmp_path):
        """Train one tiny iteration on the CPU, play 10 steps: the npz holds
        exactly the JAX play's keys, stacked over steps, and the metrics are
        finite and a subset of the JAX play's (no goal keys for drift)."""
        tiny_run(tmp_path, "RSS_DRIFT_CONFIG", "drift")
        metrics = play.main(["--run", "drift", "--logs-dir", str(tmp_path),
                             "--steps", "10", "--num-envs", "4",
                             "--device", "cpu"])
        npz_keys, metric_keys = jax_play_keys()
        assert npz_keys == {"observations", "actions", "positions", "yaws",
                            "rewards", "commands"}
        out = np.load(tmp_path / "drift" / "play" / "drift-rollouts.npz")
        assert set(out.files) == npz_keys
        assert out["observations"].shape == (10, 4, 14)
        assert out["actions"].shape == (10, 4, 2)
        assert out["commands"].shape == (10, 4, 3)
        saved = json.load(open(tmp_path / "drift" / "play" /
                               "play_metrics.json"))
        assert saved == metrics
        assert {"reward_mean", "speed_mean"} <= set(saved) <= metric_keys
        assert "goal_reach_frac" not in saved
        assert all(np.isfinite(v) for v in saved.values())

    def test_elevation_play_reports_goal_metrics(self, tmp_path):
        tiny_run(tmp_path, "RSS_ELEV_CONFIG", "elev", env_overrides={
            "terrain_extent": 20.0, "num_mounds": 10})
        metrics = play.main(["--run", "elev", "--logs-dir", str(tmp_path),
                             "--steps", "5", "--num-envs", "4",
                             "--device", "cpu"])
        _, metric_keys = jax_play_keys()
        assert {"goal_reach_frac", "goal_dist_final"} <= set(metrics)
        assert set(metrics) <= metric_keys
        out = np.load(tmp_path / "elev" / "play" / "elev-rollouts.npz")
        assert out["observations"].shape == (5, 4, 689)

    def test_video_and_missing_cuda_raise(self, tmp_path):
        """`--video` is accepted (the renderer is ported; a video is written
        in tests/test_torch_drift_family.py): only the missing run stops
        it. Without a CUDA device the default device raises."""
        with pytest.raises(FileNotFoundError):
            play.main(["--run", "x", "--logs-dir", str(tmp_path), "--video",
                       "--device", "cpu"])
        if torch.cuda.is_available():
            return
        with pytest.raises(RuntimeError, match="CUDA"):
            play.main(["--run", "x", "--logs-dir", str(tmp_path), "--video"])


if __name__ == "__main__":
    import sys

    sys.exit(pytest.main([__file__, "-x", "-q"]))
