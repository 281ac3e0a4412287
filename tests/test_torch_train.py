"""The port's training harness on the CPU: `train()` logs the JAX runner's
metric keys, checkpoints the full train state and resumes from it exactly,
PPO on the drift MDP learns, and the CLI runs."""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from wheeledlab_tpu.rl.ppo import PPOCfg as JPPOCfg
from wheeledlab_tpu.rl.ppo import make_ppo
from wheeledlab_tpu.tasks.drift.task import DriftTaskCfg as JTaskCfg
from wheeledlab_tpu.tasks.drift.task import make_drift_env as j_make_env
import wheeledlab_torch.rl  # noqa: F401  registers run configs
from wheeledlab_torch.rl.ppo import PPOCfg, make_learner
from wheeledlab_torch.rl.runner import checkpoint_steps, train
from wheeledlab_torch.tasks import make_env
from wheeledlab_torch.utils.config import RUN_CONFIGS, apply_overrides

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = {"num_envs": 16, "agent.num_steps_per_env": 8,
        "agent.num_learning_epochs": 2, "agent.num_mini_batches": 2,
        "train.log.log_every": 1, "train.log.checkpoint_every": 1,
        "device": "cpu"}


def tiny_cfg(logs, run_name, iterations, **extra):
    return apply_overrides(RUN_CONFIGS.get("RSS_DRIFT_CONFIG"), {
        **TINY, "train.log.logs_dir": str(logs),
        "train.log.run_name": run_name,
        "train.num_iterations": iterations, **extra})


def read_metrics(logs, run_name):
    with open(os.path.join(logs, run_name, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def jax_runner_keys():
    """Keys the JAX runner logs: its train iteration's metrics (found by
    abstract evaluation, nothing compiled) minus the ones it pops, plus
    perf/*; time/* depend on which phases ran and are checked apart."""
    env = j_make_env(JTaskCfg(num_envs=16))
    init_fn, train_iter, _ = make_ppo(env, JPPOCfg(
        num_steps_per_env=8, num_learning_epochs=2, num_mini_batches=2))
    state = jax.eval_shape(init_fn, jax.random.PRNGKey(0))
    _, metrics = jax.eval_shape(train_iter, state)
    keys = {k for k in metrics
            if not k.startswith("traj/") and k != "nan/detected"}
    return keys | {"perf/env_steps_per_s", "perf/wall_s"}


class TestRunner:
    def test_metrics_checkpoint_and_exact_resume(self, tmp_path):
        state, last = train(tiny_cfg(tmp_path, "t1", 2), verbose=False)
        assert state.iteration == 2
        rows = read_metrics(tmp_path, "t1")
        assert [r["iteration"] for r in rows] == [1, 2]
        assert os.path.exists(tmp_path / "t1" / "run_config.json")
        assert checkpoint_steps(str(tmp_path / "t1")) == [1, 2]

        keys = set(rows[-1]) - {"iteration"}
        assert {k for k in keys if not k.startswith("time/")} \
            == jax_runner_keys()
        phases = {"iterate", "device_sync", "checkpoint"}
        assert {f"time/{p}_{s}" for p in phases
                for s in ("s", "frac", "mean_ms")} == \
            {k for k in keys if k.startswith("time/")}
        assert all(np.isfinite(v) for v in rows[-1].values())

        # resume at iteration 2 -> 3 equals a straight 3-iteration run:
        # the checkpoint holds model, Adam with its LR, env state and both
        # generators
        state2, _ = train(tiny_cfg(tmp_path, "t2", 3, **{
            "train.load_run": "t1"}), verbose=False)
        assert state2.iteration == 3
        resumed = read_metrics(tmp_path, "t2")
        assert [r["iteration"] for r in resumed] == [3]
        train(tiny_cfg(tmp_path, "t3", 3), verbose=False)
        straight = read_metrics(tmp_path, "t3")[-1]
        for k in ("loss/total", "loss/kl", "lr", "rollout/reward_mean",
                  "episode/num_dones", "metrics/speed"):
            assert resumed[0][k] == straight[k], k

    def test_profile_writes_a_trace(self, tmp_path):
        """`train.profile` traces iterations 10-12 into trace.json."""
        train(tiny_cfg(tmp_path, "prof", 14, **{
            "train.profile": True, "train.log.checkpoint_every": 100,
            "agent.num_steps_per_env": 2, "agent.num_learning_epochs": 1}),
            verbose=False)
        with open(tmp_path / "prof" / "trace.json") as f:
            assert json.load(f)["traceEvents"]


class TestLearning:
    def test_drift_improves(self):
        """CPU-scale PPO must raise the rollout reward (the bars of
        tests/test_learning.py::test_drift_improves; measured for the port
        at seeds 0-3: first5 0.72-1.00, last5 1.08-1.89)."""
        env = make_env("MushrDriftRL-v0", num_envs=256, device="cpu")
        learner = make_learner(env, PPOCfg(
            num_steps_per_env=32, num_learning_epochs=3, num_mini_batches=4))
        state, rews, slip = learner.init_state(), [], []
        for _ in range(40):
            state, m = learner.train_iteration(state)
            rews.append(float(m["rollout/reward_mean"]))
            slip.append(float(m["metrics/slip_deg"]))
            assert np.isfinite(rews[-1]) and np.isfinite(float(
                m["loss/total"]))
        first5, last5 = np.mean(rews[:5]), np.mean(rews[-5:])
        assert last5 > first5 + 0.2, (first5, last5)
        assert last5 > 1.2 * first5, (first5, last5)
        assert np.isfinite(slip).all()


class TestCLI:
    def test_cli_runs_one_iteration_on_cpu(self, tmp_path):
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        proc = subprocess.run(
            [sys.executable, "-m", "wheeledlab_torch.cli.train",
             "--device", "cpu", "-r", "RSS_DRIFT_CONFIG", "--headless",
             "num_envs=8", "agent.num_steps_per_env=4",
             "agent.num_mini_batches=2", "agent.num_learning_epochs=1",
             "train.num_iterations=1", f"train.log.logs_dir={tmp_path}",
             "train.log.run_name=cli"],
            cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
        assert proc.returncode == 0, proc.stderr
        rows = read_metrics(tmp_path, "cli")
        assert [r["iteration"] for r in rows] == [1]
        cfg = json.load(open(tmp_path / "cli" / "run_config.json"))
        assert cfg["run"]["device"] == "cpu"
        assert cfg["run"]["num_envs"] == 8


if __name__ == "__main__":
    sys.exit(pytest.main([__file__, "-x", "-q"]))
