"""CPU-scale learning checks of the port for every task but drift (drift's
is tests/test_torch_train.py::TestLearning): the counterparts of
tests/test_learning.py::TestAllTasksImprove, at the reference's sizes,
overrides and bars — 32 steps, 3 epochs x 4 minibatches, `PPOCfg`'s
defaults otherwise, and the rollout reward's mean over the last 5
iterations against the first 5.

The port's random streams are not JAX's, so its runs at a seed are not the
reference's runs at that seed; each docstring gives the port's spread over
seeds 0-3 (`make_env(seed=s)`, `make_learner(seed=s)`), measured on the CPU
with these tests' code. The tests run seed 0. Elevation's check is in
tests/test_torch_learning_elevation.py, so that each file takes under two
minutes on one worker.
"""

import numpy as np
import torch

from wheeledlab_torch.rl.ppo import PPOCfg, make_learner
from wheeledlab_torch.tasks import make_env

torch.set_num_threads(1)

PPO = dict(num_steps_per_env=32, num_learning_epochs=3, num_mini_batches=4)


def first_and_last5(task, num_envs, iters, seed=0, **overrides):
    """(mean rollout reward of the first 5 iterations, of the last 5) of a
    run of `iters` iterations; every iteration's reward and loss finite."""
    env = make_env(task, num_envs=num_envs, overrides=overrides or None,
                   device="cpu", seed=seed)
    learner = make_learner(env, PPOCfg(**PPO), seed=seed)
    state, rews = learner.init_state(), []
    for _ in range(iters):
        state, m = learner.train_iteration(state)
        rews.append(float(m["rollout/reward_mean"]))
        assert np.isfinite(rews[-1]) and np.isfinite(float(m["loss/total"]))
    return np.mean(rews[:5]), np.mean(rews[-5:])


class TestAllTasksImprove:
    def test_f1tenth_improves(self):
        """256 envs, 40 iterations. Measured for the port at seeds 0-3:
        first5 0.756-0.818, last5 0.983-1.421, ratio 1.20-1.85 (seed 0:
        0.818 -> 0.983, ratio 1.202, inside both bars)."""
        first5, last5 = first_and_last5("F1TenthDriftRL-v0", 256, 40)
        assert last5 > first5 + 0.15, (first5, last5)
        assert last5 > 1.2 * first5, (first5, last5)

    def test_visual_improves(self):
        """64 envs, 25 iterations, a 100 x 100 map. Measured for the port
        at seeds 0-3: first5 1.25-2.99, last5 2.22-4.20, ratio 1.23-1.78
        (seed 0: 2.99 -> 4.20, ratio 1.40; seed 2 misses the +0.8 bar,
        2.65 -> 3.25)."""
        first5, last5 = first_and_last5(
            "MushrVisualRL-v0", 64, 25, map_rows=100, map_cols=100,
            env_rows=20, env_cols=20, group_rows=5, group_cols=5)
        assert last5 > first5 + 0.8, (first5, last5)
        assert last5 > 1.3 * first5, (first5, last5)
