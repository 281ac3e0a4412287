"""The CPU learning checks of ROADMAP Queue 3, rerun with the port fed the
JAX learner's own draws (`tests/_torch_lockstep.py`). Slow (about 3 and 2.5
minutes on one worker), so left out of tier 1: run them with

    JAX_PLATFORMS=cpu python -m pytest -m slow -s \
        tests/test_torch_lockstep_settle.py

Each runs JAX's learning test as tests/test_learning.py::run_iters runs it
(`PRNGKey(0)`, `PPOCfg`'s defaults with 32 steps, 3 epochs x 4
minibatches, no mesh, JAX's CPU default, the per-vehicle physics), once
plain and once recording its draws, then the port's learning test setup
(tests/test_torch_learning*.py: the kernels' plain versions) from JAX's
initial parameters and env state, fed those draws; nothing else of JAX's
is handed over (no KL residue either). They print, per iteration, both
sides' rollout reward, policy entropy, learning rate and KL, the first
iteration at which the rewards part by more than 1 %, and first5 / last5.
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
import _torch_lockstep as L  # noqa: E402
from test_learning import run_iters  # noqa: E402

torch.set_num_threads(1)

PPO = dict(num_steps_per_env=32, num_learning_epochs=3, num_mini_batches=4)
KEYS = ("rollout/reward_mean", "loss/entropy", "lr", "loss/kl")


def settle(case, task, num_envs, iters, overrides):
    """(JAX's plain run, the recorded lockstep): both sides' series of
    KEYS, printed, with the recorded JAX run held equal to the plain one
    (recording changes no value of the program)."""
    plain = run_iters(task, num_envs, iters, ppo=PPO, collect=KEYS,
                      **overrides)
    run = L.run_lockstep(case, iterations=iters, ppo=PPO,
                         capture=("minibatch",), jax_route="auto",
                         agent=None, hand_kl=False)
    series = {side: {k: [float(s["metrics"][k]) for s in snaps[1:]]
                     for k in KEYS}
              for side, snaps in (("jax", run.jax_snaps),
                                  ("port", run.port_snaps))}
    np.testing.assert_array_equal(series["jax"]["rollout/reward_mean"],
                                  plain["rollout/reward_mean"])
    np.testing.assert_array_equal(series["jax"]["loss/entropy"],
                                  plain["loss/entropy"])
    j, p = (np.array(series[s]["rollout/reward_mean"]) for s in ("jax",
                                                                  "port"))
    parted = np.flatnonzero(np.abs(p - j) > 0.01 * np.abs(j))
    print(f"\n{case}: iteration, then JAX | port for {', '.join(KEYS)}")
    for i in range(iters):
        print(i, " | ".join(f"{series['jax'][k][i]:.6g} "
                            f"{series['port'][k][i]:.6g}" for k in KEYS))
    first_parted = int(parted[0]) if parted.size else None
    print(f"first iteration parted by more than 1 %: {first_parted}")
    for s in ("jax", "port"):
        r = series[s]["rollout/reward_mean"]
        print(f"{s}: first5 {np.mean(r[:5]):.4f}, last5 {np.mean(r[-5:]):.4f}")
    return series


@pytest.mark.slow
def test_elevation_learns_on_jax_draws():
    """Queue 3's elevation stall: the port's tests/test_torch_learning_
    elevation.py setup (128 envs, 50 iterations, the reference's terrain
    overrides) fed JAX's PRNGKey(0) draws clears the learning test's bars,
    as JAX's own run does (measured: JAX 235.2 -> 304.4, the port 235.6 ->
    356.8; the rewards part by more than 1 % from iteration 5)."""
    series = settle("elevation", "MushrElevationRL-v0", 128, 50,
                    L.ELEV_OVERRIDES)
    for side in ("jax", "port"):
        r = series[side]["rollout/reward_mean"]
        first5, last5 = np.mean(r[:5]), np.mean(r[-5:])
        assert last5 > first5 + 30.0, (side, first5, last5)
        assert last5 > 1.1 * first5, (side, first5, last5)


@pytest.mark.slow
def test_visual_learns_on_jax_draws():
    """Queue 3's visual entropy: the port's visual learning test setup (64
    envs, 25 iterations, a 100 x 100 map) fed JAX's PRNGKey(0) draws clears
    the test's bars, as JAX's run does (measured: JAX 1.686 -> 3.769, the
    port 2.104 -> 2.983), and both policies' entropy stays within 2.5e-3
    of its start over the 25 iterations (measured 1.7e-3 in JAX, 2.8412 ->
    2.8402; 2.1e-3 in the port, 2.8399 -> 2.8411): at this scale the
    entropy has no trend to compare with the full-budget runs'."""
    series = settle("visual", "MushrVisualRL-v0", 64, 25, L.VISUAL_MAP)
    for side in ("jax", "port"):
        r = series[side]["rollout/reward_mean"]
        first5, last5 = np.mean(r[:5]), np.mean(r[-5:])
        assert last5 > first5 + 0.8, (side, first5, last5)
        assert last5 > 1.3 * first5, (side, first5, last5)
        ent = np.array(series[side]["loss/entropy"])
        assert np.abs(ent - ent[0]).max() < 2.5e-3, (side, ent)
