"""The port's whole PPO iteration in lockstep with the JAX learner's, on the
JAX learner's own random draws: elevation, on K3's route.

The case: `MushrElevationRL-v0` at 128 envs with the learning test's
overrides (`terrain_extent=20, num_mounds=10, spawn_range=8,
goal_range=8`), RSS_ELEV_CONFIG's agent (the fused first layer, relu), 8
steps, 2 epochs x 2 minibatches, two iterations; JAX's env on K3
(`pallas_step_hf`) in interpret mode, the port's on K3's plain version,
both on JAX's terrain. `tests/_torch_lockstep.py` records JAX's draws and
replays them at the port's sites (its docstring holds the table).

Unlike drift's, this env does not stay in lockstep on its own: K3's plain
version and JAX's kernel in interpret mode differ by tens of ulps on a
wheel rate in one substep from equal inputs (iteration 1, step 3, env 33:
5.8e-5 on 17.16 rad/s after the first substep, 1.1e-3 after the ninth,
3.0e-2 on 0.50 rad/s after the tenth, where the wheel's rate collapses
from 8.6), while JAX's own step moves by nothing under a one-ulp change of
its input. So `test_iteration_matches_jax` takes each port env step from
JAX's env state before it and hands the learner JAX's step outputs
(`run_lockstep(feed="data")`), holding the env and the learner each on
equal inputs; `test_free_running_parts_in_the_env` runs the port on its
own and shows where and how its envs part (at step 1 of the first
iteration: env 10 by 0.085, 1.3e-4 from JAX's own step taken from the
port's state; the others by 2e-3 to 4e-3, the one-step difference).

Tolerances: the env's are tests/test_torch_elevation.py's (state and
rewards 1e-5 |x| + 2e-3, observation + 1e-3); flags and counters
exactly; the learner's 1e-5 + 1e-5 |x|; parameters and Adam's first moment
within 1e-5 of each tensor's largest entry, the second within 1e-4
(tests/test_torch_ppo_elevation.py's; measured 3.6e-6, 1.2e-6, 1.4e-5).
Allowance: an env step may leave the env's tolerance (it parts, and the
test names it), on at most 2 % of the env steps. Measured: 13 and 12 of
the 1,024 env steps of each iteration (1.3 %), 24 of them on the wheel
rates alone (largest 3.0e-2, the trace above), one (iteration 1, step 1,
env 108) on the yaw-rate observation and the goal reward too (1.6e-3 and
4.6e-3). Each test prints every quantity's largest difference
(`pytest -s`).
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
import _torch_lockstep as L  # noqa: E402

torch.set_num_threads(1)

CASE = "elevation"
TOLS = L.Tols(env=(1e-5, 2e-3), obs=(1e-5, 1e-3), state=(1e-5, 2e-3),
              parting=0.02)
# draws a site takes in the reset and the two iterations of 8 steps:
# once at the reset, once a step, and the goal commands three times a
# step (the timed resample and the auto-reset's) a component
SITES = {"elev_dr_mass": 1, "elev_spawn_xy": 17, "elev_spawn_yaw": 17,
         "elev_spawn_vel": 17, "command_x": 33, "command_y": 33,
         "command_heading": 33, "action_noise": 16, "epoch_perm": 2}
_RUNS = {}


def lockstep(feed):
    """The case's lockstep run in feed mode `feed`, made once a module."""
    if feed not in _RUNS:
        _RUNS[feed] = L.run_lockstep(CASE, feed=feed)
    return _RUNS[feed]


def test_every_draw_replayed_at_its_site():
    """Every JAX draw found its row of the site table and was taken by the
    port's matching call, with the same shape, none left over (the replay
    fails otherwise); the rows taken are the case's (`SITES`, with the
    number of draws of each); a KL residue handed over
    (`_torch_lockstep.KL_RESIDUE`) is one of a first minibatch, where the
    port's estimate is 0."""
    run = lockstep("data")
    assert run.taken == SITES
    print("KL residues handed over:", run.residues)
    assert all(mb == 0 and kl_p == 0.0 for _, mb, _, kl_p in run.residues)


def test_reset_replays_jax_init():
    """The port env's `reset` fed JAX's `init_fn` draws gives JAX's initial
    env state and observation."""
    report = L.compare_reset(lockstep("data"), TOLS)
    print(report.text())
    assert not report.failures, report.failures


@pytest.mark.parametrize("phase", [1, 2])
def test_iteration_matches_jax(phase):
    """Iteration `phase`, each env step taken from JAX's state before it
    and the learner fed JAX's step outputs (module docstring): every step's
    outputs and state, the transitions, GAE, every minibatch and the end
    state; the env steps that part are named and bounded."""
    report = L.compare(lockstep("data"), phase, TOLS)
    print(f"{CASE}, iteration {phase}:\n{report.text()}")
    assert not report.failures, report.failures


def test_free_running_parts_in_the_env():
    """The port's own iteration, nothing of JAX's handed over after the
    start. Up to the first step at which an env parts, every env's outputs
    and state agree, flags and counters exactly, and so do the observations
    the policy acted on. At that step, each env that parts by more than ten
    times the state's absolute tolerance (from JAX's recorded step) is
    within a tenth of that distance of JAX's own step taken from the port's
    state before it, with the port's action: what parts is the state's
    sensitivity to the small differences carried from the steps before,
    not the port's step. The envs that part by less are the one-step
    differences that `test_iteration_matches_jax` bounds."""
    import dataclasses

    run = lockstep("free")
    tols = dataclasses.replace(TOLS, parting=1.0)
    steps = sorted(t for _, t, _, _ in L.compare(
        run, 1, tols, learner=False).partings)
    first = steps[0] if steps else None
    report = L.compare(run, 1, tols, learner=False, until=first)
    print(f"{CASE}, free running, iteration 1, to the first parting:\n"
          f"{report.text()}")
    assert not report.failures, report.failures
    if first is None:
        return
    J = L.split_events(run.jax_events[1])["traj"][0]
    P = L.split_events(run.port_events[1])["traj"][0]
    held = L.Report()
    held.add("traj/obs", P["obs"][: first + 1], J["obs"][: first + 1],
             TOLS.obs)
    assert not held.failures, held.failures
    parted = [e for _, t, e, _ in report.partings if t == first]
    got = L.split_events(run.port_events[1])["step"][first]
    jax = L.split_events(run.jax_events[1])["step"][first]
    jax = dict(obs=jax["obs"], state=L.jax_env_state(jax["state"]))
    own = L.jax_step_from_port(run, 1, first)

    def dist(other, e):
        return max(float(np.abs(got["obs"][e] - other["obs"][e]).max()),
                   float(np.abs(got["state"]["vehicle_mem"][:, e]
                                - other["state"]["vehicle_mem"][:, e]).max()))

    for e in parted:
        print(f"step {first}, env {e}: port vs JAX {dist(jax, e):.3g}, port "
              f"vs JAX from the port's state {dist(own, e):.3g}")
        if dist(jax, e) > 10 * TOLS.state[1]:
            assert 10 * dist(own, e) < dist(jax, e), e
