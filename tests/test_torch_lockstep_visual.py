"""The port's whole PPO iteration in lockstep with the JAX learner's, on the
JAX learner's own random draws: visual, on K2's route, with the camera and
its augmentation.

The case: `MushrVisualRL-v0` at 64 envs on the learning test's 100 x 100
map (`map_rows=100, map_cols=100, env_rows=20, env_cols=20, group_rows=5,
group_cols=5`), RSS_VISUAL_CONFIG's agent (the fused first layer, relu), 8
steps, 2 epochs x 2 minibatches, two iterations; JAX's env on K2
(`pallas_step`) in interpret mode, the port's on K2's plain version.
`tests/_torch_lockstep.py` records JAX's draws and replays them at the
port's sites (its docstring holds the table).

The cars spawn 4 cm above the ground and land in the first steps; where
the policy's throttle clips to 0 (no reverse), a wheel's rate of 1e-6 of
either sign decides which way the car rolls off. Free running, 24 of the
64 envs part at step 1 (env 63: wheel rates +0.42 in JAX, -0.38 in the
port). JAX's own step from the port's state gives the port's outputs
(within 2.9e-3 for every env that parts, where JAX's recorded step is up
to 1.99 away), the port's from JAX's state JAX's, and JAX's step moves by
nothing under a one-ulp change of its input: the 1e-6 the two carry out
of step 0 is what the landing amplifies. So `test_iteration_matches_jax`
takes each port env step from JAX's env state before it and hands the
learner JAX's step outputs (`run_lockstep(feed="data")`);
`test_free_running_parts_in_the_env` shows where and how the free-running
envs part.

Tolerances: the env's are tests/test_torch_visual.py's (state 1e-5 |x| +
1e-3, observation and rewards + 1e-4); flags and counters exactly; the
learner's 1e-5 + 1e-5 |x|; Adam's first moment within 1e-5 of each
tensor's largest entry, the second within 1e-4; the parameters within
1e-4 (measured 3.1e-5, on 10 of the 205,312 first-layer actor weights,
each with a second moment under 2e-10: Adam's normalized step turns that
small gradient's float noise, ~1e-3 of it, into ~1.5e-3 of the entry's own
step). Allowance: an env step may leave the env's tolerance (it parts, and
the test names it), on at most 2 % of the env steps. Measured: one in
each iteration, of 512 (iteration 1, step 5, env 45: 2.2e-4 on the
forward-velocity reward, 2.0e-3 on the state; iteration 2, step 3, env
29: a camera pixel at a cell's edge, 0.064). Each test prints every
quantity's largest difference (`pytest -s`).
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
import _torch_lockstep as L  # noqa: E402

torch.set_num_threads(1)

CASE = "visual"
TOLS = L.Tols(env=(1e-5, 1e-4), obs=(1e-5, 1e-4), state=(1e-5, 1e-3),
              params=1e-4, parting=0.02)
# draws a site takes in the reset and the two iterations of 8 steps:
# once at the reset, once a step (the observation's noise three times:
# linear and angular velocity, last action)
SITES = {"visual_dr_buckets": 1, "visual_dr_assign": 1,
         "visual_dr_base_mass": 1, "visual_dr_wheel_mass": 1,
         "visual_spawn_idx": 17, "visual_spawn_yaw": 17,
         "visual_aug_brightness": 17, "visual_aug_contrast": 17,
         "visual_aug_sigma": 17, "visual_obs_noise": 51,
         "action_noise": 16, "epoch_perm": 2}
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
