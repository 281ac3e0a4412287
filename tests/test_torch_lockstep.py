"""The port's whole PPO iteration in lockstep with the JAX learner's, on the
JAX learner's own random draws: drift, on the main path's K1 route.

`tests/_torch_lockstep.py` records every draw of JAX's jitted `init_fn` and
two `train_iteration`s (`make_ppo`, RSS_DRIFT_CONFIG's agent at 128 envs,
8 steps, 2 epochs x 2 minibatches, the env on K1 in interpret mode) and
replays each to the port's draw site (its docstring holds the site-to-site
table). The port starts from JAX's initial state (parameters through
`convert.actor_critic_from_jax`, the env state through
`convert.env_state_from_jax`, Adam fresh on both sides) and runs its own
`PPO.train_iteration` twice, K1's plain version carrying the env; nothing
of JAX's is handed to it after the start. Two cases: the task as
registered (no episode ends in 16 steps), and 0.1 s episodes with wide
spawns (time-outs with their bootstrap, out-of-bounds terminations,
resets, the curriculum; 175 episodes end in the first iteration).

Held at every step: the env's outputs (obs, reward, done, time_out, every
info) and state, then the transitions (obs, action, log-prob, value,
bootstrapped reward, done, mean, std), GAE's advantages, returns and
normalized advantages, each minibatch's losses, KL and learning rate, and
every parameter, Adam moment and metric of the iteration. Tolerances (the
module tests' own): flags and counters exactly; floats within 1e-5 + 1e-5
|x| (the port and XLA sum and round apart; measured at most 0.44 of it, the
largest on the wheel rates); parameters and Adam's first moment within
1e-5 of each tensor's largest entry, the second within 1e-4
(tests/test_torch_ppo_elevation.py's bounds; measured 8.8e-6, 4.7e-6,
1.5e-5). No env may part. Each test prints every quantity's largest
difference (`pytest -s`).
"""

import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
import _torch_lockstep as L  # noqa: E402

torch.set_num_threads(1)

TOLS = L.Tols()
DRIFT_SITES = {"drift_dr_buckets", "drift_dr_assign", "drift_dr_damping",
               "drift_dr_mass", "drift_spawn_idx", "drift_spawn_xy",
               "drift_spawn_yaw", "push_timer_init", "blind_obs_noise",
               "action_noise", "drift_step_uniforms", "drift_step_normals",
               "epoch_perm"}
_RUNS = {}


@pytest.fixture(scope="module", params=["drift", "drift_resets"])
def run(request):
    if request.param not in _RUNS:
        _RUNS[request.param] = L.run_lockstep(request.param)
    return _RUNS[request.param]


def test_every_draw_replayed_at_its_site(run):
    """Every JAX draw found its row of the site table and was taken by the
    port's matching call, with the same shape, none left over (the replay
    fails otherwise); the rows taken are drift's: the reset's DR, spawn,
    push timers and obs noise once, then per step the action noise and
    K1's uniform and normal rows (16 each), and one epoch permutation per
    iteration. A KL residue handed over (`_torch_lockstep.KL_RESIDUE`)
    is one of a first minibatch, where the port's estimate is 0 (in
    "drift_resets", iteration 2: JAX's 2.98e-8)."""
    assert set(run.taken) == DRIFT_SITES
    assert run.taken["action_noise"] == run.taken["drift_step_uniforms"] \
        == run.taken["drift_step_normals"] == 16
    assert run.taken["epoch_perm"] == 2
    print("KL residues handed over:", run.residues)
    assert all(mb == 0 and kl_p == 0.0 for _, mb, _, kl_p in run.residues)


def test_reset_replays_jax_init(run):
    """The port env's `reset` fed JAX's `init_fn` draws gives JAX's initial
    env state and observation (the DR'd params, the spawns from JAX's
    track poses, the push timers, the noisy observation)."""
    report = L.compare_reset(run, TOLS)
    print(report.text())
    assert not report.failures, report.failures


@pytest.mark.parametrize("phase", [1, 2])
def test_iteration_matches_jax(run, phase):
    """Iteration `phase` of the port against JAX's, every step, every
    transition, GAE, every minibatch and the end state (module
    docstring)."""
    report = L.compare(run, phase, TOLS)
    print(f"{run.case}, iteration {phase}:\n{report.text()}")
    assert not report.failures, report.failures
    assert not report.partings
