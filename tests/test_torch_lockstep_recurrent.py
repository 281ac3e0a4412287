"""The port's recurrent learner (RSS_DRIFT_RNN_CONFIG) in lockstep with JAX's
compiled recurrent iteration, on JAX's own draws.

JAX's side is recorded in processes of its own
(`_torch_lockstep.record_in_subprocess`, both cases at once) under
`XLA_FLAGS=--xla_allow_excess_precision=false`: XLA then rounds the LSTM
cells' bfloat16 intermediates where flax declares them, as the port does
(by default it keeps some in float32, 1e-3 away). It runs
`make_ppo_recurrent`'s jitted `init_fn` at `PRNGKey(0)` and two
`train_iteration`s: the drift env
on K1 in interpret mode, RSS_DRIFT_RNN_CONFIG's agent (one LSTM layer, cut
to 32 wide) at 128 envs, 8 steps, 2 epochs x 2 minibatches. The port starts
from JAX's initial state (parameters through
`convert.actor_critic_recurrent_from_jax`, carries through
`recurrent_hidden_from_jax`, env state through `env_state_from_jax`, Adam
fresh on both sides) and runs its own `RecurrentPPO.train_iteration` fed
JAX's draws (the site table's `rnn_action_noise` and `rnn_env_perm` rows
beside drift's), K1's plain version carrying the env. Two cases: the task
as registered, and `drift_resets`' 0.1 s episodes with wide spawns, where
carries reset inside the window, in the rollout and in every BPTT
minibatch (`test_resets_inside_the_window` prints how many).

Two runs of the port from each recording:

- free: the port carries its env, carries and learner through an
  iteration. Held: every env output and state, each policy step's carries
  (c, h of both chains) and outputs, the window-start hidden, the
  transitions and GAE within 1e-5 + 1e-5 |x|; flags, counters, reset masks
  and each minibatch's env columns exactly; the LR within 1e-6 relative;
  the loss terms and KL within 1e-5 + 1e-5 |x| (measured at most 0.73 of
  it); after each Adam step no parameter more than 2 lr per step so far +
  1e-5 apart, no first-moment entry more than 2e-4, no second-moment entry
  more than 1e-6 (measured 1.3e-3, 8.8e-5, 5.4e-8). A bfloat16 rounding
  that falls on either side parts an env; it is named and stays parted
  to the window's end, the transitions and GAE are held on the other envs,
  and at most 2 % of env steps may part (measured: "drift_rnn" iteration
  1, env 111 from step 6, and iteration 2, env 92 from step 0 and env 111
  from step 6; 1.2 %; "drift_rnn_resets", none).
- step by step: each env step starts from JAX's state and hands JAX's
  outputs to the learner (as the elevation and visual cases do), and each
  minibatch starts from JAX's parameters, Adam state and LR. The same
  quantities are held, and besides each minibatch's forward (means and
  values over the window, recomputed on the JAX side from the parameters
  before the step), its loss terms and KL within 1e-5 relative + 1e-6 (as
  `TestMinibatchUpdate` holds them; 1e-5 + 1e-5 |x| in a minibatch whose
  forward parted or that holds a parted env), and the parameters and Adam
  moments after each step by `params_close`'s rule: at most 0.5 % of the
  entries more than 1e-5 apart (measured at most 23 of 24,773, most of
  them the cells' biases) and none more than 2 lr + 1e-5 (measured
  1.8e-4); first moments none beyond 1e-4 (measured 5.3e-5).

Both runs start iteration 2 from JAX's state after iteration 1
(parameters, Adam, LR, env, carries): the free run's parameters part there
by Adam's normalized steps (562 and 4,028 of 24,773 entries more than
1e-5 apart after the iteration's 4 steps, at most 1.3e-3), and iteration
2 begun from them parts in 127 and 128 of 128 envs at its first step.
What moves them: XLA reduces a bias's gradient over the batch in bfloat16
(the transpose of its broadcast), the port in float32 rounded once, so the
cells' bias gradients differ by some 1e-3 of their largest entry
(`test_torch_recurrent.py::TestCompiledExactPrecision`); and an env that
parted feeds the update data a bfloat16 ulp apart. Each step from JAX's
state agrees as above.
"""

import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
import _torch_lockstep as L  # noqa: E402

torch.set_num_threads(1)

CASES = ("drift_rnn", "drift_rnn_resets")
RNN_SITES = {"drift_dr_buckets", "drift_dr_assign", "drift_dr_damping",
             "drift_dr_mass", "drift_spawn_idx", "drift_spawn_xy",
             "drift_spawn_yaw", "push_timer_init", "blind_obs_noise",
             "rnn_action_noise", "drift_step_uniforms", "drift_step_normals",
             "rnn_env_perm"}
# (Tols, RecurrentTols) of each run (module docstring)
RUNS = {
    "free": (dict(restart=True),
             L.Tols(parting=0.02),
             L.RecurrentTols(far=None, per_step=False, mu_max=2e-4)),
    "stepwise": (dict(feed="data", restart=True, learner_feed=True),
                 L.Tols(loss=(1e-5, 1e-6), parting=0.02),
                 L.RecurrentTols()),
}
_RUNS = {}


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    """Both cases' JAX recordings, made together, each in a process of its
    own."""
    out = tmp_path_factory.mktemp("rnn_lockstep")
    procs = {case: L.record_in_subprocess(case, str(out / f"{case}.pkl"),
                                          ppo=L.RNN_PPO) for case in CASES}
    return {case: L.load_record(proc, str(out / f"{case}.pkl"))
            for case, proc in procs.items()}


def lockstep(records, case: str, run: str) -> L.Lockstep:
    if (case, run) not in _RUNS:
        _RUNS[case, run] = L.run_lockstep(case, ppo=L.RNN_PPO,
                                          record=records[case],
                                          **RUNS[run][0])
    return _RUNS[case, run]


def test_recorded_without_excess_precision(records):
    """The recordings ran under the flag; this process's environment does
    not hold it, so the other JAX tests of this worker compile as ever."""
    for record in records.values():
        assert L.EXACT_PRECISION_FLAG in record.xla_flags.split()
    assert L.EXACT_PRECISION_FLAG not in os.environ.get("XLA_FLAGS", "")


@pytest.mark.parametrize("case", CASES)
def test_every_draw_replayed_at_its_site(records, case):
    """Every JAX draw of `init_fn` and both iterations found its row and
    was taken by the port's matching call, with its shape, none left over
    (the replay fails otherwise): drift's reset rows once, per step the
    recurrent rollout's action noise and K1's uniform and normal rows (16
    each), one env-axis permutation per iteration (`rnn_env_perm`, shared
    by both epochs). A KL residue handed over (`KL_RESIDUE`) is one of a
    first minibatch, where the port's estimate is 0."""
    for run in RUNS:
        ls = lockstep(records, case, run)
        assert set(ls.taken) == RNN_SITES
        assert ls.taken["rnn_action_noise"] == ls.taken[
            "drift_step_uniforms"] == ls.taken["drift_step_normals"] == 16
        assert ls.taken["rnn_env_perm"] == 2
        print(f"{case}, {run}: KL residues handed over: {ls.residues}")
        assert all(mb == 0 and kl_p == 0.0 for _, mb, _, kl_p in ls.residues)


@pytest.mark.parametrize("case", CASES)
def test_resets_inside_the_window(records, case):
    """The carry resets each iteration holds (JAX's rollout, whose masks the
    port's equal exactly in `test_iteration`): inside the window (steps 1
    to 7) and in each BPTT minibatch's columns. With 0.1 s episodes every
    minibatch of both iterations resets carries."""
    ls = lockstep(records, case, "free")
    for phase in (1, 2):
        J = L.split_events(ls.jax_events[phase])
        reset = J["traj"][0]["reset"]
        per_mb = [int(reset[:, L.minibatch_cols(
            m["action"], J["traj"][0]["action"])].sum())
            for m in J["minibatch"]]
        print(f"{case}, iteration {phase}: {int(reset[1:].sum())} resets "
              f"inside the window, {int(reset[0].sum())} at its start; by "
              f"minibatch {per_mb}")
        if case == "drift_rnn_resets":
            assert reset[1:].sum() > 100 and min(per_mb) > 0


@pytest.mark.parametrize("case", CASES)
def test_reset_replays_jax_init(records, case):
    """The port env's `reset` fed JAX's `init_fn` draws gives JAX's initial
    env state and observation."""
    report = L.compare_reset(lockstep(records, case, "free"), L.Tols())
    print(report.text())
    assert not report.failures, report.failures


@pytest.mark.parametrize("run", sorted(RUNS))
@pytest.mark.parametrize("phase", [1, 2])
@pytest.mark.parametrize("case", CASES)
def test_iteration(records, case, phase, run):
    """Iteration `phase` of the port against JAX's: every step, carry,
    transition, GAE value, minibatch and Adam step (module docstring)."""
    ls = lockstep(records, case, run)
    report = L.compare(ls, phase, RUNS[run][1], rnn=RUNS[run][2])
    print(f"{case}, {run}, iteration {phase}:\n{report.text()}")
    assert not report.failures, report.failures
