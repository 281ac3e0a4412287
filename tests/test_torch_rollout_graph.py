"""The graphed rollout (`rl/ppo.py::StepGraph`, `PPO.graphed_rollout`):
its step, run as it stands on the CPU, gives the eager loop's
(`act_and_step`'s) trajectory, accumulators, EnvState, obs and both
generators' states bit for bit over whole train iterations, a curriculum
boundary crossed mid-rollout included; the route is taken only by `PPO` on
a card with the fused step and no `traj/*` capture, and `GRAPH_STEPS` and
`EAGER_STEPS` count which route stepped. On a card, the captured graph
against the eager loop (skipped without one)."""

import dataclasses

import pytest
import torch

import wheeledlab_torch.rl  # noqa: F401  registers run configs
from wheeledlab_torch.envs.env import EnvState
from wheeledlab_torch.rl import ppo
from wheeledlab_torch.rl.ppo import PPOCfg, make_learner
from wheeledlab_torch.tasks import make_env

torch.set_num_threads(1)

T = 8
# the drift curriculum's first change (side_slip's, after 20 episodes of
# 250 steps)
BOUNDARY = 4750


def bits(x):
    """A float tensor's bit pattern, so that == is a bit-for-bit test."""
    x = x.detach().contiguous()
    ints = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
    return x.view(ints[x.dtype]) if x.dtype in ints else x


def assert_same(a, b, where="value"):
    """`a` and `b` equal bit for bit: tensors, dicts, sequences, dataclasses
    and plain values."""
    if isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor), where
        assert (a.dtype, a.shape) == (b.dtype, b.shape), where
        assert torch.equal(bits(a), bits(b)), where
    elif dataclasses.is_dataclass(a):
        assert type(a) is type(b), where
        for f in dataclasses.fields(a):
            assert_same(getattr(a, f.name), getattr(b, f.name),
                        f"{where}.{f.name}")
    elif isinstance(a, dict):
        assert list(a) == list(b), where
        for k in a:
            assert_same(a[k], b[k], f"{where}[{k}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{where}[{i}]")
    else:
        assert a == b, where


def cloned(x):
    """A copy of `x`'s tensors (the graphed route's trajectory is the
    graph's own, overwritten by the next rollout)."""
    if isinstance(x, torch.Tensor):
        return x.clone()
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, **{
            f.name: cloned(getattr(x, f.name)) for f in dataclasses.fields(x)})
    if isinstance(x, dict):
        return {k: cloned(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(cloned(v) for v in x)
    return x


def learner_of(envs, device="cpu", seed=3, task="MushrDriftRL-v0", **agent):
    env = make_env(task, num_envs=envs, device=device, seed=seed)
    cfg = PPOCfg(num_steps_per_env=T, num_learning_epochs=2,
                 num_mini_batches=2, **agent)
    return make_learner(env, cfg, seed=seed)


def recording(learner):
    """Record each rollout's outputs, copied, on the learner."""
    rollouts, rollout = [], learner.rollout

    def record(state, capture_traj=False):
        out = rollout(state, capture_traj)
        rollouts.append(cloned(out))
        return out

    learner.rollout = record
    return rollouts


def run(learner, iterations, common_step=None):
    """`iterations` train iterations from the learner's initial state
    (its step counter set to `common_step`); returns (rollouts, state,
    metrics of each iteration)."""
    rollouts = recording(learner)
    state = learner.init_state()
    if common_step is not None:
        state.env_state = dataclasses.replace(state.env_state,
                                              common_step=common_step)
    metrics = []
    for _ in range(iterations):
        state, m = learner.train_iteration(state)
        metrics.append(cloned(m))
    return rollouts, state, metrics


def assert_runs_equal(graphed, eager):
    (g_roll, g_state, g_metrics), g_learner = graphed
    (e_roll, e_state, e_metrics), e_learner = eager
    assert len(g_roll) == len(e_roll)
    for i, (g, e) in enumerate(zip(g_roll, e_roll)):
        for name, x, y in zip(("env_state", "obs", "traj", "acc"), g, e):
            assert_same(x, y, f"rollout {i} {name}")
    assert_same(g_state, e_state, "state")
    assert_same(g_metrics, e_metrics, "metrics")
    assert_same(g_learner.state_dict(), e_learner.state_dict(), "learner")
    assert_same(g_learner.env.generator.get_state(),
                e_learner.env.generator.get_state(), "env generator")


CASES = {
    "k1_64": (64, {}, None, False),
    "k1_256": (256, {}, None, False),
    "curriculum_boundary": (64, {}, BOUNDARY - 3, False),
    "kernel_rng": (64, {}, BOUNDARY - 11, True),
    "fused_input_layer": (64, {"fuse_input_layer": True}, None, False),
    "bfloat16": (128, {"compute_dtype": "bfloat16"}, None, False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_graph_step_uncaptured_equals_eager_loop(case, monkeypatch):
    """Two train iterations with the graphed route's step run as it stands
    (no capture on the CPU) against the eager loop: every rollout's traj,
    accumulators, EnvState and obs, the final state, the metrics, the
    learner (policy, Adam, its generator) and the env's generator, bit for
    bit. The curriculum cases start `common_step` 3 and 11 steps under a
    change of the weights, so the weights buffer is refreshed mid-rollout
    (and the case on the in-kernel-RNG route draws its rows from the
    per-step seed on the CPU)."""
    envs, agent, common_step, krng = CASES[case]
    if krng:
        monkeypatch.setenv("WHEELEDLAB_KERNEL_RNG", "1")
    runs = []
    for graphed in (True, False):
        learner = learner_of(envs, **agent)
        if graphed:
            learner.graphs_rollout = lambda capture_traj: not capture_traj
        steps = (ppo.GRAPH_STEPS, ppo.EAGER_STEPS)
        runs.append((run(learner, 2, common_step), learner))
        moved = (ppo.GRAPH_STEPS - steps[0], ppo.EAGER_STEPS - steps[1])
        assert moved == ((2 * T, 0) if graphed else (0, 2 * T))
    assert_runs_equal(*runs)
    if common_step is not None:
        final = runs[0][0][1].env_state.reward_weights
        assert not torch.equal(final, learner.env._weights_tensor(tuple(
            float(t.weight) for t in learner.env.task.reward_terms)))
    graph = runs[0][1].step_graph
    assert graph is not None and graph.graph is None


@pytest.mark.parametrize("route", ["cpu", "elevation", "capture_traj",
                                   "recurrent"])
def test_eager_routes(route, monkeypatch):
    """The CPU, an elevation env (the generic step), a rollout that
    captures `traj/*` and the recurrent learner take the eager loop:
    `EAGER_STEPS` advances by a step a step and `GRAPH_STEPS` stands. On a
    card (faked for the question alone), the drift learner would take the
    graph and these would not."""
    kw = {"task": "MushrElevationRL-v0"} if route == "elevation" else {}
    if route == "recurrent":
        kw.update(policy_class="ActorCriticRecurrent", rnn_hidden_size=8)
    learner = learner_of(16, **kw)
    capture = route == "capture_traj"
    assert not learner.graphs_rollout(capture)
    steps = (ppo.GRAPH_STEPS, ppo.EAGER_STEPS)
    learner.rollout(learner.init_state(), capture)
    assert (ppo.GRAPH_STEPS - steps[0], ppo.EAGER_STEPS - steps[1]) == (0, T)
    assert learner.step_graph is None
    monkeypatch.setattr(learner.env, "device", torch.device("cuda"))
    assert learner.graphs_rollout(capture) is (route == "cpu")


def test_a_new_state_rebuilds_the_graph():
    """A rollout handed a state whose read-only tensors (packed params,
    command, its timer) are other ones gets a graph over those; a state
    carrying the same ones keeps the graph."""
    learner = learner_of(16)
    learner.graphs_rollout = lambda capture_traj: True
    state = learner.init_state()
    env_state, obs, _, _ = learner.rollout(state)
    graph = learner.step_graph
    learner.rollout(ppo.TrainState(env_state=env_state, obs=obs,
                                   iteration=1))
    assert learner.step_graph is graph
    learner.rollout(learner.init_state())
    assert learner.step_graph is not graph


def test_first_obs_read_where_it_lies(monkeypatch):
    """A rollout whose obs lie otherwise than the graph's rows (a reset's,
    contiguous) runs its first step on them where they lie, as the eager
    loop's first step reads them; the obs a graphed rollout hands on lie
    as the rows do, and the next rollout replays every step."""
    learner = learner_of(16)
    learner.graphs_rollout = lambda capture_traj: True
    given, step = [], ppo.StepGraph.step

    def spy(self, obs=None):
        given.append(obs)
        return step(self, obs)

    monkeypatch.setattr(ppo.StepGraph, "step", spy)
    state = learner.init_state()
    assert state.obs.is_contiguous()
    env_state, obs, _, _ = learner.rollout(state)
    assert given[0] is state.obs and given[1:] == [None] * (T - 1)
    assert learner.step_graph.lays_out_like(obs)
    given.clear()
    learner.rollout(ppo.TrainState(env_state=env_state, obs=obs,
                                   iteration=1))
    assert given == [None] * T


def test_graph_result_holds_no_buffer():
    """What a graphed rollout hands back shares no storage with the graph's
    buffers but the trajectory."""
    learner = learner_of(16)
    learner.graphs_rollout = lambda capture_traj: True
    env_state, obs, traj, acc = learner.rollout(learner.init_state())
    g = learner.step_graph
    owned = {t.untyped_storage().data_ptr() for t in
             [g.obs_rows, g.acc, *(getattr(g.state, k) for k in ppo.CARRIED)]}
    handed = [obs, *acc.values(), *(getattr(env_state, k)
                                    for k in ppo.CARRIED)]
    assert not owned & {t.untyped_storage().data_ptr() for t in handed}
    assert all(traj[k] is g.traj[k] for k in traj)
    assert isinstance(env_state, EnvState)


def test_captured_graph_equals_eager_loop_on_a_card():
    """On a card: three iterations with the captured graph replayed against
    the eager loop, at 1024 envs: equal parameters, metrics, states and
    generator states, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the graph is captured there")
    runs = []
    for graphed in (True, False):
        learner = learner_of(1024, device="cuda")
        if not graphed:
            learner.graphs_rollout = lambda capture_traj: False
        assert learner.graphs_rollout(False) is graphed
        runs.append((run(learner, 3, BOUNDARY - 20), learner))
    assert runs[0][1].step_graph.graph is not None
    assert_runs_equal(*runs)
