"""The rollout's one step (`rl/ppo.py::StepGraph`, `PPO.run_steps`): run
as it stands on the CPU, it gives a plain step loop's (`reference_rollout`,
the reference written here) trajectory, accumulators, EnvState, obs and
both generators' states bit for bit over whole train iterations, a
curriculum boundary crossed mid-rollout included, on drift's fused step, on
the generic step (the visual and elevation tasks) and for the recurrent
learner; its video channels are the reference's; the EnvState tensors it
carries are those the step replaces; it is captured only on a card, off the
per-vehicle route and for a learner whose step may be (not the recurrent
one), and `REPLAYED_STEPS` and `UNCAPTURED_STEPS` count how it stepped. On
a card, the captured step against the same step uncaptured (skipped
without one)."""

import dataclasses
import functools

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import wheeledlab_torch.rl  # noqa: F401  registers run configs
from wheeledlab_torch.envs.env import EnvState
from wheeledlab_torch.rl import ppo
from wheeledlab_torch.rl.networks import gaussian_log_prob
from wheeledlab_torch.rl.ppo import (
    PPOCfg, info_increments, init_info_acc, make_learner,
)
from wheeledlab_torch.rl.recurrent import RecurrentPPO
from wheeledlab_torch.tasks import make_env

torch.set_num_threads(1)

T = 8
# the drift curriculum's first change (side_slip's, after 20 episodes of
# 250 steps)
BOUNDARY = 4750

VISUAL, ELEVATION = "MushrVisualRL-v0", "MushrElevationRL-v0"
# the generic step's tasks cut for the CPU: a small visual map, and
# episodes of 5 (visual) and 6 (elevation) steps, so that envs reset within
# a rollout, with elevation's goals resampled every 3 steps
GENERIC = {
    VISUAL: {"map_rows": 100, "map_cols": 100, "env_rows": 20,
             "env_cols": 20, "group_rows": 5, "group_cols": 5,
             "episode_length_s": 1.0},
    ELEVATION: {"episode_length_s": 0.6, "goal_resample_s": 0.3},
}
RECURRENT = {"policy_class": "ActorCriticRecurrent", "rnn_hidden_size": 8}
# elevation's first curriculum change (vel_towards_goal's, after 50
# episodes of 6 steps)
ELEVATION_BOUNDARY = 294


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
    """A copy of `x`'s tensors (a rollout's trajectory is its step's own,
    overwritten by the next rollout)."""
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


def learner_of(envs, device="cpu", seed=3, task="MushrDriftRL-v0",
               use_kernels=None, **agent):
    env = make_env(task, num_envs=envs, device=device, seed=seed,
                   overrides=GENERIC.get(task), use_kernels=use_kernels)
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


def assert_runs_equal(ours, theirs):
    (o_roll, o_state, o_metrics), o_learner = ours
    (t_roll, t_state, t_metrics), t_learner = theirs
    assert len(o_roll) == len(t_roll)
    for i, (o, t) in enumerate(zip(o_roll, t_roll)):
        assert len(o) == len(t)
        for j, (x, y) in enumerate(zip(o, t)):
            assert_same(x, y, f"rollout {i} output {j}")
    assert_same(o_state, t_state, "state")
    assert_same(o_metrics, t_metrics, "metrics")
    assert_same(o_learner.state_dict(), t_learner.state_dict(), "learner")
    assert_same(o_learner.env.generator.get_state(),
                t_learner.env.generator.get_state(), "env generator")


COLUMNS = ("obs", "action", "log_prob", "value", "reward", "done", "mean",
           "std")


@torch.no_grad()
def reference_rollout(learner, state, capture_traj=False):
    """The rollout as a plain step loop on the env's own states, the
    reference the learner's step is held to: the policy (the recurrent
    learner's LSTM step, its carry reset by the previous step's done), the
    action's sample, `env.step`, the timeout bootstrap `reward + gamma * V
    * time_out`, the stores and the info folding. Returns what
    `learner.rollout` returns."""
    env, cfg = learner.env, learner.cfg
    recurrent = isinstance(learner, RecurrentPPO)
    rows = {k: [] for k in COLUMNS + ("reset",) * recurrent}
    env_state, obs, acc = state.env_state, state.obs, None
    if recurrent:
        hidden, reset = state.hidden, state.reset_prev
    for _ in range(cfg.num_steps_per_env):
        if recurrent:
            hidden, mean, std, value = learner.model.step(hidden, obs, reset)
            rows["reset"].append(reset)
        else:
            mean, std, value = learner.policy_apply(obs)
        action = mean + std * torch.randn(mean.shape,
                                          generator=learner.generator)
        env_state, out = env.step(env_state, action)
        reward = out.reward + cfg.gamma * value * out.time_out
        for k, v in zip(COLUMNS, (obs, action,
                                  gaussian_log_prob(mean, std, action),
                                  value, reward, out.done, mean, std)):
            rows[k].append(v)
        acc = acc or init_info_acc(out.info)
        acc = {k: acc[k] + v
               for k, v in info_increments(acc, out.info, out.done).items()}
        obs, reset = out.obs, out.done.to(torch.float32)
    traj = {k: torch.stack(v).to(learner.obs_dtype if k == "obs"
                                 else torch.float32) for k, v in rows.items()}
    if recurrent:
        return env_state, obs, hidden, reset, state.hidden, traj, acc
    return env_state, obs, traj, acc


# (task, envs, agent settings, starting common_step, in-kernel RNG)
CASES = {
    "k1_64": ("MushrDriftRL-v0", 64, {}, None, False),
    "k1_256": ("MushrDriftRL-v0", 256, {}, None, False),
    "curriculum_boundary": ("MushrDriftRL-v0", 64, {}, BOUNDARY - 3, False),
    "kernel_rng": ("MushrDriftRL-v0", 64, {}, BOUNDARY - 11, True),
    "fused_input_layer": ("MushrDriftRL-v0", 64, {"fuse_input_layer": True},
                          None, False),
    "bfloat16": ("MushrDriftRL-v0", 128, {"compute_dtype": "bfloat16"},
                 None, False),
    "visual_16": (VISUAL, 16, {}, None, False),
    "visual_fused_input_layer": (VISUAL, 16, {"fuse_input_layer": True,
                                              "activation": "relu"},
                                 None, False),
    "elevation_16": (ELEVATION, 16, {}, None, False),
    "elevation_curriculum_boundary": (ELEVATION, 16, {},
                                      ELEVATION_BOUNDARY - 5, False),
    "recurrent_16": ("MushrDriftRL-v0", 16, RECURRENT, None, False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_rollout_equals_reference_loop(case, monkeypatch):
    """Two train iterations with the learner's rollout step (run as it
    stands: no capture on the CPU) against the same learner with its
    rollout the reference loop (`reference_rollout`): every rollout's
    outputs, the final state, the metrics, the learner (policy, Adam, its
    generator) and the env's generator, bit for bit. The curriculum cases
    start `common_step` a few steps under a change of the weights, so the
    weights buffer is refreshed mid-rollout (and the case on the
    in-kernel-RNG route draws its rows from the per-step seed on the CPU).
    The visual and elevation cases take the generic step, whose envs reset
    within a rollout here; the recurrent case carries the LSTM state and
    the `reset` column."""
    task, envs, agent, common_step, krng = CASES[case]
    if krng:
        monkeypatch.setenv("WHEELEDLAB_KERNEL_RNG", "1")
    runs = []
    for reference in (False, True):
        learner = learner_of(envs, task=task, **agent)
        if reference:
            learner.rollout = functools.partial(reference_rollout, learner)
        steps = (ppo.REPLAYED_STEPS, ppo.UNCAPTURED_STEPS)
        runs.append((run(learner, 2, common_step), learner))
        moved = (ppo.REPLAYED_STEPS - steps[0],
                 ppo.UNCAPTURED_STEPS - steps[1])
        assert moved == ((0, 0) if reference else (0, 2 * T))
    assert_runs_equal(*runs)
    if common_step is not None:
        final = runs[0][0][1].env_state.reward_weights
        assert not torch.equal(final, learner.env._weights_tensor(tuple(
            float(t.weight) for t in learner.env.task.reward_terms)))
    graph = runs[0][1].step_graph
    assert graph is not None and graph.graph is None
    assert runs[1][1].step_graph is None


CAPTURED_ON_A_CARD = ("cpu", "elevation", "visual", "capture_traj")


@pytest.mark.parametrize("route", ["cpu", "elevation", "capture_traj",
                                   "recurrent", "visual", "per_vehicle"])
def test_captured_routes(route, monkeypatch):
    """On the CPU every learner runs its step as it stands:
    `UNCAPTURED_STEPS` advances by a step a step and `REPLAYED_STEPS`
    stands. On a card (faked for the question alone), the drift learner's
    step and the generic step's (elevation, visual) would be captured, a
    rollout that captures `traj/*` too; the recurrent learner's and the
    per-vehicle route's would not."""
    kw = {"elevation": {"task": ELEVATION}, "visual": {"task": VISUAL},
          "per_vehicle": {"use_kernels": "off"},
          "recurrent": RECURRENT}.get(route, {})
    learner = learner_of(16, **kw)
    capture = route == "capture_traj"
    assert not ppo.StepGraph.captures(learner)
    steps = (ppo.REPLAYED_STEPS, ppo.UNCAPTURED_STEPS)
    out = learner.rollout(learner.init_state(), capture)
    assert (ppo.REPLAYED_STEPS - steps[0],
            ppo.UNCAPTURED_STEPS - steps[1]) == (0, T)
    assert learner.step_graph.graph is None
    traj = out[-2]
    assert capture is ("traj/pos" in traj)
    if capture:
        assert traj["traj/pos"].shape == (T, 8, 3)
    monkeypatch.setattr(learner.env, "device", torch.device("cuda"))
    assert ppo.StepGraph.captures(learner) is (route in CAPTURED_ON_A_CARD)


def test_video_channels_equal_reference_loop():
    """A rollout's `traj/*` channels (read from the step's carried state
    after each step) equal `traj_captures` of each env state the reference
    loop's steps return, bit for bit."""
    runs = []
    for reference in (False, True):
        learner = learner_of(16)
        state = learner.init_state()
        if reference:
            captured = []
            step = learner.env.step

            def spy(env_state, action):
                new, out = step(env_state, action)
                captured.append(ppo.traj_captures(new))
                return new, out

            learner.env.step = spy
            _, _, traj, _ = reference_rollout(learner, state)
            traj = {k: torch.stack([c[k] for c in captured])
                    for k in captured[0]}
        else:
            _, _, traj, _ = learner.rollout(state, capture_traj=True)
        runs.append({k: v for k, v in traj.items() if k.startswith("traj/")})
    assert list(runs[0]) == ["traj/pos", "traj/yaw", "traj/quat",
                             "traj/cmd"]
    assert_same(*runs, "traj")


# the EnvState tensors drift's fused step replaces
FUSED_CARRIED = ("vehicle_mem", "step_count", "last_action", "push_timers",
                 "ep_return", "ep_len")


@pytest.mark.parametrize("task", ["MushrDriftRL-v0", VISUAL, ELEVATION])
def test_carried_set_is_what_the_step_replaces(task):
    """The graph carries, in EnvState's order, the tensors its first step
    replaced: drift's fused step's six, and on the generic step the command
    and its timer besides (the reset's `torch.where` makes them anew each
    step, commands or none); the packed params it reads where they lie, and
    `serves` a state that hands in those same tensors."""
    learner = learner_of(16, task=task)
    state = learner.init_state()
    learner.rollout(state)
    g = learner.step_graph
    if task == "MushrDriftRL-v0":
        assert g.carried == FUSED_CARRIED
    else:
        assert {"vehicle_mem", "step_count", "last_action", "command",
                "command_timer", "ep_return", "ep_len"} <= set(g.carried)
        assert g.carried == tuple(k for k in ppo.STEP_FIELDS
                                  if k in g.carried)
    assert "packed_params" not in g.carried
    assert g.state.packed_params is state.env_state.packed_params
    assert g.serves(state.env_state)
    for k in g.carried:
        assert getattr(g.state, k) is not getattr(state.env_state, k)


def test_a_new_state_rebuilds_the_graph():
    """A rollout handed a state whose read-only tensors (packed params,
    command, its timer) are other ones gets a graph over those; a state
    carrying the same ones keeps the graph."""
    learner = learner_of(16)
    state = learner.init_state()
    env_state, obs, _, _ = learner.rollout(state)
    graph = learner.step_graph
    learner.rollout(ppo.TrainState(env_state=env_state, obs=obs,
                                   iteration=1))
    assert learner.step_graph is graph
    learner.rollout(learner.init_state())
    assert learner.step_graph is not graph


def spy_on_steps(monkeypatch):
    """The `obs` handed to each `StepGraph.step` from now on."""
    given, step = [], ppo.StepGraph.step

    def spy(self, obs=None):
        given.append(obs)
        return step(self, obs)

    monkeypatch.setattr(ppo.StepGraph, "step", spy)
    return given


def test_first_obs_read_where_it_lies(monkeypatch):
    """The step's first step, which lays its buffers out, reads a reset's
    obs where they lie; the obs a rollout hands on lie as the rows drift's
    fused step returns, and the next rollout reads the buffer at every
    step; a rollout whose obs lie otherwise than the rows (a reset's,
    contiguous) runs its first step on them where they lie, as the
    reference loop's first step reads them."""
    learner = learner_of(16)
    given = spy_on_steps(monkeypatch)
    state = learner.init_state()
    assert state.obs.is_contiguous()
    env_state, obs, _, _ = learner.rollout(state)
    assert given[0] is state.obs and given[1:] == [None] * (T - 1)
    assert learner.step_graph.obs.stride() == (1, 16)
    assert learner.step_graph.lays_out_like(obs)
    given.clear()
    env_state, _, _, _ = learner.rollout(ppo.TrainState(
        env_state=env_state, obs=obs, iteration=1))
    assert given == [None] * T
    given.clear()
    learner.rollout(ppo.TrainState(env_state=env_state, obs=state.obs,
                                   iteration=2))
    assert given[0] is state.obs and given[1:] == [None] * (T - 1)


def test_generic_step_obs_buffer_is_contiguous(monkeypatch):
    """The generic step returns contiguous (B, obs_dim) obs, as a reset
    does: the step's obs buffer is laid out so, and a rollout handed a
    reset's obs reads the buffer at every step, its first one included."""
    learner = learner_of(16, task=VISUAL)
    given = spy_on_steps(monkeypatch)
    state = learner.init_state()
    env_state, obs, _, _ = learner.rollout(state)
    g = learner.step_graph
    assert g.obs.shape == (16, learner.env.obs_dim) and g.obs.is_contiguous()
    assert given[0] is state.obs and given[1:] == [None] * (T - 1)
    assert obs.is_contiguous()
    given.clear()
    learner.rollout(ppo.TrainState(env_state=env_state, obs=state.obs,
                                   iteration=1))
    assert given == [None] * T


class HostData(TorchDispatchMode):
    """The shapes of the tensors made from host data (`torch.tensor`,
    `new_tensor`: `aten.lift_fresh`) while open."""

    def __init__(self):
        super().__init__()
        self.shapes = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.lift_fresh.default:
            self.shapes.append(tuple(args[0].shape))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("task", ["MushrDriftRL-v0", VISUAL, ELEVATION])
def test_step_copies_no_host_data(task):
    """A CUDA graph cannot capture a copy from pageable host memory, so a
    rollout step, once a first step has made its cached constants, makes
    no tensor from host data but 0-dim scalars (an `x[..., 0] = 1.0`
    fill, which launches a fill)."""
    learner = learner_of(16, task=task)
    learner.rollout(learner.init_state())
    g = learner.step_graph
    g.t.zero_()
    with HostData() as made:
        g.step()
    assert all(shape == () for shape in made.shapes), made.shapes


def test_graph_result_holds_no_buffer():
    """What a graphed rollout hands back shares no storage with the graph's
    buffers but the trajectory."""
    learner = learner_of(16)
    env_state, obs, traj, acc = learner.rollout(learner.init_state())
    g = learner.step_graph
    owned = {t.untyped_storage().data_ptr() for t in
             [g.obs, g.acc, *(getattr(g.state, k) for k in g.carried)]}
    handed = [obs, *acc.values(), *(getattr(env_state, k)
                                    for k in g.carried)]
    assert not owned & {t.untyped_storage().data_ptr() for t in handed}
    assert all(traj[k] is g.traj[k] for k in traj)
    assert isinstance(env_state, EnvState)


@pytest.mark.card
@pytest.mark.parametrize("task", ["MushrDriftRL-v0", VISUAL])
def test_captured_equals_uncaptured_on_a_card(task):
    """On a card: three iterations with the captured step replayed against
    the same step run as it stands, drift at 1024 envs across its
    curriculum's first change and the visual task (the generic step) at
    512: equal parameters, metrics, states and generator states, bit for
    bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the graph is captured there")
    drift = task == "MushrDriftRL-v0"
    runs = []
    for captured in (True, False):
        learner = learner_of(1024 if drift else 512, device="cuda", task=task)
        if not captured:
            learner.captures_step = False
        assert ppo.StepGraph.captures(learner) is captured
        runs.append((run(learner, 3, BOUNDARY - 20 if drift else None),
                     learner))
    assert runs[0][1].step_graph.graph is not None
    assert runs[1][1].step_graph.graph is None
    assert_runs_equal(*runs)
