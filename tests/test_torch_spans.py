"""The program's spans (`utils/profiling.py::span`): off, a span is one
shared no-op and a train iteration records nothing; on, one iteration of
the drift (fused step), elevation (generic step) and recurrent learners
gives each span its expected calls, children inside their parents, and the
same parameters and metrics as with spans off. The runner logs the spans'
keys with `train.profile` on and none with it off. `benchmark/
span_trace.py` reduces a device trace by the program's spans."""

import json
import os

import pytest
import torch

import wheeledlab_torch.rl  # noqa: F401  registers run configs
from benchmark import span_trace, tracing
from wheeledlab_torch.rl.ppo import PPOCfg, make_learner
from wheeledlab_torch.rl.runner import train
from wheeledlab_torch.tasks import make_env
from wheeledlab_torch.utils import profiling
from wheeledlab_torch.utils.config import RUN_CONFIGS, apply_overrides

torch.set_num_threads(1)

T, EPOCHS, MINIBATCHES = 4, 2, 2
ITERATION = ("ppo.rollout", "ppo.gae", "ppo.update", "ppo.metrics")
# parent -> the spans opened directly inside it
CHILDREN = {
    "ppo.iteration": ITERATION,
    "ppo.rollout": ("ppo.step_graph",),
    "ppo.step_graph": ("ppo.act", "ppo.record", "env.step"),
    "ppo.update": ("ppo.shuffle", "ppo.minibatch"),
    "ppo.minibatch": ("ppo.forward", "ppo.backward", "ppo.optimizer"),
    "env.step": ("drift.draw", "drift.launch", "drift.outputs",
                 "env.physics", "env.events", "env.terms", "env.reset",
                 "env.observe"),
}
DRIFT = ("drift.draw", "drift.launch", "drift.outputs")
GENERIC = ("env.physics", "env.events", "env.terms", "env.reset",
           "env.observe")
CASES = {
    "drift": ("MushrDriftRL-v0", 16, {}, DRIFT),
    "elevation": ("MushrElevationRL-v0", 4, {}, GENERIC),
    "recurrent": ("MushrDriftRL-v0", 8,
                  {"policy_class": "ActorCriticRecurrent",
                   "rnn_hidden_size": 8}, DRIFT),
}


@pytest.fixture(autouse=True)
def spans_off():
    """Every test starts and ends with spans off and nothing recorded."""
    profiling.enable_spans(False)
    profiling.drain()
    yield
    profiling.enable_spans(False)
    profiling.drain()


def learner_of(case, seed=0):
    task, envs, agent, _ = CASES[case]
    env = make_env(task, num_envs=envs, device="cpu", seed=seed)
    cfg = PPOCfg(num_steps_per_env=T, num_learning_epochs=EPOCHS,
                 num_mini_batches=MINIBATCHES, **agent)
    return make_learner(env, cfg, seed=seed)


def test_off_is_the_shared_noop_and_records_nothing(monkeypatch):
    """Off: `span()` hands back `NO_SPAN`, and a drift iteration under a
    running profiler opens no `record_function` and records no span."""
    assert profiling.span("ppo.rollout") is profiling.NO_SPAN
    assert profiling.span("env.step") is profiling.NO_SPAN
    opened = []
    real = torch.profiler.record_function

    def counting(name, *args):
        opened.append(name)
        return real(name, *args)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    learner = learner_of("drift")
    state = learner.init_state()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        learner.train_iteration(state)
    assert opened == []
    assert profiling.drain() == {}
    assert not [e.name for e in prof.events()
                if e.name.split(".")[0] in span_trace.PROGRAM_LAYERS]


def test_on_under_a_profiler_opens_record_function(monkeypatch):
    """On, a span opens its `record_function` while a profiler runs, and
    not otherwise."""
    opened = []
    real = torch.profiler.record_function

    def counting(name, *args):
        opened.append(name)
        return real(name, *args)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    profiling.enable_spans(True, "cpu")
    with profiling.span("ppo.gae"):
        pass
    assert opened == []
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiling.span("ppo.gae"):
            torch.ones(4).sum()
    assert opened == ["ppo.gae"]
    assert [e.name for e in prof.events()].count("ppo.gae") == 1
    totals = profiling.drain()
    assert totals["ppo.gae"].calls == 2 and totals["ppo.gae"].timed == 0


@pytest.mark.parametrize("case", sorted(CASES))
def test_one_iteration_calls_and_nesting(case):
    """One iteration: `ppo.step_graph` (the rollout's step, run as it
    stands on the CPU), `env.step`, `ppo.act` and the step's phases once a
    step, `ppo.record` twice a step, the minibatch and its parts once a
    minibatch, the rest once; each parent's host time holds its
    children's. On the CPU no call is timed on the card."""
    learner = learner_of(case)
    state = learner.init_state()
    profiling.enable_spans(True, "cpu")
    learner.train_iteration(state)
    profiling.enable_spans(False)
    totals = profiling.drain()
    steps = dict.fromkeys(("ppo.step_graph", "env.step", "ppo.act")
                          + CASES[case][3], T)
    mb = dict.fromkeys(CHILDREN["ppo.minibatch"] + ("ppo.minibatch",),
                       EPOCHS * MINIBATCHES)
    once = dict.fromkeys(ITERATION + ("ppo.iteration", "ppo.shuffle"), 1)
    assert {k: v.calls for k, v in totals.items()} == {
        **steps, **mb, **once, "ppo.record": 2 * T}
    for parent, children in CHILDREN.items():
        inside = sum(totals[c].host_ms for c in children if c in totals)
        assert 0.0 < inside <= totals[parent].host_ms, parent
    assert all(t.timed == 0 and t.device_ms == 0.0
               for t in totals.values())
    assert profiling.drain() == {}


@pytest.mark.parametrize("case", ["drift", "recurrent"])
def test_spans_change_no_bit(case):
    """Two iterations from one seed with spans on and off: the same
    parameters and metrics, bit for bit."""
    runs = []
    for on in (False, True):
        learner = learner_of(case, seed=3)
        state = learner.init_state()
        profiling.enable_spans(on, "cpu")
        for _ in range(2):
            state, metrics = learner.train_iteration(state)
        profiling.enable_spans(False)
        runs.append(({k: v.detach().clone()
                      for k, v in learner.model.state_dict().items()},
                     metrics))
    (p_off, m_off), (p_on, m_on) = runs
    assert p_off.keys() == p_on.keys()
    assert all(torch.equal(p_off[k], p_on[k]) for k in p_off)
    assert m_off.keys() == m_on.keys()
    assert all(torch.equal(m_off[k], m_on[k]) for k in m_off)
    assert profiling.drain()["ppo.iteration"].calls == 2


def test_drain_resolves_only_what_the_card_passed(monkeypatch):
    """`drain()` reads the device time of event pairs whose end has
    completed and keeps the others for a later drain; it never
    synchronizes."""

    class Event:
        def __init__(self, done, t):
            self.done, self.t = done, t

        def query(self):
            return self.done

        def elapsed_time(self, end):
            return end.t - self.t

        def synchronize(self):
            raise AssertionError("drain synchronized")

    late = Event(False, 9.0)
    monkeypatch.setattr(profiling, "_span_pending", [
        ("env.step", Event(True, 1.0), Event(True, 3.5)),
        ("env.step", Event(True, 4.0), late),
    ])
    monkeypatch.setattr(profiling, "_span_events", [])
    profiling._span_totals["env.step"] = [2, 0.004, 0.0, 0]
    first = profiling.drain()["env.step"]
    assert (first.calls, first.device_ms, first.timed) == (2, 2.5, 1)
    assert first.host_ms == pytest.approx(4.0)
    late.done = True
    second = profiling.drain()["env.step"]
    assert (second.calls, second.device_ms, second.timed) == (0, 5.0, 1)
    assert len(profiling._span_events) == 4     # back in the pool
    assert profiling.span_summary({"env.step": first}) == {
        "span/env.step/calls": 2.0, "span/env.step/host_ms": 2.0,
        "span/env.step/device_ms": 2.5}


@pytest.mark.parametrize("profile", [True, False])
def test_runner_logs_spans_with_profile_on(tmp_path, profile):
    """`train.profile` turns spans on for the loop: each log row holds every
    span's calls and mean host ms since the last row; off, none. Spans are
    off again after the run."""
    cfg = apply_overrides(RUN_CONFIGS.get("RSS_DRIFT_CONFIG"), {
        "num_envs": 16, "agent.num_steps_per_env": T,
        "agent.num_learning_epochs": 1, "agent.num_mini_batches": 2,
        "train.log.log_every": 1, "train.log.checkpoint_every": 1,
        "device": "cpu", "train.log.logs_dir": str(tmp_path),
        "train.log.run_name": "p", "train.num_iterations": 2,
        "train.profile": profile})
    train(cfg, verbose=False)
    assert profiling.span("ppo.rollout") is profiling.NO_SPAN
    with open(os.path.join(tmp_path, "p", "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    assert [r["iteration"] for r in rows] == [1, 2]
    for row in rows:
        spans = {k for k in row if k.startswith("span/")}
        if not profile:
            assert not spans
            continue
        assert row["span/ppo.rollout/calls"] == 1.0
        assert row["span/env.step/calls"] == float(T)
        assert row["span/ppo.minibatch/calls"] == 2.0
        assert 0.0 < row["span/env.step/host_ms"] \
            < row["span/ppo.rollout/host_ms"]
        assert not any(k.endswith("/device_ms") for k in spans)
    if profile:
        # a row holds its own metric read; the checkpoint after row 1 is in
        # row 2
        assert [r["span/runner.log/calls"] for r in rows] == [1.0, 1.0]
        assert "span/runner.checkpoint/calls" not in rows[0]
        assert rows[1]["span/runner.checkpoint/calls"] == 1.0


def x(cat, name, ts, dur, tid=1):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": 1, "tid": tid}


def synthetic_trace():
    """A window 0-100 us: `ppo.rollout` 0-60 holding two `env.step`s
    (10-20, 30-50), `ppo.update` 60-100; launches on the main thread and
    one on the autograd engine's thread (tid 2) inside the update."""
    return [
        x("user_annotation", tracing.WINDOW_LABEL, 0, 100),
        x("user_annotation", "ppo.rollout", 0, 60),
        x("user_annotation", "env.step", 10, 10),
        x("user_annotation", "env.step", 30, 20),
        x("user_annotation", "ppo.update", 60, 40),
        x("user_annotation", "bench.rollout", 0, 60),      # not the program's
        x("user_annotation", "Optimizer.step#Adam.step", 70, 5),
        x("cpu_op", "aten::add", 12, 2),
        x("cuda_runtime", "cudaLaunchKernel", 12, 1),       # env.step 1
        x("cuda_runtime", "cudaMemsetAsync", 15, 1),        # env.step 1
        x("cuda_driver", "cuLaunchKernel", 35, 1),          # env.step 2
        x("cuda_runtime", "cudaStreamSynchronize", 40, 1),  # not a launch
        x("cuda_runtime", "cudaLaunchKernel", 55, 1),       # rollout only
        x("cuda_runtime", "cudaLaunchKernel", 80, 1, tid=2),  # update
        x("cuda_runtime", "cudaMemcpyAsync", 90, 1),        # update
        x("kernel", "k", 14, 10, tid=7),        # 14-24
        x("gpu_memset", "m", 20, 10, tid=7),    # 20-30: busy 14-30
        x("kernel", "k", 40, 5, tid=7),         # 40-45
        x("kernel", "k", 82, 8, tid=7),         # 82-90
        x("gpu_memcpy", "c", 95, 10, tid=7),    # 95-105, clipped at 100
    ]


def test_span_trace_counts_launches_and_idle_by_span():
    events = synthetic_trace()
    r = span_trace.reduce_spans(events)
    assert set(r) == {"ppo.rollout", "env.step", "ppo.update"}
    assert r["env.step"].calls == 2
    assert r["env.step"].launches == 3
    assert r["ppo.rollout"].launches == 4
    assert r["ppo.update"].launches == 2      # one of them on thread 2
    # idle: env.step 10-20 busy 14-20 (4 idle), 30-50 busy 40-45 (15 idle)
    assert r["env.step"].idle_s == pytest.approx(19e-6)
    assert r["env.step"].span_s == pytest.approx(30e-6)
    # rollout 0-60 busy 14-30 and 40-45: 39 idle; update 60-100 busy 82-90
    # and 95-100: 27 idle
    assert r["ppo.rollout"].idle_s == pytest.approx(39e-6)
    assert r["ppo.update"].idle_s == pytest.approx(27e-6)
    idle = span_trace.idle_by_innermost(events)
    assert idle == pytest.approx({"ppo.rollout": 20e-6, "env.step": 19e-6,
                                  "ppo.update": 27e-6})
    assert span_trace.launches_and_device_events(events) == (6, 5)
    # the benchmark's own summary of the same trace is untouched by spans
    s = tracing.summarize(events)
    assert s.busy_s == pytest.approx(34e-6)
    assert sum(v for _, v in s.idle_gaps) == pytest.approx(66e-6)


def test_span_trace_without_window_or_spans():
    events = [e for e in synthetic_trace()
              if e["name"] != tracing.WINDOW_LABEL]
    assert span_trace.reduce_spans(events)["ppo.update"].launches == 2
    assert sum(span_trace.idle_by_innermost(events).values()) \
        == pytest.approx(66e-6)
    bare = [e for e in events if e["cat"] != "user_annotation"]
    assert span_trace.reduce_spans(bare) == {}
    assert span_trace.idle_by_innermost(bare) == {}
