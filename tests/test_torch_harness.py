"""The rest of the port's training harness on the CPU: the wandb sink
(driven through a real tiny `train()` with a stub `wandb` module, as
tests/test_wandb.py drives the JAX runner), checkpoints written off the
training thread, `scripts/train_bench.py` and `utils/profiling.py` held
against `wheeledlab_tpu/utils/profiling.py`."""

import json
import os
import sys
import threading
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wheeledlab_tpu.utils import profiling as jprof
import wheeledlab_torch.rl  # noqa: F401  registers run configs
from wheeledlab_torch.rl import runner
from wheeledlab_torch.rl.runner import CheckpointWriter, train
from wheeledlab_torch.utils import profiling

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_train import jax_runner_keys, read_metrics, tiny_cfg  # noqa: E402

torch.set_num_threads(1)


class _FakeRun:
    def __init__(self):
        self.logged = []
        self.finished = False

    def log(self, payload, step=None):
        self.logged.append((step, payload))

    def finish(self):
        self.finished = True


class _FakeVideo:
    def __init__(self, data, fps=None):
        assert data.ndim == 4 and data.shape[1] == 3  # (T, C, H, W)
        self.data = data
        self.fps = fps


@pytest.fixture
def fake_wandb(monkeypatch):
    mod = types.ModuleType("wandb")
    mod.run = _FakeRun()
    mod.init = lambda **kw: mod.run
    mod.Video = _FakeVideo
    monkeypatch.setitem(sys.modules, "wandb", mod)
    return mod


def cli_args(tmp_path, name, iterations, *extra):
    return ["-r", "RSS_DRIFT_CONFIG", "--device", "cpu", "num_envs=16",
            f"train.num_iterations={iterations}", "agent.num_steps_per_env=8",
            "agent.num_learning_epochs=2", "agent.num_mini_batches=2",
            "train.log.no_checkpoints=True", f"train.log.logs_dir={tmp_path}",
            f"train.log.run_name={name}", *extra]


class TestWandbSink:
    def test_metrics_and_video_uploaded(self, fake_wandb, tmp_path):
        from wheeledlab_torch.cli.train import main

        main(cli_args(tmp_path, "w1", 4, "train.log.log_every=2",
                      "train.log.no_wandb=False", "--video",
                      "train.log.video_interval=2"))
        logged = fake_wandb.run.logged
        metric_steps = [s for s, p in logged if "video" not in p]
        assert metric_steps == [2, 4]
        for _, p in logged:
            if "video" not in p:
                # the JAX runner's keys, as metrics.jsonl holds them
                assert {k for k in p if not k.startswith("time/")} \
                    == jax_runner_keys()
        videos = [p["video"] for _, p in logged if "video" in p]
        assert len(videos) == 2
        assert isinstance(videos[0], _FakeVideo)
        assert videos[0].data.dtype == np.uint8
        assert fake_wandb.run.finished

    def test_no_wandb_default_keeps_offline(self, fake_wandb, tmp_path):
        from wheeledlab_torch.cli.train import main

        main(cli_args(tmp_path, "w2", 2, "train.log.log_every=1"))
        assert fake_wandb.run.logged == []
        assert len(read_metrics(tmp_path, "w2")) == 2

    @pytest.mark.parametrize("failure", ["missing", "init_fails"])
    def test_without_wandb_training_carries_on(self, monkeypatch, tmp_path,
                                               failure):
        if failure == "missing":
            monkeypatch.setitem(sys.modules, "wandb", None)  # ImportError
        else:
            mod = types.ModuleType("wandb")

            def init(**kw):
                raise RuntimeError("no network")

            mod.init = init
            monkeypatch.setitem(sys.modules, "wandb", mod)
        state, _ = train(tiny_cfg(tmp_path, "w3", 2, **{
            "train.log.no_wandb": False}), verbose=False)
        assert state.iteration == 2
        assert [r["iteration"] for r in read_metrics(tmp_path, "w3")] \
            == [1, 2]


class TestCheckpointWriter:
    def test_write_happens_off_the_training_thread(self, monkeypatch,
                                                   tmp_path):
        """`save` returns while the file is still being written, holding a
        copy: changing the tensor afterwards does not reach the file."""
        gate, threads = threading.Event(), []
        real_save = torch.save

        def held_save(obj, f):
            threads.append(threading.current_thread().name)
            assert gate.wait(30)
            real_save(obj, f)

        monkeypatch.setattr(torch, "save", held_save)
        t = torch.arange(6, dtype=torch.float32)
        path = str(tmp_path / "ck" / "1.pt")
        writer = CheckpointWriter()
        writer.save(path, {"t": t, "nested": [(t, 3)]})
        t.add_(100.0)
        assert not os.path.exists(path)
        gate.set()
        writer.wait()
        assert threads == ["checkpoint-writer"]
        ck = torch.load(path, weights_only=True)
        assert torch.equal(ck["t"], torch.arange(6, dtype=torch.float32))
        assert torch.equal(ck["nested"][0][0], ck["t"])
        assert ck["nested"][0][1] == 3
        assert os.listdir(tmp_path / "ck") == ["1.pt"]

    def test_write_error_raised_by_wait(self, tmp_path):
        (tmp_path / "file").write_text("")
        writer = CheckpointWriter()
        writer.save(str(tmp_path / "file" / "1.pt"), {"x": torch.zeros(1)})
        with pytest.raises(OSError):
            writer.wait()
        writer.wait()   # reported once

    @pytest.mark.parametrize("policy", ["ActorCritic", "ActorCriticRecurrent"])
    def test_resume_bit_for_bit(self, tmp_path, policy):
        """A run resumed from a checkpoint written off the training thread
        continues exactly as a straight run: every metric that does not
        depend on the clock is equal."""
        extra = {"agent.policy_class": policy, "agent.rnn_hidden_size": 8}
        train(tiny_cfg(tmp_path, "a", 2, **extra), verbose=False)
        assert runner.checkpoint_steps(str(tmp_path / "a")) == [1, 2]
        train(tiny_cfg(tmp_path, "b", 3, **{"train.load_run": "a",
                                            **extra}), verbose=False)
        train(tiny_cfg(tmp_path, "c", 3, **extra), verbose=False)
        public = lambda row: {k: v for k, v in row.items()
                              if not k.startswith(("time/", "perf/"))}
        resumed = read_metrics(tmp_path, "b")
        assert [r["iteration"] for r in resumed] == [3]
        assert public(resumed[0]) == public(read_metrics(tmp_path, "c")[-1])


class TestTrainBench:
    @pytest.mark.parametrize("target", [-1e9, 1e9])
    def test_prints_one_json_line(self, tmp_path, capsys, target):
        from wheeledlab_torch.scripts import train_bench

        result = train_bench.main([
            "--device", "cpu", "--num-envs", "16", "--max-iterations", "2",
            "--target-return", str(target), "--log-every", "1",
            "--logs-dir", str(tmp_path), "--run-name", "tb",
            "--no-checkpoints"])
        line = capsys.readouterr().out.strip().splitlines()[-1]
        assert json.loads(line) == result
        reached = target < 0
        assert result["reached"] is reached
        # a target reached at the first log point stops the run there
        assert result["iterations"] == (1 if reached else 2)
        assert result["env_steps"] == result["iterations"] * 128 * 16
        assert result["metric"] == "rss_drift_config_train_to_return_s"
        assert result["device"] == "cpu"
        assert np.isfinite(result["return"]) and result["value"] > 0
        if not reached:
            assert result["steady_ms_per_iteration"] > 0
            assert result["train_s"] + result["startup_s"] == pytest.approx(
                result["value"])
        with open(tmp_path / "tb" / "result.json") as f:
            assert json.load(f) == result


class TestFullBudgetRuns:
    def test_runs_train_bench_together(self, tmp_path, capsys, monkeypatch):
        """`scripts/full_budget_runs.py` cut to 2 iterations at 16 envs on
        the CPU: each run is a `train_bench` process with the reference
        artifacts' settings, writes the three files, and is reported with
        the runs it shared the host with and its resident memory."""
        from wheeledlab_torch.scripts import full_budget_runs

        command = full_budget_runs.command
        monkeypatch.setattr(
            full_budget_runs, "command",
            lambda *a: command(*a) + ["--device", "cpu", "--num-envs", "16"])
        monkeypatch.setattr(full_budget_runs, "build_kernels", lambda: None)
        monkeypatch.setattr(full_budget_runs, "SAMPLE_S", 0.5)
        names = ["rss_drift_h100", "f1tenth_drift_h100_seed3"]
        rc = full_budget_runs.main([
            "--max-iterations", "2", "--logs-dir", str(tmp_path),
            "--only", *names])
        assert rc == 0
        lines = [json.loads(line) for line
                 in capsys.readouterr().out.strip().splitlines()]
        assert [line["run"] for line in lines] == names
        for line, other in zip(lines, reversed(names)):
            assert line["rc"] == 0 and line["shared_with"] == [other]
            assert line["rss_mib_max"] >= line["rss_mib_last"] > 0
            assert line["iterations"] == 2 and line["device"] == "cpu"
            assert line["target_return"] == 1e6
            for name in ("metrics.jsonl", "run_config.json", "result.json"):
                assert (tmp_path / line["run"] / name).exists()
            with open(tmp_path / line["run"] / "run_config.json") as f:
                run = json.load(f)["run"]
            assert run["train"]["log"]["log_every"] == 10
            assert run["train"]["log"]["no_checkpoints"] is True
        with open(tmp_path / "f1tenth_drift_h100_seed3" / "run_config.json") as f:
            run = json.load(f)["run"]
        assert run["task_name"] == "F1TenthDriftRL-v0"
        assert run["train"]["seed"] == 3
        with open(tmp_path / "full_budget_samples.jsonl") as f:
            samples = [json.loads(line) for line in f]
        assert samples and set(samples[0]["rss_mib"]) == set(names)

    def test_runs_on_the_card(self):
        """Without the test's CPU flags every run is a `train_bench` on its
        default device, the card, at the full budget."""
        from wheeledlab_torch.scripts import full_budget_runs

        args = full_budget_runs.build_parser().parse_args([])
        for name, config, seed, iterations in full_budget_runs.RUNS:
            cmd = full_budget_runs.command(args, name, config, seed,
                                           iterations)
            assert "--device" not in cmd and "--num-envs" not in cmd
            assert cmd[cmd.index("--max-iterations") + 1] == str(iterations)

    def test_unknown_run_refused(self, tmp_path):
        from wheeledlab_torch.scripts import full_budget_runs

        with pytest.raises(SystemExit):
            full_budget_runs.main(["--logs-dir", str(tmp_path),
                                   "--only", "no_such_run"])


class TestRunSummary:
    def test_reference_drift_run(self, capsys):
        """`scripts/run_summary.py` on the reference's committed seed-0
        drift run, against the numbers read straight from its files."""
        from wheeledlab_torch.scripts import run_summary

        run_dir = os.path.join(os.path.dirname(__file__), "..", "docs",
                               "runs", "rss_drift_tpu")
        (line,) = run_summary.main([run_dir])
        assert json.loads(capsys.readouterr().out) == json.loads(
            json.dumps(line))
        rows = read_metrics(os.path.dirname(run_dir), "rss_drift_tpu")
        ret = np.array([r["episode/return"] for r in rows])
        assert line["run"] == "rss_drift_tpu"
        assert line["iterations"] == 5000
        assert line["last10_return"] == pytest.approx(ret[-10:].mean())
        assert line["first3_return"] == pytest.approx(ret[:3].mean())
        assert set(line["at"]) == set(run_summary.AT)
        assert line["at"][5000]["episode/return"] == rows[-1]["episode/return"]
        first = int(np.argmax(ret >= 700))
        assert line["bar_iteration"] == rows[first]["iteration"]
        assert line["bar_wall_s"] == rows[first]["perf/wall_s"]
        last = [r for r in rows if r["iteration"] > 4000]
        assert line["last1000_lr_max"] == max(r["lr"] for r in last)
        assert 0.0 <= line["last1000_lr_at_max_share"] <= 1.0
        assert line["nonfinite_returns"] == 0
        assert line["steady_ms_per_iteration"] == 10.29


    def test_reference_elevation_stall(self, capsys):
        """The stall indicators and the bars' channels on the reference's
        seed-0 elevation run, against its rows read directly: the first
        log point with |KL| < STALL_KL, the first after it that begins
        BACK_POINTS log points with KL >= BACK_KL, and the first-3 and
        last-10 ground height."""
        from wheeledlab_torch.scripts import run_summary

        run_dir = os.path.join(os.path.dirname(__file__), "..", "docs",
                               "runs", "rss_elev_tpu")
        (line,) = run_summary.main([run_dir, "--bar", "80000"])
        capsys.readouterr()
        rows = read_metrics(os.path.dirname(run_dir), "rss_elev_tpu")
        kl = np.array([r["loss/kl"] for r in rows])
        its = np.array([r["iteration"] for r in rows])
        stall = int(np.argmax(np.abs(kl) < run_summary.STALL_KL))
        ok = kl >= run_summary.BACK_KL
        n = run_summary.BACK_POINTS
        back = next(i for i in range(stall + 1, len(rows))
                    if ok[i:i + n].all())
        assert line["stall_iteration"] == its[stall]
        assert line["kl_back_iteration"] == its[back]
        assert its[stall] < its[back] < 1000
        height = [r["metrics/ground_height"] for r in rows]
        assert line["first3_ground_height"] == pytest.approx(
            np.mean(height[:3]))
        assert line["last10_ground_height"] == pytest.approx(
            np.mean(height[-10:]))
        assert "first3_slip_deg" not in line
        assert set(line["at"]) == {a for a in run_summary.AT if a <= 4000}

    def test_reference_visual_curve(self, capsys):
        """`--at` and `--keys` on the reference's visual run: the
        traversable share and the entropy at the iterations asked for, and
        the shares of log points with the LR at `min_lr` and at `max_lr`,
        against its rows read directly."""
        from wheeledlab_torch.scripts import run_summary

        run_dir = os.path.join(os.path.dirname(__file__), "..", "docs",
                               "runs", "rss_visual_tpu")
        keys = ["metrics/traversable_frac", "loss/entropy"]
        (line,) = run_summary.main([run_dir, "--at", "400", "800", "3600",
                                    "--keys", *keys])
        capsys.readouterr()
        rows = {r["iteration"]: r for r in read_metrics(
            os.path.dirname(run_dir), "rss_visual_tpu")}
        assert set(line["at"]) == {400, 800, 3600}
        for it, got in line["at"].items():
            assert got == {k: rows[it][k] for k in (*run_summary.AT_KEYS,
                                                    *keys)}
        lr = np.array([r["lr"] for r in rows.values()])
        assert line["lr_at_min_share"] == pytest.approx(
            np.mean(lr <= 1e-5 * (1 + 1e-6)))
        assert line["lr_at_max_share"] == pytest.approx(
            np.mean(lr >= 1e-2 * (1 - 1e-6)))
        assert 0.0 < line["lr_at_min_share"] < 1.0
        assert line["first3_traversable_frac"] < 0.3 < 0.6 < line[
            "last10_traversable_frac"]

    @pytest.mark.parametrize("bar, want", [(1.5, 4.0), (2.5, 46.0 + 3.0),
                                           (3.5, 46.0 + 27.0 + 2.0)])
    def test_stitched_bar_wall_s(self, tmp_path, capsys, bar, want):
        """On a run stitched from segments, whose `perf/wall_s` restarts in
        each, the seconds to the bar add the training seconds of every
        segment before the one that logged the bar's row."""
        from wheeledlab_torch.scripts import run_summary

        rows = [(10, 1.0, 2.0), (20, 2.0, 4.0),     # segment 0, to 20
                (30, 3.0, 3.0),                     # segment 1, from 20
                (40, 4.0, 2.0), (50, 5.0, 5.0)]     # segment 2, from 30
        (tmp_path / "metrics.jsonl").write_text("".join(
            json.dumps({"iteration": it, "episode/return": ret,
                        "perf/wall_s": wall, "loss/kl": 1e-3, "lr": 1e-3})
            + "\n" for it, ret, wall in rows))
        (tmp_path / "run_config.json").write_text(json.dumps(
            {"run": {"agent": {"min_lr": 1e-5, "max_lr": 1e-2}}}))
        (tmp_path / "result.json").write_text(json.dumps({"segments": [
            {"iterations": [0, 20], "train_s": 46.0},
            {"iterations": [20, 30], "train_s": 27.0},
            {"iterations": [30, 50], "train_s": 5.0}]}))
        (line,) = run_summary.main([str(tmp_path), "--bar", str(bar)])
        capsys.readouterr()
        assert line["bar_wall_s"] == want


class TestProfiling:
    def test_phase_timer_matches_jax(self):
        """The same phases give the same keys, counts and fractions."""
        timers = (profiling.PhaseTimer(), jprof.PhaseTimer())
        for timer in timers:
            for name in ("rollout", "update", "rollout"):
                with timer.phase(name):
                    time.sleep(0.01)
        mine, ref = (t.summary() for t in timers)
        assert mine.keys() == ref.keys()
        assert dict(timers[0].counts) == dict(timers[1].counts) \
            == {"rollout": 2, "update": 1}
        for timer in timers:
            timer.reset()
            assert timer.summary() == {}

    def test_phase_waits_for_sync(self, monkeypatch):
        """`sync=` stops the clock only once the card (stood in for here)
        is done: a device or tensor through `torch.cuda.synchronize`, an
        event through its `synchronize`."""
        waited = []

        def slow_sync(dev=None):
            time.sleep(0.05)
            waited.append(torch.device(dev))

        class Event:
            def synchronize(self):
                time.sleep(0.05)
                waited.append("event")

        monkeypatch.setattr(torch.cuda, "synchronize", slow_sync)
        timer = profiling.PhaseTimer()
        with timer.phase("a", sync=torch.device("cuda", 0)):
            pass
        with timer.phase("b", sync=Event()):
            pass
        with timer.phase("c", sync=torch.zeros(1)):   # CPU: nothing pending
            pass
        assert waited == [torch.device("cuda", 0), "event"]
        assert timer.totals["a"] >= 0.05 and timer.totals["b"] >= 0.05
        assert timer.totals["c"] < 0.05

    def test_trace_writes_chrome_trace(self, tmp_path):
        with profiling.trace(str(tmp_path / "t")) as prof:
            torch.ones(64).cumsum(0)
        assert any("cumsum" in e.key for e in prof.key_averages())
        with open(tmp_path / "t" / "trace.json") as f:
            assert json.load(f)["traceEvents"]

    def test_trace_warns_without_the_card(self, tmp_path, monkeypatch):
        """A trace taken with a card that holds nothing of it warns: a
        stand-in profiler records the host's ops alone."""
        events = []

        class HostOnly:
            def __init__(self, activities):
                assert torch.profiler.ProfilerActivity.CUDA in activities

            start = stop = lambda self: None

            def export_chrome_trace(self, path):
                with open(path, "w") as f:
                    json.dump({"traceEvents": []}, f)

            def events(self):
                return events

        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.profiler, "profile", HostOnly)
        with pytest.warns(UserWarning, match="recorded nothing on the card"):
            with profiling.trace(str(tmp_path / "t")):
                torch.ones(64).cumsum(0)
        assert (tmp_path / "t" / "trace.json").exists()

    def test_debug_nans(self):
        """Both raise at the op that makes a NaN once turned on: JAX's
        computations, the port's backward pass."""
        x = torch.tensor([-1.0], requires_grad=True)
        try:
            jprof.debug_nans(True)
            profiling.debug_nans(True)
            with pytest.raises(FloatingPointError):
                jax.jit(jnp.log)(-1.0).block_until_ready()
            with pytest.raises(RuntimeError, match="nan"), \
                    pytest.warns(UserWarning, match="SqrtBackward"):
                torch.sqrt(x).sum().backward()
        finally:
            jprof.debug_nans(False)
            profiling.debug_nans(False)
        assert not torch.is_anomaly_enabled()
        torch.sqrt(x).sum().backward()   # off again: NaN gradient, no raise
        assert torch.isnan(x.grad).all()


if __name__ == "__main__":
    sys.exit(pytest.main([__file__, "-x", "-q"]))
