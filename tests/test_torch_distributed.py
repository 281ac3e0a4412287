"""Multi-process training of the port (`wheeledlab_torch/parallel/`,
`rl/ppo.py` with a world, `rl/runner.py`) in real 2-process gloo jobs on
the CPU, the counterpart of tests/test_distributed.py.

Two jobs of 2 ranks (`_torch_distributed_worker.py`, 127.0.0.1, a free
port), MushrDriftRL-v0 at 64 envs globally, 8 steps, 2 epochs x 2
minibatches:

- job a: the MLP and the recurrent learner (hidden 16) on per-rank shard
  seeds, each iteration recorded so that a one-process learner can redo
  its reductions over the global batch; one K4 step from equal generators;
  `train()` of POD_DRIFT_CONFIG cut to 64 envs with checkpoints, and a
  straight 3-iteration run;
- job b: both learners with both ranks on the same seeds, held against a
  one-process run of 32 envs; a resume of job a's run from iteration 2.

Every job is killed, both ranks, if it outlives `JOB_TIMEOUT_S`.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import wheeledlab_torch.rl  # noqa: F401  registers run configs
from wheeledlab_torch.parallel.mesh import (
    SHARD_SEED_STRIDE, World, int32_shard_offset, local_num_envs, shard_seed,
)
from wheeledlab_torch.rl.runner import checkpoint_steps, train
from wheeledlab_torch.utils.config import RUN_CONFIGS, apply_overrides

sys.path.insert(0, os.path.dirname(__file__))
from _torch_distributed_worker import (  # noqa: E402
    ENV_OVERRIDES, GLOBAL_ENVS, SEED, TINY, flat_params, learner_run, ppo_cfg,
)

torch.set_num_threads(1)

WORKER = os.path.join(os.path.dirname(__file__), "_torch_distributed_worker.py")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JOB_TIMEOUT_S = 300
# (c): each rank's gradient and KL equal the one-process run's, so their
# mean over 2 ranks is exact; only the advantage normalization is computed
# another way (all-reduced sum / N and sum of squares / N against
# `torch.mean` / `torch.std`), which may round a float32 ulp apart and be
# amplified by 2 iterations of Adam. Measured at this size: equal, bit for
# bit, parameters, learning rate and metrics of both learners.
SAME_SEED_TOL = dict(rtol=1e-5, atol=1e-5)
# (f): the moments of the advantages, all-reduced (sum / N, then the summed
# squared deviations / N) against `torch.mean`/`torch.std` and
# `jnp.mean`/`jnp.std` of the concatenated [T, 64] advantages, which sum in
# another order: float32 rounding.
MOMENT_TOL = dict(rtol=1e-5, atol=1e-6)
# (f): the update from the mean of two ranks' gradients against the
# gradient of the global minibatch, and the metrics from summed or averaged
# shard values against the one-process formulas: float32 rounding, carried
# through 2 iterations of Adam. Measured at this size: parameters within
# 6.2e-7, metrics within 1.3e-7 of their size (3.1e-5 of loss/total).
TWO_SHARD_TOL = dict(rtol=1e-5, atol=1e-5)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_job(out_dir, job, nproc=2, worker=WORKER):
    """Run `job` on `nproc` ranks of `worker`; returns each rank's saved
    results."""
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    env.pop("WHEELEDLAB_KERNEL_RNG", None)
    procs = [subprocess.Popen(
        [sys.executable, worker, str(port), str(nproc), str(rank),
         str(out_dir), job],
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for rank in range(nproc)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=JOB_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"rank failed:\n{out}"
    return [torch.load(os.path.join(out_dir, f"{job}-rank{r}.pt"),
                       weights_only=False) for r in range(nproc)], outs


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    out = tmp_path_factory.mktemp("dist")
    a, a_out = run_job(out, "a")
    with open(out / "run.json", "w") as f:
        json.dump({"run": a[0]["train"]["run"]}, f)
    b, _ = run_job(out, "b")
    return {"a": a, "a_stdout": a_out, "b": b, "dir": out}


def wide(tol, factor=10):
    """`tol` widened `factor` times: what a wrong reduction must miss by."""
    return {k: v * factor for k, v in tol.items()}


def global_update(learner, p, q, policy):
    """One minibatch update of a one-process learner on the global
    minibatch made of two ranks' minibatches `p` and `q`. The MLP's loss is
    taken over the rows joined. The recurrent learner's is taken as the
    mean of the two halves' losses, the same function: its bfloat16 cells
    round differently at another batch width (in one process, the joined
    gradient is 5.7e-4 of its norm from the mean of the halves' gradients,
    with tiny components of opposite sign that Adam turns into whole
    steps)."""
    if policy == "mlp":
        return learner.minibatch_update(tuple(torch.cat(pair)
                                              for pair in zip(p, q)))
    loss = learner.loss

    def mean_of_halves(_):
        (tp, aux_p), (tq, aux_q) = loss(p), loss(q)
        return (tp + tq) / 2, tuple((x + y) / 2 for x, y in zip(aux_p, aux_q))

    learner.loss = mean_of_halves
    try:
        return learner.minibatch_update(None)
    finally:
        del learner.loss


def assert_states_equal(x, y):
    assert x.keys() == y.keys()
    for k in x:
        if isinstance(x[k], torch.Tensor):
            assert torch.equal(x[k], y[k]), k
        else:
            assert x[k] == y[k], k


class TestTwoRanks:
    @pytest.mark.parametrize("policy", ["mlp", "rnn"])
    def test_ranks_agree_bit_for_bit(self, jobs, policy):
        """(a) the same metrics, all finite, and the same parameters and
        learning rate on both ranks after every iteration."""
        r0, r1 = jobs["a"][0][policy], jobs["a"][1][policy]
        for it in range(2):
            assert r0["metrics"][it] == r1["metrics"][it], it
            assert all(np.isfinite(v) for v in r0["metrics"][it].values())
            assert torch.equal(r0["params"][it], r1["params"][it]), it
            assert torch.equal(r0["lr"][it], r1["lr"][it]), it
        # and the parameters moved
        assert not torch.equal(r0["params"][0], r0["params"][1])

    @pytest.mark.parametrize("policy", ["mlp", "rnn"])
    def test_shards_differ(self, jobs, policy):
        """(b) each rank steps its own shard."""
        assert not torch.equal(jobs["a"][0][policy]["init_mem"],
                               jobs["a"][1][policy]["init_mem"])

    @pytest.mark.parametrize("policy", ["mlp", "rnn"])
    def test_two_shards_match_one_process(self, jobs, policy):
        """(f) on two distinct shards, every reduction is the one-process
        computation over the global batch of 64 envs: a one-process learner
        from the same seed redoes each iteration from the ranks' records —
        the GAE of both rollouts side by side, each minibatch update on the
        global minibatch the two ranks' minibatches make (`global_update`)
        — and reaches their parameters, learning rate and metrics within
        TWO_SHARD_TOL. The advantage moments and the info
        metrics are also held against the JAX package's `jnp.mean`,
        `jnp.std` and metric code on the concatenated tensors. The shards'
        episode counts differ, and a rank's own moments or a mean of the
        ranks' episode means would miss by ten times the tolerance."""
        import jax.numpy as jnp
        from wheeledlab_tpu.rl import ppo as jax_ppo
        from wheeledlab_torch.rl.ppo import (
            info_increments, init_info_acc, make_learner,
        )
        from wheeledlab_torch.tasks import make_env

        ranks = [jobs["a"][r][policy] for r in range(2)]
        env = make_env("MushrDriftRL-v0", num_envs=GLOBAL_ENVS,
                       overrides=ENV_OVERRIDES, device="cpu", seed=SEED)
        ref = make_learner(env, ppo_cfg(policy), seed=SEED)
        assert torch.equal(flat_params(ref), ranks[0]["params0"])
        assert torch.equal(ranks[0]["params0"], ranks[1]["params0"])
        uneven = 0          # iterations whose shards saw different counts
        for it, (a, b) in enumerate(zip(*(r["rec"] for r in ranks))):
            # the advantages' normalization: the global moments
            gae_in = [torch.cat(pair, 1 if pair[0].ndim == 2 else 0)
                      for pair in zip(a["gae_in"], b["gae_in"])]
            with torch.no_grad():
                adv, _, norm_adv = ref.compute_gae(*gae_in)
            assert torch.equal(torch.cat([a["moments"][0], b["moments"][0]],
                                         1), adv)
            mean, std = a["moments"][1:]
            assert torch.equal(mean, b["moments"][1])
            assert torch.equal(std, b["moments"][2])
            x = jnp.asarray(adv.numpy())
            for want in ((adv.mean(), adv.std(correction=0)),
                         (jnp.mean(x), jnp.std(x))):
                np.testing.assert_allclose(
                    [float(mean), float(std)], [float(w) for w in want],
                    **MOMENT_TOL)
            got_norm = torch.cat([a["norm_adv"], b["norm_adv"]], 1)
            np.testing.assert_allclose(got_norm, norm_adv, **MOMENT_TOL)
            own = torch.cat([(r["moments"][0] - r["moments"][0].mean())
                             / (r["moments"][0].std(correction=0) + 1e-8)
                             for r in (a, b)], 1)
            assert not np.allclose(own, norm_adv, **wide(MOMENT_TOL))

            # the update: the two ranks' minibatches joined
            rows = torch.stack([global_update(ref, p, q, policy)
                                for p, q in zip(a["batches"], b["batches"])])
            assert rows.shape[0] == 4
            # the KL that set each minibatch's learning rate is the global
            # one on both ranks (the other columns are the rank's own)
            kl = [torch.stack(r["rows"])[:, 4] for r in (a, b)]
            assert torch.equal(kl[0], kl[1])
            np.testing.assert_allclose(kl[0], rows[:, 4], **TWO_SHARD_TOL)
            np.testing.assert_allclose(flat_params(ref),
                                       ranks[0]["params"][it],
                                       **TWO_SHARD_TOL)
            np.testing.assert_allclose(ref.lr, ranks[0]["lr"][it],
                                       rtol=1e-6)

            # the metrics: sums and counts over the global batch
            (traj_a, _, acc_a), (traj_b, _, acc_b) = (
                a["metrics_in"], b["metrics_in"])
            traj = {k: torch.cat([traj_a[k], traj_b[k]], 1) for k in traj_a}
            acc = jacc = None
            for (info_a, done_a), (info_b, done_b) in zip(a["steps"],
                                                          b["steps"]):
                info = {k: torch.cat([info_a[k], info_b[k]]) for k in info_a}
                done = torch.cat([done_a, done_b])
                acc = acc or init_info_acc(info)
                acc = {k: acc[k] + v for k, v in
                       info_increments(acc, info, done).items()}
                jacc = jax_ppo.accumulate_info(
                    jacc or {k: jnp.zeros(()) for k in acc},
                    {k: jnp.asarray(v.numpy()) for k, v in info.items()},
                    jnp.asarray(done.numpy()))
            want = ref.iteration_metrics(traj, rows.mean(0), acc)
            got = ranks[0]["metrics"][it]
            assert got == ranks[1]["metrics"][it]
            assert got.keys() == want.keys()
            for k in want:
                np.testing.assert_allclose(got[k], float(want[k]),
                                           err_msg=k, **TWO_SHARD_TOL)
            num_dones = jnp.sum(jnp.asarray(traj["done"].numpy()))
            jax_want = jax_ppo.finalize_info_acc(
                jacc, 8, jnp.maximum(num_dones, 1.0))
            for k in jax_want:
                np.testing.assert_allclose(got[k], float(jax_want[k]),
                                           err_msg=k, **TWO_SHARD_TOL)
            dones = [float(t["done"].sum()) for t in (traj_a, traj_b)]
            assert got["episode/num_dones"] == float(num_dones) == sum(dones)
            assert min(dones) > 0
            if dones[0] != dones[1]:
                uneven += 1
                ranks_mean = np.mean([float(acc_r["episode_return"]) / d
                                      for acc_r, d in zip((acc_a, acc_b),
                                                          dones)])
                assert not np.allclose(ranks_mean, got["episode/return"],
                                       **wide(TWO_SHARD_TOL))
        assert uneven

    @pytest.mark.parametrize("policy", ["mlp", "rnn"])
    def test_reduction_matches_one_process(self, jobs, policy):
        """(c) with both ranks on the same seeds the 2-rank run is the
        one-process run of their shard, within SAME_SEED_TOL; the episode
        count is a count over the global batch, twice the shard's."""
        two = [r[policy] for r in jobs["b"]]
        one = learner_run(World(), policy, same_seed=True,
                          num_envs=GLOBAL_ENVS // 2)
        for it in range(2):
            assert torch.equal(two[0]["params"][it], two[1]["params"][it])
            np.testing.assert_allclose(
                two[0]["params"][it].numpy(), one["params"][it].numpy(),
                **SAME_SEED_TOL)
            np.testing.assert_allclose(two[0]["lr"][it].numpy(),
                                       one["lr"][it].numpy(), rtol=1e-6)
            m2, m1 = two[0]["metrics"][it], one["metrics"][it]
            assert m2.keys() == m1.keys()
            assert m1["episode/num_dones"] > 0
            assert m2["episode/num_dones"] == 2 * m1.pop("episode/num_dones")
            for k in m1:
                np.testing.assert_allclose(m2[k], m1[k], err_msg=k,
                                           **SAME_SEED_TOL)

    def test_kernel_rng_seed_offset(self, jobs):
        """(d) equal generators, distinct K4 streams: rank r hands the
        kernel the drawn seed plus r * 0x3779B1 (int32 wrap)."""
        k0, k1 = jobs["a"][0]["krng"], jobs["a"][1]["krng"]
        assert k0["drawn"] == k1["drawn"]
        assert k0["used"] == k0["drawn"]
        wrapped = (k1["drawn"] + SHARD_SEED_STRIDE + 2**31) % 2**32 - 2**31
        assert k1["used"] == wrapped
        assert not torch.equal(k0["obs"], k1["obs"])

    def test_io_checkpoints_and_resume(self, jobs):
        """(e) process 0 alone writes metrics and stdout, every rank its
        checkpoint; a second job resumes each rank's shard bit for bit and
        continues from iteration 2 to 3 as a straight run does."""
        a0, a1 = (r["train"] for r in jobs["a"])
        assert a0["run"] == a1["run"] and a0["run"].startswith("run-")
        run_dir = jobs["dir"] / "pod_logs" / a0["run"]
        with open(run_dir / "metrics.jsonl") as f:
            rows = [json.loads(line) for line in f]
        assert [r["iteration"] for r in rows] == [1, 2]
        assert "it     1 |" in jobs["a_stdout"][0]
        assert "it     1 |" not in jobs["a_stdout"][1]
        assert sorted(os.listdir(run_dir / "checkpoints")) == [
            "1.pt", "1.rank1.pt", "2.pt", "2.rank1.pt"]
        assert checkpoint_steps(str(run_dir)) == [1, 2]
        assert a0["last"] == a1["last"]
        assert not torch.equal(a0["obs"], a1["obs"])

        for a, b in zip((a0, a1), (r["resume"] for r in jobs["b"])):
            assert b["restored_iteration"] == 2
            assert_states_equal(b["env_state"], a["env_state"])
            assert torch.equal(b["obs"], a["obs"])
            assert b["iteration"] == 3
            assert b["last"] == a["straight"]
        with open(jobs["dir"] / "pod_logs" / "resumed" / "metrics.jsonl") as f:
            assert [json.loads(line)["iteration"] for line in f] == [3]


class TestOneProcess:
    def test_pod_on_equals_off(self, tmp_path):
        """POD_DRIFT_CONFIG in one process: "on" joins no job (a world of
        one, unsharded) and gives the bits of "off" (the JAX package asks
        the same of its harness, tests/test_pod_harness.py:43-75)."""
        base = RUN_CONFIGS.get("POD_DRIFT_CONFIG")
        assert base.num_envs == 65536 and base.train.distributed == "on"

        def run(mode):
            cfg = apply_overrides(base, {
                **TINY, "train.num_iterations": 2,
                "train.log.logs_dir": str(tmp_path),
                "train.log.run_name": mode, "train.distributed": mode})
            state, last = train(cfg, verbose=False)
            assert state.iteration == 2 and state.obs.shape[0] == GLOBAL_ENVS
            return {k: v for k, v in last.items()
                    if not k.startswith(("time/", "perf/"))}

        on, off = run("on"), run("off")
        assert on == off
        assert all(np.isfinite(v) for v in on.values())
        assert not torch.distributed.is_initialized()

    @pytest.mark.parametrize("full_ppo", [False, True])
    def test_scale_bench_row(self, capsys, full_ppo):
        from wheeledlab_torch.scripts import scale_bench

        row = scale_bench.main(["--device", "cpu", "--envs-per-device", "8",
                                "--rollout", "4", "--min-wall", "0.05"]
                               + ["--full-ppo"] * full_ppo)
        assert json.loads(capsys.readouterr().out.splitlines()[-1]) == row
        assert (row["world_size"], row["hosts"], row["num_envs"]) == (1, 1, 8)
        assert row["mode"] == ("full_ppo" if full_ppo else "rollout")
        assert row["timed_iters"] >= 4 and row["wall_s"] >= 0.05
        assert row["aggregate_env_steps_per_s"] == pytest.approx(
            8 * 4 * row["timed_iters"] / row["wall_s"])
        assert row["per_rank_env_steps_per_s"] == \
            row["aggregate_env_steps_per_s"]
        assert row["device"] == "cpu"

    def test_shard_arithmetic(self):
        assert local_num_envs(65536, 2) == 32768
        with pytest.raises(ValueError, match="not divisible"):
            local_num_envs(64, 3)
        assert shard_seed(5, 0) == 5
        assert shard_seed(5, 2) == 5 + 2 * 0x3779B1
        assert int32_shard_offset(1) == 0x3779B1
        # the int32 product of the reference wraps
        assert int32_shard_offset(600) == int(
            np.array(600 * 0x3779B1).astype(np.int32))

    def test_world_size_mismatch_raises(self, tmp_path):
        from wheeledlab_torch.rl.runner import restore_checkpoint, setup

        cfg = apply_overrides(RUN_CONFIGS.get("RSS_DRIFT_CONFIG"), {
            **TINY, "num_envs": 16, "train.num_iterations": 1,
            "train.log.logs_dir": str(tmp_path),
            "train.log.run_name": "one"})
        train(cfg, verbose=False)
        _, _, learner = setup(cfg)
        with pytest.raises(ValueError, match="world of 1 ranks and this "
                                             "job has 2"):
            restore_checkpoint(str(tmp_path / "one"), 0, learner,
                               World(rank=0, size=2))

    def test_env_of_another_shard_raises(self):
        """An env built for rank 1 (its K4 stream offset) is refused by a
        process of rank 0."""
        from wheeledlab_torch.rl.runner import setup
        from wheeledlab_torch.tasks import make_env

        cfg = apply_overrides(RUN_CONFIGS.get("RSS_DRIFT_CONFIG"),
                              {"num_envs": 8, "device": "cpu"})
        env = make_env("MushrDriftRL-v0", num_envs=8, device="cpu", shard=1)
        with pytest.raises(ValueError, match="shard 1 .* rank 0"):
            setup(cfg, env)
        assert setup(cfg, make_env("MushrDriftRL-v0", num_envs=8,
                                   device="cpu"))[1].shard == 0

    def test_resolve_world(self, monkeypatch):
        from wheeledlab_torch.rl.runner import _resolve_world

        cfg = RUN_CONFIGS.get("RSS_DRIFT_CONFIG").replace(device="cpu")
        mode = lambda m: cfg.replace(train=cfg.train.replace(distributed=m))
        for var in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "LOCAL_RANK"):
            monkeypatch.delenv(var, raising=False)
        for m in ("auto", "on", "off"):
            assert _resolve_world(mode(m)) == World()
        assert not torch.distributed.is_initialized()
        with pytest.raises(ValueError, match="auto|on|off"):
            _resolve_world(mode("yes"))
        # torchrun's variables of a 2-process job: "off" still never joins
        monkeypatch.setenv("WORLD_SIZE", "2")
        assert _resolve_world(mode("off")) == World()


if __name__ == "__main__":
    sys.exit(pytest.main([__file__, "-x", "-q"]))
