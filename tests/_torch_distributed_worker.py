"""One rank of the 2-process gloo jobs of tests/test_torch_distributed.py.

    python _torch_distributed_worker.py <port> <nproc> <rank> <out_dir> <job>

Joins a `torch.distributed` job over gloo on 127.0.0.1 (strict: a failed
rendezvous raises), runs the job's checks on the CPU and saves what the
parent test compares to `<out_dir>/<job>-rank<rank>.pt`:

- job "a": the MLP and the recurrent learner (hidden 16) at 64 envs
  globally, 8 steps, 2 epochs x 2 minibatches, 2 iterations, each rank on
  its own shard seed (`learner_run`); one K4 step of each rank from equal
  generators (`krng_step`); `train()` of POD_DRIFT_CONFIG cut to 64 envs for
  2 iterations with checkpoints, then a straight 3-iteration run beside it
  (`train_runs`).
- job "b": the two learners with both ranks built on the same seeds
  through the learner's arguments (the parent holds them against a
  one-process run of 32 envs); the resume of job "a"'s run from iteration 2
  to 3 (`resume_run`).
"""

import os
import sys

import torch

SEED = 0
GLOBAL_ENVS = 64
# short episodes from wider spawns: within 8 steps episodes time out and
# some cars leave the track, in numbers that differ from shard to shard
ENV_OVERRIDES = {"episode_length_s": 0.12, "pos_noise": 1.0}
TINY = {"num_envs": GLOBAL_ENVS, "agent.num_steps_per_env": 8,
        "agent.num_learning_epochs": 2, "agent.num_mini_batches": 2,
        "train.log.log_every": 1, "train.log.checkpoint_every": 1,
        "device": "cpu"}


def ppo_cfg(policy):
    from wheeledlab_torch.rl.ppo import PPOCfg

    cfg = PPOCfg(num_steps_per_env=8, num_learning_epochs=2,
                 num_mini_batches=2)
    if policy == "rnn":
        cfg = cfg.replace(policy_class="ActorCriticRecurrent",
                          rnn_hidden_size=16)
    return cfg


def flat_params(learner):
    return torch.cat([p.detach().reshape(-1).clone()
                      for p in learner.model.parameters()])


def record(learner, rec):
    """Spy on `learner` and append, per iteration, what a one-process
    learner needs to redo the iteration's reductions over the global batch:
    each env step's info and done, the GAE inputs and the advantages with
    the moments `global_moments` returned, every minibatch in order with
    the row `minibatch_update` returned, the rollout columns the metrics
    read, the rank's own loss metrics and info accumulators."""
    from wheeledlab_torch.rl import ppo

    env_step, gae = learner.env.step, learner.compute_gae
    update, finish = learner.minibatch_update, learner.iteration_metrics
    moments = ppo.global_moments

    def step(state, action):
        if not rec or "metrics_in" in rec[-1]:
            rec.append({"steps": [], "batches": [], "rows": []})
        state, out = env_step(state, action)
        rec[-1]["steps"].append(({k: v.clone() for k, v in out.info.items()},
                                 out.done.clone()))
        return state, out

    def compute_gae(reward, value, done, last_value):
        # copies: the trajectory is the rollout step's own, overwritten by
        # the next rollout
        rec[-1]["gae_in"] = tuple(x.clone() for x in (reward, value, done,
                                                      last_value))
        res = gae(reward, value, done, last_value)
        rec[-1]["norm_adv"] = res[2]
        return res

    def global_moments(x, world_size):
        mean, std = moments(x, world_size)
        rec[-1]["moments"] = (x.clone(), mean.clone(), std.clone())
        return mean, std

    def minibatch_update(batch):
        rec[-1]["batches"].append(batch)
        row = update(batch)
        rec[-1]["rows"].append(row)
        return row

    def iteration_metrics(traj, loss_metrics, acc):
        rec[-1]["metrics_in"] = (
            {k: traj[k].clone() for k in ("reward", "done", "action")},
            loss_metrics.clone(), dict(acc))
        return finish(traj, loss_metrics, acc)

    learner.env.step, learner.compute_gae = step, compute_gae
    learner.minibatch_update = minibatch_update
    learner.iteration_metrics = iteration_metrics
    ppo.global_moments = global_moments
    return moments


def learner_run(world, policy, same_seed=False, num_envs=GLOBAL_ENVS,
                spy=False):
    """2 iterations of this rank's learner on its share of `num_envs`.
    With `same_seed` every rank's env and learner generator take `SEED`
    (through `make_env` and `make_learner(shard_seed=)`), else the rank's
    shard seed. Returns the initial vehicle rows and, per iteration, the
    scalar metrics, the flat parameters and the learning rate; with `spy`
    also the initial parameters and `record`'s record of each iteration."""
    from wheeledlab_torch.parallel.mesh import local_num_envs, shard_seed
    from wheeledlab_torch.rl import ppo
    from wheeledlab_torch.tasks import make_env

    seed = SEED if same_seed else shard_seed(SEED, world.rank)
    env = make_env("MushrDriftRL-v0",
                   num_envs=local_num_envs(num_envs, world.size),
                   overrides=ENV_OVERRIDES, device="cpu", seed=seed,
                   shard=world.rank)
    learner = ppo.make_learner(env, ppo_cfg(policy), seed=SEED, world=world,
                               shard_seed=SEED if same_seed else None)
    state = learner.init_state()
    out = {"init_mem": state.env_state.vehicle_mem.clone()}
    if spy:
        out["params0"], out["rec"] = flat_params(learner), []
        moments = record(learner, out["rec"])
    try:
        out.update(iterations(learner, state))
    finally:
        if spy:
            ppo.global_moments = moments
    return out


def iterations(learner, state):
    out = {"metrics": [], "params": [], "lr": []}
    for _ in range(2):
        state, metrics = learner.train_iteration(state)
        out["metrics"].append({k: float(v) for k, v in metrics.items()})
        out["params"].append(flat_params(learner))
        out["lr"].append(learner.lr.detach().clone())
    return out


def krng_step(rank, n=8):
    """One drift step on the K4 route (its plain version here) from a reset
    of an env seeded with `SEED` on every rank: the seed drawn from the
    env's generator, the seed the step handed to the kernel's wrapper, and
    the observation."""
    from wheeledlab_torch.tasks import make_env
    from wheeledlab_torch.tasks.drift import fused

    os.environ["WHEELEDLAB_KERNEL_RNG"] = "1"   # read when the env is built
    try:
        env = make_env("MushrDriftRL-v0", num_envs=n, device="cpu",
                       seed=SEED, shard=rank)
    finally:
        del os.environ["WHEELEDLAB_KERNEL_RNG"]
    state, _ = env.reset()
    before = env.generator.get_state()
    drawn = torch.randint(0, 2**31 - 1, (1,), dtype=torch.int32,
                          generator=env.generator)
    env.generator.set_state(before)
    used, wrapped = [], fused.fused_drift_step_krng

    def spy(*args, **kw):
        used.append(args[5].clone())          # the (1,) int32 seed
        return wrapped(*args, **kw)

    fused.fused_drift_step_krng = spy
    try:
        _, out = env.step(state, torch.zeros(n, 2))
    finally:
        fused.fused_drift_step_krng = wrapped
    return {"drawn": int(drawn), "used": int(used[0]), "obs": out.obs}


def pod_cfg(logs, **extra):
    import wheeledlab_torch.rl  # noqa: F401  registers run configs
    from wheeledlab_torch.utils.config import RUN_CONFIGS, apply_overrides

    return apply_overrides(RUN_CONFIGS.get("POD_DRIFT_CONFIG"), {
        **TINY, "train.log.logs_dir": logs, **extra})


def public(metrics):
    """The metrics that do not depend on the clock."""
    return {k: v for k, v in metrics.items()
            if not k.startswith(("time/", "perf/"))}


def train_runs(out_dir):
    """`train()` of the cut POD config for 2 iterations under the run name
    process 0 broadcasts, then a straight 3-iteration run without
    checkpoints. Returns the run directory's name, this rank's state after
    iteration 2 and the straight run's last metrics."""
    from wheeledlab_torch.rl.runner import train

    logs = os.path.join(out_dir, "pod_logs")
    state, last = train(pod_cfg(logs, **{"train.num_iterations": 2}))
    (run,) = os.listdir(logs)
    straight_logs = os.path.join(out_dir, "straight_logs")
    _, straight = train(pod_cfg(straight_logs, **{
        "train.num_iterations": 3, "train.log.no_checkpoints": True,
        "train.log.run_name": "straight"}), verbose=False)
    return {"run": run, "iteration": state.iteration, "last": public(last),
            "env_state": {k: v for k, v in vars(state.env_state).items()},
            "obs": state.obs, "straight": public(straight)}


def resume_run(out_dir, run):
    """This rank's shard as `restore_checkpoint` rebuilds it from job a's
    iteration 2, then `train()` resumed from there to iteration 3."""
    from wheeledlab_torch.rl.runner import restore_checkpoint, setup, train

    logs = os.path.join(out_dir, "pod_logs")
    cfg = pod_cfg(logs, **{"train.num_iterations": 3,
                           "train.log.run_name": "resumed",
                           "train.load_run": run})
    world, _, learner = setup(cfg)
    restored = restore_checkpoint(os.path.join(logs, run), 2, learner, world)
    state, last = train(cfg)
    return {"restored_iteration": restored.iteration,
            "env_state": dict(vars(restored.env_state)),
            "obs": restored.obs, "iteration": state.iteration,
            "last": public(last)}


def main():
    torch.set_num_threads(1)
    port, nproc, rank = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    out_dir, job = sys.argv[4], sys.argv[5]

    from wheeledlab_torch.parallel import distributed

    distributed.initialize(backend="gloo",
                           init_method=f"tcp://127.0.0.1:{port}",
                           world_size=nproc, rank=rank, device="cpu",
                           timeout_s=120)
    try:
        world = distributed.world()
        assert (world.rank, world.size) == (rank, nproc), world
        assert distributed.is_main_process() == (rank == 0)
        assert distributed.local_batch_slice(GLOBAL_ENVS) == slice(
            rank * GLOBAL_ENVS // nproc, (rank + 1) * GLOBAL_ENVS // nproc)
        if job == "a":
            res = {"mlp": learner_run(world, "mlp", spy=True),
                   "rnn": learner_run(world, "rnn", spy=True),
                   "krng": krng_step(rank), "train": train_runs(out_dir)}
        else:
            import json

            with open(os.path.join(out_dir, "run.json")) as f:
                run = json.load(f)["run"]
            res = {"mlp": learner_run(world, "mlp", same_seed=True),
                   "rnn": learner_run(world, "rnn", same_seed=True),
                   "resume": resume_run(out_dir, run)}
        torch.save(res, os.path.join(out_dir, f"{job}-rank{rank}.pt"))
    finally:
        distributed.shutdown()


if __name__ == "__main__":
    main()
