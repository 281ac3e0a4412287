"""One rank of the gloo jobs of tests/test_torch_tensor_parallel.py.

    python _torch_tensor_parallel_worker.py <port> <nproc> <rank> <dir> m<m>

Joins a `torch.distributed` job over gloo on 127.0.0.1 (strict: a failed
rendezvous raises), lays the ranks out as `global_mesh(m)`, loads the
policy parameters and the batch the parent wrote to `<dir>/inputs.pt`,
builds this rank's share of the policy (`TensorParallelActorCritic`), runs
it on its data index's rows of the batch, takes one PPO loss and its
gradients (averaged over the data group), and saves what the parent
compares to `<dir>/m<m>-rank<rank>.pt`.
"""

import os
import sys

import torch


def main():
    torch.set_num_threads(1)
    port, nproc, rank = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    out_dir, job = sys.argv[4], sys.argv[5]
    m = int(job.removeprefix("m"))

    from wheeledlab_torch.convert import actor_critic_from_jax
    from wheeledlab_torch.parallel import distributed
    from wheeledlab_torch.parallel.tensor_parallel import (
        TensorParallelActorCritic,
    )
    from wheeledlab_torch.rl.ppo import all_reduce_grads, make_learner
    from wheeledlab_torch.tasks import make_env

    distributed.initialize(backend="gloo",
                           init_method=f"tcp://127.0.0.1:{port}",
                           world_size=nproc, rank=rank, device="cpu",
                           timeout_s=120)
    try:
        inputs = torch.load(os.path.join(out_dir, "inputs.pt"),
                            weights_only=False)
        pm = distributed.global_mesh(m)
        tp = TensorParallelActorCritic(
            actor_critic_from_jax(inputs["params"]), pm)
        rows = inputs["obs"].shape[0] // pm.data_size
        mine = slice(pm.data_index * rows, (pm.data_index + 1) * rows)
        batch = [x[mine] for x in inputs["batch"]]

        with torch.no_grad():
            mean, std, value = tp(inputs["obs"][mine])
        # the loss of the learner (its cfg: PPOCfg's defaults)
        learner = make_learner(
            make_env("MushrDriftRL-v0", num_envs=8, device="cpu"),
            inputs["ppo_cfg"])
        total, (_, _, _, kl) = learner.ppo_loss(*tp(inputs["obs"][mine]),
                                                *batch)
        total.backward()
        params = list(tp.parameters())
        kl = kl.detach()
        if pm.data_size > 1:
            kl = all_reduce_grads(params, kl, pm.data_group)
        torch.save({
            "coords": (pm.data_index, pm.model_index),
            "rows": (mine.start, mine.stop),
            "mean": mean, "std": std, "value": value,
            "loss": total.detach(), "kl": kl,
            "placement": tp.placement,
            "grads": {name.replace("/", "."): p.grad
                      for name, p in tp.shards.items()},
        }, os.path.join(out_dir, f"{job}-rank{rank}.pt"))
    finally:
        distributed.shutdown()


if __name__ == "__main__":
    main()
