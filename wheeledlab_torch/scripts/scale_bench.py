"""Weak-scaling benchmark of the drift env and PPO over the ranks of a
`torch.distributed` job — the port of `scripts/scale_bench.py`.

Every rank holds `--envs-per-device` envs on its card (ranks beyond the
host's cards share them) and steps them with zero actions (rollout mode),
or runs the whole PPO iteration with its gradient all-reduce
(`--full-ppo`). Reports the aggregate env-steps/s of the job and the rate
per rank.

    python -m wheeledlab_torch.scripts.scale_bench [--full-ppo]
    torchrun --nproc_per_node N -m wheeledlab_torch.scripts.scale_bench

Timing as `measure` of the reference: two chained warm-up calls, then a
window of at least 4 calls and at least `--min-wall` seconds, the clock
stopped by a host read of a value that depends on every call. The window
ends on the slowest rank (its wall is all-reduced as a max), so every rank
times the same number of calls. Process 0 prints one JSON line, with the
card's name and power limit. Runs on CUDA unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

MIN_ITERS = 4
MAX_ITERS = 8192


def measure(fn, state, steps_per_iter: int, min_wall: float, wall_max):
    """(steps/s, wall, calls) of a window of chained `fn` calls; `wall_max`
    reduces a rank's wall to the job's."""
    iters = 1
    while True:
        t0 = time.perf_counter()
        s = state
        for _ in range(iters):
            s, r = fn(s)
        anchor = float(r)          # waits for every call of the window
        if not math.isfinite(anchor):
            raise RuntimeError("non-finite result in the scaling bench")
        wall = wall_max(time.perf_counter() - t0)
        if (wall >= min_wall and iters >= MIN_ITERS) or iters >= MAX_ITERS:
            return steps_per_iter * iters / wall, wall, iters
        grow = max(2.0, min_wall * 1.25 / max(wall, 1e-9))
        iters = min(MAX_ITERS, max(MIN_ITERS, int(math.ceil(iters * grow))))


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--task", default="MushrDriftRL-v0")
    p.add_argument("--envs-per-device", type=int, default=2048)
    p.add_argument("--rollout", type=int, default=32)
    p.add_argument("--min-wall", type=float, default=1.0)
    p.add_argument("--full-ppo", action="store_true",
                   help="time the whole train iteration, not the rollout")
    p.add_argument("--fuse-input-layer", action="store_true",
                   help="fused actor+critic first-layer product "
                        "(PPOCfg.fuse_input_layer); needs --full-ppo")
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default=None, help="also write the JSON line here")
    return p


def main(argv=None):
    parser = build_parser()
    args = parser.parse_args(sys.argv[1:] if argv is None else argv)
    if args.fuse_input_layer and not args.full_ppo:
        parser.error("--fuse-input-layer only affects the PPO update; "
                     "pass --full-ppo with it")
    import torch

    from ..parallel import distributed
    from ..parallel.mesh import shard_seed
    from ..rl.ppo import PPOCfg, make_learner
    from ..tasks import make_env
    from ..utils.device import describe, resolve_device

    device = resolve_device(args.device)
    distributed.initialize(device=device)
    try:
        world = distributed.world()
        if world.size > 1 and device.type == "cuda":
            device = distributed.local_device()
        env = make_env(args.task, num_envs=args.envs_per_device,
                       device=device, seed=shard_seed(0, world.rank),
                       shard=world.rank)

        if args.full_ppo:
            learner = make_learner(
                env, PPOCfg(num_steps_per_env=args.rollout,
                            fuse_input_layer=args.fuse_input_layer),
                seed=0, world=world)
            state = learner.init_state()

            def fn(s):
                s, m = learner.train_iteration(s)
                return s, m["loss/total"]
        else:
            state, _ = env.reset()
            action = torch.zeros((env.num_envs, env.action_dim),
                                 device=device)

            def fn(s):
                total = torch.zeros((), device=device)
                for _ in range(args.rollout):
                    s, out = env.step(s, action)
                    total = total + out.reward.sum()
                return s, total

        def wall_max(wall):
            if world.size == 1:
                return wall
            t = torch.tensor(wall, dtype=torch.float64, device=device)
            return float(distributed.all_reduce_max_(t))

        s, r = fn(state)
        float(r)
        s, r = fn(s)
        float(r)
        num_envs = world.size * args.envs_per_device
        rate, wall, iters = measure(fn, s, num_envs * args.rollout,
                                    args.min_wall, wall_max)
        row = None
        if world.rank == 0:
            local = int(os.environ.get("LOCAL_WORLD_SIZE", world.size))
            row = {
                "task": args.task,
                "world_size": world.size,
                "hosts": max(world.size // max(local, 1), 1),
                "num_envs": num_envs,
                "envs_per_device": args.envs_per_device,
                "mode": "full_ppo" if args.full_ppo else "rollout",
                "fuse_input_layer": args.fuse_input_layer,
                "rollout": args.rollout,
                "device": describe(device),
                "aggregate_env_steps_per_s": rate,
                "per_rank_env_steps_per_s": rate / world.size,
                "wall_s": wall,
                "timed_iters": iters,
            }
            line = json.dumps(row)
            print(line, flush=True)
            if args.out:
                os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
                with open(args.out, "w") as f:
                    f.write(line + "\n")
        return row
    finally:
        distributed.shutdown()


if __name__ == "__main__":
    main()
