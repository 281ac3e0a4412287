"""Train-to-return benchmark — the port of `scripts/train_bench.py`: the
machine-checkable form of the reference's claim of "a couple hours to a
transferable policy" (reference README.md:68).

Runs a named run config until `--target-return` is reached at a log point
(or the iteration budget runs out) and prints ONE JSON line:

    {"metric": "<config>_train_to_return_s", "value": <wall s>, "unit": "s",
     "return": <last logged>, "target_return": T, "reached": bool,
     "iterations": N, "env_steps": N, "vs_baseline": <7200 s / wall>,
     "steady_ms_per_iteration": ..., "steady_env_steps_per_s": ...,
     "train_s": ..., "startup_s": ..., "device": "<card, power limit>"}

    python -m wheeledlab_torch.scripts.train_bench --config RSS_DRIFT_CONFIG \
        --target-return 800 --max-iterations 2000 --logs-dir logs

Runs on CUDA unless `--device cpu` is given. The run directory
(metrics.jsonl, run_config.json, checkpoints, result.json) lands under
`--logs-dir`. The steady rate is taken between the first and the last
logged iteration, so the kernels' build and the first iteration stand
apart in `startup_s`.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config", default="RSS_DRIFT_CONFIG")
    p.add_argument("--target-return", type=float, default=800.0)
    p.add_argument("--max-iterations", type=int, default=None,
                   help="iteration budget; defaults to the named config's "
                        "train.num_iterations")
    p.add_argument("--num-envs", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--logs-dir", default="logs")
    p.add_argument("--run-name", default="train_bench")
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--no-checkpoints", action="store_true")
    p.add_argument("--device", default="cuda")
    return p


def main(argv=None) -> dict:
    args = build_parser().parse_args(sys.argv[1:] if argv is None else argv)

    import wheeledlab_torch.rl  # noqa: F401  registers run configs
    from ..rl.runner import train
    from ..utils.config import RUN_CONFIGS
    from ..utils.device import describe, resolve_device

    device = resolve_device(args.device)
    cfg = RUN_CONFIGS.get(args.config)
    cfg = cfg.replace(device=args.device, train=cfg.train.replace(
        seed=args.seed,
        num_iterations=args.max_iterations or cfg.train.num_iterations,
        target_return=args.target_return,
        log=cfg.train.log.replace(
            logs_dir=args.logs_dir, run_name=args.run_name,
            log_every=args.log_every, no_checkpoints=args.no_checkpoints)))
    if args.num_envs:
        cfg = cfg.replace(num_envs=args.num_envs)

    t0 = time.time()
    state, metrics = train(cfg)
    wall = time.time() - t0

    iterations = state.iteration
    steps_per_iter = cfg.agent.num_steps_per_env * cfg.num_envs
    final_return = metrics.get("episode/return", float("nan"))
    result = {
        "metric": f"{args.config.lower()}_train_to_return_s",
        "value": wall,
        "unit": "s",
        "return": final_return,
        "target_return": args.target_return,
        "reached": final_return >= args.target_return,
        "iterations": iterations,
        "env_steps": iterations * steps_per_iter,
        "vs_baseline": 7200.0 / max(wall, 1e-9),  # reference: ~2 h
    }
    run_dir = os.path.join(args.logs_dir, args.run_name)
    mpath = os.path.join(run_dir, "metrics.jsonl")
    if os.path.exists(mpath):
        with open(mpath) as f:
            rows = [json.loads(line) for line in f]
        if len(rows) >= 2:
            d_it = rows[-1]["iteration"] - rows[0]["iteration"]
            d_wall = rows[-1]["perf/wall_s"] - rows[0]["perf/wall_s"]
            if d_it > 0 and d_wall > 0:
                result["steady_ms_per_iteration"] = d_wall / d_it * 1e3
                result["steady_env_steps_per_s"] = steps_per_iter * d_it / d_wall
                result["train_s"] = rows[-1]["iteration"] * d_wall / d_it
                result["startup_s"] = wall - result["train_s"]
    result["device"] = describe(device)
    print(json.dumps(result), flush=True)
    if os.path.isdir(run_dir):
        with open(os.path.join(run_dir, "result.json"), "w") as f:
            json.dump(result, f)
    return result


if __name__ == "__main__":
    main()
