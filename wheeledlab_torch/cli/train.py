"""Train CLI — the port of `wheeledlab_tpu/cli/train.py` (reference
train_rl.py):

    python -m wheeledlab_torch.cli.train -r RSS_DRIFT_CONFIG \
        env.num_envs=2048 agent.learning_rate=5e-4 train.num_iterations=1000

Dotted overrides use the same grammar as the reference's Hydra CLI. Runs on
CUDA unless `--device cpu` is given. `--headless` is accepted for
command-line compatibility. Under torchrun every rank runs the same command
on its shard of the env batch:

    torchrun --nproc_per_node N -m wheeledlab_torch.cli.train -r POD_DRIFT_CONFIG
"""

from __future__ import annotations

import argparse
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="WheeledLab RL training "
                                            "(PyTorch/CUDA port)")
    p.add_argument("-r", "--run-config", default="RSS_DRIFT_CONFIG",
                   help="named run config (RSS_DRIFT_CONFIG, "
                        "F1TENTH_DRIFT_CONFIG, RSS_DRIFT_RNN_CONFIG, "
                        "RSS_ELEV_CONFIG, ELEV_GOAL_CONFIG, "
                        "RSS_VISUAL_CONFIG, POD_DRIFT_CONFIG)")
    p.add_argument("--num-envs", type=int, default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--max-iterations", type=int, default=None)
    p.add_argument("-m", "--multirun", action="store_true",
                   help="treat comma-separated override values as a sweep "
                        "(Hydra multirun parity): a.b=1e-3,5e-4 runs twice")
    p.add_argument("--headless", action="store_true",
                   help="accepted for reference-CLI compatibility (no-op)")
    p.add_argument("--video", action="store_true",
                   help="record top-down training videos every "
                        "train.log.video_interval iterations (reference "
                        "LogConfig.video, common_cfg.py:19-29)")
    p.add_argument("--distributed", action="store_true",
                   help="shard the env batch over the ranks of the "
                        "torch.distributed job (train.distributed=on)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the run config's, cuda)")
    return p


def _sweep_product(overrides):
    """Expand {k: 'v1,v2'} into the cartesian product of single-value
    override dicts (Hydra multirun grammar)."""
    import itertools

    keys = list(overrides)
    value_lists = [str(overrides[k]).split(",") for k in keys]
    for combo in itertools.product(*value_lists):
        yield dict(zip(keys, combo))


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    parser = build_parser()
    args, extra = parser.parse_known_args(argv)

    from ..parallel import distributed
    from ..utils.config import RUN_CONFIGS, parse_cli_overrides
    import wheeledlab_torch.rl  # noqa: F401  registers run configs

    base = RUN_CONFIGS.get(args.run_config)
    overrides = parse_cli_overrides(extra)

    sweeps = list(_sweep_product(overrides)) if args.multirun else [overrides]
    try:
        _run_sweeps(args, base, sweeps)
    finally:
        distributed.shutdown()


def _run_sweeps(args, base, sweeps):
    """Train once per override dict of `sweeps`."""
    from ..rl.runner import train
    from ..utils.config import apply_overrides

    for i, once in enumerate(sweeps):
        # `env.*` routes into the task cfg via RunConfig.env_overrides
        # (applied by make_env, which raises KeyError on unknown fields);
        # `env.num_envs` maps to the top-level batch size; `agent.*`/
        # `train.*`/`num_envs` apply to the RunConfig itself.
        run_ovr, env_ovr = {}, dict(base.env_overrides or {})
        for k, v in once.items():
            if k == "env.num_envs":
                run_ovr["num_envs"] = v
            elif k.startswith("env."):
                env_ovr[k[len("env."):]] = v
            else:
                run_ovr[k] = v
        cfg = apply_overrides(base, run_ovr)
        if env_ovr:
            cfg = cfg.replace(env_overrides=env_ovr)
        if args.num_envs is not None:
            cfg = cfg.replace(num_envs=args.num_envs)
        if args.seed is not None:
            cfg = cfg.replace(train=cfg.train.replace(seed=args.seed))
        if args.max_iterations is not None:
            cfg = cfg.replace(train=cfg.train.replace(
                num_iterations=args.max_iterations))
        if args.video:
            cfg = cfg.replace(train=cfg.train.replace(
                log=cfg.train.log.replace(video=True)))
        if args.distributed:
            cfg = cfg.replace(train=cfg.train.replace(distributed="on"))
        if args.device is not None:
            cfg = cfg.replace(device=args.device)
        if args.multirun and len(sweeps) > 1:
            name = cfg.train.log.run_name or "sweep"
            cfg = cfg.replace(train=cfg.train.replace(
                log=cfg.train.log.replace(run_name=f"{name}-{i}")))
            print(f"--- multirun {i + 1}/{len(sweeps)}: {once}", flush=True)
        train(cfg)


if __name__ == "__main__":
    main()
