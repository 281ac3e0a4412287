"""Play CLI — the port of `wheeledlab_tpu/cli/play.py` (reference
play_policy.py): load a trained run, roll its deterministic policy in the
task's play variant, dump the rollouts and the task-success metrics.

    python -m wheeledlab_torch.cli.play --run <run_name> [--checkpoint N]
        [--steps 500] [--num-envs 16] [--device cuda]

Writes <run>/play/<run>-rollouts.npz (observations, actions, positions,
yaws, rewards, commands, stacked over steps) and <run>/play/
play_metrics.json, with the reference's keys; with `--video` also a top-down
video <run>/play/<run>.avi (or .mp4 / .npy, by the encoder installed) and,
for camera tasks, env 0's policy-view clip <run>/play/<run>-policyview.avi.
Runs on CUDA unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="WheeledLab policy playback "
                                            "(PyTorch/CUDA port)")
    p.add_argument("--run", required=True, help="run name under --logs-dir")
    p.add_argument("--logs-dir", default="logs")
    p.add_argument("--checkpoint", type=int, default=0, help="0 = latest")
    p.add_argument("--steps", type=int, default=500)
    p.add_argument("--num-envs", type=int, default=16)
    p.add_argument("--video", action="store_true",
                   help="render a top-down video of the rollouts and, "
                        "for camera tasks, the policy-view clip")
    p.add_argument("--headless", action="store_true", help="compat no-op")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda)")
    return p


def play_metrics(pos, yaw, rew, cmd, done, step_dt: float,
                 goal_task: bool) -> dict:
    """Task-success metrics over the played steps (numpy, (T, B, ...)
    arrays), as the reference computes them."""
    vel = np.diff(pos[..., :2], axis=0) / step_dt             # (T-1, B, 2)
    speed = np.linalg.norm(vel, axis=-1)
    # positions are recorded post-reset: the t -> t+1 difference is a
    # respawn teleport whenever step t+1 ended an episode
    valid = ~done[1:].astype(bool)
    out = {"reward_mean": float(rew.mean()),
           "speed_mean": float(speed[valid].mean())}
    moving = (speed > 0.5) & valid
    if moving.any():
        # body slip angle: motion direction vs heading (drift tasks)
        slip = np.arctan2(vel[..., 1], vel[..., 0]) - yaw[:-1]
        slip = np.degrees(np.abs((slip + np.pi) % (2 * np.pi) - np.pi))
        out["slip_deg_mean"] = float(slip[moving].mean())
    if goal_task:
        # fraction of envs within the at_goal radius (0.5 m) at any point
        d = np.linalg.norm(pos[..., :2] - cmd[..., :2], axis=-1)
        out["goal_reach_frac"] = float((d.min(axis=0) < 0.5).mean())
        out["goal_dist_final"] = float(d[-1].mean())
    return out


def main(argv=None):
    args = build_parser().parse_args(sys.argv[1:] if argv is None else argv)
    import torch

    from ..rl.ppo import PPOCfg, make_learner
    from ..rl.runner import checkpoint_steps
    from ..tasks import make_env
    from ..utils import math as wmath
    from ..utils.device import resolve_device

    device = resolve_device(args.device)
    run_dir = os.path.join(args.logs_dir, args.run)
    with open(os.path.join(run_dir, "run_config.json")) as f:
        saved = json.load(f)["run"]
    agent_cfg = PPOCfg(**{k: (tuple(v) if isinstance(v, list) else v)
                          for k, v in saved["agent"].items()})
    recurrent = agent_cfg.policy_class == "ActorCriticRecurrent"

    # the play variant; the run's env overrides are applied again so that
    # playback matches training
    env = make_env(saved["task_name"], num_envs=args.num_envs, play=True,
                   overrides=saved.get("env_overrides") or None,
                   device=device, seed=args.num_envs)
    step = args.checkpoint or checkpoint_steps(run_dir)[-1]
    ck = torch.load(os.path.join(run_dir, "checkpoints", f"{step}.pt"),
                    map_location=device, weights_only=True)
    # the run's policy class, compute dtype and apply (fused or not)
    learner = make_learner(env, agent_cfg)
    model = learner.model
    model.load_state_dict(ck["learner"]["model"])

    state, obs = env.reset()
    hidden = model.initial_hidden(args.num_envs, device) if recurrent \
        else None
    reset_prev = torch.zeros(args.num_envs, device=device)
    traj = {k: [] for k in ("observations", "actions", "positions", "yaws",
                            "rewards", "commands", "done", "quats")}
    with torch.no_grad():
        for _ in range(args.steps):
            # the deterministic policy; a recurrent one's carry is reset
            # where the previous step ended an episode
            if recurrent:
                hidden, mean, _, _ = model.step(hidden, obs, reset_prev)
            else:
                mean, _, _ = learner.policy_apply(obs)
            state, out = env.step(state, mean)
            v = state.vehicle
            for k, x in (("observations", obs), ("actions", mean),
                         ("positions", v.pos),
                         ("yaws", wmath.yaw_from_quat(v.quat)),
                         ("rewards", out.reward), ("commands", state.command),
                         ("done", out.done), ("quats", v.quat)):
                traj[k].append(x)
            obs, reset_prev = out.obs, out.done.to(torch.float32)
    # one device->host copy per channel, after the rollout
    traj = {k: torch.stack(x).cpu().numpy() for k, x in traj.items()}

    play_dir = os.path.join(run_dir, "play")
    os.makedirs(play_dir, exist_ok=True)
    out_path = os.path.join(play_dir, f"{args.run}-rollouts.npz")
    np.savez_compressed(out_path, **{k: v for k, v in traj.items()
                                     if k not in ("done", "quats")})
    print(f"saved rollouts to {out_path}  (obs "
          f"{traj['observations'].shape}, mean reward "
          f"{traj['rewards'].mean():.3f})")
    metrics = play_metrics(traj["positions"], traj["yaws"], traj["rewards"],
                           traj["commands"], traj["done"], env.cfg.step_dt,
                           env.task.command is not None)
    with open(os.path.join(play_dir, "play_metrics.json"), "w") as f:
        json.dump(metrics, f, indent=2)
    print("play metrics:", json.dumps(metrics))

    if args.video:
        from ..render.topdown import render_task_frames, save_video

        frames = render_task_frames(
            env, saved["task_name"], traj["positions"][:, :, :2],
            traj["yaws"], goals=traj["commands"][:, :, :2])
        vid = save_video(frames, os.path.join(play_dir, f"{args.run}.avi"))
        print(f"saved video to {vid}")
        if env.task.colormap is not None:
            from ..rl.runner import policy_view_video

            vid = policy_view_video(
                env, torch.from_numpy(traj["positions"][:, 0]).to(device),
                torch.from_numpy(traj["quats"][:, 0]).to(device),
                os.path.join(play_dir, f"{args.run}-policyview.avi"))
            print(f"saved policy-view video to {vid}")
    return metrics


if __name__ == "__main__":
    main()
