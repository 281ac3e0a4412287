"""Export a trained policy for deployment — the port of
`wheeledlab_tpu/cli/export.py` (the sim2real hand-off).

The reference workflow deploys checkpoints to real cars via the RealLab
stack, which consumes rsl_rl `model_<it>.pt` files (save format:
``{'model_state_dict', 'optimizer_state_dict', 'iter', 'infos'}``). This CLI
converts a checkpoint of the port (`<run>/checkpoints/<it>.pt`) into exactly
that format, with state-dict keys matching rsl_rl's ``ActorCritic`` module
(``actor.{0,2,4}.weight/bias``, ``critic.{0,2,4}.weight/bias``, ``std``), and
into a framework-agnostic ``<run>-policy.npz`` (numpy weights plus a JSON
metadata record under ``__meta__``: obs/action dims, hidden sizes,
activation, action scale/offset) for deployment targets without torch.

    python -m wheeledlab_torch.cli.export --run <run_name> [--checkpoint N]
        [--format pt|npz|both] [--out DIR] [--device cuda]

A recurrent run (`ActorCriticRecurrent`) has no rsl_rl deployment layout:
its npz holds the flax parameter tree flattened with "." (flax names and
layouts, kernels (in, out)), and `--format pt` or `both` writes the npz
alone, with a note on stderr, as the JAX export does.

`--device` is where the run's env is built (only its dimensions and action
map are read): CUDA unless `cpu` is asked for.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np


def flatten_actor_critic(state_dict, meta):
    """The port's `ActorCritic.state_dict()` -> flat {name: np.ndarray} with
    rsl_rl naming. The model's `nn.Sequential`s already interleave the
    activations, so linear layers sit at indices 0, 2, 4, ... and keep their
    (out, in) weights.

    rsl_rl's ActorCritic keeps a state-independent ``std`` parameter; the
    port's is ``log_std`` -> export ``std = exp(clip(log_std, -5, 2))``, the
    exact std the policy acts with."""
    out = {}
    for head in ("actor", "critic"):
        keys = [k for k in state_dict if k.startswith(head + ".")]
        for k in keys:
            out[k] = state_dict[k].detach().cpu().numpy()
        meta[f"{head}_layers"] = sum(k.endswith(".weight") for k in keys)
    log_std = state_dict["log_std"].detach().cpu().numpy()
    out["std"] = np.exp(np.clip(log_std, -5.0, 2.0))
    return out


def flatten_recurrent(state_dict):
    """The port's `ActorCriticRecurrent.state_dict()` -> the flax parameter
    tree flattened with "." (`flatten_dict(params["params"])` of the JAX
    model): `memory.lstm_{a,c}{i}.{ii..io}.kernel` (in, H) and
    `{hi..ho}.kernel` (H, H) with `.bias`, split out of each cell's
    concatenated `wi`, `wh`, `bh` in gate order; `{actor,critic}.Dense_{j}
    .kernel` (in, out) and `.bias`; `log_std`."""
    from ..convert import GATES

    sd = {k: v.detach().cpu().numpy() for k, v in state_dict.items()}
    out = {"log_std": sd["log_std"]}
    for k, v in sd.items():
        parts = k.split(".")
        if parts[0] in ("lstm_a", "lstm_c"):
            cell = f"memory.{parts[0]}{parts[1]}"
            side, leaf = {"wi": ("i", "kernel"), "wh": ("h", "kernel"),
                          "bh": ("h", "bias")}[parts[2]]
            for g, block in zip(GATES, np.split(v, 4, axis=-1)):
                out[f"{cell}.{side}{g}.{leaf}"] = block
        elif parts[0] in ("actor", "critic"):
            # nn.Sequential index 0, 2, 4, ... -> Dense_0, Dense_1, ...
            dense = f"{parts[0]}.Dense_{int(parts[1]) // 2}"
            if parts[2] == "weight":
                out[f"{dense}.kernel"] = v.T
            else:
                out[f"{dense}.bias"] = v
    return out


def save_pt(flat, path, iteration):
    """rsl_rl OnPolicyRunner.save layout: RealLab / play_policy.py load this
    via ``torch.load(path)['model_state_dict']``."""
    import torch

    sd = {k: torch.from_numpy(np.array(v, dtype=np.float32))
          for k, v in flat.items()}
    torch.save({"model_state_dict": sd, "optimizer_state_dict": {},
                "iter": int(iteration), "infos": None}, path)
    return path


def save_npz(flat, path, meta):
    np.savez(path, __meta__=np.frombuffer(
        json.dumps(meta).encode(), dtype=np.uint8), **flat)
    return path


def main(argv=None):
    p = argparse.ArgumentParser(description="WheeledLab policy export "
                                            "(PyTorch/CUDA port)")
    p.add_argument("--run", required=True, help="run name under --logs-dir")
    p.add_argument("--logs-dir", default="logs")
    p.add_argument("--checkpoint", type=int, default=0, help="0 = latest")
    p.add_argument("--format", choices=("pt", "npz", "both"), default="both")
    p.add_argument("--out", default=None,
                   help="output dir (default <run_dir>/export)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda)")
    args = p.parse_args(sys.argv[1:] if argv is None else argv)

    import torch

    from ..rl.ppo import PPOCfg
    from ..rl.runner import checkpoint_steps
    from ..tasks import make_env
    from ..utils.device import resolve_device

    device = resolve_device(args.device)
    run_dir = os.path.join(args.logs_dir, args.run)
    with open(os.path.join(run_dir, "run_config.json")) as f:
        saved = json.load(f)["run"]
    agent_cfg = PPOCfg(**{k: (tuple(v) if isinstance(v, list) else v)
                          for k, v in saved["agent"].items()})
    recurrent = agent_cfg.policy_class == "ActorCriticRecurrent"
    if recurrent and args.format != "npz":
        # rsl_rl's recurrent module has no registered deployment path; the
        # npz carries the full parameter tree
        print("recurrent policy: .pt export targets rsl_rl ActorCritic "
              "only; writing npz", file=sys.stderr)
        args.format = "npz"

    env = make_env(saved["task_name"], num_envs=saved["num_envs"],
                   overrides=saved.get("env_overrides") or None,
                   device=device)
    steps = checkpoint_steps(run_dir)
    if not steps:
        raise FileNotFoundError(f"no checkpoints under {run_dir}")
    step = args.checkpoint or steps[-1]
    ck = torch.load(os.path.join(run_dir, "checkpoints", f"{step}.pt"),
                    map_location="cpu", weights_only=True)
    iteration = int(ck["iteration"])

    out_dir = args.out or os.path.join(run_dir, "export")
    os.makedirs(out_dir, exist_ok=True)
    meta = {
        "task": saved["task_name"], "iteration": iteration,
        "obs_dim": env.obs_dim, "action_dim": env.action_dim,
        "activation": agent_cfg.activation,
        "actor_hidden": list(agent_cfg.actor_hidden),
        "critic_hidden": list(agent_cfg.critic_hidden),
        # deployment needs the action de-normalization the env applied
        "action_scale": list(np.asarray(env.cfg.action.scale).ravel()),
        "action_offset": list(np.asarray(env.cfg.action.offset).ravel()),
        "policy_class": agent_cfg.policy_class,
    }
    model = ck["learner"]["model"]
    flat = (flatten_recurrent(model) if recurrent
            else flatten_actor_critic(model, meta))

    written = []
    if args.format in ("pt", "both"):
        written.append(save_pt(
            flat, os.path.join(out_dir, f"model_{iteration}.pt"), iteration))
    if args.format in ("npz", "both"):
        written.append(save_npz(
            flat, os.path.join(out_dir, f"{args.run}-policy.npz"), meta))
    for w in written:
        print(f"exported {w}")
    return written


if __name__ == "__main__":
    main()
