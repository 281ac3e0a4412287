"""MPPI drifting without reinforcement learning: a planning demo on the
fused drift step — the port of `scripts/mppi_demo.py`.

    python -m wheeledlab_torch.scripts.mppi_demo [--samples 4096]
        [--horizon 16] [--steps 300] [--sigma 0.3] [--temperature 10]
        [--out FILE] [--device cuda]

Every control step samples `--samples` perturbed action sequences over a
`--horizon`-step lookahead through the real env step (the fused drift kernel:
physics plus the drift task's own reward terms as the cost), MPPI-averages
them and executes the first action. The true state lives in lane 0 of a
batched env; planning broadcasts it across the batch (the env is functional,
so rollouts from a copied state have no side effects on it). Costs come from
the env's own reward stream (slip-angle band, velocity, progress,
terminations), so "drift well" needs no hand-written cost.

Prints one JSON line with play-style metrics (mean |slip|, speed, reward) of
the MPPI controller and of a zero-noise (open-loop nominal) baseline, with
the reference's keys. A demo of the planning capability, not of superiority
over RL.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np


def broadcast_state(state, b):
    """Copy lane 0 of every batched field across the whole batch."""
    import torch

    def one(x):
        if not isinstance(x, torch.Tensor) or x.ndim < 1:
            return x
        if x.shape[-1] == b:
            # lane-major rows (rows, B): packed carry, timers
            return x[..., :1].expand(x.shape).contiguous()
        if x.shape[0] == b:
            return x[:1].expand(x.shape).contiguous()
        return x

    return dataclasses.replace(state, **{
        f.name: one(getattr(state, f.name))
        for f in dataclasses.fields(state)})


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--samples", type=int, default=4096)
    p.add_argument("--horizon", type=int, default=16)
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--sigma", type=float, default=0.3)
    p.add_argument("--temperature", type=float, default=10.0)
    p.add_argument("--out", default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda)")
    args = p.parse_args(sys.argv[1:] if argv is None else argv)

    import torch

    from ..tasks.drift.task import DriftTaskCfg, make_drift_env
    from ..utils.device import resolve_device

    device = resolve_device(args.device)
    b, h = args.samples, args.horizon

    def plan_and_step(env, state, nominal, gen):
        """One MPPI control step: sample -> rollout -> weight -> execute."""
        eps = args.sigma * torch.randn((h, b, 2), generator=gen,
                                       device=device)
        eps[:, 0] = 0.0                      # lane 0 rolls the pure nominal
        seqs = torch.clamp(nominal[:, None, :] + eps, -1.0, 1.0)  # (h, B, 2)

        s = broadcast_state(state, b)
        cost = torch.zeros((b,), device=device)
        for t in range(h):
            s, out = env.step(s, seqs[t])
            # the env's reward is the cost signal; discourage episode ends
            cost = cost - out.reward + 50.0 * out.done.to(torch.float32)

        w = torch.softmax(-cost / args.temperature, dim=0)           # (B,)
        new_nominal = torch.clamp(
            nominal + (w[None, :, None] * eps).sum(1), -1.0, 1.0)   # (h, 2)
        # execute the first nominal action on the true state (all lanes)
        state, out = env.step(state, new_nominal[0].expand(b, 2))
        # receding horizon: shift, repeat last
        nominal = torch.cat([new_nominal[1:], new_nominal[-1:]])
        return state, nominal, out

    @torch.no_grad()
    def run(use_mppi: bool):
        env = make_drift_env(DriftTaskCfg(
            num_envs=b, events_enabled=False, enable_corruption=False),
            device=device, seed=0)
        gen = torch.Generator(device=device).manual_seed(0)
        state, _ = env.reset()
        state = broadcast_state(state, b)
        nominal = torch.zeros((h, 2), device=device)
        nominal[:, 0] = 0.6                  # mild throttle prior
        trace = []
        for _ in range(args.steps):
            if use_mppi:
                state, nominal, out = plan_and_step(env, state, nominal, gen)
            else:
                state, out = env.step(state, nominal[0].expand(b, 2))
            trace.append(torch.stack([out.info["metrics/slip_deg"][0],
                                      out.info["metrics/speed"][0],
                                      out.reward[0]]))
        # one device->host copy, after the run
        return torch.stack(trace).cpu().numpy().T

    results = {}
    for name, use in (("nominal_only", False), ("mppi", True)):
        t0 = time.time()
        slip, speed, rew = run(use)
        wall = time.time() - t0
        moving = speed > 0.5
        results[name] = {
            "slip_deg_mean": float(np.abs(slip[moving]).mean())
            if moving.any() else 0.0,
            "speed_mean": float(speed.mean()),
            "reward_mean": float(rew.mean()),
            "wall_s": round(wall, 1),
        }
        print(f"{name}: {json.dumps(results[name])}")

    ms_per_plan = results["mppi"]["wall_s"] / args.steps * 1000
    out = {"metric": "mppi_drift_demo", "samples": b, "horizon": h,
           "steps": args.steps,
           "env_steps_per_control_step": b * h,
           "ms_per_control_step_incl_compile": round(ms_per_plan, 1),
           **{f"{k}/{m}": v for k, r in results.items()
              for m, v in r.items()}}
    print(json.dumps(out))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=2)
    return out


if __name__ == "__main__":
    main()
