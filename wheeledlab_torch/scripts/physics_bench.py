"""Physics micro-benchmark of the drift stack — the port of
`scripts/physics_bench.py`.

Four rows, in env-steps/s, at `--num-envs` envs over `--rollout` control
steps a timed call:

  raw_physics      `sim/dynamics.py::step` alone: the per-vehicle physics,
                   flat ground, zero steer, wheel target 20
  physics_soa      the plain packed-row substep loop (`sim/soa.py::
                   substep_soa`), the same inputs
  env_step_off     the drift env step with `use_kernels="off"`: the
                   generic step on the per-vehicle physics
  env_step_kernel  the drift env step on its fused kernel (K1; on the CPU
                   its plain version), random actions

    python -m wheeledlab_torch.scripts.physics_bench [--num-envs 16384]
        [--rollout 128] [--min-wall 1.0] [--device cuda]

Timing as the reference's `bench`: two chained warm-up calls, then a window
of at least 4 calls and at least `--min-wall` seconds, the clock stopped by
a host read of a value that depends on every call of the window. One JSON
line a row, with the card's name and power limit and the kernel launches
the row's calls made. Runs on CUDA unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time

MIN_ITERS = 4
MAX_ITERS = 8192


def bench(fn, state, min_wall: float):
    """(seconds per call, calls timed) of chained `fn` calls."""
    s, r = fn(state)
    float(r)
    s, r = fn(s)
    float(r)
    iters = 1
    while True:
        t0 = time.perf_counter()
        s = state
        for _ in range(iters):
            s, r = fn(s)
        anchor = float(r)          # waits for every call of the window
        wall = time.perf_counter() - t0
        if not math.isfinite(anchor):
            raise RuntimeError("non-finite result in the physics bench")
        if (wall >= min_wall and iters >= MIN_ITERS) or iters >= MAX_ITERS:
            return wall / iters, iters
        grow = max(2.0, min_wall * 1.25 / max(wall, 1e-9))
        iters = min(MAX_ITERS, max(MIN_ITERS, int(math.ceil(iters * grow))))


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--num-envs", type=int, default=16384)
    p.add_argument("--rollout", type=int, default=128)
    p.add_argument("--min-wall", type=float, default=1.0,
                   help="minimum timed-window seconds per row")
    p.add_argument("--device", default="cuda")
    return p


def kernel_launches() -> int:
    """Every kernel launch the port's wrappers have counted."""
    from ..ops import kernel_rng, multi_step, physics_step, physics_step_hf
    from ..tasks.drift import fused

    return (fused.LAUNCHES + fused.LAUNCHES_KRNG + physics_step.LAUNCHES
            + physics_step_hf.LAUNCHES + multi_step.LAUNCHES
            + kernel_rng.LAUNCHES)


def main(argv=None):
    args = build_parser().parse_args(sys.argv[1:] if argv is None else argv)
    import torch

    from ..sim import dynamics
    from ..sim.soa import pack_params, pack_state, substep_soa
    from ..tasks import make_env
    from ..utils.device import describe, resolve_device

    device = resolve_device(args.device)
    n, T = args.num_envs, args.rollout
    card = describe(device)
    rows = []

    def row(metric, fn, state):
        before = kernel_launches()
        per_call, calls = bench(fn, state, args.min_wall)
        line = {"metric": metric, "value": n * T / per_call,
                "unit": "env-steps/s", "num_envs": n, "rollout": T,
                "seconds_per_call": per_call, "timed_calls": calls,
                "kernel_launches": kernel_launches() - before,
                "device": card}
        print(json.dumps(line), flush=True)
        rows.append(line)

    # --- raw physics: the per-vehicle decimation loop, flat ground --------
    env = make_env("MushrDriftRL-v0", num_envs=n, device=device,
                   use_kernels="off")
    state, _ = env.reset()
    params, terrain = state.params, env.task.terrain
    dt, dec = env.cfg.sim_dt, env.cfg.decimation
    steer = torch.zeros((n, 2), device=device)
    wheel = torch.full((n, 4), 20.0, device=device)

    def physics_rollout(v):
        total = torch.zeros((), device=device)
        for _ in range(T):
            v, aux = dynamics.step(v, params, terrain, steer, wheel, dt, dec)
            total = total + aux.normal_force.sum()
        return v, total

    row("raw_physics", physics_rollout, state.vehicle)

    # --- packed-row physics: the plain substep_soa loop -------------------
    packed_params = pack_params(params, terrain.friction)
    steer_rows, wheel_rows = steer.T.contiguous(), wheel.T.contiguous()

    def soa_rollout(m):
        total = torch.zeros((), device=device)
        for _ in range(T):
            for _ in range(dec):
                m = substep_soa(m, packed_params, steer_rows, wheel_rows, dt)
            total = total + m[7].sum()   # the x-velocity row
        return m, total

    row("physics_soa", soa_rollout, pack_state(state.vehicle))

    # --- the drift env step, per-vehicle and on its kernel ----------------
    for metric, use_kernels in (("env_step_off", "off"),
                                ("env_step_kernel", "auto")):
        e = make_env("MushrDriftRL-v0", num_envs=n, device=device,
                     use_kernels=use_kernels)
        s0, _ = e.reset()
        g = torch.Generator(device=device).manual_seed(3)

        def env_rollout(s, e=e, g=g):
            total = torch.zeros((), device=device)
            for _ in range(T):
                a = torch.rand((n, 2), generator=g, device=device) * 2 - 1
                s, out = e.step(s, a)
                total = total + out.reward.sum()
            return s, total

        row(metric, env_rollout, s0)
    return rows


if __name__ == "__main__":
    main()
