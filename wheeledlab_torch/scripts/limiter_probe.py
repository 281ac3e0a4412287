"""Limiter probe for the fused drift kernel — the port of
`scripts/limiter_probe.py`: is the drift step's time set by the arithmetic of
one control step, by being launched once per control step, or by taking the
state through device memory once per control step?

    python -m wheeledlab_torch.scripts.limiter_probe [--device cuda]
        [--window 2.0]              # PROBE_ENVS=16384 in the environment

Experiment: the K-step kernel (`ops/multi_step.py::multi_step`,
`csrc/multi_step.cu`) runs the control step K times inside one launch, with
the vehicle state, params, timers and episode accumulators resident between
the steps. K = 1 is the production kernel's shape less its observation and
info blocks (sanity row). Intermediate observations are not written (the
policy consumes them between steps in real training, so K > 1 is no training
configuration). If the time per control step barely drops from K = 1 to
K = 8, the step's own dependent arithmetic is the limiter; if it drops a lot,
the launch and the state round trip are, and a multi-step rollout layout is
the next optimization.

One JSON line per K and mode, naming the device it ran on. Inputs are fixed
device tensors reused every call; the state chains through all calls and the
clock is anchored by a device->host read of a value that depends on every
call. Every K sees the same data: one sequence of 8 action and random blocks
is drawn once, and a call of K steps takes the next K blocks of it (K = 8:
all of them in one launch; K = 1: one block per launch, 8 launches per
round). The reference draws separate inputs per K; on this card the step's
time depends on its data (a standing car takes a slower path than a moving
one, PERF.md), so rows fed different actions would not compare. A timed unit is 16
chained calls: "eager" issues them from Python, "graph" (CUDA only) replays
them as one CUDA graph, which takes the host's launch cost out. Random-block
generation is excluded from all rows equally. Measured rows are in PERF.md.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

CALLS_PER_UNIT = 16
KS = (1, 2, 4, 8)


def _timed_row(run_unit, anchor, window_s, k, num_envs):
    """Two chained warm-ups, then a window of >= window_s and >= 4 units."""
    run_unit()
    run_unit()
    anchor()
    units, iters = 2, 1
    while True:
        t0 = time.perf_counter()
        for _ in range(iters):
            run_unit()
        value = anchor()
        wall = time.perf_counter() - t0
        units += iters
        if not math.isfinite(value):
            raise RuntimeError(f"K={k}: the chained state is not finite")
        if wall >= window_s and iters >= 4:
            break
        iters = max(4, int(math.ceil(
            iters * max(2.0, 1.25 * window_s / max(wall, 1e-9)))))
    steps = CALLS_PER_UNIT * k * iters
    return {"k": k, "env_steps_per_s": round(num_envs * steps / wall, 1),
            "us_per_control_step": round(wall / steps * 1e6, 2),
            "num_envs": num_envs, "timed_iters": iters,
            "wall_s": round(wall, 2)}, units


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda)")
    p.add_argument("--window", type=float, default=2.0,
                   help="least seconds of a timed window (default 2)")
    args = p.parse_args(sys.argv[1:] if argv is None else argv)

    import torch

    from ..ops.multi_step import multi_step
    from ..tasks.drift.fused import NUM_UNIFORM, OBS_ROWS, FusedDriftConsts
    from ..tasks.drift.task import (
        DriftTaskCfg, make_drift_env, reference_track_poses,
    )
    from ..utils.device import resolve_device

    device = resolve_device(args.device)
    ran_on = (torch.cuda.get_device_name(device) if device.type == "cuda"
              else "cpu")
    num_envs = int(os.environ.get("PROBE_ENVS", 16384))
    task_cfg = DriftTaskCfg(num_envs=num_envs)
    env = make_drift_env(task_cfg, device=device, seed=0)
    cfg = FusedDriftConsts(task_cfg, env.cfg)
    # the pose table the env's own fused step spawns from
    track_gen = torch.Generator().manual_seed(task_cfg.seed + 17)
    poses = reference_track_poses(
        task_cfg, torch.rand((task_cfg.num_reset_points,),
                             generator=track_gen)).to(device)
    state, _ = env.reset()
    carry0 = (state.vehicle_mem, state.step_count[None], state.push_timers,
              state.ep_return[None], state.ep_len[None])
    gen = torch.Generator(device=device).manual_seed(0)

    k_max = max(KS)
    uniforms = torch.rand((NUM_UNIFORM * k_max, num_envs), generator=gen,
                          device=device)
    normals = torch.randn((OBS_ROWS * k_max, num_envs), generator=gen,
                          device=device)
    actions = torch.rand((2 * k_max, num_envs), generator=gen,
                         device=device) * 2.0 - 1.0

    rows = []
    for k in KS:
        def step(c, call):
            m, sc, tm, er, el = c
            i = (call * k) % k_max                 # first block of this call
            return multi_step(
                state.reward_weights, poses, m, state.packed_params,
                actions[2 * i:2 * (i + k)],
                uniforms[NUM_UNIFORM * i:NUM_UNIFORM * (i + k)],
                normals[OBS_ROWS * i:OBS_ROWS * (i + k)], sc, tm, er, el,
                cfg, k)

        def chain(c):
            for call in range(CALLS_PER_UNIT):
                c = step(c, call)
            return c

        # eager: 16 calls issued from Python per unit
        box = [carry0]

        def run_eager():
            box[0] = chain(box[0])

        row, units = _timed_row(run_eager, lambda: float(box[0][0][7].sum()),
                                args.window, k, num_envs)
        row.update(mode="eager", launches=units * CALLS_PER_UNIT,
                   device=ran_on)
        rows.append(row)
        print(json.dumps(row), flush=True)

        if device.type != "cuda":
            continue
        # graph: the same 16 calls captured once, the carry held in static
        # buffers that the graph's last nodes write back
        static = tuple(t.clone() for t in carry0)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            step(static, 0)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for buf, new in zip(static, chain(static)):
                buf.copy_(new)
        row, _ = _timed_row(graph.replay, lambda: float(static[0][7].sum()),
                            args.window, k, num_envs)
        # wrapper launches: one warm-up call and the 16 captured ones
        row.update(mode="graph", launches=1 + CALLS_PER_UNIT, device=ran_on)
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows


if __name__ == "__main__":
    main()
