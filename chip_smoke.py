#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero without
printing its final line:

1. device  — require CUDA; print the card's name and power limit.
2. build   — build every CUDA kernel of the port from `wheeledlab_torch/csrc`
             (nvcc) and print the build time and ptxas resource report.
3. kernel  — hold the fused drift step kernel against its plain PyTorch
             version (`drift_step_rows`) on the card, at 16384 envs, at the
             training config's 1024 envs and at a ragged 1000 envs, for the
             MuSHR (rwd, clip) and F1Tenth (4wd) robots, with push events and
             observation noise on, and states that leave the track or reach
             the time limit. Every env must agree.
4. train   — `wheeledlab_torch.rl.runner.train` on RSS_DRIFT_CONFIG at full
             width (1024 envs, 128 steps, 5 epochs x 4 minibatches) for 3
             iterations on the card; the kernel must carry every env step.
5. timing  — the kernel's time with CUDA events beside its plain version's
             and the card's bound, at 16384 and 1024 envs.

It imports nothing of JAX. The last line is the result object.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import tempfile
import time

# nvcc's default FMA contraction moves the kernel's floats by a few ulp
# against the plain version; integers and done flags must match exactly.
FLOAT_TOL = dict(atol=1e-4, rtol=1e-4)
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and float32 (non-tensor-
# core) operations/s
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# Float operations of one env's step for MuSHR (rwd, clip) with events and
# noise on, counted by hand from csrc/fused_drift.cu and csrc/substep.cuh:
# 4 substeps x 738 (4 wheels x 129 + 16 for the steered wheels' heading,
# rotation 39, steering servo 38, rigid body 129) plus 423 for action map,
# pushes, rewards, reset and observation. Each +, -, *, / and each sqrtf,
# sinf, cosf, tanhf, floorf counts one; comparisons, selects, min/max, abs
# and negation count none.
OPS_PER_ENV = 4 * 738 + 423
TIMING_WINDOW_S = 2.0


def phase(name):
    print(f"=== {name}", flush=True)


def device_phase():
    import torch

    phase("device")
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    return card


def build_phase():
    from wheeledlab_torch.ops import build

    phase("build")
    t0 = time.perf_counter()
    build.load_library("fused_drift")
    print(f"build_s {time.perf_counter() - t0:.2f}")
    registers = None
    for line in build.BUILD_LOGS.get("fused_drift", "").splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print("ptxas:", line.strip())
        if "Used" in line and "registers" in line:
            registers = line.split("ptxas info    :")[-1].strip()
    return registers


def step_inputs(robot, b, seed, device):
    """Random but realistic inputs of one fused drift step, made with numpy
    from `seed`: states all over and beyond the track, DR'd params, step
    counts at the time limit and push timers about to fire."""
    import numpy as np
    import torch

    from wheeledlab_torch.tasks.drift.fused import (
        NUM_UNIFORM, OBS_ROWS, FusedDriftConsts,
    )
    from wheeledlab_torch.tasks.drift.task import (
        REWARD_TERMS, DriftTaskCfg, make_drift_task, reference_track_poses,
    )

    rng = np.random.default_rng(seed)
    task_cfg = DriftTaskCfg(num_envs=b, robot=robot)
    task = make_drift_task(task_cfg)
    cfg = FusedDriftConsts(task_cfg, task.cfg)
    gen = torch.Generator().manual_seed(seed)
    from wheeledlab_torch.sim.soa import pack_params

    params = pack_params(task.init_params(gen, b, "cpu"), 1.0)

    u = lambda lo, hi, *s: rng.uniform(lo, hi, s or (b,))
    roll, pitch, yaw = u(-0.1, 0.1), u(-0.1, 0.1), u(-math.pi, math.pi)
    cr, sr = np.cos(roll / 2), np.sin(roll / 2)
    cp, sp = np.cos(pitch / 2), np.sin(pitch / 2)
    cy, sy = np.cos(yaw / 2), np.sin(yaw / 2)
    quat = [cy * cp * cr + sy * sp * sr, cy * cp * sr - sy * sp * cr,
            cy * sp * cr + sy * cp * sr, sy * cp * cr - cy * sp * sr]
    state = np.stack([
        u(-2.5, 2.5), u(-2.5, 2.5), 0.06 + u(-0.01, 0.01), *quat,
        u(-3, 3), u(-3, 3), u(-0.2, 0.2),
        u(-0.3, 0.3), u(-0.3, 0.3), u(-3, 3),
        *u(-10, 80, 4, b), *u(-0.5, 0.5, 2, b), *u(-2, 2, 2, b)])
    max_len = cfg.max_episode_length
    step_count = rng.integers(0, max_len, b)
    step_count[rng.random(b) < 0.1] = max_len - 1
    weights = np.array([t.weight for t in REWARD_TERMS]) + rng.uniform(
        0, 20, len(REWARD_TERMS))
    f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=device)
    i32 = lambda x: torch.as_tensor(np.asarray(x, np.int32), device=device)
    inputs = dict(
        weights=f32(weights),
        poses=f32(reference_track_poses(
            task_cfg, torch.as_tensor(rng.random(20), dtype=torch.float32))),
        state=f32(state), params=params.to(device),
        action_rows=f32(rng.normal(0, 1, (2, b))),
        uniforms=f32(rng.random((NUM_UNIFORM, b))),
        normals=f32(rng.standard_normal((OBS_ROWS, b))),
        step_count=i32(step_count[None]),
        timers=i32(rng.integers(0, 4, (cfg.n_push, b))),
        ep_return=f32(rng.normal(0, 10, (1, b))),
        ep_len=i32(step_count[None]),
    )
    return cfg, inputs


def plain_step(cfg, x):
    """The plain version on the same tensors, in the wrapper's layout."""
    from wheeledlab_torch.tasks.drift.fused import drift_step_rows

    nsr, obs, out, sc, tm, er, el = drift_step_rows(
        x["state"], x["params"], x["action_rows"][0], x["action_rows"][1],
        x["uniforms"], x["normals"], x["weights"], x["poses"],
        x["step_count"][0], x["timers"], x["ep_return"][0], x["ep_len"][0],
        cfg=cfg)
    return nsr, obs, out, sc[None], tm, er[None], el[None]


def kernel_step(cfg, x):
    from wheeledlab_torch.tasks.drift.fused import fused_drift_step

    return fused_drift_step(cfg=cfg, **x)


def compare(got, want):
    """Agreement of the 7 outputs over every env: returns (max |kernel -
    plain| of the float outputs, number of envs beyond FLOAT_TOL or with an
    integer that differs)."""
    import torch

    names = ("state", "obs", "out", "step_count", "timers", "ep_return",
             "ep_len")
    b = got[0].shape[1]
    bad = torch.zeros(b, dtype=torch.bool, device=got[0].device)
    max_err = 0.0
    for name, g, w in zip(names, got, want):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"{name}: {g.shape}/{g.dtype} vs "
                                 f"{w.shape}/{w.dtype}")
        if g.dtype == torch.int32:
            bad |= (g != w).any(0)
        else:
            if not torch.isfinite(g).all():
                raise AssertionError(f"{name}: kernel output not finite")
            err = (g - w).abs()
            tol = FLOAT_TOL["atol"] + FLOAT_TOL["rtol"] * w.abs()
            bad |= (err > tol).any(0)
            max_err = max(max_err, err.max().item())
    return max_err, int(bad.sum())


def kernel_phase(device):
    import torch

    phase("kernel")
    print(f"tolerance |kernel - plain| <= {FLOAT_TOL['atol']} + "
          f"{FLOAT_TOL['rtol']} |plain|; integers exact; no env beyond",
          flush=True)
    max_err, cases = 0.0, {}
    for robot in ("mushr", "f1tenth"):
        for b in (16384, 1024, 1000):
            cfg, x = step_inputs(robot, b, seed=b + len(robot), device=device)
            got = kernel_step(cfg, x)
            torch.cuda.synchronize()
            want = plain_step(cfg, x)
            err, flipped = compare(got, want)
            resets = int(want[2][1].sum())
            print(f"{robot} B={b}: max_abs_err {err:.3e}, envs beyond "
                  f"tolerance {flipped}, resets {resets}", flush=True)
            if flipped:
                raise AssertionError(f"{flipped} of {b} envs disagree")
            if resets == 0 or int(want[2][2].sum()) == 0:
                raise AssertionError("inputs fired no reset or time-out")
            max_err = max(max_err, err)
            cases[(robot, b)] = (cfg, x)
    return max_err, cases


def train_phase(device):
    import torch

    import wheeledlab_torch.rl  # noqa: F401  registers run configs
    from wheeledlab_torch.rl.runner import train
    from wheeledlab_torch.tasks.drift import fused
    from wheeledlab_torch.utils.config import RUN_CONFIGS, override

    phase("train")
    iters = 3
    with tempfile.TemporaryDirectory() as logs:
        cfg = RUN_CONFIGS.get("RSS_DRIFT_CONFIG")
        for k, v in (("train.num_iterations", iters),
                     ("train.log.logs_dir", logs),
                     ("train.log.run_name", "smoke"),
                     ("train.log.log_every", 1),
                     ("train.log.checkpoint_every", 1000),
                     ("device", device)):
            cfg = override(cfg, k, v)
        assert (cfg.num_envs, cfg.agent.num_steps_per_env,
                cfg.agent.num_learning_epochs,
                cfg.agent.num_mini_batches) == (1024, 128, 5, 4)
        fused.LAUNCHES = 0
        state, last = train(cfg)
        torch.cuda.synchronize()
        launches = fused.LAUNCHES
        with open(os.path.join(logs, "smoke", "metrics.jsonl")) as f:
            rows = [json.loads(line) for line in f]
    want = iters * cfg.agent.num_steps_per_env
    if launches != want:
        raise AssertionError(f"kernel launches {launches}, expected {want}")
    for row in rows:
        for k in ("loss/total", "loss/surrogate", "loss/value",
                  "rollout/reward_mean"):
            if not math.isfinite(row[k]):
                raise AssertionError(f"{k} not finite: {row[k]}")
    obs = state.obs
    if tuple(obs.shape) != (1024, 14) or not torch.isfinite(obs).all():
        raise AssertionError("final observation malformed")
    prev, iter_ms = 0.0, []
    for row in rows:
        cum = row["time/iterate_s"] + row.get("time/device_sync_s", 0.0)
        iter_ms.append(1000.0 * (cum - prev))
        prev = cum
    steps = cfg.num_envs * cfg.agent.num_steps_per_env
    print(f"launches {launches}; iteration ms "
          f"{[round(t, 3) for t in iter_ms]}; env-steps/s (last iteration) "
          f"{steps / (iter_ms[-1] / 1000.0):.1f}; loss/total "
          f"{rows[-1]['loss/total']:.4f}", flush=True)
    return launches, iter_ms


def timed(fn, window_s=TIMING_WINDOW_S, min_calls=4):
    """ms per call from CUDA events over a window of >= window_s and
    >= min_calls, after two warmup calls."""
    import torch

    fn()
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    calls, t0 = 0, time.perf_counter()
    start.record()
    while calls < min_calls or time.perf_counter() - t0 < window_s:
        fn()
        calls += 1
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def graphed(fn, per_graph=20):
    """`fn` captured `per_graph` times in one CUDA graph: a replay's time
    over `per_graph` is the kernel's device time without launch cost."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(per_graph):
            fn()
    return timed(g.replay) / per_graph


def step_bytes(cfg, x):
    """Bytes one fused step must move on these inputs: each element the
    kernel reads, once, and each element it writes, once. The uniform rows of
    push components whose range is zero are never read, nor the normal rows
    whose noise std is zero (nor any, with corruption off); of the pose table
    only x, y and yaw of the rows that the spawn indices pick."""
    import torch

    from wheeledlab_torch.sim.soa import NUM_PARAM, NUM_STATE
    from wheeledlab_torch.tasks.drift.fused import (
        _OBS_STD, NUM_OUT, OBS_ROWS, U_SPAWN,
    )

    b = x["state"].shape[1]
    uniform_rows = 4 + sum(  # spawn, then per event: its components + interval
        1 + sum(hi != lo or lo != 0.0 for lo, hi in ranges)
        for _, _, ranges in cfg.pushes)
    normal_rows = (sum(s != 0.0 for s in _OBS_STD)
                   if cfg.enable_corruption else 0)
    # state, params, actions, uniforms, normals, step count, timers, return,
    # length
    words_in = (NUM_STATE + NUM_PARAM + 2 + uniform_rows + normal_rows + 1
                + cfg.n_push + 1 + 1)
    # state, obs, info, step count, timers, return, length
    words_out = NUM_STATE + OBS_ROWS + NUM_OUT + 1 + cfg.n_push + 1 + 1
    idx = torch.clamp((x["uniforms"][U_SPAWN] * cfg.num_reset_points)
                      .to(torch.int32), max=cfg.num_reset_points - 1)
    table_words = x["weights"].numel() + 3 * idx.unique().numel()
    return 4 * ((words_in + words_out) * b + table_words)


def timing_phase(cases, card):
    phase("timing")
    rows = {}
    for b in (16384, 1024):
        cfg, x = cases[("mushr", b)]
        kernel_ms = timed(lambda: kernel_step(cfg, x))
        graph_ms = graphed(lambda: kernel_step(cfg, x))
        plain_ms = timed(lambda: plain_step(cfg, x))
        nbytes = step_bytes(cfg, x)
        ops = OPS_PER_ENV * b
        bytes_ms = 1000.0 * nbytes / HBM_BYTES_PER_S
        ops_ms = 1000.0 * ops / FP32_OPS_PER_S
        row = {"name": "fused_drift_step", "envs": b, "ms": kernel_ms,
               "graph_ms": graph_ms, "plain_ms": plain_ms,
               "bound_ms": max(bytes_ms, ops_ms),
               "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
               "bytes": nbytes, "ops": ops, "card": card}
        print(json.dumps(row), flush=True)
        rows[b] = row
    return rows


def main():
    import torch

    card = device_phase()
    device = "cuda"
    registers = build_phase()
    max_err, cases = kernel_phase(device)
    launches, iter_ms = train_phase(device)
    timing = timing_phase(cases, card)
    main_row = timing[1024]
    kernels = [{
        "name": "fused_drift_step",
        "route": "cuda",
        "source": "wheeledlab_torch/csrc/fused_drift.cu",
        "replaces": "wheeledlab_tpu/tasks/drift/fused.py:488",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": None,
        "envs": 1024,
        "graph_ms": main_row["graph_ms"],
        "ms_16384": timing[16384]["ms"],
        "graph_ms_16384": timing[16384]["graph_ms"],
        "plain_ms_16384": timing[16384]["plain_ms"],
        "bound_ms_16384": timing[16384]["bound_ms"],
        "train_iteration_ms": iter_ms,
        "ptxas": registers,
    }]
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
