#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero without
printing its final line:

1. device  — require CUDA; print the card's name and power limit.
2. build   — build every CUDA kernel of the port from `wheeledlab_torch/csrc`
             (one nvcc per source, all started together) and print the
             build time and each ptxas resource report.
3. kernel  — hold each kernel against its plain PyTorch version on the
             card, every env bit for bit (K4: see below; every kernel is
             built without FMA contraction):
             K1, the fused drift step (`drift_step_rows`), at 65536 and
             32768 envs (POD_DRIFT_CONFIG's widths on one rank and on each
             of two), 16384, 1024, 1000, 7 and 1 envs (the last three leave
             a warp partly empty
             or a group count that is no multiple of 8), for MuSHR and
             F1Tenth, with push events, observation noise, resets and
             time-outs firing, and on the state an env starts from (every
             car standing), bit for bit;
             K2, the flat physics step (the `substep_soa` loop), at 16384,
             1024, 1000 and 16 envs, decimation 4 and 20, both robots, bit
             for bit;
             K3, the heightfield physics step (the `substep_soa_hf` loop), at
             16384, 1024, 1000, 7 and 1 envs, decimation 10, p = 12, with
             states over the mounds of a generated terrain, wheels in and
             out of contact, some envs airborne; at 1024 envs with p = 30
             (more shared memory than a block has by default) and with the
             largest patch the wrapper takes (`MAX_P`); and on cars at rest
             on the terrain. It must equal its plain version bit for bit.
             K5b, the Philox random blocks (`philox_blocks`), at 4096, 1000,
             16, 7 and 1 envs: the uniforms' 24-bit words and the normals
             bit for bit;
             K4, the fused drift step that draws its rows in the kernel
             (`philox_blocks` + `drift_step_rows`), at 16384, 1024, 1000, 7
             and 1 envs, both robots, noise on and off, and at 32768 envs
             (a rank's half of POD_DRIFT_CONFIG) on the seed rank 1 hands
             the kernel (a drawn seed plus 0x3779B1, wrapped to int32),
             every env within FLOAT_TOL, and bit for bit against K1 fed
             K5b's rows;
             K5a, the K-step resident rollout (K chained `drift_step_rows`),
             at K = 1, 2, 4, 8 and the same widths, both robots, and against
             K chained K1 launches, bit for bit;
             K2 at the visual task's shape (512 and 7 envs, decimation 20,
             dt 0.01, MuSHR with the task's DR on ground friction 2.0), bit
             for bit.
             A float that is not finite on either side marks its env, and
             the max error counts only floats finite on both sides, so it is
             never NaN. A mismatch prints, for each output that disagrees,
             "<case> <output>: N envs beyond tolerance, M not bit-equal[; not
             finite in a envs (kernel), b (plain)]; first env e: kernel
             [column], plain [column]", then launches the kernel and runs
             the plain version once more on the same inputs and prints
             {"check": "repeat after a disagreement", "case": ...,
             "kernel_repeated_bit_for_bit": ..., "plain_repeated_bit_for_bit":
             ..., and the envs that changed on each side}: the side that did
             not repeat itself is the one at fault. The phase fails after
             every case has printed.
   integrity — what an intermittent disagreement could come from, one JSON
             line a check with its counts: every case above once more with
             each output made by `torch.empty`/`torch.empty_like` filled
             with a sentinel (NaN, INT32_MIN) and placed between margins of
             one row of it: no sentinel may remain, no margin may be
             written, and the outputs must equal the ordinary launch's bit
             for bit ("poisoned outputs"); K1, K3 and K4 at 1024 envs and
             their largest width (65536, 16384, 32768) with every input
             block a contiguous view between margins of one row of
             sentinels: the same bits out, inputs and margins untouched
             ("guard bands"); 64 launches of K1 at 65536 envs and 32 of K4
             at 32768, both robots, and 32 of K3 at 16384 on the same
             inputs, each equal to the first bit for bit ("repeated
             launches"); the plain drift step 4 times on the card at 65536
             envs, both robots ("repeated plain drift steps on the card");
             K1 against its plain version at 65536 envs on 6 more seeds a
             robot ("K1 against plain on more seeds").
   per-vehicle — `sim/dynamics.py::step` (the physics of
             `use_kernels="off"` and of a heightfield without an atlas)
             against K2 at 1024 and 16384 envs, both robots, decimation 4,
             and against K3 at 1024 envs, decimation 10, p = 12, through
             each env's atlas patch and on the full grid, every env within
             FLOAT_TOL; the drift env at use_kernels="off" against its K1
             route, 1024 envs, 8 steps from one state (the reference's
             fused-against-XLA tolerances; 8 K1 launches and no other);
             16 steps of elevation without its atlases (finite, no kernel
             launched); the native host library, which must load, against
             numpy map generation at the visual map's size; and
             `scripts.physics_bench` at 16384 envs, rollout 32, in a
             subprocess (four rows; only the kernel route launches).
   visual  — `action_to_targets` on the card equal to its CPU result bit
             for bit (rwd, 4wd, ackermann; 4096 actions); the renderers
             (`render_fast` cropped, `render`, `render_rgb`) on the card
             against the CPU at 512 reset and 512 tilted poses of the full
             colored map: at most 1e-3 of the pixels may differ, each with
             its hit point within 1e-4 m of a cell edge.
4. train   — `wheeledlab_torch.rl.runner.train` for 3 iterations at full
             width (128 steps, 5 epochs x 4 minibatches): on
             RSS_DRIFT_CONFIG (1024 envs), where K1 must carry every env
             step (384 launches); on RSS_DRIFT_CONFIG with
             WHEELEDLAB_KERNEL_RNG=1, where K4 must (384 launches, 0 of K1);
             on RSS_ELEV_CONFIG (1024 envs, obs 689), where K3 must (384
             launches); and on RSS_VISUAL_CONFIG (512 envs, obs 3208, colored
             world), where K2 must (384 launches); no other kernel may
             launch. The elevation and visual runs (and every run of them
             below) must apply the policy through
             `fused_actor_critic_apply` (its call counter, reset and read
             like the launch counters: 447 calls in 3 iterations), the
             drift and recurrent runs never. One JSON line gives the first
             minibatch's KL estimate of each iteration of the four runs (a
             measurement: is it 0 on the card where the new policy is the
             old one, or a rounding residue as XLA's is?). Launches and
             fused applies are counted by host call, so a rollout's
             captured step (`rl/ppo.py::StepGraph`) counts at its first
             step, warm-up and capture; `read_launches` and
             `read_fused_calls` take those out and count each replay
             (`ppo.REPLAYED_STEPS`) as the calls one step holds.
   rollout_graph — the rollout's step captured against the same step run
             as it stands, 3 iterations each from one seed and state:
             drift at 65,536 and 1024 envs on K1 and K4, and at 1024 with
             `fuse_input_layer` and in bfloat16; RSS_VISUAL_CONFIG (the
             generic step, K2) and RSS_ELEV_CONFIG (the generic step, K3)
             at 1024; a curriculum's first change crossed at step 14 of
             the second iteration (drift, elevation): the parameters, Adam,
             both generators, the env state and every metric bit for bit,
             the route's kernel carrying every step (384 launches), every
             step replayed but a first one whose obs lie otherwise
             (uncaptured: none replayed); one JSON line a case with the
             graphed share of rollout steps and each route's iterations'
             host ms; one video iteration (`capture_traj`) at 1024 drift
             envs, its `traj/*` channels and every other number bit for
             bit; a checkpoint written after 2 captured iterations at
             65,536 envs and resumed by an uncaptured learner, whose next
             iteration must equal the captured one's bit for bit; then 2
             captured iterations under `torch.profiler`, whose trace must
             hold 256 K1 kernels.
   fused   — the fused first layer against the unfused forward on the card
             at 1024 x 689 and 512 x 3208, float32 within 1e-5 and bfloat16
             within the bound of tests/test_torch_fused_input_layer.py;
             then RSS_ELEV_CONFIG and RSS_VISUAL_CONFIG, 3 iterations a
             run with `agent.fuse_input_layer` off, on, on, off, each
             iteration's update ms and iteration ms.
   recurrent — ActorCriticRecurrent (LSTM-256, obs 14) at 1024 envs, one
             32-step sequence with resets on the card and on the CPU: means,
             values and hidden state within RNN_FORWARD_TOL (both compute
             the cells in bfloat16, summed in other orders); then 3
             iterations of RSS_DRIFT_RNN_CONFIG (1024 envs, 128 steps, 5
             epochs x 4 env-axis minibatches of BPTT), where K1 must carry
             every env step (384 launches), with finite losses and the LSTM
             weights moved; one iteration's rollout and update timed apart
             and one minibatch update's device time and launches
             (torch.profiler), and the first minibatch's KL line of the
             four iterations; RSS_ELEV_CONFIG with
             agent.compute_dtype=bfloat16 beside float32, 3 iterations a
             run in turns (float32, bfloat16, bfloat16, float32; 384 K3
             launches each, obs stored in the run's dtype).
   train_bench — `scripts.train_bench.main`, the entry point of the
             full-budget runs (`docs/runs/*_h100/`), with their settings
             (`--log-every 10 --no-checkpoints`, a target return no run
             reaches) for 20 iterations of RSS_DRIFT_CONFIG and 20 of
             F1TENTH_DRIFT_CONFIG at 1024 envs: metrics.jsonl,
             run_config.json and result.json written, the result naming
             this card with a finite return, K1 carrying every env step
             (2560 launches a config) and no other kernel launched; one
             JSON line a config with its steady ms per iteration.
   resume  — the full-budget runs' resume and stitch path
             (`scripts.full_budget_runs`) for each resumable config:
             RSS_ELEV_CONFIG (1024 envs, K3), RSS_DRIFT_RNN_CONFIG (1024,
             K1; the LSTM carry restored) and RSS_VISUAL_CONFIG (512, K2),
             each 4 iterations straight, then 2 and 2 more resumed from
             the first segment's checkpoint, both stitched by
             `full_budget_runs.stitch`: the stitched rows must equal the
             straight run's bit for bit in every metric but `perf/*` and
             `time/*`, the config's kernel carrying every env step (1024
             launches) and no other kernel launching; the play CLI on the
             resumed run, 50 steps at 64 envs (50 K3 launches for
             elevation, 50 K2 for the others); one JSON line a config
             with the straight run's ms per iteration, alone on the card.
5. play    — `wheeledlab_torch.cli.play.main` on the drift run just trained:
             its play variant for 200 steps at 16 envs through the generic
             step, where K2 must carry every step (200 launches); and on the
             visual run, 50 steps at 16 envs with `--video` (50 K2 launches),
             which must write the top-down video and env 0's policy-view
             clip; on the recurrent run, 50 steps at 16 envs (50 K2
             launches, the carry reset by done), and `cli.export --format
             both`, which must write the npz alone with the flax parameter
             names and layouts.
6. scripts — `scripts.check_kernel_rng` (K5b; must pass),
             `scripts.limiter_probe` at 16384 envs, K = 1, 2, 4, 8, with a
             0.5 s window (K5a carries every call) and `scripts.mppi_demo`
             at 4096 samples, horizon 16, 20 steps (K1: 20 + 20 x 17
             launches; finite rewards).
7. timing  — each kernel's time with CUDA events (eager and as a CUDA
             graph) beside its plain version's and the card's bound; K1 and
             K3 beside their times before they gave an env to 4 lanes, K4
             and K5b beside their times before the 4 lanes of an env drew
             its rows together (quoted from PERF.md; the run fails unless
             each is faster), with registers, block size, blocks and warps
             per SM, and K1 and K3 on standing cars beside moving ones; K4
             against K1 plus the `torch.rand` and `torch.randn` calls that
             feed it, and its premium over K1; K5b against those two calls
             alone and beside the launch floor (an empty kernel's graph
             time); K2 at the visual shape; and where a visual env step's
             time goes (the whole step, its observation: render,
             augmentation and noise, and its K2 launch): device ms and
             launches from torch.profiler's record of the card, beside the
             wall ms of the same calls unprofiled, in a process of its own
             (this script's `--visual-breakdown` mode).

8. distributed — POD_DRIFT_CONFIG (65,536 envs) over torch.distributed
             on the one card, last and in processes of its own:
             `torchrun --nproc_per_node 1` running this script's
             `--pod-cli` mode, which calls the train CLI over the job's
             NCCL group (2 iterations, 256 K1 launches, finite metrics);
             two ranks over gloo (this script's `--gloo-rank` mode; NCCL
             refuses two ranks on one card), 32,768 envs each: 2
             iterations on K1 (256 launches a rank) and 1 on K4 (128 a
             rank), the same metrics and parameter hash on both ranks and
             rank 1's K4 seed offset 0x3779B1; in both jobs a `train()`
             with `train.profile` at 4,096 envs, whose trace on rank 0 must
             hold kernels of the card, K1 among them; `scripts.scale_bench`
             at world size 1, rollout and full PPO. Every subprocess runs in a
             session of its own, killed if it outlives JOB_TIMEOUT_S.
9. tensor parallel — two gloo ranks on the one card as `global_mesh(2)`
             (data 1 x model 2; this script's `--tp-rank` mode): a
             RSS_DRIFT_CONFIG policy acts for 8 steps of a 1024-env drift
             env on each rank (8 K1 launches a rank); the rank's share of
             the policy (`TensorParallelActorCritic`) on those 8192
             observations against the whole policy, mean and value within
             1e-5, one PPO loss's gradients within 1e-5 of the whole
             gradients' slices; the TP forward's ms beside the whole one's.

Every launch counter is set to 0 just before a path is driven and read just
after. It imports nothing of JAX. The last line is the result object.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from typing import Any, NamedTuple

# The stated tolerance of a kernel against its plain version; integers and
# done flags must match exactly. Every kernel is built without FMA
# contraction (`ops/build.py::NVCC_FLAGS`) and is held bit for bit where it
# computes what its plain version does: K1, K2, K3, K5a and K5b. K4 is held
# bit for bit against K1 fed K5b's rows, and within the tolerance against
# its plain version (with the noise off, 0.0 and -0.0 differ in some
# envs).
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
# and negation count none. The kernels give an env to 4 lanes, which repeat
# the rotation, the rigid body and the epilogue; the bound counts an env's
# work once, whoever repeats it.
OPS_PER_ENV = 4 * 738 + 423
# One flat-ground substep (`substep.cuh::substep_flat`): 738, as above.
FLAT_SUBSTEP_OPS = 738
# One heightfield substep (`substep_hf.cuh::substep_hf`), counted the same
# way: the flat substep's rotation (39), steering servo (38) and rigid body
# (129) plus 4 wheels x 210 (the flat wheel's 129 plus 81: the patch query
# 39 — coordinates 6, floorf 2, fractions 2, bilinear height 12, gradient 9,
# normal 8 — then the terrain height in the penetration 1, the penetration
# rate along the normal 5, the tire frame projected on the contact plane 23,
# the 3-D slip velocities 4 and the normal in the force 9) plus 22 for the
# steered wheels' heading (16 flat, 6 for its z row).
HF_SUBSTEP_OPS = 39 + 38 + 129 + 4 * 210 + 22
# Of OPS_PER_ENV, the operations of the observation and info blocks, which
# the K-step rollout (K5a) does not compute: roll, pitch and yaw 18 + 16 + 18
# (their arguments 9, 4 and 9; atan2_approx 9, asin_approx 12), two
# world->body rotations 2 x 54, the last-action rows 2, noise on 12 rows 24,
# the slip metric 1.
OBS_OPS = 187
# Integer operations of the in-kernel generator per env: a Philox4x32-10
# call is 10 rounds of 2 wide and 2 low multiplies, 4 xors and 2 adds; each
# draw used is a shift, a mask, a convert and a multiply. K4 with noise on
# needs 10 calls and uses 34 draws, K5b 10 calls (the 40 draws fill them)
# and 40 draws. A Box-Muller normal is 6 float operations (log, sqrt, cos
# and 3 multiplies). They are counted at the float32 rate, the only rate
# outside the tensor cores that the bound's table holds; an env's work is
# counted once, not the calls the lanes of its group repeat.
K4_RNG_OPS = 10 * 100 + 34 * 4 + 12 * 6
K5B_OPS = 10 * 100 + 40 * 4 + 14 * 6
TIMING_WINDOW_S = 1.0
# Graph times of the kernels before their redesign, quoted from their
# earlier rows in PERF.md's table (NVIDIA H100 80GB HBM3, 700.00 W), not
# measured here: (kernel, envs) -> ms. The timing rows print them beside
# this run's times, which must be lower.
PREV_GRAPH_MS = {("K1", 1024): 0.0279, ("K1", 16384): 0.0287,
                 ("K3", 1024): 0.0762, ("K3", 16384): 0.0777,
                 ("K4", 1024): 0.0137, ("K4", 16384): 0.0200,
                 ("K5b", 4096): 0.00408, ("K5b", 16384): 0.00405}
# what each quoted time is
PREV_DESIGN = {
    "K1": "quoted from PERF.md: one thread per env",
    "K3": "quoted from PERF.md: one thread per env",
    "K4": "quoted from PERF.md: each lane of a group drew all of its env's "
          "rows for itself",
    "K5b": "quoted from PERF.md: one thread per env"}
# what ptxas says of a kernel that keeps its registers
NO_SPILLS = ", 0 bytes spill stores, 0 bytes spill loads"
# widths that leave a warp partly empty or a group count off a multiple of 8
TAIL_WIDTHS = (1000, 7, 1)
# POD_DRIFT_CONFIG's env batch: all of it on one rank, or a rank's half
POD_ENVS, POD_RANK_ENVS = 65536, 32768
K4_REPLACES = "wheeledlab_tpu/tasks/drift/fused.py:512"
K5A_REPLACES = "scripts/limiter_probe.py:80"
K5B_REPLACES = "scripts/check_kernel_rng.py:50"
K2_REPLACES = "wheeledlab_tpu/ops/pallas_substep.py:53"
K3_REPLACES = "wheeledlab_tpu/ops/pallas_substep_hf.py:60"


START = time.time()


def phase(name):
    """Heads a phase's output with the seconds since the script started, so
    a run's log shows what each phase costs."""
    print(f"=== {name} (at {time.time() - START:.1f} s)", flush=True)


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
    build.build_all(build.SOURCES)
    print(f"build_s {time.perf_counter() - t0:.2f} (all sources in "
          f"parallel)")
    registers = {}
    for name in build.SOURCES:
        build.load_library(name)
        for line in build.BUILD_LOGS.get(name, "").splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print(f"ptxas {name}:", line.strip())
            if "Used" in line and "registers" in line:
                registers[name] = line.split("ptxas info    :")[-1].strip()
            if "spill" in line and NO_SPILLS not in line:
                raise AssertionError(f"{name} spills registers: "
                                     f"{line.strip()}")
    return registers


def euler_quat(roll, pitch, yaw):
    """The (w, x, y, z) rows of the quaternions of numpy euler angles."""
    import numpy as np

    cr, sr = np.cos(roll / 2), np.sin(roll / 2)
    cp, sp = np.cos(pitch / 2), np.sin(pitch / 2)
    cy, sy = np.cos(yaw / 2), np.sin(yaw / 2)
    return [cy * cp * cr + sy * sp * sr, cy * cp * sr - sy * sp * cr,
            cy * sp * cr + sy * cp * sr, sy * cp * cr - cy * sp * sr]


def step_inputs(robot, b, seed, device, **task_kw):
    """Random but realistic inputs of one fused drift step, made with numpy
    from `seed`: states all over and beyond the track, DR'd params, step
    counts at the time limit and push timers about to fire. `task_kw`
    overrides fields of the task config (e.g. enable_corruption)."""
    import numpy as np
    import torch

    from wheeledlab_torch.tasks.drift.fused import (
        NUM_UNIFORM, OBS_ROWS, FusedDriftConsts,
    )
    from wheeledlab_torch.tasks.drift.task import (
        REWARD_TERMS, DriftTaskCfg, make_drift_task, reference_track_poses,
    )

    rng = np.random.default_rng(seed)
    task_cfg = DriftTaskCfg(num_envs=b, robot=robot, **task_kw)
    task = make_drift_task(task_cfg)
    cfg = FusedDriftConsts(task_cfg, task.cfg)
    gen = torch.Generator().manual_seed(seed)
    from wheeledlab_torch.sim.soa import pack_params

    params = pack_params(task.init_params(gen, b, "cpu"), 1.0)

    u = lambda lo, hi, *s: rng.uniform(lo, hi, s or (b,))
    quat = euler_quat(u(-0.1, 0.1), u(-0.1, 0.1), u(-math.pi, math.pi))
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


STEP_OUTPUTS = ("state", "obs", "out", "step_count", "timers", "ep_return",
                "ep_len")
MULTI_OUTPUTS = ("state", "step_count", "timers", "ep_return", "ep_len")


INT32_MIN = -2**31


class Agreement(NamedTuple):
    """Kernel outputs held against their plain version's, env by env."""
    max_err: float   # max |kernel - plain| over the float elements finite on
    #                  both sides: never NaN
    beyond: Any      # (B,) envs beyond FLOAT_TOL, not finite on either side,
    #                  or with an integer that differs
    differ: Any      # (B,) envs that differ in any bit
    report: list     # a line for each output that disagrees


class NotFinite(AssertionError):
    """A kernel output that is not finite; `agreement` holds the whole
    comparison, report included."""

    def __init__(self, agreement):
        super().__init__("kernel output not finite: "
                         + "; ".join(agreement.report))
        self.agreement = agreement


def bits(t):
    """`t`'s elements as int32 words: a float32's bit pattern, so that `==`
    compares bit for bit and a NaN equals its own bits."""
    import torch

    return t.contiguous().view(torch.int32) if t.dtype == torch.float32 else t


def compare_mask(got, want, names=STEP_OUTPUTS, exact=False,
                 sides=("kernel", "plain")):
    """Agreement of the outputs `got` (the kernel's) and `want` (the plain
    version's), each a sequence of (rows, B) tensors named by `names`, over
    every env: an env is beyond in an output where a float is beyond
    FLOAT_TOL of the plain value or is not finite on either side, or where
    an integer differs. The report has a line for each output with an env
    beyond (with `exact`, also an env that differs in any bit): its name,
    how many envs, the first of them and that env's column on both sides
    (named by `sides`). Raises `NotFinite` if a float of `got` is not
    finite; a non-finite plain value marks its env beyond."""
    import torch

    if len(got) != len(names) or len(want) != len(names):
        raise AssertionError(f"expected {len(names)} outputs")
    b = got[0].shape[1]
    beyond = torch.zeros(b, dtype=torch.bool, device=got[0].device)
    differ = torch.zeros_like(beyond)
    max_err, report, finite = 0.0, [], True
    for name, g, w in zip(names, got, want):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"{name}: {g.shape}/{g.dtype} vs "
                                 f"{w.shape}/{w.dtype}")
        off_bits = (bits(g) != bits(w)).any(0)
        if g.dtype == torch.int32:
            off, not_finite = off_bits, ""
        else:
            fin_g, fin_w = torch.isfinite(g), torch.isfinite(w)
            both = fin_g & fin_w
            err = torch.where(both, (g - w).abs(), 0.0)
            tol = FLOAT_TOL["atol"] + FLOAT_TOL["rtol"] * w.abs()
            off = ((err > tol) | ~both).any(0)
            max_err = max(max_err, err.max().item())
            bad_g = int((~fin_g).any(0).sum())
            bad_w = int((~fin_w).any(0).sum())
            finite &= bad_g == 0
            not_finite = (f"; not finite in {bad_g} envs ({sides[0]}), "
                          f"{bad_w} ({sides[1]})" if bad_g or bad_w else "")
        beyond |= off
        differ |= off_bits
        shown = off | off_bits if exact else off
        if shown.any():
            e = int(shown.nonzero()[0])
            report.append(
                f"{name}: {int(off.sum())} envs beyond tolerance, "
                f"{int(off_bits.sum())} not bit-equal{not_finite}; first env "
                f"{e}: {sides[0]} {g[:, e].tolist()}, {sides[1]} "
                f"{w[:, e].tolist()}")
    agreement = Agreement(max_err, beyond, differ, report)
    if not finite:
        raise NotFinite(agreement)
    return agreement


def compare_rows(got, want, name="rows", exact=False,
                 sides=("kernel", "plain")):
    """`compare_mask` of one (rows, B) output."""
    return compare_mask([got], [want], (name,), exact, sides)


def agreement(got, want, names, exact=False, sides=("kernel", "plain")):
    """`compare_mask`'s agreement, also where a kernel output is not finite
    (`NotFinite`): for a caller that reports every case before it fails."""
    try:
        return compare_mask(got, want, names, exact, sides)
    except NotFinite as e:
        return e.agreement


def as_tuple(outs):
    return outs if isinstance(outs, tuple) else (outs,)


def settle(outs):
    """Waits for the card when `outs` lie on it."""
    import torch

    if any(t.is_cuda for t in outs):
        torch.cuda.synchronize()


def repeat_sides(label, kernel, plain, got, want):
    """After a disagreement: launches the kernel and runs the plain version
    once more on the same inputs and prints whether each side repeated its
    first result bit for bit, so that a disagreement that does not recur
    names the side it came from. Returns the printed record."""
    again = as_tuple(kernel())
    settle(again)
    plain_again = as_tuple(plain())
    k_envs = envs_not_bit_equal(got, again)
    p_envs = envs_not_bit_equal(want, plain_again)
    record = {"check": "repeat after a disagreement", "case": label,
              "kernel_repeated_bit_for_bit": k_envs == 0,
              "kernel_envs_changed": k_envs,
              "plain_repeated_bit_for_bit": p_envs == 0,
              "plain_envs_changed": p_envs}
    print(json.dumps(record), flush=True)
    return record


class Held(NamedTuple):
    got: tuple
    want: tuple
    max_err: float
    beyond: int      # envs beyond FLOAT_TOL, not finite or integers off
    differ: int      # envs not bit-equal


def hold(label, kernel, plain, names, failures, exact=False):
    """Holds `kernel()`, a launch, against `plain()`, its plain version on
    the same inputs (each returns a (rows, B) tensor or a tuple of them,
    named by `names`): no env may be beyond (`compare_mask`) and, with
    `exact`, none may differ in any bit. On a disagreement it prints the
    report, repeats both sides (`repeat_sides`) and appends the case to
    `failures`."""
    got = as_tuple(kernel())
    settle(got)
    want = as_tuple(plain())
    a = agreement(got, want, names, exact)
    beyond, differ = int(a.beyond.sum()), int(a.differ.sum())
    if beyond or (exact and differ):
        for line in a.report:
            print(f"{label} {line}", flush=True)
        repeat_sides(label, kernel, plain, got, want)
        failures.append(f"{label}: {beyond} envs beyond tolerance, {differ} "
                        f"not bit-equal")
    return Held(got, want, a.max_err, beyond, differ)


def sentinel(dtype):
    """What a poisoned or guarded buffer holds where nothing was written:
    NaN in float32, the least int32 in int32."""
    import torch

    return {torch.float32: math.nan, torch.int32: INT32_MIN}[dtype]


def sentinel_buffer(shape, dtype, device, margin):
    """A new buffer of `shape`'s elements plus `margin` on each side, all
    at the sentinel: returns the contiguous view of `shape` in its middle
    (its `_base` is the whole buffer)."""
    import torch

    n = math.prod(shape)
    buf = torch.full((n + 2 * margin,), sentinel(dtype), dtype=dtype,
                     device=device)
    return buf[margin:margin + n].view(shape)


def guarded(t, margin):
    """`t` copied into the middle of a `sentinel_buffer` with `margin`
    elements on each side: a contiguous view equal to `t`, so that a read
    past either end of the block reads a sentinel."""
    view = sentinel_buffer(tuple(t.shape), t.dtype, t.device, margin)
    return view.copy_(t)


def margins_written(view):
    """Elements of the margins of `view`'s `sentinel_buffer` that no longer
    hold the sentinel's bits."""
    import torch

    buf = view._base
    start = view.storage_offset() - buf.storage_offset()
    edge = torch.cat([buf[:start], buf[start + view.numel():]])
    fill = torch.full_like(edge, sentinel(edge.dtype))
    return int((bits(edge) != bits(fill)).sum())


def at_sentinel(t):
    """Elements of `t` that hold its dtype's sentinel (a NaN of any bits in
    float32)."""
    import torch

    return int((torch.isnan(t) if t.dtype == torch.float32
                else t == INT32_MIN).sum())


@contextlib.contextmanager
def poisoned_allocations():
    """Within it, `torch.empty` and `torch.empty_like` of a float32 or int32
    tensor hand out a `sentinel_buffer` view with a margin of one row (the
    last dimension) on each side; yields the list of what they handed
    out."""
    import torch

    empty, empty_like = torch.empty, torch.empty_like
    made = []

    def poison(probe):
        if probe.dtype not in (torch.float32, torch.int32):
            return probe
        shape = tuple(probe.shape)
        view = sentinel_buffer(shape, probe.dtype, probe.device,
                               max(shape[-1:] or (1,)))
        made.append(view)
        return view

    def poisoned_empty(*size, **kw):
        if len(size) == 1 and not isinstance(size[0], int):
            size = tuple(size[0])
        t = empty(*size, **kw)
        return poison(t) if set(kw) <= {"dtype", "device"} else t

    def poisoned_empty_like(t, **kw):
        out = empty_like(t, **kw)
        return (poison(out) if set(kw) <= {"dtype", "device"}
                and out.is_contiguous() else out)

    torch.empty, torch.empty_like = poisoned_empty, poisoned_empty_like
    try:
        yield made
    finally:
        torch.empty, torch.empty_like = empty, empty_like


def poisoned(launch, ordinary):
    """Runs `launch()` within `poisoned_allocations` and holds its outputs
    against `ordinary`, the outputs of the same launch made without: returns
    the counts of elements left at the sentinel, margin elements written,
    outputs not handed out by the poisoned allocators and elements that
    differ from `ordinary` in any bit."""
    with poisoned_allocations() as made:
        outs = as_tuple(launch())
    settle(outs)
    ptrs = {m.data_ptr() for m in made}
    counts = dict(outputs=len(outs), sentinels_left=0, margins_written=0,
                  not_poisoned=0, not_bit_equal=0)
    for out, want in zip(outs, as_tuple(ordinary)):
        if out.data_ptr() not in ptrs:
            counts["not_poisoned"] += 1
            continue
        counts["sentinels_left"] += at_sentinel(out)
        counts["margins_written"] += margins_written(out)
        counts["not_bit_equal"] += (int((bits(out) != bits(want)).sum())
                                    if out.shape == want.shape
                                    else out.numel())
    return counts


def kernel_phase(device):
    """K1 against its plain version. Every case is checked and printed
    before a disagreement raises."""
    phase("kernel")
    print(f"tolerance |kernel - plain| <= {FLOAT_TOL['atol']} + "
          f"{FLOAT_TOL['rtol']} |plain|, both finite; integers exact; no env "
          f"beyond", flush=True)
    max_err, cases, failures = 0.0, {}, []
    for robot in ("mushr", "f1tenth"):
        for b in (POD_ENVS, POD_RANK_ENVS, 16384, 1024) + TAIL_WIDTHS:
            cfg, x = step_inputs(robot, b, seed=b + len(robot), device=device)
            max_err = max(max_err, k1_case(f"K1 {robot} B={b}", cfg, x,
                                           failures))
            cases[(robot, b)] = (cfg, x)
        b = 1024
        cfg, x = cases[(robot, b)]
        standing = standing_drift_inputs(x, b, robot)
        max_err = max(max_err, k1_case(f"K1 {robot} B={b}, standing start",
                                       cfg, standing, failures, False))
        cases[(robot, b, "standing")] = (cfg, standing)
    if failures:
        raise AssertionError("; ".join(failures))
    return max_err, cases


def k1_case(label, cfg, x, failures, moving=True):
    """K1 against its plain version on `x`; prints the case and returns its
    max error. `moving` inputs of 1000 envs or more must fire a reset and a
    time-out."""
    h = hold(label, lambda: kernel_step(cfg, x), lambda: plain_step(cfg, x),
             STEP_OUTPUTS, failures, exact=True)
    b = x["state"].shape[1]
    resets = int(h.want[2][1].sum())
    print(f"{label}: max_abs_err {h.max_err:.3e}, envs beyond tolerance "
          f"{h.beyond}, envs not bit-equal {h.differ}, resets {resets}",
          flush=True)
    if moving and b >= 1000 and (resets == 0
                                 or int(h.want[2][2].sum()) == 0):
        raise AssertionError("inputs fired no reset or time-out")
    return h.max_err


def flat_inputs(robot, b, seed, device):
    """Inputs of one flat physics step (K2): the states, DR'd params and
    policy actions of `step_inputs`, mapped to joint targets by the robot's
    action map."""
    from wheeledlab_torch.assets.robots import (
        F1TENTH_4WD_ACTION, MUSHR_RWD_ACTION,
    )
    from wheeledlab_torch.sim.actions import action_to_targets

    _, x = step_inputs(robot, b, seed, device)
    action = {"mushr": MUSHR_RWD_ACTION, "f1tenth": F1TENTH_4WD_ACTION}[robot]
    steer_t, wheel_t = action_to_targets(x["action_rows"].T, action)
    return dict(state=x["state"], params=x["params"],
                steer_t=steer_t.T.contiguous(),
                wheel_t=wheel_t.T.contiguous())


def hf_inputs(b, seed, device, p=None):
    """Inputs of one heightfield physics step (K3) at the elevation task's
    constants, made with numpy from `seed`: states over the mounds of a
    generated terrain, from wheels pressed into the ground to airborne,
    tilted and moving; DR'd params; the patches and origins that
    `PatchAtlas.extract_rows` gives for those positions, from the task's
    contact atlas (p = 12) or, with `p`, from an atlas of (p, p) patches of
    the same terrain. Returns (consts, inputs, envs with a wheel in contact,
    envs with none)."""
    import numpy as np
    import torch

    from wheeledlab_torch.sim.actions import action_to_targets
    from wheeledlab_torch.sim.soa import pack_params
    from wheeledlab_torch.tasks.elevation.task import (
        REST_H, ElevationTaskCfg, make_elevation_task,
    )
    from wheeledlab_torch.utils import math as wmath

    rng = np.random.default_rng(seed)
    task = make_elevation_task(ElevationTaskCfg(num_envs=b), device)
    atlas = (task.contact_atlas if p is None
             else task.terrain.build_atlas(p=p, stride=2))
    gen = torch.Generator(device=device).manual_seed(seed)
    params = pack_params(task.init_params(gen, b, device),
                         task.terrain.friction)
    f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=device)
    u = lambda lo, hi, *shape: rng.uniform(lo, hi, shape or (b,))
    xy = f32(u(-19, 19, b, 2))
    ground = atlas.lookup(xy).cpu().numpy()
    quat = euler_quat(u(-0.3, 0.3), u(-0.3, 0.3), u(-math.pi, math.pi))
    state = f32(np.stack([
        xy[:, 0].cpu().numpy(), xy[:, 1].cpu().numpy(),
        ground + REST_H + u(-0.03, 0.12), *quat,
        u(-3, 3), u(-3, 3), u(-0.5, 0.5), u(-1, 1), u(-1, 1), u(-3, 3),
        *u(-10, 80, 4, b), *u(-0.5, 0.5, 2, b), *u(-2, 2, 2, b)]))
    patch, org = atlas.extract_rows(state[0], state[1])
    steer_t, wheel_t = action_to_targets(f32(rng.normal(0, 1, (b, 2))),
                                         task.cfg.action)
    # wheels in contact at the start: terrain height + radius above the
    # wheel center
    rot = wmath.matrix_from_quat(state[3:7].T)                 # (B, 3, 3)
    wheel_b = params[6:18].T.reshape(b, 4, 3)
    centers = state[0:3].T[:, None] + torch.einsum("bij,bwj->bwi", rot,
                                                   wheel_b)
    under = atlas.lookup(centers[..., :2].reshape(-1, 2)).reshape(b, 4)
    touching = (under + params[5][:, None] - centers[..., 2] > 0).any(1)
    nx, ny = atlas.grid_shape
    consts = dict(dt=task.cfg.sim_dt, decimation=task.cfg.decimation,
                  p=atlas.p, nx=nx, ny=ny, cell=atlas.cell)
    inputs = dict(state=state, params=params, patch=patch, org=org,
                  steer_t=steer_t.T.contiguous(),
                  wheel_t=wheel_t.T.contiguous())
    n_touch = int(touching.sum())
    return consts, inputs, n_touch, b - n_touch


def standing_drift_inputs(x, b, robot="mushr"):
    """`x` with the state an env starts from: every car standing on the
    track, counters at zero, as `make_drift_env(...).reset()` gives them."""
    from wheeledlab_torch.tasks.drift.task import DriftTaskCfg, make_drift_env

    env = make_drift_env(DriftTaskCfg(num_envs=b, robot=robot),
                         device="cuda", seed=0)
    state, _ = env.reset()
    return {**x, "state": state.vehicle_mem, "params": state.packed_params,
            "step_count": state.step_count[None],
            "timers": state.push_timers,
            "ep_return": state.ep_return[None],
            "ep_len": state.ep_len[None]}


def standing_hf_inputs(b):
    """K3's inputs for cars at rest on the terrain: the state an elevation
    env starts from, its contact patches, and zero joint targets. Returns
    (consts, inputs)."""
    import torch

    from wheeledlab_torch.tasks.elevation.task import (
        ElevationTaskCfg, make_elevation_env,
    )

    env = make_elevation_env(ElevationTaskCfg(num_envs=b), device="cuda",
                             seed=0)
    state, _ = env.reset()
    mem = state.vehicle_mem
    atlas = env.task.contact_atlas
    patch, org = atlas.extract_rows(mem[0], mem[1])
    nx, ny = atlas.grid_shape
    consts = dict(dt=env.cfg.sim_dt, decimation=env.cfg.decimation,
                  p=atlas.p, nx=nx, ny=ny, cell=atlas.cell)
    inputs = dict(state=mem, params=state.packed_params, patch=patch, org=org,
                  steer_t=torch.zeros((2, b), device="cuda"),
                  wheel_t=torch.zeros((4, b), device="cuda"))
    return consts, inputs


def physics_phase(device):
    """K2 and K3 against their plain versions. Every case is checked and
    printed before a disagreement raises."""
    from wheeledlab_torch.ops.physics_step import (
        physics_step, physics_step_rows,
    )
    from wheeledlab_torch.ops.physics_step_hf import (
        MAX_P, physics_step_hf, physics_step_hf_rows,
    )

    phase("kernel (K2, K3)")
    errs = {"K2": 0.0, "K3": 0.0}
    cases, failures = {}, []
    for robot in ("mushr", "f1tenth"):
        for b in (16384, 1024, 1000, 16):
            x = flat_inputs(robot, b, seed=7 * b + len(robot), device=device)
            for dec in (4, 20):
                k = dict(dt=0.005, decimation=dec)
                label = f"K2 {robot} B={b} decimation {dec}"
                h = hold(label, lambda: physics_step(**x, **k),
                         lambda: physics_step_rows(**x, **k), ("state",),
                         failures, exact=True)
                print(f"{label}: max_abs_err {h.max_err:.3e}, envs beyond "
                      f"tolerance {h.beyond}, envs not bit-equal "
                      f"{h.differ}", flush=True)
                errs["K2"] = max(errs["K2"], h.max_err)
                cases[("K2", robot, b, dec)] = (x, k)
    # K3 is built without FMA contraction and must equal its plain version
    # bit for bit: p = 12 at every width; at 1024 envs p = 30, where the
    # launcher opts in to shared memory, and the largest patch that fits;
    # and cars at rest on the terrain
    hf_cases = [(("K3", b), *hf_inputs(b, seed=b, device=device))
                for b in (16384, 1024) + TAIL_WIDTHS]
    for p in (30, MAX_P):
        hf_cases.append((("K3", 1024, f"p{p}"),
                         *hf_inputs(1024, seed=p, device=device, p=p)))
    hf_cases.append((("K3", 1024, "standing"), *standing_hf_inputs(1024),
                     None, None))
    for key, k, x, touch, air in hf_cases:
        b = key[1]
        if touch is not None and b >= 1000 and (touch == 0 or air == 0):
            raise AssertionError(f"K3 inputs: {touch} envs touch the "
                                 f"ground, {air} do not; need both")
        label = (f"K3 {' '.join(map(str, key[1:]))} decimation "
                 f"{k['decimation']} p={k['p']}")
        h = hold(label, lambda: physics_step_hf(**x, **k),
                 lambda: physics_step_hf_rows(**x, **k), ("state",),
                 failures, exact=True)
        print(f"{label}: max_abs_err {h.max_err:.3e}, envs beyond tolerance "
              f"{h.beyond}, envs not bit-equal {h.differ}"
              + ("" if touch is None else f"; {touch} envs start with a "
                 f"wheel in contact, {air} airborne"), flush=True)
        errs["K3"] = max(errs["K3"], h.max_err)
        cases[key] = (x, k)
    if failures:
        raise AssertionError("; ".join(failures))
    return errs, cases


PHYSICS_BENCH_ARGS = ("--num-envs", "16384", "--rollout", "32",
                      "--min-wall", "0.5")


def vehicle_params(task, gen, b, packed):
    """The batched VehicleParams that `task.init_params` draws from `gen`
    (a generator seeded as the one that drew `packed`), on `packed`'s
    device; raises unless they pack to `packed` bit for bit."""
    import dataclasses

    import torch

    from wheeledlab_torch.sim.soa import pack_params
    from wheeledlab_torch.sim.types import VehicleParams

    vp = task.init_params(gen, b, gen.device)
    vp = VehicleParams(**{f.name: getattr(vp, f.name).to(packed.device)
                          for f in dataclasses.fields(vp)})
    if not torch.equal(pack_params(vp, task.terrain.friction), packed):
        raise AssertionError("the redrawn params differ from the inputs'")
    return vp


def per_vehicle_phase(device, phys_cases):
    """The per-vehicle physics (`sim/dynamics.py`, `use_kernels="off"`) on
    the card: against K2 (1024 and 16384 envs, both robots, decimation 4)
    and K3 (1024 envs, decimation 10, p = 12; through each env's atlas
    patch and on the full grid), every env within FLOAT_TOL; the drift env
    at use_kernels="off" against its K1 route (1024 envs, 8 steps from one
    state, the reference's fused-against-XLA tolerances); 16 steps of the
    elevation env without its atlases (finite, no kernel launched); the
    native host library (must load) against numpy map generation at the
    visual map's size; and `scripts.physics_bench` at 16384 envs in a
    subprocess. Returns the numbers for the kernels line."""
    import torch

    from wheeledlab_torch import native
    from wheeledlab_torch.envs.env import WheeledEnv
    from wheeledlab_torch.ops.physics_step import physics_step
    from wheeledlab_torch.ops.physics_step_hf import physics_step_hf
    from wheeledlab_torch.sim import dynamics
    from wheeledlab_torch.sim.soa import pack_params, pack_state, unpack_state
    from wheeledlab_torch.tasks import make_env
    from wheeledlab_torch.tasks.drift.task import DriftTaskCfg, make_drift_task
    from wheeledlab_torch.tasks.elevation.task import (
        ElevationTaskCfg, make_elevation_env, make_elevation_task,
    )
    from wheeledlab_torch.tasks.visual.map_gen import (
        generate_traversability_map,
    )
    from wheeledlab_torch.tasks.visual.task import VisualTaskCfg

    phase("per-vehicle physics")
    t_phase = time.perf_counter()
    res, failures = {}, []

    def agree(name, got_rows, want_rows):
        a = compare_rows(got_rows, want_rows, "state",
                         sides=("per-vehicle", "kernel"))
        bad, differ = int(a.beyond.sum()), int(a.differ.sum())
        print(f"{name}: max_abs_err {a.max_err:.3e}, envs beyond tolerance "
              f"{bad}, envs not bit-equal {differ}", flush=True)
        if bad:
            print("\n".join(f"{name} {line}" for line in a.report),
                  flush=True)
            failures.append(f"{name}: {bad} envs beyond tolerance")
        return a.max_err

    # against K2: the same states, params and joint targets
    res["vs_k2_max_abs_err"] = 0.0
    for robot in ("mushr", "f1tenth"):
        for b in (1024, 16384):
            x, k = phys_cases[("K2", robot, b, 4)]
            task = make_drift_task(DriftTaskCfg(num_envs=b, robot=robot))
            vp = vehicle_params(
                task, torch.Generator().manual_seed(7 * b + len(robot)), b,
                x["params"])
            got, aux = dynamics.step(
                unpack_state(x["state"]), vp, task.terrain, x["steer_t"].T,
                x["wheel_t"].T, k["dt"], k["decimation"])
            want = physics_step(**x, **k)
            torch.cuda.synchronize()
            err = agree(f"per-vehicle vs K2 {robot} B={b} decimation 4",
                        pack_state(got), want)
            res["vs_k2_max_abs_err"] = max(res["vs_k2_max_abs_err"], err)

    # against K3: the elevation task's terrain, its contact atlas (p = 12)
    x, k = phys_cases[("K3", 1024)]
    task = make_elevation_task(ElevationTaskCfg(num_envs=1024), device)
    patch, org = task.contact_atlas.extract_rows(x["state"][0], x["state"][1])
    if not (torch.equal(patch, x["patch"]) and torch.equal(org, x["org"])):
        raise AssertionError("K3 inputs: another terrain")
    vp = vehicle_params(
        task, torch.Generator(device=device).manual_seed(1024), 1024,
        x["params"])
    want = physics_step_hf(**x, **k)
    for contact, atlas in (("atlas patch", task.contact_atlas),
                           ("full grid", None)):
        got, aux = dynamics.step(
            unpack_state(x["state"]), vp, task.terrain, x["steer_t"].T,
            x["wheel_t"].T, k["dt"], k["decimation"], atlas)
        torch.cuda.synchronize()
        touching = int(aux.contact.any(1).sum())
        res[f"vs_k3_{contact.split()[0]}_max_abs_err"] = agree(
            f"per-vehicle vs K3 B=1024 decimation {k['decimation']} "
            f"p={k['p']}, {contact} ({touching} envs end with a wheel in "
            f"contact)", pack_state(got), want)

    # the drift env: use_kernels="off" against the K1 route
    kw = dict(events_enabled=False, enable_corruption=False)
    envs = {route: make_env("MushrDriftRL-v0", num_envs=1024, device=device,
                            overrides=kw, use_kernels=route)
            for route in ("auto", "off")}
    (sk, _), (so, _) = envs["auto"].reset(), envs["off"].reset()
    if not (torch.equal(sk.vehicle_mem, pack_state(so.vehicle_mem))
            and torch.equal(sk.packed_params, pack_params(
                so.params, envs["off"].task.terrain.friction))):
        raise AssertionError("the two routes reset to different states")
    alive = torch.ones(1024, dtype=torch.bool, device=device)
    errs = dict(pos=0.0, lin_vel=0.0, reward=0.0, obs=0.0)
    tols = dict(pos=1e-3, lin_vel=5e-3, reward=3e-2, obs=1e-2)
    reset_launches()
    for t in range(8):
        a = torch.stack([torch.full((1024,), 0.6, device=device),
                         torch.full((1024,), 0.4 * math.sin(0.7 * t),
                                    device=device)], -1)
        sk, ok = envs["auto"].step(sk, a)
        so, oo = envs["off"].step(so, a)
        if not torch.equal(ok.done[alive], oo.done[alive]):
            failures.append(f"off route vs K1: done differs at step {t}")
        alive &= ~ok.done
        for name, g, w in (("pos", so.vehicle.pos, sk.vehicle.pos),
                           ("lin_vel", so.vehicle.lin_vel,
                            sk.vehicle.lin_vel),
                           ("reward", oo.reward, ok.reward),
                           ("obs", oo.obs, ok.obs)):
            e = (g - w)[alive].abs().max().item()
            errs[name] = max(errs[name], e)
            if not e <= tols[name]:
                failures.append(f"off route vs K1: {name} {e:.3e} at step "
                                f"{t}")
    launches = read_launches()
    print(f"drift env, use_kernels=off vs K1, 1024 envs, 8 steps: max |d| "
          f"{errs} (tolerances {tols}); {int(alive.sum())} envs never "
          f"reset; launches {launches}", flush=True)
    if launches != {**NO_LAUNCHES, "K1": 8}:
        failures.append(f"off route vs K1: launches {launches}")
    if int(alive.sum()) < 512:
        failures.append("off route vs K1: too many resets")
    res["off_vs_k1_max_abs_d"] = errs

    # the elevation env without its atlases: per-vehicle physics on the grid
    env = make_elevation_env(ElevationTaskCfg(num_envs=1024), device=device)
    env = WheeledEnv(env.task._replace(terrain_atlas=None, contact_atlas=None),
                     device=device)
    state, obs = env.reset()
    gen = torch.Generator(device=device).manual_seed(5)
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(16):
        state, out = env.step(state, torch.rand((1024, 2), generator=gen,
                                                device=device) * 2 - 1)
    finite = bool(torch.isfinite(out.obs).all() and torch.isfinite(
        out.reward).all() and torch.isfinite(state.vehicle.pos).all())
    step_ms = 1000 * (time.perf_counter() - t0) / 16
    launches = read_launches()
    print(f"elevation without atlases, 1024 envs, 16 steps: finite "
          f"{finite}, {step_ms:.2f} ms a step, launches {launches}",
          flush=True)
    if not (env.per_vehicle and finite and launches == NO_LAUNCHES):
        failures.append("atlas-free elevation run")
    res["atlas_free_elevation_step_ms"] = step_ms

    # the native host library: it must load
    if not native.available():
        raise AssertionError("the native host library did not load")
    vcfg = VisualTaskCfg()
    map_kw = dict(map_size=(vcfg.map_rows, vcfg.map_cols),
                  env_size=(vcfg.env_rows, vcfg.env_cols),
                  sub_group_size=(vcfg.group_rows, vcfg.group_cols),
                  num_walkers=vcfg.num_walkers)
    map_ms = {}
    for backend in ("native", "numpy"):
        t0 = time.perf_counter()
        grid = generate_traversability_map(vcfg.seed, backend=backend,
                                           **map_kw)
        map_ms[backend] = 1000 * (time.perf_counter() - t0)
        if grid.shape != map_kw["map_size"] or not 0.02 < grid.mean() < 0.9:
            failures.append(f"{backend} map {grid.shape} {grid.mean()}")
    print(f"visual map {map_kw['map_size']}: native {map_ms['native']:.2f} "
          f"ms, numpy {map_ms['numpy']:.2f} ms (host)", flush=True)
    res["map_gen_ms"] = map_ms

    # physics_bench at 16384 envs, in a process of its own
    (out,) = run_group([[sys.executable, "-m",
                         "wheeledlab_torch.scripts.physics_bench",
                         *PHYSICS_BENCH_ARGS]])
    rows = [json.loads(line) for line in out.strip().splitlines()
            if line.startswith("{")]
    if [r["metric"] for r in rows] != ["raw_physics", "physics_soa",
                                       "env_step_off", "env_step_kernel"]:
        raise AssertionError(f"physics_bench printed:\n{out[-4000:]}")
    for r in rows:
        print(json.dumps(r), flush=True)
        # only the kernel route may launch a kernel, and it must
        on_k1 = r["metric"] == "env_step_kernel"
        if not r["value"] > 0 or (r["kernel_launches"] > 0) != on_k1:
            failures.append(f"physics_bench row {r}")
    res["physics_bench"] = {r["metric"]: r["value"] for r in rows}
    print(f"per-vehicle phase {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    if failures:
        raise AssertionError("; ".join(failures))
    return res


def envs_not_bit_equal(got, want):
    """Number of envs in which any output differs in any bit."""
    import torch

    bad = torch.zeros(got[0].shape[1], dtype=torch.bool, device=got[0].device)
    for g, w in zip(got, want):
        bad |= (bits(g) != bits(w)).any(0)
    return int(bad.sum())


def without_rows(x):
    return {k: v for k, v in x.items() if k not in ("uniforms", "normals")}


def plain_step_krng(cfg, x, seed):
    """The plain version of K4: the Philox rows, then the plain step."""
    from wheeledlab_torch.ops.kernel_rng import philox_blocks

    b = x["state"].shape[1]
    uniforms, normals = philox_blocks(seed, b, cfg.enable_corruption)
    return plain_step(cfg, {**x, "uniforms": uniforms, "normals": normals})


def multi_inputs(x, k, seed):
    """The inputs of `k` chained steps: `step_inputs`' state, params and
    counters with `k` stacked blocks of actions, uniforms and normals made
    with numpy from `seed`."""
    import numpy as np
    import torch

    from wheeledlab_torch.tasks.drift.fused import NUM_UNIFORM, OBS_ROWS

    rng = np.random.default_rng(seed)
    b = x["state"].shape[1]
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32),
                                    device=x["state"].device)
    y = {n: v for n, v in without_rows(x).items() if n != "action_rows"}
    y["actions"] = f32(rng.normal(0, 1, (2 * k, b)))
    y["uniforms"] = f32(rng.random((NUM_UNIFORM * k, b)))
    y["normals"] = f32(rng.standard_normal((OBS_ROWS * k, b)))
    return y


def chained_k1(cfg, y, k):
    """`k` launches of K1 on the rows that step i of K5a reads, state and
    counters chained through; returns K5a's five outputs."""
    from wheeledlab_torch.tasks.drift.fused import (
        NUM_UNIFORM, OBS_ROWS, fused_drift_step,
    )

    x = {n: y[n] for n in ("weights", "poses", "state", "params",
                           "step_count", "timers", "ep_return", "ep_len")}
    for i in range(k):
        res = fused_drift_step(
            cfg=cfg, action_rows=y["actions"][2 * i:2 * i + 2],
            uniforms=y["uniforms"][NUM_UNIFORM * i:NUM_UNIFORM * (i + 1)],
            normals=y["normals"][OBS_ROWS * i:OBS_ROWS * (i + 1)], **x)
        x.update(state=res[0], step_count=res[3], timers=res[4],
                 ep_return=res[5], ep_len=res[6])
    return tuple(x[n] for n in MULTI_OUTPUTS)


def rng_kernel_phase(device, cases):
    """K5b, K4 and K5a against their plain versions, and against K1 where
    the two kernels must compute the same thing. Every case is checked and
    printed before a disagreement raises."""
    import torch

    from wheeledlab_torch.ops.kernel_rng import philox_blocks, rng_blocks
    from wheeledlab_torch.ops.multi_step import multi_step, multi_step_rows
    from wheeledlab_torch.parallel.mesh import int32_shard_offset
    from wheeledlab_torch.tasks.drift.fused import fused_drift_step_krng

    phase("kernel (K4, K5a, K5b)")
    errs = {"K4": 0.0, "K5a": 0.0, "K5b": 0.0}
    kept, failures = {}, []

    # K5b: the uniform words and the normals bit for bit
    for b in (4096, 1000, 16, 7, 1):
        for s in (1234, 99):
            seed = torch.tensor([s], dtype=torch.int32, device=device)
            label = f"K5b B={b} seed {s}"
            kernel = lambda: rng_blocks(seed, b)
            plain = lambda: philox_blocks(seed, b)
            h = hold(label, kernel, plain, ("uniforms", "normals"), failures,
                     exact=True)
            print(f"{label}: max_abs_err {h.max_err:.3e}, envs beyond "
                  f"tolerance {h.beyond}, envs not bit-equal {h.differ}",
                  flush=True)
            errs["K5b"] = max(errs["K5b"], h.max_err)
            kept[("K5b", b)] = seed

    # K4: against Philox rows + the plain step, and against K1 fed K5b's rows
    def k4_case(robot, b, noise, cfg, x, seed, label=""):
        z = without_rows(x)
        label = f"K4 {robot} B={b} noise {noise}{label}"
        kernel = lambda: fused_drift_step_krng(cfg=cfg, seed=seed, **z)
        h = hold(label, kernel, lambda: plain_step_krng(cfg, x, seed),
                 STEP_OUTPUTS, failures)

        def via_k1():
            uniforms, normals = rng_blocks(seed, b)
            return kernel_step(cfg, {**z, "uniforms": uniforms,
                                     "normals": normals})

        by_k1 = via_k1()
        differ = envs_not_bit_equal(h.got, by_k1)
        resets = int(h.want[2][1].sum())
        print(f"{label}: max_abs_err {h.max_err:.3e}, envs beyond tolerance "
              f"{h.beyond}, envs not bit-equal {h.differ}, resets {resets}; "
              f"envs not bit-equal to K1 fed "
              f"K5b's rows {differ}", flush=True)
        errs["K4"] = max(errs["K4"], h.max_err)
        if differ:
            a = agreement(h.got, by_k1, STEP_OUTPUTS, exact=True,
                          sides=("K4", "K1 fed K5b's rows"))
            print("\n".join(f"{label} {line}" for line in a.report),
                  flush=True)
            repeat_sides(label + " against K1", kernel, via_k1, h.got, by_k1)
            failures.append(f"{label}: {differ} envs not equal to K1's")
        if b >= 1000 and (resets == 0 or int(h.want[2][2].sum()) == 0):
            raise AssertionError("inputs fired no reset or time-out")
        return z

    for robot in ("mushr", "f1tenth"):
        for b in (16384, 1024) + TAIL_WIDTHS:
            for noise in (True, False):
                if noise:
                    cfg, x = cases[(robot, b)]
                else:
                    cfg, x = step_inputs(robot, b, seed=b + len(robot),
                                         device=device,
                                         enable_corruption=False)
                seed = torch.tensor([b + 7 * noise], dtype=torch.int32,
                                    device=device)
                z = k4_case(robot, b, noise, cfg, x, seed)
                kept[("K4", robot, b, noise)] = (cfg, z, seed)
    # a rank's width of the 2-rank POD job, on the seed rank 1's env hands
    # the kernel for a drawn seed near the top of int32: the drawn seed plus
    # 0x3779B1, wrapped
    drawn = torch.tensor([2**31 - 2], dtype=torch.int32, device=device)
    seed = drawn + int32_shard_offset(1)
    if int(seed) != int32_shard_offset(1) - 2**31 - 2:
        raise AssertionError(f"rank 1's seed {int(seed)} did not wrap")
    cfg, x = cases[("mushr", POD_RANK_ENVS)]
    z = k4_case("mushr", POD_RANK_ENVS, True, cfg, x, seed,
                f", rank 1's seed {int(seed)}")
    kept[("K4", "mushr", POD_RANK_ENVS, True)] = (cfg, z, seed)

    # K5a: against K chained plain steps and against K chained K1 launches,
    # bit for bit: the three compute the same step in the same order
    for robot in ("mushr", "f1tenth"):
        for b in (16384, 1024, 1000):
            cfg, x = cases[(robot, b)]
            for k in (1, 2, 4, 8):
                y = multi_inputs(x, k, seed=100 * k + b)
                label = f"K5a {robot} B={b} K={k}"
                kernel = lambda: multi_step(cfg=cfg, k=k, **y)
                h = hold(label, kernel,
                         lambda: multi_step_rows(cfg=cfg, k=k, **y),
                         MULTI_OUTPUTS, failures, exact=True)
                chain = chained_k1(cfg, y, k)
                off_chain = envs_not_bit_equal(h.got, chain)
                print(f"{label}: max_abs_err {h.max_err:.3e}, envs beyond "
                      f"tolerance {h.beyond}, envs not bit-equal {h.differ}; "
                      f"envs not bit-equal to {k} chained K1 launches "
                      f"{off_chain}", flush=True)
                errs["K5a"] = max(errs["K5a"], h.max_err)
                if off_chain:
                    a = agreement(h.got, chain, MULTI_OUTPUTS, exact=True,
                                  sides=("K5a", "K1 chain"))
                    print("\n".join(f"{label} {line}" for line in a.report),
                          flush=True)
                    repeat_sides(label + " against the K1 chain", kernel,
                                 lambda: chained_k1(cfg, y, k), h.got, chain)
                    failures.append(f"{label}: {off_chain} envs not equal to "
                                    f"the K1 chain's")
                kept[("K5a", robot, b, k)] = (cfg, y)
    if failures:
        raise AssertionError("; ".join(failures))
    return errs, kept


# launches of the repeat check at the width each kernel takes on the main
# path's largest configuration: POD_DRIFT_CONFIG on one rank (K1), a rank's
# half of it (K4), bench.py's 16384 envs (K3)
REPEATS = {"K1": 64, "K4": 32, "K3": 32}
PLAIN_REPEATS = 4
# K1 against its plain version at POD_ENVS: the kernel phase's seed and
# these more
EXTRA_SEEDS = 6
# the widths of the guard-band check: the training width and the largest
GUARD_WIDTHS = {"K1": (1024, POD_ENVS), "K4": (1024, POD_RANK_ENVS),
                "K3": (1024, 16384)}


def kernel_cases(cases, phys_cases, kept, vis_cases):
    """Every case of the kernel phases as (kernel, label, envs, launch,
    inputs), where `launch(**inputs)` calls the kernel's wrapper."""
    import functools

    from wheeledlab_torch.ops.kernel_rng import rng_blocks
    from wheeledlab_torch.ops.multi_step import multi_step
    from wheeledlab_torch.ops.physics_step import physics_step
    from wheeledlab_torch.ops.physics_step_hf import physics_step_hf
    from wheeledlab_torch.tasks.drift.fused import (
        fused_drift_step, fused_drift_step_krng,
    )

    out = []
    for key, (cfg, x) in cases.items():
        out.append(("K1", key, x["state"].shape[1],
                    functools.partial(fused_drift_step, cfg=cfg), x))
    for key, (x, k) in phys_cases.items():
        call = physics_step if key[0] == "K2" else physics_step_hf
        out.append((key[0], key[1:], x["state"].shape[1],
                    functools.partial(call, **k), x))
    for b, (x, k) in vis_cases.items():
        out.append(("K2", ("visual", b), b,
                    functools.partial(physics_step, **k), x))
    for key, v in kept.items():
        if key[0] == "K4":
            cfg, z, seed = v
            out.append(("K4", key[1:], key[2], functools.partial(
                fused_drift_step_krng, cfg=cfg), {**z, "seed": seed}))
        elif key[0] == "K5a":
            cfg, y = v
            out.append(("K5a", key[1:], key[2], functools.partial(
                multi_step, cfg=cfg, k=key[3]), y))
        else:
            out.append(("K5b", key[1:], key[1], functools.partial(
                rng_blocks, b=key[1]), {"seed": v}))
    return out


def integrity_phase(device, card, cases, phys_cases, kept, vis_cases):
    """What an intermittent disagreement between a kernel and its plain
    version could come from, looked for on purpose: an output element the
    kernel leaves unwritten or a write past an output's end (poisoned
    outputs, every case of the kernel phases), a read past either end of an
    input block or a write into one (guard bands, K1, K3, K4 at their
    widths in GUARD_WIDTHS), a kernel or a plain version that does not
    repeat itself (REPEATS launches of K1, K4 and K3 at their largest
    width; the plain drift step PLAIN_REPEATS times at POD_ENVS), and K1's
    inputs at POD_ENVS on EXTRA_SEEDS more seeds a robot. One JSON line a
    check with its counts; every check runs before a fault raises. Returns
    K1's max error on the extra seeds."""
    import functools

    import torch

    from wheeledlab_torch.ops.physics_step_hf import physics_step_hf
    from wheeledlab_torch.tasks.drift.fused import (
        fused_drift_step, fused_drift_step_krng,
    )

    phase("kernel integrity (poisoned outputs, guard bands, repeats, seeds)")
    t_phase = time.perf_counter()
    every = kernel_cases(cases, phys_cases, kept, vis_cases)
    failures = []

    # poisoned outputs: every output element must be written, and only they
    totals = dict(outputs=0, sentinels_left=0, margins_written=0,
                  not_poisoned=0, not_bit_equal=0)
    per_kernel = {}
    for kernel, label, b, launch, x in every:
        ordinary = as_tuple(launch(**x))
        counts = poisoned(lambda: launch(**x), ordinary)
        per_kernel[kernel] = per_kernel.get(kernel, 0) + 1
        for key, n in counts.items():
            totals[key] += n
        if any(n for key, n in counts.items() if key != "outputs"):
            failures.append(f"poisoned {kernel} {label}: {counts}")
    print(json.dumps({"check": "poisoned outputs", "cases": per_kernel,
                      **totals, "card": card}), flush=True)

    # guard bands: each input block in the middle of a buffer with a row of
    # sentinels on each side
    guard = dict(cases={}, inputs=0, margins_written=0, inputs_changed=0,
                 not_bit_equal=0)
    for kernel, label, b, launch, x in every:
        if b not in GUARD_WIDTHS.get(kernel, ()):
            continue
        ordinary = as_tuple(launch(**x))
        g = {n: guarded(v, b) for n, v in x.items()}
        outs = as_tuple(launch(**g))
        settle(outs)
        written = sum(margins_written(v) for v in g.values())
        changed = sum(int((bits(g[n]) != bits(v)).sum())
                      for n, v in x.items())
        off = sum(int((bits(o) != bits(w)).sum())
                  for o, w in zip(outs, ordinary))
        guard["cases"][kernel] = guard["cases"].get(kernel, 0) + 1
        guard["inputs"] += len(g)
        guard["margins_written"] += written
        guard["inputs_changed"] += changed
        guard["not_bit_equal"] += off
        if written or changed or off:
            failures.append(f"guarded {kernel} {label}: {written} margin "
                            f"elements written, {changed} input elements "
                            f"changed, {off} output elements off")
    print(json.dumps({"check": "guard bands", **guard,
                      "widths": GUARD_WIDTHS, "card": card}), flush=True)

    # repeats: the same inputs, launch after launch
    runs = []
    for robot, k4_seed in (
            ("mushr", kept[("K4", "mushr", POD_RANK_ENVS, True)][2]),
            ("f1tenth", torch.tensor([POD_RANK_ENVS], dtype=torch.int32,
                                     device=device))):
        cfg, x = cases[(robot, POD_ENVS)]
        runs.append(("K1", robot, POD_ENVS, functools.partial(
            fused_drift_step, cfg=cfg, **x)))
        cfg, x = cases[(robot, POD_RANK_ENVS)]
        runs.append(("K4", robot, POD_RANK_ENVS, functools.partial(
            fused_drift_step_krng, cfg=cfg, seed=k4_seed,
            **without_rows(x))))
    x, k = phys_cases[("K3", 16384)]
    runs.append(("K3", "mushr", 16384, functools.partial(
        physics_step_hf, **x, **k)))
    series = []
    for kernel, robot, b, launch in runs:
        n = REPEATS[kernel]
        off = repeats(launch, n)
        series.append({"kernel": kernel, "robot": robot, "envs": b,
                       "launches": n, "launches_not_bit_equal_to_first": off})
        if off:
            failures.append(f"{kernel} {robot} B={b}: {off} of {n} launches "
                            f"differ from the first")
    print(json.dumps({"check": "repeated launches", "series": series,
                      "card": card}), flush=True)
    plain = []
    for robot in ("mushr", "f1tenth"):
        cfg, x = cases[(robot, POD_ENVS)]
        off = repeats(lambda: plain_step(cfg, x), PLAIN_REPEATS)
        plain.append({"robot": robot, "envs": POD_ENVS,
                      "runs": PLAIN_REPEATS, "runs_not_bit_equal_to_first":
                      off})
        if off:
            failures.append(f"plain drift step {robot}: {off} runs differ")
    print(json.dumps({"check": "repeated plain drift steps on the card",
                      "series": plain, "card": card}), flush=True)

    # more seeds at the width that once disagreed
    seeds, max_err, beyond = {}, 0.0, 0
    for robot in ("mushr", "f1tenth"):
        seeds[robot] = [POD_ENVS + len(robot)]          # the kernel phase's
        for i in range(1, EXTRA_SEEDS + 1):
            seed = POD_ENVS + len(robot) + 1000 * i
            cfg, x = step_inputs(robot, POD_ENVS, seed=seed, device=device)
            n_failed = len(failures)
            max_err = max(max_err, k1_case(f"K1 {robot} B={POD_ENVS} seed "
                                           f"{seed}", cfg, x, failures))
            beyond += len(failures) > n_failed
            seeds[robot].append(seed)
    print(json.dumps({"check": "K1 against plain on more seeds",
                      "envs": POD_ENVS, "seeds": seeds,
                      "cases": sum(map(len, seeds.values())),
                      "cases_disagreeing": beyond, "max_abs_err": max_err,
                      "card": card}), flush=True)
    print(f"kernel integrity phase {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    if failures:
        raise AssertionError("; ".join(failures))
    return max_err


def repeats(fn, n):
    """Calls `fn` `n` times; returns how many calls differ in any bit from
    the first."""
    first = as_tuple(fn())
    off = 0
    for _ in range(n - 1):
        again = as_tuple(fn())
        off += any(not bool((bits(a) == bits(f)).all())
                   for a, f in zip(again, first))
    return off


def kernel_checks(device, card):
    """Phase 3's kernel checks: each kernel against its plain version (the
    kernel phases), then `integrity_phase` on their cases. Returns (max
    error by kernel, and the cases of K1, of K2 and K3, of K4, K5a and K5b,
    and of K2 at the visual shape) for the timing phase. In a process of
    its own after `build_phase`, this is the phase that once saw K1
    disagree at POD_ENVS."""
    max_err, cases = kernel_phase(device)
    phys_err, phys_cases = physics_phase(device)
    rng_err, kept = rng_kernel_phase(device, cases)
    vis_err, vis_cases = visual_kernel_phase(device)
    seeds_err = integrity_phase(device, card, cases, phys_cases, kept,
                                vis_cases)
    errs = {"K1": max(max_err, seeds_err), "K2": max(phys_err["K2"], vis_err),
            "K3": phys_err["K3"], **rng_err}
    return errs, cases, phys_cases, kept, vis_cases


NO_LAUNCHES = {"K1": 0, "K2": 0, "K3": 0, "K4": 0, "K5a": 0, "K5b": 0}


# The launches and fused applies (`"fused"`) each run of `StepGraph.step`
# that makes a graph made since the counters were reset: its first step,
# its warm-up and its capture on a card (a host call that launches nothing
# under capture). The counters count host calls, so `read_launches` and
# `read_fused_calls` take these out and count each replay of the graph
# (`ppo.REPLAYED_STEPS`) as the calls one step holds; a step run as it
# stands counts as its host calls.
GRAPH_STEP_LAUNCHES = []


def host_launches():
    from wheeledlab_torch.ops import (
        kernel_rng, multi_step, physics_step, physics_step_hf,
    )
    from wheeledlab_torch.tasks.drift import fused

    return {"K1": fused.LAUNCHES, "K2": physics_step.LAUNCHES,
            "K3": physics_step_hf.LAUNCHES, "K4": fused.LAUNCHES_KRNG,
            "K5a": multi_step.LAUNCHES, "K5b": kernel_rng.LAUNCHES}


def host_calls():
    """The launch counters and the fused apply's call counter."""
    from wheeledlab_torch.rl import networks

    return {**host_launches(), "fused": networks.FUSED_CALLS}


def count_graph_steps():
    """Record, once a process, the launches and fused applies of each
    `StepGraph.step` run that makes a graph (of a step captured, before
    its graph exists) in `GRAPH_STEP_LAUNCHES`."""
    from wheeledlab_torch.rl import ppo

    step = ppo.StepGraph.step
    if getattr(step, "counted", False):
        return

    def counted(self, obs=None):
        before = host_calls()
        step(self, obs)
        after = host_calls()
        if self.captured and self.graph is None:
            GRAPH_STEP_LAUNCHES.append(
                {k: after[k] - before[k] for k in after})

    counted.counted = True
    ppo.StepGraph.step = counted


def reset_launches():
    from wheeledlab_torch.ops import (
        kernel_rng, multi_step, physics_step, physics_step_hf,
    )
    from wheeledlab_torch.rl import ppo
    from wheeledlab_torch.tasks.drift import fused

    fused.LAUNCHES = physics_step.LAUNCHES = physics_step_hf.LAUNCHES = 0
    fused.LAUNCHES_KRNG = multi_step.LAUNCHES = kernel_rng.LAUNCHES = 0
    ppo.REPLAYED_STEPS = ppo.UNCAPTURED_STEPS = 0
    GRAPH_STEP_LAUNCHES.clear()
    count_graph_steps()


def read_launches():
    """Kernel launches since `reset_launches`, a replay of a rollout's
    step graph counted as the launches its step holds."""
    return graph_held(host_launches())


def read_fused_calls():
    """`fused_actor_critic_apply` calls since `networks.FUSED_CALLS` was
    zeroed (after `reset_launches`), a replay of a rollout's step graph
    counted as the calls its step holds."""
    from wheeledlab_torch.rl import networks

    return graph_held({"fused": networks.FUSED_CALLS})["fused"]


def graph_held(host):
    """The host-call counts `host` with the runs of `StepGraph.step` that
    made a graph taken out and each replay counted as the calls one step
    holds."""
    from wheeledlab_torch.rl import ppo

    held = GRAPH_STEP_LAUNCHES[:1]
    if not held:
        return host
    if any(n != held[0] for n in GRAPH_STEP_LAUNCHES):
        raise AssertionError(
            f"{ppo.REPLAYED_STEPS} graph replays, steps launching "
            f"{GRAPH_STEP_LAUNCHES}: one graph a count, captured after "
            "reset_launches")
    return {k: v - sum(n[k] for n in GRAPH_STEP_LAUNCHES)
            + ppo.REPLAYED_STEPS * held[0][k] for k, v in host.items()}


def check_launches(path, got, want):
    print(f"{path}: launches {got}", flush=True)
    if got != want:
        raise AssertionError(f"{path}: launches {got}, expected {want}")


@contextlib.contextmanager
def minibatch_kls():
    """Every `minibatch_update`'s KL estimate while open, in call order, as
    the tensors it returned: read once the caller is done, so that no
    minibatch waits on the host for them."""
    from wheeledlab_torch.rl import ppo

    kls, update = [], ppo.PPO.minibatch_update

    def spy(self, batch):
        metrics = update(self, batch)
        kls.append(metrics[4])
        return metrics

    ppo.PPO.minibatch_update = spy
    try:
        yield kls
    finally:
        ppo.PPO.minibatch_update = update


def train_run(device, logs, config, run_name, obs_dim, kernel, envs=1024,
              overrides=(), fused=False, first_kls=None):
    """3 full-width training iterations of `config` (`envs` envs, with the
    (key, value) `overrides`); `kernel` must carry every env step and no
    other kernel may launch. With `fused` every policy apply (each rollout
    step, each minibatch update, the bootstrap value) must go through
    `fused_actor_critic_apply`; without it none may. With `first_kls` (a
    dict), `first_kls["config/run_name"]` gets the first minibatch's KL
    estimate of each iteration. Returns (launches, iteration ms)."""
    import torch

    import wheeledlab_torch.rl  # noqa: F401  registers run configs
    from wheeledlab_torch.rl import networks
    from wheeledlab_torch.rl.runner import train
    from wheeledlab_torch.utils.config import RUN_CONFIGS, override

    iters = 3
    cfg = RUN_CONFIGS.get(config)
    for k, v in (("train.num_iterations", iters),
                 ("train.log.logs_dir", logs),
                 ("train.log.run_name", run_name),
                 ("train.log.log_every", 1),
                 ("train.log.checkpoint_every", 1000),
                 ("device", device), *overrides):
        cfg = override(cfg, k, v)
    assert (cfg.num_envs, cfg.agent.num_steps_per_env,
            cfg.agent.num_learning_epochs,
            cfg.agent.num_mini_batches) == (envs, 128, 5, 4)
    reset_launches()
    networks.FUSED_CALLS = 0
    with minibatch_kls() as kls:
        state, last = train(cfg)
    torch.cuda.synchronize()
    launches = read_launches()
    fused_calls = read_fused_calls()
    if first_kls is not None:
        per_iteration = (cfg.agent.num_learning_epochs
                         * cfg.agent.num_mini_batches)
        first_kls[f"{config}/{run_name}"] = [float(k) for k in
                                             kls[::per_iteration]]
    want = {**NO_LAUNCHES, kernel: iters * cfg.agent.num_steps_per_env}
    check_launches(config, launches, want)
    agent = cfg.agent
    applies = iters * (agent.num_steps_per_env + 1
                       + agent.num_learning_epochs * agent.num_mini_batches)
    print(f"{config}: fused_actor_critic_apply calls {fused_calls}"
          f" of {applies} policy applies", flush=True)
    if fused_calls != (applies if fused else 0):
        raise AssertionError(f"{config}: {fused_calls} fused "
                             f"applies, expected {applies if fused else 0}")
    with open(os.path.join(logs, run_name, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    for row in rows:
        for k in ("loss/total", "loss/surrogate", "loss/value",
                  "rollout/reward_mean"):
            if not math.isfinite(row[k]):
                raise AssertionError(f"{k} not finite: {row[k]}")
    obs = state.obs
    if tuple(obs.shape) != (envs, obs_dim) or not torch.isfinite(obs).all():
        raise AssertionError("final observation malformed")
    iter_ms = iteration_ms(rows)
    steps = cfg.num_envs * cfg.agent.num_steps_per_env
    print(f"{config}: iteration ms {[round(t, 3) for t in iter_ms]}; "
          f"env-steps/s (last iteration) {steps / (iter_ms[-1] / 1000.0):.1f}"
          f"; loss/total {rows[-1]['loss/total']:.4f}; rollout/reward_mean "
          f"{rows[-1]['rollout/reward_mean']:.4f}", flush=True)
    return launches[kernel], iter_ms


def print_first_kls(phase_name, first_kls, card):
    """The measurement line of the first minibatch's KL estimate of each
    iteration: where the new policy is the old one, is it 0 on the card or
    a rounding residue, as XLA's is on the CPU (+-6e-8)? Not a check."""
    print(json.dumps({"name": "first-minibatch KL estimate of each "
                              "iteration", "phase": phase_name,
                      **first_kls, "card": card}), flush=True)


def train_phase(device, logs, card):
    phase("train")
    kls = {}
    drift = train_run(device, logs, "RSS_DRIFT_CONFIG", "smoke", 14, "K1",
                      first_kls=kls)
    # the opt-in route: the variable is read when the env is built
    os.environ["WHEELEDLAB_KERNEL_RNG"] = "1"
    try:
        krng = train_run(device, logs, "RSS_DRIFT_CONFIG", "krng", 14, "K4",
                         first_kls=kls)
    finally:
        del os.environ["WHEELEDLAB_KERNEL_RNG"]
    elev = train_run(device, logs, "RSS_ELEV_CONFIG", "elev", 689, "K3",
                     fused=True, first_kls=kls)
    visual = train_run(device, logs, "RSS_VISUAL_CONFIG", "visual", 3208,
                       "K2", envs=VISUAL_ENVS, fused=True, first_kls=kls)
    print_first_kls("train", kls, card)
    return drift, krng, elev, visual


# rollout_graph_phase's cases: (config, envs, the route's kernel, agent
# settings); every case of a task with a curriculum starts its step counter
# GRAPH_BOUNDARY_LEAD steps under the curriculum's first change (drift's at
# common_step 4750, elevation's at 9800), so that the weights change at
# step 14 of the second iteration
DRIFT = "RSS_DRIFT_CONFIG"
ROLLOUT_GRAPH_CASES = (
    (DRIFT, POD_ENVS, "K1", {}), (DRIFT, POD_ENVS, "K4", {}),
    (DRIFT, 1024, "K1", {}), (DRIFT, 1024, "K4", {}),
    (DRIFT, 1024, "K1", {"agent.fuse_input_layer": True}),
    (DRIFT, 1024, "K1", {"agent.compute_dtype": "bfloat16"}),
    ("RSS_VISUAL_CONFIG", 1024, "K2", {}),
    ("RSS_ELEV_CONFIG", 1024, "K3", {}))
GRAPH_ITERS = 3
GRAPH_BOUNDARY_LEAD = 128 + 14
VIDEO_ENVS = 1024
GRAPH_PROFILED = 2


def graph_config(config, envs, settings):
    import wheeledlab_torch.rl  # noqa: F401  registers run configs
    from wheeledlab_torch.utils.config import RUN_CONFIGS, apply_overrides

    return apply_overrides(RUN_CONFIGS.get(config), {
        "num_envs": envs, "device": "cuda", **settings})


def curriculum_change(env):
    """The step counter at which the env's curriculum first changes its
    weights (`WheeledEnv._curriculum_weights`); None without one."""
    terms = env.task.curriculum
    if not terms:
        return None
    return (min(t.episodes_per_increase for t in terms) - 1) \
        * env.max_episode_length


def graph_learner(cfg, kernel, graphed):
    """The learner `train()` would build for `cfg` (K4: the in-kernel-RNG
    route, read when the env is built), its rollout step captured or held
    to the same step run as it stands."""
    from wheeledlab_torch.rl import ppo
    from wheeledlab_torch.rl.runner import setup

    if kernel == "K4":
        os.environ["WHEELEDLAB_KERNEL_RNG"] = "1"
    try:
        _, env, learner = setup(cfg)
    finally:
        os.environ.pop("WHEELEDLAB_KERNEL_RNG", None)
    if not graphed:
        learner.captures_step = False
    if ppo.StepGraph.captures(learner) is not graphed:
        raise AssertionError(f"the step is {'not ' if graphed else ''}"
                             "captured")
    return learner


def graph_iterations(learner, state, iters, capture_traj=False):
    """`iters` train iterations; returns (state, metrics of each, host ms of
    each, closed by a synchronize)."""
    import torch

    metrics, ms = [], []
    for _ in range(iters):
        t0 = time.perf_counter()
        state, m = learner.train_iteration(state, capture_traj)
        torch.cuda.synchronize()
        ms.append(1000.0 * (time.perf_counter() - t0))
        metrics.append(m)
    return state, metrics, ms


def differing(a, b, where=""):
    """The names of the tensors of `a` and `b` (nested dicts, sequences,
    dataclasses, plain values) that are not equal bit for bit."""
    import dataclasses

    import torch

    if isinstance(a, torch.Tensor):
        same = (a.dtype == b.dtype and a.shape == b.shape
                and torch.equal(bits(a.detach()).cpu(),
                                bits(b.detach()).cpu()))
        return [] if same else [where]
    if dataclasses.is_dataclass(a):
        a, b = a.__dict__, b.__dict__
    if isinstance(a, dict):
        if list(a) != list(b):
            return [f"{where} keys"]
        return [d for k in a for d in differing(a[k], b[k], f"{where}/{k}")]
    if isinstance(a, (list, tuple)):
        return [d for i, (x, y) in enumerate(zip(a, b))
                for d in differing(x, y, f"{where}/{i}")]
    return [] if a == b else [where]


def graph_snapshot(learner, state, metrics):
    """What the captured and the uncaptured runs must agree on: the learner
    (policy, Adam, its generator), the env's generator, the state and every
    iteration's metrics."""
    return {"learner": learner.state_dict(),
            "env_generator": learner.env.generator.get_state(),
            "env_state": state.env_state, "obs": state.obs,
            "metrics": metrics}


def graph_case(card, config, envs, kernel, settings):
    """GRAPH_ITERS iterations with the rollout step captured against the
    same step run as it stands, from the same seed and state; raises unless
    every number is bit-equal, the route's kernel carried every env step
    (the graph's launches counted a replay each) and the captured run
    replayed every step but at most a first one whose obs lie otherwise
    than the graph reads them."""
    import dataclasses

    from wheeledlab_torch.rl import ppo

    cfg = graph_config(config, envs, settings)
    runs, shares = {}, {}
    for graphed in (True, False):
        learner = graph_learner(cfg, kernel, graphed)
        state = learner.init_state()
        change = curriculum_change(learner.env)
        if change is not None:
            state.env_state = dataclasses.replace(
                state.env_state, common_step=change - GRAPH_BOUNDARY_LEAD)
        reset_launches()
        state, metrics, ms = graph_iterations(learner, state, GRAPH_ITERS)
        steps = GRAPH_ITERS * cfg.agent.num_steps_per_env
        check_launches(f"rollout graph {config} {envs} {kernel} {settings} "
                       f"{'captured' if graphed else 'uncaptured'}",
                       read_launches(), {**NO_LAUNCHES, kernel: steps})
        routes = (ppo.REPLAYED_STEPS, ppo.UNCAPTURED_STEPS)
        if (sum(routes) != steps
                or routes[1] > (1 if graphed else steps)
                or (not graphed and routes[0])):
            raise AssertionError(f"replayed, uncaptured steps {routes}")
        shares[graphed] = routes[0] / sum(routes)
        runs[graphed] = (graph_snapshot(learner, state, metrics), ms)
        del learner, state, metrics
    bad = differing(runs[True][0], runs[False][0])
    print(json.dumps({"name": "rollout step captured against uncaptured",
                      "config": config, "envs": envs, "kernel": kernel,
                      "settings": settings, "iterations": GRAPH_ITERS,
                      "not_bit_equal": bad,
                      "graphed_share_of_steps": shares[True],
                      "uncaptured_graphed_share": shares[False],
                      "graphed_iteration_ms": runs[True][1],
                      "uncaptured_iteration_ms": runs[False][1],
                      "card": card}),
          flush=True)
    if bad:
        raise AssertionError(f"captured and uncaptured runs differ in {bad}")


def graph_video_case(card):
    """One video iteration (`capture_traj`) of RSS_DRIFT_CONFIG at
    VIDEO_ENVS envs with the step captured against the same step run as it
    stands: the `traj/*` channels (read from the step's carried state after
    each step) and every other number bit for bit."""
    cfg = graph_config(DRIFT, VIDEO_ENVS, {})
    runs = {}
    for graphed in (True, False):
        learner = graph_learner(cfg, "K1", graphed)
        state, metrics, _ = graph_iterations(learner, learner.init_state(),
                                             1, capture_traj=True)
        if "traj/pos" not in metrics[0]:
            raise AssertionError("the video iteration holds no traj/*")
        runs[graphed] = graph_snapshot(learner, state, metrics)
        del learner, state, metrics
    bad = differing(runs[True], runs[False])
    print(json.dumps({"name": "video iteration captured against uncaptured",
                      "envs": VIDEO_ENVS, "not_bit_equal": bad,
                      "card": card}), flush=True)
    if bad:
        raise AssertionError(f"the video iterations differ in {bad}")


def graph_resume_case(card, logs):
    """A checkpoint written after GRAPH_ITERS - 1 captured iterations at
    65,536 envs, resumed by a learner whose step runs as it stands for one
    iteration, against the captured learner's own next iteration: equal
    bits. Then GRAPH_PROFILED captured iterations under `torch.profiler`:
    the trace must hold a K1 launch a step."""
    import torch

    from wheeledlab_torch.parallel.mesh import World
    from wheeledlab_torch.rl.runner import (
        CheckpointWriter, restore_checkpoint, save_checkpoint,
    )

    cfg = graph_config(DRIFT, POD_ENVS, {})
    learner = graph_learner(cfg, "K1", True)
    state, _, _ = graph_iterations(learner, learner.init_state(),
                                   GRAPH_ITERS - 1)
    writer = CheckpointWriter()
    save_checkpoint(logs, learner, state, World(), writer)
    writer.wait()
    state, metrics, _ = graph_iterations(learner, state, 1)
    graphed = graph_snapshot(learner, state, metrics)
    resumed = graph_learner(cfg, "K1", False)
    r_state, r_metrics, _ = graph_iterations(
        resumed, restore_checkpoint(logs, 0, resumed), 1)
    bad = differing(graphed, graph_snapshot(resumed, r_state, r_metrics))
    del resumed, r_state, r_metrics
    print(json.dumps({"name": "captured checkpoint resumed uncaptured",
                      "envs": POD_ENVS, "not_bit_equal": bad, "card": card}),
          flush=True)
    if bad:
        raise AssertionError(f"uncaptured resume differs in {bad}")
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        graph_iterations(learner, state, GRAPH_PROFILED)
    k1 = sum(1 for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and "fused_drift_kernel" in e.name)
    want = GRAPH_PROFILED * cfg.agent.num_steps_per_env
    print(json.dumps({"name": "graphed iterations profiled",
                      "iterations": GRAPH_PROFILED, "k1_kernels": k1,
                      "card": card}), flush=True)
    if k1 != want:
        raise AssertionError(f"the trace holds {k1} K1 kernels, not {want}")


def rollout_graph_phase(device, logs, card):
    """The rollout's step captured (`rl/ppo.py::StepGraph`) against the
    same step run as it stands on the card (`ROLLOUT_GRAPH_CASES`, a video
    iteration), an uncaptured resume of its checkpoint, and its K1
    launches in a profiler's trace."""
    phase("rollout_graph")
    for config, envs, kernel, settings in ROLLOUT_GRAPH_CASES:
        graph_case(card, config, envs, kernel, settings)
    graph_video_case(card)
    graph_resume_case(card, os.path.join(logs, "rollout-graph"))


# train_bench's short runs: (config, iterations); F1TENTH_DRIFT_CONFIG takes
# the fused drift step too (K1), as its full-budget runs do
TRAIN_BENCH_RUNS = (("RSS_DRIFT_CONFIG", 20), ("F1TENTH_DRIFT_CONFIG", 20))


def train_bench_phase(card):
    """`scripts.train_bench.main`, the entry point of the full-budget runs
    (`docs/runs/*_h100/`), with their settings but 20 iterations a config
    at 1024 envs: the run's three files must be written, its result must
    name this card and hold a finite return, and K1 must carry every env
    step (20 x 128 launches) and no other kernel launch. Returns {config:
    (K1 launches, steady ms per iteration)}."""
    import torch

    from wheeledlab_torch.scripts import train_bench

    phase("train_bench")
    out = {}
    with tempfile.TemporaryDirectory() as logs:
        for config, iters in TRAIN_BENCH_RUNS:
            run_name = config.lower()
            reset_launches()
            result = train_bench.main([
                "--config", config, "--max-iterations", str(iters),
                "--logs-dir", logs, "--run-name", run_name,
                "--target-return", "1e9", "--log-every", "10",
                "--no-checkpoints"])
            torch.cuda.synchronize()
            launches = read_launches()
            check_launches(f"train_bench {config}", launches,
                           {**NO_LAUNCHES, "K1": iters * 128})
            for name in ("metrics.jsonl", "run_config.json", "result.json"):
                if not os.path.exists(os.path.join(logs, run_name, name)):
                    raise AssertionError(f"train_bench {config}: no {name}")
            if result["device"] != card:
                raise AssertionError(f"train_bench {config}: device "
                                     f"{result['device']!r}, card {card!r}")
            if (result["iterations"] != iters
                    or not math.isfinite(result["return"])):
                raise AssertionError(f"train_bench {config}: {result}")
            print(json.dumps({
                "name": f"train_bench {config}", "iterations": iters,
                "steady_ms_per_iteration": result["steady_ms_per_iteration"],
                "return": result["return"], "card": card}), flush=True)
            out[config] = (launches["K1"], result["steady_ms_per_iteration"])
    return out


RESUME_ITERS = 4      # the straight run; the split one stops half-way
RESUME_PLAY_STEPS, RESUME_PLAY_ENVS = 50, 64
# the resumable runs of `scripts/full_budget_runs.py` held by resume_phase:
# (run, kernel of its training steps, kernel of its play steps); recurrent
# drift plays through the generic step (K2), as recurrent_play_phase does
RESUME_RUNS = (("rss_elev_h100", "K3", "K3"),
               ("rss_drift_rnn_h100", "K1", "K2"),
               ("rss_visual_h100", "K2", "K2"))


def resume_run(device, card, name, kernel, play_kernel):
    """One resumable run at its config's width through the full-budget
    runs' resume and stitch path (`scripts/full_budget_runs.py`): 4
    iterations straight, then 2 and 2 more resumed from the first
    segment's checkpoint (`train.load_run`), each run stitched by
    `full_budget_runs.stitch`. The stitched rows must equal the straight
    run's bit for bit in every metric but `perf/*` and `time/*`; `kernel`
    must carry every env step (8 x 128 launches) and no other kernel
    launch. Then the play CLI on the resumed run, 50 steps at 64 envs
    through `play_kernel`. Returns (launches of the runs, of the play,
    iteration ms of the straight run)."""
    import torch

    import wheeledlab_torch.rl  # noqa: F401  registers run configs
    from wheeledlab_torch.cli import play
    from wheeledlab_torch.rl.runner import train
    from wheeledlab_torch.scripts import full_budget_runs as fbr
    from wheeledlab_torch.utils.config import RUN_CONFIGS, override

    run = next(r for r in fbr.RESUMABLE if r[0] == name)
    half = RESUME_ITERS // 2
    envs = RUN_CONFIGS.get(run[1]).num_envs

    def segment(logs, k, stop, load_run=None):
        cfg = RUN_CONFIGS.get(run[1])
        for key, v in (("train.num_iterations", RESUME_ITERS),
                       ("train.target_return", run[4]),
                       ("train.log.logs_dir", logs),
                       ("train.log.run_name", fbr.segment_dir(name, k)),
                       ("train.log.log_every", 1),
                       ("train.log.checkpoint_every", half),
                       ("device", device)):
            cfg = override(cfg, key, v)
        if load_run is not None:
            cfg = override(cfg, "train.load_run", load_run)
        t0 = time.time()
        state, _ = train(cfg, max_iterations=stop, verbose=False)
        fbr.record_segment(logs, name, {
            "segment": k, "run_dir": fbr.segment_dir(name, k),
            "load_run": load_run, "from_iteration": half if load_run else 0,
            "to_iteration": state.iteration, "checkpoint": state.iteration,
            "rc": 0, "stopped": stop < RESUME_ITERS,
            "completed": stop == RESUME_ITERS, "wall_s": time.time() - t0,
            "shared_with": [], "device": card})

    with tempfile.TemporaryDirectory() as tmp:
        straight, split = (os.path.join(tmp, d) for d in ("straight", "split"))
        reset_launches()
        segment(straight, 0, RESUME_ITERS)
        segment(split, 0, half)
        segment(split, 1, RESUME_ITERS, load_run=fbr.segment_dir(name, 0))
        torch.cuda.synchronize()
        launches = read_launches()
        check_launches(f"resume {name}", launches,
                       {**NO_LAUNCHES, kernel: 2 * RESUME_ITERS * 128})
        want = fbr.stitch(straight, run, os.path.join(tmp, "a"))
        got = fbr.stitch(split, run, os.path.join(tmp, "b"))
        rows = {}
        for d in ("a", "b"):
            with open(os.path.join(tmp, d, name, "metrics.jsonl")) as f:
                rows[d] = [json.loads(line) for line in f]
        public = lambda r: {k: v for k, v in r.items()
                            if not k.startswith(("perf/", "time/"))}
        differ = [(a["iteration"], k, a[k], b.get(k))
                  for a, b in zip(rows["a"], rows["b"])
                  for k in public(a) if public(b).get(k) != a[k]]
        if differ or len(rows["a"]) != len(rows["b"]):
            raise AssertionError(f"resume {name}: the stitched run differs "
                                 f"from the straight one: {differ[:8]}")
        if [len(want["segments"]), len(got["segments"])] != [1, 2]:
            raise AssertionError(f"resume {name}: segments {want} {got}")
        for row in rows["b"]:
            if not math.isfinite(row["loss/total"]):
                raise AssertionError(f"resume {name}: loss {row}")
        reset_launches()
        metrics = play.main(["--run", fbr.segment_dir(name, 1), "--logs-dir",
                             split, "--steps", str(RESUME_PLAY_STEPS),
                             "--num-envs", str(RESUME_PLAY_ENVS),
                             "--device", device])
        torch.cuda.synchronize()
        play_launches = read_launches()
        check_launches(f"resume {name} play", play_launches,
                       {**NO_LAUNCHES, play_kernel: RESUME_PLAY_STEPS})
        if not all(math.isfinite(v) for v in metrics.values()):
            raise AssertionError(f"resume {name} play metrics {metrics}")
        iter_ms = iteration_ms(rows["a"])
    print(json.dumps({
        "name": f"resume {run[1]}", "run": name, "envs": envs,
        "iterations": RESUME_ITERS, "segments": [half, RESUME_ITERS - half],
        "stitched_equal_bit_for_bit": True,
        "metrics_held": len(public(rows["a"][0])),
        "ms_per_iteration": iter_ms, "alone_on_card": True,
        f"{kernel.lower()}_launches": launches[kernel],
        f"play_{play_kernel.lower()}_launches": play_launches[play_kernel],
        "card": card}), flush=True)
    return launches[kernel], play_launches[play_kernel], iter_ms


def resume_phase(device, card):
    """Every resumable config of the full-budget runs through their resume
    and stitch path (`resume_run`): RSS_ELEV_CONFIG (1024 envs, K3),
    RSS_DRIFT_RNN_CONFIG (1024, K1; the LSTM carry and `reset_prev` are
    restored) and RSS_VISUAL_CONFIG (512, K2). Returns {run: (launches,
    play launches, iteration ms)}."""
    phase("resume")
    return {name: resume_run(device, card, name, kernel, play_kernel)
            for name, kernel, play_kernel in RESUME_RUNS}


def play_phase(logs):
    """The play CLI on the drift run: 200 steps at 16 envs through K2."""
    import numpy as np
    import torch

    from wheeledlab_torch.cli import play

    phase("play")
    steps, envs = 200, 16
    reset_launches()
    t0 = time.perf_counter()
    metrics = play.main(["--run", "smoke", "--logs-dir", logs, "--steps",
                         str(steps), "--num-envs", str(envs)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check_launches("play", read_launches(), {**NO_LAUNCHES, "K2": steps})
    npz = np.load(os.path.join(logs, "smoke", "play", "smoke-rollouts.npz"))
    keys = {"observations", "actions", "positions", "yaws", "rewards",
            "commands"}
    if set(npz.files) != keys:
        raise AssertionError(f"rollout keys {sorted(npz.files)}")
    if npz["observations"].shape != (steps, envs, 14):
        raise AssertionError(f"observations {npz['observations'].shape}")
    with open(os.path.join(logs, "smoke", "play", "play_metrics.json")) as f:
        saved = json.load(f)
    if saved != metrics or not all(math.isfinite(v) for v in saved.values()):
        raise AssertionError(f"play metrics {saved}")
    print(f"play: {steps} steps x {envs} envs in {wall:.2f} s; {saved}",
          flush=True)
    return steps


# The recurrent forward on the card against the CPU: both compute the
# cells in bfloat16, and cuBLAS sums a product in another order than the
# CPU, so a bfloat16 gate input rounds the other way now and then (about 1
# in 10^4 elements of a product, CPU against XLA); each such flip moves a
# carry by up to a bfloat16 ulp of a gate and runs on through the float32
# carry. The bound is 16 bfloat16 ulps of an O(1) output (2^-8 each) after
# 32 steps; for scale, the JAX reference compiled and run op by op differs
# by 5.6e-3 after 6 steps (tests/test_torch_recurrent.py).
RNN_FORWARD_TOL = 16 * 2.0 ** -8
RNN_STEPS = 32


def recurrent_forward_phase(device):
    """ActorCriticRecurrent at RSS_DRIFT_RNN_CONFIG's width (LSTM-256, one
    layer, obs 14, 1024 envs), weights from a seed with nonzero biases:
    one 32-step sequence with resets (about 10 % a step) from a random
    hidden state, on the card and on the CPU. Returns the largest |d| of
    means, values and hidden state."""
    import numpy as np
    import torch

    from wheeledlab_torch.rl.recurrent import ActorCriticRecurrent

    phase("recurrent forward (CUDA against the CPU)")
    envs = 1024
    model = ActorCriticRecurrent(14, 2, rnn_hidden_size=256,
                                 generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(torch.from_numpy(
                rng.normal(0, 0.1, tuple(p.shape)).astype(np.float32)))
    obs = torch.from_numpy(rng.standard_normal(
        (RNN_STEPS, envs, 14)).astype(np.float32))
    reset = torch.from_numpy(
        (rng.random((RNN_STEPS, envs)) < 0.1).astype(np.float32))
    h0 = {chain: [tuple(torch.from_numpy(0.5 * rng.standard_normal(
        (envs, 256)).astype(np.float32)) for _ in range(2))]
        for chain in ("actor", "critic")}
    with torch.no_grad():
        want = model(h0, obs, reset)
        on_card = {chain: [tuple(x.to(device) for x in pair)
                           for pair in layers] for chain, layers in h0.items()}
        got = model.to(device)(on_card, obs.to(device), reset.to(device))
        torch.cuda.synchronize()
    leaves = lambda h: [x for layers in h.values() for pair in layers
                        for x in pair]
    diff = lambda a, b: float((a.cpu() - b).abs().max())
    d = {"mean": diff(got[1], want[1]), "value": diff(got[3], want[3]),
         "hidden": max(diff(a, b) for a, b in zip(leaves(got[0]),
                                                   leaves(want[0])))}
    mean_abs = float((got[1].cpu() - want[1]).abs().mean())
    print(json.dumps({"name": "recurrent forward, card against CPU",
                      "steps": RNN_STEPS, "envs": envs, "max_abs_d": d,
                      "mean_abs_d_mean": mean_abs, "tol": RNN_FORWARD_TOL,
                      "bf16_reduced_precision_reduction":
                          torch.backends.cuda.matmul.
                          allow_bf16_reduced_precision_reduction}),
          flush=True)
    if not all(math.isfinite(v) and v <= RNN_FORWARD_TOL
               for v in d.values()):
        raise AssertionError(f"recurrent forward: card against CPU {d}")
    return max(d.values())


def recurrent_train_phase(device, logs, card):
    """3 RSS_DRIFT_RNN_CONFIG iterations at 1024 envs (384 K1 launches,
    finite losses, the LSTM weights moved); then one iteration's rollout
    and update timed apart (wall clock, synchronized) and one minibatch
    update's device time (torch.profiler). Prints the first minibatch's KL
    estimate of the 3 iterations and of the timed one. Returns (launches,
    iteration ms, split)."""
    import torch

    import wheeledlab_torch.rl  # noqa: F401  registers run configs
    from wheeledlab_torch.rl.ppo import make_learner
    from wheeledlab_torch.tasks import make_env
    from wheeledlab_torch.utils.config import RUN_CONFIGS

    phase("recurrent train")
    kls = {}
    launches, iter_ms = train_run(device, logs, "RSS_DRIFT_RNN_CONFIG", "rnn",
                                  14, "K1", first_kls=kls)
    cfg = RUN_CONFIGS.get("RSS_DRIFT_RNN_CONFIG")
    ck = torch.load(os.path.join(logs, "rnn", "checkpoints", "3.pt"),
                    map_location="cpu", weights_only=True)
    trained = ck["learner"]["model"]
    env = make_env(cfg.task_name, num_envs=cfg.num_envs, device=device)
    learner = make_learner(env, cfg.agent, seed=cfg.train.seed)
    initial = learner.model.state_dict()
    moved = {k: float((trained[k] - initial[k].cpu()).abs().max())
             for k in initial if k.startswith(("lstm_a", "lstm_c"))}
    if sorted(moved) != sorted(f"{c}.0.{w}" for c in ("lstm_a", "lstm_c")
                               for w in ("wi", "wh", "bh")) \
            or min(moved.values()) == 0.0:
        raise AssertionError(f"LSTM weights did not move: {moved}")
    print(f"LSTM weights moved by (max |d|) {moved}", flush=True)

    # rollout against update, one iteration
    state = learner.init_state()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    env_state, obs, hidden, reset_prev, h0, traj, _ = learner.rollout(state)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    with torch.no_grad():
        _, _, _, last_value = learner.model.step(hidden, obs, reset_prev)
        _, returns, norm_adv = learner.compute_gae(
            traj["reward"], traj["value"], traj["done"], last_value)
    dataset = (traj["obs"], traj["reset"], traj["action"], traj["log_prob"],
               traj["value"], returns, norm_adv, traj["mean"], traj["std"])
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    with minibatch_kls() as timed_kls:
        learner.update_epochs(h0, dataset)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    kls["RSS_DRIFT_RNN_CONFIG/timed"] = [float(timed_kls[0])]
    print_first_kls("recurrent train", kls, card)
    mb = cfg.num_envs // cfg.agent.num_mini_batches
    cols = torch.arange(mb, device=device)
    batch = ({c: [(a[cols], b[cols]) for a, b in layers]
              for c, layers in h0.items()},
             *(x[:, cols] for x in dataset))
    dev_ms, n_launch, wall_ms = profiled(
        lambda: learner.minibatch_update(batch), calls=2)
    split = {"rollout_ms": 1000.0 * (t1 - t0), "gae_ms": 1000.0 * (t2 - t1),
             "update_ms": 1000.0 * (t3 - t2),
             "minibatch_update_device_ms": dev_ms,
             "minibatch_update_launches": n_launch,
             "minibatch_update_wall_ms": wall_ms,
             "minibatch_update_busy_share": dev_ms / wall_ms}
    print(json.dumps({"name": "RSS_DRIFT_RNN_CONFIG iteration split",
                      **split}), flush=True)
    return launches, iter_ms, split


def bf16_train_phase(device, logs):
    """RSS_ELEV_CONFIG with agent.compute_dtype=bfloat16 beside float32, in
    turns (float32, bfloat16, bfloat16, float32; 3 iterations each): 384
    K3 launches a run, finite losses, and every bfloat16 update fed obs
    stored in bfloat16, every float32 one float32 obs. Returns the
    iteration ms of each run, {dtype: [run, run]}."""
    import torch

    from wheeledlab_torch.rl import ppo

    phase("bf16 train")
    stored, update = [], ppo.PPO.update_epochs

    def spy(self, dataset):
        stored.append(dataset[0].dtype)
        return update(self, dataset)

    ms = {"float32": [], "bfloat16": []}
    ppo.PPO.update_epochs = spy
    try:
        for i, dtype in enumerate(("float32", "bfloat16", "bfloat16",
                                   "float32")):
            stored.clear()
            _, iter_ms = train_run(
                device, logs, "RSS_ELEV_CONFIG", f"elev_{dtype}_{i}", 689,
                "K3", overrides=(("agent.compute_dtype", dtype),),
                fused=True)
            if stored != [getattr(torch, dtype)] * 3:
                raise AssertionError(f"{dtype} run stored obs as {stored}")
            ms[dtype].append(iter_ms)
    finally:
        ppo.PPO.update_epochs = update
    return ms


# tests/test_torch_fused_input_layer.py's bars: float32 within F32_FUSED_TOL
# of the unfused forward; bfloat16 within one bfloat16 ulp of the value
# plus four of the head's largest value
F32_FUSED_TOL = 1e-5
BF16_REL, BF16_OF_MAX = 2.0 ** -7, 4 * 2.0 ** -7


def fused_forward_check(device, envs, obs_dim, dtype):
    """The fused forward of an ActorCritic (relu, [64, 64], seed 0) against
    its unfused forward on `envs` x `obs_dim` normal obs on the card;
    returns the largest |d| of mean and value."""
    import torch

    from wheeledlab_torch.rl.networks import (
        ActorCritic, fused_actor_critic_apply,
    )

    model = ActorCritic(obs_dim, 2, activation="relu",
                        generator=torch.Generator().manual_seed(0),
                        compute_dtype=dtype).to(device)
    obs = torch.randn(envs, obs_dim, device=device, generator=torch.Generator(
        device=device).manual_seed(1))
    with torch.no_grad():
        got = fused_actor_critic_apply(model, obs)
        want = model(obs)
    err = 0.0
    for name, g, w in zip(("mean", "std", "value"), got, want):
        d = (g - w).abs()
        if dtype == "float32":
            ok = bool((d <= F32_FUSED_TOL).all())
        else:
            ok = bool((d <= BF16_REL * w.abs()
                       + BF16_OF_MAX * w.abs().max()).all())
        if not ok or g.dtype != torch.float32:
            raise AssertionError(f"fused {dtype} {envs} x {obs_dim} {name}: "
                                 f"max |d| {float(d.max())}")
        err = max(err, float(d.max()))
    return err


def fused_phase(device, logs, card):
    """The fused first layer on the card: its forward against the unfused
    one at RSS_ELEV_CONFIG's and RSS_VISUAL_CONFIG's shapes in float32 and
    bfloat16; then each config trained 3 iterations a run with
    `agent.fuse_input_layer` off and on in turns (off, on, on, off), every
    apply of an "on" run fused and none of an "off" run, with each
    iteration's update (synchronized wall ms) and whole ms. Returns
    {config: {forward max |d| by dtype, ms by setting}}."""
    import torch

    from wheeledlab_torch.rl import ppo

    phase("fused first layer")
    # the wide-observation configs that take the fused apply: (envs, obs)
    shapes = {"RSS_ELEV_CONFIG": (1024, 689),
              "RSS_VISUAL_CONFIG": (VISUAL_ENVS, 3208)}
    out = {}
    for config, (envs, obs_dim) in shapes.items():
        out[config] = {f"fused_vs_unfused_max_abs_d_{dtype}":
                       fused_forward_check(device, envs, obs_dim, dtype)
                       for dtype in ("float32", "bfloat16")}
        print(f"{config}: fused against unfused forward, {envs} x {obs_dim},"
              f" max |d| {out[config]}", flush=True)

    update, update_ms = ppo.PPO.update_epochs, []

    def timed_update(self, dataset):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = update(self, dataset)
        torch.cuda.synchronize()
        update_ms.append(1000.0 * (time.perf_counter() - t0))
        return res

    ppo.PPO.update_epochs = timed_update
    try:
        for config, (envs, obs_dim) in shapes.items():
            ms = {"off": {"iteration_ms": [], "update_ms": []},
                  "on": {"iteration_ms": [], "update_ms": []}}
            kernel = "K3" if config == "RSS_ELEV_CONFIG" else "K2"
            for i, fuse in enumerate((False, True, True, False)):
                update_ms.clear()
                _, iter_ms = train_run(
                    device, logs, config, f"fuse_{config}_{i}", obs_dim,
                    kernel, envs=envs, fused=fuse,
                    overrides=(("agent.fuse_input_layer", fuse),))
                key = "on" if fuse else "off"
                ms[key]["iteration_ms"].append(iter_ms)
                ms[key]["update_ms"].append(list(update_ms))
            out[config].update(ms)
            print(json.dumps({"name": f"{config} fuse_input_layer off / on, "
                              "in turns", **ms, "card": card}), flush=True)
    finally:
        ppo.PPO.update_epochs = update
    return out


def recurrent_play_phase(logs):
    """The play CLI on the recurrent run: 50 steps at 16 envs through K2,
    with the JAX play's keys; then the export CLI with --format both, which
    writes the npz alone, holding the flax parameter names and layouts.
    Returns the K2 launches."""
    import numpy as np
    import torch

    from wheeledlab_torch.cli import export, play

    phase("recurrent play and export")
    steps, envs = 50, 16
    reset_launches()
    t0 = time.perf_counter()
    metrics = play.main(["--run", "rnn", "--logs-dir", logs, "--steps",
                         str(steps), "--num-envs", str(envs)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check_launches("recurrent play", read_launches(),
                   {**NO_LAUNCHES, "K2": steps})
    npz = np.load(os.path.join(logs, "rnn", "play", "rnn-rollouts.npz"))
    if set(npz.files) != {"observations", "actions", "positions", "yaws",
                          "rewards", "commands"}:
        raise AssertionError(f"rollout keys {sorted(npz.files)}")
    if npz["actions"].shape != (steps, envs, 2) \
            or not np.isfinite(npz["actions"]).all():
        raise AssertionError("recurrent play actions malformed")
    if not {"reward_mean", "speed_mean"} <= set(metrics) \
            or not all(math.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"play metrics {metrics}")
    print(f"recurrent play: {steps} steps x {envs} envs in {wall:.2f} s; "
          f"{metrics}", flush=True)

    written = export.main(["--run", "rnn", "--logs-dir", logs, "--format",
                           "both"])
    if [os.path.basename(w) for w in written] != ["rnn-policy.npz"]:
        raise AssertionError(f"recurrent export wrote {written}")
    flat = np.load(written[0])
    want = {"__meta__": None, "log_std": (2,)}
    for chain in "ac":
        for g in "ifgo":
            cell = f"memory.lstm_{chain}0"
            want[f"{cell}.i{g}.kernel"] = (14, 256)
            want[f"{cell}.h{g}.kernel"] = (256, 256)
            want[f"{cell}.h{g}.bias"] = (256,)
    for head, out in (("actor", 2), ("critic", 1)):
        for i, (n_in, n_out) in enumerate(((256, 64), (64, 64), (64, out))):
            want[f"{head}.Dense_{i}.kernel"] = (n_in, n_out)
            want[f"{head}.Dense_{i}.bias"] = (n_out,)
    if set(flat.files) != set(want) or any(
            shape is not None and flat[k].shape != shape
            for k, shape in want.items()):
        raise AssertionError(f"recurrent npz {sorted(flat.files)}")
    print(f"recurrent export: {len(flat.files)} arrays, flax names and "
          "layouts", flush=True)
    return steps


VISUAL_ENVS = 512
# the pixel rule of the renders: at most PIXEL_FRAC of the pixels may
# differ, each where its hit point lies within EDGE_M of a cell edge
PIXEL_FRAC = 1e-3
EDGE_M = 1e-4


def visual_flat_inputs(b, seed, device):
    """Inputs of one K2 step at the visual task's shape, made with numpy
    from `seed`: MUSHR_SUS_CFG params with the task's DR drawn (friction
    buckets in 0.4-0.6, base mass 1-3 kg, wheel inertia from a wheel mass of
    0.01-0.3 kg) on ground friction 2.0; states all over the 250 m map, level
    to tilted by 0.1 rad, standing to moving, wheels spinning; the 4wd
    targets of random policy actions. Returns (inputs, step constants)."""
    import numpy as np
    import torch

    from wheeledlab_torch.sim.actions import action_to_targets
    from wheeledlab_torch.sim.soa import pack_params
    from wheeledlab_torch.tasks.visual.task import (
        VisualTaskCfg, make_visual_task,
    )

    rng = np.random.default_rng(seed)
    task = make_visual_task(VisualTaskCfg(num_envs=b), device)
    gen = torch.Generator(device=device).manual_seed(seed)
    params = pack_params(task.init_params(gen, b, device),
                         task.terrain.friction)
    u = lambda lo, hi, *shape: rng.uniform(lo, hi, shape or (b,))
    f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=device)
    state = f32(np.stack([
        u(-120, 120), u(-120, 120), 0.1 + u(-0.04, 0.04),
        *euler_quat(u(-0.1, 0.1), u(-0.1, 0.1), u(-math.pi, math.pi)),
        u(-3, 3), u(-3, 3), u(-0.3, 0.3), u(-0.5, 0.5), u(-0.5, 0.5),
        u(-3, 3), *u(-10, 80, 4, b), *u(-0.5, 0.5, 2, b),
        *u(-2, 2, 2, b)]))
    state[7:13, : b // 8] = 0.0                   # some cars standing
    steer_t, wheel_t = action_to_targets(f32(u(-1, 1, b, 2)),
                                         task.cfg.action)
    inputs = dict(state=state, params=params, steer_t=steer_t.T.contiguous(),
                  wheel_t=wheel_t.T.contiguous())
    return inputs, dict(dt=task.cfg.sim_dt, decimation=task.cfg.decimation)


def visual_kernel_phase(device):
    """K2 at the visual task's shape (decimation 20, dt 0.01) against its
    plain version, bit for bit, at 512 and 7 envs."""
    from wheeledlab_torch.ops.physics_step import (
        physics_step, physics_step_rows,
    )

    phase("kernel (K2 at the visual shape)")
    max_err, cases, failures = 0.0, {}, []
    for b in (VISUAL_ENVS, 7):
        x, k = visual_flat_inputs(b, seed=b + 11, device=device)
        label = f"K2 visual B={b} decimation {k['decimation']} dt {k['dt']}"
        h = hold(label, lambda: physics_step(**x, **k),
                 lambda: physics_step_rows(**x, **k), ("state",), failures,
                 exact=True)
        # packed rows: mass 0, wheel inertia 35, tire mu x ground 36-39
        p = x["params"]
        span = lambda r: f"{r.min().item():.4g}-{r.max().item():.4g}"
        print(f"{label}: max_abs_err {h.max_err:.3e}, envs beyond tolerance "
              f"{h.beyond}, envs not bit-equal {h.differ}; mass "
              f"{span(p[0])}, wheel inertia {span(p[35])}, tire mu x ground "
              f"{span(p[36:40])}", flush=True)
        max_err = max(max_err, h.max_err)
        cases[b] = (x, k)
    if failures:
        raise AssertionError("; ".join(failures))
    return max_err, cases


def action_map_phase():
    """`action_to_targets` on the card against the CPU for every drivetrain,
    on 4096 actions uniform in [-1, 1]. The card's `tanf` and `atanf` and
    the host's `torch.tan`, `torch.atan` and `torch.sqrt` round some
    arguments an ulp apart (the host's float32 square root is not correctly
    rounded: numpy's agrees with the card's), and the maps go through them;
    so the CPU side is run a second time with the card's `tan`, `atan` and
    `sqrt`, and then every target must be the same bits: what is left is
    the maps' own arithmetic (a tensor divided by a Python float on the card
    is multiplied by the reciprocal: `utils/math.py::div` divides). The
    libm differences are counted and printed."""
    from unittest import mock

    import numpy as np
    import torch

    from wheeledlab_torch.assets.robots import (
        MUSHR_4WD_ACTION, MUSHR_RWD_ACTION,
    )
    from wheeledlab_torch.sim.actions import action_to_targets

    phase("action maps (CUDA against the CPU)")
    raw = torch.as_tensor(np.random.default_rng(5).uniform(
        -1, 1, (4096, 2)).astype(np.float32))
    on_card = lambda f: (lambda x: f(x) if x.is_cuda else f(x.cuda()).cpu())
    unequal = {}
    for cfg in (MUSHR_RWD_ACTION, MUSHR_4WD_ACTION,
                MUSHR_RWD_ACTION.replace(drivetrain="ackermann")):
        got = [g.cpu() for g in action_to_targets(raw.cuda(), cfg)]
        host = action_to_targets(raw, cfg)
        with mock.patch.object(torch, "tan", on_card(torch.tan)), \
                mock.patch.object(torch, "atan", on_card(torch.atan)), \
                mock.patch.object(torch, "sqrt", on_card(torch.sqrt)):
            card_libm = action_to_targets(raw, cfg)
        libm = [int((g != w).sum()) for g, w in zip(got, host)]
        left = [int((g != w).sum()) for g, w in zip(got, card_libm)]
        unequal[cfg.drivetrain] = sum(left)
        print(f"{cfg.drivetrain}: unequal elements with the card's tan, "
              f"atan and sqrt on both sides: steer {left[0]} of "
              f"{got[0].numel()}, "
              f"wheel {left[1]} of {got[1].numel()}; with each side's own "
              f"libm: steer {libm[0]}, wheel {libm[1]}", flush=True)
    if any(unequal.values()):
        raise AssertionError(f"action maps differ from the CPU: {unequal}")
    # the fault this check is for: with the rwd map dividing by a Python
    # float again, the card's wheel targets must leave the CPU's
    from wheeledlab_torch.sim import actions

    with mock.patch.object(actions, "div", lambda x, c: x / c):
        wheel = action_to_targets(raw.cuda(), MUSHR_RWD_ACTION)[1].cpu()
        caught = int((wheel != action_to_targets(raw, MUSHR_RWD_ACTION)[1])
                     .sum())
    print(f"rwd dividing by a Python float: unequal wheel elements {caught} "
          f"of {wheel.numel()}", flush=True)
    if not caught:
        raise AssertionError("the check does not see a division by a float")
    return unequal, caught


def pixel_rule(got, want, hx, hy, cell, width, height, name):
    """Fraction of pixels that differ between two renders, and how many of
    them lie off the cell edges; raises unless the fraction is at most
    PIXEL_FRAC and none lies off the edges."""
    import torch

    differ = (got.cpu() != want)
    if differ.ndim > hx.ndim:                              # RGB channels
        differ = differ.any(-1)
    u = (hx.double() + width / 2) / cell
    v = (hy.double() + height / 2) / cell
    edge = (((u - u.round()).abs() * cell < EDGE_M)
            | ((v - v.round()).abs() * cell < EDGE_M))
    frac = differ.double().mean().item()
    off_edge = int((differ & ~edge).sum())
    print(f"{name}: pixels that differ {frac:.3e} ({int(differ.sum())} of "
          f"{differ.numel()}), off a cell edge {off_edge}", flush=True)
    if frac > PIXEL_FRAC or off_edge:
        raise AssertionError(f"{name}: {frac} of the pixels differ, "
                             f"{off_edge} off a cell edge")
    return frac


def render_phase(device):
    """The renderers on the card against the CPU, by the pixel rule, at the
    512 poses of a reset of the full 500 x 500 colored map and at 512 tilted
    poses anywhere on it. Returns the largest fraction of differing
    pixels."""
    import numpy as np
    import torch

    from wheeledlab_torch.envs.env import WheeledEnv
    from wheeledlab_torch.tasks.visual import camera
    from wheeledlab_torch.tasks.visual.task import (
        VisualTaskCfg, make_visual_task,
    )

    phase("renderer (CUDA against the CPU)")
    cfg = VisualTaskCfg(num_envs=VISUAL_ENVS, color_sampling=True)
    gpu, cpu = make_visual_task(cfg, device), make_visual_task(cfg, "cpu")
    state, _ = WheeledEnv(gpu, device=device, seed=0).reset()
    b, rng = VISUAL_ENVS, np.random.default_rng(17)
    u = lambda lo, hi: rng.uniform(lo, hi, b)
    tilted = (np.stack([u(-120, 120), u(-120, 120), u(0.05, 0.3)], -1),
              np.stack(euler_quat(u(-0.3, 0.3), u(-0.3, 0.3),
                                  u(-math.pi, math.pi)), -1))
    crop = camera.HEIGHT // 3
    atlases = (camera.ColorMapAtlas.build(gpu.colormap),
               camera.ColorMapAtlas.build(cpu.colormap))
    cm = cpu.colormap
    worst = 0.0
    for label, (pos, quat) in (
            ("reset", (state.vehicle.pos.cpu(), state.vehicle.quat.cpu())),
            ("tilted", tuple(torch.as_tensor(a.astype(np.float32))
                             for a in tilted))):
        gp, gq = pos.to(device), quat.to(device)
        _, fx, fy, _ = camera.ground_hits_planar(pos, quat, crop)
        hit, _, _ = camera.ground_hits(pos, quat)
        for name, got, want, hx, hy in (
                ("render_fast", camera.render_fast(atlases[0], gp, gq, crop),
                 camera.render_fast(atlases[1], pos, quat, crop), fx, fy),
                ("render", camera.render(gpu.colormap, gp, gq),
                 camera.render(cm, pos, quat), hit[..., 0], hit[..., 1]),
                ("render_rgb", camera.render_rgb(gpu.colormap, gp, gq),
                 camera.render_rgb(cm, pos, quat), hit[..., 0],
                 hit[..., 1])):
            worst = max(worst, pixel_rule(
                got, want, hx, hy, cm.cell, cm.width, cm.height,
                f"{name} {label} B={b}"))
    return worst


def profiled(fn, calls=10):
    """What `calls` calls of `fn` (a chain of launches) cost: (device ms
    per call, the summed durations of the kernels and copies that
    torch.profiler records on the card; their count per call; wall ms per
    call of the same calls run unprofiled, each window closed by a
    synchronize). The card's busy share of the wall time is their ratio."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    wall_ms = 1000.0 * (time.perf_counter() - t0) / calls
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    on_card = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not on_card:
        raise AssertionError("torch.profiler recorded nothing on the card")
    device_us = sum(e.time_range.elapsed_us() for e in on_card)
    return device_us / 1000.0 / calls, len(on_card) / calls, wall_ms


def visual_step_breakdown(device, card):
    """Where a visual env step's time goes at RSS_VISUAL_CONFIG's shape
    (512 envs, colored world): the whole generic step, its observation
    (render + augmentation + obs noise) and its K2 launch, each by
    `profiled`: device ms, launches and wall ms per call."""
    import torch

    from wheeledlab_torch.ops.physics_step import physics_step
    from wheeledlab_torch.tasks import make_env

    env = make_env("MushrVisualRL-v0", num_envs=VISUAL_ENVS,
                   overrides={"color_sampling": True}, device=device, seed=3)
    state, _ = env.reset()
    for _ in range(5):                     # cars moving, some wheels spun
        state, _ = env.step(state, torch.rand((VISUAL_ENVS, 2),
                                              device=device) * 2 - 1)
    action = torch.rand((VISUAL_ENVS, 2), device=device) * 2 - 1
    ctx = env._make_ctx(state, state.vehicle)
    x, k = visual_flat_inputs(VISUAL_ENVS, seed=5, device=device)
    row = {"name": "visual env step, device ms", "envs": VISUAL_ENVS,
           "card": card}
    for key, fn in (("step", lambda: env.step(state, action)),
                    ("observe", lambda: env.task.observe(ctx, env.generator)),
                    ("k2", lambda: physics_step(**x, **k))):
        (row[f"{key}_device_ms"], row[f"{key}_launches"],
         row[f"{key}_wall_ms"]) = profiled(fn)
    row["step_busy_share"] = row["step_device_ms"] / row["step_wall_ms"]
    row["observe_share_of_step_device"] = (row["observe_device_ms"]
                                           / row["step_device_ms"])
    row["k2_share_of_step_device"] = (row["k2_device_ms"]
                                      / row["step_device_ms"])
    print(json.dumps(row), flush=True)
    return row


def visual_play_phase(logs):
    """The play CLI on the visual run: 50 steps at 16 envs with --video;
    K2 carries every step, and the top-down video and env 0's policy-view
    clip are written."""
    import numpy as np
    import torch

    from wheeledlab_torch.cli import play

    phase("visual play")
    steps, envs = 50, 16
    reset_launches()
    t0 = time.perf_counter()
    metrics = play.main(["--run", "visual", "--logs-dir", logs, "--steps",
                         str(steps), "--num-envs", str(envs), "--video"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check_launches("visual play", read_launches(),
                   {**NO_LAUNCHES, "K2": steps})
    play_dir = os.path.join(logs, "visual", "play")
    files = sorted(os.listdir(play_dir))
    stems = {f.rsplit(".", 1)[0] for f in files}
    if not {"visual", "visual-policyview"} <= stems:
        raise AssertionError(f"play videos missing: {files}")
    clip = [f for f in files if f.startswith("visual-policyview")][0]
    if clip.endswith(".npy"):
        frames = np.load(os.path.join(play_dir, clip))
        if frames.shape != (steps, 240, 320, 3) or frames.max() == 0:
            raise AssertionError(f"policy-view frames {frames.shape}")
    npz = np.load(os.path.join(play_dir, "visual-rollouts.npz"))
    if npz["observations"].shape != (steps, envs, 3208):
        raise AssertionError(f"observations {npz['observations'].shape}")
    if not all(math.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"play metrics {metrics}")
    print(f"visual play: {steps} steps x {envs} envs in {wall:.2f} s; files "
          f"{files}; {metrics}", flush=True)
    return steps


def script_phase():
    """The three scripts through their `main`, as a user runs them (on the
    card by default). Returns the launches of K5b, K5a and K1 and the probe's
    rows."""
    from wheeledlab_torch.scripts import (
        check_kernel_rng, limiter_probe, mppi_demo,
    )

    phase("scripts")
    reset_launches()
    if check_kernel_rng.main([]) != 0:
        raise AssertionError("the kernel RNG check failed")
    k5b = read_launches()
    check_launches("check_kernel_rng", k5b, {**NO_LAUNCHES, "K5b": 2})

    reset_launches()
    rows = limiter_probe.main(["--window", "0.5"])
    k5a = read_launches()
    if ([(r["k"], r["mode"]) for r in rows]
            != [(k, m) for k in (1, 2, 4, 8) for m in ("eager", "graph")]
            or any(r["num_envs"] != 16384 for r in rows)):
        raise AssertionError(f"probe rows {rows}")
    check_launches("limiter_probe", k5a, {
        **NO_LAUNCHES, "K5a": sum(r["launches"] for r in rows)})

    reset_launches()
    steps, horizon = 20, 16
    demo = mppi_demo.main(["--samples", "4096", "--horizon", str(horizon),
                           "--steps", str(steps)])
    k1 = read_launches()
    check_launches("mppi_demo", k1, {
        **NO_LAUNCHES, "K1": steps + steps * (horizon + 1)})
    for key in ("mppi/reward_mean", "nominal_only/reward_mean",
                "mppi/speed_mean", "mppi/slip_deg_mean"):
        if not math.isfinite(demo[key]):
            raise AssertionError(f"mppi_demo: {key} = {demo[key]}")
    return k5b["K5b"], k5a["K5a"], k1["K1"], rows


# ------------------------------------------------------------ distributed

POD_ITERS = 2          # K1 iterations of each POD run
POD_KRNG_ITERS = 1     # K4 iterations of the 2-rank job
JOB_TIMEOUT_S = 600


def iteration_ms(rows):
    """Per-iteration wall ms of a run's metrics.jsonl rows (logged every
    iteration): the iterate and device_sync phases, which end on the host
    read of the iteration's metrics."""
    prev, out = 0.0, []
    for row in rows:
        cum = row["time/iterate_s"] + row.get("time/device_sync_s", 0.0)
        out.append(1000.0 * (cum - prev))
        prev = cum
    return out


def run_group(cmds, timeout=JOB_TIMEOUT_S):
    """Run `cmds` together, each in a session of its own; kill every
    session when one outlives `timeout`. Returns their stdouts; raises
    unless each exits 0."""
    import signal

    here = os.path.dirname(os.path.abspath(__file__))
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, cwd=here,
                              start_new_session=True) for cmd in cmds]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()
    for p, out in zip(procs, outs):
        if p.returncode != 0:
            raise AssertionError(f"{' '.join(cmds[0][:4])} ... failed "
                                 f"({p.returncode}):\n{out[-6000:]}")
    return outs


def tagged(out, tag):
    """The JSON object of the line of `out` that starts with `tag`."""
    lines = [line for line in out.splitlines() if line.startswith(tag + " ")]
    if len(lines) != 1:
        raise AssertionError(f"expected one {tag} line in:\n{out[-6000:]}")
    return json.loads(lines[0][len(tag) + 1:])


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def pod_cli_worker(logs):
    """`--pod-cli LOGS` (run by torchrun): the train CLI on
    POD_DRIFT_CONFIG at full width for POD_ITERS iterations, over the job's
    NCCL group; prints `POD_CLI {...}` with the backend, the world size and
    this process's kernel launches."""
    import torch
    import torch.distributed as dist

    from wheeledlab_torch.cli import train as train_cli
    from wheeledlab_torch.parallel import distributed

    distributed.initialize(device="cuda")     # torchrun's variables: NCCL
    backend, world = dist.get_backend(), dist.get_world_size()
    reset_launches()
    train_cli.main(["-r", "POD_DRIFT_CONFIG",
                    f"train.num_iterations={POD_ITERS}",
                    "train.log.log_every=1", f"train.log.logs_dir={logs}",
                    "train.log.run_name=pod"])
    torch.cuda.synchronize()
    launches = read_launches()
    print("POD_CLI " + json.dumps({
        "backend": backend, "world_size": world, "launches": launches,
        "profile": profiled_train(logs, "nccl")}), flush=True)


PROFILE_ENVS = 4096     # the profiled distributed run's envs, all ranks


def profiled_train(logs, tag):
    """`train()` of POD_DRIFT_CONFIG cut to PROFILE_ENVS envs, 8 steps and
    1 epoch (a short trace), with `train.profile` (rank 0 traces iterations
    10-12) in this process's job.
    Returns, on rank 0, the kernel events of its trace and how many of them
    are K1's; None on the other ranks."""
    import wheeledlab_torch.rl  # noqa: F401  registers run configs
    from wheeledlab_torch.parallel import distributed
    from wheeledlab_torch.rl.runner import train
    from wheeledlab_torch.utils.config import RUN_CONFIGS, apply_overrides

    run = f"profiled-{tag}"
    train(apply_overrides(RUN_CONFIGS.get("POD_DRIFT_CONFIG"), {
        "num_envs": PROFILE_ENVS, "agent.num_steps_per_env": 8,
        "agent.num_learning_epochs": 1, "train.num_iterations": 13,
        "train.profile": True, "train.log.no_checkpoints": True,
        "train.log.logs_dir": logs, "train.log.run_name": run}),
        verbose=False)
    if not distributed.is_main_process():
        return None
    with open(os.path.join(logs, run, "trace.json")) as f:
        kernels = [e for e in json.load(f)["traceEvents"]
                   if e.get("cat") == "kernel"]
    return {"kernels": len(kernels),
            "k1": sum("fused_drift_kernel" in e["name"] for e in kernels)}


def check_profile(what, prof):
    """A profiled iteration of a distributed `train()` recorded the card."""
    if not prof or not prof["kernels"] or not prof["k1"]:
        raise AssertionError(f"{what}: rank 0's trace holds no kernel of "
                             f"the card: {prof}")
    print(f"{what}: rank 0's trace of iterations 10-12 holds "
          f"{prof['kernels']} kernels, {prof['k1']} of them K1", flush=True)


def param_hash(learner):
    import hashlib

    h = hashlib.sha256()
    for p in learner.model.parameters():
        h.update(p.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def gloo_iterations(cfg, iters, seeds=None):
    """`iters` iterations of this rank's learner, built as `train()` builds
    it (`runner.setup`); returns per-iteration metrics, parameter hashes
    and wall ms, and the launches of those iterations. With `seeds` (a
    list) it gets the drawn and the used K4 seed of the first step."""
    import torch

    from wheeledlab_torch.rl.runner import setup
    from wheeledlab_torch.tasks.drift import fused

    world, env, learner = setup(cfg)
    state = learner.init_state()
    torch.cuda.synchronize()
    wrapped = fused.fused_drift_step_krng
    if seeds is not None:
        before = env.generator.get_state()
        seeds.append(int(torch.randint(0, 2**31 - 1, (1,), dtype=torch.int32,
                                       generator=env.generator,
                                       device=env.device)))
        env.generator.set_state(before)

        def spy(*args, **kw):
            if len(seeds) == 1:
                seeds.append(int(args[5]))
            return wrapped(*args, **kw)

        fused.fused_drift_step_krng = spy
    out = {"world": [world.rank, world.size], "envs": env.num_envs,
           "metrics": [], "params": [], "ms": []}
    try:
        reset_launches()
        for _ in range(iters):
            t0 = time.perf_counter()
            state, m = learner.train_iteration(state)
            names = sorted(m)
            values = torch.stack([m[k].float() for k in names]).tolist()
            out["ms"].append(1000.0 * (time.perf_counter() - t0))
            out["metrics"].append(dict(zip(names, values)))
            out["params"].append(param_hash(learner))
        torch.cuda.synchronize()
        out["launches"] = read_launches()
    finally:
        fused.fused_drift_step_krng = wrapped
    return out


def gloo_worker(rank, port, logs):
    """`--gloo-rank R PORT LOGS`: rank R of a 2-rank gloo job on the one
    card: POD_ITERS iterations of POD_DRIFT_CONFIG (32768 envs a rank) on
    K1, then POD_KRNG_ITERS on K4, then `profiled_train`; prints
    `GLOO {...}`."""
    import wheeledlab_torch.rl  # noqa: F401  registers run configs
    from wheeledlab_torch.parallel import distributed
    from wheeledlab_torch.utils.config import RUN_CONFIGS

    distributed.initialize(backend="gloo",
                           init_method=f"tcp://127.0.0.1:{port}",
                           world_size=2, rank=rank, device="cuda",
                           timeout_s=JOB_TIMEOUT_S)
    try:
        cfg = RUN_CONFIGS.get("POD_DRIFT_CONFIG")
        k1 = gloo_iterations(cfg, POD_ITERS)
        os.environ["WHEELEDLAB_KERNEL_RNG"] = "1"   # read when the env is built
        seeds = []
        k4 = gloo_iterations(cfg, POD_KRNG_ITERS, seeds)
        del os.environ["WHEELEDLAB_KERNEL_RNG"]
        k4["seed_drawn"], k4["seed_used"] = seeds
        print("GLOO " + json.dumps({"k1": k1, "k4": k4,
                                    "profile": profiled_train(logs, "gloo")}),
              flush=True)
    finally:
        distributed.shutdown()


def distributed_phase(logs, card):
    """POD_DRIFT_CONFIG (65,536 envs) over torch.distributed on the one
    card: (1) the train CLI under torchrun, one rank over NCCL
    (POD_ITERS x 128 K1 launches); (2) two ranks over gloo, 32,768 envs
    each (POD_ITERS x 128 K1 launches a rank, then POD_KRNG_ITERS x 128 K4
    with rank 1's seed offset), identical metrics and parameters on both
    ranks; each job then runs `profiled_train`, whose trace on rank 0 must
    record the card; (3) scale_bench at world size 1, rollout and full
    PPO. Returns the numbers for the kernels line."""
    from wheeledlab_torch.parallel.mesh import int32_shard_offset

    phase("distributed (POD_DRIFT_CONFIG)")
    script = os.path.abspath(__file__)
    py = sys.executable
    t0 = time.perf_counter()
    (out,) = run_group([[py, "-m", "torch.distributed.run", "--standalone",
                         "--nproc_per_node", "1", script, "--pod-cli",
                         logs]])
    pod = tagged(out, "POD_CLI")
    if (pod["backend"], pod["world_size"]) != ("nccl", 1):
        raise AssertionError(f"torchrun job: {pod}")
    check_launches("POD_DRIFT_CONFIG (torchrun, 1 rank, NCCL)",
                   pod["launches"], {**NO_LAUNCHES, "K1": POD_ITERS * 128})
    with open(os.path.join(logs, "pod", "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    if [r["iteration"] for r in rows] != list(range(1, POD_ITERS + 1)):
        raise AssertionError(f"POD metrics rows {rows}")
    for row in rows:
        bad = {k: v for k, v in row.items() if not math.isfinite(v)}
        if bad:
            raise AssertionError(f"POD metrics not finite: {bad}")
    check_profile("torchrun job (1 rank, NCCL)", pod["profile"])
    pod_ms = iteration_ms(rows)
    print(f"POD_DRIFT_CONFIG (1 rank, NCCL, 65536 envs): iteration ms "
          f"{pod_ms}; env-steps/s (last) "
          f"{65536 * 128 / (pod_ms[-1] / 1000.0):.1f}; "
          f"{time.perf_counter() - t0:.1f} s with the launch; {card}",
          flush=True)

    t0 = time.perf_counter()
    port = free_port()
    outs = run_group([[py, script, "--gloo-rank", str(r), str(port), logs]
                      for r in range(2)])
    ranks = [tagged(out, "GLOO") for out in outs]
    check_profile("gloo job (2 ranks)", ranks[0]["profile"])
    if ranks[1]["profile"] is not None:
        raise AssertionError("rank 1 wrote a trace")
    for route, kernel, iters in (("k1", "K1", POD_ITERS),
                                 ("k4", "K4", POD_KRNG_ITERS)):
        r0, r1 = (r[route] for r in ranks)
        for r, res in enumerate((r0, r1)):
            if res["world"] != [r, 2] or res["envs"] != 32768:
                raise AssertionError(f"rank {r}: {res['world']} "
                                     f"{res['envs']} envs")
            check_launches(f"POD_DRIFT_CONFIG rank {r} of 2 (gloo, "
                           f"{route})", res["launches"],
                           {**NO_LAUNCHES, kernel: iters * 128})
        if r0["metrics"] != r1["metrics"] or r0["params"] != r1["params"]:
            raise AssertionError(f"{route}: the ranks disagree:\n{r0}\n{r1}")
        for m in r0["metrics"]:
            if not all(math.isfinite(v) for v in m.values()):
                raise AssertionError(f"{route}: metrics not finite: {m}")
        print(f"2 ranks, gloo, {kernel}: identical metrics and parameters "
              f"(sha256 {r0['params'][-1][:16]}); iteration ms rank 0 "
              f"{[round(t, 3) for t in r0['ms']]}, rank 1 "
              f"{[round(t, 3) for t in r1['ms']]}; {card}", flush=True)
    offsets = []
    for r, res in enumerate(ranks):
        k4 = res["k4"]
        off = (k4["seed_used"] - k4["seed_drawn"] + 2**31) % 2**32 - 2**31
        if off != int32_shard_offset(r):
            raise AssertionError(f"rank {r}: K4 seed {k4['seed_used']}, "
                                 f"drawn {k4['seed_drawn']}")
        offsets.append(off)
    print(f"K4 seed offsets of ranks 0, 1: {offsets} (0x3779B1 = "
          f"{0x3779B1}); gloo job {time.perf_counter() - t0:.1f} s",
          flush=True)

    rows = []
    for extra in ([], ["--full-ppo"]):
        (out,) = run_group([[py, "-m", "wheeledlab_torch.scripts.scale_bench",
                             "--envs-per-device", "65536", *extra]])
        row = json.loads(out.strip().splitlines()[-1])
        if (row["world_size"] != 1 or row["device"] != card
                or not math.isfinite(row["aggregate_env_steps_per_s"])):
            raise AssertionError(f"scale_bench row {row}")
        print(json.dumps(row), flush=True)
        rows.append(row)
    return {"pod_torchrun_launches": pod["launches"]["K1"],
            "pod_torchrun_iteration_ms": pod_ms,
            "pod_gloo_rank_launches": [r["k1"]["launches"]["K1"]
                                       for r in ranks],
            "pod_gloo_iteration_ms": [r["k1"]["ms"] for r in ranks],
            "pod_gloo_krng_launches": [r["k4"]["launches"]["K4"]
                                       for r in ranks],
            "pod_gloo_krng_iteration_ms": [r["k4"]["ms"] for r in ranks],
            "pod_gloo_krng_seed_offsets": offsets,
            "scale_bench": rows}


TP_ENVS, TP_STEPS = 1024, 8     # the drift env that feeds the TP policy
TP_CALLS = 20                   # forward calls timed, the same on each rank
# tests/test_torch_tensor_parallel.py's bar
TP_TOL = dict(rtol=1e-5, atol=1e-5)


def max_abs_d(got, want, what):
    """The largest |got - want|; raises beyond TP_TOL."""
    import torch

    if not torch.allclose(got, want, **TP_TOL):
        raise AssertionError(f"{what}: max |d| "
                             f"{float((got - want).abs().max())}")
    return float((got - want).abs().max())


def wall_ms(fn, calls=TP_CALLS):
    """Synchronized wall ms a call over `calls` calls, after two warm-up
    calls; a fixed count, so that every rank of a job makes the same
    collectives."""
    import torch

    fn()
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return 1000.0 * (time.perf_counter() - t0) / calls


def tp_worker(rank, port):
    """`--tp-rank R PORT`: rank R of a 2-rank gloo job on the one card laid
    out as `global_mesh(2)` (data 1 x model 2). The whole policy of a
    RSS_DRIFT_CONFIG learner (seed 0, the same on both ranks) acts for
    TP_STEPS steps of a TP_ENVS-env drift env through K1; this rank's share
    of it (`TensorParallelActorCritic`) runs on those observations against
    the whole policy, forward and one PPO loss's gradients; prints `TP
    {...}` with the launches, the largest differences and both forwards'
    ms."""
    import torch

    from wheeledlab_torch.parallel import distributed
    from wheeledlab_torch.parallel.mesh import shard_seed
    from wheeledlab_torch.parallel.tensor_parallel import (
        TensorParallelActorCritic,
    )
    from wheeledlab_torch.rl.ppo import PPOCfg, make_learner
    from wheeledlab_torch.tasks import make_env

    distributed.initialize(backend="gloo",
                           init_method=f"tcp://127.0.0.1:{port}",
                           world_size=2, rank=rank, device="cuda",
                           timeout_s=JOB_TIMEOUT_S)
    try:
        pm = distributed.global_mesh(2)
        # the ranks of one model group hold the same envs
        env = make_env("MushrDriftRL-v0", num_envs=TP_ENVS, device="cuda",
                       seed=shard_seed(0, pm.data_index),
                       shard=pm.data_index)
        learner = make_learner(env, PPOCfg(num_steps_per_env=TP_STEPS))
        reset_launches()
        _, obs, traj, _ = learner.rollout(learner.init_state())
        torch.cuda.synchronize()
        launches = read_launches()
        with torch.no_grad():
            _, _, last_value = learner.policy_apply(obs)
            _, returns, norm_adv = learner.compute_gae(
                traj["reward"], traj["value"], traj["done"], last_value)
        flat = lambda x: x.reshape((-1,) + x.shape[2:])
        rows = flat(traj["obs"])
        batch = [flat(x) for x in (
            traj["action"], traj["log_prob"], traj["value"], returns,
            norm_adv, traj["mean"], traj["std"])]
        model = learner.model
        tp = TensorParallelActorCritic(model, pm)
        split = sorted(k for k, d in tp.placement.items() if d is not None)

        with torch.no_grad():
            want, got = model(rows), tp(rows)
        fwd = {name: max_abs_d(g, w, f"TP {name}") for name, g, w in
               zip(("mean", "std", "value"), got, want)}
        model.zero_grad(set_to_none=True)
        learner.ppo_loss(*model(rows), *batch)[0].backward()
        learner.ppo_loss(*tp(rows), *batch)[0].backward()
        grad = 0.0
        for name, p in model.named_parameters():
            whole = p.grad
            if name in split:
                whole = whole.chunk(pm.model_size, 0)[pm.model_index]
            grad = max(grad, max_abs_d(tp.param(name).grad, whole,
                                       f"TP gradient {name}"))
        with torch.no_grad():
            tp_ms = wall_ms(lambda: tp(rows))
            whole_ms = wall_ms(lambda: model(rows))
        print("TP " + json.dumps({
            "coords": [pm.data_index, pm.model_index], "launches": launches,
            "rows": rows.shape[0], "split": split,
            "forward_max_abs_d": fwd, "grad_max_abs_d": grad,
            "tp_forward_ms": tp_ms, "one_process_forward_ms": whole_ms}),
            flush=True)
    finally:
        distributed.shutdown()


def tensor_parallel_phase(card):
    """Tensor parallelism over 2 gloo ranks on the one card (m = 2, data
    1; this script's `--tp-rank` mode): K1 carries each rank's TP_STEPS
    env steps, the TP policy's forward and one PPO loss's gradients equal
    the whole policy's within TP_TOL on every rank. Returns the numbers for
    the kernels line."""
    phase("tensor parallel (2 gloo ranks, m = 2)")
    script = os.path.abspath(__file__)
    t0 = time.perf_counter()
    port = free_port()
    outs = run_group([[sys.executable, script, "--tp-rank", str(r),
                       str(port)] for r in range(2)])
    ranks = [tagged(out, "TP") for out in outs]
    for r, res in enumerate(ranks):
        if res["coords"] != [0, r]:
            raise AssertionError(f"rank {r} at {res['coords']}")
        check_launches(f"TP rank {r} of 2 (gloo, {TP_STEPS} drift steps)",
                       res["launches"], {**NO_LAUNCHES, "K1": TP_STEPS})
        print(f"TP rank {r}: {res['rows']} rows, split {res['split']}; "
              f"forward max |d| {res['forward_max_abs_d']}, gradient max "
              f"|d| {res['grad_max_abs_d']}; forward ms TP "
              f"{res['tp_forward_ms']:.4f}, one process "
              f"{res['one_process_forward_ms']:.4f}; {card}", flush=True)
    print(f"tensor parallel job {time.perf_counter() - t0:.1f} s",
          flush=True)
    return {"tp_rank_launches": [r["launches"]["K1"] for r in ranks],
            "tp_forward_max_abs_d": max(max(r["forward_max_abs_d"].values())
                                        for r in ranks),
            "tp_grad_max_abs_d": max(r["grad_max_abs_d"] for r in ranks),
            "tp_forward_ms": [r["tp_forward_ms"] for r in ranks],
            "tp_one_process_forward_ms": [r["one_process_forward_ms"]
                                          for r in ranks]}


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


def step_bytes(cfg, x, streamed=True):
    """Bytes one fused step must move on these inputs: each element the
    kernel reads, once, and each element it writes, once. The uniform rows of
    push components whose range is zero are never read, nor the normal rows
    whose noise std is zero (nor any, with corruption off); of the pose table
    only x, y and yaw of the rows that the spawn indices pick. With
    `streamed` off the random rows are drawn in the kernel (K4): one seed
    word is read in their place; `x["uniforms"]` then holds the rows the
    kernel draws."""
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
    if not streamed:
        uniform_rows = normal_rows = 0
    # state, params, actions, uniforms, normals, step count, timers, return,
    # length
    words_in = (NUM_STATE + NUM_PARAM + 2 + uniform_rows + normal_rows + 1
                + cfg.n_push + 1 + 1)
    # state, obs, info, step count, timers, return, length
    words_out = NUM_STATE + OBS_ROWS + NUM_OUT + 1 + cfg.n_push + 1 + 1
    idx = torch.clamp((x["uniforms"][U_SPAWN] * cfg.num_reset_points)
                      .to(torch.int32), max=cfg.num_reset_points - 1)
    table_words = (x["weights"].numel() + 3 * idx.unique().numel()
                   + (0 if streamed else 1))
    return 4 * ((words_in + words_out) * b + table_words)


def multi_bytes(cfg, y, k):
    """Bytes `k` resident steps must move: state, params and counters once
    in and once out, and per step the action rows and the uniform rows the
    step reads (no observation is made, so no normal row is read); of the
    pose table at most x, y and yaw of every row."""
    from wheeledlab_torch.sim.soa import NUM_PARAM, NUM_STATE

    b = y["state"].shape[1]
    uniform_rows = 4 + sum(
        1 + sum(hi != lo or lo != 0.0 for lo, hi in ranges)
        for _, _, ranges in cfg.pushes)
    counters = 1 + cfg.n_push + 1 + 1
    words = (NUM_STATE + NUM_PARAM + counters + k * (2 + uniform_rows)
             + NUM_STATE + counters)
    table_words = y["weights"].numel() + 3 * cfg.num_reset_points
    return 4 * (words * b + table_words)


def bound(nbytes, ops):
    bytes_ms = 1000.0 * nbytes / HBM_BYTES_PER_S
    ops_ms = 1000.0 * ops / FP32_OPS_PER_S
    return (max(bytes_ms, ops_ms),
            "bytes" if bytes_ms >= ops_ms else "operations")


def timing_row(name, b, kernel, plain, nbytes, ops, card, **extra):
    bound_ms, bound_by = bound(nbytes, ops)
    row = {"name": name, "envs": b, **extra, "ms": timed(kernel),
           "graph_ms": graphed(kernel), "plain_ms": timed(plain),
           "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
           "ops": ops, "card": card}
    print(json.dumps(row), flush=True)
    return row


def rng_calls(b, noise=True):
    """The two PyTorch calls that make K1's random rows, as the env's step
    makes them (here from the default generator, which a CUDA graph can
    capture)."""
    import torch

    def draw():
        uniforms = torch.rand((12, b), device="cuda")
        normals = (torch.randn((14, b), device="cuda") if noise
                   else torch.zeros((14, b), device="cuda"))
        return uniforms, normals

    return draw


def standing_start_rows(cases, phys_cases, b, card):
    """K1's and K3's device times on the state an env starts from (every
    car standing) beside their times on moving cars: a division whose
    numerator is zero leaves the card's fast path, which made a step on
    standing cars 30 % (K1) and 43 % (K3) dearer with one thread per env;
    `substep.cuh::divz` selects around it."""
    from wheeledlab_torch.ops.physics_step_hf import physics_step_hf

    cfg, x = cases[("mushr", b)]
    standing = standing_drift_inputs(x, b)
    k1 = {"name": "fused_drift_step, standing start", "envs": b,
          "graph_ms": graphed(lambda: kernel_step(cfg, standing)),
          "moving_graph_ms": graphed(lambda: kernel_step(cfg, x)),
          "card": card}
    print(json.dumps(k1), flush=True)
    hx, hk = phys_cases[("K3", b)]
    sk, sx = standing_hf_inputs(b)
    k3 = {"name": "physics_step_hf, standing start", "envs": b,
          "graph_ms": graphed(lambda: physics_step_hf(**sx, **sk)),
          "moving_graph_ms": graphed(lambda: physics_step_hf(**hx, **hk)),
          "card": card}
    print(json.dumps(k3), flush=True)
    return {"K1": k1, "K3": k3}


def registers_per_thread(registers, source):
    """The register count in this build's ptxas line for `source`."""
    used = registers.get(source, "")
    return int(used.split()[1]) if used else None


def launch_shape(kernel, source, b, registers):
    """What a launch of a kernel that works an env with a group of lanes
    looks like on this card, from the grouping constants of
    `csrc/substep.cuh`: registers, block size, blocks, and warps an SM holds
    (averaged over the SMs that get a block) when the whole launch is
    resident; beside them the quoted graph time of the kernel before its
    redesign."""
    import re

    import torch

    from wheeledlab_torch.ops.build import CSRC

    with open(os.path.join(CSRC, "substep.cuh")) as f:
        header = f.read()
    const = lambda name: int(re.search(
        rf"constexpr int {name} = (\d+);", header).group(1))
    threads = const("kBlockThreads")
    envs_per_block = threads // const("kLanesPerEnv")
    blocks = (b + envs_per_block - 1) // envs_per_block
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return {"prev_graph_ms": PREV_GRAPH_MS[(kernel, b)],
            "prev_graph_ms_is": PREV_DESIGN[kernel],
            "registers_per_thread": registers_per_thread(registers, source),
            "threads_per_block": threads, "blocks": blocks,
            "warps_per_sm": blocks * (threads // 32) / min(blocks, sms)}


def check_faster(row):
    """A redesigned kernel's device time must stay below the quoted time of
    the kernel before its redesign."""
    if not row["graph_ms"] < row["prev_graph_ms"]:
        raise AssertionError(
            f"{row['name']} at {row['envs']} envs: graph_ms "
            f"{row['graph_ms']} is not below {row['prev_graph_ms']}, "
            f"{row['prev_graph_ms_is']}")


def launch_floor(card):
    """The graph time of a kernel that does nothing (`torch.cuda._sleep(0)`,
    a spin of 0 cycles), in the harness that times the kernels: what any
    launch costs in a CUDA graph."""
    import torch

    row = {"name": "launch floor: torch.cuda._sleep(0)",
           "graph_ms": graphed(lambda: torch.cuda._sleep(0)), "card": card}
    print(json.dumps(row), flush=True)
    return row["graph_ms"]


def rng_timing_phase(cases, kept, card, registers):
    """Timing rows of K4, K5a (K = 8) and K5b, K4's and K5b's beside their
    quoted earlier times (the run fails unless each is faster), and the two
    comparisons: K4 against K1 plus the `torch.rand` and `torch.randn` calls
    that feed it, K5b against those two calls alone (the same
    distributions, not the same bits) and beside the launch floor."""
    from wheeledlab_torch.ops.kernel_rng import philox_blocks, rng_blocks
    from wheeledlab_torch.ops.multi_step import multi_step, multi_step_rows
    from wheeledlab_torch.tasks.drift.fused import fused_drift_step_krng

    phase("timing (K4, K5a, K5b)")
    rows = {}
    for b in (16384, 1024):
        cfg, z, seed = kept[("K4", "mushr", b, True)]
        _, x = cases[("mushr", b)]
        drawn = {**x, "uniforms": philox_blocks(seed, b)[0]}
        row = timing_row(
            "fused_drift_step_krng", b,
            lambda: fused_drift_step_krng(cfg=cfg, seed=seed, **z),
            lambda: plain_step_krng(cfg, x, seed),
            step_bytes(cfg, drawn, streamed=False),
            (OPS_PER_ENV + K4_RNG_OPS) * b, card,
            **launch_shape("K4", "fused_drift_krng", b, registers))
        check_faster(row)
        # the question K4 answers: K1 and the two calls that make its rows
        draw = rng_calls(b)

        def k1_with_rng():
            uniforms, normals = draw()
            return kernel_step(cfg, {**z, "uniforms": uniforms,
                                     "normals": normals})

        row["k1_plus_rng_ms"] = timed(k1_with_rng)
        row["k1_plus_rng_graph_ms"] = graphed(k1_with_rng)
        print(json.dumps({"name": "K1 + torch.rand + torch.randn", "envs": b,
                          "ms": row["k1_plus_rng_ms"],
                          "graph_ms": row["k1_plus_rng_graph_ms"],
                          "k4_ms": row["ms"], "k4_graph_ms": row["graph_ms"],
                          "card": card}), flush=True)
        rows[("K4", b)] = row

        k = 8
        cfg, y = kept[("K5a", "mushr", b, k)]
        row = timing_row(
            "multi_step", b, lambda: multi_step(cfg=cfg, k=k, **y),
            lambda: multi_step_rows(cfg=cfg, k=k, **y),
            multi_bytes(cfg, y, k), k * (OPS_PER_ENV - OBS_OPS) * b, card,
            k=k)
        row["ms_per_control_step"] = row["ms"] / k
        row["graph_ms_per_control_step"] = row["graph_ms"] / k
        print(json.dumps({"name": "multi_step per control step", "envs": b,
                          "k": k, "ms": row["ms_per_control_step"],
                          "graph_ms": row["graph_ms_per_control_step"],
                          "card": card}), flush=True)
        rows[("K5a", b)] = row
    floor_ms = launch_floor(card)
    for b in (4096, 16384):
        seed = kept[("K5b", 4096)]
        row = timing_row(
            "rng_blocks", b, lambda: rng_blocks(seed, b),
            lambda: philox_blocks(seed, b), 4 * (1 + 26 * b), K5B_OPS * b,
            card, **launch_shape("K5b", "rng_blocks", b, registers),
            launch_floor_graph_ms=floor_ms)
        check_faster(row)
        draw = rng_calls(b)
        row["library_ms"] = timed(draw)
        row["library_graph_ms"] = graphed(draw)
        print(json.dumps({"name": "torch.rand (12, B) + torch.randn (14, B)",
                          "envs": b, "ms": row["library_ms"],
                          "graph_ms": row["library_graph_ms"],
                          "card": card}), flush=True)
        rows[("K5b", b)] = row
    return rows


def timing_phase(cases, phys_cases, vis_cases, card, registers):
    from wheeledlab_torch.ops.physics_step import (
        physics_step, physics_step_rows,
    )
    from wheeledlab_torch.ops.physics_step_hf import (
        physics_step_hf, physics_step_hf_rows,
    )

    phase("timing")
    rows = {}
    for b in (16384, 1024):
        cfg, x = cases[("mushr", b)]
        rows[("K1", b)] = timing_row(
            "fused_drift_step", b, lambda: kernel_step(cfg, x),
            lambda: plain_step(cfg, x), step_bytes(cfg, x), OPS_PER_ENV * b,
            card, **launch_shape("K1", "fused_drift", b, registers))
        check_faster(rows[("K1", b)])
    # K2 at the play path's shape (16 envs, decimation 4) and at the
    # training widths; it reads state, params and targets and writes state
    for b in (16, 1024, 16384):
        x, k = phys_cases[("K2", "mushr", b, 4)]
        rows[("K2", b)] = timing_row(
            "physics_step", b, lambda: physics_step(**x, **k),
            lambda: physics_step_rows(**x, **k),
            4 * (21 + 46 + 2 + 4 + 21) * b,
            k["decimation"] * FLAT_SUBSTEP_OPS * b, card,
            decimation=k["decimation"])
    # K2 at the visual task's shape: 512 envs, decimation 20, dt 0.01
    x, k = vis_cases[VISUAL_ENVS]
    rows[("K2 visual", VISUAL_ENVS)] = timing_row(
        "physics_step, visual", VISUAL_ENVS, lambda: physics_step(**x, **k),
        lambda: physics_step_rows(**x, **k),
        4 * (21 + 46 + 2 + 4 + 21) * VISUAL_ENVS,
        k["decimation"] * FLAT_SUBSTEP_OPS * VISUAL_ENVS, card,
        decimation=k["decimation"], dt=k["dt"])
    for b in (1024, 16384):
        x, k = phys_cases[("K3", b)]
        words = 21 + 46 + k["p"] ** 2 + 2 + 2 + 4 + 21
        rows[("K3", b)] = timing_row(
            "physics_step_hf", b, lambda: physics_step_hf(**x, **k),
            lambda: physics_step_hf_rows(**x, **k), 4 * words * b,
            k["decimation"] * HF_SUBSTEP_OPS * b, card,
            decimation=k["decimation"], p=k["p"],
            **launch_shape("K3", "physics_step_hf", b, registers))
        check_faster(rows[("K3", b)])
    return rows


def kernel_line(name, source, replaces, launches, max_err, rows, main_b,
                other_b, registers, **extra):
    main, other = rows[main_b], rows[other_b]
    return {
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "launches": launches, "max_abs_err": max_err,
        "ms": main["ms"], "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
        "library_ms": main.get("library_ms"), "envs": main_b,
        "graph_ms": main["graph_ms"],
        f"ms_{other_b}": other["ms"], f"graph_ms_{other_b}": other["graph_ms"],
        f"plain_ms_{other_b}": other["plain_ms"],
        f"bound_ms_{other_b}": other["bound_ms"], "ptxas": registers,
        **extra}


def main():
    import torch

    card = device_phase()
    device = "cuda"
    registers = build_phase()
    errs, cases, phys_cases, kept, vis_cases = kernel_checks(device, card)
    per_vehicle = per_vehicle_phase(device, phys_cases)
    action_map_phase()
    render_frac = render_phase(device)
    rnn_forward_d = recurrent_forward_phase(device)
    with tempfile.TemporaryDirectory() as logs:
        ((k1_launches, drift_ms), (k4_launches, krng_ms),
         (k3_launches, elev_ms), (vis_launches, vis_ms)) = train_phase(
            device, logs, card)
        rollout_graph_phase(device, logs, card)
        rnn_launches, rnn_ms, rnn_split = recurrent_train_phase(device, logs,
                                                                card)
        bf16_ms = bf16_train_phase(device, logs)
        print(json.dumps({"name": "RSS_ELEV_CONFIG iteration ms, in turns",
                          **bf16_ms, "card": card}), flush=True)
        fused = fused_phase(device, logs, card)
        bench = train_bench_phase(card)
        resume = resume_phase(device, card)
        k2_launches = play_phase(logs)
        vis_play_launches = visual_play_phase(logs)
        rnn_play_launches = recurrent_play_phase(logs)
    k5b_launches, k5a_launches, mppi_launches, probe = script_phase()
    timing = timing_phase(cases, phys_cases, vis_cases, card, registers)
    timing.update(rng_timing_phase(cases, kept, card, registers))
    # in a process of its own: a process's first torch.profiler sessions
    # have always recorded the card, while this one, run in this process
    # after the other phases, recorded nothing in 2 of 9 full runs on the
    # H100 (PERF.md)
    (out,) = run_group([[sys.executable, os.path.abspath(__file__),
                         "--visual-breakdown", card]])
    breakdown = tagged(out, "BREAKDOWN")
    print(json.dumps(breakdown), flush=True)
    # last: it runs in processes of its own, after every profiled phase
    # (torch.profiler recorded nothing on the card in the visual step
    # breakdown once this phase had run before it in this process)
    with tempfile.TemporaryDirectory() as logs:
        pod = distributed_phase(logs, card)
    tp = tensor_parallel_phase(card)
    # what drawing the rows in the kernel costs over reading them (K1), in
    # this run's graph times
    premium = {b: timing[("K4", b)]["graph_ms"] - timing[("K1", b)]["graph_ms"]
               for b in (1024, 16384)}
    print(json.dumps({"name": "K4 premium over K1 (graph ms)",
                      **{str(b): v for b, v in premium.items()},
                      "card": card}), flush=True)
    standing = {b: standing_start_rows(cases, phys_cases, b, card)
                for b in (1024, 16384)}
    k = lambda name: {b: r for (n, b), r in timing.items() if n == name}
    visual_k2 = timing[("K2 visual", VISUAL_ENVS)]
    extra = lambda row, *keys: {key: row[key] for key in keys}
    kernels = [
        kernel_line("fused_drift_step", "wheeledlab_torch/csrc/fused_drift.cu",
                    "wheeledlab_tpu/tasks/drift/fused.py:488", k1_launches,
                    errs["K1"], k("K1"), 1024, 16384,
                    registers.get("fused_drift"),
                    train_iteration_ms=drift_ms,
                    **{f"train_bench_{c.lower()}_{key}": v
                       for c, (n, ms) in bench.items()
                       for key, v in (("launches", n),
                                      ("steady_ms_per_iteration", ms))},
                    rnn_train_launches=rnn_launches,
                    rnn_train_iteration_ms=rnn_ms,
                    rnn_resume_launches=resume["rss_drift_rnn_h100"][0],
                    rnn_resume_iteration_ms=resume["rss_drift_rnn_h100"][2],
                    **{f"rnn_{k}": v for k, v in rnn_split.items()},
                    rnn_forward_card_vs_cpu_max_abs_d=rnn_forward_d,
                    mppi_demo_launches=mppi_launches, **tp,
                    **{k: v for k, v in pod.items()
                       if not k.startswith("pod_gloo_krng")},
                    standing_start_graph_ms=standing[1024]["K1"]["graph_ms"],
                    standing_start_graph_ms_16384=standing[16384]["K1"][
                        "graph_ms"],
                    off_route_vs_k1_max_abs_d=per_vehicle[
                        "off_vs_k1_max_abs_d"],
                    physics_bench_env_steps_per_s=per_vehicle[
                        "physics_bench"],
                    registers_per_thread=registers_per_thread(
                        registers, "fused_drift")),
        kernel_line("physics_step", "wheeledlab_torch/csrc/physics_step.cu",
                    K2_REPLACES, k2_launches, errs["K2"],
                    k("K2"), 16, 16384, registers.get("physics_step"),
                    ms_1024=k("K2")[1024]["ms"],
                    graph_ms_1024=k("K2")[1024]["graph_ms"],
                    plain_ms_1024=k("K2")[1024]["plain_ms"],
                    bound_ms_1024=k("K2")[1024]["bound_ms"],
                    visual_train_launches=vis_launches,
                    visual_train_iteration_ms=vis_ms,
                    visual_fused=fused["RSS_VISUAL_CONFIG"],
                    visual_play_launches=vis_play_launches,
                    rnn_play_launches=rnn_play_launches,
                    visual_resume_launches=resume["rss_visual_h100"][0],
                    visual_resume_play_launches=resume["rss_visual_h100"][1],
                    visual_resume_iteration_ms=resume["rss_visual_h100"][2],
                    rnn_resume_play_launches=resume["rss_drift_rnn_h100"][1],
                    **{f"{key}_{VISUAL_ENVS}": visual_k2[key] for key in (
                        "ms", "graph_ms", "plain_ms", "bound_ms")},
                    decimation_512=visual_k2["decimation"],
                    **{f"visual_{key}": breakdown[key] for key in (
                        "step_device_ms", "step_wall_ms", "step_launches",
                        "observe_device_ms", "step_busy_share")},
                    visual_render_pixels_differ=render_frac,
                    per_vehicle_max_abs_err=per_vehicle["vs_k2_max_abs_err"]),
        kernel_line("physics_step_hf",
                    "wheeledlab_torch/csrc/physics_step_hf.cu", K3_REPLACES,
                    k3_launches, errs["K3"], k("K3"), 1024, 16384,
                    registers.get("physics_step_hf"),
                    train_iteration_ms=elev_ms,
                    resume_launches=resume["rss_elev_h100"][0],
                    resume_play_launches=resume["rss_elev_h100"][1],
                    resume_iteration_ms=resume["rss_elev_h100"][2],
                    bf16_train_iteration_ms=bf16_ms["bfloat16"],
                    elev_fused=fused["RSS_ELEV_CONFIG"],
                    f32_turns_train_iteration_ms=bf16_ms["float32"],
                    per_vehicle_patch_max_abs_err=per_vehicle[
                        "vs_k3_atlas_max_abs_err"],
                    per_vehicle_grid_max_abs_err=per_vehicle[
                        "vs_k3_full_max_abs_err"],
                    atlas_free_elevation_step_ms=per_vehicle[
                        "atlas_free_elevation_step_ms"],
                    standing_start_graph_ms=standing[1024]["K3"]["graph_ms"],
                    standing_start_graph_ms_16384=standing[16384]["K3"][
                        "graph_ms"],
                    registers_per_thread=registers_per_thread(
                        registers, "physics_step_hf")),
        kernel_line("fused_drift_step_krng",
                    "wheeledlab_torch/csrc/fused_drift_krng.cu", K4_REPLACES,
                    k4_launches, errs["K4"], k("K4"), 1024, 16384,
                    registers.get("fused_drift_krng"),
                    train_iteration_ms=krng_ms,
                    **{k: v for k, v in pod.items()
                       if k.startswith("pod_gloo_krng")},
                    **extra(k("K4")[1024], "k1_plus_rng_ms",
                            "k1_plus_rng_graph_ms"),
                    k1_plus_rng_ms_16384=k("K4")[16384]["k1_plus_rng_ms"],
                    k1_plus_rng_graph_ms_16384=k("K4")[16384][
                        "k1_plus_rng_graph_ms"],
                    premium_over_k1_graph_ms=premium[1024],
                    premium_over_k1_graph_ms_16384=premium[16384],
                    registers_per_thread=registers_per_thread(
                        registers, "fused_drift_krng")),
        kernel_line("multi_step", "wheeledlab_torch/csrc/multi_step.cu",
                    K5A_REPLACES, k5a_launches, errs["K5a"], k("K5a"),
                    16384, 1024, registers.get("multi_step"), k=8,
                    **extra(k("K5a")[16384], "ms_per_control_step",
                            "graph_ms_per_control_step"),
                    limiter_probe=probe),
        kernel_line("rng_blocks", "wheeledlab_torch/csrc/rng_blocks.cu",
                    K5B_REPLACES, k5b_launches, errs["K5b"], k("K5b"),
                    4096, 16384, registers.get("rng_blocks"),
                    library="torch.rand (12, B) + torch.randn (14, B): the "
                            "same distributions, not the same bits",
                    library_graph_ms=k("K5b")[4096]["library_graph_ms"],
                    library_ms_16384=k("K5b")[16384]["library_ms"],
                    library_graph_ms_16384=k("K5b")[16384][
                        "library_graph_ms"],
                    launch_floor_graph_ms=k("K5b")[4096][
                        "launch_floor_graph_ms"],
                    registers_per_thread=registers_per_thread(
                        registers, "rng_blocks")),
    ]
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--pod-cli"]:
        pod_cli_worker(sys.argv[2])
    elif sys.argv[1:2] == ["--gloo-rank"]:
        gloo_worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    elif sys.argv[1:2] == ["--tp-rank"]:
        tp_worker(int(sys.argv[2]), int(sys.argv[3]))
    elif sys.argv[1:2] == ["--visual-breakdown"]:
        print("BREAKDOWN " + json.dumps(visual_step_breakdown(
            "cuda", sys.argv[2])), flush=True)
    else:
        main()
