"""One run of one cell: the program's normal training path, timed, traced
on request, and held to the plain reference.

The run assembles the port's learner with `wheeledlab_torch.rl.runner.setup`,
drives its first iterations through `PPO.train_iteration` (recording what
the check compares), hands that same learner to the measured window, and
there drives `train_iteration` as the runner's loop does: a batched read of
the metrics and the NaN check every `LOG_EVERY` iterations, no video, log
file or checkpoint. After the window it reads the card's memory peak,
frees the program, runs the reference from the same seed over the same
first iterations and compares.
"""

from __future__ import annotations

import gc
import importlib
import os
import statistics
import sys
import time
from typing import Dict, List, NamedTuple, Optional

import torch

from . import spec, tracing

# the runner's default log interval (LogCfg.log_every)
LOG_EVERY = 10
# iterations driven before the window, at least: the first compiles the
# kernels and fills the allocator's pools, the second runs warm
WARMUP_ITERATIONS = 2
OUT_DIR = os.path.join(spec.BENCH, "_out")


class Readings(NamedTuple):
    """What the check compares of a run's first iterations: each
    iteration's mean loss, the first clipped gradient by parameter, the
    parameters' change by parameter."""

    losses: List[float]
    first_grad: Dict[str, torch.Tensor]
    change: Dict[str, torch.Tensor]


class RunInfo(NamedTuple):
    """What the metric readers read (`metrics/<name>.py::read`)."""

    cell: spec.Cell
    setup_s: float
    iterations: int          # completed in the measured window
    window_s: float          # the measured window, closed by a synchronize
    traced_iterations: int   # run under the profiler after the window
    memory_peak_bytes: int
    spans_ms: Dict[str, List[float]]
    trace: Optional[tracing.TraceSummary]


def run_config(cell: spec.Cell, seed: int, device: str):
    """The port's RunConfig of `cell`: its configuration and traffic, one
    process (no process group), no logs or checkpoints."""
    from wheeledlab_torch.rl.ppo import PPOCfg
    from wheeledlab_torch.rl.runner import LogCfg, RunConfig, TrainCfg

    agent = {k: tuple(v) if isinstance(v, list) else v
             for k, v in cell.agent.items()}
    return RunConfig(
        task_name=cell.config["task_name"], num_envs=cell.num_envs,
        train=TrainCfg(seed=seed, distributed="off",
                       log=LogCfg(no_log=True, no_checkpoints=True)),
        agent=PPOCfg(**agent), env_overrides=cell.config["env_overrides"],
        device=device)


def set_environment(cell: spec.Cell):
    """The configuration's environment variables (None: unset)."""
    for k, v in cell.config.get("environment", {}).items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = str(v)


def start_program(cell: spec.Cell, seed: int, device: str):
    """Assemble the port's learner for `cell` and drive its first
    iterations through `train_iteration`, as many as the check compares
    (`reference_iterations`) and at least `WARMUP_ITERATIONS`. Returns
    (learner, state, Readings); the learner is the one the window drives."""
    from wheeledlab_torch.rl.runner import setup

    set_environment(cell)
    t = time.perf_counter()
    _, env, learner = setup(run_config(cell, seed, device))
    print(f"set-up: env and learner in {time.perf_counter() - t:.2f} s",
          file=sys.stderr)
    if env.obs_dim != cell.config["obs_dim"]:
        raise ValueError(f"{cell.name}: the env's observation is "
                         f"{env.obs_dim} wide, the configuration says "
                         f"{cell.config['obs_dim']}")
    names = [k for k, _ in learner.model.named_parameters()]
    params = list(learner.model.parameters())
    start = [p.detach().clone() for p in params]
    first: Dict[str, torch.Tensor] = {}
    opt = learner.optimizer
    beta1 = opt.param_groups[0]["betas"][0]

    def first_step(optimizer, args, kwargs):
        # the first clipped gradient, from Adam's first moment after one
        # step: m1 = (1 - beta1) g
        first.update({k: optimizer.state[p]["exp_avg"].detach() / (1 - beta1)
                      for k, p in zip(names, params)})
        handle.remove()

    handle = opt.register_step_post_hook(first_step)
    state = learner.init_state()
    k = cell.settings["reference_iterations"]
    losses, change = [], None
    times = []
    for i in range(max(k, WARMUP_ITERATIONS)):
        t = time.perf_counter()
        state, metrics = learner.train_iteration(state)
        times.append(time.perf_counter() - t)
        if i < k:
            losses.append(metrics["loss/total"].detach().clone())
        if i == k - 1:
            change = {n: (p.detach() - s).cpu()
                      for n, p, s in zip(names, params, start)}
    read_metrics(metrics)
    print("set-up: first iterations' host seconds "
          + ", ".join(f"{x:.2f}" for x in times), file=sys.stderr)
    return learner, state, Readings(
        losses=[float(x) for x in losses],
        first_grad={n: g.cpu() for n, g in first.items()}, change=change)


def read_metrics(metrics: Dict[str, torch.Tensor]) -> bool:
    """The runner's one batched device-to-host read of an iteration's
    metrics; True when its NaN flag is set."""
    names = list(metrics)
    host = dict(zip(names, torch.stack(
        [metrics[k].to(torch.float32) for k in names]).tolist()))
    return host.get("nan/detected", 0.0) > 0.0


def synchronize(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def allocator_and_gc(dev: torch.device) -> Dict[str, int]:
    """Counts whose change over the window shows work that set-up did not
    finish: the caching allocator's device allocations and frees, and the
    garbage collector's runs."""
    out = {f"gc{i}": s["collections"] for i, s in enumerate(gc.get_stats())}
    if dev.type == "cuda":
        stats = torch.cuda.memory_stats(dev)
        for k in ("num_device_alloc", "num_device_free", "num_alloc_retries"):
            out[k] = stats.get(k, 0)
    return out


def measure(cell: spec.Cell, seed: int, seconds: float, trace: bool,
            device: str, t0: float):
    """Set-up, the measured window and, when `trace`, the traced iterations.
    Returns (RunInfo, Readings, attempted, failed)."""
    dev = torch.device(device)
    learner, state, readings = start_program(cell, seed, device)
    spans = tracing.Spans(dev)
    if trace:
        spans.wrap(learner, "rollout", "rollout")
        spans.wrap(learner, "update_epochs", "update")
        spans.wrap(learner.env, "step", "env_step")
    synchronize(dev)
    before = allocator_and_gc(dev)
    t_start = time.perf_counter()
    setup_s = t_start - t0
    iterations = failed = 0
    while True:
        state, metrics = learner.train_iteration(state)
        iterations += 1
        last = iterations % LOG_EVERY == 0
        if last:
            failed += read_metrics(metrics)
        if time.perf_counter() - t_start >= seconds:
            break
    if not last:
        failed += read_metrics(metrics)
    synchronize(dev)
    window_s = time.perf_counter() - t_start
    after = allocator_and_gc(dev)
    print("in the window: " + ", ".join(
        f"{k} {after[k] - before[k]}" for k in before), file=sys.stderr)
    spans_ms = spans.durations_ms()
    summary, traced_iterations = None, 0
    if trace:
        traced_iterations = cell.settings["trace_iterations"]

        def traced():
            nonlocal state
            for _ in range(traced_iterations):
                state, _ = learner.train_iteration(state)

        summary = tracing.profile(traced, os.path.join(
            OUT_DIR, f"trace-{cell.name}-{seed}.json.gz"))
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    info = RunInfo(cell=cell, setup_s=setup_s, iterations=iterations,
                   window_s=window_s, traced_iterations=traced_iterations,
                   memory_peak_bytes=peak,
                   spans_ms=spans_ms, trace=summary)
    return info, readings, iterations, failed


def reference_readings(cell: spec.Cell, seed: int, device: str,
                       fault: Optional[str] = None) -> Readings:
    """The plain reference's readings of the cell's first iterations from
    `seed`, on `device`."""
    from .reference.ppo import Learner

    task = importlib.import_module(
        f"benchmark.reference.{cell.config['reference']}")
    dev = torch.device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    env = task.make_env(cell.num_envs, g, dev)
    learner = Learner(env, cell.agent, seed, dev, fault=fault)
    r = learner.follow(cell.settings["reference_iterations"])
    return Readings(losses=r.losses,
                    first_grad={k: v.cpu() for k, v in r.first_grad.items()},
                    change={k: v.cpu() for k, v in r.change.items()})


def leaf_gap(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
             leaves: List[str]) -> float:
    """The worst leaf's gap between the norms of the program's and the
    reference's tensors, over the larger of that leaf's reference norm and
    the median leaf's."""
    ref_n = {k: float(ref[k].double().norm()) for k in leaves}
    median = statistics.median(ref_n.values())
    return max(abs(float(prog[k].double().norm()) - ref_n[k])
               / max(ref_n[k], median) for k in leaves)


def moved_leaves(ref: Readings) -> List[str]:
    """The leaves the reference moves by more than round-off: its first
    gradient at least a thousandth of the median leaf's."""
    norms = {k: float(g.double().norm()) for k, g in ref.first_grad.items()}
    median = statistics.median(norms.values())
    return [k for k, v in norms.items() if v >= 1e-3 * median]


def compare(prog: Readings, ref: Readings) -> Dict[str, float]:
    """The numbers the check holds to its limits."""
    return {
        "loss_gap": max(abs(p - r) / abs(r)
                        for p, r in zip(prog.losses, ref.losses)),
        "grad_gap": leaf_gap(prog.first_grad, ref.first_grad,
                             sorted(ref.first_grad)),
        "update_gap": leaf_gap(prog.change, ref.change, moved_leaves(ref)),
    }


def read_metrics_of(info: RunInfo, entries: List[dict]) -> Dict[str, dict]:
    """Each metric's reader on `info`; a reader that finds nothing to read
    returns None and its metric is left out."""
    out = {}
    for m in entries:
        value = spec.load_module("metrics", m["name"]).read(info)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def free_device_memory():
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def run(cell: spec.Cell, seed: int, seconds: float, trace: bool,
        device: str, t0: float) -> dict:
    """One run of `cell`: the result object without its `device` entry's
    card name (see `run.py`)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    info, prog, attempted, failed = measure(cell, seed, seconds, trace,
                                            device, t0)
    free_device_memory()
    t_ref = time.perf_counter()
    ref = reference_readings(cell, seed, device)
    print(f"window: {attempted} iterations in {info.window_s:.3f} s; "
          f"reference: {time.perf_counter() - t_ref:.1f} s", file=sys.stderr)
    numbers = compare(prog, ref)
    limits = cell.settings["limits"]
    checks = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    correct = failed == 0 and all(v <= limits[k] for k, v in numbers.items())
    metrics = read_metrics_of(info, cell.per_layer if trace
                              else cell.end_to_end)
    dev = {"count": 1, "memory_peak_bytes": info.memory_peak_bytes}
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": dev}
    if trace and info.trace is not None:
        t = info.trace
        dev.update(busy_s=t.busy_s, window_s=t.window_s)
        ops = sorted(t.kernels.items(), key=lambda kv: -kv[1][0])[:10]
        result["breakdown"] = {
            "device_ops": [[k[:160], v[0]] for k, v in ops],
            "idle_gaps": [[k, v] for k, v in t.idle_gaps]}
    result["checks"] = checks
    return result
