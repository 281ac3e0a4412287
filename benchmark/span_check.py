"""The program's spans on a cell, on the card: what they read against the
benchmark's own wrappers, what a device trace gives per span, and what they
cost when on.

    python3 benchmark/span_check.py --workload <cell> --seeds <n> [<n> ...]
        [--seconds 30] [--cost-seconds 30] [--no-cost]

1. One traced run from the first seed, as `run.py --trace 1` drives it
   (`harness.measure`), with the program's spans on from set-up. The spans
   are drained after each synchronize the harness already makes: before
   the window (set-up, dropped), after it (the window), and after the
   profiled iterations. Prints each span's calls and mean host and device
   ms in the window and in the profiled iterations, the benchmark's
   wrappers (`rollout_ms`, `update_ms`, `env_step_ms`) beside
   `ppo.rollout`, `ppo.update` and `env.step`, the iteration's parts
   against `ppo.iteration`, and, from the profiled iterations' trace
   (`span_trace.py`), each span's launches and idle share, the card's
   idle time by innermost span, the launches against the device events
   of the window, and the K1 launches (`fused_drift_kernel`) an env step.
2. Unless `--no-cost`: untraced windows with spans off and on in turns,
   one of each a seed, each its own set-up, as `run.py --trace 0` runs.

Prints one JSON line a part, the card first. Needs a CUDA card.
"""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
import run as bench_run  # noqa: E402  the run's environment, before torch

import argparse  # noqa: E402
import collections  # noqa: E402
import gzip  # noqa: E402
import json  # noqa: E402
import time  # noqa: E402

import torch  # noqa: E402

from benchmark import harness, span_trace, spec  # noqa: E402
from wheeledlab_torch.utils import profiling  # noqa: E402

K1 = "fused_drift_kernel"


def per_call(totals):
    """{name: [calls, mean host ms, mean device ms]} of drained totals."""
    return {k: [t.calls, t.host_ms / max(t.calls, 1),
                t.device_ms / t.timed if t.timed else None]
            for k, t in sorted(totals.items())}


def k1_per_env_step(events):
    """K1 kernels whose launch began inside an `env.step` span, per span;
    and K1 kernels in the trace."""
    steps = [(a, b) for n, a, b in span_trace.program_spans(events)
             if n == "env.step"]
    launch_ts = {e["args"]["correlation"]: e["ts"] for e in events
                 if e.get("cat") in span_trace.HOST_API_CATS
                 and "correlation" in e.get("args", {})}
    k1 = [e for e in events if e.get("cat") == "kernel"
          and K1 in e.get("name", "")]
    inside = sum(1 for e in k1
                 if any(a <= launch_ts.get(e["args"].get("correlation"),
                                           -1.0) <= b for a, b in steps))
    return inside / max(len(steps), 1), len(k1), len(steps)


def traced(cell, seed, seconds, device="cuda"):
    drains = []
    sync = harness.synchronize

    def synchronize_and_drain(dev):
        sync(dev)
        drains.append(profiling.drain())

    harness.synchronize = synchronize_and_drain
    profiling.enable_spans(True, device)
    try:
        info, _, attempted, failed = harness.measure(
            cell, seed, seconds, True, device, time.perf_counter())
        profiled = profiling.drain()
    finally:
        profiling.enable_spans(False)
        harness.synchronize = sync
    window = drains[1]
    wrappers = {k: sum(v) / len(v) for k, v in info.spans_ms.items() if v}
    w = per_call(window)
    p = per_call(profiled)
    parts = ("ppo.rollout", "ppo.gae", "ppo.update", "ppo.metrics")
    split = {side: {"parts_ms": sum(w[k][i] or 0.0 for k in parts),
                    "iteration_ms": w["ppo.iteration"][i]}
             for side, i in (("host", 1), ("device", 2))}
    path = os.path.join(harness.OUT_DIR, f"trace-{cell.name}-{seed}.json.gz")
    with gzip.open(path, "rb") as f:
        events = json.load(f)["traceEvents"]
    reduced = span_trace.reduce_spans(events)
    steps = cell.agent["num_steps_per_env"]
    by_span = {k: {"calls": r.calls,
                   "launches_a_call": r.launches / r.calls,
                   "idle_pct": 100.0 * r.idle_s / r.span_s,
                   "ms_a_call": 1000.0 * r.span_s / r.calls}
               for k, r in sorted(reduced.items())}
    idle = sorted(span_trace.idle_by_innermost(events).items(),
                  key=lambda kv: -kv[1])
    launches, device_events = span_trace.launches_and_device_events(events)
    k1_a_step, k1_total, env_steps = k1_per_env_step(events)
    r = reduced

    def get(name, f):
        return f(r[name]) if name in r else None

    proposed = {
        "gae_ms": w.get("ppo.gae", [None] * 3)[2],
        "rollout_host_ms": w.get("ppo.rollout", [None] * 3)[1],
        "rollout_step_launches": get(
            "ppo.rollout", lambda s: s.launches / (s.calls * steps)),
        "env_step_launches": get("env.step", lambda s: s.launches / s.calls),
        "minibatch_launches": get(
            "ppo.minibatch", lambda s: s.launches / s.calls),
        "rollout_idle_pct": get(
            "ppo.rollout", lambda s: 100.0 * s.idle_s / s.span_s),
        "update_idle_pct": get(
            "ppo.update", lambda s: 100.0 * s.idle_s / s.span_s),
    }
    steps_per_s = (info.iterations * cell.num_envs * steps / info.window_s)
    return {
        "part": "traced", "seed": seed, "attempted": attempted,
        "failed": failed, "window_iterations": info.iterations,
        "env_steps_per_s": steps_per_s,
        "device_idle_pct": (100.0 * (1 - info.trace.busy_s
                                     / info.trace.window_s)
                            if info.trace else None),
        "proposed_metrics": proposed,
        "wrappers_ms": wrappers,
        "window_spans": w, "profiled_spans": p, "iteration_split": split,
        "trace_by_span": by_span,
        "idle_by_innermost_s": idle,
        "window_launches": launches, "window_device_events": device_events,
        "k1_a_env_step": k1_a_step, "k1_in_trace": k1_total,
        "env_steps_in_trace": env_steps,
        "idle_gaps": info.trace.idle_gaps if info.trace else None,
    }


def cost(cell, seeds, seconds, device="cuda"):
    rows = collections.defaultdict(list)
    for i, seed in enumerate(seeds):
        for on in ((False, True) if i % 2 == 0 else (True, False)):
            profiling.enable_spans(on, device)
            try:
                info, _, _, _ = harness.measure(cell, seed, seconds, False,
                                                device, time.perf_counter())
            finally:
                profiling.enable_spans(False)
                profiling.drain()
            steps = cell.num_envs * cell.agent["num_steps_per_env"]
            rows["on" if on else "off"].append(
                [seed, info.iterations * steps / info.window_s])
            harness.free_device_memory()
    return {"part": "cost", "env_steps_per_s": dict(rows)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=30.0)
    p.add_argument("--cost-seconds", type=float, default=30.0)
    p.add_argument("--no-cost", action="store_true")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = spec.load_cell(args.workload)
    print(json.dumps({"card": bench_run.power_limit(),
                      "torch": torch.__version__}), flush=True)
    print(json.dumps(traced(cell, args.seeds[0], args.seconds)), flush=True)
    harness.free_device_memory()
    if not args.no_cost:
        print(json.dumps(cost(cell, args.seeds, args.cost_seconds)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
