"""Summary of committed training runs (`docs/runs/<name>/`) from their
`metrics.jsonl` and `result.json` alone; give a port run and its reference
run to set them side by side.

    python -m wheeledlab_torch.scripts.run_summary docs/runs/rss_drift_h100 \
        docs/runs/rss_drift_tpu [--bar 700] [--at 10 400 800 ...]
        [--keys metrics/traversable_frac loss/entropy ...]

One JSON line a run: the first-3 and last-10 means of the channels
`tests/test_run_artifacts.py` holds runs to (return, slip, speed, ground
height, goal distance and velocity, goal terminations, traversable share,
forward velocity, those the task logs); the return,
`loss/kl`, `lr` and `loss/value` (and the metrics `--keys` names) at the
iterations `--at` (default `AT`); the first
logged iteration whose return reaches `--bar` and the training seconds to
it (on a run stitched from segments, those of the segments before it too:
`perf/wall_s` restarts in each);
the first log point of a stall (|KL| < STALL_KL) and the first after it
that begins BACK_POINTS log points with the KL back (>= BACK_KL); the
share of log points with the LR at the learner's `min_lr` and at its
`max_lr` over the whole run; and over the last 1000 iterations the median KL, the share of log points with the LR
at `max_lr` and the LR's range, with the count of non-finite returns.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import sys

AT_KEYS = ("episode/return", "loss/kl", "lr", "loss/value")
AT = (10, 100, 500, 1000, 1500, 2000, 4000, 5000)
# the channels the reference's bars read (tests/test_run_artifacts.py),
# where the task logs them
FIRST_LAST = ("episode/return", "metrics/slip_deg", "metrics/speed",
              "metrics/ground_height", "metrics/goal_dist",
              "rew/vel_towards_goal", "done/at_goal",
              "metrics/traversable_frac", "metrics/forward_vel")
STALL_KL = 1e-5   # |KL| below this: the policy has stopped moving
BACK_KL = 1e-4    # KL at or above this after a stall, at BACK_POINTS log
BACK_POINTS = 10  # points in a row: the policy moves again


def load(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    with open(os.path.join(run_dir, "run_config.json")) as f:
        config = json.load(f)
    result = None
    path = os.path.join(run_dir, "result.json")
    if os.path.exists(path):
        with open(path) as f:
            result = json.load(f)
    return rows, config, result


def wall_to(row, result):
    """Training seconds from the run's start to `row`. A stitched run's
    `result.json` lists its segments, and `perf/wall_s` restarts in each:
    the row comes from the last segment that began before it, and every
    segment before that adds its own training seconds."""
    segments = (result or {}).get("segments", [])
    k = max((i for i, s in enumerate(segments)
             if s["iterations"][0] < row["iteration"]), default=0)
    return sum(s["train_s"] for s in segments[:k]) + row["perf/wall_s"]


def mean(rows, key):
    values = [r[key] for r in rows if key in r]
    return sum(values) / len(values) if values else None


def at_share(rows, lr, above):
    """The share of `rows` whose LR is at `lr` (within float32 rounding),
    from above (`min_lr`) or below (`max_lr`)."""
    if above:
        return sum(r["lr"] <= lr * (1 + 1e-6) for r in rows) / len(rows)
    return sum(r["lr"] >= lr * (1 - 1e-6) for r in rows) / len(rows)


def summary(run_dir, bar, at=AT, keys=()):
    rows, config, result = load(run_dir)
    min_lr = config["run"]["agent"]["min_lr"]
    max_lr = config["run"]["agent"]["max_lr"]
    last = [r for r in rows if r["iteration"] > rows[-1]["iteration"] - 1000]
    reached = next((r for r in rows if r["episode/return"] >= bar), None)
    stall = next((r for r in rows if abs(r["loss/kl"]) < STALL_KL), None)
    after = [r for r in rows if stall and r["iteration"] > stall["iteration"]]
    back = next((r for i, r in enumerate(after)
                 if all(x["loss/kl"] >= BACK_KL
                        for x in after[i:i + BACK_POINTS])), None)
    out = {
        "run": os.path.basename(os.path.normpath(run_dir)),
        "iterations": rows[-1]["iteration"],
        **{f"first3_{k.split('/')[1]}": mean(rows[:3], k)
           for k in FIRST_LAST if k in rows[0]},
        **{f"last10_{k.split('/')[1]}": mean(rows[-10:], k)
           for k in FIRST_LAST if k in rows[0]},
        "at": {r["iteration"]: {k: r.get(k) for k in (*AT_KEYS, *keys)}
               for r in rows if r["iteration"] in at},
        "bar": bar,
        "bar_iteration": reached and reached["iteration"],
        "bar_wall_s": reached and wall_to(reached, result),
        "stall_iteration": stall and stall["iteration"],
        "kl_back_iteration": back and back["iteration"],
        "lr_at_min_share": at_share(rows, min_lr, True),
        "lr_at_max_share": at_share(rows, max_lr, False),
        "last1000_kl_median": statistics.median(r["loss/kl"] for r in last),
        "last1000_lr_at_max_share": at_share(last, max_lr, False),
        "last1000_lr_min": min(r["lr"] for r in last),
        "last1000_lr_max": max(r["lr"] for r in last),
        "nonfinite_returns": sum(
            not math.isfinite(r["episode/return"]) for r in rows),
    }
    if result is not None:
        out.update({k: result.get(k) for k in (
            "value", "steady_ms_per_iteration", "startup_s", "device")})
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("runs", nargs="+")
    p.add_argument("--bar", type=float, default=700.0)
    p.add_argument("--at", type=int, nargs="+", default=list(AT),
                   help="the iterations to report metrics at")
    p.add_argument("--keys", nargs="+", default=[],
                   help="metrics reported at those iterations besides "
                        "the return, KL, LR and value loss")
    args = p.parse_args(sys.argv[1:] if argv is None else argv)
    lines = [summary(run, args.bar, args.at, args.keys)
             for run in args.runs]
    for line in lines:
        print(json.dumps(line), flush=True)
    return lines


if __name__ == "__main__":
    main()
