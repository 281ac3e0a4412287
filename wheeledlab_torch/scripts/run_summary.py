"""Summary of committed training runs (`docs/runs/<name>/`) from their
`metrics.jsonl` and `result.json` alone; give a port run and its reference
run to set them side by side.

    python -m wheeledlab_torch.scripts.run_summary docs/runs/rss_drift_h100 \
        docs/runs/rss_drift_tpu [--bar 700]

One JSON line a run: the first-3 and last-10 means of the return, slip and
speed (what `tests/test_run_artifacts.py` holds runs to); the return,
`loss/kl`, `lr` and `loss/value` at the iterations `AT`; the first
logged iteration whose return reaches `--bar` and the wall seconds to it;
and over the last 1000 iterations the median KL, the share of log points
with the LR at the learner's `max_lr` and the LR's range, with the count
of non-finite returns.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import sys

AT_KEYS = ("episode/return", "loss/kl", "lr", "loss/value")
AT = (10, 100, 500, 1000, 1500, 5000)


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


def mean(rows, key):
    values = [r[key] for r in rows if key in r]
    return sum(values) / len(values) if values else None


def summary(run_dir, bar):
    rows, config, result = load(run_dir)
    max_lr = config["run"]["agent"]["max_lr"]
    last = [r for r in rows if r["iteration"] > rows[-1]["iteration"] - 1000]
    reached = next((r for r in rows if r["episode/return"] >= bar), None)
    out = {
        "run": os.path.basename(os.path.normpath(run_dir)),
        "iterations": rows[-1]["iteration"],
        **{f"first3_{k}": mean(rows[:3], f"{p}/{k}") for p, k in (
            ("episode", "return"), ("metrics", "slip_deg"),
            ("metrics", "speed"))},
        **{f"last10_{k}": mean(rows[-10:], f"{p}/{k}") for p, k in (
            ("episode", "return"), ("metrics", "slip_deg"),
            ("metrics", "speed"))},
        "at": {r["iteration"]: {k: r.get(k) for k in AT_KEYS}
               for r in rows if r["iteration"] in AT},
        "bar": bar,
        "bar_iteration": reached and reached["iteration"],
        "bar_wall_s": reached and reached["perf/wall_s"],
        "last1000_kl_median": statistics.median(r["loss/kl"] for r in last),
        "last1000_lr_at_max_share": sum(
            r["lr"] >= max_lr * (1 - 1e-6) for r in last) / len(last),
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
    args = p.parse_args(sys.argv[1:] if argv is None else argv)
    lines = [summary(run, args.bar) for run in args.runs]
    for line in lines:
        print(json.dumps(line), flush=True)
    return lines


if __name__ == "__main__":
    main()
