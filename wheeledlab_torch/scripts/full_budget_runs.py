"""The full-budget drift runs on one card, as `docs/runs/*_h100/` were made.

Starts one `python -m wheeledlab_torch.scripts.train_bench` process a run,
all together (the iterations are host-bound, so runs can share the card),
each at the reference's budget with the reference artifacts' settings
(`--target-return 1e6 --log-every 10 --no-checkpoints`, as their
`run_config.json` record):

  rss_drift_h100, rss_drift_h100_seed1     RSS_DRIFT_CONFIG, seeds 0, 1,
                                           5000 iterations
  f1tenth_drift_h100_seed0 ... _seed4      F1TENTH_DRIFT_CONFIG, seeds 0-4,
                                           1500 iterations

    python -m wheeledlab_torch.scripts.full_budget_runs [--logs-dir logs]
        [--only rss_drift_h100 ...] [--max-iterations N]

Each run writes `<logs-dir>/<name>/` (metrics.jsonl, run_config.json,
result.json; these three are what `docs/runs/<name>/` commits) and its
output to `<logs-dir>/<name>.log`. While they run, the resident memory of
every process is sampled every `SAMPLE_S` seconds into
`<logs-dir>/full_budget_samples.jsonl`. At the end one JSON line a run: its
`result.json`, exit code, wall seconds, the runs it shared the card with,
and its resident memory at the first sample a tenth into the run, at the
last sample and at most.
The exit code is 1 if a run failed.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

RUNS = (("rss_drift_h100", "RSS_DRIFT_CONFIG", 0, 5000),
        ("rss_drift_h100_seed1", "RSS_DRIFT_CONFIG", 1, 5000),
        *((f"f1tenth_drift_h100_seed{s}", "F1TENTH_DRIFT_CONFIG", s, 1500)
          for s in range(5)))
SAMPLE_S = 30.0    # seconds between samples of the processes' memory


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--logs-dir", default="logs")
    p.add_argument("--only", nargs="+", default=None,
                   help="run names to start (default: all seven)")
    p.add_argument("--max-iterations", type=int, default=None,
                   help="cut every run to N iterations (a short check)")
    return p


def command(args, name, config, seed, iterations):
    return [sys.executable, "-m", "wheeledlab_torch.scripts.train_bench",
           "--config", config, "--seed", str(seed),
           "--max-iterations", str(args.max_iterations or iterations),
           "--logs-dir", args.logs_dir, "--run-name", name,
           "--target-return", "1e6", "--log-every", "10", "--no-checkpoints"]


def build_kernels():
    """Build the kernels once, before the processes that load them start."""
    from ..ops import build

    build.build_all(build.SOURCES)


def rss_mib(pid: int):
    """Resident memory of process `pid` in MiB, None once it has gone."""
    try:
        with open(f"/proc/{pid}/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) / 1024.0
    except OSError:
        pass
    return None


def main(argv=None) -> int:
    args = build_parser().parse_args(sys.argv[1:] if argv is None else argv)
    runs = [r for r in RUNS if args.only is None or r[0] in args.only]
    if args.only is not None and len(runs) != len(args.only):
        raise SystemExit(f"unknown run in {args.only}")
    os.makedirs(args.logs_dir, exist_ok=True)
    build_kernels()
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    procs, logs, started = {}, {}, {}
    for name, config, seed, iterations in runs:
        logs[name] = open(os.path.join(args.logs_dir, f"{name}.log"), "w")
        started[name] = time.time()
        procs[name] = subprocess.Popen(
            command(args, name, config, seed, iterations), env=env,
            stdout=logs[name], stderr=subprocess.STDOUT)
    rss = {name: [] for name in procs}    # (seconds since start, MiB)
    shared = {name: set() for name in procs}
    ended = {}
    t0 = time.time()
    with open(os.path.join(args.logs_dir, "full_budget_samples.jsonl"),
              "w") as samples:
        while len(ended) < len(procs):
            live = [n for n in procs if n not in ended]
            row = {"t_s": time.time() - t0, "rss_mib": {}}
            for name in live:
                shared[name].update(live)
                mib = rss_mib(procs[name].pid)
                if mib is not None:
                    rss[name].append((time.time() - started[name], mib))
                    row["rss_mib"][name] = mib
            samples.write(json.dumps(row) + "\n")
            samples.flush()
            deadline = time.time() + SAMPLE_S
            while time.time() < deadline and len(ended) < len(procs):
                for name in live:
                    if name not in ended and procs[name].poll() is not None:
                        ended[name] = time.time()
                time.sleep(0.5)
    failed = False
    for name, *_ in runs:
        logs[name].close()
        rc = procs[name].returncode
        failed |= rc != 0
        path = os.path.join(args.logs_dir, name, "result.json")
        result = {}
        if os.path.exists(path):
            with open(path) as f:
                result = json.load(f)
        wall = ended[name] - started[name]
        mib = [m for _, m in rss[name]] or [float("nan")]
        # the first sample a tenth into the run: set-up is over by then
        settled = [m for t, m in rss[name] if t >= 0.1 * wall] or mib
        print(json.dumps({
            "run": name, "rc": rc, "wall_s": wall,
            "shared_with": sorted(shared[name] - {name}),
            "rss_mib_first": settled[0], "rss_mib_last": mib[-1],
            "rss_mib_max": max(mib), **result}), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
