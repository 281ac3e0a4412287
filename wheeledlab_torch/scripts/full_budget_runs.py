"""The full-budget runs on one card, as `docs/runs/*_h100/` were made.

Starts one process a run, all together (the iterations are host-bound, so
runs can share the card), each at the reference's budget with the reference
artifacts' settings. Two kinds of run:

- the drift runs, one `python -m wheeledlab_torch.scripts.train_bench`
  process each (`--target-return 1e6 --log-every 10 --no-checkpoints`, as
  their references' `run_config.json` record), started when `--only` is not
  given:

    rss_drift_h100, rss_drift_h100_seed1   RSS_DRIFT_CONFIG, seeds 0, 1,
                                           5000 iterations
    f1tenth_drift_h100_seed0 ... _seed4    F1TENTH_DRIFT_CONFIG, seeds 0-4,
                                           1500 iterations

- the resumable runs, selected with `--only`, longer than one call to the
  card may last. Each is a chain of segments, each segment one `python -m
  wheeledlab_torch.cli.train -r <CONFIG> --seed <seed>` process with the
  run's log settings (`train.target_return`, `log_every` 10, checkpoints
  every 50 iterations) writing `<logs-dir>/<name>.seg<k>/`; segment k > 0
  resumes from the latest complete checkpoint of the run
  (`train.load_run=<name>.seg<j>`). A later invocation with the same
  `--logs-dir` continues every unfinished run, and plays each run that
  ends (`cli.play --steps 500 --num-envs 64`) when its reference committed
  play metrics, with `--video` where its task has a camera (the
  reference's visual run committed its policy-view clip):

    rss_elev_h100, rss_elev_h100_seed1     RSS_ELEV_CONFIG, seeds 0, 1,
                                           4000 iterations, target 1e6
    rss_elev_goal_h100                     ELEV_GOAL_CONFIG, 1500, 1e7
    rss_visual_h100                        RSS_VISUAL_CONFIG, 4000, 1e7
    rss_drift_rnn_h100                     RSS_DRIFT_RNN_CONFIG, 1500, 1e6

    python -m wheeledlab_torch.scripts.full_budget_runs [--logs-dir logs]
        [--only rss_elev_h100 ...] [--max-iterations N] [--stop-after S]
    python -m wheeledlab_torch.scripts.full_budget_runs --logs-dir logs
        --only rss_elev_h100 ... --stitch docs/runs

`--stop-after S` stops each resumable process once it has logged the first
log point after its first checkpoint written S seconds or more after the
start (at S + `STOP_GRACE_S` whatever it has written), so that a call of
limited length ends on checkpoints, and the next segment logs that point
again: the stitch holds the two rows against each other.
Checkpoints are written to `<path>.tmp` and renamed, so a stopped process
leaves its last one whole; when a segment ends, every checkpoint of its run
but the latest is deleted. `<logs-dir>/<name>.segments.jsonl` records each
segment: the iteration it resumed from, its last log point and checkpoint,
its exit code, wall seconds, the card and the runs it shared the card with.

A played run keeps its `play_metrics.json` and, where it has a camera, its
policy-view clip `<run dir>-policyview.*`; its rollouts and its top-down
video are deleted.
`--stitch OUT` writes each selected resumable run as one run under
`OUT/<name>/`, as `docs/runs/<name>/` commits it: `metrics.jsonl` with every
log point of the budget once (a row that a resumed segment logged again
must agree with the earlier one in every metric but `perf/*` and `time/*`,
or the stitch fails: resuming is exact), the first segment's
`run_config.json` with `load_run` null, `result.json` with `train_bench`'s
keys over the whole run plus `segments` and the number of rows logged
twice, and `play_metrics.json` and the policy-view clip (as
`<name>-policyview.*`) where the run was played. A run not yet finished is not written: the stitch holds
its rows logged twice all the same and reports them. It needs no device.

A drift run writes `<logs-dir>/<name>/` (metrics.jsonl, run_config.json,
result.json). Every process writes its output to `<logs-dir>/<run dir>.log`.
While they run, the resident memory of every process is sampled every
`SAMPLE_S` seconds into `<logs-dir>/full_budget_samples.jsonl`. At the end
one JSON line a run: its exit code, wall seconds, the runs it shared the
card with, its resident memory at the first sample a tenth into the run, at
the last sample and at most, and a drift run's `result.json` or a resumable
run's segment. The exit code is 1 if a run failed.
"""

from __future__ import annotations

import argparse
import glob
import json
import math
import os
import shutil
import subprocess
import sys
import time

from ..rl.runner import checkpoint_steps

RUNS = (("rss_drift_h100", "RSS_DRIFT_CONFIG", 0, 5000),
        ("rss_drift_h100_seed1", "RSS_DRIFT_CONFIG", 1, 5000),
        *((f"f1tenth_drift_h100_seed{s}", "F1TENTH_DRIFT_CONFIG", s, 1500)
          for s in range(5)))
# (name, config, seed, iterations, target return, play when done): the
# settings of the reference artifacts `rss_elev_tpu`, `rss_elev_tpu_seed1`,
# `rss_elev_goal_tpu`, `rss_visual_tpu` and `rss_drift_rnn_tpu`
RESUMABLE = (("rss_elev_h100", "RSS_ELEV_CONFIG", 0, 4000, 1e6, True),
             ("rss_elev_h100_seed1", "RSS_ELEV_CONFIG", 1, 4000, 1e6, False),
             ("rss_elev_goal_h100", "ELEV_GOAL_CONFIG", 0, 1500, 1e7, True),
             ("rss_visual_h100", "RSS_VISUAL_CONFIG", 0, 4000, 1e7, True),
             ("rss_drift_rnn_h100", "RSS_DRIFT_RNN_CONFIG", 0, 1500, 1e6,
              False))
# the reference's playback: 500 steps of 64 envs
# (docs/runs/rss_elev_tpu/goal_analysis.md)
PLAY_ARGS = ("--steps", "500", "--num-envs", "64")
# the tasks with a camera, played with `--video` for env 0's policy-view
# clip (docs/runs/rss_visual_tpu/rss_visual_tpu-policyview.mp4)
CAMERA_TASKS = ("MushrVisualRL-v0",)
SAMPLE_S = 30.0      # seconds between samples of the processes' memory
STOP_GRACE_S = 300.0  # seconds a stopped process has to reach a checkpoint
POLL_S = 0.5


class StitchError(RuntimeError):
    """The segments of a run do not make one whole run."""


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--logs-dir", default="logs")
    p.add_argument("--only", nargs="+", default=None,
                   help="run names to start (default: the seven drift runs)")
    p.add_argument("--max-iterations", type=int, default=None,
                   help="cut every run to N iterations (a short check)")
    p.add_argument("--stop-after", type=float, default=None,
                   help="stop each resumable run once it has logged the "
                        "point after its first checkpoint past S seconds")
    p.add_argument("--stitch", default=None, metavar="OUT",
                   help="write each selected resumable run's segments as "
                        "one run under OUT/<name>/ and exit")
    return p


def command(args, name, config, seed, iterations):
    return [sys.executable, "-m", "wheeledlab_torch.scripts.train_bench",
            "--config", config, "--seed", str(seed),
            "--max-iterations", str(args.max_iterations or iterations),
            "--logs-dir", args.logs_dir, "--run-name", name,
            "--target-return", "1e6", "--log-every", "10", "--no-checkpoints"]


def segment_dir(name: str, k: int) -> str:
    return f"{name}.seg{k}"


def segment_command(args, run, k, load_run):
    """Segment k of `run`: the train CLI with the run's settings, resuming
    from the run directory `load_run` (None for the first segment)."""
    name, config, seed, iterations, target, _ = run
    cmd = [sys.executable, "-m", "wheeledlab_torch.cli.train",
           "-r", config, "--seed", str(seed),
           "--max-iterations", str(args.max_iterations or iterations),
           "--device", "cuda",
           f"train.target_return={target!r}",
           f"train.log.logs_dir={args.logs_dir}",
           f"train.log.run_name={segment_dir(name, k)}",
           "train.log.log_every=10", "train.log.checkpoint_every=50",
           "train.log.no_checkpoints=false"]
    if load_run is not None:
        cmd.append(f"train.load_run={load_run}")
    return cmd


def play_command(args, run_dir, video=False):
    cmd = [sys.executable, "-m", "wheeledlab_torch.cli.play",
           "--run", run_dir, "--logs-dir", args.logs_dir,
           "--device", "cuda", *PLAY_ARGS]
    return cmd + ["--video"] if video else cmd


def has_camera(logs_dir: str, run_dir: str) -> bool:
    with open(os.path.join(logs_dir, run_dir, "run_config.json")) as f:
        return json.load(f)["run"]["task_name"] in CAMERA_TASKS


def find_clip(play_dir: str, run_dir: str):
    """The policy-view clip `cli.play --video` wrote in `play_dir` (its
    extension the encoder's: `.mp4` through OpenCV), or None."""
    clips = glob.glob(os.path.join(glob.escape(play_dir),
                                   f"{glob.escape(run_dir)}-policyview.*"))
    return clips[0] if clips else None


def drop_play_bulk(play_dir: str, run_dir: str):
    """Delete the rollouts (visual's: 500 x 64 x 3208 float32 observations,
    about 410 MB) and the top-down video, which are not kept;
    play_metrics.json and the policy-view clip are."""
    for f in os.listdir(play_dir):
        if (f == f"{run_dir}-rollouts.npz"
                or os.path.splitext(f)[0] == run_dir):
            os.remove(os.path.join(play_dir, f))


def build_kernels():
    """Build the kernels once, before the processes that load them start."""
    from ..ops import build

    build.build_all(build.SOURCES)


def card() -> str:
    """The card's name and power limit, as each segment records them."""
    from ..utils.device import describe

    return describe("cuda")


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


# ---------------------------------------------------------------- segments


def segments_path(logs_dir: str, name: str) -> str:
    return os.path.join(logs_dir, f"{name}.segments.jsonl")


def read_segments(logs_dir: str, name: str) -> list:
    path = segments_path(logs_dir, name)
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def record_segment(logs_dir: str, name: str, segment: dict):
    with open(segments_path(logs_dir, name), "a") as f:
        f.write(json.dumps(segment) + "\n")


def latest_checkpoint(logs_dir: str, segments: list):
    """(run directory, iteration) of the run's latest whole checkpoint over
    its recorded segments, or None."""
    best = None
    for seg in segments:
        steps = checkpoint_steps(os.path.join(logs_dir, seg["run_dir"]))
        if steps and (best is None or steps[-1] > best[1]):
            best = (seg["run_dir"], steps[-1])
    return best


def prune_checkpoints(logs_dir: str, segments: list):
    """Delete every checkpoint file of the run but its latest whole one."""
    keep = latest_checkpoint(logs_dir, segments)
    for seg in segments:
        ckpt_dir = os.path.join(logs_dir, seg["run_dir"], "checkpoints")
        if not os.path.isdir(ckpt_dir):
            continue
        for f in os.listdir(ckpt_dir):
            if keep is None or (seg["run_dir"], f) != (keep[0],
                                                       f"{keep[1]}.pt"):
                os.remove(os.path.join(ckpt_dir, f))


def read_rows(path: str) -> list:
    """The rows of a metrics.jsonl; a last line cut by a stopped process is
    dropped."""
    if not os.path.exists(path):
        return []
    rows = []
    with open(path) as f:
        for line in f:
            try:
                rows.append(json.loads(line))
            except json.JSONDecodeError:
                break
    return rows


def next_segment(args, run):
    """(k, load_run, from_iteration) of the run's next segment, or None
    when its last segment finished the run."""
    segments = read_segments(args.logs_dir, run[0])
    if segments and segments[-1]["completed"]:
        return None
    latest = latest_checkpoint(args.logs_dir, segments)
    k = len(segments)
    if latest is None:
        return k, None, 0
    return k, latest[0], latest[1]


# -------------------------------------------------------------- the stitch


def _public(row: dict) -> dict:
    return {k: v for k, v in row.items()
            if not k.startswith(("perf/", "time/"))}


def _same(a, b) -> bool:
    return a == b or (isinstance(a, float) and isinstance(b, float)
                      and math.isnan(a) and math.isnan(b))


def stitch_rows(name: str, segment_rows: list) -> dict:
    """{iteration: row} over the segments' rows in order, a later segment's
    row replacing an earlier one at the same log point. Raises StitchError
    where the two disagree in a metric other than `perf/*` and `time/*`."""
    rows, source = {}, {}
    for k, seg_rows in enumerate(segment_rows):
        for row in seg_rows:
            it = row["iteration"]
            if it in rows:
                old, new = _public(rows[it]), _public(row)
                differ = sorted(key for key in set(old) | set(new)
                                if not _same(old.get(key), new.get(key)))
                if differ:
                    raise StitchError(
                        f"{name}: iteration {it} of segment {k} differs "
                        f"from segment {source[it]}'s in "
                        + ", ".join(f"{key} ({old.get(key)!r} against "
                                    f"{new.get(key)!r})"
                                    for key in differ[:5]))
            rows[it], source[it] = row, k
    return rows


def steady(rows: list):
    """(iterations, seconds) between the first and last of one segment's
    rows: `perf/wall_s` restarts in every segment, so a rate never spans a
    seam."""
    if len(rows) < 2:
        return 0, 0.0
    return (rows[-1]["iteration"] - rows[0]["iteration"],
            rows[-1]["perf/wall_s"] - rows[0]["perf/wall_s"])


def stitch(logs_dir: str, run, out_dir: str) -> dict:
    """Write `run`'s segments under `logs_dir` as one run in
    `out_dir/<name>/`; returns its result. Raises StitchError when the run
    is not whole: two segments disagreeing (checked first, so that an
    unfinished run's resumed rows are held too), a segment missing, or a
    log point missing or twice."""
    name, config = run[0], run[1]
    segments = read_segments(logs_dir, name)
    seg_rows = [read_rows(os.path.join(logs_dir, s["run_dir"],
                                       "metrics.jsonl")) for s in segments]
    rows = stitch_rows(name, seg_rows)
    twice = sum(map(len, seg_rows)) - len(rows)
    if not segments or not segments[-1]["completed"]:
        raise StitchError(f"{name}: the run has not finished "
                          f"({len(segments)} segments, to iteration "
                          f"{max(rows, default=0)}; {twice} rows logged twice, "
                          f"all agree)")
    with open(os.path.join(logs_dir, segments[0]["run_dir"],
                           "run_config.json")) as f:
        run_config = json.load(f)
    cfg = run_config["run"]
    budget = cfg["train"]["num_iterations"]
    every = cfg["train"]["log"]["log_every"]
    want = list(range(every, budget + 1, every))
    if budget % every:
        want.append(budget)
    if sorted(rows) != want:
        missing = sorted(set(want) - set(rows))
        extra = sorted(set(rows) - set(want))
        raise StitchError(f"{name}: log points missing {missing[:5]} "
                          f"({len(missing)}), unexpected {extra[:5]}")
    cfg["train"]["load_run"] = None
    cfg["train"]["log"]["run_name"] = name
    ordered = [rows[it] for it in want]

    steps_per_iter = cfg["num_envs"] * cfg["agent"]["num_steps_per_env"]
    wall = sum(s["wall_s"] for s in segments)
    d_it = d_wall = 0.0
    described = []
    for seg, own in zip(segments, seg_rows):
        n, s = steady(own)
        d_it, d_wall = d_it + n, d_wall + s
        seg["steady_ms_per_iteration"] = s / n * 1e3 if n else None
        seg["train_s"] = own[-1]["perf/wall_s"] if own else 0.0
        if seg["device"] not in described:
            described.append(seg["device"])
    final_return = ordered[-1].get("episode/return", float("nan"))
    target = cfg["train"]["target_return"]
    train_s = sum(s["train_s"] for s in segments)
    result = {
        "metric": f"{config.lower()}_train_to_return_s",
        "value": wall,
        "unit": "s",
        "return": final_return,
        "target_return": target,
        "reached": final_return >= target,
        "iterations": want[-1],
        "env_steps": want[-1] * steps_per_iter,
        "vs_baseline": 7200.0 / max(wall, 1e-9),
        "steady_ms_per_iteration": d_wall / d_it * 1e3 if d_it else None,
        "steady_env_steps_per_s": (steps_per_iter * d_it / d_wall
                                   if d_wall else None),
        "train_s": train_s,
        "startup_s": wall - train_s,
        "device": "; ".join(described),
        # the log points a resumed segment logged again, each held equal
        "rows_logged_twice": twice,
        "segments": [{
            "segment": s["segment"],
            "iterations": [s["from_iteration"], s["to_iteration"]],
            "checkpoint": s["checkpoint"],
            "wall_s": s["wall_s"],
            "train_s": s["train_s"],
            "steady_ms_per_iteration": s["steady_ms_per_iteration"],
            "shared_with": s["shared_with"],
            "stopped": s["stopped"],
            "device": s["device"],
        } for s in segments],
    }
    dest = os.path.join(out_dir, name)
    os.makedirs(dest, exist_ok=True)
    with open(os.path.join(dest, "metrics.jsonl"), "w") as f:
        for row in ordered:
            f.write(json.dumps(row) + "\n")
    with open(os.path.join(dest, "run_config.json"), "w") as f:
        json.dump(run_config, f, indent=2)
    with open(os.path.join(dest, "result.json"), "w") as f:
        json.dump(result, f)
    play_dir = os.path.join(logs_dir, segments[-1]["run_dir"], "play")
    played = os.path.join(play_dir, "play_metrics.json")
    if os.path.exists(played):
        shutil.copyfile(played, os.path.join(dest, "play_metrics.json"))
    clip = find_clip(play_dir, segments[-1]["run_dir"])
    if clip is not None:
        shutil.copyfile(clip, os.path.join(
            dest, f"{name}-policyview{os.path.splitext(clip)[1]}"))
    return result


# -------------------------------------------------------------------- main


def _select(args):
    if args.only is None:
        return list(RUNS), []
    drift = [r for r in RUNS if r[0] in args.only]
    resumable = [r for r in RESUMABLE if r[0] in args.only]
    if len(drift) + len(resumable) != len(args.only):
        raise SystemExit(f"unknown run in {args.only}")
    return drift, resumable


def _stop(proc):
    proc.terminate()
    try:
        proc.wait(timeout=30)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()


def main(argv=None) -> int:
    args = build_parser().parse_args(sys.argv[1:] if argv is None else argv)
    drift, resumable = _select(args)
    if args.stitch is not None:
        failed = False
        for run in resumable:
            try:
                result = stitch(args.logs_dir, run, args.stitch)
            except StitchError as e:
                failed = True
                result = {"error": str(e)}
            print(json.dumps({"run": run[0], **result}), flush=True)
        return 1 if failed else 0
    os.makedirs(args.logs_dir, exist_ok=True)
    plans = {run[0]: (run, next_segment(args, run)) for run in resumable}
    plans = {name: plan for name, plan in plans.items()
             if plan[1] is not None}
    if drift or plans:
        build_kernels()
    device = card() if plans else None
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    # process key (the run's directory) -> (run name, command)
    todo = {name: (name, command(args, name, config, seed, iterations))
            for name, config, seed, iterations in drift}
    for name, (run, (k, load_run, _)) in plans.items():
        todo[segment_dir(name, k)] = (name, segment_command(args, run, k,
                                                            load_run))
    procs, logs, started = {}, {}, {}
    for key, (_, cmd) in todo.items():
        logs[key] = open(os.path.join(args.logs_dir, f"{key}.log"), "w")
        started[key] = time.time()
        procs[key] = subprocess.Popen(cmd, env=env, stdout=logs[key],
                                      stderr=subprocess.STDOUT)
    rss = {key: [] for key in procs}    # (seconds since start, MiB)
    shared = {key: set() for key in procs}
    ended, stopped, marks, saved = {}, set(), {}, {}
    segment_keys = {segment_dir(n, plan[1][0]) for n, plan in plans.items()}
    t0 = time.time()
    with open(os.path.join(args.logs_dir, "full_budget_samples.jsonl"),
              "a") as samples:
        while len(ended) < len(procs):
            live = [key for key in procs if key not in ended]
            row = {"t_s": time.time() - t0, "rss_mib": {}}
            for key in live:
                shared[key].update(todo[other][0] for other in live)
                mib = rss_mib(procs[key].pid)
                if mib is not None:
                    rss[key].append((time.time() - started[key], mib))
                    row["rss_mib"][key] = mib
            samples.write(json.dumps(row) + "\n")
            samples.flush()
            deadline = time.time() + SAMPLE_S
            while time.time() < deadline and len(ended) < len(procs):
                now = time.time() - t0
                for key in live:
                    if key in ended:
                        continue
                    if procs[key].poll() is not None:
                        ended[key] = time.time()
                        continue
                    if (key not in segment_keys or args.stop_after is None
                            or now < args.stop_after):
                        continue
                    steps = checkpoint_steps(os.path.join(args.logs_dir,
                                                          key))
                    last = steps[-1] if steps else 0
                    marks.setdefault(key, last)
                    if last > marks[key] and key not in saved:
                        saved[key] = last
                    if key in saved:
                        rows = read_rows(os.path.join(args.logs_dir, key,
                                                      "metrics.jsonl"))
                        logged = rows[-1]["iteration"] if rows else 0
                    if ((key in saved and logged > saved[key])
                            or now >= args.stop_after + STOP_GRACE_S):
                        _stop(procs[key])
                        stopped.add(key)
                        ended[key] = time.time()
                time.sleep(POLL_S)
    failed = False
    lines = []
    for key in procs:
        logs[key].close()
        name = todo[key][0]
        rc = procs[key].returncode
        wall = ended[key] - started[key]
        mib = [m for _, m in rss[key]] or [float("nan")]
        # the first sample a tenth into the run: set-up is over by then
        settled = [m for t, m in rss[key] if t >= 0.1 * wall] or mib
        line = {"run": name, "rc": rc, "wall_s": wall,
                "shared_with": sorted(shared[key] - {name}),
                "rss_mib_first": settled[0], "rss_mib_last": mib[-1],
                "rss_mib_max": max(mib)}
        if key in segment_keys:
            run, (k, load_run, start) = plans[name]
            rows = read_rows(os.path.join(args.logs_dir, key,
                                          "metrics.jsonl"))
            steps = checkpoint_steps(os.path.join(args.logs_dir, key))
            segment = {"segment": k, "run_dir": key, "load_run": load_run,
                       "from_iteration": start,
                       "to_iteration": rows[-1]["iteration"] if rows
                       else start,
                       "checkpoint": steps[-1] if steps else None,
                       "rc": rc, "stopped": key in stopped,
                       "completed": rc == 0 and key not in stopped,
                       "wall_s": wall, "shared_with": line["shared_with"],
                       "device": device, **{m: line[m] for m in (
                           "rss_mib_first", "rss_mib_last", "rss_mib_max")}}
            failed |= not (segment["completed"] or segment["stopped"])
            if segment["completed"] and run[5]:
                video = has_camera(args.logs_dir, key)
                with open(os.path.join(args.logs_dir, f"{key}.play.log"),
                          "w") as out:
                    segment["play_rc"] = subprocess.run(
                        play_command(args, key, video), env=env, stdout=out,
                        stderr=subprocess.STDOUT).returncode
                play_dir = os.path.join(args.logs_dir, key, "play")
                if os.path.isdir(play_dir):
                    drop_play_bulk(play_dir, key)
                clip = find_clip(play_dir, key)
                segment["clip"] = clip and os.path.basename(clip)
                failed |= segment["play_rc"] != 0 or (video and clip is None)
            record_segment(args.logs_dir, name, segment)
            prune_checkpoints(args.logs_dir, read_segments(args.logs_dir,
                                                           name))
            line.update(segment)
        else:
            failed |= rc != 0
            path = os.path.join(args.logs_dir, name, "result.json")
            if os.path.exists(path):
                with open(path) as f:
                    line.update(json.load(f))
        lines.append(line)
    for line in lines:
        print(json.dumps(line), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
