"""The resume and stitch path of `scripts/full_budget_runs.py` on the CPU: a
small run of each resumable config (elevation, the recurrent drift run,
visual on its small map; 32 envs, 8 steps an env, a log point every
iteration, a checkpoint every 2) made straight and made in two segments,
the first stopped at its first checkpoint and the second resumed from it
by a second invocation, stitches to the same rows apart from `perf/*` and
`time/*`; a row that a resumed segment logged again and that differs makes
the stitch fail."""

import json
import shutil
from concurrent.futures import ThreadPoolExecutor

import cv2
import pytest

from wheeledlab_torch.rl.runner import checkpoint_steps
from wheeledlab_torch.scripts import full_budget_runs as fbr

RUN = "rss_elev_h100"
BUDGET = 4
SMALL = ["--num-envs", "32", "agent.num_steps_per_env=8",
         "train.log.log_every=1", "train.log.checkpoint_every=2",
         "--device", "cpu"]
# the visual task's small map (tests/test_learning.py::test_visual_improves)
SMALL_MAP = ["env.map_rows=100", "env.map_cols=100", "env.env_rows=20",
             "env.env_cols=20", "env.group_rows=5", "env.group_cols=5"]
# the resumable configs held here: elevation, recurrent drift, visual
SPLIT_RUNS = ("rss_elev_h100", "rss_drift_rnn_h100", "rss_visual_h100")
# the runs whose task has a camera: played with the policy-view clip
CAMERA_RUNS = ("rss_visual_h100",)


def resumable(name):
    return next(r for r in fbr.RESUMABLE if r[0] == name)


@pytest.fixture
def small(monkeypatch):
    segment_command = fbr.segment_command
    play_command = fbr.play_command

    def small_segment(args, run, k, load_run):
        cmd = segment_command(args, run, k, load_run) + SMALL
        return cmd + SMALL_MAP if run[0] == "rss_visual_h100" else cmd

    monkeypatch.setattr(fbr, "segment_command", small_segment)
    monkeypatch.setattr(fbr, "play_command",
                        lambda *a: play_command(*a) + ["--device", "cpu"])
    monkeypatch.setattr(fbr, "card", lambda: "cpu")
    monkeypatch.setattr(fbr, "PLAY_ARGS", ("--steps", "4", "--num-envs", "4"))
    monkeypatch.setattr(fbr, "build_kernels", lambda: None)
    monkeypatch.setattr(fbr, "SAMPLE_S", 0.5)
    monkeypatch.setattr(fbr, "POLL_S", 0.05)


def invoke(logs, name, *extra):
    return fbr.main(["--logs-dir", str(logs), "--only", name,
                     "--max-iterations", str(BUDGET), *extra])


def split_run(logs, name):
    """The run in two segments: the first stopped after its first
    checkpoint (iteration 2), once it has logged iteration 3; the next
    invocation resumes it from that checkpoint and plays it where its
    reference was played; a third finds nothing left to run. Returns the
    exit codes."""
    rcs = [invoke(logs, name, "--stop-after", "0")]
    assert fbr.next_segment(fbr.build_parser().parse_args(
        ["--logs-dir", str(logs)]), resumable(name)) == (
        1, f"{name}.seg0", 2)
    rcs += [invoke(logs, name), invoke(logs, name)]
    return rcs


def public(rows):
    return [{k: v for k, v in row.items()
             if not k.startswith(("perf/", "time/"))} for row in rows]


def read(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


@pytest.mark.parametrize("name", SPLIT_RUNS)
def test_two_segments_stitch_to_the_straight_run(small, tmp_path, capsys,
                                                 name):
    run = resumable(name)
    played = run[5]
    straight, split = tmp_path / "straight", tmp_path / "split"
    # the straight run beside the split one, on a thread of its own
    with ThreadPoolExecutor(1) as pool:
        straight_rc = pool.submit(invoke, straight, name)
        split_rcs = split_run(split, name)
    assert straight_rc.result() == 0
    assert split_rcs == [0, 0, 0]
    first, second = fbr.read_segments(str(split), name)
    assert first["stopped"] and not first["completed"]
    assert first["checkpoint"] == 2 and first["from_iteration"] == 0
    assert second["load_run"] == f"{name}.seg0"
    assert second["from_iteration"] == 2 and second["completed"]
    assert second["to_iteration"] == BUDGET
    play_dir = split / f"{name}.seg1" / "play"
    clip = f"{name}.seg1-policyview.mp4" if name in CAMERA_RUNS else None
    if played:
        # the rollouts and the top-down video are gone; the metrics and,
        # for a camera task, the policy-view clip are kept
        assert second["play_rc"] == 0 and second["clip"] == clip
        assert sorted(p.name for p in play_dir.iterdir()) == sorted(
            ["play_metrics.json"] + ([clip] if clip else []))
    else:
        assert "play_rc" not in second and not play_dir.exists()
    assert len(fbr.read_segments(str(split), name)) == 2
    # one checkpoint is left of the run: its last
    assert checkpoint_steps(str(split / f"{name}.seg0")) == []
    assert checkpoint_steps(str(split / f"{name}.seg1")) == [BUDGET]
    want = fbr.stitch(str(straight), run, str(tmp_path / "a"))
    got = fbr.stitch(str(split), run, str(tmp_path / "b"))
    capsys.readouterr()
    a, b = read(tmp_path / "a" / name / "metrics.jsonl"), read(
        tmp_path / "b" / name / "metrics.jsonl")
    assert [r["iteration"] for r in b] == list(range(1, BUDGET + 1))
    assert public(a) == public(b)
    assert len(got["segments"]) == 2 and len(want["segments"]) == 1
    assert got["segments"][1]["iterations"] == [2, BUDGET]
    # the stopped segment's row at 3, logged again by the resumed one
    assert got["rows_logged_twice"] == 1 and want["rows_logged_twice"] == 0
    assert got["iterations"] == want["iterations"] == BUDGET
    assert got["env_steps"] == BUDGET * 32 * 8
    assert got["value"] == pytest.approx(sum(
        s["wall_s"] for s in got["segments"]))
    assert got["target_return"] == run[4] and got["device"] == "cpu"
    assert got["return"] == b[-1]["episode/return"]
    assert (tmp_path / "b" / name / "run_config.json").exists()
    assert (tmp_path / "b" / name / "play_metrics.json").exists() == played
    stitched = sorted(p.name for p in (tmp_path / "b" / name).iterdir())
    assert stitched == sorted(
        ["metrics.jsonl", "result.json", "run_config.json"]
        + (["play_metrics.json"] if played else [])
        + ([f"{name}-policyview.mp4"] if clip else []))
    if clip:
        # 320 x 240, one frame a played step, at the control rate
        cap = cv2.VideoCapture(str(tmp_path / "b" / name /
                                   f"{name}-policyview.mp4"))
        assert (cap.get(cv2.CAP_PROP_FRAME_WIDTH),
                cap.get(cv2.CAP_PROP_FRAME_HEIGHT)) == (320, 240)
        assert cap.get(cv2.CAP_PROP_FRAME_COUNT) == 4
        assert cap.get(cv2.CAP_PROP_FPS) == 5
        cap.release()
    with open(tmp_path / "b" / name / "run_config.json") as f:
        cfg = json.load(f)["run"]
    assert cfg["train"]["load_run"] is None
    assert cfg["train"]["num_iterations"] == BUDGET
    assert cfg["train"]["log"]["run_name"] == name

    # the row the stopped segment logged past its checkpoint was logged
    # again by the next and agreed (the stitch above); had it differed,
    # the stitch fails
    seg0 = split / f"{name}.seg0" / "metrics.jsonl"
    rows = read(seg0)
    assert [r["iteration"] for r in rows] == [1, 2, 3]
    seg0.write_text("".join(json.dumps(r) + "\n" for r in rows[:2])
                    + json.dumps({**rows[2], "episode/return":
                                  rows[2]["episode/return"] + 1.0}) + "\n")
    with pytest.raises(fbr.StitchError, match="iteration 3"):
        fbr.stitch(str(split), run, str(tmp_path / "d"))


def test_unfinished_run_is_not_stitched(tmp_path):
    fbr.record_segment(str(tmp_path), RUN, {
        "segment": 0, "run_dir": f"{RUN}.seg0", "completed": False})
    with pytest.raises(fbr.StitchError, match="not finished"):
        fbr.stitch(str(tmp_path), fbr.RESUMABLE[0], str(tmp_path / "out"))


@pytest.mark.parametrize("shift", [0.0, 1.0])
def test_unfinished_run_holds_its_rows_logged_twice(tmp_path, shift):
    """An unfinished run's segments are held against each other before it
    is refused: a row logged again that agrees is counted, one that differs
    fails the stitch at its iteration."""
    def row(it, ret, wall):
        return {"iteration": it, "episode/return": ret, "perf/wall_s": wall}

    for k, rows in enumerate([[row(10, 1.0, 5.0), row(20, 2.0, 9.0)],
                              [row(20, 2.0 + shift, 3.0), row(30, 3.0, 7.0)]]):
        seg = tmp_path / fbr.segment_dir(RUN, k)
        seg.mkdir()
        (seg / "metrics.jsonl").write_text(
            "".join(json.dumps(r) + "\n" for r in rows))
        fbr.record_segment(str(tmp_path), RUN, {
            "segment": k, "run_dir": seg.name, "completed": False})
    match = ("iteration 20 of segment 1" if shift else
             "to iteration 30; 1 rows logged twice, all agree")
    with pytest.raises(fbr.StitchError, match=match):
        fbr.stitch(str(tmp_path), fbr.RESUMABLE[0], str(tmp_path / "out"))
    assert not (tmp_path / "out").exists()


def test_missing_log_point_fails(tmp_path):
    """A stitched run must hold every log point of its budget once."""
    seg = tmp_path / f"{RUN}.seg0"
    seg.mkdir()
    with open(seg / "run_config.json", "w") as f:
        json.dump({"run": {"num_envs": 32, "agent": {"num_steps_per_env": 8},
                           "train": {"num_iterations": 30,
                                     "target_return": 1e6, "load_run": None,
                                     "log": {"log_every": 10,
                                             "run_name": "x"}}}}, f)
    with open(seg / "metrics.jsonl", "w") as f:
        for it in (10, 30):
            f.write(json.dumps({"iteration": it, "perf/wall_s": it}) + "\n")
    fbr.record_segment(str(tmp_path), RUN, {
        "segment": 0, "run_dir": seg.name, "completed": True})
    with pytest.raises(fbr.StitchError, match=r"missing \[20\]"):
        fbr.stitch(str(tmp_path), fbr.RESUMABLE[0], str(tmp_path / "out"))
    shutil.rmtree(tmp_path / "out", ignore_errors=True)


def test_segments_go_through_the_train_cli_on_the_card():
    """Without the test's flags every segment is the train CLI at the
    run's full budget and settings on the card, the resumed ones with
    `train.load_run`."""
    args = fbr.build_parser().parse_args([])
    for run in fbr.RESUMABLE:
        name, config, seed, iterations, target, _ = run
        cmd = fbr.segment_command(args, run, 1, f"{name}.seg0")
        assert cmd[1:5] == ["-m", "wheeledlab_torch.cli.train", "-r", config]
        assert cmd[cmd.index("--seed") + 1] == str(seed)
        assert cmd[cmd.index("--max-iterations") + 1] == str(iterations)
        assert cmd[cmd.index("--device") + 1] == "cuda"
        assert f"train.target_return={target!r}" in cmd
        assert f"train.load_run={name}.seg0" in cmd
        assert "train.log.no_checkpoints=false" in cmd
        assert "train.log.log_every=10" in cmd
        assert "--num-envs" not in cmd


@pytest.mark.parametrize("run", [r for r in fbr.RESUMABLE if r[5]],
                         ids=lambda r: r[0])
def test_camera_runs_play_with_video(tmp_path, run):
    """A played run whose task has a camera (visual) plays with `--video`
    for its policy-view clip; the elevation plays render no video."""
    import wheeledlab_torch.rl  # noqa: F401  (registers the RSS_* configs)
    from wheeledlab_torch.utils.config import RUN_CONFIGS

    name, config = run[0], run[1]
    task = RUN_CONFIGS.get(config).task_name
    key = fbr.segment_dir(name, 1)
    (tmp_path / key).mkdir()
    with open(tmp_path / key / "run_config.json", "w") as f:
        json.dump({"run": {"task_name": task}}, f)
    video = fbr.has_camera(str(tmp_path), key)
    assert video == (name in CAMERA_RUNS)
    cmd = fbr.play_command(fbr.build_parser().parse_args(
        ["--logs-dir", str(tmp_path)]), key, video)
    assert ("--video" in cmd) == (name in CAMERA_RUNS)
    assert cmd[cmd.index("--device") + 1] == "cuda"
