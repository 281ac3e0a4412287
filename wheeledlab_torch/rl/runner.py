"""Training runner — the port of `wheeledlab_tpu/rl/runner.py` (reference
wheeledlab_rl: RunConfig tree, modified OnPolicyRunner loop, checkpointing,
logging).

The loop runs one `train_iteration` per iteration and reads metrics back
to the host only every `log_every` iterations. Checkpoints hold the FULL
train state: the policy, Adam's state with its current learning rate, the
env state, both generators' states and, for a recurrent run, the LSTM
carry, so `train.load_run` resumes exactly where a run stopped."""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any, Dict, Optional

import torch

from ..envs.env import EnvState
from ..utils.config import configclass, to_dict
from ..utils.device import resolve_device
from ..utils.profiling import PhaseTimer
from .ppo import PPOCfg, TrainState, make_learner


@configclass
class LogCfg:
    """Parity: LogConfig (reference configs/common_cfg.py:12-39)."""

    logs_dir: str = "logs"
    no_log: bool = False
    log_every: int = 10
    no_checkpoints: bool = False
    checkpoint_every: int = 50       # reference save_interval=50
    video: bool = False              # top-down training videos
    video_interval: int = 500
    video_length: int = 0
    video_resolution: tuple = ()
    video_crf: int = 30
    no_wandb: bool = True            # the wandb sink is not ported (raises)
    wandb_project: str = "WheeledLab-TPU"
    test_mode: bool = False
    run_name: str = ""


@configclass
class TrainCfg:
    """Parity: RLTrainConfig (reference configs/rl_cfg.py:8-25)."""

    seed: int = 0
    num_iterations: int = 5000
    load_run: Optional[str] = None
    load_run_checkpoint: int = 0
    distributed: str = "auto"        # "auto" | "off": one process; "on"
                                     # (multi-process training) is not ported
    profile: bool = False            # torch.profiler trace of iterations
                                     # 10-12 into <run_dir>/trace.json
    fast_prng: bool = True           # TPU-only (JAX PRNG impl); ignored
    compilation_cache: str = "auto"  # TPU-only (XLA disk cache); ignored
    target_return: Optional[float] = None
    # ^ early stop once episode/return reaches this at a log point
    aot_warm_start: str = "auto"     # TPU-only (serialized XLA
                                     # executables); ignored
    log: LogCfg = LogCfg()


@configclass
class RunConfig:
    """Parity: RunConfig aggregation (reference configs/common_cfg.py:66-75),
    plus the device the run uses."""

    task_name: str = "MushrDriftRL-v0"
    num_envs: int = 1024
    train: TrainCfg = TrainCfg()
    agent: PPOCfg = PPOCfg()
    env_overrides: Any = None   # optional dict of env cfg field overrides
    device: str = "cuda"        # "cpu" only when asked for


class MetricLogger:
    """JSONL metric sink (`<run_dir>/metrics.jsonl`, one object per logged
    iteration) plus `run_config.json`."""

    def __init__(self, log_cfg: LogCfg, run_dir: str, config_dict: Dict):
        self.cfg = log_cfg
        self.run_dir = run_dir
        self._fh = None
        if log_cfg.no_log or log_cfg.test_mode:
            return
        os.makedirs(run_dir, exist_ok=True)
        with open(os.path.join(run_dir, "run_config.json"), "w") as f:
            json.dump(config_dict, f, indent=2, default=str)
        self._fh = open(os.path.join(run_dir, "metrics.jsonl"), "a")

    def log(self, it: int, metrics: Dict[str, float]):
        if self._fh is not None:
            self._fh.write(json.dumps({"iteration": it, **metrics}) + "\n")
            self._fh.flush()

    def close(self):
        if self._fh is not None:
            self._fh.close()


# ------------------------------------------------------------- checkpoints


def _checkpoint_dir(run_dir: str) -> str:
    return os.path.join(run_dir, "checkpoints")


# the recurrent learner's carry (`recurrent.RecurrentTrainState`): the LSTM
# hidden state and the previous step's done flags
_CARRY = ("hidden", "reset_prev")


def save_checkpoint(run_dir: str, learner, state: TrainState):
    """`<run_dir>/checkpoints/<iteration>.pt`, written atomically; a
    recurrent run's also holds its carry."""
    ckpt_dir = _checkpoint_dir(run_dir)
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"{state.iteration}.pt")
    torch.save({
        "iteration": state.iteration,
        "learner": learner.state_dict(),
        "env_generator": learner.env.generator.get_state(),
        "env_state": dataclasses.asdict(state.env_state),
        "obs": state.obs,
        **{k: getattr(state, k) for k in _CARRY if hasattr(state, k)},
    }, path + ".tmp")
    os.replace(path + ".tmp", path)


def checkpoint_steps(run_dir: str):
    ckpt_dir = _checkpoint_dir(run_dir)
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(f[:-3]) for f in os.listdir(ckpt_dir)
                  if f.endswith(".pt") and f[:-3].isdigit())


def restore_checkpoint(run_dir: str, step: int, learner) -> TrainState:
    """Load `step` (the latest when step <= 0) into `learner` and its env;
    returns the saved TrainState."""
    if step <= 0:
        steps = checkpoint_steps(run_dir)
        if not steps:
            raise FileNotFoundError(f"no checkpoints under {run_dir}")
        step = steps[-1]
    path = os.path.join(_checkpoint_dir(run_dir), f"{step}.pt")
    ck = torch.load(path, map_location=learner.env.device, weights_only=True)
    learner.load_state_dict(ck["learner"])
    learner.env.generator.set_state(ck["env_generator"])
    return learner.state_cls(
        env_state=EnvState(**ck["env_state"]), obs=ck["obs"],
        iteration=ck["iteration"], **{k: ck[k] for k in _CARRY if k in ck})


# -------------------------------------------------------------------- train


def _check_unported(run_cfg: RunConfig):
    mode = run_cfg.train.distributed
    if mode not in ("auto", "on", "off"):
        raise ValueError(f"train.distributed must be auto|on|off, got {mode!r}")
    if mode == "on":
        raise NotImplementedError(
            "multi-process training (train.distributed=on) is not ported yet")
    if not run_cfg.train.log.no_wandb:
        raise NotImplementedError("the wandb sink is not ported yet")


def train(run_cfg: RunConfig, env=None, max_iterations: Optional[int] = None,
          verbose: bool = True):
    """Assemble env + learner and run the training loop (reference
    train_rl.py:34-124 equivalent) on `run_cfg.device`. Returns
    (TrainState, last logged metrics)."""
    from ..tasks import make_env  # late import to avoid cycles

    _check_unported(run_cfg)
    device = resolve_device(run_cfg.device)
    seed = run_cfg.train.seed
    if env is None:
        env = make_env(run_cfg.task_name, num_envs=run_cfg.num_envs,
                       overrides=run_cfg.env_overrides, device=device,
                       seed=seed)
    learner = make_learner(env, run_cfg.agent, seed=seed)

    log_cfg = run_cfg.train.log
    run_name = log_cfg.run_name or f"run-{int(time.time())}"
    run_dir = os.path.join(log_cfg.logs_dir, run_name)
    logger = MetricLogger(log_cfg, run_dir,
                          {"run": to_dict(run_cfg), "task": run_cfg.task_name})
    save_ckpts = not (log_cfg.no_checkpoints or log_cfg.test_mode
                      or log_cfg.no_log)

    state = learner.init_state()
    if run_cfg.train.load_run:
        prev_dir = os.path.join(log_cfg.logs_dir, run_cfg.train.load_run)
        state = restore_checkpoint(prev_dir, run_cfg.train.load_run_checkpoint,
                                   learner)

    n_iter = max_iterations or run_cfg.train.num_iterations
    try:
        state, last_metrics = _train_loop(
            run_cfg, env, learner, state, logger, save_ckpts, n_iter,
            run_dir, verbose)
        if save_ckpts and state.iteration not in checkpoint_steps(run_dir):
            save_checkpoint(run_dir, learner, state)
    finally:
        logger.close()
    return state, last_metrics


def _write_video(run_cfg, env, run_dir, iteration, metrics):
    """Render the rollout's first envs top-down into
    `<run_dir>/videos/iter_<iteration>.*` and drop the `traj/*` channels
    from `metrics`. Camera tasks also get env 0's policy-view clip,
    `iter_<iteration>-policyview.*` (reference runner.py:368-385). Returns
    the paths written."""
    from ..render.topdown import render_task_frames, save_video

    log_cfg = run_cfg.train.log
    length = log_cfg.video_length or None          # 0 -> the full rollout
    pos = metrics.pop("traj/pos")[:length]
    quat = metrics.pop("traj/quat")[:length]
    yaw = metrics.pop("traj/yaw").cpu().numpy()[:length]
    cmd = metrics.pop("traj/cmd").cpu().numpy()[:length]
    vid_dir = os.path.join(run_dir, "videos")
    os.makedirs(vid_dir, exist_ok=True)
    frames = render_task_frames(env, run_cfg.task_name,
                                pos.cpu().numpy()[:, :, :2], yaw, cmd)
    paths = [save_video(frames,
                        os.path.join(vid_dir, f"iter_{iteration}.avi"),
                        resolution=log_cfg.video_resolution or None,
                        crf=log_cfg.video_crf)]
    if env.task.colormap is not None:
        paths.append(policy_view_video(
            env, pos[:, 0], quat[:, 0],
            os.path.join(vid_dir, f"iter_{iteration}-policyview.avi"),
            crf=log_cfg.video_crf))
    return paths


def policy_view_video(env, pos, quat, path, crf: int = 30) -> str:
    """The clip of what one env's camera sees over (T, 3) positions and
    (T, 4) orientations: the exact RGB render at 320 x 240, one frame a
    control step (reference CustomRecordVideo over the TiledCamera,
    custom_video_recorder.py:12-75). Returns the path written."""
    from ..render.topdown import save_video
    from ..tasks.visual.camera import render_rgb

    with torch.no_grad():
        rgb = render_rgb(env.task.colormap, pos, quat)
    frames = torch.clamp(rgb * 255.0, 0, 255).to(torch.uint8).cpu().numpy()
    return save_video(frames, path,
                      fps=max(int(round(1.0 / env.cfg.step_dt)), 1),
                      resolution=(320, 240), crf=crf)


def _train_loop(run_cfg, env, learner, state, logger, save_ckpts, n_iter,
                run_dir, verbose):
    log_cfg = run_cfg.train.log
    steps_per_iter = run_cfg.agent.num_steps_per_env * env.num_envs
    # wall-clock attribution per phase: "iterate" is the host dispatch time,
    # "device_sync" the device backlog paid when metrics are read
    timer = PhaseTimer()
    last_metrics: Dict[str, float] = {}
    profiler = None
    start_it = state.iteration
    t0 = time.time()
    for it in range(start_it, n_iter):
        if run_cfg.train.profile and it == 10:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if env.device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            profiler = torch.profiler.profile(activities=acts)
            profiler.start()
        if profiler is not None and it == 13:
            profiler.stop()
            profiler.export_chrome_trace(os.path.join(run_dir, "trace.json"))
            profiler = None
        want_video = (log_cfg.video and not log_cfg.test_mode
                      and not log_cfg.no_log
                      and (it + 1) % log_cfg.video_interval == 0)
        with timer.phase("iterate"):
            state, metrics = learner.train_iteration(
                state, capture_traj=want_video)
        if want_video:
            with timer.phase("video"):
                _write_video(run_cfg, env, run_dir, it + 1, metrics)
        if (it + 1) % log_cfg.log_every == 0 or it == n_iter - 1:
            # ONE batched device->host copy of every metric
            with timer.phase("device_sync"):
                names = list(metrics)
                values = torch.stack([metrics[k].to(torch.float32)
                                      for k in names]).tolist()
                host = dict(zip(names, values))
            if host.pop("nan/detected", 0.0) > 0.0:
                raise RuntimeError(
                    f"NaN detected in actions/losses at iteration {it + 1} "
                    "(parity: modified_rsl_rl_runner.py:74-75)")
            elapsed = time.time() - t0
            host["perf/env_steps_per_s"] = (steps_per_iter * (it + 1 - start_it)
                                            / elapsed)
            host["perf/wall_s"] = elapsed
            host.update(timer.summary())
            logger.log(it + 1, host)
            last_metrics = host
            if verbose:
                print(f"it {it + 1:5d} | return "
                      f"{host.get('episode/return', 0.0):9.1f}"
                      f" | len {host.get('episode/length', 0.0):6.1f}"
                      f" | kl {host.get('loss/kl', 0.0):.4f}"
                      f" | {host['perf/env_steps_per_s']:.2e} steps/s",
                      flush=True)
            if (run_cfg.train.target_return is not None
                    and host.get("episode/return", float("-inf"))
                    >= run_cfg.train.target_return):
                if verbose:
                    print(f"target return {run_cfg.train.target_return} "
                          f"reached at iteration {it + 1}", flush=True)
                break
        if save_ckpts and (it + 1) % log_cfg.checkpoint_every == 0:
            with timer.phase("checkpoint"):
                save_checkpoint(run_dir, learner, state)
    if profiler is not None:
        profiler.stop()
    return state, last_metrics
