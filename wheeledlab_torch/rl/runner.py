"""Training runner — the port of `wheeledlab_tpu/rl/runner.py` (reference
wheeledlab_rl: RunConfig tree, modified OnPolicyRunner loop, checkpointing,
logging).

The loop runs one `train_iteration` per iteration and reads metrics back
to the host only every `log_every` iterations. Checkpoints hold the FULL
train state: the policy, Adam's state with its current learning rate, the
env state, both generators' states and, for a recurrent run, the LSTM
carry, so `train.load_run` resumes exactly where a run stopped. They are
copied to host memory on the training thread and written by a background
thread, as orbax saves asynchronously.

With `train.distributed` on, every rank of the job runs `train()` on its
shard of the env batch (`parallel/`): all ranks hold the same policy and
metrics, each writes its own checkpoint file, and process 0 alone writes
metrics, videos and stdout."""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Any, Dict, Optional

import torch

from ..envs.env import EnvState
from ..parallel import distributed
from ..parallel.mesh import World, local_num_envs, shard_seed
from ..utils.config import configclass, to_dict
from ..utils.device import resolve_device
from ..utils.profiling import (
    PhaseTimer, drain, enable_spans, span, span_summary, trace,
)
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
    no_wandb: bool = True            # offline by default (no egress)
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
    distributed: str = "auto"        # "auto" | "on" | "off": shard the env
                                     # batch over the ranks of a
                                     # torch.distributed job (parallel/).
                                     # "auto" = on iff torchrun launched more
                                     # than one process; "on" also joins a
                                     # job of one; POD_DRIFT_CONFIG sets "on"
    profile: bool = False            # torch.profiler trace of iterations
                                     # 10-12 into <run_dir>/trace.json, on
                                     # rank 0; warns if it holds nothing of
                                     # the card (utils/profiling.trace).
                                     # Also turns the program's spans on:
                                     # each log row gets every span's calls
                                     # and mean host and device ms since the
                                     # last row (span/<name>/...)
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
    """JSONL + optional wandb metric sink: `<run_dir>/metrics.jsonl`, one
    object per logged iteration, and `run_config.json` (the reference logged
    to wandb only). `wandb` is imported lazily; without it, or when its
    `init` fails, training carries on with the JSONL sink alone."""

    def __init__(self, log_cfg: LogCfg, run_dir: str, config_dict: Dict):
        self.cfg = log_cfg
        self.run_dir = run_dir
        self._wandb = None
        self._fh = None
        if log_cfg.no_log or log_cfg.test_mode:
            return
        os.makedirs(run_dir, exist_ok=True)
        with open(os.path.join(run_dir, "run_config.json"), "w") as f:
            json.dump(config_dict, f, indent=2, default=str)
        self._fh = open(os.path.join(run_dir, "metrics.jsonl"), "a")
        if not log_cfg.no_wandb:
            try:
                import wandb

                self._wandb = wandb.init(
                    project=log_cfg.wandb_project,
                    name=log_cfg.run_name or None, config=config_dict)
            except Exception:   # no wandb, or no way to reach it
                self._wandb = None

    def log(self, it: int, metrics: Dict[str, float]):
        if self._fh is not None:
            self._fh.write(json.dumps({"iteration": it, **metrics}) + "\n")
            self._fh.flush()
        if self._wandb is not None:
            self._wandb.log(metrics, step=it)

    def log_video(self, it: int, frames, fps: int = 50):
        """Upload a (T, H, W, 3) uint8 clip to wandb (the reference uploads
        its training videos, custom_video_recorder.py:49-75)."""
        if self._wandb is None:
            return
        try:
            import wandb

            self._wandb.log(
                {"video": wandb.Video(frames.transpose(0, 3, 1, 2), fps=fps)},
                step=it)
        except Exception:   # an upload failure never stops training
            pass

    def close(self):
        if self._fh is not None:
            self._fh.close()
        if self._wandb is not None:
            self._wandb.finish()


# ------------------------------------------------------------- checkpoints


def _checkpoint_dir(run_dir: str) -> str:
    return os.path.join(run_dir, "checkpoints")


def checkpoint_path(run_dir: str, step: int, rank: int = 0) -> str:
    """Rank 0's `<step>.pt` (the learner, its shard and generators: what
    `cli/play.py` and `cli/export.py` read), or rank r's `<step>.rank<r>.pt`
    (its shard and generators)."""
    name = f"{step}.pt" if rank == 0 else f"{step}.rank{rank}.pt"
    return os.path.join(_checkpoint_dir(run_dir), name)


# the recurrent learner's carry (`recurrent.RecurrentTrainState`): the LSTM
# hidden state and the previous step's done flags
_CARRY = ("hidden", "reset_prev")


def _to_host(x, pinned):
    """A copy of the tensors of a nested dict / list / tuple in host memory:
    CUDA tensors into pinned buffers by non-blocking copies (recorded in
    `pinned` as their devices), CPU tensors cloned."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.device.type != "cuda":
            return x.clone()
        out = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        out.copy_(x, non_blocking=True)
        pinned.add(x.device)
        return out
    if isinstance(x, dict):
        return {k: _to_host(v, pinned) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_to_host(v, pinned) for v in x)
    return x


class CheckpointWriter:
    """Writes checkpoints off the training thread. `save` copies the payload
    to host memory (pinned, non-blocking, one stream sync), so training may
    go on changing its tensors, and hands the copy to one background thread
    that writes it with `torch.save` + `os.replace`. A save first waits for
    the previous write; `wait` joins it and raises what it raised."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, path: str, payload: dict):
        self.wait()
        pinned = set()
        host = _to_host(payload, pinned)
        for dev in pinned:
            torch.cuda.current_stream(dev).synchronize()
        self._thread = threading.Thread(target=self._write, args=(path, host),
                                        name="checkpoint-writer")
        self._thread.start()

    def _write(self, path: str, payload: dict):
        try:
            os.makedirs(os.path.dirname(path), exist_ok=True)
            torch.save(payload, path + ".tmp")
            os.replace(path + ".tmp", path)
        except BaseException as e:   # raised on the training thread by wait
            self._error = e

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            error, self._error = self._error, None
            raise error


def checkpoint_payload(learner, state: TrainState, world: World) -> dict:
    """What rank `world.rank` saves of `state`: its env shard, its
    generators and, for a recurrent run, its carry; rank 0 also the
    learner (policy, Adam with its LR, generator)."""
    es = state.env_state
    payload = {
        "iteration": state.iteration,
        "world_size": world.size,
        "env_generator": learner.env.generator.get_state(),
        "env_state": es.to_dict(),
        "obs": state.obs,
        **{k: getattr(state, k) for k in _CARRY if hasattr(state, k)},
    }
    if world.rank == 0:
        payload["learner"] = learner.state_dict()
    else:
        payload["generator"] = learner.generator.get_state()
    return payload


def save_checkpoint(run_dir: str, learner, state: TrainState, world: World,
                    writer: CheckpointWriter):
    """This rank's checkpoint of `state` (`checkpoint_path`), written
    atomically by `writer`'s thread."""
    writer.save(checkpoint_path(run_dir, state.iteration, world.rank),
                checkpoint_payload(learner, state, world))


def checkpoint_steps(run_dir: str):
    """The iterations rank 0 saved, in order."""
    ckpt_dir = _checkpoint_dir(run_dir)
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(f[:-3]) for f in os.listdir(ckpt_dir)
                  if f.endswith(".pt") and f[:-3].isdigit())


def _load(path: str, device, world: World) -> dict:
    ck = torch.load(path, map_location=device, weights_only=True)
    saved = ck.get("world_size", 1)
    if saved != world.size:
        raise ValueError(
            f"{path} was saved by a world of {saved} ranks and this job has "
            f"{world.size}: resume with the world size that saved it")
    return ck


def restore_checkpoint(run_dir: str, step: int, learner,
                       world: World = World()) -> TrainState:
    """Load `step` (the latest when step <= 0) into `learner` and its env
    shard: the learner from rank 0's file, the shard, its generators and
    carry from this rank's own. Returns the saved TrainState. Raises when
    the world size differs from the one that saved it (the shards are not
    re-cut)."""
    if step <= 0:
        steps = checkpoint_steps(run_dir)
        if not steps:
            raise FileNotFoundError(f"no checkpoints under {run_dir}")
        step = steps[-1]
    dev = learner.env.device
    ck = _load(checkpoint_path(run_dir, step), dev, world)
    learner.load_state_dict(ck["learner"])
    if world.rank > 0:
        ck = _load(checkpoint_path(run_dir, step, world.rank), dev, world)
        learner.generator.set_state(ck["generator"].cpu())
    learner.env.generator.set_state(ck["env_generator"].cpu())
    return learner.state_cls(
        env_state=EnvState.from_dict(ck["env_state"]), obs=ck["obs"],
        iteration=ck["iteration"], **{k: ck[k] for k in _CARRY if k in ck})


# -------------------------------------------------------------------- train


def _resolve_world(run_cfg: RunConfig) -> World:
    """This process's world (reference runner.py:175-204), a world of one
    unless training is distributed over several ranks. "off" never joins a
    job; "auto" joins one exactly when torchrun launched more than one
    process; "on" joins whatever job launched it, and a single process
    stays a world of one, unsharded. Raises unless the ranks divide
    `num_envs`."""
    mode = run_cfg.train.distributed
    if mode not in ("auto", "on", "off"):
        raise ValueError(f"train.distributed must be auto|on|off, got {mode!r}")
    if mode == "off" or (mode == "auto" and not distributed.launched()):
        return World()
    distributed.initialize(device=run_cfg.device)
    world = distributed.world()
    local_num_envs(run_cfg.num_envs, world.size)
    return world


def setup(run_cfg: RunConfig, env=None):
    """(world, env, learner) of this process: the env holds this rank's
    share of `num_envs` on its card, seeded with its shard seed, and the
    learner reduces over the world. `env`, when given, is this rank's
    shard (`make_env(shard=rank)`)."""
    from ..tasks import make_env  # late import to avoid cycles

    world = _resolve_world(run_cfg)
    device = resolve_device(run_cfg.device)
    if world.size > 1 and device.type == "cuda":
        device = distributed.local_device()
    seed = run_cfg.train.seed
    if env is None:
        env = make_env(run_cfg.task_name,
                       num_envs=local_num_envs(run_cfg.num_envs, world.size),
                       overrides=run_cfg.env_overrides, device=device,
                       seed=shard_seed(seed, world.rank), shard=world.rank)
    elif env.shard != world.rank:
        raise ValueError(f"the env given is shard {env.shard} and this "
                         f"process is rank {world.rank}: build it with "
                         f"make_env(shard={world.rank})")
    return world, env, make_learner(env, run_cfg.agent, seed=seed,
                                    world=world)


def train(run_cfg: RunConfig, env=None, max_iterations: Optional[int] = None,
          verbose: bool = True):
    """Assemble env + learner and run the training loop (reference
    train_rl.py:34-124 equivalent) on `run_cfg.device`. Returns
    (TrainState, last logged metrics). In a distributed run every rank
    calls it; see `setup`."""
    world, env, learner = setup(run_cfg, env)
    is_main = world.rank == 0

    log_cfg = run_cfg.train.log
    run_name = log_cfg.run_name or f"run-{int(time.time())}"
    if world.size > 1 and not log_cfg.run_name:
        # every rank writes under process 0's run directory
        run_name = distributed.broadcast_object(run_name)
    run_dir = os.path.join(log_cfg.logs_dir, run_name)
    # metrics, videos and stdout are process 0's; every rank checkpoints
    logger = MetricLogger(log_cfg if is_main else log_cfg.replace(no_log=True),
                          run_dir,
                          {"run": to_dict(run_cfg), "task": run_cfg.task_name})
    save_ckpts = not (log_cfg.no_checkpoints or log_cfg.test_mode
                      or log_cfg.no_log)
    writer = CheckpointWriter()

    state = learner.init_state()
    if run_cfg.train.load_run:
        prev_dir = os.path.join(log_cfg.logs_dir, run_cfg.train.load_run)
        state = restore_checkpoint(prev_dir, run_cfg.train.load_run_checkpoint,
                                   learner, world)

    n_iter = max_iterations or run_cfg.train.num_iterations
    if run_cfg.train.profile:
        enable_spans(True, env.device)
    try:
        state, last_metrics, saved = _train_loop(
            run_cfg, env, learner, state, logger, save_ckpts, writer, world,
            n_iter, run_dir, verbose and is_main)
        if save_ckpts and saved != state.iteration:
            save_checkpoint(run_dir, learner, state, world, writer)
    finally:
        if run_cfg.train.profile:
            enable_spans(False)
            drain()
        try:
            writer.wait()
        finally:
            logger.close()
    return state, last_metrics


def _write_video(run_cfg, env, run_dir, iteration, metrics, logger):
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
    logger.log_video(iteration, frames)
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


def _train_loop(run_cfg, env, learner, state, logger, save_ckpts, writer,
                world, n_iter, run_dir, verbose):
    """The iterations; returns (state, last logged metrics, the last
    iteration checkpointed or None). The NaN raise and the target-return
    stop read all-reduced metrics, so every rank leaves at the same
    iteration; IO that only process 0 does (`logger.cfg.no_log` is set on
    the others) holds no collective. With `train.profile` the program's
    spans are on (see `train`) and drained at each log point, right after
    the metric read has waited for the card."""
    log_cfg = run_cfg.train.log
    # env-steps of the whole job
    steps_per_iter = (run_cfg.agent.num_steps_per_env * env.num_envs
                      * world.size)
    saved = None
    # wall-clock attribution per phase: "iterate" is the host dispatch time,
    # "device_sync" the device backlog paid when metrics are read
    timer = PhaseTimer()
    last_metrics: Dict[str, float] = {}
    profiling = contextlib.ExitStack()   # the trace of iterations 10-12
    start_it = state.iteration
    t0 = time.time()
    for it in range(start_it, n_iter):
        if run_cfg.train.profile and world.rank == 0 and it == 10:
            profiling.enter_context(trace(run_dir))
        if it == 13:
            profiling.close()
        want_video = (log_cfg.video and not log_cfg.test_mode
                      and not logger.cfg.no_log
                      and (it + 1) % log_cfg.video_interval == 0)
        with timer.phase("iterate"):
            state, metrics = learner.train_iteration(
                state, capture_traj=want_video)
        if want_video:
            with timer.phase("video"), span("runner.video"):
                _write_video(run_cfg, env, run_dir, it + 1, metrics, logger)
        if (it + 1) % log_cfg.log_every == 0 or it == n_iter - 1:
            # ONE batched device->host copy of every metric
            with timer.phase("device_sync"), span("runner.log"):
                names = list(metrics)
                values = torch.stack([metrics[k].to(torch.float32)
                                      for k in names]).tolist()
                host = dict(zip(names, values))
            if run_cfg.train.profile:
                host.update(span_summary(drain()))
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
            # the copy to host memory; the file is written off this thread
            with timer.phase("checkpoint"), span("runner.checkpoint"):
                save_checkpoint(run_dir, learner, state, world, writer)
            saved = state.iteration
    profiling.close()
    return state, last_metrics, saved
