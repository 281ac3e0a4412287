"""Lockstep of the port's PPO iteration with the JAX learner's, on the JAX
learner's own random draws: the helpers of tests/test_torch_lockstep*.py.

How it works:

1. `JaxRun` runs JAX's `make_ppo` `init_fn` and `train_iteration`
   (`make_ppo_recurrent`'s for the recurrent cases), jitted as
   the runner jits them, with `jax.random.normal`, `uniform`, `randint`
   and `permutation` (the draws the package makes) wrapped for the length
   of the trace. A
   wrapped call made from the JAX package computes its draw as before and
   hands it to the host through an ordered `io_callback`, with the package
   frames of its call stack. So the draws recorded are those of the
   compiled program itself, in program order. (Recording under
   `jax.disable_jit()` would run every op apart, with rounding of its own,
   and the interpret-mode kernels op by op: slower, and another program.)
   A uniform draw also records its unit draw: `uniform` of the same key
   at minval 0 and maxval 1, the same bits before scaling. The same kind
   of callback records what the iteration computes between its modules:
   each env step's outputs, the rollout's transitions, GAE's outputs, each
   minibatch's losses and learning rate; for the recurrent learner also
   each policy step's carries, the window-start hidden, and each
   minibatch's columns, forward and learner state (`instrument_jax`).
2. `PortReplay` replaces `torch.rand`, `randn`, `randint` and `randperm`
   while the port runs. A call made from the port finds its row in
   `SITES` by its package frames and returns the next draw recorded at the
   row's JAX site: a uniform site gets the unit draw, which the port then
   scales with its own code (so the scaling is under test too, and agrees
   with JAX's within an ulp of `hi - lo`); every other site gets JAX's
   output. A JAX draw that no row matches, a port call that no row
   matches, a shape that differs and a draw left over all fail.
3. `run_lockstep` then runs the port's own `PPO.train_iteration` from
   JAX's initial state, with the same capture wrappers on its env and
   learner instances (`env.step`, `rollout`, `compute_gae`,
   `minibatch_update`, `ppo_loss`; the recurrent model's `step`), and
   `compare` holds every captured
   value to JAX's. Nothing in `wheeledlab_torch/` changes for it: the port
   has no seam. `feed` says what of JAX's the port is handed after the
   start: nothing ("free"), or each env step's starting state and its
   outputs for the learner ("data"), where the env amplifies the two
   packages' rounding until envs part. Where the new
   policy is the old one, a KL residue of JAX's may be handed over
   (`KL_RESIDUE`). `restart` starts each later iteration from JAX's
   state, `learner_feed` each minibatch from JAX's learner state.
4. The recurrent cases record JAX's side in a process of its own
   (`record_in_subprocess`, `_torch_lockstep_recorder.py`, which pickles
   `record_jax`'s `JaxRecord`), with `--xla_allow_excess_precision=false`
   appended to `XLA_FLAGS`: XLA then rounds the LSTM cells' bfloat16
   intermediates where flax declares them, as the port does. XLA reads the
   flag when JAX's backend starts, and a test worker has started it
   already, so the worker's own environment stays as it is.

The site-to-site table. A site is the package frames of the draw's call,
innermost first ("a <- b": `a` is called from `b`), as `package_stack`
writes them: `path:line` in the JAX package, `path:function+offset` in the
port (the line's offset from the function's first line; `fused_step+26`
is `tasks/drift/fused.py:608` today); paths are relative to
`wheeledlab_tpu/` and `wheeledlab_torch/`. `SITES` is parsed from this
table, so the table is what the replay uses; "unit" replays JAX's unit
draw, "output" JAX's value. Each case's test names the rows it must take
and how many draws each.

| site | JAX draw | port draw | replay |
|---|---|---|---|
| action_noise | `rl/ppo.py:234` | `rl/ppo.py:PPO.act_and_step+10 <- rl/ppo.py:PPO.rollout+15` | output |
| epoch_perm | `rl/ppo.py:358` | `rl/ppo.py:PPO.update_epochs+16` | output |
| rnn_action_noise | `rl/recurrent.py:242` | `rl/ppo.py:PPO.act_and_step+10 <- rl/recurrent.py:RecurrentPPO.rollout+16` | output |
| rnn_env_perm | `rl/recurrent.py:328` | `rl/recurrent.py:RecurrentPPO.update_epochs+14` | output |
| drift_step_uniforms | `tasks/drift/fused.py:618` | `tasks/drift/fused.py:make_fused_drift_step.fused_step+26` | unit |
| drift_step_normals | `tasks/drift/fused.py:619` | `tasks/drift/fused.py:make_fused_drift_step.fused_step+28` | output |
| drift_dr_buckets | `tasks/drift/task.py:283` | `tasks/drift/task.py:_uniform+1 <- tasks/drift/task.py:make_drift_task.init_params+6` | unit |
| drift_dr_assign | `tasks/drift/task.py:286` | `tasks/drift/task.py:make_drift_task.init_params+8` | output |
| drift_dr_damping | `tasks/drift/task.py:288` | `tasks/drift/task.py:_uniform+1 <- tasks/drift/task.py:make_drift_task.init_params+11` | unit |
| drift_dr_mass | `tasks/drift/task.py:292` | `tasks/drift/task.py:_uniform+1 <- tasks/drift/task.py:make_drift_task.init_params+13` | unit |
| drift_spawn_idx | `tasks/drift/task.py:302` | `tasks/drift/task.py:make_drift_task.sample_spawn+3` | output |
| drift_spawn_xy | `tasks/drift/task.py:304` | `tasks/drift/task.py:make_drift_task.sample_spawn+6` | unit |
| drift_spawn_yaw | `tasks/drift/task.py:305` | `tasks/drift/task.py:make_drift_task.sample_spawn+8` | unit |
| blind_obs_noise | `tasks/common/observations.py:42` | `tasks/common/observations.py:blind_obs+10` | output |
| push_timer_init | `envs/env.py:491 <- envs/env.py:485` | `envs/env.py:WheeledEnv._sample_interval+4 <- envs/env.py:WheeledEnv._init_push_timers+5` | output |
| command_x | `envs/env.py:209 <- envs/env.py:529` | `envs/env.py:WheeledEnv._uniform+1 <- envs/env.py:WheeledEnv._sample_command+5` | unit |
| command_y | `envs/env.py:209 <- envs/env.py:530` | `envs/env.py:WheeledEnv._uniform+1 <- envs/env.py:WheeledEnv._sample_command+6` | unit |
| command_heading | `envs/env.py:209 <- envs/env.py:531` | `envs/env.py:WheeledEnv._uniform+1 <- envs/env.py:WheeledEnv._sample_command+7` | unit |
| elev_dr_mass | `tasks/elevation/task.py:294` | `tasks/elevation/task.py:make_elevation_task.init_params+6` | unit |
| elev_spawn_xy | `tasks/elevation/task.py:303` | `tasks/elevation/task.py:make_elevation_task.sample_spawn.<lambda>+0 <- tasks/elevation/task.py:make_elevation_task.sample_spawn+5` | unit |
| elev_spawn_yaw | `tasks/elevation/task.py:305` | `tasks/elevation/task.py:make_elevation_task.sample_spawn.<lambda>+0 <- tasks/elevation/task.py:make_elevation_task.sample_spawn+6` | unit |
| elev_spawn_vel | `tasks/elevation/task.py:306` | `tasks/elevation/task.py:make_elevation_task.sample_spawn.<lambda>+0 <- tasks/elevation/task.py:make_elevation_task.sample_spawn+7` | unit |
| visual_dr_buckets | `tasks/visual/task.py:184` | `tasks/visual/task.py:make_visual_task.init_params.<lambda>+0 <- tasks/visual/task.py:make_visual_task.init_params+8` | unit |
| visual_dr_assign | `tasks/visual/task.py:187` | `tasks/visual/task.py:make_visual_task.init_params+9` | output |
| visual_dr_base_mass | `tasks/visual/task.py:190` | `tasks/visual/task.py:make_visual_task.init_params.<lambda>+0 <- tasks/visual/task.py:make_visual_task.init_params+11` | unit |
| visual_dr_wheel_mass | `tasks/visual/task.py:193` | `tasks/visual/task.py:make_visual_task.init_params.<lambda>+0 <- tasks/visual/task.py:make_visual_task.init_params+12` | unit |
| visual_spawn_idx | `tasks/visual/task.py:204` | `tasks/visual/task.py:make_visual_task.sample_spawn+3` | output |
| visual_spawn_yaw | `tasks/visual/task.py:206` | `tasks/visual/task.py:make_visual_task.sample_spawn+5` | unit |
| visual_aug_brightness | `tasks/visual/augment.py:50` | `tasks/visual/augment.py:augmentation_draws.u+1 <- tasks/visual/augment.py:augmentation_draws+9` | unit |
| visual_aug_contrast | `tasks/visual/augment.py:52` | `tasks/visual/augment.py:augmentation_draws.u+1 <- tasks/visual/augment.py:augmentation_draws+10` | unit |
| visual_aug_sigma | `tasks/visual/augment.py:54` | `tasks/visual/augment.py:augmentation_draws.u+1 <- tasks/visual/augment.py:augmentation_draws+11` | unit |
| visual_obs_noise | `tasks/visual/task.py:244 <- tasks/visual/task.py:246` | `tasks/visual/task.py:make_visual_task.observe.<lambda>+0 <- tasks/visual/task.py:make_visual_task.observe+18` | unit |

The recurrent rollout's action noise shares its innermost port frame with
the MLP rollout's; the two rows tell them apart by the caller's frame
(`PPO.rollout` or `RecurrentPPO.rollout`). `rnn_env_perm` is drawn once an
iteration and shared by its epochs, on both sides.

A site may draw more than once a step: `command_*` at the timed resample
and again for the envs that reset, `visual_obs_noise` three times on one
line (`lin, ang, act = u(lin), u(ang), u(act)`). Its draws are taken in
program order, which both sides share; a port that took them in another
order would get another env's or another channel's values and part from
JAX at once.

Sites on one side only, in an iteration of these cases: none. The generic
step's push events (`envs/env.py:505-507`, `:512`; the port's
`WheeledEnv._apply_pushes`) are drawn by no case here: drift's pushes run
in K1 on its uniform rows, and elevation and visual have none. Outside an
iteration: JAX draws the drift track's reset poses (`tasks/drift/task.py:
83`) and the elevation terrain (`tasks/elevation/terrain_gen.py:29-34`)
from `PRNGKey(cfg.seed)` when it builds a task, where the port draws them
from `torch.Generator`s (`tasks/drift/task.py:255`,
`tasks/elevation/terrain_gen.py:31`); the tests hand JAX's over
(`ref_poses=`, `terrain=`). JAX's in-kernel RNG seed (`tasks/drift/
fused.py:586`) and the port's (`tasks/drift/fused.py:591`) are off here,
as JAX ignores `WHEELEDLAB_KERNEL_RNG` off a TPU.
"""

from __future__ import annotations

import dataclasses
import functools
import inspect
import os
import re
import sys
from collections import defaultdict, deque
from typing import Dict, List, Tuple

import jax
import numpy as np
import torch
from jax.experimental import io_callback

import wheeledlab_torch
import wheeledlab_tpu

TPU_ROOT = os.path.dirname(os.path.abspath(wheeledlab_tpu.__file__))
TORCH_ROOT = os.path.dirname(os.path.abspath(wheeledlab_torch.__file__))

# the draws the JAX package makes
JAX_FUNCS = ("normal", "uniform", "randint", "permutation")


@dataclasses.dataclass(frozen=True)
class Site:
    name: str
    jax: Tuple[str, ...]
    port: Tuple[str, ...]
    replay: str          # "unit" | "output"


def _parse_sites(doc: str) -> Tuple[Site, ...]:
    rows = []
    for line in doc.splitlines():
        m = re.match(r"\| (\w+) \| `([^`]+)` \| `([^`]+)` \| "
                     r"(unit|output) \|$", line.strip())
        if m:
            name, j, p, replay = m.groups()
            rows.append(Site(name, tuple(j.split(" <- ")),
                             tuple(p.split(" <- ")), replay))
    return tuple(rows)


SITES = _parse_sites(__doc__)


def package_stack(root: str, frame) -> Tuple[str, ...]:
    """The frames of `frame`'s stack in the package at `root`, innermost
    first: `path:line` in the JAX package, whose lines do not move, and
    `path:function+offset` in the port (the line's offset from the
    function's first line), which an edit elsewhere in the file leaves
    as it was."""
    out = []
    while frame is not None:
        code = frame.f_code
        path = code.co_filename
        if path.startswith(root + os.sep):
            rel = os.path.relpath(path, root)
            if root == TPU_ROOT:
                out.append(f"{rel}:{frame.f_lineno}")
            else:
                name = code.co_qualname.replace(".<locals>", "")
                out.append(f"{rel}:{name}+"
                           f"{frame.f_lineno - code.co_firstlineno}")
        frame = frame.f_back
    return tuple(out)


def site_of(stack: Tuple[str, ...], side: str) -> List[Site]:
    """The rows of `SITES` whose `side` frames begin `stack`."""
    return [s for s in SITES
            if stack[:len(getattr(s, side))] == getattr(s, side)]


@dataclasses.dataclass
class Draw:
    fn: str
    stack: Tuple[str, ...]
    shape: Tuple[int, ...]
    value: np.ndarray
    unit: np.ndarray = None    # uniform draws: the same bits in [0, 1)

    @property
    def where(self) -> str:
        return " <- ".join(self.stack[:3])


class JaxRun:
    """Records the draws and the between-module values of JAX's jitted
    `init_fn` and `train_iteration`, in program order, as a list of
    `(tag, value)` events; `("draw", Draw)` for each draw."""

    def __init__(self):
        self.events: List[tuple] = []

    def _host(self, tag, meta, value):
        value = jax.tree_util.tree_map(np.asarray, value)
        if tag == "draw":
            fn, stack = meta
            out, unit = value if fn == "uniform" else (value, None)
            value = Draw(fn, stack, tuple(out.shape), out, unit)
        self.events.append((tag, value))

    def emit(self, tag, value, meta=None):
        io_callback(functools.partial(self._host, tag, meta), None, value,
                    ordered=True)

    def _wrap(self, name, orig):
        sig = inspect.signature(orig)

        @functools.wraps(orig)
        def wrapper(*args, **kwargs):
            out = orig(*args, **kwargs)
            caller = sys._getframe(1)
            if not caller.f_code.co_filename.startswith(TPU_ROOT + os.sep):
                return out      # a draw inside JAX itself
            value = out
            if name == "uniform":
                bound = sig.bind(*args, **kwargs)
                bound.apply_defaults()
                bound.arguments.update(minval=0.0, maxval=1.0)
                value = (out, orig(*bound.args, **bound.kwargs))
            self.emit("draw", value,
                      meta=(name, package_stack(TPU_ROOT, caller)))
            return out
        return wrapper

    def __enter__(self):
        self._orig = {f: getattr(jax.random, f) for f in JAX_FUNCS}
        for f, orig in self._orig.items():
            setattr(jax.random, f, self._wrap(f, orig))
        return self

    def __exit__(self, *exc):
        for f, orig in self._orig.items():
            setattr(jax.random, f, orig)

    def take(self) -> List[tuple]:
        """The events recorded since the last `take`."""
        jax.effects_barrier()
        out, self.events = self.events, []
        return out


def _cell(fn, name):
    return fn.__closure__[fn.__code__.co_freevars.index(name)]


def instrument_jax(run: JaxRun, jenv, train_iteration,
                   what=("step", "traj", "gae", "minibatch")):
    """Emit, from JAX's compiled iteration, each env step's outputs
    (`"step"`), the rollout's transitions (`"traj"`), GAE's outputs
    (`"gae"`) and each minibatch's [total, surrogate, value, entropy, kl]
    with the learning rate after it (`"minibatch"`). The env's `step` is
    wrapped on the instance; `rollout`, `compute_gae` and `minibatch_update`
    are the closures `make_ppo` built, replaced in the cells that
    `train_iteration` and `update_epochs` read them from. `what` names the
    tags to emit.

    The recurrent learner's (`make_ppo_recurrent`) also emits each policy
    step's carries, the `reset_prev` it took and its outputs (`"carry"`:
    the T rollout steps, then the bootstrap's), the window-start hidden
    (`"h0"`, from `rollout`), and with each minibatch its actions
    (`action`, [T, mb_envs, A], which name its env columns), its forward's
    means and values (`seq_apply` from the parameters before the step,
    outside the gradient: XLA compiles it apart from the gradient's own
    forward, which rounds where it does at float32 level) and the
    learner state after the step (`params`, `mu`, `nu`, `count`); its
    `step_apply` is replaced in the cell that `rollout` and `policy_apply`
    read it from."""
    # make_ppo_recurrent's rollout reads the policy through `step_apply`
    recurrent = "step_apply" in _cell(
        train_iteration, "rollout").cell_contents.__code__.co_freevars
    if "minibatch" in what:
        update_epochs = _cell(train_iteration, "update_epochs").cell_contents
        cell = _cell(update_epochs, "minibatch_update")
        mb = cell.cell_contents

        if recurrent:
            loss_fn = _cell(mb, "grad_fn").cell_contents.__wrapped__
            seq_apply = _cell(loss_fn, "seq_apply").cell_contents

        def mb_w(carry, batch):
            (params, opt_state), metrics = mb(carry, batch)
            out = dict(metrics=metrics,
                       lr=opt_state[1].hyperparams["learning_rate"])
            if recurrent:
                h0, traj = batch[:2]
                _, mean, _, value = seq_apply(carry[0], h0, traj.obs,
                                              traj.reset)
                adam = opt_state[1].inner_state[0]
                out.update(action=traj.action, mean=mean, value=value,
                           params=params, mu=adam.mu, nu=adam.nu,
                           count=adam.count)
            run.emit("minibatch", out)
            return (params, opt_state), metrics

        cell.cell_contents = mb_w
    if "step" not in what:
        return
    if recurrent:
        cell = _cell(_cell(train_iteration, "rollout").cell_contents,
                     "step_apply")
        step_apply = cell.cell_contents

        def step_apply_w(params, hidden, obs, reset_prev):
            res = step_apply(params, hidden, obs, reset_prev)
            run.emit("carry", dict(hidden=res[0], reset_prev=reset_prev,
                                   mean=res[1], std=res[2], value=res[3]))
            return res

        cell.cell_contents = step_apply_w
    step = jenv.step

    def env_step(state, action):
        state, out = step(state, action)
        run.emit("step", dict(obs=out.obs, reward=out.reward, done=out.done,
                              time_out=out.time_out, info=out.info,
                              state=state))
        return state, out

    jenv.step = env_step

    cell = _cell(train_iteration, "rollout")
    rollout = cell.cell_contents

    def rollout_w(state):
        res = rollout(state)
        if recurrent:
            run.emit("traj", res[5]._asdict())
            run.emit("h0", res[4])
        else:
            run.emit("traj", res[2]._asdict())
        return res

    cell.cell_contents = rollout_w

    cell = _cell(train_iteration, "compute_gae")
    gae = cell.cell_contents

    def gae_w(traj, last_value):
        res = gae(traj, last_value)
        run.emit("gae", dict(zip(("advantages", "returns", "norm_adv"), res)))
        return res

    cell.cell_contents = gae_w


# ---------------------------------------------------------------------------
# the port
# ---------------------------------------------------------------------------


class PortReplay:
    """Feeds recorded JAX draws to the port's draw calls (see the module
    docstring). `queues[name]` holds the draws of each site, in order."""

    def __init__(self):
        self.queues: Dict[str, deque] = defaultdict(deque)
        self.taken: Dict[str, int] = defaultdict(int)

    def feed(self, events):
        """Queue the draws among `events` at their sites; a draw that no
        row of `SITES` matches fails."""
        for tag, d in events:
            if tag != "draw":
                continue
            rows = site_of(d.stack, "jax")
            if len(rows) != 1:
                raise AssertionError(
                    f"JAX draw {d.fn}{d.shape} at {d.where} matches "
                    f"{len(rows)} rows of the site table")
            self.queues[rows[0].name].append(d)

    def pending(self) -> Dict[str, int]:
        return {k: len(q) for k, q in self.queues.items() if q}

    def _take(self, fn, shape):
        caller = sys._getframe(2)
        stack = package_stack(TORCH_ROOT, caller)
        rows = site_of(stack, "port")
        if len(rows) != 1:
            raise AssertionError(
                f"port draw torch.{fn}{tuple(shape)} at "
                f"{' <- '.join(stack[:3])} matches {len(rows)} rows of the "
                "site table")
        name = rows[0].name
        queue = self.queues[name]
        if not queue:
            raise AssertionError(f"port draw at {name} "
                                 f"({' <- '.join(stack[:3])}): no JAX draw "
                                 "left")
        d = queue.popleft()
        if tuple(shape) != d.shape:
            raise AssertionError(f"{name}: port draws {tuple(shape)}, JAX "
                                 f"drew {d.shape} at {d.where}")
        self.taken[name] += 1
        return d.unit if rows[0].replay == "unit" else d.value

    @staticmethod
    def _shape(args):
        if len(args) == 1 and isinstance(args[0], (tuple, list, torch.Size)):
            return tuple(args[0])
        return tuple(args)

    def __enter__(self):
        self._orig = {f: getattr(torch, f)
                      for f in ("rand", "randn", "randint", "randperm")}
        orig = self._orig

        def from_port():
            return sys._getframe(2).f_code.co_filename.startswith(
                TORCH_ROOT + os.sep)

        def rand(*size, generator=None, device=None, dtype=None, **kw):
            if not from_port():
                return orig["rand"](*size, generator=generator,
                                    device=device, dtype=dtype, **kw)
            v = self._take("rand", self._shape(size))
            return torch.as_tensor(np.array(v), dtype=dtype or torch.float32,
                                   device=device)

        def randn(*size, generator=None, device=None, dtype=None, **kw):
            if not from_port():
                return orig["randn"](*size, generator=generator,
                                     device=device, dtype=dtype, **kw)
            v = self._take("randn", self._shape(size))
            return torch.as_tensor(np.array(v), dtype=dtype or torch.float32,
                                   device=device)

        def randint(*args, generator=None, device=None, dtype=None, **kw):
            if not from_port():
                return orig["randint"](*args, generator=generator,
                                       device=device, dtype=dtype, **kw)
            low, high, size = (0, *args) if len(args) == 2 else args
            v = self._take("randint", tuple(size))
            assert low <= v.min() and v.max() < high, (low, high)
            return torch.as_tensor(np.array(v), dtype=dtype or torch.int64,
                                   device=device)

        def randperm(n, generator=None, device=None, dtype=None, **kw):
            if not from_port():
                return orig["randperm"](n, generator=generator,
                                        device=device, dtype=dtype, **kw)
            v = self._take("randperm", (n,))
            assert np.array_equal(np.sort(v), np.arange(n))
            return torch.as_tensor(np.array(v), dtype=dtype or torch.int64,
                                   device=device)

        for name, fn in (("rand", rand), ("randn", randn),
                         ("randint", randint), ("randperm", randperm)):
            setattr(torch, name, fn)
        return self

    def __exit__(self, *exc):
        for name, fn in self._orig.items():
            setattr(torch, name, fn)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy().copy()
    return np.array(x)


def port_learner(learner) -> dict:
    """The learner's parameters (state-dict names), Adam moments and step
    count, and learning rate, as numpy."""
    named = dict(learner.model.named_parameters())
    opt = learner.optimizer.state
    moments = lambda key: {n: _np(opt[p][key]) for n, p in named.items()}
    return dict(params={k: _np(v) for k, v in named.items()},
                mu=moments("exp_avg"), nu=moments("exp_avg_sq"),
                count=int(next(iter(opt.values()))["step"]),
                lr=float(learner.lr))


def load_jax_learner(learner, state: dict):
    """Put a JAX learner state into the port's learner: `state` holds the
    flax-shaped `params`, `mu` and `nu`, and `count` and `lr` (a snapshot,
    or what a minibatch event holds after its step)."""
    named = dict(learner.model.named_parameters())
    model = lambda tree: {k: torch.from_numpy(v) for k, v in jax_as_port(
        tree, learner.cfg.activation).items()}
    params, mu, nu = (model(state[k]) for k in ("params", "mu", "nu"))
    with torch.no_grad():
        for k, p in named.items():
            p.copy_(params[k])
            learner.optimizer.state[p] = dict(
                step=torch.tensor(float(state["count"])),
                exp_avg=mu[k].clone(), exp_avg_sq=nu[k].clone())
        learner.lr.copy_(torch.tensor(state["lr"]))


# Where the new policy is the old one (the first minibatch of an
# iteration), the KL estimate is 0 up to rounding. JAX's is a residue of
# +-6e-8 there (its rollout and its update compile the policy's forward
# apart; visual lockstep, iteration 2, minibatch 0: 5.96e-8), the port's is
# 0 (the same forward both times). The adaptive LR's `0 < kl` then decides
# on the residue's sign: JAX's LR rose 1.5x where the port's stayed. Where
# both estimates are residues under KL_RESIDUE and fall on either side of
# 0, the lockstep hands the port JAX's and records the minibatch.
KL_RESIDUE = 1e-6


def instrument_port(learner, phases: List[list], feed: deque = None,
                    what=("step", "traj", "gae", "minibatch"),
                    kl_feed: deque = None, residues: list = None,
                    learner_feed: deque = None):
    """The port's counterpart of `instrument_jax`, on the learner and env
    instances: the same tags, values as numpy, appended to `phases[-1]`.
    With `feed`, each env step takes the next `(state, out)` of `feed`:
    it starts from the JAX env state `state` (a numpy tree, converted with
    `convert.env_state_from_jax`) in place of the state the port carried,
    and hands JAX's outputs of that step, `out`, to the learner in place
    of its own. The port's own outputs are recorded either way. `what` names the tags to record. With `kl_feed`
    (JAX's KL estimate of each minibatch, in order), a minibatch whose two
    estimates are residues on either side of 0 (`KL_RESIDUE`) takes JAX's;
    it is appended to `residues` as (phase, minibatch, JAX's, the port's).
    With `learner_feed`, each minibatch starts from the next learner state
    of it (`load_jax_learner`). The recurrent learner's minibatches also
    record their actions and the learner state after the step
    (`port_learner`), and its policy steps their carries (`"carry"`) and
    its rollout the window-start hidden (`"h0"`), as `instrument_jax`'s.
    """
    from wheeledlab_torch.convert import env_state_from_jax
    from wheeledlab_torch.envs.env import StepOutput
    from wheeledlab_torch.rl.recurrent import RecurrentPPO

    if kl_feed is not None:
        ppo_loss = learner.ppo_loss

        def ppo_loss_w(*args):
            total, (surr, vloss, ent, kl) = ppo_loss(*args)
            kl_j, kl_p = float(kl_feed.popleft()), float(kl.detach())
            if (max(abs(kl_j), abs(kl_p)) <= KL_RESIDUE
                    and (kl_j > 0) != (kl_p > 0)):
                n = sum(tag == "minibatch" for tag, _ in phases[-1])
                residues.append((len(phases) - 1, n, kl_j, kl_p))
                kl = torch.tensor(kl_j, dtype=kl.dtype, device=kl.device)
            return total, (surr, vloss, ent, kl)

        learner.ppo_loss = ppo_loss_w

    recurrent = isinstance(learner, RecurrentPPO)
    forward = {}
    if recurrent and "minibatch" in what:
        # the minibatch's forward, as `RecurrentPPO.loss` hands it over
        ppo_loss_f = learner.ppo_loss

        def ppo_loss_rec(mean, std, value, *rest):
            forward.update(mean=_np(mean), value=_np(value))
            return ppo_loss_f(mean, std, value, *rest)

        learner.ppo_loss = ppo_loss_rec
    if "minibatch" in what:
        mb = learner.minibatch_update

        def mb_w(batch):
            if learner_feed is not None:
                load_jax_learner(learner, learner_feed.popleft())
            metrics = mb(batch)
            out = dict(metrics=_np(metrics), lr=_np(learner.lr))
            if recurrent:
                out.update(action=_np(batch[3]), **forward,
                           **port_learner(learner))
            phases[-1].append(("minibatch", out))
            return metrics

        learner.minibatch_update = mb_w
    if "step" in what and recurrent:
        # the policy's steps (the rollout's, then the bootstrap's), on the
        # model instance: `rollout` keeps its carries to itself
        model_step = learner.model.step

        def model_step_w(hidden, obs, reset_prev):
            res = model_step(hidden, obs, reset_prev)
            phases[-1].append(("carry", dict(
                hidden=flat_hidden(res[0]), reset_prev=_np(reset_prev),
                mean=_np(res[1]), std=_np(res[2]), value=_np(res[3]))))
            return res

        learner.model.step = model_step_w
    if "step" in what:
        env = learner.env
        step = env.step

        def env_step(state, action):
            jout = None
            if feed is not None:
                jstate, jout = feed.popleft()
                state = env_state_from_jax(jstate)
            state, out = step(state, action)
            phases[-1].append(("step", dict(
                obs=_np(out.obs), reward=_np(out.reward), done=_np(out.done),
                time_out=_np(out.time_out),
                info={k: _np(v) for k, v in out.info.items()},
                state=port_env_state(state))))
            if jout is not None:
                t = lambda x: torch.from_numpy(np.array(x))
                out = StepOutput(
                    obs=t(jout["obs"]), reward=t(jout["reward"]),
                    done=t(jout["done"]), time_out=t(jout["time_out"]),
                    info={k: t(v) for k, v in jout["info"].items()})
            return state, out

        env.step = env_step
        rollout = learner.rollout

        def rollout_w(state, capture_traj=False):
            res = rollout(state, capture_traj)
            traj = res[5] if recurrent else res[2]
            phases[-1].append(("traj", {k: _np(v) for k, v in traj.items()
                                        if not k.startswith("traj/")}))
            if recurrent:
                phases[-1].append(("h0", flat_hidden(res[4])))
            return res

        learner.rollout = rollout_w
        gae = learner.compute_gae

        def gae_w(*args):
            res = gae(*args)
            phases[-1].append(("gae", dict(zip(
                ("advantages", "returns", "norm_adv"), map(_np, res)))))
            return res

        learner.compute_gae = gae_w


def flat_hidden(hidden) -> Dict[str, np.ndarray]:
    """A hidden tree of either package ({chain: [(c, h) a layer]}) as
    numpy arrays under the names "actor0/c", "actor0/h", ..."""
    return {f"{chain}{i}/{n}": _np(x) for chain in ("actor", "critic")
            for i, pair in enumerate(hidden[chain])
            for n, x in zip("ch", pair)}


def split_events(events):
    """{tag: [values in order]} of the events that are not draws."""
    out = defaultdict(list)
    for tag, v in events:
        if tag != "draw":
            out[tag].append(v)
    return out


# ---------------------------------------------------------------------------
# the cases and a lockstep run
# ---------------------------------------------------------------------------

ELEV_OVERRIDES = dict(terrain_extent=20.0, num_mounds=10, spawn_range=8.0,
                      goal_range=8.0)
VISUAL_MAP = dict(map_rows=100, map_cols=100, env_rows=20, env_cols=20,
                  group_rows=5, group_cols=5)
# 0.1 s episodes (5 steps) and wide spawns: time-outs, the bootstrap
# `reward + gamma * V * time_out`, terminations, resets and the curriculum
# fire within the two iterations
RESETS = dict(episode_length_s=0.1, pos_noise=1.0)
# task, envs, run config whose agent it takes, task overrides
CASES = {
    "drift": ("MushrDriftRL-v0", 128, "RSS_DRIFT_CONFIG", {}),
    "drift_resets": ("MushrDriftRL-v0", 128, "RSS_DRIFT_CONFIG", RESETS),
    "f1tenth": ("F1TenthDriftRL-v0", 128, "F1TENTH_DRIFT_CONFIG", {}),
    "drift_rnn": ("MushrDriftRL-v0", 128, "RSS_DRIFT_RNN_CONFIG", {}),
    "drift_rnn_resets": ("MushrDriftRL-v0", 128, "RSS_DRIFT_RNN_CONFIG",
                         RESETS),
    "elevation": ("MushrElevationRL-v0", 128, "RSS_ELEV_CONFIG",
                  ELEV_OVERRIDES),
    "visual": ("MushrVisualRL-v0", 64, "RSS_VISUAL_CONFIG", VISUAL_MAP),
}
SMALL_PPO = dict(num_steps_per_env=8, num_learning_epochs=2,
                 num_mini_batches=2)
# the recurrent cases: RSS_DRIFT_RNN_CONFIG's one layer, cut to 32 wide
RNN_PPO = dict(SMALL_PPO, rnn_hidden_size=32)


def to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def agent_cfgs(config, ppo: dict):
    """(port PPOCfg, JAX PPOCfg): the named run config's agent (`PPOCfg`'s
    defaults for None, as the learning tests take) with `ppo`'s fields
    replaced, field for field the same."""
    from wheeledlab_torch.rl.ppo import PPOCfg
    from wheeledlab_torch.rl.run_cfgs import RUN_CONFIGS
    from wheeledlab_tpu.rl.ppo import PPOCfg as JPPOCfg

    agent = (PPOCfg() if config is None
             else RUN_CONFIGS.get(config).agent).replace(**ppo)
    fields = [f.name for f in dataclasses.fields(JPPOCfg)]
    return agent, JPPOCfg(**{f: getattr(agent, f) for f in fields})


def jax_env(task: str, num_envs: int, overrides: dict, route: str):
    """The JAX env on its kernel route in interpret mode (`route="kernel"`:
    K1 for drift, K2 for visual, K3 for elevation, as the JAX package's
    own tests run them on the CPU), or on JAX's CPU default, the
    per-vehicle physics (`route="auto"`)."""
    from wheeledlab_tpu.tasks import make_env as j_make_env

    env = j_make_env(task, num_envs=num_envs, overrides=overrides or None)
    if route == "kernel":
        if env.task.terrain.is_flat:
            env._use_pallas = True
        else:
            env._use_pallas_hf = True
        env._pallas_interpret = True
    return env


def build_draws(task: str, jenv) -> dict:
    """JAX's build-time draws that the port's env is handed, as numpy:
    the drift track's reset poses (`ref_poses`), the elevation terrain
    (`terrain`)."""
    from wheeledlab_tpu.tasks.drift.task import reference_track_poses

    if task.endswith("DriftRL-v0"):
        jcfg = jenv.task_cfg
        return dict(ref_poses=np.array(reference_track_poses(
            jax.random.fold_in(jax.random.PRNGKey(jcfg.seed), 17), jcfg)))
    if task.startswith("MushrElevation"):
        return dict(terrain=to_np(jenv.task.terrain))
    return {}


def port_env(task: str, num_envs: int, overrides: dict, build: dict):
    """The port's env on the CPU with JAX's build-time draws handed over
    (`build_draws`)."""
    from wheeledlab_torch.convert import heightfield_from_jax
    from wheeledlab_torch.tasks import resolve_task
    from wheeledlab_torch.utils.config import apply_overrides

    entry = resolve_task(task)
    cfg = apply_overrides(entry["cfg"].replace(num_envs=num_envs),
                          dict(overrides))
    extra = {}
    if "ref_poses" in build:
        extra["ref_poses"] = torch.from_numpy(build["ref_poses"])
    if "terrain" in build:
        extra["terrain"] = heightfield_from_jax(build["terrain"])
    return entry["make"](cfg, device="cpu", **extra)


ENV_FIELDS = ("vehicle_mem", "packed_params", "step_count", "common_step",
              "reward_weights", "last_action", "command", "command_timer",
              "push_timers", "ep_return", "ep_len")


def port_env_state(state) -> dict:
    """The port's EnvState as numpy arrays under the JAX EnvState's field
    names, the vehicle in the packed (21, B) rows whatever the route (the
    per-vehicle route carries no packed params)."""
    from wheeledlab_torch.sim.soa import pack_state
    from wheeledlab_torch.sim.types import VehicleState

    out = {f: getattr(state, f) for f in ENV_FIELDS}
    if isinstance(out["vehicle_mem"], VehicleState):
        out["vehicle_mem"] = pack_state(out["vehicle_mem"])
    return {k: _np(v) for k, v in out.items() if v is not None}


def jax_env_state(state) -> dict:
    """`port_env_state` of a JAX EnvState (numpy leaves)."""
    from wheeledlab_tpu.sim.soa import pack_state
    from wheeledlab_tpu.sim.types import VehicleState

    out = {f: getattr(state, f) for f in ENV_FIELDS}
    if isinstance(out["vehicle_mem"], VehicleState):
        out["vehicle_mem"] = pack_state(out["vehicle_mem"])
    return {k: np.asarray(v) for k, v in out.items() if v is not None}


def jax_snapshot(state, metrics) -> dict:
    """The learner's state after a phase; the recurrent learner's also
    holds its carries (`hidden`) and `reset_prev`."""
    adam = state.opt_state[1].inner_state[0]
    snap = dict(params=to_np(state.params), mu=to_np(adam.mu),
                nu=to_np(adam.nu), count=int(adam.count),
                lr=float(state.opt_state[1].hyperparams["learning_rate"]),
                metrics={k: np.asarray(v) for k, v in metrics.items()
                         if not k.startswith("traj/")},
                env_state=to_np(state.env_state), obs=np.asarray(state.obs))
    if hasattr(state, "hidden"):
        snap.update(hidden=to_np(state.hidden),
                    reset_prev=np.asarray(state.reset_prev))
    return snap


def port_snapshot(learner, state, metrics) -> dict:
    """`jax_snapshot` of the port's learner and train state."""
    snap = dict(port_learner(learner),
                metrics={k: _np(v) for k, v in metrics.items()
                         if not k.startswith("traj/")},
                env_state=port_env_state(state.env_state), obs=_np(state.obs))
    if hasattr(state, "hidden"):
        snap.update(hidden=flat_hidden(state.hidden),
                    reset_prev=_np(state.reset_prev))
    return snap


def port_model_from_jax(tree, activation: str):
    """The port's model (`ActorCritic` or `ActorCriticRecurrent`) holding a
    flax-shaped tree: parameters, or an Adam moment of them."""
    from wheeledlab_torch.convert import (
        actor_critic_from_jax, actor_critic_recurrent_from_jax)

    tree = to_np(tree)
    convert = (actor_critic_recurrent_from_jax if "memory" in tree["params"]
               else actor_critic_from_jax)
    return convert(tree, activation=activation)


def jax_as_port(tree, activation: str) -> dict:
    """A flax-shaped tree (parameters or an Adam moment) as numpy arrays
    under the port's state-dict names."""
    return {k: v.numpy() for k, v in port_model_from_jax(
        tree, activation).state_dict().items()}


@dataclasses.dataclass
class JaxRecord:
    """JAX's side of a lockstep run: per phase (the init, then each
    iteration) the events and the snapshot after it, the build-time draws
    handed to the port (`build_draws`), and the `XLA_FLAGS` it ran
    under."""

    events: List[list]
    snaps: List[dict]
    build: dict
    xla_flags: str = ""         # the recording process's `XLA_FLAGS`


def record_jax(case: str, iterations: int = 2, ppo: dict = SMALL_PPO,
               capture=("step", "traj", "gae", "minibatch"),
               jax_route: str = "kernel", agent: str = "case") -> JaxRecord:
    """Run JAX's `init_fn` at `PRNGKey(0)` and `iterations` of its
    `train_iteration` (`make_learner`: `make_ppo`, or `make_ppo_recurrent`
    for a recurrent agent), jitted, recording their draws and the values
    between the modules that `capture` names (`instrument_jax`)."""
    from wheeledlab_tpu.rl.ppo import make_learner

    task, num_envs, config, overrides = CASES[case]
    _, jcfg = agent_cfgs(config if agent == "case" else agent, ppo)
    jenv = jax_env(task, num_envs, overrides, jax_route)
    run = JaxRun()
    events, snaps = [], []
    with run:
        init_fn, train_iteration, _ = make_learner(jenv, jcfg)
        instrument_jax(run, jenv, train_iteration, capture)
        state = jax.jit(init_fn)(jax.random.PRNGKey(0))
        events.append(run.take())
        snaps.append(jax_snapshot(state, {}))
        step = jax.jit(train_iteration)
        for it in range(iterations):
            state, metrics = step(state)
            events.append(run.take())
            snaps.append(jax_snapshot(state, metrics))
    return JaxRecord(events, snaps, build_draws(task, jenv),
                     os.environ.get("XLA_FLAGS", ""))


# `XLA_FLAGS` of a recording made in a process of its own: XLA then rounds
# every bfloat16 intermediate where the program declares it (its default,
# excess precision, keeps some in float32), as the port's recurrent cells
# do. The flag is read when JAX's backend starts, so it cannot be set in a
# process that has started JAX already.
EXACT_PRECISION_FLAG = "--xla_allow_excess_precision=false"


def exact_precision_env() -> dict:
    """The environment of a child process that runs JAX on the CPU with
    `EXACT_PRECISION_FLAG` appended to `XLA_FLAGS` (the others kept) and
    the repo on its path; this process's own is left as it is."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["XLA_FLAGS"] = " ".join(
        f for f in (env.get("XLA_FLAGS", ""), EXACT_PRECISION_FLAG) if f)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (os.path.dirname(TORCH_ROOT), env.get("PYTHONPATH"))
        if p)
    return env


def record_in_subprocess(case: str, path: str, **kwargs):
    """Start `record_jax(case, **kwargs)` in a process of its own, on the
    CPU with `EXACT_PRECISION_FLAG` appended to `XLA_FLAGS`; it pickles its
    `JaxRecord` to `path` (`_torch_lockstep_recorder.py`). Returns the
    `subprocess.Popen`; `load_record` waits for it. This process's own
    environment is left as it is."""
    import json
    import subprocess

    script = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "_torch_lockstep_recorder.py")
    return subprocess.Popen(
        [sys.executable, script, case, path, json.dumps(kwargs)],
        env=exact_precision_env(), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)


def load_record(proc, path: str, timeout: float = 600) -> JaxRecord:
    """Wait for `record_in_subprocess`'s process and load its record."""
    import pickle

    out, _ = proc.communicate(timeout=timeout)
    if proc.returncode != 0:
        raise AssertionError(f"the JAX recording failed ({proc.returncode})"
                             f":\n{out[-4000:]}")
    with open(path, "rb") as f:
        return pickle.load(f)


@dataclasses.dataclass
class Lockstep:
    """What a lockstep run kept: per phase (the init, then each iteration)
    the JAX and port events and snapshots."""

    case: str
    activation: str
    jax_events: List[list]
    port_events: List[list]
    jax_snaps: List[dict]
    port_snaps: List[dict]
    reset: Tuple = None         # (port env state, port obs) of the replayed
    # reset
    residues: list = None       # KL residues handed over (instrument_port)
    taken: dict = None          # draws replayed, by site
    jax_route: str = "kernel"


def port_train_state(snap: dict, iteration: int = 0):
    """The port's train state from a JAX snapshot: env state and obs, and
    the recurrent learner's carries and `reset_prev`."""
    from wheeledlab_torch.convert import (
        env_state_from_jax, recurrent_hidden_from_jax)
    from wheeledlab_torch.rl.ppo import TrainState
    from wheeledlab_torch.rl.recurrent import RecurrentTrainState

    state = dict(env_state=env_state_from_jax(snap["env_state"]),
                 obs=torch.from_numpy(snap["obs"].copy()),
                 iteration=iteration)
    if "hidden" not in snap:
        return TrainState(**state)
    return RecurrentTrainState(
        **state, hidden=recurrent_hidden_from_jax(snap["hidden"]),
        reset_prev=torch.from_numpy(snap["reset_prev"].copy()))


def run_lockstep(case: str, iterations: int = 2, ppo: dict = SMALL_PPO,
                 capture=("step", "traj", "gae", "minibatch"),
                 jax_route: str = "kernel", feed: str = "free",
                 agent: str = "case", hand_kl: bool = True,
                 record: JaxRecord = None, restart: bool = False,
                 learner_feed: bool = False) -> Lockstep:
    """Run JAX's side (`record_jax`, unless `record` is given: one made
    with the same arguments, as `record_in_subprocess` makes it); then the
    port from JAX's initial state (parameters, env state, obs; the
    recurrent learner's carries and `reset_prev`; Adam fresh on both
    sides), its env's `reset` and each `train_iteration` fed the draws of
    JAX's.

    `feed`: "free", the port carries its own env state and outputs;
    "data", each port env step starts from JAX's env state before that
    step and the learner gets JAX's step outputs in place of the port
    env's (`instrument_port`). The port's own outputs and post-step
    states are recorded either way. `agent`: "case", the case's run config's
    agent; None, `PPOCfg`'s defaults. `hand_kl`: hand the port JAX's KL
    residues (`KL_RESIDUE`; needs "minibatch" in `capture`). `restart`:
    each iteration after the first starts from JAX's state after the one
    before (parameters, Adam, LR, env state, obs, carries) in place of the
    port's. `learner_feed` (the recurrent learner): each minibatch starts
    from JAX's parameters, Adam state and LR before it."""
    from wheeledlab_torch.rl.ppo import make_learner

    if record is None:
        record = record_jax(case, iterations, ppo, capture, jax_route, agent)
    jax_events, jax_snaps = record.events, record.snaps
    task, num_envs, config, overrides = CASES[case]
    agent, _ = agent_cfgs(config if agent == "case" else agent, ppo)
    tenv = port_env(task, num_envs, overrides, record.build)
    learner = make_learner(tenv, agent)
    learner.model.load_state_dict(port_model_from_jax(
        jax_snaps[0]["params"], agent.activation).state_dict())
    port_events = [[]]
    feeds = None if feed == "free" else deque()
    kl_feed = deque() if hand_kl else None
    states = deque() if learner_feed else None
    residues = []
    instrument_port(learner, port_events, feeds, capture, kl_feed, residues,
                    states)
    replay = PortReplay()
    replay.feed(jax_events[0])
    with replay:
        reset = tenv.reset()
    assert not replay.pending(), replay.pending()
    tstate = port_train_state(jax_snaps[0])
    port_snaps = [None]
    for it in range(iterations):
        port_events.append([])
        if restart and it > 0:
            load_jax_learner(learner, jax_snaps[it])
            tstate = port_train_state(jax_snaps[it], it)
        if states is not None:
            steps = [v for tag, v in jax_events[it + 1] if tag == "minibatch"]
            states.extend([jax_snaps[it]] + steps[:-1])
        replay.feed(jax_events[it + 1])
        if kl_feed is not None:
            kl_feed.extend(v["metrics"][4] for tag, v in jax_events[it + 1]
                           if tag == "minibatch")
        if feeds is not None:
            steps = [v for tag, v in jax_events[it + 1] if tag == "step"]
            pre = [jax_snaps[it]["env_state"]] + [v["state"]
                                                  for v in steps[:-1]]
            feeds.extend(zip(pre, steps))
        with replay:
            tstate, metrics = learner.train_iteration(tstate)
        assert not replay.pending(), (it, replay.pending())
        port_snaps.append(port_snapshot(learner, tstate, metrics))
    return Lockstep(case, agent.activation, jax_events, port_events,
                    jax_snaps, port_snaps, reset, residues,
                    dict(replay.taken), jax_route)


# ---------------------------------------------------------------------------
# comparison
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Tols:
    """The lockstep's tolerances: (rtol, atol) pairs, `|got - want| <= atol
    + rtol |want|` elementwise; `params`, `mu`, `nu` as fractions of each
    tensor's largest entry; `parting`, the share of env steps that may
    part (see `compare`)."""

    env: Tuple[float, float] = (1e-5, 1e-5)
    obs: Tuple[float, float] = (1e-5, 1e-5)
    state: Tuple[float, float] = (1e-5, 1e-5)
    policy: Tuple[float, float] = (1e-5, 1e-5)
    loss: Tuple[float, float] = (1e-5, 1e-5)
    lr_rtol: float = 1e-6
    params: float = 1e-5
    mu: float = 1e-5
    nu: float = 1e-4
    parting: float = 0.0


@dataclasses.dataclass
class RecurrentTols:
    """The recurrent learner's bounds beyond `Tols` (see `compare`). After
    each Adam step: parameters, at most `far` of the entries more than
    ADAM_NEAR apart (None: counted and printed, not held) and none more
    than 2 lr per Adam step + ADAM_NEAR; the first moment, at most `far`
    of the entries more than ADAM_NEAR apart and none more than `mu_max`;
    the second, none more than NU_MAX. `per_step`: each step started from
    JAX's learner state (`run_lockstep(learner_feed=True)`), so its bound
    counts its own LR; otherwise the LRs of the iteration's steps so far
    add up."""

    far: float = 0.005
    mu_max: float = 1e-4
    per_step: bool = True


# tests/test_torch_recurrent.py::params_close's "apart"; a bound on Adam's
# second moment, whose entries are gradients squared (1e-8 here)
ADAM_NEAR, NU_MAX = 1e-5, 1e-6


# env-step values compared exactly: flags, counters, integral floats
EXACT = ("done", "time_out", "episode_length", "step_count", "common_step",
         "command_timer", "push_timers", "ep_len", "reward_weights")


@dataclasses.dataclass
class Report:
    """Per quantity, the largest |difference| and its largest ratio to the
    tolerance; the failures, and the env steps that parted as
    (phase, step, env, [quantities])."""

    rows: Dict[str, list] = dataclasses.field(
        default_factory=lambda: defaultdict(lambda: [0.0, 0.0]))
    failures: List[str] = dataclasses.field(default_factory=list)
    partings: List[tuple] = dataclasses.field(default_factory=list)
    notes: List[str] = dataclasses.field(default_factory=list)

    def add(self, name, got, want, tol=None, env_axis=None):
        """Compare; return the envs (along `env_axis`) out of tolerance, or
        record a failure when `env_axis` is None. `tol` None: exact."""
        got = np.asarray(got)
        want = np.asarray(want)
        if got.shape != want.shape:
            self.failures.append(f"{name}: shape {got.shape} != "
                                 f"{want.shape}")
            return np.zeros(0, int)
        g, w = got.astype(np.float64), want.astype(np.float64)
        diff = np.abs(g - w)
        bound = (np.zeros_like(w) if tol is None
                 else tol[1] + tol[0] * np.abs(w))
        bad = ~(diff <= bound)
        row = self.rows[name]
        if diff.size:
            row[0] = max(row[0], float(diff.max()))
            ratio = diff / np.where(bound > 0, bound, 1.0)
            ratio = np.where(bound > 0, ratio, np.where(diff > 0, np.inf, 0))
            row[1] = max(row[1], float(ratio.max()))
        if not bad.any():
            return np.zeros(0, int)
        if env_axis is None:
            i = np.unravel_index(np.argmax(bad), bad.shape)
            self.failures.append(f"{name}: {int(bad.sum())} out of "
                                 f"tolerance, first at {i}: got {g[i]}, "
                                 f"want {w[i]}")
            return np.zeros(0, int)
        other = tuple(a for a in range(bad.ndim) if a != env_axis)
        return np.flatnonzero(bad.any(axis=other) if other else bad)

    def text(self) -> str:
        lines = [f"  {k}: max |diff| {v[0]:.3g}, {v[1]:.3g} of the "
                 "tolerance" for k, v in sorted(self.rows.items())]
        lines += [f"  {n}" for n in self.notes]
        lines += [f"  parted: phase {p}, step {t}, env {e}: {q}"
                  for p, t, e, q in self.partings]
        return "\n".join(lines)


def _scale_rel(got: dict, want: dict) -> Dict[str, float]:
    return {k: float(np.abs(got[k] - want[k]).max())
            / max(float(np.abs(want[k]).max()), 1e-30) for k in want}


def compare(ls: Lockstep, phase: int, tols: Tols, learner: bool = True,
            until: int = None, rnn: RecurrentTols = None) -> Report:
    """Hold phase `phase` (an iteration, 1-based) of a lockstep run to JAX's.

    Each env step: the outputs (obs, reward, done, time_out, every info)
    and the post-step env state. An env step whose values leave `tols`
    parts: it is recorded by phase, step and env with the quantities that
    left, and `tols.parting` bounds their share. Then, elementwise, the
    rollout's transitions (obs, action, log-prob, value, the bootstrapped
    reward, done, mean, std), GAE's advantages, returns and normalized
    advantages, each minibatch's [total, surrogate, value, entropy, KL]
    and learning rate, and last every parameter, Adam's moments and step
    count, the learning rate and every metric of the iteration. `until`:
    the env steps after it are left out; `learner=False` stops after the
    env steps.

    The recurrent learner's run (`rnn`, its further bounds) also holds
    each policy step's carries and outputs (`tols.policy`; an env whose
    carries leave it parts at that step, as above) and the `reset_prev`
    it took (exactly), and the window-start hidden; its transitions and
    GAE on the envs that did not part. Each minibatch: its env columns
    exactly (named by its actions, on each side against its own rollout),
    its forward where its parameters started equal (each minibatch with
    `rnn.per_step`, else the first): means and values over the window
    within `tols.policy`, a (step, env) that leaves it parting, named by
    minibatch and step; its loss terms within `tols.loss` (the default
    `Tols.loss` where its forward parted or it holds an env that parted in
    the rollout), and the parameters and Adam moments after its step by
    `RecurrentTols`' rule."""
    report = Report()
    J = split_events(ls.jax_events[phase])
    P = split_events(ls.port_events[phase])
    tags = ("step", "traj", "gae", "minibatch") + (
        ("carry", "h0") if rnn else ())
    for tag in tags:
        if len(J[tag]) != len(P[tag]):
            report.failures.append(f"{tag}: {len(P[tag])} in the port, "
                                   f"{len(J[tag])} in JAX")
    pairs = list(zip(J["step"], P["step"]))
    for t, (js, ps) in enumerate(pairs[:None if until is None
                                       else until + 1]):
        parted = defaultdict(list)
        jst = jax_env_state(js["state"])
        values = [("obs", ps["obs"], js["obs"], tols.obs, 0),
                  ("reward", ps["reward"], js["reward"], tols.env, 0),
                  ("done", ps["done"], js["done"], None, 0),
                  ("time_out", ps["time_out"], js["time_out"], None, 0)]
        if set(ps["info"]) != set(js["info"]):
            report.failures.append(f"info keys {sorted(ps['info'])} != "
                                   f"{sorted(js['info'])}")
        for k in sorted(set(ps["info"]) & set(js["info"])):
            exact = k.startswith("done/") or k in EXACT
            values.append((f"info/{k}", ps["info"][k], js["info"][k],
                           None if exact else tols.env, 0))
        for k in sorted(jst):
            if k not in ps["state"]:
                report.failures.append(f"state/{k}: not in the port")
                continue
            axis = {"vehicle_mem": 1, "packed_params": 1, "push_timers": 1,
                    "common_step": None, "reward_weights": None}.get(k, 0)
            tol = None if k in EXACT else (
                tols.state if k == "vehicle_mem" else tols.env)
            values.append((f"state/{k}", ps["state"][k], jst[k], tol, axis))
        for name, got, want, tol, axis in values:
            # flags and counters never part: they fail
            for e in report.add(f"step/{name}", got, want, tol,
                                None if tol is None else axis):
                parted[int(e)].append(name)
        report.partings.extend((phase, t, e, q)
                               for e, q in sorted(parted.items()))
    if rnn:
        _compare_carries(report, phase, J, P, tols)
    if J["step"]:
        env_steps = len(J["step"]) * J["step"][0]["reward"].shape[0]
        share = len({(t, e) for p, t, e, _ in report.partings
                     if p == phase and isinstance(t, int)}) / env_steps
        if share > tols.parting:
            report.failures.append(
                f"{share:.4f} of the env steps parted (allowed "
                f"{tols.parting})")
    if not learner:
        return report
    # the recurrent run's transitions and GAE on the envs that did not
    # part (an env's carries, once parted, stay so to the window's end)
    parted = sorted({e for p, t, e, _ in report.partings
                     if p == phase and isinstance(t, int)})
    keep = lambda x: np.delete(x, parted, axis=1) if rnn else x
    for jt, pt in zip(J["traj"], P["traj"]):
        for k in sorted(jt):
            report.add(f"traj/{k}", keep(pt[k]), keep(jt[k]),
                       None if k in ("done", "reset") else tols.policy)
    for jg, pg in zip(J["gae"], P["gae"]):
        for k in sorted(jg):
            report.add(f"gae/{k}", keep(pg[k]), keep(jg[k]), tols.policy)
    loss_tol = tols.loss
    lrs = []
    for i, (jm, pm) in enumerate(zip(J["minibatch"], P["minibatch"])):
        tol = tols.loss
        if rnn:
            lrs.append(float(jm["lr"]))
            # the forward is held where the parameters start equal
            cols = _compare_minibatch(report, phase, i, jm, pm, J, P, tols,
                                      hold=rnn.per_step or i == 0)
            if cols is None or set(cols) & set(parted):
                tol = loss_tol = Tols.loss
            _compare_adam(report, f"minibatch {i}", pm, jm, ls.activation,
                          rnn, lrs)
        report.add("minibatch/losses", pm["metrics"], jm["metrics"], tol)
        report.add("minibatch/lr", pm["lr"], jm["lr"], (tols.lr_rtol, 0.0))
    js, ps = ls.jax_snaps[phase], ls.port_snaps[phase]
    # the recurrent learner's end state is its last minibatch's, held
    # above
    for part, tol in () if rnn else (("params", tols.params),
                                     ("mu", tols.mu), ("nu", tols.nu)):
        rel = _scale_rel(ps[part], jax_as_port(js[part], ls.activation))
        worst = max(rel, key=rel.get)
        report.rows[f"{part} (of the tensor's scale)"] = [rel[worst],
                                                          rel[worst] / tol]
        if rel[worst] > tol:
            report.failures.append(f"{part}/{worst}: {rel[worst]:.3g} of "
                                   f"its scale (allowed {tol})")
    report.add("adam/count", ps["count"], js["count"])
    report.add("lr", ps["lr"], js["lr"], (tols.lr_rtol, 0.0))
    if set(ps["metrics"]) != set(js["metrics"]):
        report.failures.append(f"metric keys {sorted(ps['metrics'])} != "
                               f"{sorted(js['metrics'])}")
    for k in sorted(set(ps["metrics"]) & set(js["metrics"])):
        tol = None if k == "episode/num_dones" else (
            (tols.lr_rtol, 0.0) if k == "lr" else loss_tol)
        report.add(f"metric/{k}", ps["metrics"][k], js["metrics"][k], tol)
    return report


def _compare_carries(report: Report, phase: int, J, P, tols: Tols):
    """The recurrent rollout's policy steps (`compare`)."""
    for t, (jc, pc) in enumerate(zip(J["carry"], P["carry"])):
        parted = defaultdict(list)
        jh = flat_hidden(jc["hidden"])
        values = [(f"carry/{k}", pc["hidden"][k], jh[k]) for k in sorted(jh)]
        values += [(f"policy/{k}", pc[k], jc[k]) for k in ("mean", "value")]
        for name, got, want in values:
            for e in report.add(name, got, want, tols.policy, 0):
                parted[int(e)].append(name)
        report.add("policy/std", pc["std"], jc["std"], tols.policy)
        report.add("carry/reset_prev", pc["reset_prev"], jc["reset_prev"])
        report.partings.extend((phase, t, e, q)
                               for e, q in sorted(parted.items()))
    for jh, ph in zip(J["h0"], P["h0"]):
        jh = flat_hidden(jh)
        for k in sorted(jh):
            report.add(f"h0/{k}", ph[k], jh[k], tols.policy)


def minibatch_cols(mb_action: np.ndarray, traj_action: np.ndarray
                   ) -> np.ndarray:
    """A minibatch's env columns: for each of its columns the env whose
    actions over the window ([T, mb, A] against the rollout's [T, B, A])
    it holds; -1 where none or more than one env does."""
    same = (mb_action[:, :, None] == traj_action[:, None]).all(axis=(0, 3))
    return np.where(same.sum(1) == 1, same.argmax(1), -1)


def _compare_minibatch(report: Report, phase: int, i: int, jm, pm, J, P,
                       tols: Tols, hold: bool):
    """A recurrent minibatch's columns and, if `hold`, its forward
    (`compare`). Returns its columns, or None where its forward parted."""
    cols = minibatch_cols(jm["action"], J["traj"][0]["action"])
    report.add("minibatch/cols", minibatch_cols(
        pm["action"], P["traj"][0]["action"]), cols)
    if (cols < 0).any():
        report.failures.append(f"minibatch {i}: columns not found")
    parted = defaultdict(list)
    for k in ("mean", "value") if hold else ():
        bad = ~(np.abs(pm[k].astype(np.float64) - jm[k])
                <= tols.policy[1] + tols.policy[0] * np.abs(jm[k]))
        report.add(f"minibatch/{k}", pm[k], jm[k], tols.policy, 1)
        for t, j in np.argwhere(bad.reshape(*bad.shape[:2], -1).any(-1)):
            parted[(int(t), int(cols[j]))].append(k)
    report.partings.extend((phase, f"{t} of minibatch {i}'s forward", e, q)
                           for (t, e), q in sorted(parted.items()))
    return None if parted else cols


def _compare_adam(report: Report, where: str, got: dict, want: dict,
                  activation: str, rnn: RecurrentTols, lrs: List[float]):
    """Parameters and Adam moments after an Adam step by `RecurrentTols`'
    rule; `lrs`, the LRs of the iteration's steps so far."""
    step = 2 * (lrs[-1] if rnn.per_step else sum(lrs)) + ADAM_NEAR
    for part, far, limit in (("params", rnn.far, step),
                             ("mu", rnn.far, rnn.mu_max),
                             ("nu", None, NU_MAX)):
        ref = jax_as_port(want[part], activation)
        d = {k: np.abs(got[part][k].astype(np.float64) - ref[k])
             for k in ref}
        n = sum(x.size for x in d.values())
        n_far = sum(int((x > ADAM_NEAR).sum()) for x in d.values())
        worst = max(d, key=lambda k: d[k].max())
        report.notes.append(
            f"{part} after {where}: {n_far} of {n} entries more than "
            f"{ADAM_NEAR} apart, max |diff| {d[worst].max():.3g} "
            f"({worst}; limit {limit:.3g})")
        row = report.rows[f"adam/{part}"]
        row[0] = max(row[0], float(d[worst].max()))
        row[1] = max(row[1], float(d[worst].max()) / limit)
        if d[worst].max() > limit:
            report.failures.append(f"{part} after {where}: {worst} "
                                   f"{d[worst].max():.3g} apart (limit "
                                   f"{limit:.3g})")
        if far is not None and n_far > far * n:
            report.failures.append(f"{part} after {where}: {n_far} of {n} "
                                   f"entries more than {ADAM_NEAR} apart "
                                   f"(allowed {far})")


def compare_reset(ls: Lockstep, tols: Tols) -> Report:
    """The port env's `reset`, fed JAX's `init_fn` draws, against JAX's
    initial env state and observation: flags and counters exactly, floats
    within `tols.env` (`tols.obs` for the observation)."""
    report = Report()
    state, obs = ls.reset
    got, want = port_env_state(state), jax_env_state(
        ls.jax_snaps[0]["env_state"])
    for k in sorted(want):
        report.add(f"reset/{k}", got.get(k), want[k],
                   None if k in EXACT else tols.env)
    report.add("reset/obs", _np(obs), ls.jax_snaps[0]["obs"], tols.obs)
    return report


def jax_step_from_port(ls: Lockstep, phase: int, step: int) -> dict:
    """JAX's env step `step` of iteration `phase` taken from the port's env
    state before that step, with the port's action: JAX's own env
    (uninstrumented, on the run's route) on the port's inputs, its key and
    so its draws unchanged. Returns the step's outputs and state as numpy,
    as a "step" event holds them."""
    import jax.numpy as jnp

    task, num_envs, _, overrides = CASES[ls.case]
    jenv = jax_env(task, num_envs, overrides, ls.jax_route)
    J = split_events(ls.jax_events[phase])
    P = split_events(ls.port_events[phase])
    jpre = (ls.jax_snaps[phase - 1]["env_state"] if step == 0
            else J["step"][step - 1]["state"])
    ppre = (P["step"][step - 1]["state"] if step > 0
            else None if phase == 1
            else ls.port_snaps[phase - 1]["env_state"])
    state = jax.tree_util.tree_map(jnp.asarray, jpre)
    if ppre is not None:
        state = state.replace(**{
            k: jnp.asarray(v, dtype=getattr(state, k).dtype)
            for k, v in ppre.items()})
    action = jnp.asarray(P["traj"][0]["action"][step])
    state, out = jax.jit(jenv.step)(state, action)
    return dict(obs=np.asarray(out.obs), reward=np.asarray(out.reward),
                state=jax_env_state(to_np(state)))
