"""PPO learner — the port of `wheeledlab_tpu/rl/ppo.py` (rsl_rl semantics,
reference modified_rsl_rl_runner.py:67-118 + RslRlPpoAlgorithmCfg,
drifting/.../rsl_rl_ppo_cfg.py:19-31).

One `train_iteration`: a rollout of `num_steps_per_env` env steps with the
`reward += gamma * V * time_out` bootstrap and online info folding, GAE,
advantage normalization, then `num_learning_epochs` x `num_mini_batches`
clipped-surrogate / clipped-value updates over one permutation shared across
epochs, each with the adaptive-KL learning rate, a global grad-norm clip and
Adam. Nothing in an iteration reads a value back to the host: the learning
rate is a device tensor that the fused Adam step reads.

In a job of several ranks (`world`, `parallel/`) each rank rolls out and
shuffles its own env shard; the gradients and the KL of every minibatch,
the advantage normalization's moments and the iteration's metrics are
all-reduced, so every rank holds the same parameters, learning rate and
metrics, as the reference's replicated state under GSPMD. A world of one
rank issues no collective and keeps the one-process bits.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from ..envs.env import EnvState, WheeledEnv
from ..parallel import distributed, mesh
from ..parallel.mesh import World
from ..utils.config import configclass
from ..utils.profiling import span, spanned
from .networks import (
    DTYPES, ActorCritic, fused_actor_critic_apply, gaussian_entropy,
    gaussian_kl, gaussian_log_prob,
)


@configclass
class PPOCfg:
    """Parity: RslRlPpoAlgorithmCfg + runner fields (rsl_rl_ppo_cfg.py:5-32)."""

    num_steps_per_env: int = 128
    num_learning_epochs: int = 5
    num_mini_batches: int = 4
    clip_param: float = 0.2
    gamma: float = 0.99
    lam: float = 0.95
    value_loss_coef: float = 1.0
    use_clipped_value_loss: bool = True
    entropy_coef: float = 0.005
    learning_rate: float = 1.0e-3
    schedule: str = "adaptive"       # "adaptive" | "fixed"
    desired_kl: float = 0.01
    max_grad_norm: float = 1.0
    min_lr: float = 1.0e-5
    max_lr: float = 1.0e-2
    # policy (rsl_rl RslRlPpoActorCriticCfg.class_name): "ActorCritic" |
    # "ActorCriticRecurrent"
    policy_class: str = "ActorCritic"
    actor_hidden: Tuple[int, ...] = (64, 64)
    critic_hidden: Tuple[int, ...] = (64, 64)
    activation: str = "elu"
    init_noise_std: float = 1.0
    rnn_hidden_size: int = 256       # recurrent policy only (rsl_rl default)
    rnn_num_layers: int = 1
    fuse_input_layer: bool = False
    # ^ run the actor's and the critic's first layers as one product
    # (`networks.fused_actor_critic_apply`) in the rollout, the update and
    # the bootstrap value; taken when the first hidden widths are equal.
    # The recurrent learner ignores it.
    compute_dtype: str = "float32"
    # ^ "bfloat16": the MLP policy computes in bfloat16 (float32 params and
    # heads, `networks.dense`) and the rollout stores its obs in bfloat16.
    # The dense layer rounds its input to bfloat16, so the update sees the
    # same matmul inputs whichever dtype the obs were stored in. The
    # recurrent learner ignores it (its cells are bfloat16 regardless).


def init_info_acc(info: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Zeroed scalar accumulators for an env's per-step info channels."""
    z = torch.zeros((), device=info["episode_return"].device)
    acc = {"episode_return": z, "episode_length": z}
    acc.update({k: z for k in info
                if k.startswith(("rew/", "metrics/", "done/"))})
    return acc


def info_increments(acc: Dict[str, torch.Tensor],
                    info: Dict[str, torch.Tensor],
                    done: torch.Tensor) -> Dict[str, torch.Tensor]:
    """What one rollout step adds to each accumulator of `acc`, in its
    order: rew/*, metrics/* their per-step batch means (later / num_steps);
    done/* their counts (later / n_done); the episode stats their
    done-masked sums."""
    dm = done.to(torch.float32)
    inc = {}
    for k in acc:
        if k in ("episode_return", "episode_length"):
            inc[k] = (info[k] * dm).sum()
        elif k.startswith(("rew/", "metrics/")):
            inc[k] = info[k].mean()
        elif k.startswith("done/"):
            inc[k] = info[k].sum()
    return inc


def accumulate_info(acc: Dict[str, torch.Tensor],
                    info: Dict[str, torch.Tensor],
                    done: torch.Tensor) -> Dict[str, torch.Tensor]:
    """One rollout step of metric folding (`info_increments`)."""
    return {k: acc[k] + v for k, v in info_increments(acc, info, done).items()}


def finalize_info_acc(acc: Dict[str, torch.Tensor], num_steps: int,
                      n_done: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Accumulators -> iteration metrics: rollout means of rew/* and
    metrics/*, done/* as fractions of finished episodes, and
    episode/return, episode/length as means over finished episodes."""
    out: Dict[str, torch.Tensor] = {}
    for name, v in acc.items():
        if name.startswith(("rew/", "metrics/")):
            out[name] = v / num_steps
        elif name.startswith("done/"):
            out[name] = v / n_done
    out["episode/return"] = acc["episode_return"] / n_done
    out["episode/length"] = acc["episode_length"] / n_done
    return out


def global_moments(x: torch.Tensor, world_size: int):
    """(mean, population std) of `x` over every rank's `x` (equal shapes):
    the sum, then the squared deviations from the global mean, each
    all-reduced, as GSPMD computes `jnp.mean` and `jnp.std` of a sharded
    array."""
    n = x.numel() * world_size
    mean = distributed.all_reduce_sum_(x.sum()) / n
    sq = distributed.all_reduce_sum_(((x - mean) ** 2).sum())
    return mean, torch.sqrt(sq / n)


def all_reduce_grads(params, kl: torch.Tensor, group=None) -> torch.Tensor:
    """Replace the gradient of every parameter in `params` by its mean over
    the ranks of `group` (default all; a tensor-parallel job passes its data
    group), in one collective on one flat buffer that also carries the
    minibatch's `kl`; returns the mean `kl`. The learner runs it before the
    adaptive LR and the clip, which then see the global KL and the global
    norm."""
    grads = [p.grad for p in params]
    flat = torch.cat([g.reshape(-1) for g in grads] + [kl.reshape(1)])
    distributed.all_reduce_mean_(flat, group)
    for g, part in zip(grads, torch.split(flat[:-1],
                                          [g.numel() for g in grads])):
        g.copy_(part.view_as(g))
    return flat[-1]


def reduce_metrics(acc, num_dones, reward_mean, loss_metrics, nan,
                   world_size: int):
    """The iteration's metric inputs over every rank, in one sum all-reduce
    and one max: counts and done-masked sums are summed (so episode/return
    is the global sum over the global `num_dones`), per-rank means (rew/*,
    metrics/*, the reward mean, the losses) averaged over the equal shards,
    the NaN flag maxed. Returns them in the order given."""
    names = list(acc)
    flat = torch.cat([torch.stack([acc[k] for k in names]
                                  + [num_dones, reward_mean]), loss_metrics])
    distributed.all_reduce_sum_(flat)
    is_mean = torch.tensor(
        [k.startswith(("rew/", "metrics/")) for k in names]
        + [False, True] + [True] * loss_metrics.numel(), device=flat.device)
    flat = torch.where(is_mean, flat / world_size, flat)
    k = len(names)
    return (dict(zip(names, flat[:k])), flat[k], flat[k + 1], flat[k + 2:],
            distributed.all_reduce_max_(nan))


def traj_captures(env_state: EnvState) -> Dict[str, torch.Tensor]:
    """One step's trajectory capture of the first 8 envs, for the training
    videos (the reference's `traj_captures`): position, yaw, orientation
    (for the policy-view clip of camera tasks) and goal."""
    v = env_state.vehicle
    quat = v.quat[:8]
    qw, qx, qy, qz = quat.unbind(-1)
    return {
        "traj/pos": v.pos[:8],
        "traj/yaw": torch.atan2(2 * (qw * qz + qx * qy),
                                1 - 2 * (qy**2 + qz**2)),
        "traj/quat": quat,
        "traj/cmd": env_state.command[:8, :2],
    }


@dataclasses.dataclass
class TrainState:
    env_state: EnvState
    obs: torch.Tensor
    iteration: int


# Rollout steps taken by `StepGraph` (a replay each on a card, but a first
# step whose obs lie otherwise than the graph reads them, which its step
# runs uncaptured) and by the eager loop (`PPO.act_and_step`), counted like
# the kernels' launches: the first over their sum is the graphed share of
# rollout steps.
GRAPH_STEPS = 0
EAGER_STEPS = 0

# the EnvState tensors a fused step reads and replaces, which the graph's
# step copies back into its inputs (the others it reads, or the host keeps)
CARRIED = ("vehicle_mem", "step_count", "last_action", "push_timers",
           "ep_return", "ep_len")


class StepGraph:
    """A `PPO` rollout step as one CUDA graph, replayed once a step: the
    policy's forward, the action's sample and log-prob, the env's fused step
    (its random rows, K1 or K4, its outputs), the timeout bootstrap, the 8
    stores into the trajectory at a device step index, and the info
    folding. It works on buffers that live as long as it does: the obs (as
    the fused step's (obs_dim, B) rows, so the policy reads the layout the
    eager loop's steps read), the EnvState tensors the step writes, the (7,)
    curriculum weights, the [T, B, ...] trajectory and the accumulators. The
    step copies its outputs back into its inputs (about 11 MB at 65,536
    envs), so one graph serves every step. `packed_params`, `command` and
    `command_timer` are read where they are: `serves` checks that a rollout
    hands in those same tensors.

    On a card the graph is captured when the object is made: one warm-up
    step on a copy of the incoming state, on the capture stream, then the
    capture; both generators are registered with the graph and their states
    put back afterwards, so the capture consumes no draw, a replay draws
    what the eager step draws, and after a rollout the generators stand
    where the eager loop leaves them. On the CPU `replay` runs the step as
    it stands."""

    def __init__(self, learner: "PPO", state: TrainState):
        self.learner = learner
        env, es = learner.env, state.env_state
        dev = env.device
        self.traj = learner.new_traj()
        self.obs_rows = torch.empty((env.obs_dim, env.num_envs), device=dev)
        self.state = dataclasses.replace(
            es, reward_weights=torch.empty_like(es.reward_weights),
            **{k: torch.empty_like(getattr(es, k)) for k in CARRIED})
        self.t = torch.zeros((1,), dtype=torch.long, device=dev)
        self.acc_names: Optional[Tuple[str, ...]] = None
        self.acc = torch.zeros((0,), device=dev)
        self.weights_from: Optional[torch.Tensor] = None
        self.graph = None
        if dev.type == "cuda":
            with span("ppo.graph_capture"):
                self.capture(state)

    def serves(self, env_state: EnvState) -> bool:
        """Whether the graph reads this state's read-only tensors."""
        return all(getattr(env_state, k) is getattr(self.state, k)
                   for k in ("packed_params", "command", "command_timer"))

    def capture(self, state: TrainState):
        """Warm up on a copy of `state`, capture the step, put the
        generators back."""
        learner = self.learner
        dev = learner.env.device
        gens = (learner.generator, learner.env.generator)
        saved = [g.get_state() for g in gens]
        self.load(state)
        stream = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            self.step()
        torch.cuda.current_stream(dev).wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        for g in gens:
            graph.register_generator_state(g)
        # thread_local: another thread (the checkpoint writer) may call the
        # CUDA runtime meanwhile without spoiling the capture
        with torch.cuda.graph(graph, stream=stream,
                              capture_error_mode="thread_local"):
            self.step()
        for g, s in zip(gens, saved):
            g.set_state(s)
        self.graph = graph

    def load(self, state: TrainState):
        """Copy a rollout's incoming state in; zero the step index and the
        accumulators."""
        self.obs_rows.copy_(state.obs.T)
        for k in CARRIED:
            getattr(self.state, k).copy_(getattr(state.env_state, k))
        self.t.zero_()
        self.acc.zero_()
        self.weights_from = None

    def step(self, obs: Optional[torch.Tensor] = None):
        """One rollout step on the buffers: what the graph holds. Given
        `obs`, the policy reads it where it lies in place of the obs rows."""
        learner = self.learner
        if obs is None:
            obs = self.obs_rows.T
        with span("ppo.act"):
            mean, std, value = learner.policy_apply(obs)
        with span("ppo.record"):
            action = mean + std * torch.randn(
                mean.shape, generator=learner.generator, device=obs.device)
            log_prob = gaussian_log_prob(mean, std, action)
        new, out = learner.env.step(self.state, action)
        with span("ppo.record"):
            reward = out.reward + learner.cfg.gamma * value * out.time_out
            for k, v in (("obs", obs), ("action", action),
                         ("log_prob", log_prob), ("value", value),
                         ("reward", reward), ("done", out.done),
                         ("mean", mean), ("std", std)):
                buf = self.traj[k]
                buf.index_copy_(0, self.t, v.to(buf.dtype)[None])
            if self.acc_names is None:
                self.acc_names = tuple(init_info_acc(out.info))
                self.acc = torch.zeros((len(self.acc_names),),
                                       device=obs.device)
            inc = info_increments(dict.fromkeys(self.acc_names), out.info,
                                  out.done)
            self.acc.add_(torch.stack(list(inc.values())))
            self.obs_rows.copy_(out.obs.T)
            for k in CARRIED:
                getattr(self.state, k).copy_(getattr(new, k))
            self.t.add_(1)

    def lays_out_like(self, obs: torch.Tensor) -> bool:
        """Whether `obs` lies as the policy's input does in the graph."""
        return obs.stride() == self.obs_rows.T.stride()

    def replay(self, weights: torch.Tensor,
               obs: Optional[torch.Tensor] = None):
        """One step with the curriculum `weights`, copied in when they are
        another tensor than the last step's (the env's cached tensors, so
        identity is the test and nothing is read back). Given `obs` (laid
        out otherwise than the graph reads), the step runs uncaptured."""
        global GRAPH_STEPS
        if weights is not self.weights_from:
            self.state.reward_weights.copy_(weights)
            self.weights_from = weights
        with span("ppo.step_graph"):
            if self.graph is None or obs is not None:
                self.step(obs)
            else:
                self.graph.replay()
        GRAPH_STEPS += 1

    def result(self, env_state: EnvState, common_step: int,
               weights: torch.Tensor):
        """(env_state, obs, traj, acc) as `PPO.rollout` returns them, from
        copies of the buffers, so that no caller holds a tensor the next
        rollout overwrites; the trajectory is the graph's own (every reader
        of it is done within the iteration)."""
        new = dataclasses.replace(
            env_state, common_step=common_step, reward_weights=weights,
            **{k: getattr(self.state, k).clone() for k in CARRIED})
        acc = dict(zip(self.acc_names, self.acc.clone().unbind()))
        return new, self.obs_rows.clone().T, dict(self.traj), acc


class PPO:
    """The learner: the policy, its optimizer and the learner's generator
    (action noise and the epoch permutation)."""

    state_cls = TrainState

    def __init__(self, env: WheeledEnv, cfg: PPOCfg, seed: int = 0,
                 world: Optional[World] = None,
                 shard_seed: Optional[int] = None):
        self.env, self.cfg = env, cfg
        # None unless there is another rank to reduce with
        self.world = world if world is not None and world.size > 1 else None
        dev = env.device
        # the same initial parameters on every rank
        self.model = self.build_model(
            torch.Generator().manual_seed(seed + 1)).to(dev)
        # fused Adam takes the learning rate as a device tensor, so the
        # adaptive schedule never syncs with the host
        self.optimizer = torch.optim.Adam(
            self.model.parameters(),
            lr=torch.tensor(cfg.learning_rate, device=dev), fused=True)
        if shard_seed is None:
            shard_seed = mesh.shard_seed(seed, world.rank if world else 0)
        self.generator = torch.Generator(device=dev)
        self.generator.manual_seed(shard_seed + 2)
        self.step_graph: Optional[StepGraph] = None

    def build_model(self, generator: torch.Generator) -> ActorCritic:
        cfg, env = self.cfg, self.env
        return ActorCritic(
            env.obs_dim, env.action_dim, cfg.actor_hidden, cfg.critic_hidden,
            cfg.activation, cfg.init_noise_std, generator=generator,
            compute_dtype=cfg.compute_dtype)

    @property
    def fused(self) -> bool:
        """Whether the policy runs through `fused_actor_critic_apply`."""
        cfg = self.cfg
        return (cfg.fuse_input_layer
                and cfg.actor_hidden[0] == cfg.critic_hidden[0])

    def policy_apply(self, obs: torch.Tensor):
        """(mean, std, value) of the policy on `obs`: the fused apply when
        `fused`, else the module's forward (the JAX learner's `apply_fn`)."""
        if self.fused:
            return fused_actor_critic_apply(self.model, obs)
        return self.model(obs)

    @property
    def obs_dtype(self) -> torch.dtype:
        """The dtype the rollout stores its obs in (JAX `store_obs`)."""
        return DTYPES[self.cfg.compute_dtype]

    @property
    def lr(self) -> torch.Tensor:
        return self.optimizer.param_groups[0]["lr"]

    def init_state(self) -> TrainState:
        env_state, obs = self.env.reset()
        return TrainState(env_state=env_state, obs=obs, iteration=0)

    # ------------------------------------------------------------- rollout

    def new_traj(self, *extra: str) -> Dict[str, torch.Tensor]:
        """Empty time-major [T, B, ...] rollout buffers: the transition's
        columns, plus a [T, B] float column for each name in `extra`."""
        cfg, env = self.cfg, self.env
        shape = (cfg.num_steps_per_env, env.num_envs)
        buf = lambda *s, dtype=torch.float32: torch.empty(
            shape + s, dtype=dtype, device=env.device)
        a = env.action_dim
        traj = {"obs": buf(env.obs_dim, dtype=self.obs_dtype),
                "action": buf(a), "log_prob": buf(), "value": buf(),
                "reward": buf(), "done": buf(), "mean": buf(a),
                "std": buf(a)}
        traj.update({k: buf() for k in extra})
        return traj

    def act_and_step(self, traj, t, env_state, obs, mean, std, value, acc,
                     captures=None):
        """Sample the action from the policy's (mean, std), step the env
        and store transition t in `traj` (with the timeout bootstrap
        `reward += gamma * V * time_out`, rsl_rl process_env_step); fold
        the step's info into `acc` (None before the first step) and, when
        `captures` is a list, append the step's `traj_captures`. Returns
        (env_state, step output, acc). The span `ppo.record` covers all
        but the env step: two calls a step."""
        with span("ppo.record"):
            action = mean + std * torch.randn(
                mean.shape, generator=self.generator, device=self.env.device)
            log_prob = gaussian_log_prob(mean, std, action)
        env_state, out = self.env.step(env_state, action)
        with span("ppo.record"):
            reward = out.reward + self.cfg.gamma * value * out.time_out
            for k, v in (("obs", obs), ("action", action),
                         ("log_prob", log_prob), ("value", value),
                         ("reward", reward), ("done", out.done),
                         ("mean", mean), ("std", std)):
                traj[k][t] = v
            if acc is None:
                acc = init_info_acc(out.info)
            acc = accumulate_info(acc, out.info, out.done)
            if captures is not None:
                captures.append(traj_captures(env_state))
        global EAGER_STEPS
        EAGER_STEPS += 1
        return env_state, out, acc

    @staticmethod
    def stack_captures(traj, captures):
        """The `traj/*` channels of a captured rollout, [T, 8, ...]."""
        for k in (captures[0] if captures else ()):
            traj[k] = torch.stack([c[k] for c in captures])

    @spanned("ppo.rollout")
    @torch.no_grad()
    def rollout(self, state: TrainState, capture_traj: bool = False):
        """Returns (env_state, obs, traj dict of time-major [T, B, ...]
        tensors, info accumulators). With `capture_traj` the dict also holds
        the `traj/*` channels of `traj_captures`, [T, 8, ...], for a
        video. Replays the step graph where `graphs_rollout` says so."""
        if self.graphs_rollout(capture_traj):
            return self.graphed_rollout(state)
        traj = self.new_traj()
        env_state, obs, acc = state.env_state, state.obs, None
        captures = [] if capture_traj else None
        for t in range(self.cfg.num_steps_per_env):
            with span("ppo.act"):
                mean, std, value = self.policy_apply(obs)
            env_state, out, acc = self.act_and_step(
                traj, t, env_state, obs, mean, std, value, acc, captures)
            obs = out.obs
        self.stack_captures(traj, captures)
        return env_state, obs, traj, acc

    def graphs_rollout(self, capture_traj: bool) -> bool:
        """Whether `rollout` replays a `StepGraph`: `PPO` itself (a
        subclass keeps its own rollout), on a card, on an env that takes its
        task's fused step, with no `traj/*` capture."""
        env = self.env
        return (type(self) is PPO and env.device.type == "cuda"
                and not capture_traj and env.task.fused_step is not None
                and not env.per_vehicle)

    def graphed_rollout(self, state: TrainState):
        """`rollout` as replays of the learner's `StepGraph` (made at the
        first call, and again for a state whose read-only tensors are other
        ones). The host keeps the step counter and the curriculum weights
        as the eager loop does."""
        g = self.step_graph
        if g is None or not g.serves(state.env_state):
            g = self.step_graph = StepGraph(self, state)
        g.load(state)
        env = self.env
        common_step = state.env_state.common_step
        weights = state.env_state.reward_weights
        # a float32 product's bits follow its input's layout (at 1024 envs
        # on an H100): obs that lie otherwise than the graph's rows (a
        # reset's, a checkpoint's) are read where they lie, as the eager
        # loop's first step reads them
        first = None if g.lays_out_like(state.obs) else state.obs
        for t in range(self.cfg.num_steps_per_env):
            g.replay(weights, first if t == 0 else None)
            common_step += 1
            weights = env._curriculum_weights(weights, common_step)
        return g.result(state.env_state, common_step, weights)

    # ----------------------------------------------------------------- GAE

    def compute_gae(self, reward, value, done, last_value):
        """[T, B] rewards/values/dones -> (advantages, returns, normalized
        advantages). The normalization uses the population std, as
        `jnp.std` does."""
        cfg = self.cfg
        advantages = torch.empty_like(reward)
        adv_next = torch.zeros_like(last_value)
        v_next = last_value
        for t in reversed(range(reward.shape[0])):
            nonterminal = 1.0 - done[t]
            delta = reward[t] + cfg.gamma * v_next * nonterminal - value[t]
            adv_next = (delta
                        + cfg.gamma * cfg.lam * nonterminal * adv_next)
            advantages[t] = adv_next
            v_next = value[t]
        returns = advantages + value
        if self.world is None:
            mean, std = advantages.mean(), advantages.std(correction=0)
        else:
            mean, std = global_moments(advantages, self.world.size)
        norm_adv = (advantages - mean) / (std + 1e-8)
        return advantages, returns, norm_adv

    # -------------------------------------------------------------- update

    def loss(self, batch):
        """(total, (surrogate, value, entropy, kl)) of one minibatch."""
        obs, *rest = batch
        mean, std, value = self.policy_apply(obs)
        return self.ppo_loss(mean, std, value, *rest)

    def ppo_loss(self, mean, std, value, action, old_log_prob, old_value,
                 ret, adv, old_mean, old_std):
        """The clipped surrogate, the (clipped) value loss, the entropy
        bonus and the KL estimate of the policy's (mean, std, value) on a
        minibatch."""
        cfg = self.cfg
        log_prob = gaussian_log_prob(mean, std, action)
        ratio = torch.exp(log_prob - old_log_prob)
        surr1 = ratio * adv
        surr2 = torch.clamp(ratio, 1.0 - cfg.clip_param,
                            1.0 + cfg.clip_param) * adv
        surrogate_loss = -torch.minimum(surr1, surr2).mean()

        if cfg.use_clipped_value_loss:
            value_clipped = old_value + torch.clamp(
                value - old_value, -cfg.clip_param, cfg.clip_param)
            value_loss = torch.maximum(
                (value - ret) ** 2, (value_clipped - ret) ** 2).mean()
        else:
            value_loss = ((value - ret) ** 2).mean()

        entropy = gaussian_entropy(std).mean()
        kl = gaussian_kl(old_mean, old_std, mean, std).mean()
        total = (surrogate_loss + cfg.value_loss_coef * value_loss
                 - cfg.entropy_coef * entropy)
        return total, (surrogate_loss, value_loss, entropy, kl)

    @spanned("ppo.minibatch")
    def minibatch_update(self, batch) -> torch.Tensor:
        """One gradient step; returns [total, surrogate, value, entropy,
        kl] (detached)."""
        cfg = self.cfg
        with span("ppo.forward"):
            total, (surr, vloss, ent, kl) = self.loss(batch)
        with span("ppo.backward"):
            self.optimizer.zero_grad(set_to_none=True)
            total.backward()
        with span("ppo.optimizer"):
            kl = kl.detach()
            if self.world is not None:
                kl = all_reduce_grads(list(self.model.parameters()), kl)

            if cfg.schedule == "adaptive":
                # rsl_rl adaptive-KL LR, set before this minibatch's Adam step
                lr = self.lr
                new = torch.where(kl > cfg.desired_kl * 2.0,
                                  torch.clamp(lr / 1.5, min=cfg.min_lr), lr)
                new = torch.where((kl < cfg.desired_kl / 2.0) & (kl > 0.0),
                                  torch.clamp(new * 1.5, max=cfg.max_lr), new)
                lr.copy_(new)

            # optax.clip_by_global_norm: scale by max / norm once norm >= max
            grads = [p.grad for p in self.model.parameters()]
            g_norm = torch.sqrt(sum((g * g).sum() for g in grads))
            keep = g_norm < cfg.max_grad_norm
            for g in grads:
                g.copy_(torch.where(keep, g, g / g_norm * cfg.max_grad_norm))
            self.optimizer.step()
        return torch.stack([total, surr, vloss, ent, kl]).detach()

    @spanned("ppo.update")
    def update_epochs(self, dataset) -> torch.Tensor:
        """dataset: tuple of time-major [T, B, ...] tensors (obs, action,
        log_prob, value, returns, norm_adv, mean, std). One permutation
        shared across epochs (rsl_rl's mini_batch_generator); the float32
        columns are packed into one array so the shuffle is one gather
        (two when the obs are stored in bfloat16). Each rank of a job
        shuffles its own shard (reference ppo.py:365-376). Returns the mean
        of the minibatch metrics."""
        cfg = self.cfg
        nb = cfg.num_mini_batches
        t_len, b = dataset[0].shape[:2]
        n = t_len * b
        mb = n // nb
        cols = [x.reshape(n, -1) for x in dataset]
        with span("ppo.shuffle"):
            perm = torch.randperm(n, generator=self.generator,
                                  device=dataset[0].device)[: mb * nb]
            split = 1 if cols[0].dtype != cols[1].dtype else 0
            packed = cols[split:]
            widths = [c.shape[1] for c in packed]
            shuffled = torch.cat(packed, dim=1)[perm]
            obs = cols[0][perm] if split else None
            batches = []
            for i in range(nb):
                rows = slice(i * mb, (i + 1) * mb)
                parts = list(torch.split(shuffled[rows], widths, dim=1))
                if split:
                    parts.insert(0, obs[rows])
                batches.append(tuple(
                    p if x.ndim == 3 else p[:, 0]
                    for p, x in zip(parts, dataset)))
        metrics = [self.minibatch_update(batch)
                   for _ in range(cfg.num_learning_epochs)
                   for batch in batches]
        return torch.stack(metrics).mean(0)

    # ------------------------------------------------------ full iteration

    @spanned("ppo.metrics")
    def iteration_metrics(self, traj, loss_metrics, acc
                          ) -> Dict[str, torch.Tensor]:
        """The iteration's metrics (the JAX learner's keys), with the
        rollout's `traj/*` channels when it captured them."""
        # episode stats: mean over transitions where an episode finished
        num_dones = traj["done"].sum()
        reward_mean = traj["reward"].mean()
        nan = 1.0 - (torch.isfinite(traj["action"]).all()
                     & torch.isfinite(loss_metrics).all()).to(torch.float32)
        if self.world is not None:
            acc, num_dones, reward_mean, loss_metrics, nan = reduce_metrics(
                acc, num_dones, reward_mean, loss_metrics, nan,
                self.world.size)
        n_done = torch.clamp(num_dones, min=1.0)
        metrics = {
            "loss/total": loss_metrics[0],
            "loss/surrogate": loss_metrics[1],
            "loss/value": loss_metrics[2],
            "loss/entropy": loss_metrics[3],
            "loss/kl": loss_metrics[4],
            "lr": self.lr.detach().clone(),
            "episode/num_dones": num_dones,
            "rollout/reward_mean": reward_mean,
            # NaN guard (parity: modified_rsl_rl_runner.py:74-75); the
            # runner raises when this fires
            "nan/detected": nan,
        }
        metrics.update(finalize_info_acc(acc, self.cfg.num_steps_per_env,
                                         n_done))
        metrics.update({k: v for k, v in traj.items()
                        if k.startswith("traj/")})
        return metrics

    @spanned("ppo.iteration")
    def train_iteration(self, state: TrainState, capture_traj: bool = False
                        ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """One PPO iteration. With `capture_traj` the metrics also carry the
        rollout's `traj/*` channels ([T, 8, ...] tensors, not scalars)."""
        env_state, obs, traj, acc = self.rollout(state, capture_traj)
        with torch.no_grad(), span("ppo.gae"):
            _, _, last_value = self.policy_apply(obs)
            _, returns, norm_adv = self.compute_gae(
                traj["reward"], traj["value"], traj["done"], last_value)
        dataset = (traj["obs"], traj["action"], traj["log_prob"],
                   traj["value"], returns, norm_adv, traj["mean"],
                   traj["std"])
        loss_metrics = self.update_epochs(dataset)
        return TrainState(env_state=env_state, obs=obs,
                          iteration=state.iteration + 1), \
            self.iteration_metrics(traj, loss_metrics, acc)

    # ---------------------------------------------------------- checkpoint

    def state_dict(self) -> dict:
        return {"model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict(),
                "generator": self.generator.get_state()}

    def load_state_dict(self, sd: dict):
        self.model.load_state_dict(sd["model"])
        self.optimizer.load_state_dict(sd["optimizer"])
        # a generator's state is a CPU byte tensor, wherever the
        # checkpoint was mapped to
        self.generator.set_state(sd["generator"].cpu())


def make_learner(env: WheeledEnv, cfg: PPOCfg, seed: int = 0,
                 world: Optional[World] = None,
                 shard_seed: Optional[int] = None) -> PPO:
    """Policy-class dispatch (rsl_rl resolves RslRlPpoActorCriticCfg
    .class_name to ActorCritic or ActorCriticRecurrent; the runner is
    agnostic to which).

    `world` (the JAX learner's `mesh=`) is this rank's place in a job of
    several ranks, each holding its own env shard in `env`. The policy's
    initial parameters come from `seed` on every rank; the learner's
    generator (action noise, shuffles) from `shard_seed`, which defaults to
    `parallel.shard_seed(seed, world.rank)`."""
    if cfg.compute_dtype not in DTYPES:
        raise ValueError(f"unknown compute_dtype {cfg.compute_dtype!r}")
    if cfg.policy_class == "ActorCritic":
        return PPO(env, cfg, seed, world, shard_seed)
    if cfg.policy_class == "ActorCriticRecurrent":
        from .recurrent import RecurrentPPO

        return RecurrentPPO(env, cfg, seed, world, shard_seed)
    raise ValueError(f"unknown policy_class {cfg.policy_class!r}")
