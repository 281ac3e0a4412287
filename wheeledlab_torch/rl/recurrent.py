"""Recurrent actor-critic PPO — the port of `wheeledlab_tpu/rl/recurrent.py`
(rsl_rl's `ActorCriticRecurrent`: LSTM memory in front of the actor and
critic MLPs, the hidden state reset on episode done), selected by
`PPOCfg.policy_class = "ActorCriticRecurrent"`.

- Rollout: the LSTM carries live in the train state and run through the
  rollout; the carry entering a step is zeroed where the previous step
  ended an episode.
- Update: minibatches split the env axis (the log-prob recomputation needs
  the hidden chain). Each minibatch reruns both chains over the whole
  rollout window from the window-start hidden, resetting where `done`
  said, and backpropagates through the window.

The cells compute as flax `OptimizedLSTMCell(dtype=bfloat16)` with float32
parameters; the carries stay float32.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from ..utils.profiling import span, spanned
from .networks import _mlp, init_linears_, lecun_normal_, sigmoid
from .ppo import PPO, TrainState

# {"actor": [(c, h) per layer], "critic": [...]}: the JAX hidden tree
Hidden = Dict[str, List[Tuple[torch.Tensor, torch.Tensor]]]
CHAINS = ("actor", "critic")


class LSTMCell(nn.Module):
    """flax `OptimizedLSTMCell(features=H, dtype=bfloat16)`: the input
    kernels `ii, if, ig, io` (in, H, no bias) concatenated in gate order i,
    f, g, o as `wi` (in, 4H); the recurrent kernels `hi, hf, hg, ho` (H, H)
    as `wh` (H, 4H) with their biases as `bh` (4H). Init as flax's:
    truncated lecun-normal input kernels, an orthogonal (H, H) recurrent
    kernel per gate, zero biases."""

    def __init__(self, in_dim: int, hidden: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.wi = nn.Parameter(torch.empty(in_dim, 4 * hidden))
        self.wh = nn.Parameter(torch.empty(hidden, 4 * hidden))
        self.bh = nn.Parameter(torch.zeros(4 * hidden))
        with torch.no_grad():
            for k in range(4):
                gate = slice(k * hidden, (k + 1) * hidden)
                w = torch.empty(in_dim, hidden)
                lecun_normal_(w, in_dim, generator)
                self.wi[:, gate] = w
                w = torch.empty(hidden, hidden)
                nn.init.orthogonal_(w, generator=generator)
                self.wh[:, gate] = w


class _Gates(torch.autograd.Function):
    """The cell's gates from its pre-activations z (bfloat16, (..., 4H)):
    (i, f, g, o) = sigmoid, sigmoid, tanh, sigmoid of z's four chunks, as
    the forward computed them before (one sigmoid over all four chunks,
    g's computed and not used: the same values elementwise, in a quarter
    of the launches). The backward is JAX's: the logistic's rule, `d * (y
    * (1 - y))`, and the transpose of tanh's, `e = d * (1 - y)`, then `e +
    e * y`, each operation rounding to bfloat16 as XLA's does. Autograd's
    of 1 / (1 + exp(-z)) and `torch.tanh`'s `d * (1 - y * y)`, rounded
    once, move the gates' gradients by a bfloat16 ulp in a third of the
    entries. One Function for the four gates: its Python call is the
    host's cost of the rule."""

    @staticmethod
    def forward(ctx, z):
        s = sigmoid(z)
        g = torch.tanh(z.chunk(4, dim=-1)[2])
        ctx.save_for_backward(s, g)
        i, f, _, o = s.chunk(4, dim=-1)
        return i, f, g, o

    @staticmethod
    def backward(ctx, di, df, dg, do):
        s, g = ctx.saved_tensors
        dz = torch.cat([di, df, dg, do], dim=-1) * (s * (1.0 - s))
        e = dg * (1.0 - g)
        dz.chunk(4, dim=-1)[2].copy_(e + e * g)
        return dz


def lstm_step(carry: Tuple[torch.Tensor, torch.Tensor], dense_i: torch.Tensor,
              wh: torch.Tensor, bh: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One `LSTMCell` step from `carry` = (c, h), float32, (..., B, H).
    `dense_i` is the input's projection `bf16(x) @ bf16(wi)` (bfloat16,
    (..., B, 4H)); `wh` and `bh` are the cell's, float32: cast here, as
    flax casts them inside each step, so that the steps' gradients of a
    weight add up in float32 (the uses of one bfloat16 copy would add up
    in bfloat16). Leading axes batch cells side by side. Rounding points
    as flax's: the projections and their sum in bfloat16, the gates in
    bfloat16 (with JAX's backward, `_Gates`), `f * c` and the new carry
    in float32."""
    c, h = carry
    bf = torch.bfloat16
    z = h.to(bf) @ wh.to(bf) + bh.to(bf) + dense_i
    i, f, g, o = _Gates.apply(z)
    new_c = f * c + i * g
    new_h = o * torch.tanh(new_c)
    return new_c, new_h


class ActorCriticRecurrent(nn.Module):
    """LSTM memory (separate actor and critic chains of `rnn_num_layers`
    cells each, the rsl_rl layout) feeding the same MLP heads and
    state-independent Gaussian std as `ActorCritic`.

    `forward(hidden, obs_seq [T, B, D], reset_seq [T, B]) -> (hidden, mean
    [T, B, A], std, value [T, B])`; `step` is the single-step form."""

    def __init__(self, obs_dim: int, action_dim: int,
                 actor_hidden: Sequence[int] = (64, 64),
                 critic_hidden: Sequence[int] = (64, 64),
                 activation: str = "elu", init_noise_std: float = 1.0,
                 rnn_hidden_size: int = 256, rnn_num_layers: int = 1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.rnn_hidden_size, self.rnn_num_layers = (rnn_hidden_size,
                                                     rnn_num_layers)
        dims = [obs_dim] + [rnn_hidden_size] * (rnn_num_layers - 1)
        self.lstm_a = nn.ModuleList(LSTMCell(d, rnn_hidden_size, generator)
                                    for d in dims)
        self.lstm_c = nn.ModuleList(LSTMCell(d, rnn_hidden_size, generator)
                                    for d in dims)
        self.actor = _mlp(rnn_hidden_size, actor_hidden, action_dim,
                          activation)
        self.critic = _mlp(rnn_hidden_size, critic_hidden, 1, activation)
        for head in (self.actor, self.critic):
            init_linears_(head, generator)
        self.log_std = nn.Parameter(
            torch.full((action_dim,), math.log(init_noise_std)))

    def initial_hidden(self, batch: int, device=None) -> Hidden:
        zeros = lambda: torch.zeros((batch, self.rnn_hidden_size),
                                    device=device)
        return {chain: [(zeros(), zeros())
                        for _ in range(self.rnn_num_layers)]
                for chain in CHAINS}

    def memory(self, hidden: Hidden, obs_seq: torch.Tensor,
               reset_seq: torch.Tensor):
        """Both chains over the sequence -> (hidden, (xa, xc) [T, B, H]),
        the last layer's h of each chain in float32. The carry entering
        step t is multiplied by 1 - reset_seq[t] in every layer.

        The two chains are independent and of one shape, so they run side
        by side: each layer's carries, weights and products are stacked on
        a leading axis of 2 (actor, critic), and a step's products are one
        batched matmul, in half the launches of two chains one after the
        other."""
        bf = torch.bfloat16
        pairs = list(zip(self.lstm_a, self.lstm_c))
        # weights stacked: [2, in, 4H], [2, H, 4H], [2, 1, 4H]
        weights = [tuple(torch.stack([getattr(a, n), getattr(c, n)])
                         for n in ("wi", "wh", "bh")) for a, c in pairs]
        weights = [(wi, wh, bh[:, None]) for wi, wh, bh in weights]
        carry = [tuple(torch.stack([hidden["actor"][layer][k],
                                    hidden["critic"][layer][k]])
                       for k in range(2)) for layer in range(len(pairs))]
        # the first layer's input projection for the whole sequence, [T,
        # 2, B, 4H]: row for row the product flax's cell forms a step at a
        # time (unbound, so that the backward stacks its T gradients once;
        # the weight cast a step, as in `lstm_step`, so that their sum is in
        # float32)
        wi0 = weights[0][0]
        first_i = (obs_seq.to(bf)[:, None]
                   @ wi0.expand(len(obs_seq), *wi0.shape).to(bf)).unbind(0)
        seq = []
        for t, keep in enumerate((1.0 - reset_seq)[..., None].unbind(0)):
            x = None
            for layer, (wi, wh, bh) in enumerate(weights):
                c, h = carry[layer]
                dense_i = first_i[t] if layer == 0 else x.to(bf) @ wi.to(bf)
                carry[layer] = lstm_step((c * keep, h * keep), dense_i, wh,
                                         bh)
                x = carry[layer][1]
            seq.append(x)
        out = torch.stack(seq)                         # [T, 2, B, H]
        hidden = {chain: [(c[i], h[i]) for c, h in carry]
                  for i, chain in enumerate(CHAINS)}
        return hidden, (out[:, 0], out[:, 1])

    def forward(self, hidden: Hidden, obs_seq: torch.Tensor,
                reset_seq: torch.Tensor):
        hidden, (xa, xc) = self.memory(hidden, obs_seq, reset_seq)
        mean = self.actor(xa)
        value = self.critic(xc)[..., 0]
        std = torch.exp(torch.clamp(self.log_std, -5.0, 2.0))
        return hidden, mean, std.expand_as(mean), value

    def step(self, hidden: Hidden, obs: torch.Tensor,
             reset_prev: torch.Tensor):
        """One step: (hidden, obs [B, D], reset_prev [B]) -> (hidden, mean,
        std, value)."""
        hidden, mean, std, value = self(hidden, obs[None], reset_prev[None])
        return hidden, mean[0], std[0], value[0]


def gather_hidden(hidden: Hidden, cols: torch.Tensor) -> Hidden:
    return {chain: [(c[cols], h[cols]) for c, h in layers]
            for chain, layers in hidden.items()}


@dataclasses.dataclass
class RecurrentTrainState(TrainState):
    hidden: Hidden               # the LSTM carries, {actor, critic}
    reset_prev: torch.Tensor     # [B] done flags of the previous step


class RecurrentPPO(PPO):
    """The recurrent counterpart of `PPO`: the same PPO semantics (GAE,
    clipped surrogate and value loss, adaptive-KL LR, global-norm clip,
    Adam), with minibatches that split the env axis and an update that
    backpropagates through the rollout window. It computes its cells in
    bfloat16 whatever `compute_dtype` says, as the JAX learner does, and
    ignores `fuse_input_layer`, as the JAX recurrent learner does."""

    state_cls = RecurrentTrainState
    obs_dtype = torch.float32
    fused = False

    def build_model(self, generator):
        cfg, env = self.cfg, self.env
        return ActorCriticRecurrent(
            env.obs_dim, env.action_dim, cfg.actor_hidden, cfg.critic_hidden,
            cfg.activation, cfg.init_noise_std, cfg.rnn_hidden_size,
            cfg.rnn_num_layers, generator=generator)

    def init_state(self) -> RecurrentTrainState:
        env_state, obs = self.env.reset()
        n, dev = self.env.num_envs, self.env.device
        return RecurrentTrainState(
            env_state=env_state, obs=obs, iteration=0,
            hidden=self.model.initial_hidden(n, dev),
            reset_prev=torch.zeros(n, device=dev))

    # ------------------------------------------------------------- rollout

    @spanned("ppo.rollout")
    @torch.no_grad()
    def rollout(self, state: RecurrentTrainState, capture_traj: bool = False):
        """As `PPO.rollout`, with the carry reset by the previous step's
        done; the traj also holds `reset` (the flag each step's carry was
        reset by). Returns (env_state, obs, hidden, reset_prev, h0, traj,
        acc), h0 the window-start hidden."""
        traj = self.new_traj("reset")
        env_state, obs, acc = state.env_state, state.obs, None
        hidden, reset_prev = state.hidden, state.reset_prev
        captures = [] if capture_traj else None
        for t in range(self.cfg.num_steps_per_env):
            with span("ppo.act"):
                hidden, mean, std, value = self.model.step(hidden, obs,
                                                           reset_prev)
            traj["reset"][t] = reset_prev
            env_state, out, acc = self.act_and_step(
                traj, t, env_state, obs, mean, std, value, acc, captures)
            obs, reset_prev = out.obs, out.done.to(torch.float32)
        self.stack_captures(traj, captures)
        return env_state, obs, hidden, reset_prev, state.hidden, traj, acc

    # -------------------------------------------------------------- update

    def loss(self, batch):
        """(total, (surrogate, value, entropy, kl)) of one env-axis
        minibatch: `batch` = (h0, obs, reset, action, log_prob, value,
        returns, advantages, mean, std), each [T, mb_envs, ...] but h0."""
        h0, obs, reset, *rest = batch
        _, mean, std, value = self.model(h0, obs, reset)
        return self.ppo_loss(mean, std, value, *rest)

    @spanned("ppo.update")
    def update_epochs(self, h0: Hidden, dataset) -> torch.Tensor:
        """dataset: time-major [T, B, ...] tensors (obs, reset, action,
        log_prob, value, returns, norm_adv, mean, std). One env-axis
        permutation from the learner's generator, shared across epochs;
        minibatch i holds the envs `perm[i * mb:(i + 1) * mb]`, time-major,
        with their window-start hidden. Each rank of a job permutes its own
        envs (reference recurrent.py:335-351); `minibatch_update` reduces
        the gradients."""
        cfg = self.cfg
        nb = cfg.num_mini_batches
        n_envs = dataset[0].shape[1]
        mb = n_envs // nb
        with span("ppo.shuffle"):
            perm = torch.randperm(n_envs, generator=self.generator,
                                  device=dataset[0].device)
            cols = perm[: mb * nb].reshape(nb, mb)
            batches = [(gather_hidden(h0, c), *(x[:, c] for x in dataset))
                       for c in cols]
        metrics = [self.minibatch_update(batch)
                   for _ in range(cfg.num_learning_epochs)
                   for batch in batches]
        return torch.stack(metrics).mean(0)

    # ------------------------------------------------------ full iteration

    @spanned("ppo.iteration")
    def train_iteration(self, state: RecurrentTrainState,
                        capture_traj: bool = False):
        env_state, obs, hidden, reset_prev, h0, traj, acc = self.rollout(
            state, capture_traj)
        with torch.no_grad(), span("ppo.gae"):
            # the bootstrap value: one more step, its hidden thrown away
            _, _, _, last_value = self.model.step(hidden, obs, reset_prev)
            _, returns, norm_adv = self.compute_gae(
                traj["reward"], traj["value"], traj["done"], last_value)
        loss_metrics = self.update_epochs(h0, (
            traj["obs"], traj["reset"], traj["action"], traj["log_prob"],
            traj["value"], returns, norm_adv, traj["mean"], traj["std"]))
        metrics = self.iteration_metrics(traj, loss_metrics, acc)
        return RecurrentTrainState(
            env_state=env_state, obs=obs, iteration=state.iteration + 1,
            hidden=hidden, reset_prev=reset_prev), metrics

