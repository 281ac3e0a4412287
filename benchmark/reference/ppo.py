"""Plain reference of the PPO learner (rsl_rl's PPO as the reference
WheeledLab configures it, `rsl_rl_ppo_cfg.py:5-32`): the Gaussian MLP
actor-critic with flax's initialisation, the rollout with the time-out
bootstrap, GAE with normalised advantages, and the clipped-surrogate update
with the adaptive-KL learning rate, the global-norm clip and PyTorch's
fused Adam.

A frozen copy of the plain computation, written apart from the program (it
imports nothing of it). It follows the program's order of random draws and
of floating-point operations, so that, fed the same seed and configuration,
it follows the program's first iterations. `follow` returns what the
benchmark compares: each iteration's loss, the first clipped gradient and
the parameters' change.
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Optional

import torch
from torch import nn
from torch.nn import functional as F

_ACTS = {"elu": nn.ELU, "relu": nn.ReLU, "tanh": nn.Tanh}
# flax's lecun_normal: a normal truncated at +-2 std, rescaled to unit
# variance
_TRUNC_STD = 0.87962566103423978


def _mlp(in_dim, hidden, out_dim, activation):
    layers, d = [], in_dim
    for h in hidden:
        layers += [nn.Linear(d, h), _ACTS[activation]()]
        d = h
    layers.append(nn.Linear(d, out_dim))
    return nn.Sequential(*layers)


class ActorCritic(nn.Module):
    """Actor and critic MLPs and a state-independent log std."""

    def __init__(self, obs_dim, action_dim, agent: dict, seed: int):
        super().__init__()
        self.actor = _mlp(obs_dim, agent["actor_hidden"], action_dim,
                          agent["activation"])
        self.critic = _mlp(obs_dim, agent["critic_hidden"], 1,
                           agent["activation"])
        self.log_std = nn.Parameter(torch.full(
            (action_dim,), math.log(agent["init_noise_std"])))
        self.fused = (agent["fuse_input_layer"]
                      and agent["actor_hidden"][0] == agent["critic_hidden"][0])
        g = torch.Generator().manual_seed(seed + 1)
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, nn.Linear):
                    std = math.sqrt(1.0 / m.in_features) / _TRUNC_STD
                    nn.init.trunc_normal_(m.weight, 0.0, std, -2.0 * std,
                                          2.0 * std, generator=g)
                    nn.init.zeros_(m.bias)

    def forward(self, obs):
        if self.fused:
            # the actor's and the critic's first layers as one product
            a0, c0 = self.actor[0], self.critic[0]
            h1 = a0.out_features
            w = torch.cat([a0.weight, c0.weight], 0)
            b = torch.cat([a0.bias, c0.bias])
            hidden = self.actor[1](F.linear(obs, w, b))
            mean = self.actor[2:](hidden[..., :h1])
            value = self.critic[2:](hidden[..., h1:])[..., 0]
        else:
            mean = self.actor(obs)
            value = self.critic(obs)[..., 0]
        std = torch.exp(torch.clamp(self.log_std, -5.0, 2.0))
        return mean, std.expand_as(mean), value


def log_prob(mean, std, action):
    var = std**2
    lp = -0.5 * ((action - mean) ** 2 / var + torch.log(2 * math.pi * var))
    return lp.sum(-1)


def entropy(std):
    return (0.5 * math.log(2 * math.pi * math.e) + torch.log(std)).sum(-1)


def kl(mean1, std1, mean2, std2):
    return (torch.log(std2 / std1)
            + (std1**2 + (mean1 - mean2) ** 2) / (2.0 * std2**2)
            - 0.5).sum(-1)


class Readings(NamedTuple):
    """What a run of the first iterations gives to compare: each
    iteration's mean loss, the first minibatch's clipped gradient and each
    parameter's change over the iterations, by parameter name."""

    losses: List[float]
    first_grad: Dict[str, torch.Tensor]
    change: Dict[str, torch.Tensor]


class Learner:
    """The reference learner on an env of `reference/<task>.py`.

    `fault` plants one of the faults the benchmark's check must catch, for
    its own tests and calibration: "frozen" (no parameter ever moves),
    "half_batch" (each minibatch's loss over its first half only),
    "reward" (env 0's reward altered where the env produces it)."""

    def __init__(self, env, agent: dict, seed: int, device,
                 fault: Optional[str] = None):
        self.env, self.agent, self.device, self.fault = env, agent, device, fault
        self.model = ActorCritic(env.obs_dim, env.action_dim, agent,
                                 seed).to(device)
        # PyTorch's fused Adam, the learning rate a device tensor that the
        # adaptive schedule sets in place: its rounding is the one the
        # program's optimizer has, and a one-ulp difference in a parameter
        # can move a later minibatch's KL across the schedule's thresholds
        self.lr = torch.tensor(agent["learning_rate"], device=device)
        self.adam = torch.optim.Adam(self.model.parameters(), lr=self.lr,
                                     fused=True)
        self.g = torch.Generator(device=device)
        self.g.manual_seed(seed + 2)

    # ------------------------------------------------------------- rollout

    @torch.no_grad()
    def rollout(self, env_state, obs):
        a, env = self.agent, self.env
        t_len, n = a["num_steps_per_env"], env.n
        buf = lambda *s: torch.empty((t_len, n) + s, device=self.device)
        traj = {"obs": buf(env.obs_dim), "action": buf(env.action_dim),
                "log_prob": buf(), "value": buf(), "reward": buf(),
                "done": buf(), "mean": buf(env.action_dim),
                "std": buf(env.action_dim)}
        for t in range(t_len):
            mean, std, value = self.model(obs)
            action = mean + std * torch.randn(mean.shape, generator=self.g,
                                              device=self.device)
            lp = log_prob(mean, std, action)
            env_state, out = env.step(env_state, action)
            reward = out.reward
            if self.fault == "reward":
                reward = reward.clone()
                reward[0] += 1.0
            reward = reward + a["gamma"] * value * out.time_out
            for k, v in (("obs", obs), ("action", action), ("log_prob", lp),
                         ("value", value), ("reward", reward),
                         ("done", out.done), ("mean", mean), ("std", std)):
                traj[k][t] = v
            obs = out.obs
        return env_state, obs, traj

    @torch.no_grad()
    def gae(self, reward, value, done, last_value):
        a = self.agent
        advantages = torch.empty_like(reward)
        adv_next = torch.zeros_like(last_value)
        v_next = last_value
        for t in reversed(range(reward.shape[0])):
            nonterminal = 1.0 - done[t]
            delta = reward[t] + a["gamma"] * v_next * nonterminal - value[t]
            adv_next = delta + a["gamma"] * a["lam"] * nonterminal * adv_next
            advantages[t] = adv_next
            v_next = value[t]
        returns = advantages + value
        mean, std = advantages.mean(), advantages.std(correction=0)
        return returns, (advantages - mean) / (std + 1e-8)

    # -------------------------------------------------------------- update

    def loss(self, obs, action, old_lp, old_value, ret, adv, old_mean,
             old_std):
        a = self.agent
        if self.fault == "half_batch":
            half = obs.shape[0] // 2
            obs, action, old_lp, old_value, ret, adv, old_mean, old_std = (
                x[:half] for x in (obs, action, old_lp, old_value, ret, adv,
                                   old_mean, old_std))
        mean, std, value = self.model(obs)
        ratio = torch.exp(log_prob(mean, std, action) - old_lp)
        clip = a["clip_param"]
        surrogate = -torch.minimum(
            ratio * adv, torch.clamp(ratio, 1.0 - clip, 1.0 + clip) * adv
        ).mean()
        if a["use_clipped_value_loss"]:
            clipped = old_value + torch.clamp(value - old_value, -clip, clip)
            value_loss = torch.maximum((value - ret) ** 2,
                                       (clipped - ret) ** 2).mean()
        else:
            value_loss = ((value - ret) ** 2).mean()
        total = (surrogate + a["value_loss_coef"] * value_loss
                 - a["entropy_coef"] * entropy(std).mean())
        return total, kl(old_mean, old_std, mean, std).mean()

    def minibatch(self, batch, on_first_grad):
        a = self.agent
        params = list(self.model.parameters())
        self.adam.zero_grad(set_to_none=True)
        total, kl_mean = self.loss(*batch)
        total.backward()
        kl_mean = kl_mean.detach()
        if a["schedule"] == "adaptive":
            lr = self.lr
            new = torch.where(kl_mean > a["desired_kl"] * 2.0,
                              torch.clamp(lr / 1.5, min=a["min_lr"]), lr)
            new = torch.where((kl_mean < a["desired_kl"] / 2.0)
                              & (kl_mean > 0.0),
                              torch.clamp(new * 1.5, max=a["max_lr"]), new)
            lr.copy_(new)
        grads = [p.grad for p in params]
        g_norm = torch.sqrt(sum((g * g).sum() for g in grads))
        keep = g_norm < a["max_grad_norm"]
        for g in grads:
            g.copy_(torch.where(keep, g, g / g_norm * a["max_grad_norm"]))
        if on_first_grad is not None:
            on_first_grad(grads)
        if self.fault != "frozen":
            self.adam.step()
        return total.detach()

    def update(self, traj, returns, norm_adv, on_first_grad):
        a = self.agent
        dataset = (traj["obs"], traj["action"], traj["log_prob"],
                   traj["value"], returns, norm_adv, traj["mean"], traj["std"])
        nb = a["num_mini_batches"]
        t_len, b = dataset[0].shape[:2]
        n = t_len * b
        mb = n // nb
        cols = [x.reshape(n, -1) for x in dataset]
        perm = torch.randperm(n, generator=self.g,
                              device=self.device)[: mb * nb]
        widths = [c.shape[1] for c in cols]
        shuffled = torch.cat(cols, dim=1)[perm]
        batches = []
        for i in range(nb):
            parts = torch.split(shuffled[i * mb:(i + 1) * mb], widths, dim=1)
            batches.append(tuple(p if x.ndim == 3 else p[:, 0]
                                 for p, x in zip(parts, dataset)))
        totals = []
        for _ in range(a["num_learning_epochs"]):
            for batch in batches:
                totals.append(self.minibatch(batch, on_first_grad))
                on_first_grad = None
        return torch.stack(totals).mean()

    # ------------------------------------------------------------- follow

    def follow(self, iterations: int) -> Readings:
        """Run `iterations` training iterations from the seed's reset and
        return their readings."""
        names = [k for k, _ in self.model.named_parameters()]
        start = [p.detach().clone() for p in self.model.parameters()]
        first = {}

        def on_first_grad(grads):
            first.update({k: g.detach().clone() for k, g in zip(names, grads)})

        env_state, obs = self.env.reset()
        losses = []
        for _ in range(iterations):
            env_state, obs, traj = self.rollout(env_state, obs)
            with torch.no_grad():
                _, _, last_value = self.model(obs)
                returns, norm_adv = self.gae(traj["reward"], traj["value"],
                                             traj["done"], last_value)
            losses.append(self.update(traj, returns, norm_adv,
                                      on_first_grad if not first else None))
            del traj, returns, norm_adv
        change = {k: (p.detach() - s) for k, p, s in
                  zip(names, self.model.parameters(), start)}
        return Readings(losses=[float(x) for x in losses], first_grad=first,
                        change=change)
