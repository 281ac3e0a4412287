"""Actor-critic policy — the port of `wheeledlab_tpu/rl/networks.py`
(rsl_rl's ActorCritic MLP as configured by the reference: hidden [64, 64],
elu/relu, Gaussian with state-independent learned std, init_noise_std=1.0;
reference rsl_rl_ppo_cfg.py:12-18)."""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

_ACTS = {"elu": nn.ELU, "relu": nn.ReLU, "tanh": nn.Tanh, "gelu": nn.GELU}

# flax's lecun_normal draws from a normal truncated at +-2 std and rescales
# by this constant so the truncated draw keeps unit variance
_TRUNC_STD = 0.87962566103423978


def _mlp(in_dim: int, hidden: Sequence[int], out_dim: int,
         activation: str) -> nn.Sequential:
    """Linear/act stack; layer keys `0, 2, 4, ...` (the rsl_rl layout)."""
    layers, d = [], in_dim
    for h in hidden:
        layers += [nn.Linear(d, h), _ACTS[activation]()]
        d = h
    layers.append(nn.Linear(d, out_dim))
    return nn.Sequential(*layers)


class ActorCritic(nn.Module):
    """`forward(obs) -> (mean, std, value)`; std = exp(clip(log_std,
    -5, 2)) broadcast to the mean's shape."""

    def __init__(self, obs_dim: int, action_dim: int,
                 actor_hidden: Sequence[int] = (64, 64),
                 critic_hidden: Sequence[int] = (64, 64),
                 activation: str = "elu", init_noise_std: float = 1.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.actor = _mlp(obs_dim, actor_hidden, action_dim, activation)
        self.critic = _mlp(obs_dim, critic_hidden, 1, activation)
        self.log_std = nn.Parameter(
            torch.full((action_dim,), math.log(init_noise_std)))
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """flax Dense's default init: truncated lecun-normal kernels
        (variance 1/fan_in) and zero biases."""
        for m in self.modules():
            if isinstance(m, nn.Linear):
                std = math.sqrt(1.0 / m.in_features) / _TRUNC_STD
                nn.init.trunc_normal_(m.weight, 0.0, std, -2.0 * std,
                                      2.0 * std, generator=generator)
                nn.init.zeros_(m.bias)

    def forward(self, obs: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        mean = self.actor(obs)
        value = self.critic(obs)[..., 0]
        std = torch.exp(torch.clamp(self.log_std, -5.0, 2.0))
        return mean, std.expand_as(mean), value


def gaussian_log_prob(mean, std, action):
    """Diagonal Gaussian log-prob summed over action dims."""
    var = std**2
    lp = -0.5 * ((action - mean) ** 2 / var + torch.log(2 * math.pi * var))
    return lp.sum(-1)


def gaussian_entropy(std):
    return (0.5 * math.log(2 * math.pi * math.e) + torch.log(std)).sum(-1)


def gaussian_kl(mean1, std1, mean2, std2):
    """KL(N1 || N2) summed over dims — the rsl_rl adaptive-lr KL estimate."""
    kl = (torch.log(std2 / std1)
          + (std1**2 + (mean1 - mean2) ** 2) / (2.0 * std2**2) - 0.5)
    return kl.sum(-1)
