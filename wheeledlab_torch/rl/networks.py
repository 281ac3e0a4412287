"""Actor-critic policy — the port of `wheeledlab_tpu/rl/networks.py`
(rsl_rl's ActorCritic MLP as configured by the reference: hidden [64, 64],
elu/relu, Gaussian with state-independent learned std, init_noise_std=1.0;
reference rsl_rl_ppo_cfg.py:12-18).

Compute dtype is float32 by default; `compute_dtype="bfloat16"` runs the
MLPs with flax `Dense(dtype=bfloat16)` semantics (`dense`), parameters kept
in float32 and the heads cast back to float32.

`fused_actor_critic_apply` is `ActorCritic.forward` with the actor's and the
critic's first layers run as one product (`PPOCfg.fuse_input_layer`)."""

from __future__ import annotations

import functools
import math
from typing import Optional, Sequence, Tuple

import torch
from torch import nn
from torch.nn import functional as F

# flax's `nn.gelu` is the tanh approximation by default
_ACTS = {"elu": nn.ELU, "relu": nn.ReLU, "tanh": nn.Tanh,
         "gelu": functools.partial(nn.GELU, approximate="tanh")}

# flax's lecun_normal draws from a normal truncated at +-2 std and rescales
# by this constant so the truncated draw keeps unit variance
_TRUNC_STD = 0.87962566103423978

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def dense(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
          dtype: torch.dtype) -> torch.Tensor:
    """flax `Dense(dtype=dtype)` (`promote_dtype`): the input, the float32
    `(out, in)` weight and the bias are cast to `dtype`, the product comes
    out in `dtype` and the bias is added in `dtype`. The bias is added
    apart from the product (not fused as `F.linear` does), so that the sum
    rounds where flax's does."""
    return x.to(dtype) @ weight.to(dtype).T + bias.to(dtype)


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """`jax.nn.sigmoid` as XLA expands it on the CPU and GPU: 1 / (1 +
    exp(-x)), each operation rounding to the input's dtype (for bfloat16
    this differs from a sigmoid rounded once in a third of the inputs).
    `torch.reciprocal` is the division of 1 in one launch (`1.0 / t` is
    a reciprocal and a multiply)."""
    return torch.reciprocal(1.0 + torch.exp(-x))


def mlp_apply(seq: nn.Sequential, x: torch.Tensor,
              dtype: torch.dtype) -> torch.Tensor:
    """`seq` (Linear/act stack) in `dtype`: every Linear through `dense`,
    the activations in `dtype`."""
    if dtype == torch.float32:
        return seq(x)
    for m in seq:
        x = dense(x, m.weight, m.bias, dtype) if isinstance(m, nn.Linear) \
            else m(x)
    return x


def _mlp(in_dim: int, hidden: Sequence[int], out_dim: int,
         activation: str) -> nn.Sequential:
    """Linear/act stack; layer keys `0, 2, 4, ...` (the rsl_rl layout)."""
    layers, d = [], in_dim
    for h in hidden:
        layers += [nn.Linear(d, h), _ACTS[activation]()]
        d = h
    layers.append(nn.Linear(d, out_dim))
    return nn.Sequential(*layers)


def lecun_normal_(w: torch.Tensor, fan_in: int,
                  generator: Optional[torch.Generator] = None):
    """flax's `lecun_normal`: a normal of variance 1/fan_in truncated at 2
    standard deviations (in place)."""
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                          generator=generator)


@torch.no_grad()
def init_linears_(module: nn.Module,
                  generator: Optional[torch.Generator] = None):
    """flax Dense's default init for every `nn.Linear` in `module`:
    truncated lecun-normal kernels (variance 1/fan_in) and zero biases."""
    for m in module.modules():
        if isinstance(m, nn.Linear):
            lecun_normal_(m.weight, m.in_features, generator)
            nn.init.zeros_(m.bias)


class ActorCritic(nn.Module):
    """`forward(obs) -> (mean, std, value)`; std = exp(clip(log_std,
    -5, 2)) broadcast to the mean's shape. Under `compute_dtype=
    "bfloat16"` the MLPs compute in bfloat16 and mean and value are cast
    back to float32."""

    def __init__(self, obs_dim: int, action_dim: int,
                 actor_hidden: Sequence[int] = (64, 64),
                 critic_hidden: Sequence[int] = (64, 64),
                 activation: str = "elu", init_noise_std: float = 1.0,
                 generator: Optional[torch.Generator] = None,
                 compute_dtype: str = "float32"):
        super().__init__()
        self.compute_dtype = DTYPES[compute_dtype]
        self.actor = _mlp(obs_dim, actor_hidden, action_dim, activation)
        self.critic = _mlp(obs_dim, critic_hidden, 1, activation)
        self.log_std = nn.Parameter(
            torch.full((action_dim,), math.log(init_noise_std)))
        init_linears_(self, generator)

    def forward(self, obs: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        dt = self.compute_dtype
        mean = mlp_apply(self.actor, obs, dt).float()
        value = mlp_apply(self.critic, obs, dt)[..., 0].float()
        std = torch.exp(torch.clamp(self.log_std, -5.0, 2.0))
        return mean, std.expand_as(mean), value


# Calls of `fused_actor_critic_apply`, counted like the kernels' launches
FUSED_CALLS = 0


def fused_actor_critic_apply(model: ActorCritic, obs: torch.Tensor
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """`model(obs)` with the actor's and the critic's first layers run as
    one product over their weights concatenated along the output axis — the
    port of the JAX package's `fused_actor_critic_apply`. One (B, in) x
    (in, 2 h1) product and its one weight gradient in place of two at
    N = h1, for wide observations (elevation 689, visual 3208).

    The parameters are unchanged: the weights are concatenated at every
    call (autograd runs through `torch.cat`), so the state dict,
    checkpoints and export do not move. In float32 the product is
    `F.linear`, as `nn.Linear` computes it; in bfloat16 it is `dense`, which
    rounds where flax's `Dense(dtype=bfloat16)` does (casting the
    concatenated weight gives the bits of the concatenated casts). The
    result differs from `model(obs)` only by the product's reduction order.
    Requires equal first hidden widths."""
    global FUSED_CALLS
    FUSED_CALLS += 1
    dt = model.compute_dtype
    actor0, critic0 = model.actor[0], model.critic[0]
    h1 = actor0.out_features
    w = torch.cat([actor0.weight, critic0.weight], 0)
    b = torch.cat([actor0.bias, critic0.bias])
    hidden = (F.linear(obs, w, b) if dt == torch.float32
              else dense(obs, w, b, dt))
    hidden = model.actor[1](hidden)
    mean = mlp_apply(model.actor[2:], hidden[..., :h1], dt).float()
    value = mlp_apply(model.critic[2:], hidden[..., h1:], dt)[..., 0].float()
    std = torch.exp(torch.clamp(model.log_std, -5.0, 2.0))
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
