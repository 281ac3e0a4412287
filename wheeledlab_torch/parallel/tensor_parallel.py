"""Tensor parallelism of the MLP actor-critic over `torch.distributed` —
what the JAX package gets from GSPMD when it passes the parameters placed
by `shard_params_model_parallel` into the same apply
(`wheeledlab_tpu/parallel/mesh.py:122-140`), written out.

Each rank of a model group holds its share of the policy
(`parallel/mesh.py::shard_params_model_parallel`). A split layer computes
its share of the output columns and gathers the group's shares into the
full-width activation before the activation function and the next layer
(`distributed.gather_columns`); the input of a split layer after the first
sums its gradient over the group (`distributed.sum_gradients`). A
replicated layer runs whole on every rank. Every rank of the group thus
computes the one-process policy's mean, std and value, and the gradient of
a loss of them reaches each share as its slice of the one-process gradient.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn
from torch.nn import functional as F

from ..rl.networks import ActorCritic
from . import distributed
from .distributed import ProcessMesh
from .mesh import model_parallel_placement, shard_params_model_parallel


class TensorParallelActorCritic(nn.Module):
    """This rank's share of `model` (float32) under `pm`'s model group,
    with the forward of `ActorCritic`. `placement[name]` says which
    parameters are split (dim 0) and which are whole; the parameters keep
    `model`'s names, with "." replaced by "/"."""

    def __init__(self, model: ActorCritic, pm: ProcessMesh):
        super().__init__()
        if model.compute_dtype != torch.float32:
            raise ValueError("tensor parallelism runs the float32 policy")
        self.pm = pm
        self.placement = model_parallel_placement(model, pm.model_size)
        self.shards = nn.ParameterDict({
            name.replace(".", "/"): nn.Parameter(x)
            for name, x in shard_params_model_parallel(
                model, pm.mesh, pm.rank).items()})
        # (layer name, its activation or None) for each Linear of each head
        self.heads = {}
        for head in ("actor", "critic"):
            seq = getattr(model, head)
            layers = []
            for i, m in enumerate(seq):
                if isinstance(m, nn.Linear):
                    act = seq[i + 1] if i + 1 < len(seq) else None
                    layers.append((f"{head}.{i}", act))
            self.heads[head] = layers

    def param(self, name: str) -> torch.Tensor:
        return self.shards[name.replace(".", "/")]

    def split(self, name: str) -> bool:
        return (self.pm.model_size > 1
                and self.placement[name + ".weight"] is not None)

    def head(self, name: str, x: torch.Tensor) -> torch.Tensor:
        for i, (layer, act) in enumerate(self.heads[name]):
            w, b = self.param(layer + ".weight"), self.param(layer + ".bias")
            if self.split(layer):
                if i:
                    x = distributed.sum_gradients(x, self.pm)
                x = distributed.gather_columns(F.linear(x, w, b), self.pm)
            else:
                x = F.linear(x, w, b)
            if act is not None:
                x = act(x)
        return x

    def forward(self, obs: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        mean = self.head("actor", obs)
        value = self.head("critic", obs)[..., 0]
        std = torch.exp(torch.clamp(self.param("log_std"), -5.0, 2.0))
        return mean, std.expand_as(mean), value
