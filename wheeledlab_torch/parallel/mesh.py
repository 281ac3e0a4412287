"""The (data, model) grid of a job's ranks and the shard arithmetic — the
port of `wheeledlab_tpu/parallel/mesh.py` in PyTorch's idiom.

The JAX package shards the env batch over a `data` mesh axis and lets GSPMD
insert the gradient psum. Here every rank is a process that holds its share
of the envs outright: data index i steps envs [i * B / D, (i + 1) * B / D)
of the global batch B on its own card, the policy is replicated over the
data axis (every rank builds it from the same seed and applies the same
all-reduced gradients), and the env and learner generators of data index i
are seeded with `shard_seed(seed, i)`, so that index 0 keeps a one-process
run's streams and no two shards share one. In a job without a model axis
the data index is the rank.

Tensor parallelism: `make_mesh(W, m)` lays the W ranks out as a (W / m, m)
grid, and `shard_params_model_parallel` gives each rank its model-index
share of the policy's layers (`parallel/tensor_parallel.py` runs them).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

DATA_AXIS = "data"
MODEL_AXIS = "model"

# the shard constant of `wheeledlab_tpu/tasks/drift/fused.py:600-604`
SHARD_SEED_STRIDE = 0x3779B1


@dataclasses.dataclass(frozen=True)
class World:
    """This process's place in the job: its rank and the number of ranks."""

    rank: int = 0
    size: int = 1


def shard_seed(seed: int, rank: int) -> int:
    """The seed of rank `rank`'s env and learner generators."""
    return seed + rank * SHARD_SEED_STRIDE


def int32_shard_offset(rank: int) -> int:
    """`rank * SHARD_SEED_STRIDE` wrapped to int32, the offset of rank
    `rank`'s in-kernel random stream (the reference adds it to an int32
    seed, which wraps)."""
    v = (rank * SHARD_SEED_STRIDE) & 0xFFFFFFFF
    return v - (1 << 32) if v >= 1 << 31 else v


def local_num_envs(num_envs: int, world_size: int) -> int:
    """The envs one rank holds; raises unless `world_size` divides
    `num_envs`."""
    if num_envs % world_size:
        raise ValueError(f"num_envs={num_envs} not divisible by the "
                         f"{world_size}-rank world")
    return num_envs // world_size


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The ranks of a job as a (data, model) grid: rank r sits at data
    index r // m and model index r % m, JAX's row-major `reshape(n // m,
    m)` of the device list. The ranks of one model group (one data index)
    hold the same envs and split the policy's layers; the ranks of one data
    group (one model index) hold the same shares of the policy and average
    their gradients."""

    world_size: int
    model_parallel: int = 1

    @property
    def shape(self) -> Dict[str, int]:
        return {DATA_AXIS: self.world_size // self.model_parallel,
                MODEL_AXIS: self.model_parallel}

    def coords(self, rank: int) -> Tuple[int, int]:
        """(data index, model index) of `rank`."""
        return divmod(rank, self.model_parallel)

    def model_group(self, data_index: int) -> List[int]:
        """The ranks at `data_index`, in model-index order."""
        m = self.model_parallel
        return list(range(data_index * m, (data_index + 1) * m))

    def data_group(self, model_index: int) -> List[int]:
        """The ranks at `model_index`, in data-index order."""
        return list(range(model_index, self.world_size, self.model_parallel))


def make_mesh(world_size: int, model_parallel: int = 1) -> Mesh:
    """The (world_size / model_parallel, model_parallel) grid of a job's
    ranks; raises unless `model_parallel` divides `world_size`."""
    if model_parallel < 1 or world_size % model_parallel:
        raise ValueError(f"{world_size} ranks not divisible by "
                         f"model={model_parallel}")
    return Mesh(world_size, model_parallel)


def model_parallel_placement(model: nn.Module, model_parallel: int
                             ) -> Dict[str, Optional[int]]:
    """JAX's rule of `shard_params_model_parallel` for each parameter of
    `model`: the dim split over the model axis, or None when the parameter
    is replicated. A 2-D weight whose output width (dim 0 of torch's
    `(out, in)`) divides by `model_parallel` is split along it, and so is a
    bias of such a width; everything else is replicated: a head narrower
    than the axis (the critic's, width 1) and `log_std`, which the JAX rule
    leaves whole because it matches the names "kernel" and "bias"."""
    out = {}
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        split = ((p.ndim == 2 and leaf == "weight")
                 or (p.ndim == 1 and leaf == "bias"))
        out[name] = 0 if split and p.shape[0] % model_parallel == 0 else None
    return out


def shard_params_model_parallel(model: nn.Module, mesh: Mesh, rank: int
                                ) -> Dict[str, torch.Tensor]:
    """Rank `rank`'s copy of `model`'s parameters under
    `model_parallel_placement`: a split parameter keeps its model-index
    share of output rows, a replicated one is whole. Copies, detached."""
    m = mesh.model_parallel
    _, j = mesh.coords(rank)
    placement = model_parallel_placement(model, m)
    shards = {}
    for name, p in model.named_parameters():
        x = p.detach()
        if placement[name] is not None:
            x = x.chunk(m, placement[name])[j]
        shards[name] = x.clone()
    return shards
