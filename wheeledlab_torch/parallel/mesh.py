"""Shard arithmetic of a data-parallel job — the port of
`wheeledlab_tpu/parallel/mesh.py` in PyTorch's idiom.

The JAX package shards the env batch over a `data` mesh axis and lets GSPMD
insert the gradient psum. Here every rank is a process that holds its share
of the envs outright: rank r steps envs [r * B / W, (r + 1) * B / W) of the
global batch B on its own card, the policy is replicated (every rank builds
it from the same seed and applies the same all-reduced gradients), and the
env and learner generators of rank r are seeded with `shard_seed(seed, r)`,
so that rank 0 keeps a one-process run's streams and no two ranks share one.

Tensor parallelism (`shard_params_model_parallel`, `MODEL_AXIS`) is not
ported: no named config uses it (ROADMAP, "Left out by decision").
"""

from __future__ import annotations

import dataclasses

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
