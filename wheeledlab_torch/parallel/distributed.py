"""Multi-process launch over `torch.distributed` — the port of
`wheeledlab_tpu/parallel/distributed.py`.

One process per rank. Launched by torchrun, a process finds its rank in the
environment:

    torchrun --nproc_per_node N -m wheeledlab_torch.cli.train -r POD_DRIFT_CONFIG

Each rank steps its own shard of the env batch (the physics has no
collective), shuffles its own shard, and all-reduces the gradients of every
minibatch (`rl/ppo.py`). Process 0 alone writes metrics, videos and stdout.

The collectives the learner needs are plain functions on tensors of the
default process group, or of a group of `global_mesh`'s (data, model) grid;
gloo all-reduces CUDA tensors too, so two ranks can share one card, which
NCCL refuses. Every collective here is an all-reduce, for that reason: gloo
has no all-gather of CUDA tensors.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Any, Optional

import torch
import torch.distributed as dist

from .mesh import DATA_AXIS, MODEL_AXIS, Mesh, World, make_mesh

TORCHRUN_VARS = ("RANK", "WORLD_SIZE", "MASTER_ADDR")


def launched() -> bool:
    """Whether this process belongs to a job of more than one process: a
    process group of several ranks exists, or torchrun started it with
    `WORLD_SIZE` > 1."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    return int(os.environ.get("WORLD_SIZE", "1")) > 1


def initialize(backend: Optional[str] = None,
               init_method: Optional[str] = None,
               world_size: Optional[int] = None, rank: Optional[int] = None,
               device="cuda", timeout_s: Optional[float] = None) -> None:
    """Join the job's process group; a no-op when already joined.

    With explicit arguments (`init_method` such as `tcp://127.0.0.1:<port>`,
    `world_size`, `rank`) this is strict: a failed rendezvous raises, since a
    process that silently trains alone corrupts the job. With none, it reads
    torchrun's `RANK`, `WORLD_SIZE` and `MASTER_ADDR` and stays a single
    process, with no group, when they are absent. The backend defaults to
    the one `device`'s tensors need: nccl for CUDA, gloo for the CPU. A
    CUDA rank's current device becomes `local_device()`."""
    if dist.is_initialized():
        return
    cuda = torch.device(device).type == "cuda"
    backend = backend or ("nccl" if cuda else "gloo")
    timeout = (None if timeout_s is None
               else datetime.timedelta(seconds=timeout_s))
    if init_method is None and world_size is None and rank is None:
        if not all(k in os.environ for k in TORCHRUN_VARS):
            return
        init_method = "env://"
    if cuda:
        torch.cuda.set_device(local_device())
    dist.init_process_group(
        backend, init_method=init_method, timeout=timeout,
        world_size=-1 if world_size is None else world_size,
        rank=-1 if rank is None else rank)


def shutdown() -> None:
    """Leave the process group, if this process joined one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_main_process() -> bool:
    return rank() == 0


def world() -> World:
    return World(rank=rank(), size=world_size())


def local_device() -> torch.device:
    """This rank's card: `cuda:{LOCAL_RANK % device_count}`, so that ranks
    beyond the host's cards share them."""
    local = int(os.environ.get("LOCAL_RANK", "0"))
    return torch.device("cuda", local % max(torch.cuda.device_count(), 1))


@dataclasses.dataclass(frozen=True)
class ProcessMesh:
    """This rank's place in the job's (data, model) grid and the process
    groups of its row and column. A group is None where it is the whole
    job (the default group) or where this rank is alone in it (no
    collective is issued)."""

    mesh: Mesh
    rank: int
    model_group: Optional[Any] = None
    data_group: Optional[Any] = None

    @property
    def data_index(self) -> int:
        return self.mesh.coords(self.rank)[0]

    @property
    def model_index(self) -> int:
        return self.mesh.coords(self.rank)[1]

    @property
    def data_size(self) -> int:
        return self.mesh.shape[DATA_AXIS]

    @property
    def model_size(self) -> int:
        return self.mesh.model_parallel


def global_mesh(model_parallel: int = 1) -> ProcessMesh:
    """The grid over every rank of the job (`make_mesh(world_size(),
    model_parallel)`), with this rank's model group (its row: the ranks
    that split the policy's layers over the same envs) and data group (its
    column: the ranks that average the gradients of one share). Every rank
    creates every group, in the same order, as `dist.new_group` requires.
    A world of one, or a grid with one row or one column, creates no
    group."""
    mesh = make_mesh(world_size(), model_parallel)
    rows, cols = mesh.shape[DATA_AXIS], mesh.shape[MODEL_AXIS]
    me = rank()
    model_group = data_group = None
    if rows > 1 and cols > 1:
        for i in range(rows):
            g = dist.new_group(mesh.model_group(i))
            if i == mesh.coords(me)[0]:
                model_group = g
        for j in range(cols):
            g = dist.new_group(mesh.data_group(j))
            if j == mesh.coords(me)[1]:
                data_group = g
    return ProcessMesh(mesh, me, model_group, data_group)


def local_batch_slice(global_batch: int) -> slice:
    """The slice of the global env batch this rank owns."""
    per = global_batch // world_size()
    return slice(rank() * per, (rank() + 1) * per)


# ------------------------------------------------------------- collectives


def all_reduce_sum_(t: torch.Tensor, group=None) -> torch.Tensor:
    """Sum `t` over the ranks (of `group`, default all), in place; returns
    `t`."""
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def all_reduce_mean_(t: torch.Tensor, group=None) -> torch.Tensor:
    """Mean of `t` over the ranks (of `group`, default all), in place;
    returns `t`."""
    return all_reduce_sum_(t, group).div_(dist.get_world_size(group))


def all_reduce_max_(t: torch.Tensor) -> torch.Tensor:
    """Maximum of `t` over the ranks, in place; returns `t`."""
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return t


def broadcast_object(obj: Any, src: int = 0) -> Any:
    """Rank `src`'s `obj` (a picklable value such as the run name) on every
    rank."""
    box = [obj]
    dist.broadcast_object_list(box, src=src)
    return box[0]


class _GatherColumns(torch.autograd.Function):
    """Forward: the full-width (..., m * w) result of the model group's m
    (..., w) column shares, share j from model index j. Built from an
    all-reduce (gloo has no all-gather of CUDA tensors): each rank writes
    its share into a zeroed buffer and the buffers are summed, which adds
    only zeros, so the result is exact. Backward: this rank's columns of
    the incoming gradient; every rank of the group computes the same loss
    from the same gathered activations, so that slice is the share's whole
    gradient."""

    @staticmethod
    def forward(ctx, local, index, size, group):
        w = local.shape[-1]
        ctx.cols = slice(index * w, (index + 1) * w)
        full = local.new_zeros(local.shape[:-1] + (size * w,))
        full[..., ctx.cols] = local
        return all_reduce_sum_(full, group)

    @staticmethod
    def backward(ctx, grad):
        return grad[..., ctx.cols], None, None, None


class _SumGradients(torch.autograd.Function):
    """Forward: the identity. Backward: the incoming gradient summed over
    the model group. The input of a split layer gets from each rank only
    the gradient through that rank's output columns; the sum is the whole
    gradient, which every rank needs for the layers before it."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_sum_(
            grad.clone(memory_format=torch.contiguous_format), ctx.group), None


def gather_columns(local: torch.Tensor, pm: ProcessMesh) -> torch.Tensor:
    """The full-width activation of a layer split over `pm`'s model group,
    from this rank's columns `local` (`_GatherColumns`)."""
    return _GatherColumns.apply(local, pm.model_index, pm.model_size,
                                pm.model_group)


def sum_gradients(x: torch.Tensor, pm: ProcessMesh) -> torch.Tensor:
    """`x`, with its gradient summed over `pm`'s model group
    (`_SumGradients`)."""
    return _SumGradients.apply(x, pm.model_group)
