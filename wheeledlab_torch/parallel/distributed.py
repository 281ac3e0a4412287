"""Multi-process launch over `torch.distributed` — the port of
`wheeledlab_tpu/parallel/distributed.py`.

One process per rank. Launched by torchrun, a process finds its rank in the
environment:

    torchrun --nproc_per_node N -m wheeledlab_torch.cli.train -r POD_DRIFT_CONFIG

Each rank steps its own shard of the env batch (the physics has no
collective), shuffles its own shard, and all-reduces the gradients of every
minibatch (`rl/ppo.py`). Process 0 alone writes metrics, videos and stdout.

The collectives the learner needs are plain functions on tensors of the
default process group; gloo all-reduces CUDA tensors too, so two ranks can
share one card, which NCCL refuses.
"""

from __future__ import annotations

import datetime
import os
from typing import Any, Optional

import torch
import torch.distributed as dist

from .mesh import World

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


def local_batch_slice(global_batch: int) -> slice:
    """The slice of the global env batch this rank owns."""
    per = global_batch // world_size()
    return slice(rank() * per, (rank() + 1) * per)


# ------------------------------------------------------------- collectives


def all_reduce_sum_(t: torch.Tensor) -> torch.Tensor:
    """Sum `t` over the ranks, in place; returns `t`."""
    dist.all_reduce(t, op=dist.ReduceOp.SUM)
    return t


def all_reduce_mean_(t: torch.Tensor) -> torch.Tensor:
    """Mean of `t` over the ranks, in place; returns `t`."""
    return all_reduce_sum_(t).div_(world_size())


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
