"""Input checks shared by the kernel wrappers: the kernels take contiguous
(rows, B) blocks of one dtype on one device, and nothing else."""

from __future__ import annotations

import torch


def check_rows(name: str, x: torch.Tensor, rows: int, b: int,
               device: torch.device, dtype=torch.float32):
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} has dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != (rows, b):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, "
                         f"expected {(rows, b)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
