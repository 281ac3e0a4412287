"""Device selection for the port's entry points: CUDA unless the caller asks
for the CPU."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """`torch.device` for `device`; raises if it names CUDA and there is no
    CUDA device, rather than running on the CPU unasked."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but CUDA is not available; "
            "pass device='cpu' (or --device cpu) to run on the CPU")
    return dev
