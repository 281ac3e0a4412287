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


def describe(device) -> str:
    """What a measurement ran on: for a CUDA device the card's name and
    power limit as `nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader` gives them (the name alone without
    `nvidia-smi`), else "cpu"."""
    import subprocess

    dev = torch.device(device)
    if dev.type != "cuda":
        return "cpu"
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    try:
        smi = subprocess.run(
            ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=30)
        return smi.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return torch.cuda.get_device_name(index)
