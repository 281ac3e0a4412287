"""Flat-ground physics control step — kernel K2.

Port of `wheeledlab_tpu/ops/pallas_substep.py::pallas_step`: `decimation`
flat-ground substeps on the packed (rows, B) layout. Two pieces:

- `physics_step_rows`: the plain PyTorch version, the `sim/soa.py::
  substep_soa` loop. It is the CPU path and the kernel's oracle.
- `physics_step`: the wrapper. CPU tensors run `physics_step_rows`; CUDA
  tensors launch the kernel of `csrc/physics_step.cu` (built at first use)
  or raise. It counts its kernel launches in `LAUNCHES`.

See `csrc/physics_step.cu` for the kernel's bound and design.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..sim.soa import NUM_PARAM, NUM_STATE, substep_soa
from .checks import check_rows

# Kernel launches made by `physics_step` (CUDA tensors only).
LAUNCHES = 0


def physics_step_rows(state, params, steer_t, wheel_t, *, dt: float,
                      decimation: int) -> torch.Tensor:
    """`decimation` x `substep_soa`: (NUM_STATE, B) -> (NUM_STATE, B)."""
    for _ in range(decimation):
        state = substep_soa(state, params, steer_t, wheel_t, dt)
    return state


@functools.lru_cache(maxsize=None)
def _kernel_fn():
    """The ctypes launcher, built and loaded on first use."""
    from .build import load_library

    fn = load_library("physics_step").physics_step_launch
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int]
                   + [ctypes.c_float] * 3 + [ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def physics_step(state, params, steer_t, wheel_t, *, dt: float,
                 decimation: int) -> torch.Tensor:
    """One flat-ground control step, the counterpart of the reference
    `pallas_step`: state (21, B), params (46, B), steer_t (2, B), wheel_t
    (4, B) f32, contiguous -> new state (21, B). CPU tensors run the plain
    version; CUDA tensors launch the kernel, asynchronously on the current
    stream."""
    global LAUNCHES
    device = state.device
    b = state.shape[-1]
    for name, x, rows in (("state", state, NUM_STATE),
                          ("params", params, NUM_PARAM),
                          ("steer_t", steer_t, 2), ("wheel_t", wheel_t, 4)):
        check_rows(name, x, rows, b, device)
    if device.type == "cpu":
        return physics_step_rows(state, params, steer_t, wheel_t, dt=dt,
                                 decimation=decimation)
    if device.type != "cuda":
        raise ValueError(f"physics_step runs on cpu or cuda, not {device}")

    f = lambda x: float(np.float32(x))
    out = torch.empty_like(state)
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = _kernel_fn()(state.data_ptr(), params.data_ptr(),
                           steer_t.data_ptr(), wheel_t.data_ptr(),
                           out.data_ptr(), b, f(dt), f(dt * dt),
                           f(0.5 * dt), int(decimation), stream)
    if err != 0:
        raise RuntimeError(f"physics_step kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES += 1
    return out
