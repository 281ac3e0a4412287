"""K drift control steps in one launch, with the state resident.

Port of `scripts/limiter_probe.py::multi_step_pallas` (the Pallas TPU kernel
of the limiter probe): the fused drift step runs K times inside one kernel.
Step i reads rows [2i, 2i+2) of the stacked actions, [12i, 12i+12) of the
uniforms and [14i, 14i+14) of the normals; state, params, push timers and the
episode accumulators stay on chip between the steps; no observation or info
block is written. It separates the cost of a step's arithmetic from the cost
of being launched once per control step, and is the shape of an open-loop
rollout for sampling planners.

- `multi_step_rows`: the plain PyTorch version, K chained `drift_step_rows`
  calls on the sliced rows; the CPU path and the kernel's oracle.
- `multi_step`: the wrapper. CPU tensors go to `multi_step_rows`; CUDA
  tensors launch the kernel of `csrc/multi_step.cu` (built at first use) or
  raise. It counts its launches in `LAUNCHES`.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..tasks.drift.fused import (
    NUM_UNIFORM, OBS_ROWS, FusedDriftConsts, FusedDriftConstsC,
    check_step_inputs, drift_step_rows,
)
from .checks import check_rows

# Kernel launches made by `multi_step` (CUDA tensors only).
LAUNCHES = 0


def multi_step_rows(weights, poses, state, params, actions, uniforms,
                    normals, step_count, timers, ep_return, ep_len, cfg, k):
    """The plain PyTorch version, in the wrapper's layout."""
    sc, er, el = step_count[0], ep_return[0], ep_len[0]
    for i in range(k):
        state, _obs, _out, sc, timers, er, el = drift_step_rows(
            state, params, actions[2 * i], actions[2 * i + 1],
            uniforms[NUM_UNIFORM * i:NUM_UNIFORM * (i + 1)],
            normals[OBS_ROWS * i:OBS_ROWS * (i + 1)], weights, poses, sc,
            timers, er, el, cfg=cfg)
    return state, sc[None], timers, er[None], el[None]


@functools.lru_cache(maxsize=None)
def _kernel_fn():
    """The ctypes launcher, built and loaded on first use."""
    from .build import load_library

    fn = load_library("multi_step").multi_step_launch
    fn.argtypes = ([FusedDriftConstsC] + [ctypes.c_void_p] * 16
                   + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def multi_step(weights, poses, state, params, actions, uniforms, normals,
               step_count, timers, ep_return, ep_len, cfg: FusedDriftConsts,
               k: int):
    """`k` chained control steps: the counterpart of the reference
    `multi_step_pallas`, for any B.

    weights (7,), poses (N, 4), state (21, B), params (46, B), actions
    (2k, B), uniforms (12k, B), normals (14k, B), ep_return (1, B) f32;
    step_count (1, B), timers (n_push, B), ep_len (1, B) int32.

    Returns (state (21, B), step_count (1, B), timers (n_push, B), ep_return
    (1, B), ep_len (1, B)) after the k-th step. CPU tensors run
    `multi_step_rows`; CUDA tensors launch the kernel, asynchronously on the
    current stream."""
    global LAUNCHES
    if k < 1:
        raise ValueError(f"k must be at least 1, got {k}")
    device, b = state.device, state.shape[-1]
    check_step_inputs(cfg, weights, poses, state, params, actions,
                      step_count, timers, ep_return, ep_len, action_k=k)
    check_rows("uniforms", uniforms, NUM_UNIFORM * k, b, device)
    check_rows("normals", normals, OBS_ROWS * k, b, device)
    if device.type == "cpu":
        return multi_step_rows(weights, poses, state, params, actions,
                               uniforms, normals, step_count, timers,
                               ep_return, ep_len, cfg, k)
    f32, i32 = torch.float32, torch.int32
    outs = (torch.empty_like(state),
            torch.empty((1, b), dtype=i32, device=device),
            torch.empty((cfg.n_push, b), dtype=i32, device=device),
            torch.empty((1, b), dtype=f32, device=device),
            torch.empty((1, b), dtype=i32, device=device))
    ins = (weights, poses, state, params, actions, uniforms, normals,
           step_count, timers, ep_return, ep_len)
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = _kernel_fn()(cfg.c_struct, *(x.data_ptr() for x in ins + outs),
                           b, k, stream)
    if err != 0:
        raise RuntimeError(f"multi_step kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES += 1
    return outs
