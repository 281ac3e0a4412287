"""Heightfield physics control step — kernel K3.

Port of `wheeledlab_tpu/ops/pallas_substep_hf.py::pallas_step_hf`:
`decimation` rough-terrain substeps on the packed (rows, B) layout, with
each env's (p, p) terrain patch resident. Two pieces:

- `physics_step_hf_rows`: the plain PyTorch version, the `sim/soa_hf.py::
  substep_soa_hf` loop. It is the CPU path and the kernel's oracle.
- `physics_step_hf`: the wrapper. CPU tensors run `physics_step_hf_rows`;
  CUDA tensors launch the kernel of `csrc/physics_step_hf.cu` (built at
  first use) or raise. It counts its kernel launches in `LAUNCHES`.

The kernel gives an env to 4 lanes (a wheel a lane) and keeps a block's
patches in shared memory (`shared_bytes`, `patch_pitch`). Patch extraction
(`PatchAtlas.extract_rows`) stays outside, in plain PyTorch, as it stays in
XLA outside the reference's Pallas call. See `csrc/physics_step_hf.cu` for
the kernel's bound and design.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..sim.soa import NUM_PARAM, NUM_STATE
from ..sim.soa_hf import substep_soa_hf
from .checks import check_rows

# Kernel launches made by `physics_step_hf` (CUDA tensors only).
LAUNCHES = 0
# Envs of one block of the kernel (`kEnvsPerBlock` in csrc/substep.cuh).
ENVS_PER_BLOCK = 32
# The kernel keeps its block's patches in shared memory (`shared_bytes`), at
# most the 227 KB a block may opt in to (`kMaxSharedBytes`).
MAX_SHARED_BYTES = 232448


def patch_pitch(p: int) -> int:
    """Row pitch of a (p, p) patch in the kernel's shared memory: the
    smallest pitch >= p that is 2 modulo 4, so that the four cells of a
    2 x 2 block fall into four different groups of banks. Mirror of
    `patch_pitch` in csrc/substep_hf.cuh."""
    return p + ((2 - p) & 3)


def shared_bytes(p: int) -> int:
    """Shared memory of one block of the kernel: its envs' patches, a
    region a warp, cell (ix, iy) of env e of the warp at word
    (ix * pitch + iy) * 8 + e of the region. Mirror of `patch_words` in
    csrc/physics_step_hf.cu, in bytes."""
    return p * patch_pitch(p) * ENVS_PER_BLOCK * 4


# The largest patch side whose block fits: 42 (225,792 bytes).
MAX_P = max(p for p in range(2, 64) if shared_bytes(p) <= MAX_SHARED_BYTES)


class HfConstsC(ctypes.Structure):
    """Mirror of `struct HfConsts` in csrc/substep_hf.cuh (same field order
    and types)."""

    _fields_ = [
        ("dt", ctypes.c_float), ("dt2", ctypes.c_float),
        ("half_dt", ctypes.c_float), ("decimation", ctypes.c_int),
        ("p", ctypes.c_int), ("cell", ctypes.c_float),
        ("half_nx", ctypes.c_float), ("half_ny", ctypes.c_float),
        ("uv_max", ctypes.c_float),
    ]


@functools.lru_cache(maxsize=None)
def hf_consts(dt: float, decimation: int, p: int, nx: int, ny: int,
              cell: float) -> HfConstsC:
    """The kernel's constant block: every value the plain version computes
    in Python (double) and applies to float32 tensors, rounded to float32
    once here."""
    f = lambda x: float(np.float32(x))
    return HfConstsC(dt=f(dt), dt2=f(dt * dt), half_dt=f(0.5 * dt),
                     decimation=int(decimation), p=int(p), cell=f(cell),
                     half_nx=f((nx - 1) / 2.0), half_ny=f((ny - 1) / 2.0),
                     uv_max=f(p - 1.001))


def physics_step_hf_rows(state, params, patch, org, steer_t, wheel_t, *,
                         dt: float, decimation: int, p: int, nx: int,
                         ny: int, cell: float) -> torch.Tensor:
    """`decimation` x `substep_soa_hf`: (NUM_STATE, B) -> (NUM_STATE, B)."""
    for _ in range(decimation):
        state = substep_soa_hf(state, params, patch, org, steer_t, wheel_t,
                               dt, p=p, nx=nx, ny=ny, cell=cell)
    return state


@functools.lru_cache(maxsize=None)
def _kernel_fn():
    """The ctypes launcher, built and loaded on first use."""
    from .build import load_library

    fn = load_library("physics_step_hf").physics_step_hf_launch
    fn.argtypes = ([HfConstsC] + [ctypes.c_void_p] * 7
                   + [ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def physics_step_hf(state, params, patch, org, steer_t, wheel_t, *,
                    dt: float, decimation: int, p: int, nx: int, ny: int,
                    cell: float) -> torch.Tensor:
    """One heightfield control step, the counterpart of the reference
    `pallas_step_hf`: state (21, B), params (46, B), patch (p*p, B), org
    (2, B), steer_t (2, B), wheel_t (4, B) f32, contiguous -> new state
    (21, B). `nx`, `ny` are the terrain grid's shape and `cell` its
    spacing. CPU tensors run the plain version; CUDA tensors launch the
    kernel, asynchronously on the current stream."""
    global LAUNCHES
    device = state.device
    b = state.shape[-1]
    for name, x, rows in (("state", state, NUM_STATE),
                          ("params", params, NUM_PARAM),
                          ("patch", patch, p * p), ("org", org, 2),
                          ("steer_t", steer_t, 2), ("wheel_t", wheel_t, 4)):
        check_rows(name, x, rows, b, device)
    if p < 2 or shared_bytes(p) > MAX_SHARED_BYTES:
        raise ValueError(
            f"patch side {p} outside [2, {MAX_P}]: a block's patches must "
            f"fit {MAX_SHARED_BYTES} bytes of shared memory")
    if device.type == "cpu":
        return physics_step_hf_rows(
            state, params, patch, org, steer_t, wheel_t, dt=dt,
            decimation=decimation, p=p, nx=nx, ny=ny, cell=cell)
    if device.type != "cuda":
        raise ValueError(f"physics_step_hf runs on cpu or cuda, not {device}")

    out = torch.empty_like(state)
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = _kernel_fn()(
            hf_consts(dt, decimation, p, nx, ny, cell), state.data_ptr(),
            params.data_ptr(), patch.data_ptr(), org.data_ptr(),
            steer_t.data_ptr(), wheel_t.data_ptr(), out.data_ptr(), b,
            stream)
    if err != 0:
        raise RuntimeError(f"physics_step_hf kernel launch failed: CUDA "
                           f"error {err}")
    LAUNCHES += 1
    return out
