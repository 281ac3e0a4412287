"""The drift kernels' in-kernel random generator: Philox4x32-10, the
reference's bit extraction and Box-Muller.

The Pallas TPU kernel `wheeledlab_tpu/tasks/drift/fused.py::_kernel_krng`
draws its per-step random rows from the TPU's hardware generator, seeded per
(seed, grid block). The port draws them from the counter-based Philox4x32-10
(Salmon et al., SC'11), so that a draw depends only on (seed, env index, draw
index) and never on the block size or the batch:

- key = (seed as uint32, `KEY1`), counter = (env index b, call index q, 0, 0);
  draw j is word j % 4 of call q = j // 4;
- draw order, as the reference slices its bits (`fused.py:428-432`): j 0-11
  the 12 uniform rows, 12-25 `u1` of the 14 normal rows, 26-39 `u2` of the 14
  normal rows;
- uniform = ((word >> 7) & 0xFFFFFF) * 2^-24; normal = sqrt(-2 log max(u1,
  1e-7)) * cos(2 pi u2).

Three pieces, as for every kernel of the port:

- `philox_blocks`: the plain PyTorch version, on int64 tensors masked to 32
  bits. It is the CPU path and the oracle of both kernels that draw these
  rows (`csrc/rng_blocks.cu`, `csrc/fused_drift_krng.cu`): the words agree bit
  for bit.
- `rng_blocks`: the wrapper of `csrc/rng_blocks.cu`, which replaces the
  Pallas kernel of `scripts/check_kernel_rng.py` (`run` / `_kern`). CPU seeds
  run `philox_blocks`; CUDA seeds launch the kernel or raise. It counts its
  launches in `LAUNCHES`.
- `philox4x32_10`: the generator itself, for the known-answer tests.
"""

from __future__ import annotations

import ctypes
import functools

import torch

M0, M1 = 0xD2511F53, 0xCD9E8D57          # round multipliers
W0, W1 = 0x9E3779B9, 0xBB67AE85          # key increments
KEY1 = 0x574C5247                        # second key word of every stream
MASK = 0xFFFFFFFF
NUM_UNIFORM = 12
NUM_NORMAL = 14
TWO_PI = 6.2831855                       # float32(2 pi)

# Kernel launches made by `rng_blocks` (CUDA tensors only).
LAUNCHES = 0


def philox4x32_10(counter, key):
    """Philox4x32-10 on int64 tensors holding uint32 values: `counter` a
    sequence of 4 broadcastable tensors, `key` of 2. Returns the 4 output
    words. int64 products wrap and `>>` is arithmetic, so every word is
    masked after the shift."""
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for _ in range(10):
        p0, p1 = c0 * M0, c2 * M1
        hi0, lo0 = (p0 >> 32) & MASK, p0 & MASK
        hi1, lo1 = (p1 >> 32) & MASK, p1 & MASK
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + W0) & MASK, (k1 + W1) & MASK
    return c0, c1, c2, c3


def philox_words(seed: torch.Tensor, b: int, draws: int) -> torch.Tensor:
    """(draws, B) int64 words: draw j of env b under `seed`, a (1,) int32
    tensor whose device the result lives on."""
    dev = seed.device
    calls = -(-draws // 4)
    env = torch.arange(b, dtype=torch.int64, device=dev)[None, :]
    q = torch.arange(calls, dtype=torch.int64, device=dev)[:, None]
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    k0 = seed.to(torch.int64) & MASK                       # (1,)
    k1 = torch.full((), KEY1, dtype=torch.int64, device=dev)
    words = philox4x32_10((env, q, zero, zero), (k0, k1))  # 4 x (calls, B)
    # word w of call q is draw 4 q + w
    return torch.stack(words, 1).reshape(4 * calls, b)[:draws]


def bits_to_uniform(words: torch.Tensor) -> torch.Tensor:
    """The reference's extraction: 24 bits of each word -> float32 in
    [0, 1), exactly."""
    return ((words >> 7) & 0x00FFFFFF).to(torch.float32) * (1.0 / (1 << 24))


def box_muller(u1: torch.Tensor, u2: torch.Tensor) -> torch.Tensor:
    return (torch.sqrt(-2.0 * torch.log(torch.clamp(u1, min=1e-7)))
            * torch.cos(TWO_PI * u2))


def philox_blocks(seed: torch.Tensor, b: int, noise: bool = True):
    """The random rows of one control step of `b` envs under `seed` ((1,)
    int32): (uniforms (12, B), normals (14, B)) float32 on the seed's device.
    With `noise` off only the 12 uniform draws exist and the normals are 0,
    as in the reference. The plain PyTorch version of the kernels' draws."""
    draws = NUM_UNIFORM + (2 * NUM_NORMAL if noise else 0)
    u = bits_to_uniform(philox_words(seed, b, draws))
    uniforms = u[:NUM_UNIFORM].contiguous()
    if not noise:
        return uniforms, torch.zeros((NUM_NORMAL, b), device=seed.device)
    normals = box_muller(u[NUM_UNIFORM:NUM_UNIFORM + NUM_NORMAL],
                         u[NUM_UNIFORM + NUM_NORMAL:])
    return uniforms, normals.contiguous()


def check_seed(seed: torch.Tensor):
    if seed.dtype != torch.int32 or tuple(seed.shape) != (1,):
        raise TypeError(f"seed must be a (1,) int32 tensor, got "
                        f"{tuple(seed.shape)} {seed.dtype}")


@functools.lru_cache(maxsize=None)
def _kernel_fn():
    """The ctypes launcher, built and loaded on first use."""
    from .build import load_library

    fn = load_library("rng_blocks").rng_blocks_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def rng_blocks(seed: torch.Tensor, b: int):
    """(uniforms (12, B), normals (14, B)) for `seed`, a (1,) int32 tensor:
    the rows the in-kernel-RNG drift step draws for the same seed. A CPU seed
    runs `philox_blocks`; a CUDA seed launches the kernel, asynchronously on
    the current stream."""
    global LAUNCHES
    check_seed(seed)
    device = seed.device
    if device.type == "cpu":
        return philox_blocks(seed, b)
    if device.type != "cuda":
        raise ValueError(f"rng_blocks runs on cpu or cuda, not {device}")
    uniforms = torch.empty((NUM_UNIFORM, b), dtype=torch.float32,
                           device=device)
    normals = torch.empty((NUM_NORMAL, b), dtype=torch.float32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = _kernel_fn()(seed.data_ptr(), uniforms.data_ptr(),
                           normals.data_ptr(), b, stream)
    if err != 0:
        raise RuntimeError(f"rng_blocks kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES += 1
    return uniforms, normals
