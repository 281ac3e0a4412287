"""Build and load the port's CUDA kernels and its host C++ library.

Each kernel library is one `.cu` file of `wheeledlab_torch/csrc/` with a
plain C interface. It is compiled with nvcc for Hopper (`sm_90a`) at first
use into `wheeledlab_torch/_build/`, named by a hash of every source in
`csrc/` and of the flags, and loaded with `ctypes`. No PyTorch headers are
involved, so a build takes seconds; `build_all` runs one nvcc per source, in
parallel. `build_host` compiles a host C++ source (the native library,
`wheeledlab_torch/native/`) with the host's C++ compiler into the same
directory, named by a hash of the source and the flags.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from typing import Optional

CSRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                         "_build")
# Every kernel is built without FMA contraction, so that each equals its
# plain version bit for bit: with contraction a one-ulp difference is
# amplified where a step crosses a threshold. K3: a patch coordinate at a
# cell edge, or a penetration near 0, switches the terrain normal or the
# contact over ten stiff substeps (80 of 16384 envs disagreed, by up to 2.0,
# on an H100). K5a: 1 of 16384 F1Tenth envs left the tolerance after 4
# chained steps (a wheel rate near zero). K2: the visual task's 20 substeps
# a control step. K1: at 65536 envs, 1 or 2 envs beyond the tolerance on 5
# of 12 seeds (the slip metric's |body vx| >= 1 gate flipped, 113.7 deg
# against 0; a rear wheel's rate near zero). K4 and K5b draw the same rows
# as each other and K4 must equal K1 fed K5b's rows, so they are built as
# K1 is.
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]
SOURCES = ("fused_drift", "physics_step", "physics_step_hf",
           "fused_drift_krng", "multi_step", "rng_blocks")

# ptxas resource reports of the builds made in this process, by library
BUILD_LOGS = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: put it on PATH or set CUDA_HOME")
    return path


def library_path(name: str) -> str:
    """Where the build of `csrc/<name>.cu` for the current sources lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for fn in sorted(os.listdir(CSRC)):
        if fn.endswith((".cu", ".cuh")):
            with open(os.path.join(CSRC, fn), "rb") as f:
                h.update(fn.encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")


def build_all(names=SOURCES) -> dict:
    """Compile `csrc/<name>.cu` for each name whose build for these sources
    does not exist, one nvcc process per source, all started together;
    returns {name: library path}."""
    outs = {name: library_path(name) for name in names}
    jobs = []
    try:
        for name, out in outs.items():
            if os.path.exists(out):
                continue
            os.makedirs(BUILD_DIR, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            proc = subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", tmp,
                 os.path.join(CSRC, f"{name}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            jobs.append((name, proc, tmp))
        for name, proc, tmp in jobs:
            _, stderr = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {name}.cu:\n{stderr}")
            BUILD_LOGS[name] = stderr
            os.replace(tmp, outs[name])   # atomic: concurrent builds race
    finally:
        for _, proc, tmp in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.remove(tmp)
    return outs


def build(name: str) -> str:
    """Compile `csrc/<name>.cu` unless the build for these sources exists;
    returns the library path."""
    return build_all([name])[name]


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load `csrc/<name>.cu` once per process."""
    return ctypes.CDLL(build(name))


HOST_CXX = ("c++", "g++", "clang++")
HOST_CXX_FLAGS = ["-O2", "-shared", "-fPIC", "-std=c++17"]


def host_library_path(src: str) -> str:
    """Where the build of the host C++ source `src` lives."""
    h = hashlib.sha256(" ".join(HOST_CXX_FLAGS).encode())
    with open(src, "rb") as f:
        h.update(f.read())
    stem = os.path.splitext(os.path.basename(src))[0]
    return os.path.join(BUILD_DIR, f"{stem}-{h.hexdigest()[:16]}.so")


def build_host(src: str) -> Optional[str]:
    """Compile the host C++ source `src` into a shared library with the
    first of `HOST_CXX` that succeeds, unless its build exists; returns the
    library path, or None when no compiler builds it. The build goes to a
    temporary file renamed into place, so concurrent processes never load
    a half-written library."""
    out = host_library_path(src)
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        for cxx in HOST_CXX:
            try:
                subprocess.run([cxx, *HOST_CXX_FLAGS, "-o", tmp, src],
                               check=True, capture_output=True, timeout=120)
            except (OSError, subprocess.CalledProcessError,
                    subprocess.TimeoutExpired):
                continue
            os.replace(tmp, out)
            return out
        return None
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
