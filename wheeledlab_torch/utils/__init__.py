"""Utilities of the port: configs (`config`), the device rule (`device`),
division as the reference rounds it (`math`) and profiling (`profiling`).

The JAX package's other four utilities have no counterpart, each by
decision:

- `utils/aot.py` (serialized XLA executables of the train iteration): the
  port compiles nothing per run but its kernels, and those are cached.
- `utils/cache.py` (the persistent XLA compilation cache): the nvcc build
  cache in `wheeledlab_torch/_build/`, keyed by a hash of `csrc/` and the
  flags (`ops/build.py`), does its job.
- `utils/host.py` (build-time arrays kept as numpy so jitted closures embed
  constants): eager PyTorch captures nothing; task builders place their
  tables on the env's device once.
- `utils/rng.py` (the TPU's `rbg` PRNG): PyTorch's generators are Philox on
  CUDA already; `TrainCfg.fast_prng` stays an ignored field.
"""
