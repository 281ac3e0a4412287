"""WheeledLab on PyTorch and CUDA: the port of `wheeledlab_tpu` (the JAX/TPU
reference package beside it). Each Pallas TPU kernel of the reference
becomes a CUDA C++ kernel for Hopper, built from `csrc/` at first use."""

__version__ = "0.1.0"
