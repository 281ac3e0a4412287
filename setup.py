from setuptools import find_packages, setup

setup(
    name="wheeledlab-tpu",
    version="0.1.0",
    description="TPU-native wheeled-robot RL framework (WheeledLab capabilities on JAX)",
    packages=find_packages(include=["wheeledlab_tpu*", "wheeledlab_torch*"]),
    package_data={"wheeledlab_torch": ["csrc/*.cu", "csrc/*.cuh"]},
    python_requires=">=3.10",
    install_requires=["jax", "flax", "optax", "orbax-checkpoint", "numpy"],
)
