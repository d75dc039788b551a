"""Packaging (capability parity with reference setup.py:1-12)."""

from setuptools import find_packages, setup

setup(
    name="ray_lightning_accelerators_tpu",
    packages=find_packages(include=["ray_lightning_accelerators_tpu",
                                    "ray_lightning_accelerators_tpu.*",
                                    "ray_lightning_accelerators_tpu_torch",
                                    "ray_lightning_accelerators_tpu_torch.*"]),
    # the PyTorch/CUDA port builds its kernels and its shm store from
    # these at first use
    package_data={"ray_lightning_accelerators_tpu_torch": ["csrc/*.cu",
                                                           "csrc/*.cuh",
                                                           "native/*.cc"]},
    version="0.1.0",
    description="TPU-native distributed training accelerators with a "
                "Lightning-shaped trainer, mesh parallelism, and a Tune-style "
                "hyperparameter search subsystem",
    python_requires=">=3.10",
    install_requires=["jax", "flax", "optax", "numpy"],
    entry_points={
        "console_scripts": [
            "rla-tpu=ray_lightning_accelerators_tpu.cli:main",
            "rla-tpu-torch=ray_lightning_accelerators_tpu_torch.cli:main"],
    },
)
