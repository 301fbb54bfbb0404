"""Packaging for gpim_tpu (reference packaging: /root/reference/setup.py).

The optional native helper (gpim_tpu/native/_spatial.so) is built on demand
by gpim_tpu/native/build.sh; the library falls back to numpy without it.

gpim_tpu_torch, the PyTorch/CUDA port, ships beside it with its CUDA source
(gpim_tpu_torch/csrc/*.cu, compiled by nvcc at first use on a CUDA
machine). The port needs torch, which the "torch" extra names; the install
requirements stay those of gpim_tpu.
"""

import os
import subprocess

from setuptools import find_packages, setup
from setuptools.command.build_py import build_py


class BuildWithNative(build_py):
    """Best-effort native build; the package works without it."""

    def run(self):
        here = os.path.dirname(os.path.abspath(__file__))
        script = os.path.join(here, "gpim_tpu", "native", "build.sh")
        try:
            subprocess.run(["sh", script], check=True, capture_output=True)
        except Exception:
            pass
        super().run()


setup(
    name="gpim_tpu",
    version="0.1.0",
    description=("TPU-native Gaussian process framework for sparse "
                 "scientific image and hyperspectral data analysis "
                 "and GP-based Bayesian optimization"),
    long_description=open("README.md").read(),
    long_description_content_type="text/markdown",
    packages=find_packages(exclude=("tests",)),
    package_data={"gpim_tpu.native": ["*.cpp", "build.sh"],
                  "gpim_tpu_torch": ["csrc/*.cu",
                                     "examples/notebooks/*.ipynb"]},
    python_requires=">=3.10",
    install_requires=[
        "jax>=0.4.30",
        "optax>=0.2",
        "numpy>=1.24",
        "scipy>=1.10",
        "matplotlib>=3.5",
    ],
    extras_require={"torch": ["torch>=2.1"]},
    cmdclass={"build_py": BuildWithNative},
    license="MIT",
    classifiers=[
        "Programming Language :: Python :: 3",
        "License :: OSI Approved :: MIT License",
        "Topic :: Scientific/Engineering :: Image Processing",
    ],
)
