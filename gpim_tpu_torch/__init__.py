"""
gpim_tpu_torch
==============

PyTorch/CUDA port of ``gpim_tpu`` for one NVIDIA H100 (Hopper). The JAX
package is the reference; this package carries its exact and sparse (VFE)
reconstruction paths and its Bayesian-optimisation loop end to end:

- ``utils``         : NaN-masked grid preparation (numpy)
- ``reconstructor`` : exact and inducing-point (VFE, ``sparse=True``) GP
                      regression of 2D images / 3D grids, and its
                      exploration ``step()``
- ``boptimizer``    : GP-based Bayesian optimisation of the next
                      measurement point(s) on a grid

Plain tensor code is PyTorch; the three kernels that ``gpim_tpu`` wrote in
Pallas are hand-written CUDA for Hopper (``gpim_tpu_torch/csrc``), each
beside its plain PyTorch version (``gpim_tpu_torch.ops.gram_kernels``).
"""

import torch as _torch

# GP numerics need true float32 products: TF32 operands keep ~3 decimal
# digits, collapse the distances between neighbouring grid points and make
# Gram matrices singular (the counterpart of gpim_tpu's
# jax_default_matmul_precision=highest).
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")

from gpim_tpu_torch import utils  # noqa: E402
from gpim_tpu_torch.gpreg.gpr import reconstructor  # noqa: E402
from gpim_tpu_torch.gpbayes.boptim import boptimizer  # noqa: E402

__version__ = "0.1.0"

__all__ = ["utils", "reconstructor", "boptimizer"]
