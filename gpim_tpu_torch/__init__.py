"""
gpim_tpu_torch
==============

PyTorch/CUDA port of ``gpim_tpu`` for one NVIDIA H100 (Hopper). The JAX
package is the reference; this package carries its five public names:

- ``utils``          : NaN-masked grid preparation (numpy) and plotting
- ``reconstructor``  : exact and inducing-point (VFE, ``sparse=True``) GP
                       regression of 2D images / 3D grids, and its
                       exploration ``step()``
- ``skreconstructor``: structured-kernel GP regression of 2D-4D grids: the
                       dense exact route, the spectral mixture kernel,
                       exact Kronecker inference on full grids, and SKI on
                       NaN-masked lattices and on points off a lattice
- ``vreconstructor`` : multi-output GP regression (independent "parallel"
                       channels, or the correlated Kronecker multitask model)
- ``boptimizer``     : GP-based Bayesian optimisation of the next
                       measurement point(s) on a grid

``gpim_tpu_torch.parallel`` is the parallel layer: ``mesh=`` on every
model shards its work over the ranks of a ``torch.distributed`` world, one
process a card (``torchrun --nproc-per-node=N``).

``gpim_tpu_torch.examples`` holds the six example workflows as runners
(``python -m gpim_tpu_torch.examples.sparse_image_2d``; ``--cpu`` for the
CPU). Plotting (``utils.plot_*``) needs matplotlib, which is imported on
the first use of a plot function and never by ``import gpim_tpu_torch``.

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

from gpim_tpu_torch import parallel, utils  # noqa: E402,F401
from gpim_tpu_torch.gpreg.gpr import reconstructor  # noqa: E402
from gpim_tpu_torch.gpreg.skgpr import skreconstructor  # noqa: E402
from gpim_tpu_torch.gpreg.vgpr import vreconstructor  # noqa: E402
from gpim_tpu_torch.gpbayes.boptim import boptimizer  # noqa: E402

__version__ = "0.1.0"

__all__ = ["utils", "reconstructor", "skreconstructor", "vreconstructor",
           "boptimizer"]
