"""
Structured-kernel-interpolation building blocks (counterpart of
``gpim_tpu/ops/ski.py``). Only the per-dimension grid kernel factors are
ported so far, which the exact Kronecker engine
(:mod:`gpim_tpu_torch.gpreg.kron_model`) builds every step; the
interpolation operator, CG, SLQ, Lanczos and the Nystrom variance come with
the masked-lattice and off-lattice SKI routes.
"""

import torch

from gpim_tpu_torch.kernels.functional import get_kernel_fn

__all__ = ["grid_kernel_factors"]


def grid_kernel_factors(kernel, p, grids):
    """Dense 1D kernel factors K_k (G_k, G_k), one per grid axis; the output
    variance multiplies the first factor (product form per dimension,
    gpim_tpu/ops/ski.py:137-160). On a CUDA tensor each factor's distances
    are one K1 launch at (G_k, 1) x (G_k, 1).

    ``gpim_tpu`` pins the factors behind an ``optimization_barrier`` against
    a TPU miscompile of the fused factor build; eager PyTorch fuses nothing
    and needs none.
    """
    kfn = get_kernel_fn(kernel)
    d = len(grids)
    ls = torch.broadcast_to(p["lengthscale"], (d,))
    factors = []
    for k, g in enumerate(grids):
        pk = {"lengthscale": ls[k][None],
              "variance": p["variance"] if k == 0 else 1.0}
        if "alpha" in p:
            pk["alpha"] = p["alpha"]
        factors.append(kfn(pk, g[:, None], g[:, None]))
    return factors
