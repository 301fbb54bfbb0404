"""
Explicit inverse of a lower-triangular factor (counterpart of
``gpim_tpu/ops/tri.py``).

The JAX package splits the inverse into a batched bisection because XLA's
triangular solve is a sequential chain on the TPU. On the GPU this is one
cuBLAS/cuSOLVER triangular solve against the identity; whether another
formulation is faster there is a measurement still to be made.
"""

import torch

__all__ = ["tri_inverse"]


def tri_inverse(L):
    """Inverse of a lower-triangular matrix: ``solve_triangular(L, I)``."""
    eye = torch.eye(L.shape[-1], dtype=L.dtype, device=L.device)
    return torch.linalg.solve_triangular(L, eye, upper=False)
