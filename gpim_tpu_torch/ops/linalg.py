"""
Small shared linear-algebra helpers (counterpart of
``gpim_tpu/ops/linalg.py``).

The JAX package pins the Cholesky operand behind an optimization barrier to
dodge an XLA:CPU miscompile; PyTorch runs eagerly and needs none.
"""

import torch

__all__ = ["safe_cholesky"]


def safe_cholesky(A):
    """Lower Cholesky factor without a host sync: returns ``(L, info)``.

    ``info`` is a device int tensor, 0 on success and otherwise the order of
    the leading minor that is not positive definite. Callers collect it on
    the device and check it once, where they sync anyway, instead of
    stalling every call.
    """
    return torch.linalg.cholesky_ex(A)
