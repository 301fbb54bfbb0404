"""
Small shared linear-algebra helpers (counterpart of
``gpim_tpu/ops/linalg.py``).

The JAX package pins the Cholesky operand behind an optimization barrier to
dodge an XLA:CPU miscompile; PyTorch runs eagerly and needs none.
"""

import torch

__all__ = ["safe_cholesky", "solve_triangular", "sym_syrk"]


def safe_cholesky(A):
    """Lower Cholesky factor without a host sync: returns ``(L, info)``.

    ``info`` is a device int tensor, 0 on success and otherwise the order of
    the leading minor that is not positive definite. Callers collect it on
    the device and check it once, where they sync anyway, instead of
    stalling every call.
    """
    return torch.linalg.cholesky_ex(A)


def solve_triangular(L, b, *, lower=True):
    """``jax.scipy.linalg.solve_triangular(L, b, lower=lower)``: a 1-D
    right-hand side is solved as one column and comes back 1-D."""
    if b.dim() == 1:
        return torch.linalg.solve_triangular(L, b[:, None],
                                             upper=not lower)[:, 0]
    return torch.linalg.solve_triangular(L, b, upper=not lower)


class _SymSyrk(torch.autograd.Function):
    @staticmethod
    def forward(ctx, M):
        ctx.save_for_backward(M)
        return M @ M.T

    @staticmethod
    def backward(ctx, dQ):
        (M,) = ctx.saved_tensors
        return (dQ + dQ.T) @ M


def sym_syrk(M):
    """``M @ M.T`` with a one-gemm backward.

    Autograd of ``M @ M.T`` runs two (m, n)-wide cotangent gemms
    (``dQ @ M`` and ``dQ.T @ M``); their sum is ``(dQ + dQ.T) @ M``, so the
    backward symmetrises the small (m, m) cotangent first and runs one.
    """
    return _SymSyrk.apply(M)
