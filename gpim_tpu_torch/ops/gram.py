"""
Gram-matrix building blocks (counterpart of ``gpim_tpu/ops/gram.py``).

A CUDA tensor goes to kernel K1 (:func:`.gram_kernels.sqdist`): one pass
over the output, exact zeros at coincident points by construction. A CPU tensor takes the centred norm-trick expansion of the
JAX package's XLA path, round-off snap included, so the CPU tests compare
like with like.
"""

import torch

from gpim_tpu_torch.ops import gram_kernels

__all__ = ["pairwise_sq_dist", "pairwise_dist"]


def pairwise_sq_dist(X1, X2):
    """Pairwise squared Euclidean distances between rows of X1 and X2.

    On the CPU: the |a|^2 + |b|^2 - 2ab expansion with mean-centering
    (grid coordinates can be O(100) while relevant distances are O(1)),
    and distances below the expansion's round-off floor snapped to exactly
    zero, so coincident points give d2 = 0 and k(x, x) = v
    (gpim_tpu/ops/gram.py:33-50).
    """
    if X1.is_cuda:
        return gram_kernels.sqdist(X1, X2)
    center = X1.mean(dim=0, keepdim=True)
    a = X1 - center
    b = X2 - center
    aa = (a * a).sum(dim=-1)
    bb = (b * b).sum(dim=-1)
    d2 = aa[:, None] + bb[None, :] - 2.0 * (a @ b.T)
    eps = torch.finfo(d2.dtype).eps
    floor = 8.0 * eps * (aa.max() + bb.max() + 1.0)
    d2 = torch.where(d2 < floor, torch.zeros_like(d2), d2)
    return d2.clamp_min(0.0)


def pairwise_dist(X1, X2, eps=1e-12):
    """Pairwise Euclidean distance with a smooth-at-zero gradient."""
    return torch.sqrt(pairwise_sq_dist(X1, X2) + eps)
