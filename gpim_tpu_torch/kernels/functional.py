"""
Stationary covariance functions ``k(params, X1, X2)`` on tensors
(counterpart of ``gpim_tpu/kernels/functional.py``).

``params`` holds *constrained* values: 'lengthscale' (d,) or (1,),
'variance' (), and 'alpha' () for RationalQuadratic. The spectral mixture
kernel comes with the structured-kernel slice of the port.
"""

import math

import torch

from gpim_tpu_torch.ops.gram import pairwise_dist, pairwise_sq_dist

__all__ = [
    "rbf", "matern52", "rational_quadratic", "get_kernel_fn", "kernel_diag",
    "KERNELS",
]

_SQRT5 = math.sqrt(5.0)


def rbf(params, X1, X2):
    r"""k(x, x') = \sigma^2 exp(-0.5 ||(x - x') / l||^2)."""
    ls = params["lengthscale"]
    d2 = pairwise_sq_dist(X1 / ls, X2 / ls)
    return params["variance"] * torch.exp(-0.5 * d2)


def matern52(params, X1, X2):
    r"""Matern-5/2: \sigma^2 (1 + sqrt5 r + 5 r^2/3) exp(-sqrt5 r)."""
    ls = params["lengthscale"]
    r = pairwise_dist(X1 / ls, X2 / ls)
    poly = 1.0 + _SQRT5 * r + (5.0 / 3.0) * r * r
    return params["variance"] * poly * torch.exp(-_SQRT5 * r)


def rational_quadratic(params, X1, X2):
    r"""RQ: \sigma^2 (1 + r^2 / (2 \alpha))^{-\alpha} with trainable alpha."""
    ls = params["lengthscale"]
    alpha = params["alpha"]
    d2 = pairwise_sq_dist(X1 / ls, X2 / ls)
    return params["variance"] * (1.0 + d2 / (2.0 * alpha)) ** (-alpha)


KERNELS = {
    "RBF": rbf,
    "Matern52": matern52,
    "RationalQuadratic": rational_quadratic,
}


def get_kernel_fn(kernel_type):
    """Look up a kernel function by the reference's string names."""
    if kernel_type == "Spectral":
        raise NotImplementedError(
            "the Spectral kernel is not ported yet; it comes with the "
            "structured-kernel (skgpr) slice")
    try:
        return KERNELS[kernel_type]
    except KeyError:
        raise NotImplementedError(
            "Select one of the currently available kernels: " +
            ", ".join(sorted(KERNELS))) from None


def kernel_diag(kernel_type, params, X):
    """diag(k(X, X)) without forming the Gram matrix."""
    get_kernel_fn(kernel_type)
    return params["variance"].expand(X.shape[0])
