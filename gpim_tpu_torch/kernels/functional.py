"""
Stationary covariance functions ``k(params, X1, X2)`` on tensors
(counterpart of ``gpim_tpu/kernels/functional.py``).

``params`` holds *constrained* values: 'lengthscale' (d,) or (1,),
'variance' (), and 'alpha' () for RationalQuadratic. With a leading task
axis (the multi-output GP's per-channel hyperparameters, which
``gpim_tpu`` vmaps), 'lengthscale' is (T, 1, d) or (T, 1, 1) and
'variance' (T, 1, 1): the inputs scale to (T, n, d), the Gram matrix is
(T, n, m) and :func:`kernel_diag` (T, n). The spectral mixture takes
'weights' (Q,), 'means' (Q, d) and 'scales' (Q, d), and no task axis.
"""

import math

import torch

from gpim_tpu_torch.ops.gram import pairwise_dist, pairwise_sq_dist

__all__ = [
    "rbf", "matern52", "rational_quadratic", "spectral_mixture",
    "get_kernel_fn", "kernel_diag", "KERNELS",
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


def spectral_mixture(params, X1, X2):
    r"""Spectral mixture (Wilson & Adams):

    k(tau) = sum_q w_q prod_d exp(-2 pi^2 tau_d^2 s_{qd}^2) cos(2 pi m_{qd} tau_d)

    with tau = x - x', mixture weights w, spectral means m and spectral
    standard deviations s (gpim_tpu/kernels/functional.py:55-76). No
    hand-written kernel: ``gpim_tpu`` has no Pallas counterpart, so the
    build stays elementwise PyTorch, differentiated by autograd. The
    product over d is written out: ``torch.prod``'s backward counts the
    zeros of its input and reads the count on the host, a sync per mixture
    component every step.
    """
    tau = X1[:, None, :] - X2[None, :, :]          # (n, m, d)
    two_pi = 2.0 * math.pi
    out = 0.0
    # Q is small (default 4); an unrolled sum keeps memory at one (n, m, d)
    # buffer instead of materializing (Q, n, m, d).
    for q in range(params["weights"].shape[0]):
        s = params["scales"][q]
        m = params["means"][q]
        exp_term = torch.exp(-2.0 * math.pi ** 2 * ((tau * s) ** 2).sum(-1))
        cos = torch.cos(two_pi * tau * m)
        cos_term = cos[..., 0]
        for k in range(1, cos.shape[-1]):
            cos_term = cos_term * cos[..., k]
        out = out + params["weights"][q] * exp_term * cos_term
    return out


KERNELS = {
    "RBF": rbf,
    "Matern52": matern52,
    "RationalQuadratic": rational_quadratic,
    "Spectral": spectral_mixture,
}


def get_kernel_fn(kernel_type):
    """Look up a kernel function by the reference's string names."""
    try:
        return KERNELS[kernel_type]
    except KeyError:
        raise NotImplementedError(
            "Select one of the currently available kernels: " +
            ", ".join(sorted(KERNELS))) from None


def kernel_diag(kernel_type, params, X):
    """diag(k(X, X)) without forming the Gram matrix: (n,), or (T, n) for a
    (T, 1, 1) variance; the spectral mixture's is the sum of its weights."""
    if get_kernel_fn(kernel_type) is spectral_mixture:
        return params["weights"].sum().expand(X.shape[-2])
    v = params["variance"]
    lead = v.shape[:-2] if v.dim() >= 2 else ()
    return v.reshape(lead + (1,)).expand(lead + (X.shape[-2],))
