"""
Constraint bijectors for GP hyperparameters (counterpart of
``gpim_tpu/kernels/transforms.py``).

Training happens in unconstrained space; the interval transform's
log-Jacobian is the MAP prior term of the objective. Softplus is
``logaddexp(u, 0)``, as ``jax.nn.softplus`` is: ``F.softplus`` switches to
the identity above a threshold of 20, which changes the value slightly.
"""

import torch
import torch.nn.functional as F

__all__ = [
    "interval_forward", "interval_inverse", "interval_log_jacobian",
    "positive_forward", "positive_inverse",
]


def interval_forward(u, lo, hi):
    """Unconstrained -> (lo, hi) via scaled sigmoid."""
    return lo + (hi - lo) * torch.sigmoid(u)


def interval_inverse(x, lo, hi, eps=1e-12):
    """(lo, hi) -> unconstrained (logit), clipping to the open interval."""
    t = (x - lo) / (hi - lo)
    t = torch.clamp(t, eps, 1.0 - 1e-7)
    return torch.log(t) - torch.log1p(-t)


def interval_log_jacobian(u, lo, hi):
    """log |d interval_forward / du| summed over elements."""
    # log sigmoid(u) + log sigmoid(-u) is the stable log s(u)(1-s(u)).
    return torch.sum(torch.log(hi - lo) + F.logsigmoid(u) + F.logsigmoid(-u))


def positive_forward(u):
    """Unconstrained -> (0, inf) via softplus."""
    return torch.logaddexp(u, torch.zeros_like(u))


def positive_inverse(x):
    """Stable inverse softplus: log(exp(x) - 1)."""
    return x + torch.log(-torch.expm1(-x))
