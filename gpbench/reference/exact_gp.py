"""
Plain exact GP regression and Bayesian optimisation: the benchmark's
reference for the ``exact_rbf`` configuration.

Written from the model's equations, in plain PyTorch, for any dtype and
device; the benchmark runs it in float64. It imports nothing of the program
under test and takes nothing the program made: it reads the scan (a grid
with NaN at the pixels not measured) and derives the training rows, the
hyperparameters' bounds and initial values, and every Gram matrix itself.

Model (GPim's ``reconstructor``, RBF kernel):

    k(x, x') = v exp(-0.5 |(x - x') / l|^2),  one lengthscale per axis
    A = K(X, X) + (noise + jitter) I
    NLL = 0.5 y^T A^-1 y + sum log diag chol(A) + n/2 log 2 pi

trained by Adam (lr, b1 0.9, b2 0.999, eps 1e-8, moments new each training
call) in unconstrained coordinates: l = lo + (hi - lo) sigmoid(u) with
lo = 0 and hi = mean(grid shape) / 2, v = 1e-4 + (10 - 1e-4) sigmoid(u),
noise = softplus(u). The objective adds minus the log-Jacobian of the two
interval maps (a uniform prior on l and v). Initial values: l at a tenth of
its interval, v = 1, noise = 1. The gradient is autograd's through the
Cholesky factor. Prediction: mean K*^T A^-1 y and variance
v - diag(K*^T A^-1 K*) + noise.

Bayesian optimisation (GPim's ``boptimizer`` with EI): each step retrains
from the previous step's parameters (the first step ``iterations``, later
steps ``refit`` Adam steps), predicts the grid, and takes expected
improvement over the best predicted mean at the measured pixels,
xi = 0.01; the next pixel is the best of the ``batch`` largest values
(equal values in ascending flat index) that has not been chosen before.
"""

import contextlib
import math

import numpy as np
import torch

__all__ = ["Bounds", "observed_rows", "grid_rows", "train", "predict",
           "expected_improvement", "choose", "tf32"]

_CHUNK = 4096


@contextlib.contextmanager
def tf32(enabled):
    """Let float32 matrix products on the card run in TF32 inside the
    block (the lower-precision control of a float32 configuration)."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = bool(enabled)
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


class Bounds:
    """The hyperparameters' intervals for a grid of ``shape``."""

    def __init__(self, shape, amplitude=(1e-4, 10.0)):
        d = len(shape)
        self.ls_lo = np.zeros(d)
        self.ls_hi = np.full(d, float(np.mean(shape)) / 2.0)
        self.var_lo, self.var_hi = float(amplitude[0]), float(amplitude[1])


def observed_rows(R):
    """(X (n, d), y (n,)): the coordinates and values of the measured
    pixels of the grid ``R``, in row-major order."""
    keep = ~np.isnan(R)
    return np.argwhere(keep).astype(np.float64), R[keep].astype(np.float64)


def grid_rows(shape):
    """Every pixel's coordinates, (prod(shape), d), in row-major order."""
    return np.argwhere(np.ones(shape, bool)).astype(np.float64)


def _rbf(ls, var, A, B):
    diff = A[:, None, :] / ls - B[None, :, :] / ls
    return var * torch.exp(-0.5 * (diff * diff).sum(-1))


def _constrain(u, b):
    t = lambda x: torch.as_tensor(x, dtype=u.dtype, device=u.device)  # noqa
    d = len(b.ls_lo)
    lo, hi = t(b.ls_lo), t(b.ls_hi)
    ls = lo + (hi - lo) * torch.sigmoid(u[:d])
    var = b.var_lo + (b.var_hi - b.var_lo) * torch.sigmoid(u[d])
    noise = torch.logaddexp(u[d + 1], torch.zeros((), dtype=u.dtype,
                                                  device=u.device))
    return ls, var, noise


def _log_jacobian(u, b):
    d = len(b.ls_lo)
    lsig = torch.nn.functional.logsigmoid
    span = np.log(b.ls_hi - b.ls_lo).sum() + np.log(b.var_hi - b.var_lo)
    return span + (lsig(u[:d + 1]) + lsig(-u[:d + 1])).sum()


def initial_u(b, dtype, device):
    """The unconstrained starting point: l at 0.1 of its interval, v = 1,
    noise = 1."""
    d = len(b.ls_lo)
    t_var = (1.0 - b.var_lo) / (b.var_hi - b.var_lo)
    raw = [math.log(0.1 / 0.9)] * d + [
        math.log(t_var / (1.0 - t_var)), 1.0 + math.log(-math.expm1(-1.0))]
    return torch.tensor(raw, dtype=dtype, device=device)


def _loss(u, X, y, b, jitter):
    ls, var, noise = _constrain(u, b)
    n = X.shape[0]
    A = _rbf(ls, var, X, X) + (noise + jitter) * torch.eye(
        n, dtype=X.dtype, device=X.device)
    L = torch.linalg.cholesky(A)
    z = torch.linalg.solve_triangular(L, y[:, None], upper=False)[:, 0]
    nll = (0.5 * (z * z).sum() + torch.log(torch.diagonal(L)).sum()
           + 0.5 * n * math.log(2.0 * math.pi))
    return nll - _log_jacobian(u, b)


def train(X, y, b, u, *, lr, iterations, jitter):
    """``iterations`` Adam steps from ``u``; returns (u, losses), the
    losses before each update."""
    u = u.detach().clone()
    m = torch.zeros_like(u)
    v = torch.zeros_like(u)
    losses = []
    for t in range(1, iterations + 1):
        w = u.clone().requires_grad_(True)
        loss = _loss(w, X, y, b, jitter)
        (g,) = torch.autograd.grad(loss, w)
        losses.append(loss.detach())
        m = 0.9 * m + 0.1 * g
        v = 0.999 * v + 0.001 * g * g
        mhat = m / (1.0 - 0.9 ** t)
        vhat = v / (1.0 - 0.999 ** t)
        u = u - lr * mhat / (torch.sqrt(vhat) + 1e-8)
    return u, torch.stack(losses) if losses else None


def hyperparams(u, b):
    """{lengthscale (d,), variance, noise} as float64 numpy."""
    ls, var, noise = _constrain(u, b)
    return {"lengthscale": ls.detach().cpu().double().numpy(),
            "variance": float(var), "noise": float(noise)}


@torch.no_grad()
def predict(X, y, b, u, Xt, *, jitter):
    """Predictive mean and sd (observation noise included) at ``Xt``."""
    ls, var, noise = _constrain(u, b)
    n = X.shape[0]
    A = _rbf(ls, var, X, X) + (noise + jitter) * torch.eye(
        n, dtype=X.dtype, device=X.device)
    L = torch.linalg.cholesky(A)
    alpha = torch.cholesky_solve(y[:, None], L)[:, 0]
    means, sds = [], []
    for s in range(0, Xt.shape[0], _CHUNK):
        Ks = _rbf(ls, var, Xt[s:s + _CHUNK], X)
        W = torch.linalg.solve_triangular(L, Ks.T, upper=False)
        means.append(Ks @ alpha)
        sds.append(torch.sqrt((var - (W * W).sum(0) + noise).clamp_min(0)))
    return torch.cat(means), torch.cat(sds)


def expected_improvement(mean, sd, measured, xi=0.01):
    """EI of every grid point over the best mean at the ``measured`` ones
    (a bool mask over the flat grid)."""
    best = mean[measured].max()
    imp = mean - best - xi
    z = imp / sd
    pdf = torch.exp(-0.5 * z * z) / math.sqrt(2.0 * math.pi)
    return imp * torch.special.ndtr(z) + sd * pdf


def choose(acq, chosen, batch=100):
    """The flat index of the next pixel: the first of the ``batch`` largest
    finite acquisition values (ties in ascending index) not in
    ``chosen``; None when every one of them was chosen before."""
    a = np.asarray(acq.detach().cpu().double().numpy())
    a = np.where(np.isnan(a), -np.inf, a)
    order = np.argsort(-a, kind="stable")[:batch]
    for i in order:
        if np.isfinite(a[i]) and int(i) not in chosen:
            return int(i)
    return None
