"""
Functional exact-GP core on tensors (counterpart of
``gpim_tpu/gpreg/engine.py``, exact subset).

- Observations are NaN-compacted on host and padded to a bucket size; a 0/1
  mask folds the padding out of the marginal likelihood exactly (padded
  rows/cols of the covariance become identity rows, padded targets zeros).
- Hyperparameters are optimized in unconstrained space with the interval
  log-Jacobians added to the objective (the MAP objective of Pyro's
  Uniform-prior Trace_ELBO).
- The RBF / Matern52 / RationalQuadratic marginal likelihood has a
  closed-form backward (:class:`_NLLFast`); on CUDA its forward runs kernel
  K2 and its RBF backward kernel K3 (:mod:`gpim_tpu_torch.ops.gram_kernels`).
- Training is a Python loop of ``torch.optim.Adam`` steps that never waits
  for the device: losses, raw parameters and Cholesky status are recorded
  into preallocated device tensors and read once after the loop.
- Prediction runs over fixed-size chunks of the test grid.

The sparse (VFE) objective and predictor come with a later slice.
"""

import math

import numpy as np
import torch

from gpim_tpu_torch.kernels.functional import get_kernel_fn, kernel_diag
from gpim_tpu_torch.kernels.transforms import (
    interval_forward, interval_log_jacobian, positive_forward)
from gpim_tpu_torch.ops import gram_kernels
from gpim_tpu_torch.ops.gram import pairwise_sq_dist
from gpim_tpu_torch.ops.linalg import safe_cholesky
from gpim_tpu_torch.ops.tri import tri_inverse

__all__ = [
    "constrain", "exact_loss", "train", "predict_exact", "pad_rows",
    "chunk_rows",
]

_LOG_2PI = math.log(2.0 * math.pi)
_SQRT5 = math.sqrt(5.0)
_FAST_KERNELS = ("RBF", "Matern52", "RationalQuadratic")


# --------------------------------------------------------------------------
# Parameter handling
# --------------------------------------------------------------------------

def constrain(u, bounds):
    """Map unconstrained parameters to their constrained domains.

    Keys of ``u``: 'lengthscale', 'variance', 'noise', optional 'alpha'
    (RationalQuadratic). ``bounds``: 'ls_lo', 'ls_hi', 'var_lo', 'var_hi'.
    Leading batch axes of ``u`` broadcast against the bounds.
    """
    p = {
        "lengthscale": interval_forward(
            u["lengthscale"], bounds["ls_lo"], bounds["ls_hi"]),
        "variance": interval_forward(
            u["variance"], bounds["var_lo"], bounds["var_hi"]),
        "noise": positive_forward(u["noise"]),
    }
    if "alpha" in u:
        p["alpha"] = positive_forward(u["alpha"])
    return p


def _log_jacobian(u, bounds):
    """Interval-transform log-Jacobian (the MAP prior term)."""
    return (interval_log_jacobian(u["lengthscale"],
                                  bounds["ls_lo"], bounds["ls_hi"]) +
            interval_log_jacobian(u["variance"],
                                  bounds["var_lo"], bounds["var_hi"]))


def _record(p):
    """Per-iteration hyperparameter snapshot (the public `hyperparams`
    contract)."""
    return {"lengthscale": p["lengthscale"], "variance": p["variance"],
            "noise": p["noise"]}


# --------------------------------------------------------------------------
# Masked marginal likelihoods
# --------------------------------------------------------------------------

def _masked_system(K, noise, mask, jitter):
    """Replace padded rows/cols of (K + noise I) with identity rows."""
    mm = mask[:, None] * mask[None, :]
    eye = torch.eye(K.shape[0], dtype=K.dtype, device=K.device)
    diag_fix = (1.0 - mask) * eye
    return mm * (K + (noise + jitter) * eye) + diag_fix


def _nll_core(L, z, mask):
    """0.5 |z|^2 + masked log det + n_eff/2 log 2 pi."""
    return (0.5 * torch.dot(z, z)
            + torch.sum(torch.log(torch.diagonal(L)) * mask)
            + 0.5 * mask.sum() * _LOG_2PI)


def _exact_loss_info(u, X, y, mask, bounds, jitter, kernel):
    p = constrain(u, bounds)
    if kernel in _FAST_KERNELS:
        nll, info = _NLLFast.apply(kernel, p["lengthscale"], p["variance"],
                                   p["noise"], p.get("alpha"), X, y, mask,
                                   jitter)
    else:
        nll, info = _exact_nll_autodiff(p, X, y, mask, jitter, kernel)
    return nll - _log_jacobian(u, bounds), info


def exact_loss(u, X, y, mask, bounds, jitter, *, kernel):
    """Masked negative log marginal likelihood + MAP prior terms."""
    return _exact_loss_info(u, X, y, mask, bounds, jitter, kernel)[0]


def _exact_nll_autodiff(p, X, y, mask, jitter, kernel):
    """Masked NLL differentiated by autograd through the Cholesky; returns
    ``(nll, info)`` with the Cholesky status of :func:`safe_cholesky`."""
    kfn = get_kernel_fn(kernel)
    A = _masked_system(kfn(p, X, X), p["noise"], mask, jitter)
    L, info = safe_cholesky(A)
    # quadratic form via one triangular solve: y^T A^-1 y = |L^-1 y|^2
    z = torch.linalg.solve_triangular(L, (y * mask)[:, None],
                                      upper=False)[:, 0]
    return _nll_core(L, z, mask), info


# --------------------------------------------------------------------------
# Closed-form MLL gradient (RBF / Matern52 / RationalQuadratic)
#
#     dNLL/dA = 0.5 (A^-1 - alpha alpha^T),   alpha = A^-1 y
# With base = (A^-1 - alpha alpha^T) . mm (mm the padding-mask outer product):
#     dNLL/dnoise = 0.5 (sum_i Ainv_ii m_i^2 - |alpha|^2)
#     dNLL/dv     = 0.5 sum(base . K) / v
#     dNLL/dl_k   = (sum_i x_ik^2 rowsum(W)_i - x_k^T W x_k) / l_k^3,
#                   W = base . G
# Per-kernel G: RBF G = K; Matern52 G = (5/3) v (1 + sqrt5 r) exp(-sqrt5 r);
# RationalQuadratic G = v (1 + s/(2a))^(-a-1), plus
#     dNLL/da = 0.5 sum(base . K . (-log u + s / (2a + s))),  u = 1 + s/(2a).
# (gpim_tpu/gpreg/engine.py:136-290.)
# --------------------------------------------------------------------------

class _NLLFast(torch.autograd.Function):
    """Masked NLL of the constrained hyperparameters with the closed-form
    backward. Returns ``(nll, info)``; ``info`` is the Cholesky status,
    non-differentiable."""

    @staticmethod
    def forward(ctx, kernel, ls, variance, noise, alpha, X, y, mask, jitter):
        Xs = X / ls
        # one fused pass producing K and the masked system together (K2 on
        # CUDA); the backward recomputes s when the kernel needs it
        Kt, A = gram_kernels.masked_system(Xs, mask, variance, noise + jitter,
                                           alpha, kernel=kernel)
        L, info = safe_cholesky(A)
        # explicit L^-1: z now, and both backward solves become gemms
        V = tri_inverse(L)
        z = V @ (y * mask)
        ctx.kernel = kernel
        ctx.save_for_backward(ls, variance, alpha, X, mask, V, Kt, z)
        ctx.mark_non_differentiable(info)
        return _nll_core(L, z, mask), info

    @staticmethod
    def backward(ctx, g, _g_info):
        ls, v, a_rq, X, mask, V, Kt, z = ctx.saved_tensors
        kernel = ctx.kernel
        alpha = V.T @ z                                   # A^-1 (y . m)
        Ainv = V.T @ V
        d_alpha = None
        if kernel == "RBF":
            # one pass over Ainv and Kt computes every matrix reduction (K3)
            s1, rw, WX, diagsum = gram_kernels.rbf_bwd_reductions(
                Ainv, Kt, alpha, mask, X)
            dv = 0.5 * g * s1 / v
            dn = 0.5 * g * (diagsum - torch.dot(alpha, alpha))
        else:
            mm = mask[:, None] * mask[None, :]
            base = (Ainv - alpha[:, None] * alpha[None, :]) * mm
            dv = 0.5 * g * torch.sum(base * Kt) / v
            dn = 0.5 * g * (torch.dot(torch.diagonal(Ainv), mask * mask)
                            - torch.dot(alpha, alpha))
            s = pairwise_sq_dist(X / ls, X / ls)     # K1 on CUDA
            if kernel == "Matern52":
                r = torch.sqrt(s + 1e-12)
                G = (5.0 / 3.0) * v * (1.0 + _SQRT5 * r) * torch.exp(
                    -_SQRT5 * r)
            else:  # RationalQuadratic
                u_ = 1.0 + s / (2.0 * a_rq)
                G = v * u_ ** (-a_rq - 1.0)
                d_alpha = 0.5 * g * torch.sum(
                    base * Kt * (-torch.log(u_) + s / (2.0 * a_rq + s)))
            W = base * G
            rw = W.sum(dim=1)
            WX = W @ X
        per_dim = g * ((X * X * rw[:, None]).sum(dim=0)
                       - (X * WX).sum(dim=0))
        if ls.shape[0] == 1 and X.shape[1] > 1:
            # isotropic: one lengthscale scales every dim
            dls = per_dim.sum()[None] / ls ** 3
        else:
            dls = per_dim / ls ** 3
        dy = g * alpha if ctx.needs_input_grad[6] else None
        # X and mask are never trained in the exact path; jitter is constant
        return None, dls, dv, dn, d_alpha, None, dy, None, None


# --------------------------------------------------------------------------
# Training: a host loop of Adam steps that never waits for the device
# --------------------------------------------------------------------------

def _check_cholesky(infos, what):
    """Raise if any recorded Cholesky status is nonzero (one host sync)."""
    infos = infos.cpu().numpy().reshape(-1)
    bad = np.flatnonzero(infos)
    if bad.size:
        raise torch.linalg.LinAlgError(
            "%s: Cholesky failed at step %d (leading minor of order %d is "
            "not positive definite)" % (what, bad[0], infos[bad[0]]))


def train(u0, X, y, mask, bounds, lr, jitter, *, kernel, iterations):
    """Run ``iterations`` Adam steps; returns (final_u, trajectory dict).

    The trajectory holds the post-update constrained hyperparameters of
    every iteration plus the pre-update loss. Adam is ``torch.optim.Adam``,
    whose update m_hat / (sqrt(v_hat) + 1e-8) is optax.adam's. Nothing in
    the loop reads a device value: the Cholesky status of every step is
    checked once at the end, and a failure raises
    ``torch.linalg.LinAlgError``.
    """
    u = {k: v.detach().clone().requires_grad_(True) for k, v in u0.items()}
    opt = torch.optim.Adam(list(u.values()), lr=lr)
    dev = X.device
    losses = torch.empty((iterations,), dtype=X.dtype, device=dev)
    infos = torch.zeros((iterations,), dtype=torch.int32, device=dev)
    u_traj = {k: torch.empty((iterations,) + tuple(v.shape), dtype=v.dtype,
                             device=dev) for k, v in u.items()}
    for i in range(iterations):
        opt.zero_grad(set_to_none=True)
        loss, info = _exact_loss_info(u, X, y, mask, bounds, jitter, kernel)
        loss.backward()
        opt.step()
        with torch.no_grad():
            losses[i] = loss
            infos[i] = info
            for k, v in u.items():
                u_traj[k][i] = v
    _check_cholesky(infos, "train")
    with torch.no_grad():
        # constrain the raw trajectory in one batched pass
        traj = _record(constrain(u_traj, bounds))
    traj["loss"] = losses
    return {k: v.detach() for k, v in u.items()}, traj


# --------------------------------------------------------------------------
# Prediction: chunk by chunk over the test grid
# --------------------------------------------------------------------------

@torch.no_grad()
def predict_exact(u, X, y, mask, bounds, jitter, Xtest_chunks, *,
                  kernel, noiseless=False):
    """Exact GP predictive mean/variance over chunked test points.

    ``Xtest_chunks`` has shape (n_chunks, chunk, d); chunks run one after
    another so peak memory stays at one (n, chunk) block. Variance includes
    observation noise unless ``noiseless``.
    """
    kfn = get_kernel_fn(kernel)
    p = constrain(u, bounds)
    A = _masked_system(kfn(p, X, X), p["noise"], mask, jitter)
    L, info = safe_cholesky(A)
    # one explicit L^-1 turns every per-chunk triangular solve into a gemm
    V = tri_inverse(L)
    alpha = V.T @ (V @ (y * mask))
    n_chunks, chunk = Xtest_chunks.shape[:2]
    means = torch.empty((n_chunks, chunk), dtype=X.dtype, device=X.device)
    variances = torch.empty_like(means)
    for c in range(n_chunks):
        xc = Xtest_chunks[c]
        Ks = kfn(p, xc, X) * mask[None, :]
        means[c] = Ks @ alpha
        W = V @ Ks.T
        var = kernel_diag(kernel, p, xc) - (W * W).sum(dim=0)
        if not noiseless:
            var = var + p["noise"]
        variances[c] = var.clamp_min(0.0)
    _check_cholesky(info, "predict")
    return means.reshape(-1), variances.reshape(-1)


# --------------------------------------------------------------------------
# Host-side shape plumbing (numpy)
# --------------------------------------------------------------------------

def pad_rows(arr, bucket):
    """Pad axis 0 up to the next multiple of ``bucket`` (with zeros).

    Returns (padded, original_length).
    """
    n = arr.shape[0]
    n_pad = int(-(-max(n, 1) // bucket) * bucket)
    if n_pad == n:
        return arr, n
    pad = [(0, n_pad - n)] + [(0, 0)] * (arr.ndim - 1)
    return np.pad(arr, pad), n


def chunk_rows(arr, chunk):
    """Zero-pad axis 0 to a multiple of ``chunk`` and reshape to
    (n_chunks, chunk, ...). Returns (chunked, original_length)."""
    padded, n = pad_rows(arr, chunk)
    return padded.reshape((-1, chunk) + arr.shape[1:]), n
