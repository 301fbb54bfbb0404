"""
Multi-output GP engine on tensors (counterpart of
``gpim_tpu/gpreg/multi.py``): independent channels on a task axis, and the
Kronecker multitask model.

- Independent mode (the "parallel GP" of the EELS workflow): one exact GP
  per output channel, with its own constant mean, outputscale, ARD
  lengthscales and noise, all trained jointly. ``gpim_tpu`` vmaps the
  masked MLL over the channels, which turns each Pallas kernel into one
  call over a task grid axis. Here every per-channel tensor carries that
  leading task axis, so each Adam step runs K2, one batched Cholesky, one
  batched triangular inverse and (RBF) K3 once for all T channels, and
  prediction runs K1 once per test chunk for all of them
  (:mod:`gpim_tpu_torch.ops.gram_kernels`).
- Correlated mode: the covariance Kx (x) B with a low-rank-plus-diagonal
  task covariance B. ``eigh`` of the T x T matrix B rotates the task basis,
  so the nT x nT system decouples into T systems lam_t Kx + noise I,
  factorised by one batched Cholesky: O(T n^3) instead of O((nT)^3), with a
  closed-form backward (:class:`_KronMTCore`).

Prediction is the closed-form mean and variance, chunk by chunk over the
test grid. Training is :func:`engine.adam_steps`, the sync-free Adam loop
that every model trains through.
"""

import math

import numpy as np
import torch

from gpim_tpu_torch.gpreg import engine
from gpim_tpu_torch.kernels.functional import get_kernel_fn, kernel_diag
from gpim_tpu_torch.kernels.transforms import (
    interval_forward, interval_log_jacobian, positive_forward)
from gpim_tpu_torch.ops.linalg import safe_cholesky
from gpim_tpu_torch.ops.tri import chol_and_inverse, tri_gram, tri_inverse
from gpim_tpu_torch.parallel.distributed import (
    all_gather, all_reduce, reduce_from_shards)

__all__ = [
    "broadcast_ls_bounds",
    "train_independent", "predict_independent",
    "train_correlated", "predict_correlated",
]

_LOG_2PI = math.log(2.0 * math.pi)
_FAST_KERNELS = ("RBF", "Matern52")


# --------------------------------------------------------------------------
# shared pieces
# --------------------------------------------------------------------------

def _constrain_task(u, bounds):
    """Per-task parameters: interval lengthscale (T, d), positive
    outputscale and noise (T,), unconstrained constant mean (T,)."""
    return {
        "lengthscale": interval_forward(
            u["lengthscale"], bounds["ls_lo"], bounds["ls_hi"]),
        "variance": positive_forward(u["outputscale"]),
        "noise": positive_forward(u["noise"]),
        "mean": u["mean"],
    }


def broadcast_ls_bounds(lengthscale, input_dim, isotropic, dtype):
    """GPyTorch semantics: a scalar interval broadcasts over the ARD dims
    (``isotropic`` collapses to one lengthscale). Returns numpy (lo, hi)."""
    lo, hi = lengthscale
    if np.ndim(lo) == 0:
        shape = (1,) if isotropic else (input_dim,)
        return np.full(shape, lo, dtype), np.full(shape, hi, dtype)
    return np.asarray(lo, dtype), np.asarray(hi, dtype)


def _task_factors(T):
    """Names of the T per-task Cholesky factors a step records."""
    return tuple("task %d" % t for t in range(T))


def _batched(p):
    """Per-task parameters in the layout the kernel functions take with a
    task axis: lengthscale (T, 1, d), variance (T, 1, 1)."""
    return {"lengthscale": p["lengthscale"][:, None, :],
            "variance": p["variance"][:, None, None], "noise": p["noise"]}


def _masked_gram(kfn, p, X, mask, jitter):
    """Every channel's masked training system, (T, n, n)."""
    return engine._masked_system(kfn(_batched(p), X, X), p["noise"], mask,
                                 jitter)


def _task_mll(p, X, Y, mask, jitter, kernel):
    """Masked exact MLL of every channel with its constant mean, (T,), and
    the Cholesky status (T,); ``Y`` is (T, n).

    RBF and Matern52 take the closed-form backward (:class:`engine._NLLFast`
    with a task axis), whose exact dNLL/dy carries the mean's gradient;
    anything else is differentiated through the Cholesky.
    """
    y = Y - p["mean"][:, None]
    if kernel in _FAST_KERNELS:
        return engine._NLLFast.apply(kernel, p["lengthscale"], p["variance"],
                                     p["noise"], None, X, y, mask, jitter)
    return engine._exact_nll_autodiff(_batched(p), X, y, mask, jitter,
                                      kernel)


# --------------------------------------------------------------------------
# independent ("parallel") multi-output GP
# --------------------------------------------------------------------------

def _iv_loss(u, X, Y, mask, bounds, jitter, *, kernel):
    """Sum of the channels' masked MLLs minus the lengthscales'
    log-Jacobian, and the Cholesky status (T,); ``Y`` is (n, T)."""
    nll, info = _task_mll(_constrain_task(u, bounds), X, Y.mT, mask, jitter,
                          kernel)
    return nll.sum() - interval_log_jacobian(
        u["lengthscale"], bounds["ls_lo"], bounds["ls_hi"]), info


def train_independent(u0, X, Y, mask, bounds, lr, jitter, *, kernel,
                      iterations):
    """Joint Adam training of all channels; ``Y`` is (n, T). Returns (final
    u, trajectory of lengthscale (iters, T, d), noise and outputscale
    (iters, T), loss (iters,))."""
    u, u_traj, losses = engine.adam_steps(
        lambda uu: _iv_loss(uu, X, Y, mask, bounds, jitter, kernel=kernel),
        u0, lr, iterations, _task_factors(Y.shape[1]))
    with torch.no_grad():
        p = _constrain_task(u_traj, bounds)
    return u, {"lengthscale": p["lengthscale"], "noise": p["noise"],
               "outputscale": p["variance"], "loss": losses}


@torch.no_grad()
def predict_independent(u, X, Y, mask, bounds, jitter, Xtest_chunks, *,
                        kernel, noiseless=False):
    """Closed-form per-channel predictive mean and variance over chunked
    test points (``Xtest_chunks`` (n_chunks, chunk, d)); returns mean and
    var of shape (n_chunks * chunk, T). One K1 launch builds every channel's
    training Gram, one more each chunk's cross-Gram."""
    kfn = get_kernel_fn(kernel)
    p = _constrain_task(u, bounds)
    kp = _batched(p)
    # one explicit L^-1 a channel turns every per-chunk solve into a gemm
    V, info = chol_and_inverse(_masked_gram(kfn, p, X, mask, jitter))[1:]
    ym = (Y.mT - p["mean"][:, None]) * mask
    alpha = V.mT @ (V @ ym[..., None])                # (T, n, 1)
    n_chunks, chunk = Xtest_chunks.shape[:2]
    T = Y.shape[1]
    means = torch.empty((n_chunks, chunk, T), dtype=X.dtype, device=X.device)
    variances = torch.empty_like(means)
    for c in range(n_chunks):
        xc = Xtest_chunks[c]
        Ks = kfn(kp, xc, X) * mask                    # (T, chunk, n)
        means[c] = ((Ks @ alpha)[..., 0] + p["mean"][:, None]).mT
        W = V @ Ks.mT                                 # (T, n, chunk)
        var = kernel_diag(kernel, kp, xc) - (W * W).sum(dim=-2)
        if not noiseless:
            var = var + p["noise"][:, None]
        variances[c] = var.clamp_min(0.0).mT
        del Ks, W
    engine._check_cholesky(info, "predict", _task_factors(T))
    return means.reshape(-1, T), variances.reshape(-1, T)


# --------------------------------------------------------------------------
# correlated multitask GP (Kronecker Kx (x) B)
# --------------------------------------------------------------------------

def _constrain_corr(u, bounds):
    noise = positive_forward(u["noise"])
    return {
        "lengthscale": interval_forward(
            u["lengthscale"], bounds["ls_lo"], bounds["ls_hi"]),
        # the outputscale is absorbed into B
        "variance": torch.ones((), dtype=noise.dtype, device=noise.device),
        "noise": noise,
        "mean": u["mean"],                                # (T,) task means
        "F": u["F"],                                      # (T, rank) factor
        "task_var": positive_forward(u["task_var"]),      # (T,) diagonal
    }


def _task_cov(p):
    """B = F F^T + diag(v), GPyTorch's IndexKernel parametrisation."""
    return p["F"] @ p["F"].mT + torch.diag(p["task_var"])


def _decouple(Kx, B, noise, Yc, tasks=slice(None)):
    """Rotate the task basis by eigh(B): A = Kx (x) B + noise I becomes T
    systems A_t = lam_t Kx + noise I. Returns (lam, Qb, A_s, Yt): the
    eigenvalues (clamped at 1e-12) and eigenvectors of B, the systems
    (T_s, n, n) of the rotated tasks ``tasks`` (a slice; all by default)
    and the rotated targets Yt (T, n)."""
    lam, Qb = torch.linalg.eigh(B)
    lam = lam.clamp_min(1e-12)
    eye = torch.eye(Kx.shape[-1], dtype=Kx.dtype, device=Kx.device)
    return lam, Qb, lam[tasks, None, None] * Kx + noise * eye, (Yc @ Qb).mT


class _KronMTCore(torch.autograd.Function):
    """0.5 y^T A^-1 y + 0.5 logdet A for A = Kx (x) B + noise I, with
    vec(Yc) in row-major (n, T) order; returns (value, Cholesky status
    (T_s,)).

    Autograd through eigh(B) would be unstable: the rank-1-plus-diagonal
    initial B has T - 1 exactly repeated eigenvalues, and eigh's backward
    divides by their differences. The backward instead gives the closed-form
    total derivatives (gpim_tpu/gpreg/multi.py:257-335), which hold no
    eigenvector sensitivities and are invariant under any choice of
    eigenvectors inside a repeated eigenvalue's block:

        dL/dB     = 0.5 Qb (diag(c) - S) Qb^T,  c_t = tr(A_t^-1 Kx),
                                                S   = at^T Kx at
        dL/dKx    = 0.5 (sum_t lam_t A_t^-1 - at diag(lam) at^T)
        dL/dnoise = 0.5 (sum_t tr(A_t^-1) - |at|^2)
        dL/dYc    = at Qb^T

    Sharded over the rotated tasks: with ``tasks`` a slice of them and
    ``group`` the ranks that hold the other slices, the value is this
    slice's share of the sum, and the backward returns this slice's share
    of each total derivative (its rows of diag(c) - S, its terms of the
    sums; S's rows need every task's ``at``, gathered once forward), so the
    shares sum to the whole over ``group``.
    """

    @staticmethod
    def forward(ctx, Kx, B, noise, Yc, tasks, group):
        lam, Qb, A, Yt = _decouple(Kx, B, noise, Yc, tasks)
        L, info = safe_cholesky(A)
        at = torch.cholesky_solve(Yt[tasks, :, None], L)[..., 0]
        out = (0.5 * (Yt[tasks] * at).sum()
               + torch.log(torch.diagonal(L, dim1=-2, dim2=-1)).sum())
        at_all = all_gather(at, group, dim=0)
        ctx.tasks = tasks
        ctx.save_for_backward(Kx, lam, Qb, L, at, at_all)
        ctx.mark_non_differentiable(info)
        return out, info

    @staticmethod
    def backward(ctx, g, _g_info):
        Kx, lam, Qb, L, at, at_all = ctx.saved_tensors
        tasks = ctx.tasks
        lam_s, Qb_s = lam[tasks], Qb[:, tasks]
        V = tri_inverse(L)
        Inv = tri_gram(V)                                 # A_t^-1 (T_s, n, n)
        del V
        tr_c = (Inv * Kx).sum(dim=(-2, -1))               # tr(A_t^-1 Kx)
        S = at @ (Kx @ at_all.mT)                         # (T_s, T)
        D = torch.zeros_like(S)
        D[:, tasks] = torch.diag(tr_c)
        dB = 0.5 * g * (Qb_s @ (D - S) @ Qb.mT)
        dKx = 0.5 * g * (torch.tensordot(lam_s, Inv, dims=1)
                         - (at.mT * lam_s) @ at)
        dnoise = 0.5 * g * (torch.diagonal(Inv, dim1=-2, dim2=-1).sum()
                            - (at * at).sum())
        dYc = g * (at.mT @ Qb_s.mT)
        return dKx, dB, dnoise, dYc, None, None


def _corr_loss(u, X, Y, bounds, jitter, *, kernel, tasks=slice(None),
               group=None):
    """Kronecker multitask NLL minus the lengthscale's log-Jacobian, and the
    Cholesky status (T_s,) of the rotated tasks ``tasks``; ``Y`` is (n, T).
    With ``group``, this rank factorises only ``tasks``: Kx, B, the noise
    and Yc enter through one :func:`copy_to_shards` and the task sum leaves
    through :func:`reduce_from_shards`, so the loss and its gradients are
    the whole model's on every rank."""
    kfn = get_kernel_fn(kernel)
    p = _constrain_corr(u, bounds)
    n, T = Y.shape
    shared = engine._enter_rows(
        [kfn(p, X, X), _task_cov(p), p["noise"] + jitter,
         Y - p["mean"][None, :]], group)
    core, info = _KronMTCore.apply(*shared, tasks, group)
    nll = reduce_from_shards(core, group) + 0.5 * n * T * _LOG_2PI
    return nll - interval_log_jacobian(
        u["lengthscale"], bounds["ls_lo"], bounds["ls_hi"]), info


def train_correlated(u0, X, Y, bounds, lr, jitter, *, kernel, iterations,
                     tasks=slice(None), group=None):
    """Adam training of the Kronecker multitask model; ``Y`` is (n, T).
    Returns (final u, trajectory of lengthscale (iters, d), noise and loss
    (iters,)). With ``group``, this rank factorises the rotated tasks
    ``tasks`` and takes the same steps as one process."""
    u, u_traj, losses = engine.adam_steps(
        lambda uu: _corr_loss(uu, X, Y, bounds, jitter, kernel=kernel,
                              tasks=tasks, group=group), u0,
        lr, iterations, _task_factors(Y.shape[1])[tasks])
    with torch.no_grad():
        ls = interval_forward(u_traj["lengthscale"], bounds["ls_lo"],
                              bounds["ls_hi"])
        noise = positive_forward(u_traj["noise"])
    return u, {"lengthscale": ls, "noise": noise, "loss": losses}


@torch.no_grad()
def predict_correlated(u, X, Y, bounds, jitter, Xtest_chunks, *, kernel,
                       noiseless=False, tasks=slice(None), group=None):
    """Closed-form multitask predictive mean and variance, (n_chunks * chunk,
    T). In the rotated task basis the posterior decouples,
    f~_t(x*) ~ N(lam_t k*^T A_t^-1 y~_t, lam_t k** - lam_t^2 k*^T A_t^-1 k*),
    and rotating back, Var(f_task) = sum_t Qb[task, t]^2 var~_t. With
    ``group``, this rank computes the rotated tasks ``tasks`` and their
    share of both sums, all-reduced once over ``group``."""
    kfn = get_kernel_fn(kernel)
    p = _constrain_corr(u, bounds)
    lam, Qb, A, Yt = _decouple(kfn(p, X, X), _task_cov(p),
                               p["noise"] + jitter, Y - p["mean"][None, :],
                               tasks)
    # one explicit L^-1 a rotated task turns every per-chunk solve into a
    # gemm
    L, V, info = chol_and_inverse(A)
    alphas = torch.cholesky_solve(Yt[tasks, :, None], L)[..., 0]
    del L
    n_chunks, chunk = Xtest_chunks.shape[:2]
    T = Y.shape[1]
    means = torch.empty((n_chunks, chunk, T), dtype=X.dtype, device=X.device)
    variances = torch.empty_like(means)
    lam_c = lam[tasks, None]
    Qb_s = Qb[:, tasks]
    for c in range(n_chunks):
        xc = Xtest_chunks[c]
        Ks = kfn(p, xc, X)                                # (chunk, n)
        m_rot = lam_c * (alphas @ Ks.mT)                  # (T_s, chunk)
        W = V @ Ks.mT                                     # (T_s, n, chunk)
        v_rot = (lam_c * kernel_diag(kernel, p, xc)
                 - lam_c ** 2 * (W * W).sum(dim=-2)).clamp_min(0.0)
        means[c] = (Qb_s @ m_rot).mT
        variances[c] = ((Qb_s ** 2) @ v_rot).mT
        del Ks, W
    both = all_reduce(torch.stack([means, variances]), group)
    means = both[0] + p["mean"]
    variances = both[1] if noiseless else both[1] + p["noise"]
    engine._check_cholesky(info, "predict", _task_factors(T)[tasks])
    return means.reshape(-1, T), variances.reshape(-1, T)
