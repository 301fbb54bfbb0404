"""
Spectral-mixture GP engine on tensors (counterpart of
``gpim_tpu/gpreg/structured.py``): initialisation, training and prediction.

Mixture weights, means and scales are softplus-parametrised. The initial
parameters come from numpy's ``default_rng(seed)``, as in ``gpim_tpu``, so
one seed starts both packages at the same point. Training is
:func:`engine.adam_steps` on :func:`engine.mll_from_gram`: autograd
differentiates the elementwise spectral Gram build alone, and the
closed-form dNLL/dK stands in for the Cholesky's backward. Prediction is the
closed-form mean and variance, chunk by chunk over the test grid.

The spectral kernel has no hand-written kernel: ``gpim_tpu`` builds it in
plain XLA, so it stays plain PyTorch on the card as well, and the spectral
path launches none of K1, K2 or K3.
"""

import numpy as np
import torch

from gpim_tpu_torch.gpreg import engine
from gpim_tpu_torch.kernels.functional import spectral_mixture
from gpim_tpu_torch.kernels.transforms import (
    positive_forward, positive_inverse)
from gpim_tpu_torch.ops.tri import chol_and_inverse

__all__ = ["init_spectral_params", "train_spectral", "predict_spectral"]


def init_spectral_params(X, y, n_mixtures, seed, dtype, device):
    """Deterministic data-driven initialisation (GPyTorch's
    ``initialize_from_data`` idea, gpim_tpu/gpreg/structured.py:30-62):
    means ~ U[0, nyquist_d), scales = 1 / range_d, weights = std(y) / Q,
    noise = 0.1 var(y); unconstrained tensors of the numpy ``dtype`` on
    ``device``. ``X`` (n, d) and ``y`` (n,) are the unpadded numpy
    observations."""
    rng = np.random.default_rng(seed)
    d = X.shape[1]
    spans = np.maximum(X.max(0) - X.min(0), 1e-6)
    # minimal spacing per dim from the sorted unique coordinates
    nyquist = []
    for k in range(d):
        u = np.unique(X[:, k])
        du = np.min(np.diff(u)) if len(u) > 1 else 1.0
        nyquist.append(0.5 / max(du, 1e-6))
    nyquist = np.asarray(nyquist, dtype)
    means = rng.uniform(0.0, 1.0, (n_mixtures, d)).astype(dtype) * nyquist
    scales = np.tile((1.0 / spans).astype(dtype), (n_mixtures, 1))
    weights = np.full((n_mixtures,), max(float(np.std(y)), 1e-3) / n_mixtures,
                      dtype)
    noise0 = max(0.1 * float(np.var(y)), 1e-4)
    t = lambda a: torch.as_tensor(  # noqa: E731
        np.asarray(a, dtype), device=device)
    return {
        "weights": positive_inverse(t(weights)),
        "means": positive_inverse(t(np.maximum(means, 1e-4))),
        "scales": positive_inverse(t(scales)),
        "noise": positive_inverse(t(noise0)),
        "mean": t(0.0),
    }


def _constrain_sm(u):
    return {
        "weights": positive_forward(u["weights"]),
        "means": positive_forward(u["means"]),
        "scales": positive_forward(u["scales"]),
        "noise": positive_forward(u["noise"]),
        "mean": u["mean"],
    }


def _sm_loss(u, X, y, mask, jitter):
    """Spectral-mixture NLL and the Cholesky status."""
    p = _constrain_sm(u)
    ym = (y - p["mean"]) * mask
    return engine.mll_from_gram(spectral_mixture(p, X, X), p["noise"], ym,
                                mask, jitter)


def train_spectral(u0, X, y, mask, lr, jitter, *, iterations):
    """Adam training of the mixture; returns (final u, trajectory of the
    constrained weights (iters, Q), means and scales (iters, Q, d), noise
    and loss (iters,))."""
    u, u_traj, losses = engine.adam_steps(
        lambda uu: _sm_loss(uu, X, y, mask, jitter), u0, lr, iterations)
    with torch.no_grad():
        traj = _constrain_sm(u_traj)
    del traj["mean"]
    traj["loss"] = losses
    return u, traj


@torch.no_grad()
def predict_spectral(u, X, y, mask, jitter, Xtest_chunks, *,
                     noiseless=False):
    """Closed-form predictive mean and variance over chunked test points
    (``Xtest_chunks`` (n_chunks, chunk, d)); one explicit inverse factor
    turns every chunk's triangular solve into a gemm."""
    p = _constrain_sm(u)
    V, info = chol_and_inverse(engine._masked_system(
        spectral_mixture(p, X, X), p["noise"], mask, jitter))[1:]
    alpha = V.T @ (V @ ((y - p["mean"]) * mask))
    kss = p["weights"].sum()
    n_chunks, chunk = Xtest_chunks.shape[:2]
    means = torch.empty((n_chunks, chunk), dtype=X.dtype, device=X.device)
    variances = torch.empty_like(means)
    for c in range(n_chunks):
        Ks = spectral_mixture(p, Xtest_chunks[c], X) * mask[None, :]
        means[c] = Ks @ alpha + p["mean"]
        W = V @ Ks.T
        var = kss - (W * W).sum(dim=0)
        if not noiseless:
            var = var + p["noise"]
        variances[c] = var.clamp_min(0.0)
        del Ks, W
    engine._check_cholesky(info, "predict")
    return means.reshape(-1), variances.reshape(-1)
