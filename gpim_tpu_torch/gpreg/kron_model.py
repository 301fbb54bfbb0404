"""
Exact Kronecker GP model for full-grid training data on tensors
(counterpart of ``gpim_tpu/gpreg/kron_model.py``).

Ties :mod:`gpim_tpu_torch.ops.kron_exact` into the parameter semantics of
the dense and SKI ``skreconstructor`` routes: constant mean, outputscale,
interval lengthscales and positive noise (``multi._constrain_task``), so
checkpoints and trajectories are the same across routes. ``skreconstructor``
selects it when the training observations cover a full Cartesian grid with
no NaNs.

Each Adam step builds one kernel factor per grid axis (K1 on CUDA, at
(G_k, 1) x (G_k, 1)), takes one ``eigh`` of each, and differentiates the
factors in closed form (:func:`kron_exact.kron_nll`). Prediction runs over
4096-point chunks of the test points; each chunk's cross rows are one K1
launch per axis, at (chunk, 1) x (G_k, 1).
"""

import numpy as np
import torch

from gpim_tpu_torch import dtypes
from gpim_tpu_torch.gpreg import engine
from gpim_tpu_torch.gpreg.multi import _constrain_task as _constrain
from gpim_tpu_torch.kernels.functional import get_kernel_fn
from gpim_tpu_torch.kernels.transforms import interval_log_jacobian
from gpim_tpu_torch.ops import kron_exact
from gpim_tpu_torch.ops.ski import grid_kernel_factors

__all__ = ["KronEngine"]

_PREDICT_CHUNK = 4096


def _factors(kernel, p, axes):
    kp = {"lengthscale": p["lengthscale"], "variance": p["variance"]}
    return grid_kernel_factors(kernel, kp, list(axes))


def _loss(u, axes, Y, bounds, jitter, kernel):
    """Kronecker NLL minus the lengthscales' interval log-Jacobian (the
    dense route's MAP objective); no Cholesky, so no status."""
    p = _constrain(u, bounds)
    nll = kron_exact.kron_nll(_factors(kernel, p, axes), p["noise"] + jitter,
                              Y - p["mean"])
    return nll - interval_log_jacobian(
        u["lengthscale"], bounds["ls_lo"], bounds["ls_hi"]), None


@torch.no_grad()
def _predict(u, axes, Y, bounds, jitter, Xtest_chunks, kernel):
    p = _constrain(u, bounds)
    fs = _factors(kernel, p, axes)
    d = len(axes)
    kfn = get_kernel_fn(kernel)
    ls = torch.broadcast_to(p["lengthscale"], (d,))

    def cross(k):
        def e(xcol):
            pk = {"lengthscale": ls[k][None],
                  "variance": p["variance"] if k == 0 else 1.0}
            return kfn(pk, xcol[:, None], axes[k][:, None])
        return e

    mean, var = kron_exact.kron_predict_chunks(
        fs, [cross(k) for k in range(d)], p["noise"] + jitter,
        Y - p["mean"], p["variance"], Xtest_chunks, noiseless=False)
    return mean + p["mean"], var


class KronEngine:
    """Exact grid GP: one eigh per dimension, closed-form MLL, gradient and
    prediction. ``axes``: the per-dimension grid coordinates (numpy)."""

    def __init__(self, kernel, axes, dims, dtype, device):
        self.kernel = kernel
        self.dims = tuple(int(s) for s in dims)
        self.dtype = dtype
        self.device = device
        self._axes = tuple(torch.as_tensor(np.asarray(a), dtype=dtype,
                                           device=device) for a in axes)

    def train(self, u0, Y, bounds, lr, jitter, *, iterations):
        """Adam on the Kronecker MLL; returns (final u, trajectory of
        lengthscale (iters, d), noise and loss (iters,))."""
        u, u_traj, losses = engine.adam_steps(
            lambda uu: _loss(uu, self._axes, Y, bounds, jitter, self.kernel),
            u0, lr, iterations, factors=())
        with torch.no_grad():
            p = _constrain(u_traj, bounds)
        return u, {"lengthscale": p["lengthscale"], "noise": p["noise"],
                   "loss": losses}

    def predict(self, u, Y, bounds, jitter, Xtest_clean, mesh=None):
        """Predictive mean and variance (tensors) at the NaN-free test
        points ``Xtest_clean`` (numpy (n_test, d)). With a mesh, each rank
        computes its rows of every tile against the replicated
        eigendecompositions, and the rows are gathered."""
        chunk = min(_PREDICT_CHUNK,
                    dtypes.round_up(max(len(Xtest_clean), 1), 128))
        chunks, n_test = engine.chunk_rows(np.asarray(Xtest_clean), chunk)
        chunks_d = torch.as_tensor(chunks, dtype=self.dtype,
                                   device=self.device)

        def predict(tiles):
            return _predict(u, self._axes, Y, bounds, jitter, tiles,
                            self.kernel)
        if mesh is None:
            mean, var = predict(chunks_d)
        else:
            from gpim_tpu_torch.parallel.mesh import predict_rows
            mean, var = predict_rows(predict, chunks_d, mesh)
        return mean[:n_test], var[:n_test]
