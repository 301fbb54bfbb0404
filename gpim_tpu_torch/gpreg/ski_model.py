"""
Off-lattice SKI engine on tensors (counterpart of
``gpim_tpu/gpreg/ski_model.py``): the structured route of
``skreconstructor`` for large data that is not a NaN-masked uniform
lattice, or for any large data with ``lattice=False``.

The points are linearly interpolated onto a Cartesian inducing grid
(:func:`ski.choose_grid`, :func:`ski.build_interp`) and the operator is
A v = W K_UU W^T v + (noise + jitter) v (:func:`ski.make_interp_mvm`: the
weighted corners summed onto the grid by K4 over W's CSR layout, built
once here, d mode products, a gather). Training
is Adam on the SKI marginal likelihood of :func:`ski.ski_mll`:
split-preconditioned CG over the data and the Rademacher probes, the SLQ
log-determinant and trace-estimated gradients, with the same constant mean,
outputscale, interval lengthscales and positive noise as the dense route.
Each Adam step builds the d kernel factors once (d K1 launches on CUDA).
The preconditioner, the dense Nystrom basis of the interpolated Kronecker
eigen-root (:func:`ski.kron_eig_root`, :func:`ski.split_root`), is rebuilt
at the start of each training segment, whose length adapts to the realized
CG iterations (:func:`engine.adam_segments`, shared with the masked-lattice
engine).

The points are sorted by their lower-corner flat index once, with a stable
sort, as ``gpim_tpu`` sorts them (ski_model.py:157-170): the probes are
drawn for the sorted rows, so the same sort gives the same probes to the
same points. Targets and masks are permuted at entry; every output is
order-invariant.

Prediction takes every test point at once: the SKI mean, and the Nystrom
variance of the preconditioner's eigen-root, or the LOVE variance of
``rank`` Lanczos steps when ``precond_rank`` is 0, whose solve then runs
to CG's tolerance (:func:`ski.make_ski_predictor`).

Not carried from ``gpim_tpu``: the sorted-corner form of the operator
(``sorted_corners``, a TPU scatter-lowering device; the port applies the
plain form) and ``mesh=``.
"""

import math

import numpy as np
import torch

from gpim_tpu_torch.gpreg import engine
from gpim_tpu_torch.gpreg.multi import _constrain_task as _constrain
from gpim_tpu_torch.kernels.transforms import interval_log_jacobian
from gpim_tpu_torch.ops import gram_kernels, ski
from gpim_tpu_torch.parallel.distributed import all_reduce, copy_to_shards

__all__ = ["SKIEngine"]

_LOG_2PI = math.log(2.0 * math.pi)


def _kernel_params(p):
    return {"lengthscale": p["lengthscale"], "variance": p["variance"]}


def _loss(u, grids, core, Qp, lam_n, y, mask_, bounds, jitter, *, kernel,
          record_iters=False, shard=None):
    """The SKI MAP objective (gpim_tpu/gpreg/ski_model.py:43-67, and over
    the masked lattice mgrid_model.py:134-169): the SKI marginal likelihood
    ``core`` (:func:`ski.ski_mll` or :func:`ski.ski_mll_from_mvm` with
    ``return_iters``) over all rows of ``y``, less the exact
    0.5 (rows - n_obs) log(noise) of the rows ``mask_`` leaves out (noise
    only there), less the lengthscales' interval log-Jacobian; with
    ``record_iters`` also the realized CG iterations. With ``shard`` (a
    :class:`ski.GridShard`), ``y`` and ``mask_`` are this rank's block of
    ``shard.n`` equal blocks: the observed count is summed over its group,
    and the mean enters the block through :func:`copy_to_shards`, so its
    gradient is summed too."""
    p = _constrain(u, bounds)
    mean = p["mean"]
    n_eff, rows = mask_.sum(), y.shape[0]
    if shard is not None:
        mean = copy_to_shards(mean, shard.group)
        n_eff, rows = all_reduce(n_eff, shard.group), rows * shard.n
    yc = (y - mean) * mask_
    noise_pj = p["noise"] + jitter
    factors = ski.grid_kernel_factors(kernel, _kernel_params(p), grids)
    base, it = core(factors, noise_pj, yc, Qp, lam_n)
    loss = (base + 0.5 * n_eff * _LOG_2PI
            - 0.5 * (rows - n_eff) * torch.log(noise_pj)
            - interval_log_jacobian(u["lengthscale"], bounds["ls_lo"],
                                    bounds["ls_hi"]))
    return (loss, it) if record_iters else loss


@torch.no_grad()
def _build_precond(u, grids, i0, w0, mask_, bounds, *, kernel, rank):
    """The preconditioner's orthonormal Nystrom form (Q, lam_n) at the
    current hyperparameters: noise-independent and fixed for a training
    segment; rank 0 gives an empty basis."""
    if rank == 0:
        return w0.new_zeros((w0.shape[0], 0)), w0.new_zeros((0,))
    p = _constrain(u, bounds)
    factors = ski.grid_kernel_factors(kernel, _kernel_params(p), grids)
    Lp = ski.kron_eig_root(ski._kron_top_modes(factors, rank), i0, w0, mask_)
    Qp, lam_n, _ = ski.split_root(Lp)
    return Qp, lam_n


class SKIEngine:
    """The inducing grid, interpolation tensors and probes of one dataset.

    ``X_pad`` (n_pad, d) numpy points, padded; ``mask`` (n_pad,) 1 at real
    rows; ``grids`` the per-dim inducing grids (:func:`ski.choose_grid`).
    ``cg_iters`` and the Lanczos ``rank`` are capped at n_pad,
    ``precond_rank`` (None: 512) at n_pad and the grid size. The probes are
    ``numpy.random.default_rng(seed).choice([-1, 1], (n_pad, n_probes))``
    for the sorted rows, the draw ``gpim_tpu`` makes, held batch-first; the
    Lanczos start is JAX's Rademacher draw for ``seed``.
    """

    def __init__(self, kernel, X_pad, mask, grids, dtype, device, *,
                 cg_iters=64, n_probes=8, rank=100, precond_rank=None,
                 seed=0):
        self.kernel = kernel
        self.dtype = dtype
        self.device = device
        np_dtype = np.float32 if dtype == torch.float32 else np.float64
        X_pad = np.asarray(X_pad, np_dtype)
        self.grids_np = [np.asarray(g, np_dtype) for g in grids]
        self.grid_shape = tuple(len(g) for g in self.grids_np)
        idx, wgt = ski.build_interp(X_pad, self.grids_np, mask)
        i0, w0 = ski.build_interp_sep(X_pad, self.grids_np)
        # sorted by lower-corner flat index, stably (every corner column is
        # then sorted too): the order gpim_tpu's probes belong to
        perm = np.argsort(idx[:, 0], kind="stable")
        t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)  # noqa
        ti = lambda a: torch.as_tensor(  # noqa: E731
            a, dtype=torch.int64, device=device)
        self._perm = ti(perm)
        self._idx, self._wgt = ti(idx[perm]), t(wgt[perm])
        self._i0, self._w0 = ti(i0[perm]), t(w0[perm])
        self._mask = t(np.asarray(mask, np_dtype)[perm])
        self._grids = [t(g) for g in self.grids_np]
        # W's CSR layout by cell, for K4: every mvm of every train() and
        # predict() of this data set
        self._layout = gram_kernels.interp_layout(
            self._idx, self._wgt, math.prod(self.grid_shape))
        n_pad = X_pad.shape[0]
        self.cg_iters = int(min(cg_iters, n_pad))
        self.rank = int(min(rank, n_pad))
        if precond_rank is None:
            precond_rank = 512
        self.precond_rank = int(min(precond_rank, n_pad,
                                    math.prod(self.grid_shape)))
        self.seed = seed
        rng = np.random.default_rng(seed)
        pm1 = np.asarray([-1.0, 1.0], np_dtype)
        # probes of the split operator, batch-first (a probe per row)
        self._g0 = t(rng.choice(pm1, size=(n_pad, n_probes)).T.copy())
        # the realized CG iterations of every step and the segment lengths
        # of the last train() (the adaptive schedule's record), and the
        # realized CG iterations of the last predict()'s solve
        self.last_cg_iters = np.zeros((0,), np_dtype)
        self.last_segments = []
        self.last_predict_cg_iters = None

    def train(self, u0, y, mask_, bounds, lr, jitter, *, iterations,
              record_cg_iters=False):
        """Adam on the off-lattice objective with the adaptive rebuild
        schedule; ``y`` and ``mask_`` (n_pad,) in the caller's row order.
        Returns (final u, trajectory of lengthscale (iters, d), noise and
        loss (iters,)[, cg_iters (iters,)]); zero-length series for
        ``iterations`` <= 0."""
        y, mask_ = y[self._perm], mask_[self._perm]
        core = ski.ski_mll(self._idx, self._wgt, self.grid_shape,
                           self.cg_iters, self._g0, return_iters=True,
                           layout=self._layout)
        u, u_traj, losses, its, segments = engine.adam_segments(
            u0, lr, max(int(iterations), 0),
            lambda u: _build_precond(u, self._grids, self._i0, self._w0,
                                     self._mask, bounds, kernel=self.kernel,
                                     rank=self.precond_rank),
            lambda u, pre: _loss(u, self._grids, core, *pre, y, mask_,
                                 bounds, jitter, kernel=self.kernel,
                                 record_iters=True))
        with torch.no_grad():
            p = _constrain(u_traj, bounds)
        traj = {"lengthscale": p["lengthscale"], "noise": p["noise"],
                "loss": losses}
        self.last_cg_iters = its.cpu().numpy()
        self.last_segments = segments
        if record_cg_iters:
            traj["cg_iters"] = its
        return u, traj

    @torch.no_grad()
    def predict(self, u, y, mask, bounds, jitter, Xtest_clean, mesh=None):
        """Predictive mean and variance (tensors, the noise included) at the
        NaN-free test points ``Xtest_clean`` (numpy (m, d)), all at once.
        With a mesh, each rank takes its block of the test rows against the
        replicated training-side solve, and the rows are gathered
        (:func:`~gpim_tpu_torch.parallel.mesh.shard_gather`)."""
        predictor = ski.make_ski_predictor(
            self.kernel, self._grids, self.grid_shape, self._idx, self._wgt,
            self._i0, self._w0, self._mask, self.cg_iters, self.rank,
            self.precond_rank, self._layout)
        p = _constrain(u, bounds)
        mask = mask[self._perm]
        yc = (y[self._perm] - p["mean"]) * mask
        t = lambda a: torch.as_tensor(  # noqa: E731
            a, dtype=self.dtype, device=self.device)
        ti = lambda a: torch.as_tensor(  # noqa: E731
            a, dtype=torch.int64, device=self.device)

        def predict(Xt):
            t_idx, t_wgt = ski.build_interp(Xt, self.grids_np)
            t_i0, t_w0 = ski.build_interp_sep(Xt, self.grids_np)
            kss = torch.full((len(Xt),), 1.0, dtype=self.dtype,
                             device=self.device) * p["variance"]
            return predictor(_kernel_params(p), p["noise"] + jitter, yc,
                             ti(t_idx), t(t_wgt), ti(t_i0), t(t_w0), kss,
                             self.seed)
        Xt = np.asarray(Xtest_clean, self.grids_np[0].dtype)
        if mesh is None:
            mean, var = predict(Xt)
        else:
            from gpim_tpu_torch.parallel.mesh import shard_gather
            mean, var = shard_gather(predict, Xt, mesh)
        self.last_predict_cg_iters = int(predictor.cg_iters)
        return mean + p["mean"], var + p["noise"]   # noiseless=False
