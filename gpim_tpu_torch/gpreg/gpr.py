"""
Exact and sparse (inducing-point VFE) GP reconstruction of NaN-masked grids
on PyTorch (counterpart of ``gpim_tpu/gpreg/gpr.py``).

Same constructor signature as the reference's
``gpim.gpreg.gpr.reconstructor``, ``train`` / ``predict`` / ``run``
methods, numpy in and numpy out, and the same public ``hyperparams`` time
series. The model runs on the CUDA device unless the caller asks for the
CPU with ``use_gpu=False``; without a CUDA device the default raises and
never quietly runs on the CPU. (The reference ignores ``use_gpu`` and always
runs on its accelerator.)

``sparse=True`` trains the Titsias VFE bound with trainable inducing
points, initialised as a strided subsample of the observations, and
records their trajectory in ``hyperparams['inducing_points']``.

``step()`` trains, predicts and ranks the grid by an acquisition function
(the exploration step of ``gpim_tpu``).

``mesh=`` (a ``DeviceMesh`` with a 'grid' axis, ``True``, or the world
size; :mod:`gpim_tpu_torch.parallel`) shards the rows of every prediction
tile over 'grid' for both models, and the sparse model's training rows too
when their padded count divides the axis: each rank then sums its rows'
share of the bound's (m, m) and (m,) terms and one all-reduce a step makes
them whole. The exact model trains on every rank, as in ``gpim_tpu``
(one Cholesky stays rank-local). Every rank passes the same data and gets
the same results.
"""

import time
import warnings

import numpy as np
import torch

from gpim_tpu_torch import convert, dtypes
from gpim_tpu_torch.gpreg import engine
from gpim_tpu_torch.kernels.transforms import (
    interval_inverse, positive_inverse)
from gpim_tpu_torch.utils import gridutils, profiling

__all__ = ["reconstructor"]

_PAD_BUCKET = 128          # training-set padding bucket (see engine.pad_rows)
_PREDICT_CHUNK = 4096      # test points per prediction chunk
_NP_DTYPE = {torch.float32: np.float32, torch.float64: np.float64}


def _as_bounds(lengthscale, dtype):
    """Normalize the reference's lengthscale-bounds convention: a flat
    ``[lo, hi]`` pair means ONE shared lengthscale, a pair of per-dim lists
    means ARD (reference gpr.py:46-51)."""
    lo, hi = lengthscale
    if np.ndim(lo) == 0:
        return np.full((1,), lo, dtype), np.full((1,), hi, dtype)
    return np.asarray(lo, dtype), np.asarray(hi, dtype)


def _resolve_device(use_gpu):
    if not use_gpu:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass use_gpu=False "
                           "to run on the CPU")
    return torch.device("cuda")


class reconstructor:
    """GP-based reconstruction of sparse 2D images and 3D spectroscopic data.

    Args mirror the reference (gpr.py:74-168): X (c, N, M[, L]) grid indices
    with NaNs at missing points, y (N, M[, L]) observations with NaNs, Xtest
    full prediction grid, kernel in {'RBF', 'Matern52', 'RationalQuadratic'},
    lengthscale bounds, sparse/indpoints for inducing-point VFE
    regression, learning_rate, iterations, use_gpu (default True:
    the CUDA device, RuntimeError without one; False: the CPU), verbose,
    seed, and kwargs: amplitude (variance bounds), precision
    ('single'/'double'; default: double on the CPU, single on CUDA),
    jitter, isotropic, mesh (a ``DeviceMesh`` with a 'grid' axis, True for
    the whole world, or its size: prediction tiles, and the sparse model's
    training rows, shard over 'grid').
    """

    def __init__(self,
                 X,
                 y,
                 Xtest=None,
                 kernel='RBF',
                 lengthscale=None,
                 sparse=False,
                 indpoints=None,
                 learning_rate=5e-2,
                 iterations=1000,
                 use_gpu=True,
                 verbose=1,
                 seed=0,
                 **kwargs):
        self._mesh = None
        if kwargs.get("mesh") not in (None, False):
            from gpim_tpu_torch.parallel.mesh import resolve_mesh
            self._mesh = resolve_mesh(kwargs["mesh"])
        if kernel not in ("RBF", "Matern52", "RationalQuadratic"):
            raise NotImplementedError(
                "Select one of the currently available kernels: "
                "RBF, Matern52, RationalQuadratic")
        with profiling.span("recon.init"):
            self.device = _resolve_device(use_gpu)
            self.precision = kwargs.get("precision")
            self.dtype = dtypes.resolve_dtype(self.precision, self.device)
            np_dtype = _NP_DTYPE[self.dtype]
            self._prec_str = ("single" if self.dtype == torch.float32
                              else "double")
            self.verbose = verbose
            self.seed = seed
            self.kernel_type = kernel
            self.do_sparse = bool(sparse)
            input_dim = np.ndim(y)

            # --- host-side data prep (NaN compaction), reference gpr.py:115
            X_np, y_np = gridutils.prepare_training_data(
                X, y, precision=self._prec_str)

            # --- lengthscale bounds defaults, reference gpr.py:118-123 ---
            if lengthscale is None:
                lmean = float(np.mean(y.shape) / 2)
                if kwargs.get("isotropic"):
                    lengthscale = [0.0, lmean]
                else:
                    lengthscale = [[0.0] * input_dim, [lmean] * input_dim]
            ls_lo, ls_hi = _as_bounds(lengthscale, np_dtype)
            amp = kwargs.get("amplitude")
            if amp is None:
                amp = [1e-4, 10.0]
            self._bounds_np = {
                "ls_lo": ls_lo, "ls_hi": ls_hi,
                "var_lo": np.asarray(amp[0], np_dtype),
                "var_hi": np.asarray(amp[1], np_dtype),
            }

            if Xtest is not None:
                self.fulldims = Xtest.shape[1:]
                self.Xtest = gridutils.prepare_test_data(
                    Xtest, precision=self._prec_str)
            else:
                self.fulldims = X.shape[1:]
                self.Xtest = None

            self.jitter = float(kwargs.get("jitter",
                                           dtypes.default_jitter(self.dtype)))
            self.learning_rate = learning_rate
            self.iterations = iterations

            # --- parameter initialization (unconstrained space), as in
            # gpim_tpu: lengthscale 10% into its interval, variance and
            # noise 1
            b = self._bounds()
            ls_init = ls_lo + 0.1 * (ls_hi - ls_lo)
            var_init = np.clip(np.asarray(1.0, np_dtype),
                               amp[0] * 1.001, amp[1] * 0.999)
            one = self._tensor(1.0)
            self.u = {
                "lengthscale": interval_inverse(
                    self._tensor(ls_init), b["ls_lo"], b["ls_hi"]),
                "variance": interval_inverse(
                    self._tensor(var_init), b["var_lo"], b["var_hi"]),
                "noise": positive_inverse(one),
            }
            if kernel == "RationalQuadratic":
                self.u["alpha"] = positive_inverse(one)
            if sparse:
                # strided subsample of the observations
                # (gpim_tpu gpr.py:167-178)
                if indpoints is None:
                    indpoints = max(len(X_np) // 10, 1)
                else:
                    indpoints = min(indpoints, len(X_np))
                Xu = X_np[::len(X_np) // indpoints].copy()
                if self.verbose == 2:
                    print("# of inducing points for sparse GP regression: "
                          "{}".format(len(Xu)))
                self.u["Xu"] = self._tensor(Xu)

            self._set_data(X_np, y_np)
            self.hyperparams = {}
            self._traj_list = []

    # ------------------------------------------------------------------
    # data plumbing
    # ------------------------------------------------------------------

    def _tensor(self, x):
        with profiling.wait("upload"):
            return torch.as_tensor(np.asarray(x, _NP_DTYPE[self.dtype]),
                                   device=self.device)

    def _set_data(self, X_np, y_np):
        """Install a (new) training set, padded to a bucket size."""
        self.X, self.y = X_np, y_np
        Xp, n = engine.pad_rows(X_np, _PAD_BUCKET)
        yp, _ = engine.pad_rows(y_np, _PAD_BUCKET)
        mask = np.zeros(len(Xp), _NP_DTYPE[self.dtype])
        mask[:n] = 1.0
        self._Xd = self._tensor(Xp)
        self._yd = self._tensor(yp)
        self._maskd = self._tensor(mask)
        self._rows = (self._Xd, self._yd, self._maskd, None)
        if self._mesh is not None and self.do_sparse:
            from gpim_tpu_torch.parallel import mesh as meshmod
            if len(Xp) % meshmod.axis_size(self._mesh, "grid") == 0:
                # the VFE is a sum over rows: each rank takes its share
                self._rows = tuple(
                    meshmod.shard_batch(t, self._mesh)
                    for t in self._rows[:3]) + (
                        meshmod.axis_group(self._mesh, "grid"),)

    def update_data(self, X, y):
        """Re-prepares raw grid data and swaps the training set in place."""
        X_np, y_np = gridutils.prepare_training_data(
            X, y, precision=self._prec_str)
        self._set_data(X_np, y_np)

    def _bounds(self):
        # memoized on the _bounds_np dict identity (rebound by load_model)
        if getattr(self, "_bounds_dev_src", None) is not self._bounds_np:
            self._bounds_dev = convert.bounds_from_numpy(
                self._bounds_np, self.device, self.dtype)
            self._bounds_dev_src = self._bounds_np
        return self._bounds_dev

    def current_lengthscale(self):
        """Constrained lengthscale(s) from the current parameters."""
        p = engine.constrain(self.u, self._bounds())
        with profiling.wait("readback"):
            return p["lengthscale"].cpu().numpy()

    # ------------------------------------------------------------------
    # training
    # ------------------------------------------------------------------

    def train(self, **kwargs):
        """Optimize hyperparameters (and inducing points) by Adam on the
        masked exact MLL / sparse VFE bound."""
        if kwargs.get("learning_rate") is not None:
            self.learning_rate = kwargs.get("learning_rate")
        if kwargs.get("iterations") is not None:
            self.iterations = kwargs.get("iterations")
        if kwargs.get("verbose") is not None:
            self.verbose = kwargs.get("verbose")
        start_time = time.time()
        if self.verbose:
            print('Model training...')
        with profiling.span("recon.train"):
            self.u, traj = self._fit(self.u, float(self.learning_rate),
                                     int(self.iterations))
            with profiling.wait("traj", len(traj)):
                traj = {k: v.cpu().numpy() for k, v in traj.items()}
        self._traj_list.append(traj)
        self._assemble_hyperparams()
        elapsed = time.time() - start_time
        if self.verbose == 2:
            for i in range(0, int(self.iterations), 100):
                print('iter: {} ...'.format(i),
                      'loss: {} ...'.format(np.around(traj["loss"][i], 4)),
                      'amp: {} ...'.format(
                          np.around(traj["variance"][i], 4)),
                      'length: {} ...'.format(
                          np.around(traj["lengthscale"][i], 4)),
                      'noise: {} ...'.format(np.around(traj["noise"][i], 7)))
        if self.verbose:
            print('training completed in {} s'.format(np.round(elapsed, 2)))
            print('Final parameter values:\n',
                  'amp: {}, lengthscale: {}, noise: {}'.format(
                      np.around(traj["variance"][-1], 4),
                      np.around(traj["lengthscale"][-1], 4),
                      np.around(traj["noise"][-1], 7)))

    def _fit(self, u0, lr, iterations):
        """:func:`engine.train` from ``u0`` on this model's training rows
        (this rank's share of them, when they are sharded)."""
        X, y, mask, group = self._rows
        return engine.train(u0, X, y, mask, self._bounds(), lr, self.jitter,
                            kernel=self.kernel_type, iterations=iterations,
                            sparse=self.do_sparse, group=group)

    def _predict_chunks(self, u, chunks):
        """Predictive mean and variance (noise included) over the test
        tiles ``chunks`` (n_chunks, chunk, d), flat; with a mesh, each rank
        computes its rows of every tile and the rows are gathered."""
        X, y, mask, group = self._rows

        def predict(tiles):
            if self.do_sparse:
                return engine.predict_vfe(
                    u, X, y, mask, self._bounds(), self.jitter, tiles,
                    kernel=self.kernel_type, group=group)
            return engine.predict_exact(u, X, y, mask, self._bounds(),
                                        self.jitter, tiles,
                                        kernel=self.kernel_type)
        if self._mesh is None:
            return predict(chunks)
        from gpim_tpu_torch.parallel.mesh import predict_rows
        return predict_rows(predict, chunks, self._mesh)

    def _assemble_hyperparams(self):
        """Concatenate trajectories across train() calls, as the
        reference's Python lists accumulate (gpr.py:160-168,195-199)."""
        cat = {k: np.concatenate([t[k] for t in self._traj_list])
               for k in self._traj_list[0]}
        self.losses = cat.pop("loss")
        cat.setdefault("inducing_points",
                       np.zeros((0,), _NP_DTYPE[self.dtype]))
        self.hyperparams = cat

    # ------------------------------------------------------------------
    # prediction
    # ------------------------------------------------------------------

    def predict(self, Xtest=None, **kwargs):
        """Predictive mean and standard deviation on the (full) test grid.

        Returns arrays reshaped to ``fulldims``; sd includes observation
        noise, matching reference gpr.py:247-252. Test points with NaN
        coordinates give NaN outputs.
        """
        if Xtest is None and self.Xtest is None:
            warnings.warn(
                "No test data provided. Using training data for prediction",
                UserWarning)
            self.Xtest = self.X
            self.fulldims = (len(self.X),)
        elif Xtest is not None:
            self.Xtest = gridutils.prepare_test_data(
                Xtest, precision=self._prec_str)
            self.fulldims = Xtest.shape[1:]
        if kwargs.get("verbose") is not None:
            self.verbose = kwargs.get("verbose")
        if self.verbose:
            print("Calculating predictive mean and variance...", end=" ")
        with profiling.span("recon.predict"):
            # the device runs on NaN-cleaned coordinates; NaN rows are
            # restored afterwards (EI/POI acquisition relies on them)
            nan_rows = np.isnan(self.Xtest).any(axis=1)
            chunk = min(_PREDICT_CHUNK,
                        dtypes.round_up(len(self.Xtest), 128))
            chunks, n_test = engine.chunk_rows(
                np.nan_to_num(self.Xtest), chunk)
            mean, var = self._predict_chunks(self.u, self._tensor(chunks))
            with profiling.wait("readback", 2):
                mean = mean.cpu().numpy()[:n_test]
                sd = np.sqrt(var.cpu().numpy()[:n_test])
        mean[nan_rows] = np.nan
        sd[nan_rows] = np.nan
        if self.verbose:
            print("Done")
        return mean.reshape(self.fulldims), sd.reshape(self.fulldims)

    # ------------------------------------------------------------------
    # model checkpointing
    # ------------------------------------------------------------------

    def save_model(self, filename):
        """Persist trained hyperparameters (unconstrained + bounds) to an
        .npz in the layout gpim_tpu's save_model writes."""
        with profiling.wait("checkpoint", len(self.u)):
            flat = {("u_" + k): v.detach().cpu().numpy()
                    for k, v in self.u.items()}
        flat.update({("b_" + k): np.asarray(v)
                     for k, v in self._bounds_np.items()})
        flat["kernel"] = np.asarray(self.kernel_type)
        flat["sparse"] = np.asarray(self.do_sparse)
        np.savez(filename, **flat)

    def load_model(self, filename):
        """Restore hyperparameters saved by this class's or gpim_tpu's
        save_model, in this model's dtype and on its device."""
        data = np.load(filename if str(filename).endswith(".npz")
                       else str(filename) + ".npz", allow_pickle=False)
        if str(data["kernel"]) != self.kernel_type or \
                bool(data["sparse"]) != self.do_sparse:
            raise ValueError(
                "checkpoint was written by a different model configuration")
        self.u = convert.params_from_numpy(
            {k[2:]: data[k] for k in data.files if k.startswith("u_")},
            self.device, self.dtype)
        self._bounds_np = {k[2:]: np.asarray(data[k], _NP_DTYPE[self.dtype])
                           for k in data.files if k.startswith("b_")}

    # ------------------------------------------------------------------
    # combined flows
    # ------------------------------------------------------------------

    def run(self, **kwargs):
        """Train, then predict. Returns (mean, sd, hyperparams)."""
        if kwargs.get("learning_rate") is not None:
            self.learning_rate = kwargs.get("learning_rate")
        if kwargs.get("iterations") is not None:
            self.iterations = kwargs.get("iterations")
        self.train(learning_rate=self.learning_rate,
                   iterations=self.iterations)
        mean, sd = self.predict()
        return mean, sd, self.hyperparams

    def step(self, acquisition_function=None,
             batch_size=100, batch_update=False,
             lscale=None, **kwargs):
        """Single train-predict exploration step returning the next query
        point(s) by maximum acquisition value (gpim_tpu/gpreg/gpr.py:430).

        The reference's step calls a missing gprutils.acquisition
        (gpr.py:326-328); this implements its documented contract.
        ``acquisition_function`` takes (mean, sd) and defaults to pure
        uncertainty (sd). Returns (vals, inds, mean.flatten(),
        sd.flatten()).
        """
        from gpim_tpu_torch.gpbayes.acqfunc import rank_acquisition
        if kwargs.get("learning_rate") is not None:
            self.learning_rate = kwargs.get("learning_rate")
        if kwargs.get("iterations") is not None:
            self.iterations = kwargs.get("iterations")
        self.train(learning_rate=self.learning_rate,
                   iterations=self.iterations)
        if lscale is None:
            # read AFTER the retrain so batch spacing reflects the model's
            # current correlation length, not the previous step's
            lscale = float(np.mean(self.hyperparams["lengthscale"][-1]))
        mean, sd = self.predict()
        vals, inds = rank_acquisition(
            mean, sd, acquisition_function, batch_size, batch_update, lscale)
        return vals, inds, mean.flatten(), sd.flatten()
