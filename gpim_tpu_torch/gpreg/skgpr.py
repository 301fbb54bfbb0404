"""
Structured-kernel / spectral-mixture GP reconstruction of 2D-4D grids on
PyTorch (counterpart of ``gpim_tpu/gpreg/skgpr.py``).

Same constructor signature as the reference's
``gpim.gpreg.skgpr.skreconstructor`` (kernel 'RBF' | 'Matern52' |
'Spectral', ``ski``, ``grid_points_ratio``, ``maxroot``, ``num_batches``,
``isotropic``, ``n_mixtures``, ``precision``), ``train`` / ``predict`` /
``run`` / ``step`` methods, numpy in and numpy out, and the same
``hyperparams`` time series (lengthscale and noise, or the spectral
scales, means, weights, noise and maxdim). The model runs on the CUDA
device unless the caller asks for the CPU with ``use_gpu=False``; without a
CUDA device the default raises. (``gpim_tpu`` ignores ``use_gpu``.)

Routes, chosen as ``gpim_tpu`` chooses them:

- dense exact (below ``ski_min_points``, default 8192 padded rows, or
  ``ski=False``): the independent multi-output engine at one task
  (:mod:`gpim_tpu_torch.gpreg.multi`): K2 and, for RBF, K3 every Adam step,
  K1 in prediction;
- spectral mixture (``kernel='Spectral'``): plain PyTorch
  (:mod:`gpim_tpu_torch.gpreg.structured`), no hand-written kernel;
- exact Kronecker (``ski=True``, at least ``ski_min_points`` rows covering
  a full Cartesian grid with no NaNs): per-dimension factors (K1) and
  ``eigh`` (:mod:`gpim_tpu_torch.gpreg.kron_model`);
- masked lattice (``ski=True``, at least ``ski_min_points`` rows of a
  NaN-masked grid on uniform axes, which is what ``utils.get_sparse_grid``
  gives; ``lattice=True``, the default): split-preconditioned CG with the
  SLQ log-determinant over the masked Kronecker operator, K1 for every
  kernel factor (:mod:`gpim_tpu_torch.gpreg.mgrid_model`);
- off-lattice SKI (``ski=True``, at least ``ski_min_points`` rows that are
  neither, or any such data with ``lattice=False``): linear interpolation
  onto an inducing grid of ``grid_points_ratio`` n^(1/d) points a
  dimension, the same solver over the interpolated operator, K1 for every
  kernel factor (:mod:`gpim_tpu_torch.gpreg.ski_model`).

``mesh=`` (a ``DeviceMesh`` with a 'grid' axis, ``True``, or the world
size; :mod:`gpim_tpu_torch.parallel`) shards the test rows of every
prediction over 'grid' on every route; the masked-lattice route also
shards its training (the G-sized CG state, by blocks of the first grid
axis), while the dense, spectral, Kronecker and off-lattice routes train
replicated, as in ``gpim_tpu``.

Reference defects stay fixed, as in ``gpim_tpu``: ``predict()`` without a
test grid warns and predicts at the training points, and ``max_root`` is
kept: it sets the off-lattice route's Lanczos rank, and caps the SKI
routes' preconditioner and Nystrom variance rank.
"""

import math
import time
import warnings

import numpy as np
import torch

from gpim_tpu_torch import convert, dtypes
from gpim_tpu_torch.gpreg import (
    engine, mgrid_model, multi, ski_model, structured)
from gpim_tpu_torch.gpreg.gpr import _NP_DTYPE, _resolve_device
from gpim_tpu_torch.gpreg.kron_model import KronEngine
from gpim_tpu_torch.kernels.transforms import (
    interval_inverse, positive_inverse)
from gpim_tpu_torch.ops import kron_exact, ski
from gpim_tpu_torch.utils import gridutils, profiling

__all__ = ["skreconstructor"]

_PAD_BUCKET = 128
_PREDICT_CHUNK = 4096
# below this many (padded) observations the dense exact GP is used whatever
# ``ski`` says: the structured operators are a large-n scaling device
_SKI_MIN_N = 8192


class skreconstructor:
    """GP regression with structured-kernel-interpolation semantics or a
    spectral mixture kernel, for 2D/3D/4D image-grid reconstruction.

    Args mirror the reference (skgpr.py:21-110): X (c, N, M[, L, K]) grid
    indices with NaNs at missing points, y (N, M[, L, K]) observations,
    Xtest prediction grid, kernel 'RBF' | 'Matern52' | 'Spectral',
    lengthscale bounds, ski, learning_rate, iterations, use_gpu (default
    True: the CUDA device, RuntimeError without one; False: the CPU),
    verbose, seed (the spectral initialisation); kwargs: precision
    ('single'/'double'; default: double on the CPU, single on CUDA), jitter,
    num_batches, maxroot (or max_root), grid_points_ratio, isotropic,
    n_mixtures (default 4), ski_min_points (default 8192), and for the
    SKI routes lattice (default True; False sends large data to the
    off-lattice route), cg_iterations (64), n_probes (8) and precond_rank
    (None: on the masked lattice 1024 at 500k grid cells or more, else
    512); seed also draws those routes' probes.
    """

    def __init__(self,
                 X,
                 y,
                 Xtest=None,
                 kernel='RBF',
                 lengthscale=None,
                 ski=True,
                 learning_rate=.1,
                 iterations=50,
                 use_gpu=True,
                 verbose=1,
                 seed=0,
                 **kwargs):
        self._mesh = None
        if kwargs.get("mesh") not in (None, False):
            from gpim_tpu_torch.parallel.mesh import resolve_mesh
            self._mesh = resolve_mesh(kwargs["mesh"])
        if kernel not in ("RBF", "Matern52", "Spectral"):
            # GPyTorch-parity surface (reference gpytorch_kernels.py:60-73)
            raise NotImplementedError(
                "Select one of the currently available kernels: "
                "RBF, Matern52, Spectral")
        self.device = _resolve_device(use_gpu)
        self.precision = kwargs.get("precision")
        self.dtype = dtypes.resolve_dtype(self.precision, self.device)
        np_dtype = _NP_DTYPE[self.dtype]
        self._prec_str = ("single" if self.dtype == torch.float32
                          else "double")
        self.verbose = verbose
        self.kernel_type = kernel
        self.do_ski = ski and kernel != "Spectral"
        input_dim = np.ndim(y)

        X_np, y_np = gridutils.prepare_training_data(
            X, y, precision=self._prec_str)
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
        self.num_batches = kwargs.get("num_batches", 1)
        self.maxroot = kwargs.get("maxroot", kwargs.get("max_root", 100))
        self.grid_points_ratio = kwargs.get("grid_points_ratio", 1.0)
        self._engine_opts = {
            "ski_min_points": int(kwargs.get("ski_min_points", _SKI_MIN_N)),
            "lattice": bool(kwargs.get("lattice", True)),
            "cg_iterations": int(kwargs.get("cg_iterations", 64)),
            "n_probes": int(kwargs.get("n_probes", 8)),
            "precond_rank": kwargs.get("precond_rank"),
            "seed": seed,
        }
        self._build_engines(X, y, X_np, y_np)

        isotropic = bool(kwargs.get("isotropic"))
        n_mixtures = kwargs.get("n_mixtures") or 4
        if kernel == "Spectral":
            self.u = structured.init_spectral_params(
                X_np, y_np, n_mixtures, seed, np_dtype, self.device)
            self._bounds_np = {}
        else:
            if lengthscale is None:
                lmean = float(np.mean(y.shape) / 2)
                lengthscale = ([0.0, lmean] if isotropic
                               else [[0.0] * input_dim, [lmean] * input_dim])
            lo, hi = multi.broadcast_ls_bounds(
                lengthscale, input_dim, isotropic, np_dtype)
            self._bounds_np = {"ls_lo": lo, "ls_hi": hi}
            b = self._bounds()
            one = positive_inverse(self._tensor(1.0))
            # a one-task batch of the multi-output engine: constant mean,
            # outputscale and noise (GPyTorch skgprmodel parity)
            self.u = {
                "lengthscale": interval_inverse(
                    self._tensor(lo + 0.1 * (hi - lo)), b["ls_lo"],
                    b["ls_hi"])[None],
                "outputscale": one.expand(1).clone(),
                "noise": one.expand(1).clone(),
                "mean": torch.zeros(1, dtype=self.dtype, device=self.device),
            }
        self._set_data(X_np, y_np)
        self.hyperparams = {}
        self._traj_list = []

    def _tensor(self, x):
        return torch.as_tensor(np.asarray(x, _NP_DTYPE[self.dtype]),
                               device=self.device)

    def _build_engines(self, X, y, X_np, y_np):
        """The route, as gpim_tpu/gpreg/skgpr.py:162-222 chooses it, when
        ``ski`` is asked for on at least ``ski_min_points`` padded rows:
        exact Kronecker inference if they cover a full Cartesian grid with
        no NaNs, else the masked-lattice engine if the raw grid ``X`` is a
        NaN-masked lattice of uniform axes (and ``lattice``), else the
        off-lattice SKI engine on grids of ``grid_points_ratio``; the dense
        exact engine below that size."""
        opts = self._engine_opts
        self._kron_engine = None
        self._mgrid_engine = None
        self._ski_engine = None
        self._Y_grid = None
        n_pad = dtypes.round_up(max(len(X_np), 1), _PAD_BUCKET)
        if not (self.do_ski and n_pad >= opts["ski_min_points"]):
            return
        axes = None
        if len(X_np) == int(np.prod(np.shape(y))):
            axes = kron_exact.detect_cartesian(X_np, np.shape(y))
        if axes is not None:
            self._kron_engine = KronEngine(self.kernel_type, axes,
                                           np.shape(y), self.dtype,
                                           self.device)
            self._Y_grid = self._tensor(y_np.reshape(np.shape(y)))
            if self.verbose == 2:
                print("Kronecker exact grid:", np.shape(y))
            return
        lat_axes = (mgrid_model.detect_masked_lattice(X, y)
                    if opts["lattice"] else None)
        if lat_axes is None:
            Xp, n = engine.pad_rows(X_np, _PAD_BUCKET)
            mask = np.zeros(len(Xp), X_np.dtype)
            mask[:n] = 1.0
            self._ski_engine = ski_model.SKIEngine(
                self.kernel_type, Xp, mask,
                ski.choose_grid(X_np, ratio=float(self.grid_points_ratio)),
                self.dtype, self.device, cg_iters=opts["cg_iterations"],
                n_probes=opts["n_probes"], precond_rank=opts["precond_rank"],
                rank=int(self.maxroot), seed=opts["seed"])
            if self.verbose == 2:
                print("SKI grid:", self._ski_engine.grid_shape)
            return
        self._mgrid_engine = mgrid_model.MaskedGridEngine(
            self.kernel_type, lat_axes, ~np.isnan(y), y, self.dtype,
            self.device, cg_iters=opts["cg_iterations"],
            n_probes=opts["n_probes"], precond_rank=opts["precond_rank"],
            seed=opts["seed"], mesh=self._mesh, rank=int(self.maxroot))
        if self.verbose == 2:
            print("Masked-lattice grid:", np.shape(y))

    def update_data(self, X, y):
        """Install a new training set and rebuild the route (the structured
        engines bind the construction-time grid and mask, so the route may
        change). Trained hyperparameters are kept: a following train()
        continues warm, and the time series runs on."""
        X_np, y_np = gridutils.prepare_training_data(
            X, y, precision=self._prec_str)
        self._build_engines(X, y, X_np, y_np)
        self._set_data(X_np, y_np)

    def _set_data(self, X_np, y_np):
        self.X, self.y = X_np, y_np
        Xp, n = engine.pad_rows(X_np, _PAD_BUCKET)
        yp, _ = engine.pad_rows(y_np, _PAD_BUCKET)
        mask = np.zeros(len(Xp))
        mask[:n] = 1.0
        self._Xd, self._yd = self._tensor(Xp), self._tensor(yp)
        self._maskd = self._tensor(mask)

    def _bounds(self):
        # memoized on the _bounds_np dict identity (rebound by load_model)
        if getattr(self, "_bounds_dev_src", None) is not self._bounds_np:
            self._bounds_dev = convert.bounds_from_numpy(
                self._bounds_np, self.device, self.dtype)
            self._bounds_dev_src = self._bounds_np
        return self._bounds_dev

    # ------------------------------------------------------------------

    def train(self, **kwargs):
        """Optimise the hyperparameters by Adam on the chosen route."""
        if kwargs.get("learning_rate") is not None:
            self.learning_rate = kwargs.get("learning_rate")
        if kwargs.get("iterations") is not None:
            self.iterations = kwargs.get("iterations")
        if kwargs.get("verbose") is not None:
            self.verbose = kwargs.get("verbose")
        start = time.time()
        if self.verbose:
            print('Model training...')
        lr = float(self.learning_rate)
        iters = int(self.iterations)
        with profiling.span("recon.train"):
            if self.kernel_type == "Spectral":
                self.u, traj = structured.train_spectral(
                    self.u, self._Xd, self._yd, self._maskd, lr, self.jitter,
                    iterations=iters)
            elif self._kron_engine is not None:
                u_k, traj = self._kron_engine.train(
                    {k: v[0] for k, v in self.u.items()}, self._Y_grid,
                    self._bounds(), lr, self.jitter, iterations=iters)
                self.u = {k: v[None] for k, v in u_k.items()}
                traj["lengthscale"] = traj["lengthscale"][:, None, :]
                traj["noise"] = traj["noise"][:, None]
            elif self._mgrid_engine is not None:
                u_g, traj = self._mgrid_engine.train(
                    {k: v[0] for k, v in self.u.items()}, self._bounds(), lr,
                    self.jitter, iterations=iters)
                self.u = {k: v[None] for k, v in u_g.items()}
                traj["lengthscale"] = traj["lengthscale"][:, None, :]
                traj["noise"] = traj["noise"][:, None]
            elif self._ski_engine is not None:
                u_s, traj = self._ski_engine.train(
                    {k: v[0] for k, v in self.u.items()}, self._yd,
                    self._maskd, self._bounds(), lr, self.jitter,
                    iterations=iters)
                self.u = {k: v[None] for k, v in u_s.items()}
                traj["lengthscale"] = traj["lengthscale"][:, None, :]
                traj["noise"] = traj["noise"][:, None]
            else:
                self.u, traj = multi.train_independent(
                    self.u, self._Xd, self._yd[:, None], self._maskd,
                    self._bounds(), lr, self.jitter, kernel=self.kernel_type,
                    iterations=iters)
            traj = {k: v.cpu().numpy() for k, v in traj.items()}
        self._traj_list.append(traj)
        self._assemble_hyperparams()
        if self.verbose:
            print('training completed in {} s'.format(
                np.round(time.time() - start, 2)))

    def _assemble_hyperparams(self):
        # only the keys every route records: after update_data() changes the
        # route, the dense route's trajectory holds an outputscale that the
        # Kronecker route's does not (gpim_tpu/gpreg/skgpr.py:316 raises a
        # KeyError there)
        keys = (("weights", "means", "scales", "noise")
                if self.kernel_type == "Spectral"
                else ("lengthscale", "noise"))
        cat = {k: np.concatenate([t[k] for t in self._traj_list])
               for k in keys + ("loss",)}
        self.losses = cat.pop("loss")
        if self.kernel_type == "Spectral":
            # the derived quantities the reference stores (period = 1/mean,
            # scale = 1/sqrt(spectral scale); skgpr.py:214-220), in the
            # (Q, 1, d) shape its plots expect
            q, d = cat["means"].shape[1:]
            self.hyperparams = {
                "scales": 1.0 / np.sqrt(cat["scales"]).reshape(-1, q, 1, d),
                "means": 1.0 / cat["means"].reshape(-1, q, 1, d),
                "weights": cat["weights"],
                "noise": cat["noise"],
                "maxdim": max(self.fulldims),
            }
        else:
            self.hyperparams = {
                "lengthscale": cat["lengthscale"][:, 0, :],
                "noise": cat["noise"][:, 0],
            }

    # ------------------------------------------------------------------

    def predict(self, Xtest=None, **kwargs):
        """Predictive mean and sd over the test grid, shaped like it; NaN
        test rows give NaN. ``num_batches`` > 1 sets the chunk size to the
        test points / num_batches (the reference's manual splitting,
        skgpr.py:309-326)."""
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
        if kwargs.get("num_batches") is not None:
            self.num_batches = kwargs.get("num_batches")
        if kwargs.get("max_root") is not None:
            # kept, not dropped as in the reference (skgpr.py:305-306): it
            # sets both SKI routes' Lanczos rank (the masked lattice's at
            # precond_rank 0 only), and on both SKI routes the variance root
            # is otherwise the preconditioner's eigen-root, so max_root caps
            # its rank and never raises it (gpim_tpu/gpreg/skgpr.py:357-376)
            self.maxroot = kwargs.get("max_root")
            if self._ski_engine is not None:
                self._ski_engine.rank = int(
                    min(self.maxroot, self._Xd.shape[0]))
            if self._mgrid_engine is not None:
                self._mgrid_engine.rank = int(min(
                    self.maxroot, math.prod(self._mgrid_engine.grid_shape)))
            eng = self._ski_engine or self._mgrid_engine
            if eng is not None and eng.precond_rank > 0:
                capped = int(min(self.maxroot, eng.precond_rank))
                if self.verbose and capped < eng.precond_rank:
                    print("max_root=%d caps the Nystrom/preconditioner "
                          "rank (was %d)" % (capped, eng.precond_rank))
                eng.precond_rank = capped
        if self.verbose:
            print('Calculating predictive mean and uncertainty...')
        nan_rows = np.isnan(self.Xtest).any(axis=1)
        Xtest_clean = np.nan_to_num(self.Xtest)
        with profiling.span("recon.predict"):
            if self._kron_engine is not None:
                mean, var = self._kron_engine.predict(
                    {k: v[0] for k, v in self.u.items()}, self._Y_grid,
                    self._bounds(), self.jitter, Xtest_clean,
                    mesh=self._mesh)
            elif self._mgrid_engine is not None:
                mean, var = self._mgrid_engine.predict(
                    {k: v[0] for k, v in self.u.items()}, self._bounds(),
                    self.jitter, Xtest_clean, self.fulldims)
            elif self._ski_engine is not None:
                mean, var = self._ski_engine.predict(
                    {k: v[0] for k, v in self.u.items()}, self._yd,
                    self._maskd, self._bounds(), self.jitter, Xtest_clean,
                    mesh=self._mesh)
            else:
                nb = max(1, int(self.num_batches))
                target = (-(-len(self.Xtest) // nb) if nb > 1
                          else _PREDICT_CHUNK)
                chunk = min(dtypes.round_up(max(target, 1), 128),
                            dtypes.round_up(len(self.Xtest), 128))
                chunks, n_test = engine.chunk_rows(Xtest_clean, chunk)
                mean, var = self._predict_chunks(self._tensor(chunks))
                mean, var = mean[:n_test], var[:n_test]
            mean = mean.cpu().numpy()
            sd = np.sqrt(var.cpu().numpy())
        mean[nan_rows] = np.nan
        sd[nan_rows] = np.nan
        if self.verbose:
            print("Done")
        return mean.reshape(self.fulldims), sd.reshape(self.fulldims)

    def _predict_chunks(self, chunks):
        """The dense and spectral routes' mean and variance over the tiles
        ``chunks``, flat; with a mesh, each rank computes its rows of every
        tile and the rows are gathered."""
        def predict(tiles):
            if self.kernel_type == "Spectral":
                return structured.predict_spectral(
                    self.u, self._Xd, self._yd, self._maskd, self.jitter,
                    tiles)
            mean, var = multi.predict_independent(
                self.u, self._Xd, self._yd[:, None], self._maskd,
                self._bounds(), self.jitter, tiles, kernel=self.kernel_type)
            return mean[:, 0], var[:, 0]
        if self._mesh is None:
            return predict(chunks)
        from gpim_tpu_torch.parallel.mesh import predict_rows
        return predict_rows(predict, chunks, self._mesh)

    def run(self):
        """Train, then predict. Returns (mean, sd, hyperparams)."""
        self.train()
        mean, sd = self.predict()
        return mean, sd, self.hyperparams

    def save_model(self, filename):
        """Persist trained hyperparameters (unconstrained + bounds) to an
        .npz in the layout gpim_tpu's skreconstructor writes; restore with
        load_model on a model of the same kernel (the route is rebuilt from
        that model's data)."""
        flat = {("u_" + k): v.detach().cpu().numpy()
                for k, v in self.u.items()}
        flat.update({("b_" + k): np.asarray(v)
                     for k, v in self._bounds_np.items()})
        flat["kernel"] = np.asarray(self.kernel_type)
        np.savez(filename, **flat)

    def load_model(self, filename):
        """Restore hyperparameters saved by this class's or gpim_tpu's
        save_model, in this model's dtype and on its device."""
        data = np.load(filename if str(filename).endswith(".npz")
                       else str(filename) + ".npz", allow_pickle=False)
        u = {k[2:]: data[k] for k in data.files if k.startswith("u_")}
        if (str(data["kernel"]) != self.kernel_type
                or set(u) != set(self.u)
                or any(u[k].shape != tuple(self.u[k].shape) for k in u)):
            raise ValueError(
                "checkpoint was written by a different model configuration")
        self.u = convert.params_from_numpy(u, self.device, self.dtype)
        self._bounds_np = {k[2:]: np.asarray(data[k], _NP_DTYPE[self.dtype])
                           for k in data.files if k.startswith("b_")}

    def step(self, acquisition_function=None,
             batch_size=100, batch_update=False,
             lscale=None, **kwargs):
        """Single train-predict exploration step (gpim_tpu/gpreg/skgpr.py:
        483-511): returns (vals, inds, mean.flatten(), sd.flatten()). Raises
        for the structured (``ski``) and spectral models, as the reference
        does (skgpr.py:377-379)."""
        if self.do_ski or self.kernel_type == "Spectral":
            raise NotImplementedError(
                "The Bayesian optimization routines are not available for "
                "structured or spectral kernel")
        from gpim_tpu_torch.gpbayes.acqfunc import rank_acquisition
        if kwargs.get("learning_rate") is not None:
            self.learning_rate = kwargs.get("learning_rate")
        if kwargs.get("iterations") is not None:
            self.iterations = kwargs.get("iterations")
        self.train(learning_rate=self.learning_rate,
                   iterations=self.iterations)
        if lscale is None:
            # read after the retrain, so the batch spacing follows the
            # model's current correlation length
            ls = self.hyperparams.get("lengthscale")
            lscale = float(np.mean(ls[-1])) if ls is not None and len(ls) \
                else 1.0
        mean, sd = self.predict()
        vals, inds = rank_acquisition(
            mean.reshape(self.fulldims), sd.reshape(self.fulldims),
            acquisition_function, batch_size, batch_update, lscale)
        return vals, inds, mean.flatten(), sd.flatten()
