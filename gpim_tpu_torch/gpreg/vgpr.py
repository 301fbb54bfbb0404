"""
Multi-output ("vector-valued") GP reconstruction of 2D-4D grids on
PyTorch (counterpart of ``gpim_tpu/gpreg/vgpr.py``).

Same constructor signature as the reference's
``gpim.gpreg.vgpr.vreconstructor``, ``train`` / ``predict`` / ``run``
methods, numpy in and numpy out; rows with a NaN in any output channel are
dropped. The model runs on the CUDA device unless the caller asks for the
CPU with ``use_gpu=False``; without a CUDA device the default raises.

- ``independent=True`` (the EELS "parallel GP"): one GP per channel, all
  channels on one task axis (:mod:`gpim_tpu_torch.gpreg.multi`); the
  training rows are padded to a 128-row bucket with an inert 0/1 mask.
- ``independent=False``: the Kronecker multitask covariance Kx (x) B with a
  rank-``task_rank`` plus diagonal task covariance, decoupled by eigh(B)
  into T batched n x n systems; no padding.
- Prediction is the closed-form mean and sd; ``predict(n_samples=...)``
  gives the reference's Monte-Carlo estimator of the same posterior.

The correlated mode's initial task factor ``F`` is the draw of
``jax.random.normal(PRNGKey(seed))`` that ``gpim_tpu`` makes
(:func:`gpim_tpu_torch.ops.prng.jax_normal`), so one seed starts both
packages at the same point.

``mesh=`` (a ``DeviceMesh`` with 'task' and 'grid' axes, ``True``, or the
world size, which takes the squarest task-major split;
:mod:`gpim_tpu_torch.parallel`) shards the channels (independent) or the
rotated task systems (correlated) over 'task', and the rows of every
prediction tile over 'grid'. When 'task' does not divide the channel count
the model warns and runs unsharded, as ``gpim_tpu`` does. Every rank
passes the same data and gets the same results.
"""

import time
import warnings

import numpy as np
import torch

from gpim_tpu_torch import convert, dtypes
from gpim_tpu_torch.gpreg import engine, multi
from gpim_tpu_torch.gpreg.gpr import _NP_DTYPE, _resolve_device
from gpim_tpu_torch.kernels.transforms import (
    interval_inverse, positive_inverse)
from gpim_tpu_torch.ops.prng import jax_normal
from gpim_tpu_torch.utils import gridutils
from gpim_tpu_torch.utils.profiling import Timer

__all__ = ["vreconstructor"]

_PAD_BUCKET = 128
_PREDICT_CHUNK = 2048


class vreconstructor:
    """Multi-output GP regression for vector-valued 2D/3D/4D functions.

    Args mirror the reference (vgpr.py:72-147): X (c, N, M[, L, K]) grid
    indices, y (N, M[, L, K], d) observations with d output channels, Xtest
    prediction grid, kernel 'RBF' | 'Matern52', lengthscale bounds,
    independent (per-channel GPs, or the correlated Kronecker model),
    learning_rate, iterations, use_gpu (default True: the CUDA device,
    RuntimeError without one; False: the CPU), verbose, seed (the initial
    task factor of the correlated mode); kwargs: isotropic, precision
    ('single'/'double'; default: double on the CPU, single on CUDA), jitter,
    num_batches (test points per prediction chunk = their count /
    num_batches), task_rank (correlated mode, default 1), mesh (a
    ('task', 'grid') ``DeviceMesh``, True for the whole world, or its
    size).
    """

    def __init__(self,
                 X,
                 y,
                 Xtest=None,
                 kernel='RBF',
                 lengthscale=None,
                 independent=False,
                 learning_rate=.1,
                 iterations=50,
                 use_gpu=True,
                 verbose=1,
                 seed=0,
                 **kwargs):
        if kernel not in ("RBF", "Matern52"):
            raise NotImplementedError(
                "Select one of the currently available kernels: "
                "RBF, Matern52")
        self.device = _resolve_device(use_gpu)
        self.precision = kwargs.get("precision")
        self.dtype = dtypes.resolve_dtype(self.precision, self.device)
        np_dtype = _NP_DTYPE[self.dtype]
        self._prec_str = ("single" if self.dtype == torch.float32
                          else "double")
        self.verbose = verbose
        self.kernel_type = kernel
        self.independent = independent
        input_dim = np.ndim(y) - 1

        X_np, Y_np = gridutils.prepare_training_data(
            X, y, vector_valued=True, precision=self._prec_str)
        num_tasks = Y_np.shape[-1]
        self.num_tasks = num_tasks
        if Xtest is not None:
            self.fulldims = Xtest.shape[1:] + (num_tasks,)
            self.Xtest = gridutils.prepare_test_data(
                Xtest, precision=self._prec_str)
        else:
            self.fulldims = X.shape[1:] + (num_tasks,)
            self.Xtest = None

        isotropic = bool(kwargs.get("isotropic"))
        if lengthscale is None:
            lmean = float(np.mean(y.shape[:-1]) / 2)
            lengthscale = ([0.0, lmean] if isotropic
                           else [[0.0] * input_dim, [lmean] * input_dim])
        lo, hi = multi.broadcast_ls_bounds(
            lengthscale, input_dim, isotropic, np_dtype)
        self._bounds_np = {"ls_lo": lo, "ls_hi": hi}
        self.jitter = float(kwargs.get("jitter",
                                       dtypes.default_jitter(self.dtype)))
        self.learning_rate = learning_rate
        self.iterations = iterations
        self.num_batches = kwargs.get("num_batches", 1)

        b = self._bounds()
        u_ls = interval_inverse(self._tensor(lo + 0.1 * (hi - lo)),
                                b["ls_lo"], b["ls_hi"])
        one = positive_inverse(self._tensor(1.0))
        full = lambda x: x.expand(num_tasks).clone()  # noqa: E731
        zeros = torch.zeros(num_tasks, dtype=self.dtype, device=self.device)
        if independent:
            self.u = {"lengthscale": u_ls.repeat(num_tasks, 1),
                      "outputscale": full(one), "noise": full(one),
                      "mean": zeros}
        else:
            rank = int(kwargs.get("task_rank", 1))
            F = 0.1 * jax_normal(seed, (num_tasks, rank), np_dtype)
            self.u = {"lengthscale": u_ls, "noise": one, "mean": zeros,
                      "F": self._tensor(F), "task_var": full(one)}

        self._mesh = None
        if kwargs.get("mesh") not in (None, False):
            from gpim_tpu_torch.parallel.mesh import axis_size, resolve_mesh
            self._mesh = resolve_mesh(kwargs["mesh"], ("task", "grid"))
            t_ax = axis_size(self._mesh, "task")
            if num_tasks % t_ax:
                warnings.warn(
                    "num_tasks (%d) not divisible by mesh task axis "
                    "(%d); running unsharded" % (num_tasks, t_ax),
                    UserWarning)
                self._mesh = None

        self._set_data(X_np, Y_np)
        self.hyperparams = {}
        self._traj_list = []
        self.timer = Timer()

    def _tensor(self, x):
        return torch.as_tensor(np.asarray(x, _NP_DTYPE[self.dtype]),
                               device=self.device)

    def _set_data(self, X_np, Y_np):
        self.X, self.y = X_np, Y_np
        if self.independent:
            Xp, n = engine.pad_rows(X_np, _PAD_BUCKET)
            Yp, _ = engine.pad_rows(Y_np, _PAD_BUCKET)
            mask = np.zeros(len(Xp))
            mask[:n] = 1.0
            self._Xd, self._Yd = self._tensor(Xp), self._tensor(Yp)
            self._maskd = self._tensor(mask)
        else:
            # the Kronecker rotation takes no padding
            self._Xd, self._Yd = self._tensor(X_np), self._tensor(Y_np)
            self._maskd = None

    def _bounds(self):
        # memoized on the _bounds_np dict identity (rebound by load_model)
        if getattr(self, "_bounds_dev_src", None) is not self._bounds_np:
            self._bounds_dev = convert.bounds_from_numpy(
                self._bounds_np, self.device, self.dtype)
            self._bounds_dev_src = self._bounds_np
        return self._bounds_dev

    # ------------------------------------------------------------------

    def train(self, **kwargs):
        """Optimize every channel's hyperparameters (independent) or the
        shared and task hyperparameters (correlated) by Adam."""
        if kwargs.get("learning_rate") is not None:
            self.learning_rate = kwargs.get("learning_rate")
        if kwargs.get("iterations") is not None:
            self.iterations = kwargs.get("iterations")
        if kwargs.get("verbose") is not None:
            self.verbose = kwargs.get("verbose")
        start = time.time()
        if self.verbose:
            print('Model training...')
        kw = dict(kernel=self.kernel_type, iterations=int(self.iterations))
        lr = float(self.learning_rate)
        with self.timer.phase("train", self.device):
            if self.independent and self._mesh is not None:
                from gpim_tpu_torch.parallel import multichip
                self.u, traj = multichip.train_step_sharded(
                    self.u, self._Xd, self._Yd, self._maskd, self._bounds(),
                    lr, self.jitter, self._mesh, **kw)
            elif self.independent:
                self.u, traj = multi.train_independent(
                    self.u, self._Xd, self._Yd, self._maskd, self._bounds(),
                    lr, self.jitter, **kw)
            else:
                self.u, traj = multi.train_correlated(
                    self.u, self._Xd, self._Yd, self._bounds(), lr,
                    self.jitter, **kw, **self._task_shard())
        traj = {k: v.cpu().numpy() for k, v in traj.items()}
        self._traj_list.append(traj)
        self.hyperparams = {
            k: np.concatenate([t[k] for t in self._traj_list])
            for k in traj if k != "loss"}
        self.losses = np.concatenate([t["loss"] for t in self._traj_list])
        if self.verbose:
            print('training completed in {} s'.format(
                np.round(time.time() - start, 2)))
            print('Final parameter values:\n',
                  'lengthscale: {}'.format(
                      np.around(self.hyperparams["lengthscale"][-1], 4)))

    def predict(self, Xtest=None, **kwargs):
        """Closed-form predictive mean and sd of shape fulldims (= grid
        dims + (num_tasks,)); NaN test rows give NaN. Pass ``n_samples`` to
        use the reference's Monte-Carlo estimator instead (vgpr.py:218-225).
        """
        if Xtest is None and self.Xtest is None:
            warnings.warn(
                "No test data provided. Using training data for prediction",
                UserWarning)
            self.Xtest = self.X
            self.fulldims = (len(self.X), self.num_tasks)
        elif Xtest is not None:
            self.Xtest = gridutils.prepare_test_data(
                Xtest, precision=self._prec_str)
            self.fulldims = Xtest.shape[1:] + (self.num_tasks,)
        if kwargs.get("verbose") is not None:
            self.verbose = kwargs.get("verbose")
        if kwargs.get("num_batches") is not None:
            self.num_batches = kwargs.get("num_batches")
        if self.verbose:
            print('Calculating predictive mean and uncertainty...')
        nan_rows = np.isnan(self.Xtest).any(axis=1)
        # num_batches > 1 maps the reference's manual test-grid splitting
        # (vgpr.py:247-264) onto the chunk size
        nb = max(1, int(self.num_batches))
        target = -(-len(self.Xtest) // nb) if nb > 1 else _PREDICT_CHUNK
        chunk = min(dtypes.round_up(max(target, 1), 128),
                    dtypes.round_up(len(self.Xtest), 128))
        chunks, n_test = engine.chunk_rows(np.nan_to_num(self.Xtest), chunk)
        with self.timer.phase("predict", self.device):
            mean, var = self._predict_chunks(self._tensor(chunks))
            mean = mean.cpu().numpy()[:n_test]
            var = var.cpu().numpy()[:n_test]
        n_samples = kwargs.get("n_samples")
        if n_samples:
            # the reference's Monte-Carlo estimator of the same posterior
            rng = np.random.default_rng(0)
            samples = rng.normal(
                mean, np.sqrt(var), (int(n_samples),) + mean.shape)
            mean = samples.mean(0)
            var = samples.var(0)
        mean[nan_rows] = np.nan
        var[nan_rows] = np.nan
        sd = np.sqrt(var)
        if self.verbose:
            print("Done")
        return mean.reshape(self.fulldims), sd.reshape(self.fulldims)

    def _task_shard(self):
        """The correlated mode's share of this rank: its slice of the
        rotated tasks and the 'task' group (all tasks, no group, without a
        mesh)."""
        if self._mesh is None:
            return {}
        from gpim_tpu_torch.parallel import mesh as meshmod, multichip
        return {"tasks": multichip.task_slice(self.num_tasks, self._mesh),
                "group": meshmod.axis_group(self._mesh, "task")}

    def _predict_chunks(self, chunks):
        """Mean and variance (n_chunks * chunk, T) over the tiles
        ``chunks``: with a mesh, each rank computes its channels (or its
        share of the rotated tasks) on its rows of every tile, then both
        are gathered."""
        kw = dict(kernel=self.kernel_type)
        if self.independent and self._mesh is not None:
            from gpim_tpu_torch.parallel import multichip
            return multichip.predict_sharded(
                self.u, self._Xd, self._Yd, self._maskd, self._bounds(),
                self.jitter, chunks, self._mesh, **kw)
        if self.independent:
            return multi.predict_independent(
                self.u, self._Xd, self._Yd, self._maskd, self._bounds(),
                self.jitter, chunks, **kw)

        def predict(tiles):
            return multi.predict_correlated(
                self.u, self._Xd, self._Yd, self._bounds(), self.jitter,
                tiles, **kw, **self._task_shard())
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
        .npz in the layout gpim_tpu's vreconstructor writes; restore with
        load_model on a model of the same kernel, mode and task count."""
        flat = {("u_" + k): v.detach().cpu().numpy()
                for k, v in self.u.items()}
        flat.update({("b_" + k): np.asarray(v)
                     for k, v in self._bounds_np.items()})
        flat["kernel"] = np.asarray(self.kernel_type)
        flat["independent"] = np.asarray(bool(self.independent))
        np.savez(filename, **flat)

    def load_model(self, filename):
        """Restore hyperparameters saved by this class's or gpim_tpu's
        save_model, in this model's dtype and on its device."""
        data = np.load(filename if str(filename).endswith(".npz")
                       else str(filename) + ".npz", allow_pickle=False)
        u = {k[2:]: data[k] for k in data.files if k.startswith("u_")}
        if (str(data["kernel"]) != self.kernel_type
                or bool(data["independent"]) != bool(self.independent)
                or set(u) != set(self.u)
                or any(u[k].shape != tuple(self.u[k].shape) for k in u)):
            raise ValueError(
                "checkpoint was written by a different model configuration")
        self.u = convert.params_from_numpy(u, self.device, self.dtype)
        self._bounds_np = {k[2:]: np.asarray(data[k], _NP_DTYPE[self.dtype])
                           for k in data.files if k.startswith("b_")}
