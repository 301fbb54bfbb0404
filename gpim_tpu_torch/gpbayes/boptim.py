"""
GP-based Bayesian optimization loop for automated experiments (counterpart
of ``gpim_tpu/gpbayes/boptim.py``).

Behavioral parity with reference gpim/gpbayes/boptim.py:22-485: the same
exploration-exploitation loop around a GP surrogate -
train surrogate -> evaluate acquisition over the full grid -> select next
point(s) under revisit-avoidance / gamma-decayed distance-memory constraints
-> evaluate the target (real instrument callback, simulated lookup, or
analytic function) -> update the posterior -> checkpoint.

The surrogate is the port's ``reconstructor``, on the CUDA device unless the
caller passes ``use_gpu=False``. The outer loop, the distance suppression
and the memory filters are host-side control logic, as in the reference.

For the named acquisition functions each step runs ``_device_bo_step``:
retrain -> dense predict -> acquisition as one function on tensors; the
step ranks its output on the device (``_top_k``) and reads back only the
top-k candidates and the final lengthscale. The full-grid mean/sd and the
hyperparameter trajectory stay on the device until a save or the end of
``run``. Simulated measurements take the same step: the JAX package's
device-resident explore loop (``device_loop``) exists there to run the
whole loop as one compiled scan with a single fetch; in eager PyTorch it
would be the same Python loop with the same synchronisations, so
``device_loop`` is accepted and ignored.

Ranking keeps equal acquisition values in ascending flat-index order, as
``jax.lax.top_k`` and ``jnp.argmax`` do.
"""

import math
import os
import types

import numpy as np
import torch

from gpim_tpu_torch import convert, dtypes
from gpim_tpu_torch.gpbayes import acqfunc
from gpim_tpu_torch.gpreg import engine, gpr
from gpim_tpu_torch.native import spatial
from gpim_tpu_torch.utils import gridutils

__all__ = ["boptimizer"]

_INV_SQRT_2PI = 1.0 / math.sqrt(2.0 * math.pi)


def _acquisition(mean, sd, obs, acq_kind, alpha, beta, xi):
    """CB, EI or POI over the flat grid; ``obs`` (bool) marks the observed
    points whose best mean is the EI/POI incumbent."""
    if acq_kind == "cb":
        return alpha * mean + beta * sd
    best = mean.masked_fill(~obs, -math.inf).max()
    imp = mean - best - xi
    z = imp / sd
    if acq_kind == "ei":
        pdf = _INV_SQRT_2PI * torch.exp(-0.5 * z * z)
        return imp * torch.special.ndtr(z) + sd * pdf
    return torch.special.ndtr(z)


def _select(acq, sel_mask):
    """The acquisition under the selection mask (reference
    boptim.py:303-315: acq times the mask, NaNs dropped from the ranking):
    masked-out, padded and NaN points become -inf."""
    macq = sel_mask * acq
    return macq.masked_fill(torch.isnan(macq) | (sel_mask == 0), -math.inf)


def _top_k(macq, k):
    """The ``k`` largest values and their flat indices, equal values in
    ascending index order. ``torch.topk`` leaves the order of ties open on
    CUDA, and far from the data many grid points share one f32 sd."""
    neg, order = torch.sort(-macq, stable=True)
    return -neg[:k], order[:k]


def _device_bo_step(m, u0, lr, iterations, chunks, obs_mask, sel_mask,
                    alpha, beta, xi, acq_kind):
    """One retrain -> predict -> acquisition step of the surrogate ``m`` on
    tensors (through its mesh, when it has one).

    ``sel_mask`` folds the user's acquisition mask together with the
    test-grid padding; ``obs_mask`` marks observed grid points for the
    EI/POI incumbent. Returns (u, trajectory, mean, sd, masked
    acquisition), all on the device.
    """
    u, traj = m._fit(u0, lr, iterations)
    mean, var = m._predict_chunks(u, chunks)
    sd = torch.sqrt(var)
    macq = _select(_acquisition(mean, sd, obs_mask, acq_kind, alpha, beta,
                                xi), sel_mask)
    return u, traj, mean, sd, macq


def _surrogate_precision(precision):
    """The surrogate's precision: ``precision`` when the caller gives one,
    else "double" on every device. The reference GPim trains in float64
    (gpr.py:92-99); ``gpim_tpu`` defaults to single on its accelerator only
    because float64 is emulated and slow on a TPU, which the card does not
    do. In float32 a BO seeded with the 128x128 spiral scan fails a refit's
    Cholesky (n = 6144): once EI measures inside the scan's gaps, noise +
    jitter fall below the float32 factorisation's round-off."""
    return "double" if precision is None else precision


def _atomic_save(filename, obj, allow_pickle=False):
    """np.save via temp-file + os.replace: a crash mid-write must never
    truncate the only resume state of a long-running experiment."""
    tmp = str(filename) + ".tmp"
    with open(tmp, "wb") as f:
        np.save(f, obj, allow_pickle=allow_pickle)
    os.replace(tmp, str(filename))


class boptimizer:
    """Bayesian optimizer selecting next measurement point(s) on a grid.

    Constructor signature and kwargs mirror reference boptim.py:167-237:
    X_seed/y_seed (sparse seed with NaNs), X_full (dense grid),
    target_function, acquisition_function ('cb'|'ei'|'poi'|callable),
    exploration_steps, batch_size, batch_update, kernel, lengthscale,
    sparse/indpoints, gp_iterations, seed, and kwargs: alpha, beta, xi,
    use_gpu (default True: the surrogate runs on the CUDA device and raises
    without one; False: the CPU), precision (None: "double" on every
    device, see :func:`_surrogate_precision`), jitter, isotropic, mask,
    dscale, batch_dscale, batch_out_max, gamma, memory, exit_strategy,
    extent, simulate_measurement, y_true, save_checkpoints, filename,
    verbose, learning_rate, device_loop (accepted for gpim_tpu's
    signature and ignored: simulated runs take the device step),
    refit_iterations (per-step retrain budget AFTER the first full
    ``gp_iterations`` train; defaults to gp_iterations // 4. Each step's
    retrain continues from the previous step's parameters; pass
    refit_iterations=gp_iterations to reproduce the reference's
    full-budget retrain, boptim.py:459-470), mesh (forwarded to the
    surrogate: its retrain and the full-grid prediction of every step shard
    over the mesh's 'grid' axis, see :class:`gpr.reconstructor`).
    """

    def __init__(self,
                 X_seed,
                 y_seed,
                 X_full,
                 target_function,
                 acquisition_function='cb',
                 exploration_steps=10,
                 batch_size=100,
                 batch_update=False,
                 kernel='RBF',
                 lengthscale=None,
                 sparse=False,
                 indpoints=None,
                 gp_iterations=1000,
                 seed=0,
                 **kwargs):
        self.verbose = kwargs.get("verbose", 1)
        self.precision = _surrogate_precision(kwargs.get("precision"))

        # the reference passes use_gpu=False positionally here and the JAX
        # package ignores it; the port honours it, so it defaults to the card
        self.surrogate_model = gpr.reconstructor(
            X_seed, y_seed, X_full, kernel, lengthscale, sparse, indpoints,
            learning_rate=kwargs.get("learning_rate", 5e-2),
            iterations=gp_iterations, use_gpu=kwargs.get("use_gpu", True),
            verbose=self.verbose, seed=seed,
            isotropic=kwargs.get("isotropic", False),
            precision=self.precision, jitter=kwargs.get("jitter", 1.0e-6),
            mesh=kwargs.get("mesh"))

        self.X_sparse = X_seed.copy()
        self.y_sparse = y_seed.copy()
        self.X_full = X_full

        self.target_function = target_function
        self.acquisition_function = acquisition_function
        self.exploration_steps = exploration_steps
        self.batch_update = batch_update
        self.batch_size = batch_size
        self.simulate_measurement = kwargs.get("simulate_measurement", False)
        if self.simulate_measurement:
            self.y_true = kwargs.get("y_true")
            if self.y_true is None:
                raise AssertionError(
                    "To simulate measurements, add ground truth ('y_true)")
        self.extent = kwargs.get("extent", None)
        self.alpha = kwargs.get("alpha", 0)
        self.beta = kwargs.get("beta", 1)
        self.xi = kwargs.get("xi", 0.01)
        self.dscale = kwargs.get("dscale", None)
        self.batch_dscale = kwargs.get("batch_dscale", None)
        self.batch_out_max = kwargs.get("batch_out_max", 10)
        self.gamma = kwargs.get("gamma", 0.8)
        self.points_mem = kwargs.get("memory", 10)
        self.exit_strategy = kwargs.get("exit_strategy", 1)
        self.mask = kwargs.get("mask", None)
        refit = kwargs.get("refit_iterations")
        self.refit_iterations = (max(1, int(gp_iterations) // 4)
                                 if refit is None else int(refit))
        self.save_checkpoints = kwargs.get("save_checkpoints", False)
        self.filename = kwargs.get("filename", "./boptim_results")
        self._rng = np.random.RandomState(seed)
        self.indices_all, self.vals_all = [], []
        self.target_func_vals, self.gp_predictions = [y_seed.copy()], []
        self.steps_done = 0

        # the device step's static inputs, uploaded once: the test grid in
        # prediction chunks and the selection mask over the flat grid
        self._fulldims = X_full.shape[1:]
        m = self.surrogate_model
        Xt = m.Xtest                       # prepared (n, d), NaN-free grid
        self._n_test = len(Xt)
        chunk = min(4096, dtypes.round_up(self._n_test, 128))
        chunks, _ = engine.chunk_rows(np.nan_to_num(Xt), chunk)
        self._chunks_d = m._tensor(chunks)
        n_flat = int(np.prod(chunks.shape[:2]))
        sel = np.zeros(n_flat, chunks.dtype)
        if self.mask is None:
            sel[:self._n_test] = 1.0
        else:
            sel[:self._n_test] = np.asarray(
                self.mask, chunks.dtype).ravel()[:self._n_test]
        self._sel_mask_d = m._tensor(sel)
        self._n_flat = n_flat

    # ------------------------------------------------------------------

    def update_posterior(self):
        """Swap in the grown training set and retrain the surrogate,
        warm-starting from the current parameters with the (reduced)
        per-step budget (reference boptim.py:239-251)."""
        self.surrogate_model.update_data(self.X_sparse, self.y_sparse)
        self.surrogate_model.train(verbose=self.verbose,
                                   iterations=self.refit_iterations)

    def evaluate_function(self, indices, y_measured=None):
        """Evaluate the target at the selected grid indices
        (simulated lookup / measured array / instrument callback with
        optional extent offsetting, reference boptim.py:253-276)."""
        indices = [indices] if not self.batch_update else indices
        if self.simulate_measurement:
            for idx in indices:
                self.y_sparse[tuple(idx)] = self.y_true[tuple(idx)]
        elif y_measured is not None:
            for idx in indices:
                self.y_sparse[tuple(idx)] = y_measured[tuple(idx)]
        else:
            for idx in indices:
                if self.extent is not None:
                    _idx = tuple(i + e[0] for i, e in zip(idx, self.extent))
                else:
                    _idx = tuple(idx)
                self.y_sparse[tuple(idx)] = self.target_function(_idx)
        self.X_sparse = gridutils.get_sparse_grid(self.y_sparse, self.extent)
        self.target_func_vals.append(self.y_sparse.copy())

    def next_point(self):
        """Acquisition evaluation over the full grid and candidate ranking
        (reference boptim.py:278-324, incl. NaN-mask support)."""
        if self.verbose:
            print("Computing acquisition function...")
        if self.acquisition_function == 'cb':
            acq, pred = acqfunc.confidence_bound(
                self.surrogate_model, self.X_full,
                alpha=self.alpha, beta=self.beta)
        elif self.acquisition_function == 'ei':
            acq, pred = acqfunc.expected_improvement(
                self.surrogate_model, self.X_full,
                self.X_sparse, xi=self.xi)
        elif self.acquisition_function == 'poi':
            acq, pred = acqfunc.probability_of_improvement(
                self.surrogate_model, self.X_full,
                self.X_sparse, xi=self.xi)
        elif isinstance(self.acquisition_function, types.FunctionType):
            acq, pred = self.acquisition_function(
                self.surrogate_model, self.X_full, self.X_sparse)
        else:
            raise NotImplementedError(
                "Choose between 'cb', 'ei', and 'poi' acquisition functions "
                "or define your own")
        self.gp_predictions.append(pred)
        if self.mask is None:
            vals_list, indices_list = acqfunc.top_candidates(
                acq, self.batch_size)
        else:
            macq = (self.mask * acq).ravel()
            order = np.argsort(macq)[::-1]
            vals = macq[order]
            valid = ~np.isnan(vals)
            order, vals = order[valid], vals[valid]
            vals_list = vals[:self.batch_size].tolist()
            indices_list = np.stack(
                np.unravel_index(order[:self.batch_size], acq.shape),
                axis=-1).tolist()
        if not self.batch_update:
            return vals_list, indices_list
        if self.batch_dscale is None:
            ls_traj = self.surrogate_model.hyperparams.get("lengthscale")
            if ls_traj is not None and len(ls_traj):
                batch_dscale_ = float(np.mean(ls_traj[-1]))
            else:
                # no trajectory yet (e.g. a run resumed from a checkpoint,
                # which restores parameters but not the training history):
                # read the lengthscale off the current surrogate parameters
                batch_dscale_ = float(np.mean(
                    self.surrogate_model.current_lengthscale()))
        else:
            batch_dscale_ = self.batch_dscale
        return self.update_points(vals_list, indices_list, batch_dscale_)

    def _fused_ok(self):
        """The device step covers the three named acquisition functions on
        a standard (non-super-resolved) full grid; custom callables and
        mismatched grids take the host path."""
        return (self.acquisition_function in ("cb", "ei", "poi")
                and self._n_test == int(np.prod(np.shape(self.y_sparse))))

    def _fused_step(self, iterations):
        """Retrain + acquisition + top-k on the device, one small read
        back.

        Returns (vals_list, indices_list, mean_lengthscale) with the same
        candidate-ranking semantics as next_point (reference
        boptim.py:278-324); the dense mean/sd prediction is appended to
        gp_predictions as device tensors and materialized at save time.
        """
        m = self.surrogate_model
        obs = np.zeros(self._n_flat, bool)
        obs[:self._n_test] = ~np.isnan(
            np.asarray(self.y_sparse).ravel())
        u_new, traj, mean, sd, macq = _device_bo_step(
            m, m.u, float(m.learning_rate), int(iterations), self._chunks_d,
            torch.as_tensor(obs, device=m.device), self._sel_mask_d,
            float(self.alpha), float(self.beta), float(self.xi),
            self.acquisition_function)
        m.u = u_new
        m._traj_list.append(traj)          # on the device until assembled
        self.gp_predictions.append((mean, sd))
        top = _top_k(macq, min(self.batch_size, self._n_flat))
        vals, order, ls_last = (t.cpu().numpy() for t in (
            *top, traj["lengthscale"][-1]))
        valid = np.isfinite(vals)
        vals, order = vals[valid], order[valid]
        vals_list = vals.tolist()
        indices_list = np.stack(
            np.unravel_index(order, self._fulldims), axis=-1).tolist()
        return vals_list, indices_list, float(np.mean(ls_last))

    def _materialize(self):
        """Copy device-resident BO state to the host: gp_predictions become
        numpy (fulldims) arrays and the surrogate's trajectory segments are
        assembled into its hyperparams dict. Saved artefacts and
        checkpoints then hold numpy only."""
        dims, n = self._fulldims, self._n_test
        for i, pred in enumerate(self.gp_predictions):
            if isinstance(pred[0], torch.Tensor):
                self.gp_predictions[i] = tuple(
                    t[:n].cpu().numpy().reshape(dims) for t in pred)
        m = self.surrogate_model
        if any(isinstance(v, torch.Tensor)
               for t in m._traj_list for v in t.values()):
            m._traj_list = [{k: (v.cpu().numpy()
                                 if isinstance(v, torch.Tensor) else v)
                             for k, v in t.items()} for t in m._traj_list]
            m._assemble_hyperparams()

    def update_points(self, acqfunc_values, indices, dscale):
        """Lengthscale-spaced batch selection: greedy suppression of
        candidates within ``dscale`` of each accepted point, random fill-up
        to ``batch_out_max`` (reference boptim.py:326-376)."""
        ind, val = self.checkvalues(indices, acqfunc_values)
        start = int(np.where(np.asarray(acqfunc_values) == val)[0][0])
        vals = np.asarray(acqfunc_values)[start:]
        pts = np.vstack(indices)[start:]
        # candidates are already in descending acquisition order
        sel = spatial.spaced_batch(pts, dscale, self.batch_out_max)
        max_val_all = vals[sel].tolist()
        indices_ = pts[sel].tolist()
        if len(indices_) < self.batch_out_max:
            n_fill = self.batch_out_max - len(indices_)
            if self.verbose == 2:
                print("Adding {} random indices".format(n_fill))
            idx_random = self._rng.randint(0, len(vals), n_fill)
            indices_.extend(pts[idx_random].tolist())
            max_val_all.extend(vals[idx_random].tolist())
        return max_val_all, indices_

    def checkvalues(self, idx_list, val_list):
        """Revisit-avoidance + gamma-decayed short-term distance memory:
        skip candidates already measured or closer than dscale*gamma^i to the
        i-th most recent query (reference boptim.py:378-429)."""
        dscale_ = 0 if self.dscale is None else self.dscale

        def too_close(idx):
            idx_prev = self.indices_all[-self.points_mem:]
            d_all = [np.linalg.norm(np.asarray(idx) - np.asarray(i))
                     for i in idx_prev]
            thresholds = [dscale_ * self.gamma ** i
                          for i in range(len(idx_prev))]
            # most recent point gets the largest exclusion radius
            return any(d <= t for d, t in zip(d_all[::-1], thresholds))

        _idx = 0
        if self.verbose == 2:
            print('Acquisition function max value {} at {}'.format(
                val_list[_idx], idx_list[_idx]))
        if len(self.indices_all) == 0:
            return idx_list[_idx], val_list[_idx]
        while (idx_list[_idx] in self.indices_all
               or too_close(idx_list[_idx])):
            if self.verbose == 2:
                print("Finding the next max point...")
            _idx += 1
            if _idx == len(idx_list):
                _idx = (self._rng.randint(0, len(idx_list))
                        if self.exit_strategy else -1)
                if self.verbose == 2:
                    print('Index out of list. Exiting with acquisition '
                          'function value {} at {}'.format(
                              val_list[_idx], idx_list[_idx]))
                break
            if self.verbose == 2:
                print('Acquisition function max value {} at {}'.format(
                    val_list[_idx], idx_list[_idx]))
        return idx_list[_idx], val_list[_idx]

    # ------------------------------------------------------------------

    def single_step(self, e):
        """One explore-measure-update cycle (reference boptim.py:431-457).

        On the device step the posterior update for measurement e happens
        at the START of step e+1 (retrain -> acquire is one call) instead
        of at the end of step e - the same train-on-the-same-data schedule,
        moved across the step boundary; run() adds the reference's
        trailing post-measurement retrain.
        """
        if self.verbose:
            print("\nExploration step {} / {}".format(
                e + 1, self.exploration_steps))
        if self._fused_ok():
            iters = (self.surrogate_model.iterations if e == 0
                     else self.refit_iterations)
            self.surrogate_model.update_data(self.X_sparse, self.y_sparse)
            vals, inds, lscale = self._fused_step(iters)
            if self.batch_update:
                bd = (self.batch_dscale if self.batch_dscale is not None
                      else lscale)
                vals, inds = self.update_points(vals, inds, bd)
            else:
                inds, vals = self.checkvalues(inds, vals)
            self.evaluate_function(inds)
        else:
            if e == 0:
                self.surrogate_model.train()
            vals, inds = self.next_point()
            if not self.batch_update:
                inds, vals = self.checkvalues(inds, vals)
            self.evaluate_function(inds)
            self.update_posterior()
        if isinstance(vals, float):
            self.indices_all.append(inds)
            self.vals_all.append(vals)
        else:
            self.indices_all.extend(inds)
            self.vals_all.extend(vals)

    def run(self):
        """Run the exploration loop (resumable - continues from steps_done
        after load_checkpoint) with optional per-step checkpoints."""
        start = self.steps_done
        for i in range(self.steps_done, self.exploration_steps):
            self.single_step(i)
            self.steps_done = i + 1
            if self.save_checkpoints:
                self.save_results()
                self.save_checkpoint(self.filename + "_state")
        if self._fused_ok() and self.steps_done > start:
            # trailing posterior update: the reference loop retrains after
            # the LAST measurement too (boptim.py:449); the device step
            # deferred every other retrain into the next step. Called
            # through the engine so the surrogate's iterations stay as set.
            m = self.surrogate_model
            m.update_data(self.X_sparse, self.y_sparse)
            m.u, traj = m._fit(m.u, float(m.learning_rate),
                               int(self.refit_iterations))
            m._traj_list.append(traj)
        self.save_results()
        if self.verbose:
            print("\nExploration completed")

    # ------------------------------------------------------------------
    # resumable experiment state (the reference only np.saves result
    # artifacts and has no resume path - SURVEY.md section 5)
    # ------------------------------------------------------------------

    def save_checkpoint(self, filename):
        """Full resumable state: measurements, query history, RNG state and
        the surrogate's trained (unconstrained) hyperparameters; the layout
        of gpim_tpu's save_checkpoint, numpy only."""
        self._materialize()
        state = {
            "y_sparse": self.y_sparse,
            "indices_all": self.indices_all,
            "vals_all": self.vals_all,
            "target_func_vals": self.target_func_vals,
            "gp_predictions": self.gp_predictions,
            "steps_done": self.steps_done,
            "rng_state": self._rng.get_state(),
            "surrogate_u": {k: v.detach().cpu().numpy()
                            for k, v in self.surrogate_model.u.items()},
        }
        _atomic_save(str(filename) + ".npy", state, allow_pickle=True)

    def load_checkpoint(self, filename):
        """Restore state written by save_checkpoint (this class's or
        gpim_tpu's); run() then continues from the saved step."""
        fname = str(filename)
        if not fname.endswith(".npy"):
            fname += ".npy"
        state = np.load(fname, allow_pickle=True).item()
        self.y_sparse = state["y_sparse"]
        self.X_sparse = gridutils.get_sparse_grid(self.y_sparse, self.extent)
        self.indices_all = list(state["indices_all"])
        self.vals_all = list(state["vals_all"])
        self.target_func_vals = list(state["target_func_vals"])
        self.gp_predictions = list(state["gp_predictions"])
        self.steps_done = int(state["steps_done"])
        self._rng.set_state(state["rng_state"])
        m = self.surrogate_model
        m.u = convert.params_from_numpy(state["surrogate_u"], m.device,
                                        m.dtype)
        m.update_data(self.X_sparse, self.y_sparse)

    def save_results(self, *args):
        """np.save a dict of {gp_pred, func_val, inds_all, vals_all}
        (artifact-compatible with reference boptim.py:472-485)."""
        self._materialize()
        filename = args[0] if args else self.filename
        results = {
            'gp_pred': self.gp_predictions,
            'func_val': self.target_func_vals,
            'inds_all': np.array(self.indices_all),
            'vals_all': np.array(self.vals_all),
        }
        _atomic_save(filename + ".npy", results, allow_pickle=True)
