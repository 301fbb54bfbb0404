"""
Masked-lattice SKI engine on tensors (counterpart of
``gpim_tpu/gpreg/mgrid_model.py``): the structured route of
``skreconstructor`` for NaN-masked data on the Cartesian data lattice,
which is what ``utils.get_sparse_grid`` gives.

With the inducing grid equal to the data grid the interpolation is a masked
identity, and the operator is A v = M . K_UU (M . v) + (noise + jitter) v:
per-dimension mode products and masks (:mod:`gpim_tpu_torch.ops.ski`), exact
in W, so off-lattice interpolation is never needed for such data.

Training is Adam on the SKI marginal likelihood of
:func:`ski.ski_mll_from_mvm`: split-preconditioned CG over the data and the
Rademacher probes, the SLQ log-determinant and trace-estimated gradients.
Each Adam step builds the d kernel factors once (d K1 launches on CUDA).
The preconditioner (the factored Kronecker eigen-root, :class:`ski.KronRoot`)
is rebuilt at the start of each training segment, whose length adapts to
the realized CG iterations, the schedule ``gpim_tpu`` runs
(mgrid_model.py:596-642): a segment of 2 steps first, then twice as long
(up to 10) while the last step needed at most 8 CG iterations, and
half as long (at least 2) when it needed 16 or more. The host reads one
value a segment for this.

Prediction on a Cartesian test grid uses exact per-dimension
cross-covariances and the Nystrom variance of the same eigen-root; scattered
test points go through the per-point cross rows in chunks of up to 4096.
At ``precond_rank`` 0 the predict-time solve is plain CG to its tolerance
and the variance LOVE's, from ``rank`` Lanczos steps on the masked operator
(:func:`ski.mgrid_solve_core`; ``gpim_tpu`` raises there).

``MaskedGridEngine.train(warm_start=True)`` is ``gpim_tpu``'s experimental
warm-started CG (off the public ``skreconstructor`` surface there as here):
within a segment each step's solve starts from the previous step's
solutions. ``train_memory_analysis`` gives ``gpim_tpu``'s analytic model of
the dominant buffers beside, on CUDA, the measured peak of a training run
(``gpim_tpu`` compiles its fused program and reads XLA's accounting).

Not carried from ``gpim_tpu``, each a TPU artefact: the 128-multiple pad
dodge (``pad_dodge``, ``GPIM_TPU_PAD_DODGE``) and its non-finite check, and
the fused whole-training device program (``_train_fused``, ``_FUSED_MAX_G``;
eager PyTorch has the one host segment loop with the same schedule).

With a mesh (``MaskedGridEngine(mesh=...)``, mgrid_model.py:135-253,
352-416 of ``gpim_tpu``), each rank holds a block of the first grid axis of
every G-sized vector (observations, mask, probes, the CG state): the mode
products reshard through two all-to-alls when the mesh's 'grid' size
divides the two leading grid axes (:func:`ski.kron_mvm_bf_sharded`), CG's
inner products and the likelihood's sums are all-reduced, and the
hyperparameters take the same steps on every rank. Prediction solves the
same way, gathers alpha, and shards the test grid's first axis (or the
scattered points' chunk rows) over 'grid'.
"""

import math

import numpy as np
import torch

from gpim_tpu_torch.gpreg import engine, ski_model
from gpim_tpu_torch.gpreg.multi import _constrain_task as _constrain
from gpim_tpu_torch.gpreg.ski_model import _kernel_params
from gpim_tpu_torch.ops import kron_exact, ski

__all__ = ["MaskedGridEngine", "detect_masked_lattice",
           "cartesian_axes_from_points"]

_PREDICT_CHUNK = 4096


# --------------------------------------------------------------------------
# host-side lattice detection (numpy)
# --------------------------------------------------------------------------

def _fit_uniform_axis(vals_2d, rtol=1e-6):
    """Given per-line coordinate samples (N, n_other) with NaNs, recover a
    uniform axis a + b*i by least squares over the observed lines; None if
    the observed coordinates are not uniform within tolerance."""
    N = vals_2d.shape[0]
    line_val = np.full(N, np.nan)
    for i in range(N):
        row = vals_2d[i]
        row = row[~np.isnan(row)]
        if len(row):
            if np.ptp(row) > rtol * (abs(row[0]) + 1.0):
                return None                    # not constant along the line
            line_val[i] = row[0]
    obs = ~np.isnan(line_val)
    if obs.sum() < 2:
        return None
    i_obs = np.nonzero(obs)[0]
    A = np.stack([np.ones(len(i_obs)), i_obs.astype(np.float64)], -1)
    coef, *_ = np.linalg.lstsq(A, line_val[obs], rcond=None)
    axis = coef[0] + coef[1] * np.arange(N)
    span = np.abs(axis).max() + 1.0
    if np.abs(axis[i_obs] - line_val[obs]).max() > rtol * span:
        return None
    if abs(coef[1]) < 1e-12:
        return None
    return axis


def detect_masked_lattice(X_raw, y_raw, rtol=1e-6):
    """If ``X_raw`` (d, *y.shape) is a (possibly NaN-masked) mgrid over
    uniform per-dim axes, the list of 1D axes; else None. Fully unmeasured
    grid lines take the fitted axis's coordinates."""
    X_raw = np.asarray(X_raw, np.float64)
    shape = np.shape(y_raw)
    d = len(shape)
    if X_raw.ndim != d + 1 or X_raw.shape != (d,) + tuple(shape):
        return None
    axes = []
    for k in range(d):
        vals = np.moveaxis(X_raw[k], k, 0).reshape(shape[k], -1)
        axis = _fit_uniform_axis(vals, rtol)
        if axis is None:
            return None
        axes.append(axis)
    return axes


def cartesian_axes_from_points(X_flat, dims, rtol=1e-6):
    """Per-dim axes if the (m, d) rows are the C-order flattening of a
    Cartesian product over ``dims`` with uniform axes; else None."""
    axes = kron_exact.detect_cartesian(np.asarray(X_flat, np.float64), dims,
                                       rtol)
    if axes is None:
        return None
    for ax in axes:
        if len(ax) > 1 and np.ptp(np.diff(ax)) > rtol * (np.abs(ax).max()
                                                         + 1.0):
            return None
    return axes


# --------------------------------------------------------------------------
# loss, preconditioner, prediction
# --------------------------------------------------------------------------

def _loss(u, axes, mask_flat, g0, Qp, lam_n, y_flat, bounds, jitter, *,
          kernel, grid_shape, cg_iters, record_iters=False, X0=None,
          shard=None):
    """The masked-lattice MAP objective (gpim_tpu mgrid_model.py:134-169):
    :func:`ski_model._loss` over the masked operator and all G cells, whose
    masked cells are noise-only rows as padded rows are there; with
    ``record_iters`` also the realized CG iterations. With ``X0`` the
    warm-started objective (mgrid_model.py:190-218): the solve starts from
    the split-space block ``X0`` and, with ``record_iters``, the second
    output is (the solutions, the realized CG iterations). With a
    :class:`ski.GridShard`, the G-sized arguments are this rank's blocks."""
    mvm = ski.make_masked_grid_mvm(grid_shape, mask_flat, batch_first=True,
                                   shard=shard)
    group = None if shard is None else shard.group
    if X0 is None:
        core = ski.ski_mll_from_mvm(mvm, cg_iters, g0, return_iters=True,
                                    group=group)
    else:
        core_ws = ski.ski_mll_from_mvm(mvm, cg_iters, g0, warm_start=True,
                                       group=group)
        core = lambda *args: core_ws(*args, X0)  # noqa: E731
    return ski_model._loss(u, axes, core, Qp, lam_n, y_flat, mask_flat,
                           bounds, jitter, kernel=kernel,
                           record_iters=record_iters, shard=shard)


@torch.no_grad()
def _build_precond(u, axes, mask_flat, bounds, *, kernel, rank, shard=None):
    """The preconditioner's orthonormal Nystrom form (Q, lam_n): the
    factored :class:`ski.KronRoot`, noise-independent and fixed for a
    training segment; rank 0 gives an empty dense basis."""
    if rank == 0:
        return mask_flat.new_zeros((mask_flat.shape[0], 0)), \
            mask_flat.new_zeros((0,))
    p = _constrain(u, bounds)
    factors = ski.grid_kernel_factors(kernel, _kernel_params(p), axes)
    Qp, lam_n, _, _ = ski.mgrid_split_root(factors, mask_flat, rank,
                                           shard=shard)
    return Qp, lam_n


@torch.no_grad()
def _predict_grid(u, axes, mask_flat, y_flat, t_axes, bounds, jitter, *,
                  kernel, grid_shape, cg_iters, precond_rank, shard=None,
                  rank=0, seed=0, record=None):
    """A Cartesian test grid of per-dim axes ``t_axes``: the cross factors
    for the mean and the Nystrom or (at ``precond_rank`` 0) LOVE variance
    (:func:`ski.make_grid_predictor`); ``record`` (a dict) receives the
    solve's realized CG iterations."""
    predictor = ski.make_grid_predictor(kernel, axes, grid_shape, cg_iters,
                                        precond_rank, shard, rank, seed)
    p = _constrain(u, bounds)
    mean, var = predictor(_kernel_params(p), p["noise"] + jitter, mask_flat,
                          (y_flat - p["mean"]) * mask_flat, t_axes,
                          p["variance"])
    if record is not None:
        record["cg_iters"] = predictor.cg_iters
    return mean + p["mean"], var + p["noise"]   # noiseless=False semantics


@torch.no_grad()
def _predict_points(u, axes, mask_flat, y_flat, Xt_chunks, bounds, jitter, *,
                    kernel, grid_shape, cg_iters, precond_rank, shard=None,
                    rank=0, seed=0, record=None):
    """Scattered test points: per-point Kronecker cross rows contracted
    mode by mode for the mean, the Nystrom extension (or, at
    ``precond_rank`` 0, the LOVE variance of ``rank`` Lanczos steps) for
    the variance, one chunk at a time (d K1 launches a chunk); ``record``
    as in :func:`_predict_grid`."""
    p = _constrain(u, bounds)
    kp = _kernel_params(p)
    sol = ski.mgrid_solve_core(
        kernel, kp, axes, grid_shape, mask_flat, precond_rank, cg_iters,
        p["noise"] + jitter, (y_flat - p["mean"]) * mask_flat, shard, rank,
        seed)
    if record is not None:
        record["cg_iters"] = sol.cg_iters
    d = len(axes)
    means, variances = [], []
    for xc in Xt_chunks:
        E = ski.grid_cross_factors(kernel, kp, axes,
                                   [xc[:, k] for k in range(d)])
        T = torch.einsum("bi,i...->b...", E[0], sol.am)
        for k in range(1, d):
            T = torch.einsum("bi,bi...->b...", E[k], T)
        means.append(T)
        if sol.T is not None:
            variances.append(ski.points_love_var(
                E, sol.MQ, sol.T, p["variance"]).clamp_min(0.0))
            continue
        B = E[0] @ sol.sel[0]
        for k in range(1, d):
            B = B * (E[k] @ sol.sel[k])
        H = B @ sol.Bmat
        variances.append((p["variance"] - H.square().sum(1)).clamp_min(0.0))
    return (torch.cat(means) + p["mean"],
            torch.cat(variances) + p["noise"])


class MaskedGridEngine:
    """The axes, mask, observations and probes of one lattice dataset.

    ``axes``: the per-dim lattice coordinates (numpy); ``mask_grid`` and
    ``y_grid`` shaped like the lattice (NaNs in ``y_grid`` are ignored
    where ``mask_grid`` is False). The probes are
    ``numpy.random.default_rng(seed).choice([-1, 1], (n_probes, G))``, the
    draw ``gpim_tpu`` makes, so one seed gives both packages the same
    probes. ``precond_rank`` None means 1024 at 500k cells or more, else
    512 (a larger eigenspace costs little per CG iteration on the factored
    basis and saves iterations at scale). ``rank``, capped at G, is the
    depth of the Lanczos factorisation of the LOVE variance at
    ``precond_rank`` 0, started from JAX's Rademacher draw for ``seed``.

    With a ``mesh`` (its 'grid' axis of n ranks), this rank keeps its block
    of the first grid axis of the mask, the observations and the probes;
    over more than one rank, n must divide the two leading grid axes.
    """

    def __init__(self, kernel, axes, mask_grid, y_grid, dtype, device, *,
                 cg_iters=64, n_probes=8, precond_rank=None, seed=0,
                 mesh=None, rank=100):
        self.kernel = kernel
        self.dtype = dtype
        self.device = device
        np_dtype = np.float32 if dtype == torch.float32 else np.float64
        self.axes_np = [np.asarray(a, np_dtype) for a in axes]
        self.grid_shape = tuple(len(a) for a in self.axes_np)
        t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)  # noqa
        self._axes = [t(a) for a in self.axes_np]
        G = math.prod(self.grid_shape)
        mask_flat = np.asarray(mask_grid, np_dtype).reshape(-1)
        self._mask = t(mask_flat)
        self._y = t(np.nan_to_num(np.asarray(y_grid, np_dtype)).reshape(-1))
        self.cg_iters = int(min(cg_iters, G))
        if precond_rank is None:
            precond_rank = 1024 if G >= 500_000 else 512
        self.precond_rank = int(min(precond_rank, G))
        self.rank = int(min(rank, G))
        self.seed = seed
        rng = np.random.default_rng(seed)
        pm1 = np.asarray([-1.0, 1.0], np_dtype)
        # probes of the split operator, batch-first (a probe per row)
        self._g0 = t(rng.choice(pm1, size=(n_probes, G)))
        self.mesh, self._shard = mesh, None
        if mesh is not None:
            self._shard = self._take_block(mesh)
        # the realized CG iterations of every step and the segment lengths
        # of the last train() (the adaptive schedule's record), and the
        # realized CG iterations of the last predict()'s solve
        self.last_cg_iters = np.zeros((0,), np_dtype)
        self.last_segments = []
        self.last_predict_cg_iters = None

    def _take_block(self, mesh):
        """Keep this rank's block of the mask, observations and probes;
        returns its :class:`ski.GridShard`."""
        from gpim_tpu_torch.parallel import mesh as meshmod
        n = meshmod.axis_size(mesh, "grid")
        if n > 1 and not ski.kron_shardable(self.grid_shape, n):
            raise ValueError(
                "the masked-lattice route shards its first grid axis: the "
                "%d-rank 'grid' mesh axis must divide the two leading grid "
                "axes %s" % (n, self.grid_shape[:2]))
        rows = self.grid_shape[0] // n
        r = meshmod.axis_rank(mesh, "grid")
        cells = slice(r * self._mask.shape[0] // n,
                      (r + 1) * self._mask.shape[0] // n)
        self._mask = self._mask[cells].contiguous()
        self._y = self._y[cells].contiguous()
        self._g0 = self._g0[:, cells].contiguous()
        return ski.GridShard(meshmod.axis_group(mesh, "grid"), n, r * rows,
                             rows)

    def train(self, u0, bounds, lr, jitter, *, iterations,
              record_cg_iters=False, warm_start=False):
        """Adam on the masked-lattice objective with the adaptive rebuild
        schedule; returns (final u, trajectory of lengthscale (iters, d),
        noise and loss (iters,)[, cg_iters (iters,)]). The Adam moments
        carry across segments; the trajectory holds the post-update
        hyperparameters and the pre-update loss of every step.

        ``warm_start`` (experimental): each step's CG starts from the
        previous step's split-space solutions, from zeros at each segment's
        start (where the preconditioner is rebuilt); the gradients are the
        cold ones up to the CG tolerance, the recorded loss's
        log-determinant is biased (:func:`ski.ski_mll_from_mvm`)."""
        kw = dict(kernel=self.kernel, grid_shape=self.grid_shape,
                  cg_iters=self.cg_iters, record_iters=True,
                  shard=self._shard)
        build = lambda u: _build_precond(  # noqa: E731
            u, self._axes, self._mask, bounds, kernel=self.kernel,
            rank=self.precond_rank, shard=self._shard)
        if warm_start:
            def loss_iters(u, pre, X):
                loss, (X_new, it) = _loss(u, self._axes, self._mask,
                                          self._g0, *pre, self._y, bounds,
                                          jitter, X0=X, **kw)
                return loss, it, X_new
            carry0 = lambda: self._g0.new_zeros(  # noqa: E731
                (self._g0.shape[0] + 1, self._g0.shape[1]))
        else:
            def loss_iters(u, pre):
                return _loss(u, self._axes, self._mask, self._g0, *pre,
                             self._y, bounds, jitter, **kw)
            carry0 = None
        u, u_traj, losses, its, segments = engine.adam_segments(
            u0, lr, int(iterations), build, loss_iters, carry0)
        with torch.no_grad():
            p = _constrain(u_traj, bounds)
        traj = {"lengthscale": p["lengthscale"], "noise": p["noise"],
                "loss": losses}
        self.last_cg_iters = its.cpu().numpy()
        self.last_segments = segments
        if record_cg_iters:
            traj["cg_iters"] = its
        return u, traj

    def train_memory_analysis(self, u0, bounds, lr, jitter, *,
                              iterations=30):
        """Memory accounting of training at this engine's shapes
        (gpim_tpu mgrid_model.py:501-548): the grid's sizes, the analytic
        model of the dominant buffers in bytes (the (p + 1, G) CG state
        four times, the probe block, the grid vectors, the factored
        preconditioner, the trajectory) and, on CUDA, the measured peak of
        the device's allocated bytes over a training run of ``iterations``
        steps (``peak_allocated_bytes``; ``allocated_before_bytes`` were
        held before it). Unlike ``gpim_tpu``'s, which compiles its fused
        program and never runs it, this executes the training (it resets
        the device's peak-memory statistics and this engine's
        ``last_cg_iters`` and ``last_segments``). On the CPU there is no
        device accounting: ``memory_analysis_error`` says so."""
        G = math.prod(self.grid_shape)
        p = int(self._g0.shape[0])
        isz = self._g0.element_size()
        out = {"G": G, "grid_shape": tuple(self.grid_shape),
               "rank": self.precond_rank, "n_probes": p, "itemsize": isz}
        out["analytic_bytes"] = {
            "cg_state_4x(p+1)G": 4 * (p + 1) * G * isz,
            "probe_block_pG": p * G * isz,
            "grid_vectors_y_mask": 2 * G * isz,
            "precond_factored_rr": (self.precond_rank ** 2 * isz
                                    + sum(len(a) * min(len(a), 4096) * isz
                                          for a in self.axes_np)),
            "trajectory_per_iter": (int(iterations)
                                    * (2 + len(self.axes_np)) * isz),
        }
        dev = torch.device(self.device)
        if dev.type != "cuda":
            out["memory_analysis_error"] = (
                "no device memory accounting on %s" % dev.type)
            return out
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        out["allocated_before_bytes"] = torch.cuda.memory_allocated(dev)
        self.train(u0, bounds, lr, jitter, iterations=int(iterations))
        torch.cuda.synchronize(dev)
        out["peak_allocated_bytes"] = torch.cuda.max_memory_allocated(dev)
        return out

    def predict(self, u, bounds, jitter, Xtest_clean, fulldims):
        """Predictive mean and variance (tensors) at the NaN-free test points
        ``Xtest_clean`` (numpy (n_test, d)): through the cross factors when
        the points are a Cartesian grid of shape ``fulldims``, else by the
        scattered-point path in chunks of up to 4096. With the engine's
        mesh, each rank predicts its block of the test grid's first axis
        (or its rows of every chunk) and the blocks are gathered."""
        t_axes = None
        if fulldims is not None and len(fulldims) == len(self.grid_shape) \
                and len(Xtest_clean) == math.prod(fulldims):
            t_axes = cartesian_axes_from_points(Xtest_clean, fulldims)
        record = {}
        kw = dict(kernel=self.kernel, grid_shape=self.grid_shape,
                  cg_iters=self.cg_iters, precond_rank=self.precond_rank,
                  shard=self._shard, rank=self.rank, seed=self.seed,
                  record=record)
        t = lambda a: torch.as_tensor(  # noqa: E731
            np.asarray(a), dtype=self.dtype, device=self.device)
        if t_axes is not None:
            t_axes = [t(a) for a in t_axes]
            if self.mesh is None:
                out = _predict_grid(u, self._axes, self._mask, self._y,
                                    t_axes, bounds, jitter, **kw)
            else:
                out = self._predict_grid_sharded(u, t_axes, bounds, jitter,
                                                 kw)
            self.last_predict_cg_iters = int(record["cg_iters"])
            return out
        Xt = np.asarray(Xtest_clean)
        chunks, n_t = engine.chunk_rows(
            Xt, min(_PREDICT_CHUNK, max(128, len(Xt))))

        def predict(tiles):
            return _predict_points(u, self._axes, self._mask, self._y,
                                   tiles, bounds, jitter, **kw)
        if self.mesh is None:
            mean, var = predict(t(chunks))
        else:
            from gpim_tpu_torch.parallel.mesh import predict_rows
            mean, var = predict_rows(predict, t(chunks), self.mesh)
        self.last_predict_cg_iters = int(record["cg_iters"])
        return mean[:n_t], var[:n_t]

    def _predict_grid_sharded(self, u, t_axes, bounds, jitter, kw):
        """The Cartesian test grid's first axis in blocks over 'grid'
        (:func:`~gpim_tpu_torch.parallel.mesh.shard_gather`), then
        gathered."""
        from gpim_tpu_torch.parallel.mesh import shard_gather
        return shard_gather(
            lambda block: _predict_grid(u, self._axes, self._mask, self._y,
                                        [block] + t_axes[1:], bounds,
                                        jitter, **kw),
            t_axes[0], self.mesh)
