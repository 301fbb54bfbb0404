"""
Acquisition functions, evaluated batched over the entire prediction grid
(counterpart of ``gpim_tpu/gpbayes/acqfunc.py``).

Parity with reference gpim/gpbayes/acqfunc.py:11-92 (confidence bound,
expected improvement, probability of improvement), with one deliberate fix:
the reference's ``probability_of_improvement`` forgets to unpack the
``predict()`` tuple and takes ``nanmax`` over (mean, sd) jointly
(acqfunc.py:86-88); here the mean is unpacked correctly, as in its own EI.

The GP prediction underneath runs on the model's device; the closed-form
acquisition on top is host numpy, as the surrogate's ``predict`` returns
numpy. The boptimizer's fused step computes the same three functions on
tensors instead (``boptim._acquisition``).
"""

import numpy as np
from scipy.stats import norm

from gpim_tpu_torch.native.spatial import spaced_batch

__all__ = [
    "confidence_bound", "expected_improvement", "probability_of_improvement",
    "rank_acquisition", "top_candidates",
]


def confidence_bound(gpmodel, X_full, **kwargs):
    """alpha * mu + beta * sigma over the full grid.

    Returns (acquisition values, (mean, sd)).
    """
    alpha = kwargs.get("alpha", 0)
    beta = kwargs.get("beta", 1)
    mean, sd = gpmodel.predict(X_full, verbose=0)
    acq = alpha * mean + beta * sd
    return acq, (mean, sd)


def _best_observed_mean(mean, X_sparse, gpmodel=None):
    """max of the predictive mean over the *observed* grid points.

    The reference computes this with a second full ``predict(X_sparse)``
    (acqfunc.py:56-57): but the sparse grid IS the full grid with NaN rows,
    and predict's NaN rows propagate to NaN outputs - so the second predict
    returns exactly ``mean`` masked to observed points. Masking on the host
    gives the same values with one predict instead of two.
    """
    Xs = np.asarray(X_sparse)
    c = Xs.shape[0]
    nan_rows = np.isnan(Xs.reshape(c, -1)).any(0)
    if nan_rows.size != mean.size:
        # super-resolved full grid (dense_x < 1): the grids genuinely
        # differ, fall back to the reference's second predict
        mean_sample, _ = gpmodel.predict(X_sparse, verbose=0)
        return np.nanmax(mean_sample)
    return np.nanmax(np.where(nan_rows.reshape(mean.shape), np.nan, mean))


def expected_improvement(gpmodel, X_full, X_sparse, **kwargs):
    """EI with exploration constant xi against the best observed-grid mean."""
    xi = kwargs.get("xi", 0.01)
    mean, sd = gpmodel.predict(X_full, verbose=0)
    mean_sample_opt = _best_observed_mean(mean, X_sparse, gpmodel)
    imp = mean - mean_sample_opt - xi
    with np.errstate(divide="ignore", invalid="ignore"):
        z = imp / sd
        acq = imp * norm.cdf(z) + sd * norm.pdf(z)
    return acq, (mean, sd)


def probability_of_improvement(gpmodel, X_full, X_sparse, **kwargs):
    """POI with exploration constant xi (reference bug fixed: mean
    unpacked)."""
    xi = kwargs.get("xi", 0.01)
    mean, sd = gpmodel.predict(X_full, verbose=0)
    mean_sample_opt = _best_observed_mean(mean, X_sparse, gpmodel)
    with np.errstate(divide="ignore", invalid="ignore"):
        z = (mean - mean_sample_opt - xi) / sd
        acq = norm.cdf(z)
    return acq, (mean, sd)


def top_candidates(acq, batch_size):
    """The ``batch_size`` largest acquisition values, descending, and their
    grid indices (as lists, the layout boptimizer.next_point returns)."""
    order = np.argsort(acq.ravel())[::-1][:batch_size]
    vals = acq.ravel()[order].tolist()
    inds = np.stack(np.unravel_index(order, acq.shape), axis=-1).tolist()
    return vals, inds


def rank_acquisition(mean, sd, acquisition_function=None,
                     batch_size=100, batch_update=False, lscale=None):
    """Rank grid points by acquisition value; optionally space a batch by a
    lengthscale-scaled exclusion radius.

    This realizes the contract of the reference's missing
    ``gprutils.acquisition`` used by reconstructor.step (gpr.py:326-328).
    Returns (values, indices) for the top point(s).
    """
    acq = sd if acquisition_function is None \
        else acquisition_function(mean, sd)
    vals, inds = top_candidates(acq, batch_size)
    if not batch_update:
        return vals, inds
    # explicit None test: lscale == 0.0 is a legitimate "no spacing" radius
    keep = spaced_batch(np.asarray(inds, np.float64),
                        1.0 if lscale is None else lscale)
    vals = [vals[i] for i in keep]
    inds = [inds[i] for i in keep]
    return vals, inds
