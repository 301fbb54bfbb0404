"""
Grid / data preparation utilities (host-side, numpy-in / numpy-out).

Behavioral parity with the reference's gpim/gprutils.py:23-382 (data prep,
grid generation, synthetic corruption, edge opening), with the following
deliberate fixes of reference defects (SURVEY.md section 2.4):

- ``get_full_grid`` with ``extent`` works for 3D/4D (reference unpacks mgrid
  into two names at gprutils.py:147-149,164-166 and crashes);
- ``get_grid_indices`` passes ``dense_x`` by keyword (reference passes it into
  the ``extent`` positional slot at gprutils.py:103);
- ``np.product`` (removed in numpy>=2) replaced by ``np.prod``.

A copy of ``gpim_tpu/utils/gridutils.py`` (pure numpy): importing any
``gpim_tpu`` module imports jax. All NaN masking happens on host before
the data reaches the device, so device tensors stay dense; the arrays here
are plain numpy.
"""

import numpy as np

__all__ = [
    "prepare_training_data", "prepare_test_data", "get_grid_indices",
    "get_full_grid", "get_sparse_grid", "to_constrained_interval",
    "corrupt_data_xy", "corrupt_image2d", "corrupt_image3d",
    "open_edge_points",
]


def _np_dtype(precision):
    return np.float32 if precision == "single" else np.float64


def prepare_training_data(X, y=None, vector_valued=False, **kwargs):
    """Flattens grid-index and observation arrays and drops NaN rows.

    Args:
        X: grid indices, shape (c, N, M[, L, ...]) with NaNs at missing points.
        y: observations, shape (N, M[, L, ...]) (or (..., d) when
           ``vector_valued=True``), NaNs at missing points.
        vector_valued: treat the last axis of ``y`` as output channels; rows
            with any NaN channel are dropped (reference gprutils.py:53-55).
        **precision: 'single' or 'double' (default 'double').

    Returns:
        (X, y) numpy arrays of shape (n, c) and (n,) (or (n, d)).
    """
    dtype = _np_dtype(kwargs.get("precision", "double"))
    X = X.reshape(X.shape[0], int(np.prod(X.shape[1:]))).T
    X = np.ascontiguousarray(X[~np.isnan(X).any(axis=1)], dtype=dtype)
    if y is None:
        return X, y
    if vector_valued:
        y = y.reshape(int(np.prod(y.shape[:-1])), y.shape[-1])
        y = np.ascontiguousarray(y[~np.isnan(y).any(axis=1)], dtype=dtype)
    else:
        y = y.flatten()
        y = np.ascontiguousarray(y[~np.isnan(y)], dtype=dtype)
    return X, y


def prepare_test_data(X, **kwargs):
    """Flattens a (c, N, M[, L, ...]) grid-index array to (n, c)."""
    dtype = _np_dtype(kwargs.get("precision", "double"))
    X = X.reshape(X.shape[0], int(np.prod(X.shape[1:]))).T
    return np.ascontiguousarray(X, dtype=dtype)


def get_grid_indices(R, dense_x=1.0):
    """Returns (full, sparse) grid indices for a 2D/3D measurement array."""
    if np.ndim(R) > 3:
        raise NotImplementedError("Currently supports only 2D and 3D arrays")
    X_full = get_full_grid(R, dense_x=np.float64(dense_x))
    X_sparse = get_sparse_grid(R)
    return X_full, X_sparse


def get_full_grid(R, extent=None, dense_x=1.0):
    """Creates dense grid indices for a 2D-4D array.

    Args:
        R: grid measurements (2D-4D array); only its shape is used.
        extent: per-dimension [min, max] bounds, e.g. [[xmin, xmax],
            [ymin, ymax]] for 2D data.
        dense_x: grid density; values < 1 produce a denser ("super-
            resolution") prediction grid (reference gprutils.py:108-172).

    Returns:
        Array of shape (ndim, *grid_shape).
    """
    dense_x = np.float64(dense_x)
    ndim = np.ndim(R)
    if not 2 <= ndim <= 4:
        raise NotImplementedError("Currently works only for 2D-4D sets")
    if extent:
        slices = []
        for e, (lo, hi) in zip(R.shape, extent):
            # e / dense_x points spanning [lo, hi). The reference's
            # dense_x / (e // span) (gprutils.py:131) equals this when span
            # divides e exactly, and divides by zero / yields wrong-size
            # axes otherwise; span * dense_x / e is robust for any extent.
            step = (hi - lo) * dense_x / e
            slices.append(slice(lo, hi, step))
    else:
        slices = [slice(0, e, dense_x) for e in R.shape]
    return np.asarray(np.mgrid[tuple(slices)])


def get_sparse_grid(R, extent=None):
    """Returns grid indices with NaNs at missing (NaN) measurement positions.

    Mirrors the xy- vs xyz-sparsity branching of the reference
    (gprutils.py:175-210): for 3D data whose last ("spectroscopic") axis is
    fully measured wherever (x, y) was visited, whole spectra are NaN-ed out
    per spatial pixel.
    """
    if not np.isnan(R).any():
        raise NotImplementedError(
            "Missing values in sparse data must be represented as NaNs")
    X = get_full_grid(R, extent).copy()
    c = X.shape[0]
    if np.ndim(R) == 2:
        flat = X.reshape(c, -1)
        flat[:, np.isnan(R.flatten())] = np.nan
    elif np.ndim(R) == 3 and not np.isnan(R[..., -1]).any():
        e1, e2, e3 = R.shape
        flat = X.reshape(c, e1 * e2, e3)
        rows = np.where(np.isnan(R.reshape(e1 * e2, e3)))[0]
        flat[:, rows] = np.nan
    else:
        # pointwise sparsity for 3D and above (the reference raises for
        # ndim > 3, gprutils.py:207-210, but its own 4D cKPFM workflow
        # needs exactly this generic branch)
        flat = X.reshape(c, -1)
        flat[:, np.isnan(R.flatten())] = np.nan
    return X


def to_constrained_interval(state_dict, lscale, amp):
    """Transforms unconstrained lengthscale/variance to their intervals.

    Accepts either a dict (or a callable returning a dict, as in the
    reference's ``kernel.state_dict`` usage, gprutils.py:213-241) holding
    unconstrained values under 'lengthscale_map_unconstrained' /
    'variance_map_unconstrained' (the reference misspells the former as
    'lenghtscale...'; both spellings are accepted here).
    """
    d = state_dict() if callable(state_dict) else dict(state_dict)
    l_u = d.get("lengthscale_map_unconstrained",
                d.get("lenghtscale_map_unconstrained"))
    a_u = d["variance_map_unconstrained"]

    def _sigmoid(v):
        v = np.asarray(v, dtype=np.float64)
        return 1.0 / (1.0 + np.exp(-v))

    lo_l, hi_l = np.asarray(lscale[0]), np.asarray(lscale[1])
    lo_a, hi_a = np.asarray(amp[0]), np.asarray(amp[1])
    l = lo_l + (hi_l - lo_l) * _sigmoid(l_u)
    a = lo_a + (hi_a - lo_a) * _sigmoid(a_u)
    return l, a


def corrupt_data_xy(X_true, R_true, prob=0.5, replace_w_zeros=False):
    """Replaces a fraction of 2D/3D data with NaNs (synthetic sparsity)."""
    if np.ndim(R_true) == 2:
        return corrupt_image2d(X_true, R_true, prob, replace_w_zeros)
    if np.ndim(R_true) == 3:
        return corrupt_image3d(X_true, R_true, prob, replace_w_zeros)
    raise NotImplementedError("Currently supports only 2D and 3D sets")


def corrupt_image2d(X_true, R_true, prob, replace_w_zeros):
    """Bernoulli(prob) removal of single pixels from a 2D image.

    Seeded removal mask (seed 0) for reproducibility, mirroring the
    reference's seeded pyro Bernoulli sampling (gprutils.py:299-301).
    """
    e1, e2 = R_true.shape
    if np.isnan(R_true).any():
        X = X_true.copy().reshape(2, e1 * e2)
        X[:, np.isnan(R_true.flatten())] = np.nan
        return X.reshape(2, e1, e2), R_true
    rng = np.random.default_rng(0)
    drop = rng.random(e1 * e2) < prob
    R = R_true.copy().reshape(e1 * e2)
    R[drop] = np.nan
    R = R.reshape(e1, e2)
    X = X_true.copy().reshape(2, e1 * e2)
    X[:, drop] = np.nan
    X = X.reshape(2, e1, e2)
    if replace_w_zeros:
        X, R = np.nan_to_num(X), np.nan_to_num(R)
    return X, R


def corrupt_image3d(X_true, R_true, prob, replace_w_zeros):
    """Bernoulli(prob) removal of whole spectra per (x, y) pixel of a cube."""
    e1, e2, e3 = R_true.shape
    if np.isnan(R_true).any():
        X = X_true.copy().reshape(3, e1 * e2, e3)
        rows = np.where(np.isnan(R_true.reshape(e1 * e2, e3)))[0]
        X[:, rows] = np.nan
        return X.reshape(3, e1, e2, e3), R_true
    rng = np.random.default_rng(0)
    drop = rng.random(e1 * e2) < prob
    R = R_true.copy().reshape(e1 * e2, e3)
    R[drop, :] = np.nan
    R = R.reshape(e1, e2, e3)
    X = X_true.copy().reshape(3, e1 * e2, e3)
    X[:, drop, :] = np.nan
    X = X.reshape(3, e1, e2, e3)
    if replace_w_zeros:
        X, R = np.nan_to_num(X), np.nan_to_num(R)
    return X, R


def open_edge_points(R, R_true, s=6):
    """Reveals ground-truth points along the field-of-view edges every s px."""
    e1, e2 = R_true.shape[:2]
    R[0, ::s] = R_true[0, ::s]
    R[::s, 0] = R_true[::s, 0]
    R[e1 - 1, s:e2 - s:s] = R_true[e1 - 1, s:e2 - s:s]
    R[s::s, e2 - 1] = R_true[s::s, e2 - 1]
    return R
