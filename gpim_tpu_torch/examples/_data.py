"""
Data resolution for the example runners (the port's own copy of
``examples/_data.py``, numpy only).

Every runner runs anywhere: if the bundled experimental datasets (the
reference repo's ``expdata/``, reference README.md:42-109) are present, at
$GPIM_TPU_EXPDATA or in an ``expdata`` directory at the repository's root,
they are used; otherwise a synthetic stand-in with the same shape and
sparsity statistics is generated, the same arrays ``examples/_data.py``
makes, so the workflow still runs end to end.
"""

import os

import numpy as np

_DEFAULT_ROOTS = (
    os.environ.get("GPIM_TPU_EXPDATA"),
    os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "expdata"),
)


def expdata_path(fname):
    """Absolute path of a bundled dataset, or None if unavailable."""
    for root in _DEFAULT_ROOTS:
        if root:
            p = os.path.join(root, fname)
            if os.path.exists(p):
                return p
    return None


def _smooth_field(shape, sigma, seed):
    """Band-limited random field in [0, 1] via Gaussian spectral damping
    (no scipy dependency)."""
    rng = np.random.RandomState(seed)
    f = rng.randn(*shape)
    for ax, s in enumerate(sigma):
        if s <= 0:
            continue
        n = shape[ax]
        k = np.fft.rfftfreq(n)
        damp = np.exp(-0.5 * (2 * np.pi * k * s) ** 2)
        f = np.fft.irfft(np.fft.rfft(f, axis=ax)
                         * damp.reshape([-1 if a == ax else 1
                                         for a in range(f.ndim)]),
                         n=n, axis=ax)
    return (f - f.min()) / (f.max() - f.min())


def bepfm_cube(sparse=False, missing=0.706, seed=0):
    """The 32x32x102 BEPFM hyperspectral cube (GP_BEPFM.ipynb), or a
    synthetic stand-in: smooth in the two spatial dims, band-structured
    along the spectral dim, with whole spectra removed at random sites
    (the acquisition pattern the reference workflow assumes)."""
    name = ("bepfm_test_data_sparse.npy" if sparse
            else "bepfm_test_data.npy")
    p = expdata_path(name)
    if p is not None:
        return np.load(p)
    shape = (32, 32, 102)
    cube = _smooth_field(shape, sigma=(2.0, 2.0, 4.0), seed=seed)
    if not sparse:
        return cube
    rng = np.random.RandomState(seed + 1)
    R = cube + 0.02 * rng.randn(*shape)
    sites = rng.choice(shape[0] * shape[1],
                       int(missing * shape[0] * shape[1]), replace=False)
    R.reshape(-1, shape[2])[sites] = np.nan
    return R


def ckpfm_slab(seed=0):
    """The 10x10x64x5 cKPFM response grid (GP_TD_cKPFM.ipynb): real data
    when bundled, else a smooth synthetic 4D field in [0, 1]."""
    p = expdata_path("cKPFM loop_0001 10 x 10-proc.npz")
    if p is not None:
        d = np.load(p)
        R = (d["Nd_mat_amp"] * np.cos(d["Nd_mat_phase"]))[..., 1, :, :]
        return (R - R.min()) / np.ptp(R)
    return _smooth_field((10, 10, 64, 5), sigma=(1.0, 1.0, 6.0, 0.8),
                         seed=seed)


def spiral_scan(seed=0):
    """The 128x128 spiral-scan topography (sparse_image_2d 'real data'
    path): real scan when bundled, else a synthetic smooth image with a
    spiral acquisition mask (~37% measured)."""
    p = expdata_path("spiral_s_00010_2019.npy")
    if p is not None:
        img = np.load(p).astype(np.float64)
        vals, counts = np.unique(img, return_counts=True)
        img[img == vals[np.argmax(counts)]] = np.nan
        return (img - np.nanmin(img)) / (np.nanmax(img) - np.nanmin(img))
    n = 128
    f = _smooth_field((n, n), sigma=(6.0, 6.0), seed=seed)
    yy, xx = np.mgrid[:n, :n] - (n - 1) / 2.0
    r = np.hypot(xx, yy)
    th = np.arctan2(yy, xx)
    # Archimedean spiral mask: measured where the scan path passes
    pitch = 3.0
    dist = np.abs((r - pitch * ((th % (2 * np.pi)) / (2 * np.pi)))
                  % pitch)
    keep = np.minimum(dist, pitch - dist) < 0.55
    img = f.copy()
    img[~keep] = np.nan
    return img
