"""Whole spectra left out of a hyperspectral cube: of the (x, y) positions
of a grid whose last axis is the spectrum, int(``remove`` x their number)
drawn without replacement are not measured at any bin; new in each job."""

import numpy as np


def keep(shape, params, rng):
    n_xy = int(np.prod(shape[:-1]))
    out = np.ones((n_xy, shape[-1]), bool)
    out[rng.choice(n_xy, int(params["remove"] * n_xy), replace=False)] = False
    return out.reshape(shape)
