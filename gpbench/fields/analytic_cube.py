"""A smooth analytic cube in [0, 1]: sin(x / 9) cos(y / 11) + exp(-((z -
30) / 15)^2) over the grid indices (x, y, z), rescaled to [0, 1]; the same
in every job (the noise and the scan change)."""

import numpy as np


def make(shape, params, rng):
    del params, rng
    x, y, z = np.meshgrid(*[np.arange(s, dtype=np.float64) for s in shape],
                          indexing="ij")
    f = np.sin(x / 9.0) * np.cos(y / 11.0) + np.exp(-((z - 30.0) / 15.0) ** 2)
    return (f - f.min()) / np.ptp(f)
