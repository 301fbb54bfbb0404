"""An Archimedean spiral scan of ``pitch`` grid units about the grid's
centre: a pixel is measured where the path passes within ``width`` of it.
The same pixels in every job."""

import numpy as np


def keep(shape, params, rng):
    pitch, width = params["pitch"], params["width"]
    n0, n1 = shape
    yy, xx = np.mgrid[:n0, :n1]
    yy = yy - (n0 - 1) / 2.0
    xx = xx - (n1 - 1) / 2.0
    r = np.hypot(xx, yy)
    th = np.arctan2(yy, xx)
    dist = np.abs((r - pitch * ((th % (2 * np.pi)) / (2 * np.pi))) % pitch)
    return np.minimum(dist, pitch - dist) < width
