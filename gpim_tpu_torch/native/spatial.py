"""
Greedy spatial suppression for batch query-point selection (counterpart of
``gpim_tpu/native/spatial.py``).

Algorithm (contract of reference boptim.update_points, boptim.py:326-376):
walk candidate points in descending acquisition order; each accepted point
suppresses every remaining candidate within Euclidean distance ``dscale``.

Only the vectorised numpy sweep is carried. The JAX package also builds a
C++ helper (``spatial.cpp``, loaded with ctypes) for grid-sized candidate
sets, but the candidates here number at most ``batch_size`` (100 by
default), so a compiled host helper buys nothing. The helper is a host
routine, not a device kernel; the sweep gives the same selection.
"""

import numpy as np

__all__ = ["spaced_batch"]


def spaced_batch(points, dscale, max_out=None):
    """Greedy selection of points spaced more than ``dscale`` apart.

    Args:
        points: (n, d) candidate coordinates in descending priority order.
        dscale: exclusion radius (a candidate at exactly ``dscale`` is
            suppressed).
        max_out: optional cap on the number of selected points.

    Returns:
        List of selected row positions into ``points`` (ascending priority
        order preserved).
    """
    pts = np.ascontiguousarray(points, np.float64)
    n = pts.shape[0]
    if n == 0:
        return []
    cap = n if max_out is None else min(int(max_out), n)
    alive = np.ones(n, bool)
    selected = []
    r2 = float(dscale) ** 2
    while len(selected) < cap:
        remaining = np.nonzero(alive)[0]
        if remaining.size == 0:
            break
        i = remaining[0]
        selected.append(int(i))
        diff = pts[remaining] - pts[i]
        alive[remaining[np.einsum("ij,ij->i", diff, diff) <= r2]] = False
    return selected

