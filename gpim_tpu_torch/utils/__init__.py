"""
gpim_tpu_torch.utils: host-side grid/data preparation and plotting,
mirroring the reference's ``gpim.gprutils`` namespace.

The ``plot_*`` helpers (:mod:`gpim_tpu_torch.utils.viz`) resolve on first
use, which imports matplotlib then: the package imports without it, and a
plot name raises ImportError where it is missing.
"""

import importlib

from gpim_tpu_torch.utils.gridutils import *  # noqa: F401,F403

from gpim_tpu_torch.utils import gridutils as _g

# star-imports take the grid helpers only, so they never need matplotlib
__all__ = list(_g.__all__)

_VIZ_NAMES = (
    "plot_kernel_hyperparams", "plot_mixture_hyperparams", "plot_raw_data",
    "plot_reconstructed_data2d", "plot_reconstructed_data3d",
    "plot_exploration_results", "plot_inducing_points",
    "plot_inducing_points_2d", "plot_inducing_points_3d", "plot_query_points",
)


def __getattr__(name):
    if name in _VIZ_NAMES:
        return getattr(importlib.import_module(__name__ + ".viz"), name)
    raise AttributeError("module %r has no attribute %r" % (__name__, name))


def __dir__():
    return sorted(set(globals()) | set(_VIZ_NAMES))
