"""
Carry parameters across from ``gpim_tpu``.

``gpim_tpu`` keeps a model's unconstrained hyperparameters (``model.u``) and
bounds as dicts of arrays; its ``save_model`` writes them to an .npz as
``u_*`` and ``b_*`` keys. These functions turn such dicts, given as numpy
(e.g. ``{k: np.asarray(v) for k, v in model.u.items()}``), into the port's
tensors, so a JAX-trained model can be predicted by the port.
"""

import numpy as np
import torch

from gpim_tpu_torch.utils import profiling

__all__ = ["params_from_numpy", "bounds_from_numpy"]


def _to_tensors(arrays, device, dtype):
    with profiling.wait("upload", len(arrays)):
        return {k: torch.tensor(np.asarray(v), dtype=dtype, device=device)
                for k, v in arrays.items()}


def params_from_numpy(u, device, dtype):
    """Unconstrained parameters as tensors of ``dtype`` on ``device``, for
    every model of the port:

    - ``reconstructor``: {'lengthscale', 'variance', 'noise'[, 'alpha'][,
      'Xu']}; 'Xu' holds a sparse (VFE) model's (m, d) inducing points, so
      a ``gpim_tpu`` sparse model is predicted by the port as it stands;
    - ``vreconstructor``, independent: {'lengthscale' (T, d),
      'outputscale', 'noise', 'mean' (T,)}; correlated: {'lengthscale'
      (d,), 'noise' (), 'mean' (T,), 'F' (T, rank), 'task_var' (T,)};
    - ``skreconstructor``, dense and Kronecker routes: the independent
      ``vreconstructor`` layout at T = 1 ({'lengthscale' (1, d),
      'outputscale', 'noise', 'mean' (1,)}); spectral: {'weights' (Q,),
      'means' (Q, d), 'scales' (Q, d), 'noise' (), 'mean' ()}.
    """
    return _to_tensors(u, device, dtype)


def bounds_from_numpy(bounds, device, dtype):
    """Bounds {'ls_lo', 'ls_hi'[, 'var_lo', 'var_hi']} as tensors of
    ``dtype`` on ``device`` (a ``vreconstructor`` has no variance
    bounds)."""
    return _to_tensors(bounds, device, dtype)
