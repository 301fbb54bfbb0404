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

__all__ = ["params_from_numpy", "bounds_from_numpy"]


def _to_tensors(arrays, device, dtype):
    return {k: torch.as_tensor(np.asarray(v), dtype=dtype, device=device)
            for k, v in arrays.items()}


def params_from_numpy(u, device, dtype):
    """Unconstrained parameters {'lengthscale', 'variance', 'noise'[,
    'alpha']} as tensors of ``dtype`` on ``device``."""
    return _to_tensors(u, device, dtype)


def bounds_from_numpy(bounds, device, dtype):
    """Bounds {'ls_lo', 'ls_hi', 'var_lo', 'var_hi'} as tensors of
    ``dtype`` on ``device``."""
    return _to_tensors(bounds, device, dtype)
