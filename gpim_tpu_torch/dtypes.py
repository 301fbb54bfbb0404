"""
Precision handling (counterpart of ``gpim_tpu/dtypes.py``).

``precision`` resolves to an explicit torch dtype threaded through every
computation. When it is not given, it defaults to "double" on the CPU
(reference parity) and "single" on CUDA, as the JAX package defaults to
single on its accelerator.
"""

import torch

__all__ = ["resolve_dtype", "default_jitter", "round_up"]


def resolve_dtype(precision=None, device=None):
    """Map 'single' | 'double' | None to a torch dtype; None means double
    on the CPU and single on CUDA."""
    if precision is None:
        on_cuda = device is not None and torch.device(device).type == "cuda"
        precision = "single" if on_cuda else "double"
    if precision == "single":
        return torch.float32
    if precision == "double":
        return torch.float64
    raise ValueError(
        "precision must be 'single', 'double' or None, got %r" % (precision,))


def default_jitter(dtype):
    """Numerical-stability jitter matched to the working precision."""
    return 1.0e-5 if dtype == torch.float64 else 1.0e-4


def round_up(x, multiple):
    """Round ``x`` up to the nearest multiple (used for padding buckets)."""
    return int(-(-int(x) // multiple) * multiple)
