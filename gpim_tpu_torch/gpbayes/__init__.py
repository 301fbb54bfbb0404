"""GP-based Bayesian optimization: acquisition functions and the optimizer."""

from gpim_tpu_torch.gpbayes import acqfunc, boptim  # noqa: F401
