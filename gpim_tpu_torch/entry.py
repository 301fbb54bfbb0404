"""
Two entry points: the exact GP's predict step on a small seeded problem
of the flagship's form, and a multi-process dry run of the parallel layer.

    from gpim_tpu_torch import entry
    fn, args = entry.entry()          # on the CUDA card
    mean, var = fn(*args)
    entry.dryrun_multichip(2)         # two CPU processes over gloo
"""

import functools

import numpy as np
import torch

__all__ = ["entry", "dryrun_multichip"]


def entry(device="cuda"):
    """Returns ``(fn, example_args)``: the exact GP's predict step
    (:func:`gpim_tpu_torch.gpreg.engine.predict_exact`, RBF, with the
    observation noise in the variance) and its arguments on ``device``, a
    seeded float32 problem of the flagship's form: 256 training points in
    2D, their values, an all-ones padding mask, the hyperparameter bounds,
    the unconstrained hyperparameters (lengthscale and variance at the
    middle of their bounds, noise 1), the jitter and 512 test points in 4
    chunks of 128. ``fn(*example_args)`` returns the predictive mean and
    variance, (512,) each. The card is the default device; without one
    this raises unless ``device="cpu"`` is given."""
    from gpim_tpu_torch.gpreg import engine
    from gpim_tpu_torch.gpreg.gpr import _resolve_device
    from gpim_tpu_torch.kernels.transforms import positive_inverse

    device = (_resolve_device(True) if torch.device(device).type == "cuda"
              else torch.device(device))
    dtype = torch.float32
    n, d, n_test = 256, 2, 512
    rng = np.random.RandomState(0)
    Xn = (rng.rand(n, d) * 20).astype(np.float32)
    X = torch.tensor(Xn, device=device)
    y = torch.tensor(np.sin(Xn[:, 0]), device=device)
    mask = torch.ones((n,), dtype=dtype, device=device)

    def t(v):
        return torch.tensor(v, dtype=dtype, device=device)

    bounds = {"ls_lo": torch.zeros((d,), dtype=dtype, device=device),
              "ls_hi": torch.full((d,), 10.0, dtype=dtype, device=device),
              "var_lo": t(1e-4), "var_hi": t(10.0)}
    u = {"lengthscale": torch.zeros((d,), dtype=dtype, device=device),
         "variance": t(0.0), "noise": positive_inverse(t(1.0))}
    chunks = torch.tensor(rng.rand(4, n_test // 4, d) * 20, dtype=dtype,
                          device=device)
    fn = functools.partial(engine.predict_exact, kernel="RBF",
                           noiseless=False)
    return fn, (u, X, y, mask, bounds, t(1e-4), chunks)


def dryrun_multichip(n):
    """Run the parallel layer's multi-process dry run on ``n`` processes
    (:func:`gpim_tpu_torch.parallel.distributed.dryrun_multiprocess`: a
    world of ``n`` CPU processes over gloo trains and predicts the
    task-sharded multi-output model and the row-sharded sparse GP, and its
    ranks must agree with each other and with one process), and check that
    it reported both scenarios. Returns the report: {scenario: {key:
    largest gap to one process}}."""
    from gpim_tpu_torch.parallel import distributed
    report = distributed.dryrun_multiprocess(n_procs=int(n))
    if set(report) != {"multitask", "vfe"}:
        raise AssertionError("the dry run reported %s, not the multitask "
                             "and vfe scenarios" % sorted(report))
    return report
