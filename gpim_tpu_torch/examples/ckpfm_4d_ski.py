"""
4D cKPFM reconstruction with the structured GP (the port's runner of
examples/ckpfm_4d_ski.py; reference recipe GP_TD_cKPFM.ipynb): the full
10x10x64x5 grid, Matern52, ``ski=True`` (a full grid takes the exact
Kronecker route), 50 Adam steps, then prediction on a 2x denser grid.

    python -m gpim_tpu_torch.examples.ckpfm_4d_ski [--cpu]
"""

import sys

import numpy as np

from gpim_tpu_torch import skreconstructor, utils
from gpim_tpu_torch.examples import _cli, _data

NAME = "ckpfm_4d_ski"
ITERATIONS = 50


def data():
    """The 10x10x64x5 cKPFM response grid: bundled when available, a
    smooth synthetic 4D field otherwise."""
    return _data.ckpfm_slab()


def run(iterations=ITERATIONS, R=None, use_gpu=True, outdir=None,
        verbose=0):
    """Train on the full grid ``R`` (default :func:`data`), predict it,
    then predict the 2x denser grid. Returns {R, mean, sd, hyperparams,
    rmse_fit (over the grid, benchmarks/suite.py's), mean2x, sd2x, model,
    outdir}."""
    R = data() if R is None else R
    X = utils.get_full_grid(R)
    model = skreconstructor(
        X, R, X, kernel="Matern52", ski=True, grid_points_ratio=1.0,
        lengthscale=[1.0, 3.0], iterations=iterations, use_gpu=use_gpu,
        verbose=verbose)
    mean, sd, hyperparams = model.run()
    # super-resolution pass
    X2 = utils.get_full_grid(R, dense_x=0.5)
    mean2x, sd2x = model.predict(X2)
    rmse = float(np.sqrt(np.mean((mean - R) ** 2)))
    outdir = _cli.save(outdir, NAME, hyperparams, mean=mean, sd=sd,
                       mean2x=mean2x, sd2x=sd2x)
    return {"R": R, "mean": mean, "sd": sd, "hyperparams": hyperparams,
            "rmse_fit": rmse, "mean2x": mean2x, "sd2x": sd2x,
            "model": model, "outdir": outdir}


def main(argv=None):
    args = _cli.parse(argv, __doc__, ITERATIONS, plots=False)
    out = run(args.iterations, use_gpu=not args.cpu, outdir=args.out,
              verbose=2)
    print("rmse of the fit: %.5f" % out["rmse_fit"])
    print("2x-dense reconstruction:", out["mean2x"].shape)
    print("results in", out["outdir"])


if __name__ == "__main__":
    main(sys.argv[1:])
