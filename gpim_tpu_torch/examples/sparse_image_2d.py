"""
2D sparse image reconstruction with an exact GP, the flagship workflow (the
port's runner of examples/sparse_image_2d.py; reference recipe
README.md:42-66 and GP_sparse2Dimages.ipynb): RBF, 250 Adam steps.

    python -m gpim_tpu_torch.examples.sparse_image_2d [image.npy] [--cpu]

Missing pixels must be NaN; in an image without NaNs the most frequent
value marks the unmeasured pixels (spiral scans). Without an image, the
128x128 spiral scan (:func:`_data.spiral_scan`).
"""

import sys

import numpy as np

from gpim_tpu_torch import reconstructor, utils
from gpim_tpu_torch.examples import _cli, _data

NAME = "sparse_image_2d"
ITERATIONS = 250


def data(path=None):
    """The image at ``path``, or the spiral scan."""
    if path is None:
        return _data.spiral_scan()
    R = np.load(path).astype(np.float64)
    if not np.isnan(R).any():
        vals, counts = np.unique(R, return_counts=True)
        R[R == vals[np.argmax(counts)]] = np.nan
    return R


def run(iterations=ITERATIONS, R=None, use_gpu=True, outdir=None,
        verbose=0):
    """Normalise ``R`` (default :func:`data`) to [0, 1], train and predict
    over its full grid. Returns {R, mean, sd, hyperparams, rmse_obs (at the
    measured pixels), model, outdir}."""
    R = data() if R is None else R
    R = (R - np.nanmin(R)) / (np.nanmax(R) - np.nanmin(R))
    X = utils.get_sparse_grid(R)       # NaN-marked grid indices
    X_full = utils.get_full_grid(R)    # dense prediction grid
    model = reconstructor(X, R, X_full, kernel="RBF", lengthscale=None,
                          iterations=iterations, use_gpu=use_gpu,
                          verbose=verbose)
    mean, sd, hyperparams = model.run()
    obs = ~np.isnan(R)
    rmse = float(np.sqrt(np.mean((mean[obs] - R[obs]) ** 2)))
    outdir = _cli.save(outdir, NAME, hyperparams, R=R, mean=mean, sd=sd)
    return {"R": R, "mean": mean, "sd": sd, "hyperparams": hyperparams,
            "rmse_obs": rmse, "model": model, "outdir": outdir}


def main(argv=None):
    args = _cli.parse(argv, __doc__, ITERATIONS, image=True)
    out = run(args.iterations, data(args.image), use_gpu=not args.cpu,
              outdir=args.out, verbose=2)
    print("rmse at the measured pixels: %.5f" % out["rmse_obs"])
    print("results in", out["outdir"])
    if not args.no_plot:
        utils.plot_kernel_hyperparams(out["hyperparams"])
        utils.plot_reconstructed_data2d(out["R"], out["mean"])


if __name__ == "__main__":
    main(sys.argv[1:])
