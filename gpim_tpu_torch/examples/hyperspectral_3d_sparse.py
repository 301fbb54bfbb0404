"""
3D hyperspectral reconstruction with an inducing-point (VFE) GP (the port's
runner of examples/hyperspectral_3d_sparse.py; reference recipe
GP_BEPFM.ipynb): the 32x32x102 BEPFM cube with 70.6% of its spectra
removed, Matern52, 1000 trainable inducing points, learning rate 0.05, 400
Adam steps.

    python -m gpim_tpu_torch.examples.hyperspectral_3d_sparse [--cpu]
"""

import sys

import numpy as np

from gpim_tpu_torch import reconstructor, utils
from gpim_tpu_torch.examples import _cli, _data

NAME = "hyperspectral_3d_sparse"
ITERATIONS = 400
# the script's plot: the slice integrated around channel 50, spectra at two
# pixels of the 32x32 map
PLOT = dict(slice_number=50, pos=[[5, 10], [20, 25]])


def data():
    """(the NaN-sparse cube, the full cube): bundled when available,
    synthetic otherwise."""
    return _data.bepfm_cube(sparse=True), _data.bepfm_cube(sparse=False)


def run(iterations=ITERATIONS, cubes=None, use_gpu=True, outdir=None,
        verbose=0):
    """Train on the sparse cube of ``cubes`` (default :func:`data`) and
    predict the full grid. Returns {R, truth, mean, sd, hyperparams, mae
    (the script's mean absolute error against the full cube),
    rmse_vs_truth (benchmarks/suite.py's, both normalised by the full
    cube's range), model, outdir}."""
    R, truth = data() if cubes is None else cubes
    X = utils.get_sparse_grid(R)
    X_full = utils.get_full_grid(R)
    model = reconstructor(X, R, X_full, kernel="Matern52", sparse=True,
                          indpoints=1000, learning_rate=0.05,
                          iterations=iterations, use_gpu=use_gpu,
                          verbose=verbose)
    mean, sd, hyperparams = model.run()
    span = np.ptp(truth)
    rmse = float(np.sqrt(np.mean(((mean - truth) / span) ** 2)))
    mae = float(np.abs(mean - truth).mean())
    outdir = _cli.save(outdir, NAME, hyperparams, mean=mean, sd=sd)
    return {"R": R, "truth": truth, "mean": mean, "sd": sd,
            "hyperparams": hyperparams, "mae": mae, "rmse_vs_truth": rmse,
            "model": model, "outdir": outdir}


def main(argv=None):
    args = _cli.parse(argv, __doc__, ITERATIONS)
    out = run(args.iterations, use_gpu=not args.cpu, outdir=args.out,
              verbose=2)
    print("mean abs error vs ground truth:", out["mae"])
    print("results in", out["outdir"])
    if not args.no_plot:
        utils.plot_reconstructed_data3d(np.nan_to_num(out["R"]), out["mean"],
                                        out["sd"], **PLOT)


if __name__ == "__main__":
    main(sys.argv[1:])
