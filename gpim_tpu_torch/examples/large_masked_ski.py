"""
Large NaN-masked hyperspectral reconstruction through the structured (SKI)
route (the port's runner of examples/large_masked_ski.py): a 64x64x32
BEPFM-style cube (131,072 voxels) with 70% of its (x, y) spectra removed,
``skreconstructor(ski=True)``, RBF, learning rate 0.1, 30 Adam steps. A
NaN-masked lattice of this size takes the masked-lattice SKI route: the
masked Kronecker operator, split-preconditioned CG over the data and the
probes, the SLQ log-determinant and trace-estimated gradients.

    python -m gpim_tpu_torch.examples.large_masked_ski [--xl] [--cpu]

``--xl``: a 128x128x64 cube (1,048,576 voxels), the scale of the
reference's 128x128 BEPFM map.
"""

import sys

import numpy as np

from gpim_tpu_torch import skreconstructor, utils
from gpim_tpu_torch.examples import _cli

NAME = "large_masked_ski"
ITERATIONS = 30
SHAPE, SHAPE_XL = (64, 64, 32), (128, 128, 64)


def make_cube(shape=SHAPE, missing=0.7, seed=2):
    """A synthetic smooth BEPFM-style cube with noise 0.02 and whole
    spectra removed at ``missing`` of the (x, y) sites (reference
    gprutils.corrupt_image3d semantics); returns (noiseless truth, R)."""
    from scipy.ndimage import gaussian_filter
    rng = np.random.RandomState(seed)
    f = gaussian_filter(rng.randn(*shape), sigma=(4, 4, 2))
    f = (f - f.min()) / (f.max() - f.min())
    R = f + 0.02 * rng.randn(*shape)
    sites = rng.choice(shape[0] * shape[1],
                       int(missing * shape[0] * shape[1]), replace=False)
    R.reshape(-1, shape[2])[sites] = np.nan
    return f, R


def run(iterations=ITERATIONS, cube=None, xl=False, use_gpu=True,
        outdir=None, verbose=0):
    """Train on ``cube`` (truth, R) (default :func:`make_cube` at the
    64x64x32 or, with ``xl``, the 128x128x64 shape) and predict its full
    grid. Returns {truth, R, mean, sd, hyperparams, rmse_vs_truth, model,
    outdir}."""
    truth, R = make_cube(SHAPE_XL if xl else SHAPE) if cube is None else cube
    X = utils.get_sparse_grid(R)
    Xfull = utils.get_full_grid(R)
    model = skreconstructor(X, R, Xfull, kernel="RBF", ski=True,
                            learning_rate=0.1, iterations=iterations,
                            use_gpu=use_gpu, verbose=verbose)
    mean, sd, hyperparams = model.run()
    mean = mean.reshape(truth.shape)
    rmse = float(np.sqrt(np.mean((mean - truth) ** 2)))
    outdir = _cli.save(outdir, NAME, hyperparams, mean=mean, sd=sd)
    return {"truth": truth, "R": R, "mean": mean, "sd": sd,
            "hyperparams": hyperparams, "rmse_vs_truth": rmse,
            "model": model, "outdir": outdir}


def main(argv=None):
    args = _cli.parse(argv, __doc__, ITERATIONS, plots=False, xl=True)
    out = run(args.iterations, xl=args.xl, use_gpu=not args.cpu,
              outdir=args.out, verbose=1)
    print("final lengthscale:",
          np.around(out["hyperparams"]["lengthscale"][-1], 3))
    print("rmse vs noiseless truth: %.4f (data noise sd 0.02)"
          % out["rmse_vs_truth"])
    print("observed voxels:", int((~np.isnan(out["R"])).sum()), "of",
          out["R"].size)
    print("results in", out["outdir"])


if __name__ == "__main__":
    main(sys.argv[1:])
