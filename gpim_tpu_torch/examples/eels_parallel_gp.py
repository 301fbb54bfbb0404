"""
Multi-output ("parallel") GP over spectral components, the EELS workflow
(the port's runner of examples/eels_parallel_gp.py; reference recipe
GP_EELS.ipynb): 6 band-averaged components of the BEPFM cube as output
channels, half the pixels removed, independent per-channel GPs (RBF, 100
Adam steps), prediction on a 2x denser grid.

    python -m gpim_tpu_torch.examples.eels_parallel_gp [--cpu]
"""

import sys

import numpy as np

from gpim_tpu_torch import utils, vreconstructor
from gpim_tpu_torch.examples import _cli, _data

NAME = "eels_parallel_gp"
ITERATIONS = 100


def data():
    """(32, 32, 6): the BEPFM cube averaged over 6 bands of 15 channels,
    normalised to [0, 1] (a stand-in for the reference's eels.npy)."""
    cube = _data.bepfm_cube()
    bands = np.stack([cube[:, :, i * 15:(i + 1) * 15].mean(-1)
                      for i in range(6)], axis=-1)
    return (bands - bands.min()) / np.ptp(bands)


def run(iterations=ITERATIONS, bands=None, use_gpu=True, outdir=None,
        verbose=0):
    """Remove half the pixels of ``bands`` (default :func:`data`), train
    one GP a channel and predict on the 2x denser grid. Returns {Y, mean,
    sd (64, 64, 6 for the default data), hyperparams, rmse_vs_bands (at the
    dense grid's points on the original pixels, measured or not), model,
    outdir}."""
    bands = data() if bands is None else bands
    rng = np.random.default_rng(0)
    drop = rng.random(bands.shape[:2]) < 0.5
    Y = bands.copy()
    Y[drop] = np.nan
    X = utils.get_full_grid(Y[..., 0]).copy()
    X[:, drop] = np.nan
    # 2x denser prediction grid (dense_x < 1 = super-resolution)
    X_dense = utils.get_full_grid(Y[..., 0], dense_x=0.5)
    model = vreconstructor(X, Y, X_dense, kernel="RBF", independent=True,
                           iterations=iterations, use_gpu=use_gpu,
                           verbose=verbose)
    mean, sd, hyperparams = model.run()
    rmse = float(np.sqrt(np.mean((mean[::2, ::2] - bands) ** 2)))
    outdir = _cli.save(outdir, NAME, hyperparams, mean=mean, sd=sd)
    return {"Y": Y, "mean": mean, "sd": sd, "hyperparams": hyperparams,
            "rmse_vs_bands": rmse, "model": model, "outdir": outdir}


def main(argv=None):
    args = _cli.parse(argv, __doc__, ITERATIONS, plots=False)
    out = run(args.iterations, use_gpu=not args.cpu, outdir=args.out,
              verbose=2)
    print("prediction:", out["mean"].shape)
    print("rmse vs the bands at the original pixels: %.5f"
          % out["rmse_vs_bands"])
    print("results in", out["outdir"])


if __name__ == "__main__":
    main(sys.argv[1:])
