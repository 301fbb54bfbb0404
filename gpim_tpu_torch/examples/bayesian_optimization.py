"""
GP-based Bayesian optimisation of a measurement target (the port's runner
of examples/bayesian_optimization.py; reference recipe README.md:71-109 and
the GP_based_exploration_exploitation notebook): a 25x25 grid seeded with 5
measured pixels, EI, 20 exploration steps, 200 GP iterations, checkpoints,
the query path plotted.

    python -m gpim_tpu_torch.examples.bayesian_optimization [--cpu]

The checkpoint (``boptim_results.npy``) goes to the results directory.
"""

import os
import sys

import numpy as np

from gpim_tpu_torch import boptimizer, utils
from gpim_tpu_torch.examples import _cli

NAME = "bayesian_optimization"
ITERATIONS = 200
SIZE = 25


def measure(idx):
    """Stand-in for the instrument callback: an analytic target, 1 at
    (5, 10)."""
    return float(np.exp(-4 * np.log(2) *
                        ((idx[0] - 5) ** 2 + (idx[1] - 10) ** 2) / 4.5 ** 2))


def data():
    """The 25x25 grid measured at 5 pixels drawn from seed 0 (the script's
    ``np.random.seed(0)`` draw), NaN elsewhere."""
    seeds = np.random.RandomState(0).randint(0, SIZE, size=(2, 5))
    Z_sparse = np.full((SIZE, SIZE), np.nan)
    for i, j in zip(*seeds):
        Z_sparse[i, j] = measure((i, j))
    return Z_sparse


def run(iterations=ITERATIONS, Z_sparse=None, use_gpu=True, outdir=None,
        verbose=0):
    """EI from the seed grid ``Z_sparse`` (default :func:`data`) for
    min(iterations, 20) steps with ``iterations`` GP iterations, the
    checkpoint in ``outdir``. Returns {bo (the optimiser), indices (the
    points measured), best_found, outdir}."""
    Z_sparse = data() if Z_sparse is None else Z_sparse
    outdir = _cli.results_dir(outdir)
    X_full = utils.get_full_grid(Z_sparse)
    X_sparse = utils.get_sparse_grid(Z_sparse)
    bo = boptimizer(
        X_sparse, Z_sparse, X_full, measure, acquisition_function="ei",
        exploration_steps=min(iterations, 20), gp_iterations=iterations,
        save_checkpoints=True, filename=os.path.join(outdir, "boptim_results"),
        verbose=verbose, use_gpu=use_gpu)
    bo.run()
    best = float(np.nanmax(np.asarray(bo.target_func_vals[-1], float)))
    return {"bo": bo, "indices": np.asarray(bo.indices_all),
            "best_found": best, "outdir": outdir}


def main(argv=None):
    args = _cli.parse(argv, __doc__, ITERATIONS)
    out = run(args.iterations, use_gpu=not args.cpu, outdir=args.out,
              verbose=1)
    print("best value found:", out["best_found"])
    print("checkpoint in", out["outdir"])
    if not args.no_plot:
        utils.plot_query_points(out["bo"].indices_all, plot_lines=True)


if __name__ == "__main__":
    main(sys.argv[1:])
