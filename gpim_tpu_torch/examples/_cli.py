"""The runners' shared command line and results directory."""

import argparse
import os
import tempfile

import numpy as np


def parse(argv, doc, iterations, plots=True, xl=False, image=False):
    """``--iterations`` (default: the script's budget), ``--cpu``, ``--out``
    and, as the runner has them, ``--no-plot``, ``--xl`` and a positional
    image path."""
    ap = argparse.ArgumentParser(description=doc.strip().splitlines()[0])
    if image:
        ap.add_argument("image", nargs="?", default=None,
                        help="a 2D .npy image (default: the spiral scan)")
    ap.add_argument("--iterations", type=int, default=iterations,
                    help="Adam steps (default %(default)s)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the CUDA card)")
    ap.add_argument("--out", default=None,
                    help="results directory (default: a new temporary one)")
    if plots:
        ap.add_argument("--no-plot", action="store_true",
                        help="skip the plots (they need matplotlib)")
    if xl:
        ap.add_argument("--xl", action="store_true",
                        help="the 128x128x64 cube (1,048,576 cells)")
    return ap.parse_args(argv)


def results_dir(outdir):
    """``outdir``, made if missing, or a new temporary directory."""
    if outdir is None:
        return tempfile.mkdtemp(prefix="gpim_tpu_torch_")
    os.makedirs(outdir, exist_ok=True)
    return outdir


def save(outdir, name, hyperparams=None, **arrays):
    """Write ``arrays`` (and the hyperparameter series, keys prefixed
    ``hp_``) to ``<outdir>/<name>.npz``; returns the directory."""
    outdir = results_dir(outdir)
    for k, v in (hyperparams or {}).items():
        arrays["hp_" + k] = np.asarray(v)
    np.savez(os.path.join(outdir, name + ".npz"), **arrays)
    return outdir
