"""
Generate the port's executable example notebooks: the seven notebooks of
``examples/notebooks`` (each mirrors a reference notebook; six mirror the
runners of ``gpim_tpu_torch.examples``), with the same cells, data, kwargs
and iteration budgets, through ``gpim_tpu_torch`` on the CUDA card.

Each notebook's SETUP cell reads GPIM_TPU_TORCH_NB_ITERS (a smaller
iteration budget), GPIM_TPU_TORCH_NB_DEVICE ("cpu" for the CPU; the CUDA
card otherwise) and GPIM_TPU_TORCH_REPO (a checkout to import the package
from). Every plotting call sits in a code cell tagged ``plot``, and such a
cell holds nothing else, so ``gpim_tpu_torch.examples._notebook`` can run a
notebook without matplotlib by skipping those cells. The notebooks are
written without outputs and with fixed cell ids, so this script reproduces
them byte for byte.

Run: python gpim_tpu_torch/examples/notebooks/_generate.py
"""

import os

import nbformat as nbf

HERE = os.path.dirname(os.path.abspath(__file__))

SETUP = """\
import os
import sys

import numpy as np

# a checkout to import gpim_tpu_torch from, when it is not installed
if os.environ.get("GPIM_TPU_TORCH_REPO"):
    sys.path.insert(0, os.path.abspath(os.environ["GPIM_TPU_TORCH_REPO"]))

# GPIM_TPU_TORCH_NB_ITERS shrinks the iteration budget (a smoke run takes
# 2); GPIM_TPU_TORCH_NB_DEVICE=cpu runs on the CPU, anything else (or
# nothing) on the CUDA card, and without a card the first model raises
ITERS = int(os.environ.get("GPIM_TPU_TORCH_NB_ITERS", {iters}))
USE_GPU = os.environ.get("GPIM_TPU_TORCH_NB_DEVICE") != "cpu"

import gpim_tpu_torch
from gpim_tpu_torch import utils
print(gpim_tpu_torch.__version__,
      "on the CUDA card" if USE_GPU else "on the CPU")"""


def nb(name, cells):
    """A notebook of (kind, source) cells: "md", "code" or "plot" (a code
    cell tagged ``plot``); cell ids are the notebook's name and the cell's
    number."""
    notebook = nbf.v4.new_notebook()
    notebook["metadata"] = {
        "kernelspec": {"display_name": "Python 3", "language": "python",
                       "name": "python3"},
        "language_info": {"name": "python"},
    }
    stem = os.path.splitext(name)[0]
    out = []
    for i, (kind, src) in enumerate(cells):
        cid = "%s-%02d" % (stem, i)
        if kind == "md":
            out.append(nbf.v4.new_markdown_cell(src, id=cid))
        else:
            meta = {"tags": ["plot"]} if kind == "plot" else {}
            out.append(nbf.v4.new_code_cell(src, id=cid, metadata=meta))
    notebook["cells"] = out
    return notebook


CELLS = {}

CELLS["sparse_image_2d.ipynb"] = [
    ("md", "# 2D sparse image reconstruction (exact GP)\n\n"
     "The flagship workflow (reference: `GP_sparse2Dimages.ipynb` / "
     "`Quickstart_GPim.ipynb`): a sparsely sampled 128×128 PFM scan is\n"
     "reconstructed by an exact Gaussian process with an ARD RBF kernel, "
     "in PyTorch on the CUDA card. Missing pixels are encoded as NaN;\n"
     "the model masks them out, trains the hyperparameters by Adam on the "
     "exact marginal likelihood (each step's masked kernel system and\n"
     "its backward reductions are hand-written CUDA kernels), and returns "
     "a dense mean + sd."),
    ("code", SETUP.format(iters=250)),
    ("md", "Load the spiral scan (bundled when available, a synthetic "
     "spiral acquisition otherwise) and normalize to [0, 1]."),
    ("code", """\
from gpim_tpu_torch.examples import _data

R = _data.spiral_scan()
R = (R - np.nanmin(R)) / (np.nanmax(R) - np.nanmin(R))
print("grid:", R.shape, " observed:", int((~np.isnan(R)).sum()))"""),
    ("md", "Build the NaN-marked sparse grid (training coordinates) and "
     "the dense prediction grid."),
    ("code", """\
X = utils.get_sparse_grid(R)
X_full = utils.get_full_grid(R)"""),
    ("md", "Train + predict. `verbose=2` prints the loss/hyperparameter "
     "trajectory (recorded per iteration, as in the reference)."),
    ("code", """\
from gpim_tpu_torch import reconstructor

model = reconstructor(X, R, X_full, kernel="RBF",
                      iterations=ITERS, use_gpu=USE_GPU, verbose=2)
mean, sd, hyperparams = model.run()"""),
    ("md", "Inspect the hyperparameter trajectories and the "
     "reconstruction (needs matplotlib)."),
    ("plot", """\
utils.plot_kernel_hyperparams(hyperparams)
utils.plot_reconstructed_data2d(R, mean)"""),
]

CELLS["hyperspectral_3d_sparse.ipynb"] = [
    ("md", "# 3D hyperspectral reconstruction (inducing-point sparse GP)\n\n"
     "Reference recipe: `GP_BEPFM.ipynb` - a 32×32×102 BEPFM cube with "
     "70.6% of the spectra removed, reconstructed by a sparse\n"
     "variational-free-energy (VFE) GP with trainable inducing points "
     "(the counterpart of Pyro's `SparseGPRegression`). Every training\n"
     "step builds its inducing-point kernel blocks with the hand-written "
     "squared-distance kernel on the CUDA card."),
    ("code", SETUP.format(iters=400)),
    ("code", """\
from gpim_tpu_torch.examples import _data

R = _data.bepfm_cube(sparse=True)       # (32, 32, 102), NaN-sparse
X = utils.get_sparse_grid(R)
X_full = utils.get_full_grid(R)
print("observed voxels:", int((~np.isnan(R)).sum()), "of", R.size)"""),
    ("md", "Train the VFE model. `indpoints` sets the inducing-point "
     "count; the inducing locations start as a strided subsample and are "
     "trained jointly with the kernel hyperparameters."),
    ("code", """\
from gpim_tpu_torch import reconstructor

model = reconstructor(X, R, X_full, kernel="Matern52",
                      sparse=True, indpoints=1000,
                      learning_rate=0.05, iterations=ITERS,
                      use_gpu=USE_GPU, verbose=2)
mean, sd, hyperparams = model.run()"""),
    ("code", """\
truth = _data.bepfm_cube(sparse=False)
print("mean abs error vs ground truth:",
      float(np.abs(mean - truth).mean()))
R_filled = np.nan_to_num(R)"""),
    ("plot", """\
utils.plot_reconstructed_data3d(R_filled, mean, sd,
                                slice_number=50, pos=[[5, 10], [20, 25]])"""),
]

CELLS["eels_parallel_gp.ipynb"] = [
    ("md", "# Multi-output (\"parallel\") GP over spectral components\n\n"
     "Reference recipe: `GP_EELS.ipynb` - spectral components (NMF in "
     "the reference; band averages here) become output channels of a\n"
     "vector-valued GP. `independent=True` trains one GP per channel, "
     "all channels at once along a task axis of the same hand-written\n"
     "CUDA kernels (and shardable over the ranks of a "
     "`torch.distributed` world with `mesh=`); prediction runs on a 2× "
     "denser\ngrid (super-resolution)."),
    ("code", SETUP.format(iters=100)),
    ("code", """\
from gpim_tpu_torch.examples import _data

cube = _data.bepfm_cube()
bands = np.stack([cube[:, :, i * 15:(i + 1) * 15].mean(-1)
                  for i in range(6)], axis=-1)
bands = (bands - bands.min()) / np.ptp(bands)

rng = np.random.default_rng(0)
drop = rng.random(bands.shape[:2]) < 0.5
Y = bands.copy()
Y[drop] = np.nan
X = utils.get_full_grid(Y[..., 0]).copy()
X[:, drop] = np.nan
X_dense = utils.get_full_grid(Y[..., 0], dense_x=0.5)   # 2x denser"""),
    ("code", """\
from gpim_tpu_torch import vreconstructor

model = vreconstructor(X, Y, X_dense, kernel="RBF",
                       independent=True, iterations=ITERS,
                       use_gpu=USE_GPU, verbose=2)
mean, sd, hyperparams = model.run()
print("prediction:", mean.shape)    # (64, 64, 6)"""),
    ("md", "Correlated channels (Kronecker multitask covariance) are one "
     "kwarg away: `independent=False` uses the decoupled-eigenbasis "
     "trainer, exact in the task covariance."),
]

CELLS["ckpfm_4d_ski.ipynb"] = [
    ("md", "# 4D cKPFM reconstruction (structured-kernel GP)\n\n"
     "Reference recipe: `GP_TD_cKPFM.ipynb` - a full 10×10×64×5 cKPFM "
     "response grid fit with the structured-kernel (SKI) engine and\n"
     "predicted on a 2× denser grid. On lattice data the engine uses "
     "exact Kronecker algebra instead of interpolation - same API,\n"
     "exact math; its per-axis kernel factors come from the hand-written "
     "squared-distance kernel on the CUDA card."),
    ("code", SETUP.format(iters=50)),
    ("code", """\
from gpim_tpu_torch.examples import _data

R = _data.ckpfm_slab()                 # (10, 10, 64, 5)
X = utils.get_full_grid(R)"""),
    ("code", """\
from gpim_tpu_torch import skreconstructor

model = skreconstructor(X, R, X, kernel="Matern52", ski=True,
                        grid_points_ratio=1.0, lengthscale=[1.0, 3.0],
                        iterations=ITERS, use_gpu=USE_GPU, verbose=2)
mean, sd, hyperparams = model.run()"""),
    ("md", "Super-resolution pass: predict on a 2× denser grid "
     "(`dense_x=0.5`)."),
    ("code", """\
X2 = utils.get_full_grid(R, dense_x=0.5)
mean2x, sd2x = model.predict(X2)
print("2x-dense reconstruction:", mean2x.shape)"""),
]

CELLS["bayesian_optimization.ipynb"] = [
    ("md", "# GP-based exploration of a measurement target\n\n"
     "Reference recipe: `GP_based_exploration_exploitation.ipynb` - seed "
     "a few measurements, then let the Bayesian-optimization loop pick\n"
     "where to measure next (expected improvement), retraining the GP "
     "surrogate on the CUDA card after every measurement. The `measure`\n"
     "callback stands in for the physical instrument."),
    ("code", SETUP.format(iters=200)),
    ("code", """\
def measure(idx):
    \"\"\"Stand-in for the physical instrument callback.\"\"\"
    return float(np.exp(-4 * np.log(2) *
                        ((idx[0] - 5) ** 2 + (idx[1] - 10) ** 2)
                        / 4.5 ** 2))


np.random.seed(0)
size = 25
seeds = np.random.randint(0, size, size=(2, 5))
Z_sparse = np.full((size, size), np.nan)
for i, j in zip(*seeds):
    Z_sparse[i, j] = measure((i, j))

X_full = utils.get_full_grid(Z_sparse)
X_sparse = utils.get_sparse_grid(Z_sparse)"""),
    ("code", """\
from gpim_tpu_torch import boptimizer

boptim = boptimizer(
    X_sparse, Z_sparse, X_full, measure,
    acquisition_function="ei",
    exploration_steps=min(ITERS, 20),
    gp_iterations=ITERS,
    save_checkpoints=True, filename="boptim_results",
    use_gpu=USE_GPU, verbose=1)
boptim.run()
print("best value found:", np.nanmax(boptim.target_func_vals[-1]))"""),
    ("plot", """\
utils.plot_query_points(boptim.indices_all, plot_lines=True)"""),
    ("md", "The checkpoint file (`boptim_results.npy`) stores the same "
     "artifact dict as the reference (`gp_pred`, `func_val`, `inds_all`, "
     "`vals_all`) after every step; a full resumable state (including "
     "RNG) is saved alongside it, restored with "
     "`boptim.load_checkpoint(...)`."),
]

CELLS["quickstart.ipynb"] = [
    ("md", "# Quickstart: gpim_tpu_torch\n\n"
     "Reference parity: `Quickstart_GPim.ipynb` (an index of the example "
     "notebooks). This one is also runnable: the cell below trains an\n"
     "exact GP end-to-end on a tiny sparse image, which is the whole "
     "library in four lines. The port runs in PyTorch on a CUDA card;\n"
     "its Gaussian-process kernels (squared distances, the masked kernel "
     "system, the backward reductions) are hand-written CUDA.\n\n"
     "The full workflow notebooks (each mirrors a reference notebook):\n\n"
     "1. [2D sparse image reconstruction](sparse_image_2d.ipynb) - exact "
     "GP, the flagship workflow (`GP_sparse2Dimages.ipynb`).\n"
     "2. [3D hyperspectral reconstruction](hyperspectral_3d_sparse.ipynb) "
     "- inducing-point sparse GP (`GP_BEPFM.ipynb`, "
     "`GP_2D3D_images.ipynb`).\n"
     "3. [Multi-output GP over spectral components](eels_parallel_gp.ipynb)"
     " - parallel GPs on a task axis (`GP_EELS.ipynb`).\n"
     "4. [4D cKPFM structured-kernel GP](ckpfm_4d_ski.ipynb) - exact "
     "Kronecker on lattices (`GP_TD_cKPFM.ipynb`).\n"
     "5. [GP-based exploration](bayesian_optimization.ipynb) - Bayesian "
     "optimization loop (`GP_based_exploration_exploitation.ipynb`).\n"
     "6. [Large NaN-masked grids](large_masked_ski.ipynb) - the "
     "masked-Kronecker CG engine at 10^5-10^7 cells (no reference "
     "equivalent; replaces its `GridInterpolationKernel` path).\n\n"
     "Everything runs on the CUDA card by default "
     "(`GPIM_TPU_TORCH_NB_DEVICE=cpu`, or `use_gpu=False`, for the CPU); "
     "sharding over the ranks of a `torch.distributed` world is one "
     "`mesh=` kwarg."),
    ("code", SETUP.format(iters=100)),
    ("md", "A 48×48 test image with 65% of the pixels unmeasured (NaN), "
     "reconstructed by an exact GP:"),
    ("code", """\
rng = np.random.default_rng(0)
xx, yy = np.meshgrid(np.arange(48), np.arange(48), indexing="ij")
truth = np.sin(xx / 7.0) * np.cos(yy / 9.0)
R = truth + 0.05 * rng.standard_normal(truth.shape)
R[rng.random(R.shape) < 0.65] = np.nan

from gpim_tpu_torch import reconstructor

model = reconstructor(
    utils.get_sparse_grid(R), R, utils.get_full_grid(R),
    kernel="RBF", iterations=ITERS, use_gpu=USE_GPU, verbose=1)
mean, sd, hyperparams = model.run()
print("rmse vs truth: %.4f" % float(
    np.sqrt(np.mean((mean - truth) ** 2))))"""),
    ("plot", """\
utils.plot_reconstructed_data2d(R, mean)"""),
]

CELLS["large_masked_ski.ipynb"] = [
    ("md", "# Large NaN-masked grids (masked-Kronecker CG engine)\n\n"
     "The regime of the reference's `GridInterpolationKernel` path "
     "(skgpr.py:436-440), far past dense-GP reach: a 64×64×32 cube\n"
     "(131,072 voxels; switch to 128×128×64 = 1M+, or 256×256×64 = 4.2M) "
     "with 70% of the spatial sites never measured, trained\n"
     "end-to-end on the CUDA card through batched preconditioned "
     "conjugate gradients with stochastic-Lanczos-quadrature log-det\n"
     "gradients; the per-axis kernel factors come from the hand-written "
     "squared-distance kernel."),
    ("code", SETUP.format(iters=30)),
    ("code", """\
from scipy.ndimage import gaussian_filter


def make_cube(shape=(64, 64, 32), missing=0.7, seed=2):
    rng = np.random.RandomState(seed)
    f = gaussian_filter(rng.randn(*shape), sigma=(4, 4, 2))
    f = (f - f.min()) / (f.max() - f.min())
    R = f + 0.02 * rng.randn(*shape)
    sites = rng.choice(shape[0] * shape[1],
                       int(missing * shape[0] * shape[1]), replace=False)
    R.reshape(-1, shape[2])[sites] = np.nan
    return f, R


truth, R = make_cube()
X = utils.get_sparse_grid(R)
X_full = utils.get_full_grid(R)
print("observed voxels:", int((~np.isnan(R)).sum()), "of", R.size)"""),
    ("code", """\
from gpim_tpu_torch import skreconstructor

model = skreconstructor(
    X, R, X_full, kernel="RBF", ski=True,
    learning_rate=0.1, iterations=ITERS, use_gpu=USE_GPU, verbose=1)
mean, sd, hyperparams = model.run()

mean = mean.reshape(truth.shape)
rmse = float(np.sqrt(np.mean((mean - truth) ** 2)))
print("final lengthscale:",
      np.around(hyperparams["lengthscale"][-1], 3))
print("rmse vs noiseless truth: %.4f (data noise sd 0.02)" % rmse)"""),
]

def notebooks():
    """{file name: notebook} of the seven notebooks."""
    return {name: nb(name, cells) for name, cells in CELLS.items()}


def main():
    for name, notebook in notebooks().items():
        path = os.path.join(HERE, name)
        nbf.write(notebook, path)
        print("wrote", path)


if __name__ == "__main__":
    main()
