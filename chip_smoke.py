#!/usr/bin/env python3
"""
Smoke run of gpim_tpu_torch on one CUDA card: the quickest proof that the
port builds, that its kernels agree with their plain PyTorch versions, and
that its main path runs through them.

    python3 chip_smoke.py

Phases (each raises on failure, and the script then exits non-zero without
its final line):

1. device  - require CUDA; print the card, its power limit, torch/CUDA.
2. build   - compile csrc/gram_kernels.cu with nvcc; print the seconds.
3. kernels - K1/K2/K3 against their plain versions (evaluated in float64
             on the same inputs), in float32 and float64, at the flagship's
             shapes and at the BO paths' (bo25: K2/K3 at n = 128, K1 at
             128 x 128 and 640 x 128; its VFE surrogate: K1 at 5 x 5,
             5 x 128 and 640 x 5), and K1 also at the three shapes of the
             VFE path (Kmn, Kmm, one predict chunk's Ks) and at the six of
             the ckpfm4d Kronecker path (d = 1: the factors 10 x 10,
             64 x 64, 5 x 5 and a predict chunk's cross rows 4096 x 10,
             4096 x 64, 4096 x 5), the four of the masked-lattice rows
             (d = 1: the factors 128 x 128, 64 x 64, 32 x 32 and
             256 x 256), the two of the off-lattice rows (d = 1: the
             inducing-grid factors 36 x 36 and 70 x 70) and the three that
             only the two-rank world of phase parallel gives it (a VFE
             rank's Kmn 1027 x 15424 and predict tile 2048 x 1027, d = 3;
             a masked-lattice rank's factor block 32 x 64, d = 1), with
             the tolerances below; K4 (the off-lattice interpolation
             adjoint W^T v, a CSR sum by cell in a fixed order) at the two
             off-lattice rows' own shapes (ski_offlattice64x64x32: 39,424
             padded points on 36^3 cells; ski_offlattice128x128x64:
             314,624 on 70^3) with the block widths their paths give it (b
             = 9 in training, 1 in predict, 100 for the rank-0 Lanczos
             basis), normalized by the largest sum of |w v| over a cell,
             and bit for bit against its plain version run on the CPU in
             the same dtype (but at the 1M row's b = 100);
             float32 device time per call of each kernel, its plain version
             and (K1) torch.cdist, (K4, at every width) the index_add_ it
             replaced, beside the kernel's bound: K2, K3 and K4 from a warm
             loop of launches (_time_ms; K4 also from a CUDA graph), K1
             from a CUDA graph of calls (_time_graph_ms); at the 1M row's
             training block (b = 9) every piece of the off-lattice operator
             (K4, the mode products, the gather W step by step, the noise
             term, the whole) by warm loops, the gather beside its bound;
             the batched kernels at the multi-output eels64 shapes (T = 64
             tasks, n = 2048: K2, K3, and K1 on one 64 x 2048 x 2048
             predict chunk), and at one task-sharded rank's share of them
             (T = 32), against their plain versions in float32 and
             float64, each timed (a warm loop of launches) beside its
             bound, its plain version and (K1) batched torch.cdist.
4. flagship - reconstructor(X, R, X_full, kernel="RBF", iterations=250,
             precision="single").run() on the 128x128 spiral
             (gpim_tpu_torch/examples/_data.spiral_scan, the same arrays as
             examples/_data.py, n = 6144 padded training rows,
             16384 test points), cold then warm, built without use_gpu;
             rmse at the observed pixels < 0.1, no NaN, every kernel
             launched, every model tensor on the card.
5. vfe     - the BEPFM 3D sparse workflow (examples/hyperspectral_3d_sparse
             .py, benchmarks/suite.py bench_bepfm_3d_sparse):
             reconstructor(X, R, X_full, kernel="Matern52", sparse=True,
             indpoints=1000, learning_rate=0.05, iterations=400,
             precision="single").run() on the 32x32x102 cube with 70.6% of
             its spectra removed (n = 30848 padded rows, d = 3, m = 1027
             inducing points, 104448 test points), cold then warm, built
             without use_gpu; rmse against the full cube < 0.1, no NaN, K1
             launched, every model tensor on the card.
6. cross-check - the flagship and the VFE run in float64 (at the float32
             jitter) on the card against their float32 runs; and small exact
             and sparse problems on the card against the CPU path.
7. bo      - boptimizer, built without use_gpu: the three BO rows of
             benchmarks/suite.py at their own sizes (25x25 target, 5 seeds,
             200 iterations; EI 30 steps, the same with simulated
             measurements, CB batch of 8 for 10 steps; at the surrogate's
             default precision, float64, on the device step), cold then
             warm, with the suite's gates, and bo25 EI also at
             precision="single"; the full-width run at the default
             precision (float64; it must finish): EI, 8 steps, 250
             iterations, seeded with the flagship's spiral scan (n = 6144
             rows, 16384 candidates), on the device step and on the host
             loop, which must select the same points; a sparse surrogate
             (indpoints=24, 4 steps) in float32, then in float64 on both
             paths; bo25 EI in float64 on the card against the CPU path;
             every run's kernel launches against what its code implies;
             ties in the ranking in ascending index order on the card.
8. multi   - vreconstructor, built without use_gpu, at the two EELS
             "parallel GP" rows of benchmarks/suite.py (RBF, independent,
             100 iterations, float32): eels6 (6 channels of the band-
             averaged BEPFM cube on its 32x32 grid, half the pixels
             removed, n = 640 padded rows, a 2x denser 64x64 test grid) and
             eels64 (64 channels on a 64x64 grid, n = 2048, 4096 test
             points, the suite's rmse gate), cold then warm; eels6 in the
             correlated (Kronecker) mode; eels6 in float64 against float32;
             small problems in both modes on the card against the CPU;
             every run's launches against what its code implies (K2 and K3
             once an Adam step, K1 once for the Gram and once a predict
             chunk); the batched Cholesky and triangular-inverse options at
             the eels64 shape, timed.
9. sk      - skreconstructor, built without use_gpu, on its three ported
             routes: the cKPFM row of benchmarks/suite.py (ckpfm4d: the
             10x10x64x5 slab, a full grid of n = 32000 with no NaNs, so the
             exact Kronecker route; Matern52, 50 iterations, float32) cold
             then warm with rmse_fit < 0.1, and in float64 against float32
             (CKPFM_CROSS_TOL); the dense route on the flagship's spiral
             (RBF, 100 iterations, n = 6144 < 8192 padded rows) and the
             spectral route on it (Spectral, Q = 4, 100 iterations), each
             with rmse_obs < 0.1; small problems of every route on the
             card against the CPU in float64; every run's launches against
             what its code implies (ckpfm4d: K1 once a factor each step,
             once a factor and once a factor a chunk in predict; dense: K2
             and K3 each step, K1 for the Gram and each chunk; spectral:
             none).
10. mgrid   - skreconstructor, built without use_gpu, on its
             masked-lattice SKI route: the three masked rows of
             benchmarks/suite.py (RBF, learning rate 0.1, float32):
             ski_masked64x64x32 (the 64x64x32 random field with 70% of its
             spectra removed, 30 iterations) cold then warm with
             rmse_vs_truth < 0.75 data sd and in float64 against float32
             (MGRID_CROSS_TOL); mgrid_masked128x128x64 (1,048,576 cells,
             30 iterations) cold then warm and mgrid_masked256x256x64
             (4,194,304 cells, 10 iterations) once, each with every gate
             the suite raises on (rmse and an exact GP on 4000 observed
             points below 0.15 data sd, 1-sigma coverage >= 0.55 at
             observed and unobserved cells, model sd^2 >= 0.8 of the exact
             posterior variance from ski.mgrid_exact_var_probe at 64
             cells) and its peak device memory; every run's realized CG
             iterations, training segments and K1 launches against what
             its code implies (d (steps + segments + 2)); the masked mvm
             in both layouts and P^-1/2 timed at the 1M shape; the
             experimental warm-started CG (MaskedGridEngine.train(
             warm_start=True)) beside the cold one on ski_masked64x64x32
             and the 1M row: both realized-CG series, both walls, the
             final lengthscales' gap; the 1M engine's
             train_memory_analysis, its measured peak beside the analytic
             model; small masked problems card against CPU in float64.
11. ski     - skreconstructor, built without use_gpu, on its off-lattice
             SKI route (lattice=False: grid interpolation, RBF, learning
             rate 0.1, float32): ski_offlattice64x64x32 (the cube of
             ski_masked64x64x32, 39,328 points on a 36^3 inducing grid,
             30 iterations) cold, then warm twice, the two warm runs
             bit-equal in mean, sd and series (K4 sums in a fixed order),
             with rmse_vs_truth < 0.75 data sd beside the masked-lattice
             route's on the same cube, and in float64 against float32
             (OFFLATTICE_CROSS_TOL); the same cube at precond_rank=0 on
             both SKI routes (off-lattice, and the masked lattice, whose
             rank-0 predict is the port's own: CG to its tolerance and
             the LOVE variance) at the default cg_iterations, each with
             the same rmse gate and its realized predict iterations;
             ski_offlattice128x128x64 (the 1M analytic cube of
             mgrid_masked128x128x64, 314,624 points on a 70^3 grid, 10
             iterations) once, finite, its rmse and peak memory recorded,
             the operator and P^-1/2 at the CG block width timed beside the
             operator's bound; each run's realized CG iterations, segments
             and K1 launches against what its code implies (d (steps +
             segments + 1)) and K4 launches against the CG iterations
             each solve ran (_ski_k4_launches: one an iteration, two a
             backward, one for the mean, and at rank 0 one a Lanczos step
             and one for its cross rows); small problems on random 2D and
             3D coordinates (9216 rows) card against CPU in float64, on both
             variance paths (Nystrom; Lanczos at precond_rank=0) and with
             max_root.
12. parallel - the parallel layer (gpim_tpu_torch.parallel, mesh=): (a) a
             one-rank NCCL world (parallel.distributed.initialize), in which
             every public name runs with mesh=True on rows the script
             already runs - the flagship, the BEPFM VFE, eels6 correlated,
             ckpfm4d, ski_masked64x64x32, ski_offlattice64x64x32 and bo25
             EI - against its unsharded twin in the same process: results
             equal to float32 rtol 1e-6 (series included, the off-lattice
             row too since K4 sums in a fixed order), the same K1-K4
             launches, NCCL collectives issued; (b) two
             ranks sharing the card over gloo (python -m
             gpim_tpu_torch.parallel.mp_worker spec), at full width, each
             row cold then warm: eels64 task-sharded (T = 64, 32 channels
             a rank, n = 2048, 100 iterations, f32) with its rmse gate,
             the BEPFM VFE row-sharded (n = 30848, 15424 rows a rank, m =
             1027, Matern52, 400 steps) with rmse_vs_truth < 0.1, and
             ski_masked64x64x32 in blocks of its first grid axis (32 x 64 x
             32 cells a rank, all-to-alls in every mode product) with
             rmse_vs_truth < 0.75 data sd; against one-rank runs of the
             same rows: the gaps of mean, sd, lengthscale and noise
             (MULTI_CROSS_TOL, VFE_CROSS_TOL, MGRID_CROSS_TOL), of the
             step-0 loss (PARALLEL_LOSS0_RTOL) and which of eels64's
             channels are bit-equal (EELS64_BIT_EQUAL must all be),
             each rank's K1/K2/K3 launches and call shapes (its share
             only), collective calls and bytes (staged through the host or
             not), walls.
13. profile - torch.profiler over PROFILE_STEPS warm float32 training steps
             of the flagship, of the VFE run, of ckpfm4d and of the
             spectral row, MULTI_PROFILE_STEPS of eels6, eels64 and eels6
             correlated, MGRID_PROFILE_STEPS of mgrid_masked128x128x64 and
             of ski_offlattice64x64x32, and over one warm BO step (refit,
             predict, acquisition, ranking) of bo25 EI (float32) and of
             the spiral run (float64): device ms by kernel, the device's
             idle share, the host's synchronising calls a step and
             (ckpfm4d) the host time of eigh (printed; a profiler that
             records no device time prints "not measured" and fails
             nothing).
14. examples - each runner of gpim_tpu_torch/examples (the six
             examples/*.py workflows) once, warm, at its script's full
             budget on the card, its data made beforehand:
             sparse_image_2d (the spiral, RBF, 250 iterations; rmse_obs <
             0.1), hyperspectral_3d_sparse (the BEPFM VFE, 400 iterations;
             rmse_vs_truth < 0.1), eels_parallel_gp (6 channels, 100
             iterations, the 2x denser prediction), ckpfm_4d_ski (50
             iterations and the 2x-dense predict; rmse_fit < 0.1),
             large_masked_ski (64x64x32, 30 iterations; rmse_vs_truth < 0.75
             data sd) and with --xl (128x128x64; the same gate and the 1M
             row's variance gates), bayesian_optimization (25x25, EI, 20
             steps, 200 GP iterations, its checkpoint in a temporary
             directory); wall, train and predict s, peak memory, the
             script's quality number, launches against the counts each
             run implies; eels and the BO, which gate on nothing, must give
             finite output of the expected shape.
15. notebooks - each of the seven notebooks of
             gpim_tpu_torch/examples/notebooks once, warm, at its full
             budget on the card (gpim_tpu_torch.examples._notebook.execute,
             in a new temporary directory removed afterwards, its printed
             output kept aside): quickstart (48x48, exact RBF, 100
             iterations; rmse against its noiseless truth < 0.1),
             sparse_image_2d (rmse at the observed pixels < 0.1),
             hyperspectral_3d_sparse (rmse against the full cube < 0.1),
             eels_parallel_gp (finite, 64 x 64 x 6), ckpfm_4d_ski (rmse_fit
             < 0.1), large_masked_ski (rmse against the truth < 0.75 data
             sd) and bayesian_optimization (finite, its best value finite,
             its checkpoint written); wall, peak memory and the plot cells
             skipped (the only cells skipped); every model tensor on the
             card; launches against the counts its code implies.
16. trace   - utils.profiling.trace around a warm flagship run of
             PROFILE_STEPS training steps and its predict, three times, a
             new model each time, and the same run untraced: each exported
             Chrome trace must hold K1, K2 and K3 as CUDA kernel events as
             often as the run launched them.

Prints the kernels as one JSON line, then as its last line
{"ok": true, "device": {...}}.
"""

import importlib
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, _HERE)

ITERATIONS = 250
VFE = dict(kernel="Matern52", sparse=True, indpoints=1000,
           learning_rate=0.05, iterations=400)
TIMING_REPS = 50
# NVIDIA H100 SXM data sheet: HBM3 rate, and peaks outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"float32": 67e12, "float64": 34e12}
SOURCE = "gpim_tpu_torch/csrc/gram_kernels.cu"
# Normalized max error |kernel - plain_f64| / scale, set beforehand from
# the rounding of each kernel's arithmetic (see gram_kernels docstrings).
TOL = {
    "sqdist": {"float32": 1e-6, "float64": 1e-14},
    "masked_system": {"float32": 4e-6, "float64": 1e-13},
    "rbf_bwd_reductions": {"float32": 1e-4, "float64": 1e-12},
    # normalized by the largest sum of |w v| over a cell: a sum of a few
    # f32 products, each product and sum rounded once
    "interp_adjoint": {"float32": 1e-6, "float64": 1e-12},
}
# the kernels, in the order of the kernels line
KERNELS = ("sqdist", "masked_system", "rbf_bwd_reductions", "interp_adjoint")
# f32 flagship vs f64 flagship at the same jitter. Measured on an H100:
# mean 7.9e-4, sd 4.9e-4, noise 2.1e-8 apart, so those limits are tightened
# from tests/test_gpr.py:174-178 (5e-3, 5e-3, 1e-3). The final lengthscale
# differs by 2.06e-2: on this noise-free synthetic scan the likelihood is
# flat in the lengthscale and 250 Adam steps have not converged, so f32
# rounding moves where the run stops along that ridge, while the
# prediction agrees to < 1e-3. Its limit is 5e-2.
CROSS_TOL = {"mean_atol": 2e-3, "sd_atol": 2e-3, "ls_rtol": 5e-2,
             "noise_atol": 1e-6}
# f32 VFE run vs f64 VFE run at the same jitter. The VFE trains 1027 x 3
# inducing-point coordinates with the hyperparameters, and 400 Adam steps
# amplify f32 rounding: on an H100 the two runs ended with inducing points
# up to 16 grid units apart, mean 5.8e-2, sd 2.3e-2, lengthscale 5.5% and
# noise 18% apart, while both reached rmse_vs_truth ~0.02 (0.0224 vs
# 0.0195). So the end points are held to about twice those gaps, and
# precision itself by what stays on one path: the loss at step 0 (same
# parameters; 1.4e-7 apart) and a prediction in f64 from the f32 run's
# final parameters against the f32 prediction ("same_u_*"; mean 1.8e-3
# and sd 1.1e-5 apart, the mean through the f32 Cholesky of Kmm at jitter
# 1e-4), each held to a few times its measured gap.
VFE_CROSS_TOL = {"mean_atol": 1.2e-1, "sd_atol": 5e-2, "ls_rtol": 1.2e-1,
                 "noise_rtol": 4e-1, "rmse_diff": 1e-2, "loss0_rtol": 1e-6,
                 "same_u_mean_atol": 5e-3, "same_u_sd_atol": 1e-4}
SMALL_RTOL = 1e-7          # small problems, CUDA vs CPU, float64
PROFILE_STEPS = 10
TRACE_REPEATS = 3          # traced flagship runs in phase trace
# The BO rows of benchmarks/suite.py:87-213 at their own sizes, and the
# full-width BO run seeded with the flagship's spiral scan; refit_iterations
# is the boptimizer's default, gp_iterations // 4.
BO25_ITERATIONS = 200
BO25_ROWS = {
    "bo25_ei_explore": dict(acquisition_function="ei", exploration_steps=30),
    "bo25_ei_sim_device": dict(acquisition_function="ei",
                               exploration_steps=30,
                               simulate_measurement=True),
    "bo25_batch_explore": dict(acquisition_function="cb",
                               exploration_steps=10, batch_update=True,
                               batch_size=50, batch_out_max=8),
}
SPIRAL_BO = dict(acquisition_function="ei", exploration_steps=8,
                 gp_iterations=ITERATIONS, simulate_measurement=True)
BO_VFE = dict(acquisition_function="ei", exploration_steps=4, sparse=True,
              indpoints=24, simulate_measurement=True)
BO_RTOL = 1e-6             # float64 BO runs, two paths: vals_all
# float64 device step vs host loop: two picks tie when their acquisition
# values are this close, of the run's largest. On an H100 the spiral runs
# agree to 4.2e-13 while they select the same points, and part at step 4,
# where EI has underflowed to exactly 0 at every candidate and the device
# ranks the tie by ascending index, the host's argsort otherwise.
TIE_ATOL = 1e-9
# The multi-output rows of benchmarks/suite.py:249-275 (eels6) and 482-516
# (eels64): RBF, independent channels, 100 Adam steps at vreconstructor's
# default learning rate, float32 (the card's default precision).
MULTI = dict(kernel="RBF", independent=True, iterations=100)
MULTI_CHUNK = 2048           # vreconstructor's test points per chunk
MULTI_TIMING_REPS = 20       # each batched call moves >= 1 GB
MULTI_PROFILE_STEPS = 3
# eels6 in float32 against float64 at the float32 jitter. Measured on an
# H100: mean 7.2e-6, sd 1.2e-6, lengthscale 4.0e-5 and noise 1.0e-5 apart
# (relative for the last two): the channels' likelihoods are well curved
# and 100 steps converge in both precisions. Each limit is about ten times
# its measured gap.
MULTI_CROSS_TOL = {"mean_atol": 5e-5, "sd_atol": 1e-5, "ls_rtol": 4e-4,
                   "noise_rtol": 1e-4}
# The cKPFM row of benchmarks/suite.py:278-295 (bench_ckpfm_4d_ski), as
# the suite calls it: the 10x10x64x5 slab (_data.ckpfm_slab, the
# synthetic field: no expdata on the machine), float32 by the card's
# default. A full grid with no NaNs, n = 32000: the exact Kronecker route.
CKPFM = dict(kernel="Matern52", ski=True, grid_points_ratio=1.0,
             lengthscale=[1.0, 3.0], iterations=50)
CKPFM_LS = 2.3               # a trained lengthscale, for K1's operands
SK_CHUNK = 4096              # skreconstructor's test points per chunk
# skreconstructor's dense and spectral routes on the flagship's spiral
SK_DENSE = dict(kernel="RBF", iterations=100)
SK_SPECTRAL = dict(kernel="Spectral", n_mixtures=4, learning_rate=0.05,
                   iterations=100)
# ckpfm4d in float32 against float64 at the float32 jitter. Measured on an
# H100: mean 3.3e-6, sd 3.3e-7, lengthscale 7.4e-7 and noise 2.1e-7 apart
# (relative for the last two): the Kronecker likelihood is closed form,
# well curved, and 50 steps end at the same point in both precisions. Each
# limit is about ten times its measured gap.
CKPFM_CROSS_TOL = {"mean_atol": 5e-5, "sd_atol": 5e-6, "ls_rtol": 1e-5,
                   "noise_rtol": 3e-6}
# The masked-lattice rows of benchmarks/suite.py: ski_masked64x64x32
# (:298-330, bench_ski_masked_3d) and the 128x128x64 and 256x256x64 rows of
# _bench_mgrid_masked (:333-461, bench_mgrid_1m, bench_mgrid_4m), RBF at
# learning rate 0.1, float32 by the card's default: (shape, iterations).
MGRID = dict(kernel="RBF", learning_rate=0.1)
MGRID_ROWS = {"ski_masked64x64x32": ((64, 64, 32), 30),
              "mgrid_masked128x128x64": ((128, 128, 64), 30),
              "mgrid_masked256x256x64": ((256, 256, 64), 10)}
MGRID_LS = 12.0              # a trained lengthscale, for K1's operands
MGRID_PROFILE_STEPS = 3
# ski_masked64x64x32 in float32 against float64 at the float32 jitter.
# Measured on an H100: mean 6.8e-5, sd 4.4e-6, lengthscale 1.2e-4 and
# noise 1.9e-7 apart (relative for the last two), though float64 runs its
# CG to a far tighter tolerance (64 iterations a step where float32 takes
# 2-30): the probes are the same, so both estimate the same likelihood.
# Each limit is about ten times its measured gap.
MGRID_CROSS_TOL = {"mean_atol": 7e-4, "sd_atol": 5e-5, "ls_rtol": 1.2e-3,
                   "noise_rtol": 2e-6}
# The off-lattice rows: the cube of ski_masked64x64x32 and the 1M analytic
# cube of mgrid_masked128x128x64 through skreconstructor(lattice=False),
# the grid-interpolation route (choose_grid: 36^3 and 70^3 inducing
# points), RBF at learning rate 0.1, float32: (shape, iterations).
OFFLATTICE = dict(kernel="RBF", ski=True, lattice=False, learning_rate=0.1)
OFFLATTICE_ROWS = {"ski_offlattice64x64x32": ((64, 64, 32), 30),
                   "ski_offlattice128x128x64": ((128, 128, 64), 10)}
# ski_offlattice64x64x32 in float32 against float64 at the float32 jitter.
# Measured on an H100 (the first run of this phase, with MGRID_CROSS_TOL's
# limits): mean 4.5e-5, sd 1.6e-5, lengthscale 7.8e-5 and noise 8.0e-7
# apart (relative for the last two). Each limit is about ten times its
# measured gap.
OFFLATTICE_CROSS_TOL = {"mean_atol": 5e-4, "sd_atol": 2e-4,
                        "ls_rtol": 8e-4, "noise_rtol": 8e-6}


def log(msg):
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

def flagship_data():
    from gpim_tpu_torch.examples import _data
    from gpim_tpu_torch import utils
    R = _data.spiral_scan()
    return R, utils.get_sparse_grid(R), utils.get_full_grid(R)


def vfe_data():
    from gpim_tpu_torch.examples import _data
    from gpim_tpu_torch import utils
    R = _data.bepfm_cube(sparse=True)
    return R, utils.get_sparse_grid(R), utils.get_full_grid(R), \
        _data.bepfm_cube()


def bo25_target(idx):
    """The suite's 25x25 target: a Gaussian peak, 1 at (5, 10)."""
    return float(np.exp(-((idx[0] - 5.) ** 2 + (idx[1] - 10.) ** 2) / 20.0))


def bo25_data():
    """benchmarks/suite.py:92-106: the target seen at 5 random pixels;
    returns (seed grid, its sparse and full grids, the whole target)."""
    from gpim_tpu_torch import utils
    np.random.seed(0)
    grid = np.full((25, 25), np.nan)
    for i, j in np.random.randint(0, 25, (5, 2)):
        grid[i, j] = bo25_target((i, j))
    truth = np.array([[bo25_target((i, j)) for j in range(25)]
                      for i in range(25)])
    return grid, utils.get_sparse_grid(grid), utils.get_full_grid(grid), \
        truth


def quickstart_data():
    """quickstart.ipynb's image, made as its cell makes it: (noisy grid
    with 65% NaN, noiseless truth)."""
    rng = np.random.default_rng(0)
    xx, yy = np.meshgrid(np.arange(48), np.arange(48), indexing="ij")
    truth = np.sin(xx / 7.0) * np.cos(yy / 9.0)
    R = truth + 0.05 * rng.standard_normal(truth.shape)
    R[rng.random(R.shape) < 0.65] = np.nan
    return R, truth


def eels6_data():
    """benchmarks/suite.py:254-262: the BEPFM cube band-averaged into 6
    channels, normalised, half its 32x32 pixels removed; the test grid 2x
    denser (64x64)."""
    from gpim_tpu_torch.examples import _data
    from gpim_tpu_torch import utils
    cube = _data.bepfm_cube()
    bands = np.stack([cube[:, :, i * 15:(i + 1) * 15].mean(-1)
                      for i in range(6)], axis=-1)
    bands = (bands - bands.min()) / np.ptp(bands)
    rng = np.random.default_rng(0)
    Y = bands.copy()
    Y[rng.random(bands.shape[:2]) < 0.5] = np.nan
    X = utils.get_full_grid(Y[..., 0]).copy()
    X[:, np.isnan(Y[..., 0])] = np.nan
    return X, Y, utils.get_full_grid(Y[..., 0], dense_x=0.5)


def eels64_data():
    """benchmarks/suite.py:491-499: 64 smooth channels on a 64x64 grid with
    noise 0.02, half the pixels removed; returns (X, Y, the full grid, the
    noise-free fields)."""
    from scipy.ndimage import gaussian_filter
    from gpim_tpu_torch import utils
    rng = np.random.RandomState(3)
    g, T = 64, 64
    fields = gaussian_filter(rng.randn(g, g, T), sigma=(5, 5, 0))
    fields = (fields - fields.min()) / np.ptp(fields)
    Y = fields + 0.02 * rng.randn(g, g, T)
    Y[rng.random((g, g)) < 0.5] = np.nan
    X = utils.get_full_grid(Y[..., 0]).copy()
    X[:, np.isnan(Y[..., 0])] = np.nan
    return X, Y, utils.get_full_grid(Y[..., 0]), fields


def small_vector_data(seed=0):
    """12x12 grid, 3 channels, 30% of the pixels missing
    (tests/test_vgpr.py:15-28)."""
    from gpim_tpu_torch import utils
    rng = np.random.RandomState(seed)
    xx, yy = np.meshgrid(np.arange(12.0), np.arange(12.0), indexing="ij")
    base = np.exp(-((xx - 5) ** 2 + (yy - 7) ** 2) / 8.0)
    Y = np.stack([base * (k + 1) * 0.3 + 0.05 * rng.rand(12, 12)
                  for k in range(3)], axis=-1)
    drop = rng.rand(12, 12) < 0.3
    Y[drop] = np.nan
    X = utils.get_full_grid(Y[..., 0]).copy()
    X[:, drop] = np.nan
    return X, Y, utils.get_full_grid(Y[..., 0])


def ckpfm_data():
    """benchmarks/suite.py:281-283: the cKPFM slab and its full grid."""
    from gpim_tpu_torch.examples import _data
    from gpim_tpu_torch import utils
    R = _data.ckpfm_slab()
    return R, utils.get_full_grid(R)


def small_grid_data(seed=0):
    """An 8x8x6 full grid with a little noise, in [0, 1]
    (tests/test_torch_skgpr.py:_grid_data, smaller)."""
    rng = np.random.RandomState(seed)
    t = np.linspace(0, 4, 8)
    R = (np.sin(t)[:, None, None] * np.cos(t)[None, :, None]
         * np.linspace(1, 2, 6)[None, None, :])
    R = R + 0.01 * rng.randn(*R.shape)
    return (R - R.min()) / np.ptp(R)


def small_data(seed=0):
    """24x24 Gaussian bump with 40% of the pixels missing."""
    rng = np.random.RandomState(seed)
    ii, jj = np.indices((24, 24))
    R = np.exp(-((ii - 9.0) ** 2 + (jj - 14.0) ** 2) / 40.0)
    R = R + 0.01 * rng.randn(24, 24)
    R[rng.rand(24, 24) < 0.4] = np.nan
    return R


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device():
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke needs one GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log("[device] torch %s, CUDA %s, %d device(s), python %s" % (
        torch.__version__, torch.version.cuda, torch.cuda.device_count(),
        sys.version.split()[0]))
    return card


def phase_build():
    from gpim_tpu_torch.ops import _build
    res = _build.build()
    # ptxas -v: one line per kernel (mangled name from the kernel's own
    # name on, so the template arguments show; registers, spills)
    name = spill = ""
    for line in res.log.splitlines():
        if "Function properties for" in line:
            name = re.sub(r"^.*?\d+(?=(sqdist|masked_system|rbf_bwd|"
                          r"interp_adjoint(_runs)?)_kernel)", "",
                          line.split(" for ", 1)[1].strip())
        elif "spill" in line:
            spill = line.strip()
        elif "Used" in line and "registers" in line:
            log("[build] %s: %s; %s" % (name[:40], line.split(":", 1)[1]
                                        .strip(), spill))
        elif "error" in line:
            log("[build] " + line.strip())
    _build.load_library()
    log("[build] %s built in %.2f s" % (res.path.name, res.seconds))
    return res.seconds


def _time_ms(fn, reps=TIMING_REPS):
    """Device ms per call: CUDA events around a warm loop of ``reps``
    calls, one synchronise at its end, the window divided by ``reps``. The
    wrappers' host work (checks, allocation, the ctypes call) then overlaps
    the device's, as it does in the training loop. The flagship's calls
    move >= 100 MB, twice the card's 50 MB L2, so each call finds cold what
    the one before it touched, as the training loop does."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _time_graph_ms(fn, reps=TIMING_REPS):
    """Device ms per call with no host time in the window: ``reps`` calls
    captured into one CUDA graph, one replay timed by CUDA events, divided
    by ``reps``. K1's VFE shapes take a few microseconds on the card, less
    than the wrapper's host work, so a loop of calls (:func:`_time_ms`)
    times the host there; every K1 time is taken this way. Its Kmm (4 MB)
    and Ks (17 MB) outputs fit in the 50 MB L2, as they do in training."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / reps


def bound(name, n, d, m=None, dtype_name="float32", batch=1):
    """(least ms, "bytes" or "operations") the card could take for one call
    at these shapes (``batch`` tasks): the larger of the bytes it must move
    over the memory rate and its operations over the peak rate of their
    type."""
    from gpim_tpu_torch.ops.gram_kernels import min_traffic
    itemsize = 4 if dtype_name == "float32" else 8
    read, written, ops = min_traffic(name, n, d, m, itemsize, batch)
    t_bytes = (read + written) / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _norm_err(out, ref, scale):
    import torch
    err = (out.double() - ref).abs().max().item()
    return err, err / max(float(scale), torch.finfo(torch.float64).tiny)


def _check(name, dtype_name, err, nerr):
    tol = TOL[name][dtype_name]
    ok = nerr <= tol
    log("[kernels] %-19s %-7s max_abs_err %.3e  normalized %.3e  tol %.0e"
        "  %s" % (name, dtype_name, err, nerr, tol, "ok" if ok else "FAIL"))
    if not ok:
        raise AssertionError("%s %s disagrees with its plain version: "
                             "normalized error %.3e > %.0e"
                             % (name, dtype_name, nerr, tol))


def _sqdist_case(A, B, zeros, dname, timed):
    """K1 on (A, B) against its plain version; ``zeros`` (rows, cols) are
    coincident pairs that must come out exactly 0. Returns the record."""
    import torch
    from gpim_tpu_torch.ops import gram_kernels as gk
    out = gk.sqdist(A, B)
    ref = gk.sqdist_plain(A.double(), B.double())
    torch.cuda.synchronize()
    if not bool((out[zeros] == 0).all()):
        raise AssertionError("sqdist: coincident points are not exactly 0")
    err, nerr = _norm_err(out, ref, ref.abs().max())
    _check("sqdist", dname, err, nerr)
    rec = {"err": err, "shape": [len(A), len(B), A.shape[1]]}
    if timed:
        rec["ms"] = _time_graph_ms(lambda: gk.sqdist(A, B))
        # the same kernel timed as K2 and K3 are, host time overlapped
        rec["loop_ms"] = _time_ms(lambda: gk.sqdist(A, B))
        rec["plain_ms"] = _time_graph_ms(lambda: gk.sqdist_plain(A, B))
        # the nearest single call; it returns the root of K1's output
        rec["library_ms"] = _time_graph_ms(lambda: torch.cdist(A, B))
        rec["bound"] = bound("sqdist", len(A), A.shape[1], m=len(B),
                             dtype_name=dname)
    return rec


def _vfe_k1_inputs(vfe, dtype):
    """K1's three operand pairs on the VFE path, from the BEPFM cube at a
    trained model's lengthscales: Kmn (Xu, X), Kmm (Xu, Xu) and one predict
    chunk's Ks (test points, Xu), with their coincident pairs."""
    import torch
    from gpim_tpu_torch import utils
    from gpim_tpu_torch.gpreg import engine
    R, X, X_full, _ = vfe
    X_np, _ = utils.prepare_training_data(X, R)
    stride = len(X_np) // VFE["indpoints"]
    Xp, _ = engine.pad_rows(X_np, 128)
    ls = np.array([4.0, 4.0, 9.0])
    t = lambda a: torch.as_tensor(a / ls, dtype=dtype,  # noqa: E731
                                  device="cuda").contiguous()
    Xu, Xs = t(X_np[::stride]), t(Xp)
    Xt = t(utils.prepare_test_data(X_full)[:4096])
    Xt[:512] = Xu[:512]
    m = len(Xu)
    i = torch.arange(m, device="cuda")
    j = torch.arange(512, device="cuda")
    return [("Kmn", Xu, Xs, (i, i * stride)),
            ("Kmm", Xu, Xu, (i, i)),
            ("Ks", Xt, Xu, (j, j))]


def _parallel_k1_inputs(vfe, dtype):
    """K1's operand pairs that only the two-rank world gives it (phase
    parallel (b)): the row-sharded VFE rank's Kmn (Xu against its 15424 of
    the 30848 padded rows; rank 1's, the padding included) and its
    2048-row predict tile against Xu, and the masked-lattice rank's block
    of the first grid axis (32 of 64) against the whole axis, with their
    coincident pairs."""
    import torch
    from gpim_tpu_torch import utils
    from gpim_tpu_torch.gpreg import engine
    R, X, X_full, _ = vfe
    X_np, _ = utils.prepare_training_data(X, R)
    stride = len(X_np) // VFE["indpoints"]
    Xp, _ = engine.pad_rows(X_np, 128)
    half = len(Xp) // 2
    ls = np.array([4.0, 4.0, 9.0])
    t = lambda a: torch.as_tensor(a / ls, dtype=dtype,  # noqa: E731
                                  device="cuda").contiguous()
    Xu, Xs = t(X_np[::stride]), t(Xp[half:])
    Xt = t(utils.prepare_test_data(X_full)[MULTI_CHUNK:2 * MULTI_CHUNK])
    Xt[:512] = Xu[:512]
    i = torch.arange(len(Xu), device="cuda")
    i = i[(i * stride >= half) & (i * stride < len(X_np))]
    j = torch.arange(512, device="cuda")
    axis = torch.as_tensor(np.arange(64, dtype=np.float64)[:, None]
                           / MGRID_LS, dtype=dtype, device="cuda")
    k = torch.arange(32, device="cuda")
    return [("Kmn rank share", Xu, Xs, (i, i * stride - half)),
            ("Ks rank tile", Xt, Xu, (j, j)),
            ("factor block 32x64", axis[32:].contiguous(), axis,
             (k, k + 32))]


def _kron_k1_inputs(ckpfm, dtype):
    """K1's operand pairs on the ckpfm4d Kronecker path at a trained
    lengthscale, one feature each: every grid axis against itself (the
    factors) and the first predict chunk's coordinate along it against the
    axis (the cross rows), with their coincident pairs."""
    import torch
    from gpim_tpu_torch import utils
    R, X = ckpfm
    Xt = utils.prepare_test_data(X)[:SK_CHUNK]
    t = lambda a: torch.as_tensor(  # noqa: E731
        np.ascontiguousarray(a) / CKPFM_LS, dtype=dtype,
        device="cuda").contiguous()
    ar = lambda k: torch.arange(k, device="cuda")  # noqa: E731
    factors, crosses = [], []
    for k, g in enumerate(R.shape):
        axis = np.arange(g, dtype=np.float64)[:, None]
        factors.append(("factor %d" % g, t(axis), t(axis), (ar(g), ar(g))))
        idx = torch.as_tensor(Xt[:, k].astype(np.int64), device="cuda")
        crosses.append(("cross %dx%d" % (len(Xt), g), t(Xt[:, k:k + 1]),
                        t(axis), (ar(len(Xt)), idx)))
    # the factor of 10 and the cross rows against it appear twice
    return factors[1:] + crosses[1:]


def _mgrid_k1_inputs(dtype):
    """K1's operand pairs on the masked-lattice rows, one feature each: the
    grid factors 128 x 128, 64 x 64 and 32 x 32 (mgrid_masked128x128x64,
    ski_masked64x64x32) and 256 x 256 (mgrid_masked256x256x64), at a
    trained lengthscale; predict's cross factors on the same grids have the
    same shapes."""
    import torch
    out = []
    for g in (128, 64, 32, 256):
        a = torch.as_tensor(np.arange(g, dtype=np.float64)[:, None]
                            / MGRID_LS, dtype=dtype, device="cuda")
        i = torch.arange(g, device="cuda")
        out.append(("factor %d" % g, a, a, (i, i)))
    return out


def _ski_k1_inputs(dtype):
    """K1's operand pairs on the off-lattice rows, one feature each: the
    first axis of each inducing grid (choose_grid over the 64 and 128
    cells of that axis: 36 and 70 points, one step of padding at each end)
    against itself, at a trained lengthscale."""
    import torch
    out = []
    for cells, g in ((64, 34), (128, 68)):
        step = (cells - 1) / (g - 1)
        a = torch.as_tensor(np.linspace(-step, cells - 1 + step, g + 2)
                            [:, None] / MGRID_LS, dtype=dtype, device="cuda")
        i = torch.arange(g + 2, device="cuda")
        out.append(("factor %d" % (g + 2), a, a, (i, i)))
    return out


def _k4_layouts(dtype):
    """K4's operands on the two off-lattice rows: each row's observed
    points, padded to skreconstructor's 128-row bucket (the padded rows
    weigh 0), interpolated onto choose_grid's inducing grid and sorted by
    an SKIEngine on the card, which builds W's CSR layout; yields (row,
    engine)."""
    from gpim_tpu_torch import utils
    from gpim_tpu_torch.gpreg import engine, ski_model
    from gpim_tpu_torch.ops import ski
    for row in OFFLATTICE_ROWS:
        R = (ski_masked_data()[0] if row == "ski_offlattice64x64x32"
             else mgrid_data(OFFLATTICE_ROWS[row][0])[0])
        X_np, _ = utils.prepare_training_data(
            utils.get_sparse_grid(R), R,
            precision="single" if dtype.itemsize == 4 else "double")
        Xp, n = engine.pad_rows(X_np, 128)
        mask = np.zeros(len(Xp), Xp.dtype)
        mask[:n] = 1.0
        yield row, ski_model.SKIEngine("RBF", Xp, mask, ski.choose_grid(X_np),
                                       dtype, "cuda", precond_rank=0)


def _interp_adjoint_cases(dname, dtype, timed):
    """K4 against its plain version (in float64) at each off-lattice row's
    shape and at the block widths its paths give it (9: the training CG
    block; 1: the predict solve and mean; 100: the rank-0 Lanczos basis);
    two launches bit-equal, and bit-equal to the plain version run on the
    CPU in the same dtype (K4 sums in its order and rounding; left out at
    the 1M row's b = 100, 2 GB of rows in float64); in float32 each width
    timed beside its bound, its plain version and the index_add_ it
    replaced, and at the 1M row's b = 9 the operator's other pieces
    (:func:`_interp_operator_pieces`). Returns the records by row."""
    import torch
    from gpim_tpu_torch.ops import gram_kernels as gk
    out = {}
    for row, eng in _k4_layouts(dtype):
        lay = eng._layout
        n, S = eng._idx.shape
        d = S.bit_length() - 1
        lay64 = lay._replace(wgt=lay.wgt.double())
        abs64 = lay64._replace(wgt=lay64.wgt.abs())
        lay_cpu = gk.InterpLayout(lay.rowptr.cpu(), lay.src.cpu(),
                                  lay.wgt.cpu(), n, lay.G)
        recs = {}
        for b in (9, 1, 100):
            v = torch.randn(b, n, dtype=dtype, device="cuda")
            got = gk.interp_adjoint(lay, v)
            again = gk.interp_adjoint(lay, v)
            ref = gk.interp_adjoint_plain(lay64, v.double())
            scale = gk.interp_adjoint_plain(abs64, v.double().abs()).max()
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                raise AssertionError("interp_adjoint: two launches differ")
            err, nerr = _norm_err(got, ref, scale)
            kernel = ("runs" if lay.offsets and lay.G * b
                      >= gk._RUNS_MIN_OUTPUTS else "csr")
            log("[kernels]   interp_adjoint %s n = %d, G = %d, b = %d (%s "
                "kernel)" % (row, n, lay.G, b, kernel))
            _check("interp_adjoint", dname, err, nerr)
            rec = {"err": err, "shape": [n, d, lay.G, b], "kernel": kernel}
            if b < 100 or n < 100000:
                cpu = gk.interp_adjoint_plain(lay_cpu, v.cpu())
                rec["bit_equal_cpu"] = torch.equal(got.cpu(), cpu)
                log("[kernels]   interp_adjoint %s b = %d: bit-equal to the "
                    "plain version on the CPU: %s"
                    % (row, b, rec["bit_equal_cpu"]))
                if not rec["bit_equal_cpu"]:
                    raise AssertionError(
                        "interp_adjoint: differs from the plain version on "
                        "the CPU (largest gap %.3e)"
                        % (got.cpu() - cpu).abs().max().item())
                del cpu
            if timed:
                flat = eng._idx.reshape(-1)
                wgt = eng._wgt
                rec["ms"] = _time_ms(lambda: gk.interp_adjoint(lay, v))
                rec["graph_ms"] = _time_graph_ms(
                    lambda: gk.interp_adjoint(lay, v))
                rec["plain_ms"] = _time_ms(
                    lambda: gk.interp_adjoint_plain(lay, v))
                # the index_add_ this kernel replaced (ops/ski.py before
                # it), on the same inputs
                rec["library_ms"] = _time_ms(
                    lambda: v.new_zeros((lay.G, b)).index_add_(
                        0, flat, (wgt[:, :, None] * v.mT[:, None, :])
                        .reshape(n * S, b)))
                rec["bound"] = bound("interp_adjoint", n, d, m=lay.G,
                                     dtype_name=dname, batch=b)
                if b == 9 and n > 100000:
                    rec["operator"] = _interp_operator_pieces(eng, v)
            recs["b%d" % b] = rec
            del v, got, again, ref
        out[row] = recs
        del eng, lay, lay64, abs64, lay_cpu
        torch.cuda.empty_cache()
    return out


def _interp_operator_pieces(eng, v):
    """Float32 device ms a call of each piece of the off-lattice operator
    W K_UU W^T v + noise v (``ops/ski.py`` ``make_interp_mvm``) on the
    block ``v`` (b, n), warm loops: W^T (K4), the d mode products, the
    gather W (``_interp_apply``: ``index_select`` of the 2^d corners'
    rows, the weighting, the sum over corners) with each of its three
    steps alone, the noise term and the whole operator. The gather's bound:
    it reads the (G, b) block, the int64 corner indices and the weights and
    writes (b, n), over the memory rate."""
    import torch
    from gpim_tpu_torch.ops import gram_kernels as gk
    from gpim_tpu_torch.ops import ski
    n, S = eng._idx.shape
    b, G = v.shape[0], eng._layout.G
    item = v.element_size()
    factors = ski.grid_kernel_factors(
        "RBF", {"lengthscale": torch.tensor(MGRID_LS, device="cuda",
                                            dtype=v.dtype),
                "variance": torch.tensor(1.0, device="cuda",
                                         dtype=v.dtype)}, eng._grids)
    gshape = tuple(eng.grid_shape) + (b,)
    lay, idx, wgt = eng._layout, eng._idx, eng._wgt
    flat = idx.reshape(-1)
    t = ski.modeprod(factors, gk.interp_adjoint(lay, v).reshape(gshape)) \
        .reshape(G, b)
    rows = t.index_select(0, flat)
    prods = rows.reshape(n, S, b) * wgt[:, :, None]
    summed = prods.sum(1)
    mvm = ski.make_interp_mvm(idx, wgt, eng.grid_shape, lay)
    noise = 1e-3
    out = {"interp_adjoint_ms": _time_ms(lambda: gk.interp_adjoint(lay, v)),
           "modeprod_ms": _time_ms(
               lambda: ski.modeprod(factors, t.reshape(gshape))),
           "gather_ms": _time_ms(lambda: ski._interp_apply(idx, wgt, t)),
           "gather_index_select_ms": _time_ms(lambda: t.index_select(0, flat)),
           "gather_weight_ms": _time_ms(
               lambda: rows.reshape(n, S, b) * wgt[:, :, None]),
           "gather_sum_ms": _time_ms(lambda: prods.sum(1)),
           "noise_add_ms": _time_ms(lambda: summed.mT + noise * v),
           "operator_ms": _time_ms(lambda: mvm(factors, noise, v), 20)}
    out["gather_bound_ms"] = ((G * b + n * S + b * n) * item + n * S * 8) \
        / PEAK_BYTES_PER_S * 1e3
    log("[kernels] off-lattice operator at n = %d, G = %d, b = %d, float32, "
        "ms a call: %s" % (n, G, b, ", ".join(
            "%s %.4f" % (k[:-3], x) for k, x in out.items())))
    return out


def _bo_kernel_inputs(dtype):
    """The operands the BO paths give the kernels, from the bo25 target at
    lengthscales of a trained model (3.7 and 4.3 px, which no binary
    fraction represents, so the products round as in a run): the exact surrogate's training rows (the 5 seeds
    and 30 measurements, padded to 128) with their mask, targets and
    scaled coordinates; K1's pairs at its predict (the training Gram and
    the one 640-row test chunk) and at the VFE surrogate's (its 5 inducing
    points: Kmm, Kmn against the seed's 128 padded rows, the chunk's Ks),
    with their coincident pairs."""
    import torch
    from gpim_tpu_torch import utils
    from gpim_tpu_torch.gpreg import engine
    grid, _, X_full, truth = bo25_data()
    rng = np.random.RandomState(1)
    free = np.flatnonzero(np.isnan(grid.ravel()))
    grown = grid.copy().ravel()
    picks = rng.choice(free, 30, replace=False)
    grown[picks] = truth.ravel()[picks]
    grown = grown.reshape(grid.shape)
    ls = np.array([3.7, 4.3])
    t = lambda a: torch.as_tensor(a, dtype=dtype,  # noqa: E731
                                  device="cuda").contiguous()

    def rows(g):
        X_np, y_np = utils.prepare_training_data(utils.get_sparse_grid(g), g)
        return X_np, y_np, engine.pad_rows(X_np, 128)[0]
    X_np, y_np, Xp = rows(grown)
    X5, _, X5p = rows(grid)
    Xt_np = utils.prepare_test_data(X_full)
    at = {tuple(x): i for i, x in enumerate(Xt_np)}
    Xt_np = engine.chunk_rows(Xt_np, 640)[0][0]
    n_obs, m = len(X_np), len(X5)
    mask = np.zeros(len(Xp))
    mask[:n_obs] = 1.0
    Xs, Xt, Xu = t(Xp / ls), t(Xt_np / ls), t(X5 / ls)
    ar = lambda k: torch.arange(k, device="cuda")  # noqa: E731
    ids = lambda Xa: torch.as_tensor(  # noqa: E731
        [at[tuple(x)] for x in Xa], device="cuda")
    return {
        "Xs": Xs, "Xr": t(Xp), "Xt": Xt, "Xu": Xu, "mask": t(mask),
        "y": t(engine.pad_rows(y_np, 128)[0]),
        "sqdist": [("Kxx", Xs, Xs, (ar(n_obs), ar(n_obs))),
                   ("Ks", Xt, Xs, (ids(X_np), ar(n_obs))),
                   ("VFE Kmm", Xu, Xu, (ar(m), ar(m))),
                   ("VFE Kmn", Xu, t(X5p / ls), (ar(m), ar(m))),
                   ("VFE Ks", Xt, Xu, (ids(X5), ar(m)))]}


def _quickstart_kernel_inputs(dtype):
    """The operands quickstart.ipynb gives the kernels, from its own image
    at lengthscales of a trained model (5.3 and 6.7 px): the training rows
    (the observed pixels, padded to 128) with their mask, targets and
    scaled coordinates, and K1's pairs at its predict (the training Gram
    and the one test chunk of every pixel) with their coincident pairs."""
    import torch
    from gpim_tpu_torch import utils
    from gpim_tpu_torch.gpreg import engine
    R, _ = quickstart_data()
    ls = np.array([5.3, 6.7])
    t = lambda a: torch.as_tensor(a, dtype=dtype,  # noqa: E731
                                  device="cuda").contiguous()
    X_np, y_np = utils.prepare_training_data(utils.get_sparse_grid(R), R)
    Xp, n_obs = engine.pad_rows(X_np, 128)
    Xt_np = utils.prepare_test_data(utils.get_full_grid(R))
    at = {tuple(x): i for i, x in enumerate(Xt_np)}
    mask = np.zeros(len(Xp))
    mask[:n_obs] = 1.0
    Xs, Xt = t(Xp / ls), t(Xt_np / ls)
    ar = torch.arange(n_obs, device="cuda")
    ids = torch.as_tensor([at[tuple(x)] for x in X_np], device="cuda")
    return {
        "Xs": Xs, "Xr": t(Xp), "mask": t(mask),
        "y": t(engine.pad_rows(y_np, 128)[0]),
        "sqdist": [("Kxx", Xs, Xs, (ar, ar)), ("Ks", Xt, Xs, (ids, ar))]}


def _masked_system_case(Xs, mask, vt, njt, at, dname):
    """K2 against its plain version for all three kernel families; returns
    the largest absolute error."""
    import torch
    from gpim_tpu_torch.ops import gram_kernels as gk
    errs = []
    for kernel in ("RBF", "Matern52", "RationalQuadratic"):
        a = at if kernel == "RationalQuadratic" else None
        Kt, A = gk.masked_system(Xs, mask, vt, njt, a, kernel=kernel)
        Kr, Ar = gk.masked_system_plain(
            Xs.double(), mask.double(), vt.double(), njt.double(),
            None if a is None else a.double(), kernel=kernel)
        torch.cuda.synchronize()
        if not bool((torch.diagonal(Kt) == vt).all()):
            raise AssertionError("masked_system: diagonal is not v")
        ek, nk = _norm_err(Kt, Kr, Kr.abs().max())
        ea, na = _norm_err(A, Ar, Ar.abs().max())
        log("[kernels]   masked_system %s n = %d: Kt %.3e, A %.3e"
            % (kernel, len(Xs), ek, ea))
        errs.append((max(ek, ea), max(nk, na)))
    err, nerr = max(errs)
    _check("masked_system", dname, err, nerr)
    return err


def _rbf_bwd_case(Xs, Xr, mask, y, vt, njt, dname):
    """K3 against its plain version on an SPD Ainv built from the real
    masked RBF system; returns (largest absolute error, K3's operands)."""
    import torch
    from gpim_tpu_torch.ops import gram_kernels as gk
    from gpim_tpu_torch.ops.linalg import safe_cholesky
    from gpim_tpu_torch.ops.tri import tri_inverse
    Kt, A = gk.masked_system(Xs, mask, vt, njt, kernel="RBF")
    L, info = safe_cholesky(A)
    if int(info.item()) != 0:
        raise AssertionError("Cholesky of the K3 test system failed")
    V = tri_inverse(L)
    alpha = V.T @ (V @ (y * mask))
    ops = (V.T @ V, Kt, alpha, mask, Xr)
    got = gk.rbf_bwd_reductions(*ops)
    d64 = [x.double() for x in ops]
    ref = gk.rbf_bwd_reductions_plain(*d64)
    absW = ((d64[0] - d64[2][:, None] * d64[2][None, :]).abs()
            * (d64[3][:, None] * d64[3][None, :]) * d64[1].abs())
    row_scale = absW.sum(dim=1).max()
    scales = (absW.sum(), row_scale, row_scale * d64[4].abs().max(),
              (torch.diagonal(d64[0]) * d64[3] ** 2).abs().sum())
    errs = [_norm_err(g_, r_, s_) for g_, r_, s_ in zip(got, ref, scales)]
    err, nerr = max(e for e, _ in errs), max(ne for _, ne in errs)
    log("[kernels]   rbf_bwd_reductions n = %d S1/rw/WX/diagsum normalized: "
        % len(Xs) + ", ".join("%.3e" % ne for _, ne in errs))
    _check("rbf_bwd_reductions", dname, err, nerr)
    return err, ops


def _eels64_kernel_inputs(eels64, dtype):
    """The operands the eels64 path gives the batched kernels: the 64
    channels' padded training rows (n = 2048) scaled by per-channel
    lengthscales of a trained model (3-6 px, drawn from a seed), the mask,
    v and noise + jitter per channel, and the first predict chunk's 2048
    test points scaled the same way, its first 512 coincident with
    training points."""
    import torch
    from gpim_tpu_torch import utils
    from gpim_tpu_torch.gpreg import engine
    X, Y, Xf, _ = eels64
    X_np, Y_np = utils.prepare_training_data(X, Y, vector_valued=True)
    Xp, n_obs = engine.pad_rows(X_np, 128)
    Yp, _ = engine.pad_rows(Y_np, 128)
    T = Y_np.shape[1]
    rng = np.random.RandomState(4)
    ls = 3.0 + 3.0 * rng.rand(T, 1, 2)
    mask = np.zeros(len(Xp))
    mask[:n_obs] = 1.0
    t = lambda a: torch.as_tensor(a, dtype=dtype,  # noqa: E731
                                  device="cuda").contiguous()
    Xs = t(Xp[None] / ls)
    Xt = t(utils.prepare_test_data(Xf)[:MULTI_CHUNK][None] / ls)
    Xt[:, :512] = Xs[:, :512]
    return {"Xs": Xs, "Xt": Xt, "Xr": t(Xp), "mask": t(mask),
            "y": t(Yp.T - np.nanmean(Y_np, axis=0)[:, None]) * t(mask),
            "v": t(0.05 + 0.1 * rng.rand(T)),
            "nj": t(1e-4 + 1e-3 * (1.0 + rng.rand(T))), "n_obs": n_obs}


def _per_task_err(out, ref, scales):
    """Largest absolute and normalised error over the tasks, each task
    against its own scale."""
    errs = [_norm_err(o, r, s) for o, r, s in zip(out, ref, scales)]
    return max(e for e, _ in errs), max(ne for _, ne in errs)


def _batched_cases(eels64, dname, timed):
    """K1, K2 and K3 with their task axis at the eels64 shapes against
    their plain versions (each task at its own scale); timed in float32.
    Returns {kernel: record}."""
    import torch
    from gpim_tpu_torch.ops import gram_kernels as gk
    from gpim_tpu_torch.ops.linalg import safe_cholesky
    from gpim_tpu_torch.ops.tri import tri_inverse
    dtype = getattr(torch, dname)
    b = _eels64_kernel_inputs(eels64, dtype)
    Xs, Xt, mask, v, nj = b["Xs"], b["Xt"], b["mask"], b["v"], b["nj"]
    T, n, d = Xs.shape
    log("[kernels] eels64 batched shapes: T = %d tasks, n = %d (%d observed),"
        " predict chunk %d, d = %d, %s" % (T, n, b["n_obs"], Xt.shape[1], d,
                                           dname))
    out = {}

    # K1 on one predict chunk: (T, 2048, d) x (T, n, d)
    D = gk.sqdist(Xt, Xs)
    ref = gk.sqdist_plain(Xt.double(), Xs.double())
    torch.cuda.synchronize()
    j = torch.arange(512, device="cuda")
    if not bool((D[:, j, j] == 0).all()):
        raise AssertionError("batched sqdist: coincident points are not 0")
    err, nerr = _per_task_err(D, ref, ref.abs().amax(dim=(1, 2)))
    del D, ref
    _check("sqdist", dname, err, nerr)
    out["sqdist"] = {"err": err, "shape": [T, Xt.shape[1], n, d]}

    # K2 on the training system
    Kt, A = gk.masked_system(Xs, mask, v, nj, kernel="RBF")
    Kr, Ar = gk.masked_system_plain(Xs.double(), mask.double(), v.double(),
                                    nj.double(), kernel="RBF")
    torch.cuda.synchronize()
    if not bool((torch.diagonal(Kt, dim1=-2, dim2=-1) == v[:, None]).all()):
        raise AssertionError("batched masked_system: diagonal is not v")
    ek, nk = _per_task_err(Kt, Kr, v.double())
    ea, na = _per_task_err(A, Ar, v.double() + 1.0)
    del Kr, Ar
    _check("masked_system", dname, max(ek, ea), max(nk, na))
    out["masked_system"] = {"err": max(ek, ea), "shape": [T, n, d]}

    # K3 on the real system's inverse
    L, info = safe_cholesky(A)
    if int(info.abs().max().item()) != 0:
        raise AssertionError("Cholesky of the eels64 K3 test system failed")
    del A
    V = tri_inverse(L)
    del L
    alpha = (V.mT @ (V @ b["y"][..., None]))[..., 0]
    Ainv = V.mT @ V
    del V
    ops = (Ainv, Kt, alpha, mask, b["Xr"])
    got = gk.rbf_bwd_reductions(*ops)
    Xr64, m64 = b["Xr"].double(), mask.double()
    errs = []
    for t in range(T):
        a64, k64, al64 = Ainv[t].double(), Kt[t].double(), alpha[t].double()
        ref = gk.rbf_bwd_reductions_plain(a64, k64, al64, m64, Xr64)
        absW = ((a64 - al64[:, None] * al64[None, :]).abs()
                * (m64[:, None] * m64[None, :]) * k64.abs())
        row = absW.sum(dim=1).max()
        scales = (absW.sum(), row, row * Xr64.abs().max(),
                  (torch.diagonal(a64) * m64 ** 2).abs().sum())
        errs += [_norm_err(g_[t], r_, s_)
                 for g_, r_, s_ in zip(got, ref, scales)]
    err, nerr = max(e for e, _ in errs), max(ne for _, ne in errs)
    _check("rbf_bwd_reductions", dname, err, nerr)
    out["rbf_bwd_reductions"] = {"err": err, "shape": [T, n, d]}

    if timed:
        reps = MULTI_TIMING_REPS
        r = out["sqdist"]
        r["ms"] = _time_ms(lambda: gk.sqdist(Xt, Xs), reps)
        r["plain_ms"] = _time_ms(lambda: gk.sqdist_plain(Xt, Xs), reps)
        r["library_ms"] = _time_ms(lambda: torch.cdist(Xt, Xs), reps)
        r["bound"] = bound("sqdist", Xt.shape[1], d, m=n, batch=T)
        r = out["masked_system"]
        r["ms"] = _time_ms(
            lambda: gk.masked_system(Xs, mask, v, nj, kernel="RBF"), reps)
        r["plain_ms"] = _time_ms(
            lambda: gk.masked_system_plain(Xs, mask, v, nj, kernel="RBF"),
            reps)
        r["library_ms"] = None
        r["bound"] = bound("masked_system", n, d, batch=T)
        r = out["rbf_bwd_reductions"]
        r["ms"] = _time_ms(lambda: gk.rbf_bwd_reductions(*ops), reps)
        r["plain_ms"] = _time_ms(
            lambda: gk.rbf_bwd_reductions_plain(*ops), reps)
        r["library_ms"] = None
        r["bound"] = bound("rbf_bwd_reductions", n, d, batch=T)
    del ops, Ainv, Kt, got
    torch.cuda.empty_cache()
    return out


def phase_kernels(R, X, X_full, vfe, eels64, ckpfm):
    """Each kernel against its plain version at the flagship's shapes, at
    the BO paths' and at quickstart.ipynb's, batched at eels64's and at one task-sharded rank's
    share of it, and K1 also at the VFE path's, the ckpfm4d Kronecker
    path's, the SKI rows' and the two-rank world's shapes."""
    import torch
    from gpim_tpu_torch import utils
    from gpim_tpu_torch.gpreg import engine
    from gpim_tpu_torch.ops import gram_kernels as gk

    dev = torch.device("cuda")
    X_np, y_np = utils.prepare_training_data(X, R)
    Xp, n_obs = engine.pad_rows(X_np, 128)
    yp, _ = engine.pad_rows(y_np, 128)
    mask_np = np.zeros(len(Xp))
    mask_np[:n_obs] = 1.0
    Xt_np = utils.prepare_test_data(X_full)[:4096]
    ls = np.array([3.0, 2.5])          # hyperparameters of a trained model
    v, noise, jitter, rq_alpha = 0.08, 3e-3, 1e-4, 1.3
    n = len(Xp)
    log("[kernels] training rows n = %d (%d observed), test chunk %d, d = %d"
        % (n, n_obs, len(Xt_np), Xp.shape[1]))
    report = {}
    for dtype in (torch.float32, torch.float64):
        dname = str(dtype).split(".")[-1]
        t = lambda a: torch.as_tensor(a, dtype=dtype, device=dev)  # noqa
        Xs = t(Xp / ls).contiguous()
        mask = t(mask_np)
        y = t(yp)

        # K1 at the predict cross-Gram shape, a coincident block included
        A1 = t(Xt_np / ls).contiguous()
        A1[:512] = Xs[:512]
        j = torch.arange(512, device=dev)
        timed = dtype == torch.float32
        rec = {"sqdist": _sqdist_case(A1, Xs, (j, j), dname, timed)}
        # K1 at the VFE path's three shapes
        rec["sqdist"]["vfe_shapes"] = {}
        for label, A, B, zeros in _vfe_k1_inputs(vfe, dtype):
            log("[kernels]   sqdist VFE %s %d x %d, d = %d"
                % (label, len(A), len(B), A.shape[1]))
            rec["sqdist"]["vfe_shapes"][label] = _sqdist_case(
                A, B, zeros, dname, timed)
        # K1 at the ckpfm4d Kronecker path's one-feature shapes
        rec["sqdist"]["kron_shapes"] = {}
        for label, A, B, zeros in _kron_k1_inputs(ckpfm, dtype):
            log("[kernels]   sqdist ckpfm4d %s, d = 1" % label)
            rec["sqdist"]["kron_shapes"][label] = _sqdist_case(
                A, B, zeros, dname, timed)
        # K1 at the masked-lattice rows' one-feature factor shapes
        rec["sqdist"]["mgrid_shapes"] = {}
        for label, A, B, zeros in _mgrid_k1_inputs(dtype):
            log("[kernels]   sqdist masked lattice %s, d = 1" % label)
            rec["sqdist"]["mgrid_shapes"][label] = _sqdist_case(
                A, B, zeros, dname, timed)
        # K1 at the off-lattice rows' one-feature inducing-grid factors
        rec["sqdist"]["ski_shapes"] = {}
        for label, A, B, zeros in _ski_k1_inputs(dtype):
            log("[kernels]   sqdist off-lattice %s, d = 1" % label)
            rec["sqdist"]["ski_shapes"][label] = _sqdist_case(
                A, B, zeros, dname, timed)
        # K1 at the shapes only the two-rank world gives it
        rec["sqdist"]["parallel_shapes"] = {}
        for label, A, B, zeros in _parallel_k1_inputs(vfe, dtype):
            log("[kernels]   sqdist two-rank %s %d x %d, d = %d"
                % (label, len(A), len(B), A.shape[1]))
            rec["sqdist"]["parallel_shapes"][label] = _sqdist_case(
                A, B, zeros, dname, timed)
        del A1, A, B

        # K2 at the training system shape, all three kernel families
        vt, njt, at = t(v), t(noise + jitter), t(rq_alpha)
        err = _masked_system_case(Xs, mask, vt, njt, at, dname)
        rec["masked_system"] = {"err": err}
        if dtype == torch.float32:
            rec["masked_system"]["ms"] = _time_ms(
                lambda: gk.masked_system(Xs, mask, vt, njt, kernel="RBF"))
            rec["masked_system"]["plain_ms"] = _time_ms(
                lambda: gk.masked_system_plain(Xs, mask, vt, njt,
                                               kernel="RBF"))
            rec["masked_system"]["library_ms"] = None
            rec["masked_system"]["bound"] = bound("masked_system", n,
                                                  Xs.shape[1])

        # K3 on an SPD Ainv built from the real masked RBF system
        Xr = t(Xp).contiguous()
        err, ops = _rbf_bwd_case(Xs, Xr, mask, y, vt, njt, dname)
        rec["rbf_bwd_reductions"] = {"err": err}
        if dtype == torch.float32:
            rec["rbf_bwd_reductions"]["ms"] = _time_ms(
                lambda: gk.rbf_bwd_reductions(*ops))
            rec["rbf_bwd_reductions"]["plain_ms"] = _time_ms(
                lambda: gk.rbf_bwd_reductions_plain(*ops))
            rec["rbf_bwd_reductions"]["library_ms"] = None
            rec["rbf_bwd_reductions"]["bound"] = bound(
                "rbf_bwd_reductions", n, Xr.shape[1])
        del ops
        torch.cuda.empty_cache()

        # every kernel at the shapes the BO paths give it
        bo = _bo_kernel_inputs(dtype)
        log("[kernels] BO shapes: bo25 training rows n = %d (%d observed), "
            "test chunk %d, d = %d; VFE surrogate m = %d"
            % (len(bo["Xs"]), int(bo["mask"].sum().item()), len(bo["Xt"]),
               bo["Xs"].shape[1], len(bo["Xu"])))
        for label, A, B, zeros in bo["sqdist"]:
            log("[kernels]   sqdist BO %s %d x %d" % (label, len(A), len(B)))
            rec["sqdist"].setdefault("bo_shapes", {})[label] = _sqdist_case(
                A, B, zeros, dname, False)
        shape = list(bo["Xs"].shape)
        err = _masked_system_case(bo["Xs"], bo["mask"], vt, njt, at, dname)
        rec["masked_system"]["bo_shapes"] = {
            "bo25": {"err": err, "shape": shape}}
        err, _ = _rbf_bwd_case(bo["Xs"], bo["Xr"], bo["mask"], bo["y"], vt,
                               njt, dname)
        rec["rbf_bwd_reductions"]["bo_shapes"] = {
            "bo25": {"err": err, "shape": shape}}
        del bo
        # every kernel at the shapes quickstart.ipynb gives it
        qs = _quickstart_kernel_inputs(dtype)
        log("[kernels] quickstart shapes: training rows n = %d (%d "
            "observed), test chunk %d, d = %d"
            % (len(qs["Xs"]), int(qs["mask"].sum().item()),
               len(qs["sqdist"][1][1]), qs["Xs"].shape[1]))
        rec["sqdist"]["quickstart_shapes"] = {}
        for label, A, B, zeros in qs["sqdist"]:
            log("[kernels]   sqdist quickstart %s %d x %d"
                % (label, len(A), len(B)))
            rec["sqdist"]["quickstart_shapes"][label] = _sqdist_case(
                A, B, zeros, dname, False)
        shape = list(qs["Xs"].shape)
        err = _masked_system_case(qs["Xs"], qs["mask"], vt, njt, at, dname)
        rec["masked_system"]["quickstart_shapes"] = {
            "quickstart": {"err": err, "shape": shape}}
        err, _ = _rbf_bwd_case(qs["Xs"], qs["Xr"], qs["mask"], qs["y"], vt,
                               njt, dname)
        rec["rbf_bwd_reductions"]["quickstart_shapes"] = {
            "quickstart": {"err": err, "shape": shape}}
        del qs
        # every kernel with its task axis at the multi-output eels64 shapes
        for name, r in _batched_cases(eels64, dname, timed).items():
            rec[name]["batched_shapes"] = {"eels64": r}
        # and at one task-sharded rank's share of them (32 of the 64)
        X, Y, Xf, fields = eels64
        share = (X, Y[..., Y.shape[-1] // 2:], Xf,
                 fields[..., fields.shape[-1] // 2:])
        for name, r in _batched_cases(share, dname, timed).items():
            rec[name]["batched_shapes"]["eels64 rank share"] = r
        # K4 at the off-lattice rows' shapes; its top record is the 1M
        # row's training block
        k4 = _interp_adjoint_cases(dname, dtype, timed)
        rec["interp_adjoint"] = dict(k4["ski_offlattice128x128x64"]["b9"],
                                     ski_shapes=k4)
        report[dname] = rec
    def show(name, r, reps=TIMING_REPS):
        log("[kernels] %-19s float32 kernel %.4f ms%s, plain %.4f ms, "
            "library %s ms, bound %.4f ms (%s), %.0f%% of bound (%s of %d)"
            % (name, r["ms"], "" if "loop_ms" not in r else
               " (%.4f in a loop of calls)" % r["loop_ms"], r["plain_ms"],
               "none" if r["library_ms"] is None else
               "%.4f" % r["library_ms"], r["bound"][0], r["bound"][1],
               100 * r["bound"][0] / r["ms"],
               "graph" if "loop_ms" in r else "warm loop", reps))
    for name, r in report["float32"].items():
        show(name, r)
    for row, recs in report["float32"]["interp_adjoint"]["ski_shapes"] \
            .items():
        for key, r in recs.items():
            show("interp_adjoint %s %s" % (row, key), r)
            log("[kernels] interp_adjoint %s %s: %.4f ms by a CUDA graph of "
                "%d launches, %.0f%% of bound" % (
                    row, key, r["graph_ms"], TIMING_REPS,
                    100 * r["bound"][0] / r["graph_ms"]))
    for label, r in report["float32"]["sqdist"]["vfe_shapes"].items():
        show("sqdist VFE " + label, r)
    for label, r in report["float32"]["sqdist"]["kron_shapes"].items():
        show("sqdist ckpfm4d " + label, r)
    for label, r in report["float32"]["sqdist"]["mgrid_shapes"].items():
        show("sqdist mgrid " + label, r)
    for label, r in report["float32"]["sqdist"]["ski_shapes"].items():
        show("sqdist off-lattice " + label, r)
    for label, r in report["float32"]["sqdist"]["parallel_shapes"].items():
        show("sqdist two-rank " + label, r)
    for name, r in report["float32"].items():
        for label, b in r.get("batched_shapes", {}).items():
            show(name + " " + label, b, MULTI_TIMING_REPS)
    return report["float32"]


def _spans():
    """The program's span recorder, on for a ``with`` block; it adds no
    device synchronisation."""
    from gpim_tpu_torch.utils import profiling
    return profiling.spans()


def _phases(recorder):
    """{"train": ..., "predict": ...}: the summaries of the model's
    ``recon.train`` and ``recon.predict`` spans (``first_s``, ``warm_s``,
    ``calls``); each span ends after the read-back that waits for the
    card."""
    s = recorder.summary()
    return {"train": s["recon.train"], "predict": s["recon.predict"]}


def _reset_launches():
    from gpim_tpu_torch.ops import gram_kernels as gk
    for name in KERNELS:
        getattr(gk, name).launches = 0


def _read_launches():
    from gpim_tpu_torch.ops import gram_kernels as gk
    return {name: getattr(gk, name).launches for name in KERNELS}


def _counts(sqdist=0, masked_system=0, rbf_bwd_reductions=0,
            interp_adjoint=0):
    """Launch counts of every kernel, by name, as _read_launches gives
    them."""
    return {"sqdist": sqdist, "masked_system": masked_system,
            "rbf_bwd_reductions": rbf_bwd_reductions,
            "interp_adjoint": interp_adjoint}


def _run_flagship(R, X, X_full, precision, label, **kwargs):
    import torch
    from gpim_tpu_torch import reconstructor
    # no use_gpu: the card is the default device
    model = reconstructor(X, R, X_full, kernel="RBF", iterations=ITERATIONS,
                          precision=precision, verbose=0, **kwargs)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with _spans() as recorder:
        mean, sd, hp = model.run()
    total = time.perf_counter() - t0
    ph = _phases(recorder)
    obs = ~np.isnan(R)
    rmse = float(np.sqrt(np.mean((mean[obs] - R[obs]) ** 2)))
    ls = hp["lengthscale"]
    drift = np.max(np.abs(ls[-1] - ls[-51]) / np.abs(ls[-1]))
    log("[flagship] %-11s train %.3f s, predict %.3f s, total %.3f s, "
        "rmse_obs %.5f, lengthscale %s (moved %.2e over the last 50 steps), "
        "noise %.6g, loss %.6g" % (
            label, ph["train"]["first_s"], ph["predict"]["first_s"], total,
            rmse, np.array2string(ls[-1], precision=4), drift,
            hp["noise"][-1], model.losses[-1]))
    return model, mean, sd, hp, rmse


def phase_flagship(R, X, X_full):
    import torch
    _reset_launches()
    _run_flagship(R, X, X_full, "single", "f32 cold")
    _reset_launches()
    model, mean, sd, hp, rmse = _run_flagship(R, X, X_full, "single",
                                              "f32 warm")
    launches = _read_launches()
    log("[flagship] kernel launches in the warm run: %s" % launches)
    if np.isnan(mean).any() or np.isnan(sd).any():
        raise AssertionError("flagship prediction has NaNs")
    if mean.shape != R.shape or sd.shape != R.shape:
        raise AssertionError("flagship prediction has the wrong shape")
    if not rmse < 0.1:
        raise AssertionError("flagship rmse_obs %.4f >= 0.1" % rmse)
    if not all(launches[k] > 0 for k in KERNELS[:3]):
        raise AssertionError("a kernel of the main path was never launched: "
                             "%s" % launches)
    tensors = (list(model.u.values()) + list(model._bounds().values())
               + [model._Xd, model._yd, model._maskd])
    if not all(t.is_cuda for t in tensors):
        raise AssertionError("a model built without use_gpu has a tensor "
                             "that is not on the card")
    log("[flagship] peak device memory %.1f MiB" % (
        torch.cuda.max_memory_allocated() / 2 ** 20))
    return launches, (mean, sd, hp)


def _run_vfe(vfe, precision, label, **kwargs):
    import torch
    from gpim_tpu_torch import reconstructor
    R, X, X_full, truth = vfe
    # no use_gpu: the card is the default device
    model = reconstructor(X, R, X_full, precision=precision, verbose=0,
                          **VFE, **kwargs)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with _spans() as recorder:
        mean, sd, hp = model.run()
    total = time.perf_counter() - t0
    ph = _phases(recorder)
    # benchmarks/suite.py:237-239
    tnorm = (truth - truth.min()) / np.ptp(truth)
    mnorm = (mean - truth.min()) / np.ptp(truth)
    rmse = float(np.sqrt(np.mean((mnorm - tnorm) ** 2)))
    log("[vfe] %-11s train %.3f s, predict %.3f s, total %.3f s, "
        "rmse_vs_truth %.5f, n = %d, m = %d, lengthscale %s, noise %.6g, "
        "loss %.6g" % (
            label, ph["train"]["first_s"], ph["predict"]["first_s"], total,
            rmse, model._Xd.shape[0], model.u["Xu"].shape[0],
            np.array2string(hp["lengthscale"][-1], precision=4),
            hp["noise"][-1], model.losses[-1]))
    return model, mean, sd, hp, rmse


def phase_vfe(vfe):
    import torch
    R = vfe[0]
    _reset_launches()
    _run_vfe(vfe, "single", "f32 cold")
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    model, mean, sd, hp, rmse = _run_vfe(vfe, "single", "f32 warm")
    launches = _read_launches()
    n_chunks = -(-int(np.prod(R.shape)) // 4096)
    expected = 2 * VFE["iterations"] + 2 + n_chunks
    log("[vfe] kernel launches in the warm run: %s (K1 expected %d: Kmm and "
        "Kmn per step, both once more and %d chunks in predict)"
        % (launches, expected, n_chunks))
    log("[vfe] peak device memory %.1f MiB (warm run)" % (
        torch.cuda.max_memory_allocated() / 2 ** 20))
    if np.isnan(mean).any() or np.isnan(sd).any():
        raise AssertionError("VFE prediction has NaNs")
    if mean.shape != R.shape or sd.shape != R.shape:
        raise AssertionError("VFE prediction has the wrong shape")
    if not rmse < 0.1:
        raise AssertionError("VFE rmse_vs_truth %.4f >= 0.1" % rmse)
    if launches["sqdist"] == 0:
        raise AssertionError("K1 was never launched on the VFE path")
    tensors = (list(model.u.values()) + list(model._bounds().values())
               + [model._Xd, model._yd, model._maskd])
    if not all(t.is_cuda for t in tensors):
        raise AssertionError("a VFE model built without use_gpu has a "
                             "tensor that is not on the card")
    return launches, (mean, sd, hp, rmse, model.u, model.losses)


def phase_cross_check(R, X, X_full, f32, vfe, vfe32):
    import torch
    from gpim_tpu_torch import dtypes, reconstructor, utils
    # same objective in both precisions: the default jitter differs by
    # precision (1e-4 vs 1e-5) and on this noise-free scan the learned
    # noise falls below it, so the f64 run takes the f32 jitter
    _, m64, s64, h64, _ = _run_flagship(
        R, X, X_full, "double", "f64",
        jitter=dtypes.default_jitter(torch.float32))
    m32, s32, h32 = f32
    diffs = {
        "mean_atol": float(np.abs(m32 - m64).max()),
        "sd_atol": float(np.abs(s32 - s64).max()),
        "ls_rtol": float(np.max(np.abs(h32["lengthscale"][-1]
                                       - h64["lengthscale"][-1])
                                / np.abs(h64["lengthscale"][-1]))),
        "noise_atol": float(abs(h32["noise"][-1] - h64["noise"][-1])),
    }
    log("[cross-check] f32 vs f64 flagship: %s (limits %s)"
        % (json.dumps(diffs), json.dumps(CROSS_TOL)))
    for k, lim in CROSS_TOL.items():
        if not diffs[k] <= lim:
            raise AssertionError("f32 vs f64 %s %.3e > %.0e"
                                 % (k, diffs[k], lim))

    # small problem through every kernel in float64: CUDA vs the CPU path
    Rs = small_data()
    Xs, Xfs = utils.get_sparse_grid(Rs), utils.get_full_grid(Rs)
    out = {}
    for use_gpu in (True, False):
        for kernel in ("RBF", "Matern52", "RationalQuadratic"):
            mean, sd, hp = reconstructor(
                Xs, Rs, Xfs, kernel=kernel, iterations=30,
                learning_rate=0.1, precision="double", use_gpu=use_gpu,
                verbose=0).run()
            out[use_gpu, kernel] = (mean, sd, hp["lengthscale"])
    for kernel in ("RBF", "Matern52", "RationalQuadratic"):
        worst = max(float(np.max(np.abs(g - c)) / np.max(np.abs(c)))
                    for g, c in zip(out[True, kernel], out[False, kernel]))
        log("[cross-check] small 24x24 %s, CUDA vs CPU (f64): max diff / "
            "max value %.3e (limit %.0e)" % (kernel, worst, SMALL_RTOL))
        if not worst <= SMALL_RTOL:
            raise AssertionError("CUDA and CPU paths disagree on %s" % kernel)

    # the VFE run in float64 at the float32 jitter
    model64, m64, s64, h64, r64 = _run_vfe(
        vfe, "double", "f64", jitter=dtypes.default_jitter(torch.float32))
    m32, s32, h32, r32, u32, losses32 = vfe32
    model64.u = {k: v.double() for k, v in u32.items()}
    m64u, s64u = model64.predict()
    vdiffs = {
        "mean_atol": float(np.abs(m32 - m64).max()),
        "sd_atol": float(np.abs(s32 - s64).max()),
        "ls_rtol": float(np.max(np.abs(h32["lengthscale"][-1]
                                       - h64["lengthscale"][-1])
                                / np.abs(h64["lengthscale"][-1]))),
        "noise_rtol": float(abs(h32["noise"][-1] - h64["noise"][-1])
                            / abs(h64["noise"][-1])),
        "rmse_diff": abs(r32 - r64),
        "loss0_rtol": float(abs(losses32[0] - model64.losses[0])
                            / abs(model64.losses[0])),
        "same_u_mean_atol": float(np.abs(m32 - m64u).max()),
        "same_u_sd_atol": float(np.abs(s32 - s64u).max()),
    }
    log("[cross-check] f32 vs f64 VFE: %s (limits %s); inducing points "
        "%.3e apart at most" % (
            json.dumps(vdiffs), json.dumps(VFE_CROSS_TOL),
            float(np.abs(h32["inducing_points"][-1]
                         - h64["inducing_points"][-1]).max())))
    for k, lim in VFE_CROSS_TOL.items():
        if not vdiffs[k] <= lim:
            raise AssertionError("f32 vs f64 VFE %s %.3e > %.0e"
                                 % (k, vdiffs[k], lim))

    # small sparse problem in float64: CUDA vs the CPU path
    out = {}
    for use_gpu in (True, False):
        for kernel in ("RBF", "Matern52", "RationalQuadratic"):
            mean, sd, hp = reconstructor(
                Xs, Rs, Xfs, kernel=kernel, sparse=True, indpoints=40,
                iterations=30, learning_rate=0.1, precision="double",
                use_gpu=use_gpu, verbose=0).run()
            out[use_gpu, kernel] = (mean, sd, hp["lengthscale"],
                                    hp["inducing_points"])
    for kernel in ("RBF", "Matern52", "RationalQuadratic"):
        worst = max(float(np.max(np.abs(g - c)) / np.max(np.abs(c)))
                    for g, c in zip(out[True, kernel], out[False, kernel]))
        log("[cross-check] small 24x24 sparse %s, CUDA vs CPU (f64): max "
            "diff / max value %.3e (limit %.0e)" % (kernel, worst,
                                                   SMALL_RTOL))
        if not worst <= SMALL_RTOL:
            raise AssertionError("CUDA and CPU sparse paths disagree on %s"
                                 % kernel)
    return diffs, vdiffs


def _profiled(fn):
    """Run ``fn`` under torch.profiler, synchronised at both ends; returns
    (host ms of the window, {device kernel name: (device ms, launches)},
    {host op: (self host ms, total host ms, calls)}). Ranges that
    record_function marks on the
    device's timeline (torch.optim's "Optimizer.step#Adam.step") span
    kernels and gaps; they are not kernels and are left out."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    per_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and not getattr(
                e, "is_user_annotation", False):
            ms, n = per_name.get(e.name, (0.0, 0))
            per_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    host = {e.key: (e.self_cpu_time_total / 1e3, e.cpu_time_total / 1e3,
                    e.count) for e in prof.key_averages()}
    return wall_ms, per_name, host


# host calls that wait for the device
_SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
               "cudaEventSynchronize", "cudaMemcpy")


def _report_profile(label, what, count, profiled, host_ops=0, host_keys=()):
    """Print device ms per unit by kernel (the ten largest and the port's
    own), the kernels launched per unit, the share of the host's window in
    which the device ran no kernel, the host's synchronising calls per
    unit, the ``host_ops`` host operations with the most self time, and the
    total host time (its children included) of each op in
    ``host_keys``."""
    wall_ms, per_name, host = profiled
    busy_ms = sum(ms for ms, _ in per_name.values())
    if busy_ms == 0.0:
        log("[profile] %s: the profiler recorded no device time: not "
            "measured" % label)
        return
    log("[profile] %s: %d %s: %.3f ms each on the host clock, %.3f ms of "
        "device time in %d kernel launches, device idle %.1f%%"
        % (label, count, what, wall_ms / count, busy_ms / count,
           sum(n for _, n in per_name.values()) // count,
           100.0 * max(0.0, 1.0 - busy_ms / wall_ms)))
    ranked = sorted(per_name.items(), key=lambda kv: -kv[1][0])
    ours = ("sqdist_kernel", "masked_system_kernel", "rbf_bwd_kernel")
    for i, (name, (ms, _)) in enumerate(ranked):
        if i < 10 or any(k in name for k in ours):
            log("[profile] %8.4f ms each %5.1f%%  %s" % (
                ms / count, 100.0 * ms / busy_ms, name[:100]))
    syncs = {k: host[k][2] / count for k in _SYNC_CALLS if k in host}
    log("[profile]   host calls that wait for the device, each: %s"
        % json.dumps(syncs))
    ranked = sorted(((k, v[0]) for k, v in host.items() if v[0] > 0),
                    key=lambda kv: -kv[1])
    for name, ms in ranked[:host_ops]:
        log("[profile]   host %8.4f ms each %5.1f%% of the window  %s" % (
            ms / count, 100.0 * ms / wall_ms, name[:80]))
    for key in host_keys:
        _, total, calls = host.get(key, (0.0, 0.0, 0))
        log("[profile]   host %s: %.4f ms each with its children, %.1f%% of "
            "the window, %g calls each" % (key, total / count,
                                           100.0 * total / wall_ms,
                                           calls / count))


def phase_profile(label, R, X, X_full, **kwargs):
    """Device time per warm training step, by kernel name, and the share of
    the host's train() window in which the device ran no kernel."""
    from gpim_tpu_torch import reconstructor
    model = reconstructor(X, R, X_full, precision="single", verbose=0,
                          **kwargs)
    model.iterations = PROFILE_STEPS
    _report_profile(label, "warm f32 training steps", PROFILE_STEPS,
                    _profiled(model.train))


def phase_bo_profile(label, bo):
    """One warm device step of a BO run that has finished: refit
    (refit_iterations Adam steps), predict over the grid, acquisition and
    ranking, and the read of its top-k candidates."""
    profiled = _profiled(lambda: bo._fused_step(bo.refit_iterations))
    _report_profile(label, "warm %s BO step (%d refit steps, predict, "
                    "acquisition, ranking)" % (
                        str(bo.surrogate_model.dtype).split(".")[-1],
                        bo.refit_iterations), 1, profiled, host_ops=12)


# ---------------------------------------------------------------------------
# Bayesian optimisation
# ---------------------------------------------------------------------------

BO_DIR = os.path.join(_HERE, "build", "chip_smoke")   # gitignored


def _check_tie_order():
    """The device paths' ranking on the card: equal acquisition values in
    ascending flat-index order (as jax.lax.top_k), at the spiral grid's
    size with ~330 ties per value, against numpy's stable sort."""
    import torch
    from gpim_tpu_torch.gpbayes import boptim
    v = np.random.RandomState(0).randint(0, 50, 16384).astype(np.float32)
    _, order = boptim._top_k(torch.as_tensor(v, device="cuda"), 100)
    if not np.array_equal(order.cpu().numpy(),
                          np.argsort(-v, kind="stable")[:100]):
        raise AssertionError("the BO ranking breaks ties out of index order "
                             "on the card")
    log("[bo] ranking on the card: ties in ascending flat-index order "
        "(16384 values, 50 distinct)")


def _bo_expected(bo):
    """Kernel launches a BO run implies. Exact RBF surrogate: K2 and K3
    once per Adam step (the first train, one refit a step after it, the
    trailing retrain), K1 once per predict for the training Gram and once
    per test chunk. VFE surrogate: K1 for Kmm and Kmn per Adam step, and
    for Kmm, Kmn and each chunk's Ks per predict."""
    m = bo.surrogate_model
    steps = bo.exploration_steps
    adam = m.iterations + steps * bo.refit_iterations
    n_chunks = int(bo._chunks_d.shape[0])
    if m.do_sparse:
        return _counts(sqdist=2 * adam + steps * (2 + n_chunks))
    return _counts(sqdist=steps * (1 + n_chunks), masked_system=adam,
                   rbf_bwd_reductions=adam)


def _run_bo(label, seed, target, **kwargs):
    """One boptimizer run, built without use_gpu; returns the optimizer and
    its record (host wall s of run(), which ends by copying its results to
    the host; steps/s; points measured; best value found; launches)."""
    import torch
    from gpim_tpu_torch import boptimizer
    grid, X, X_full = seed
    os.makedirs(BO_DIR, exist_ok=True)
    bo = boptimizer(X, grid, X_full, target, verbose=0,
                    filename=os.path.join(BO_DIR, label.split()[0]),
                    **kwargs)
    path = "device step" if bo._fused_ok() else "host loop"
    expected = _bo_expected(bo)
    torch.cuda.synchronize()
    _reset_launches()
    t0 = time.perf_counter()
    bo.run()
    wall = time.perf_counter() - t0
    launches = _read_launches()
    m = bo.surrogate_model
    tensors = (list(m.u.values()) + list(m._bounds().values())
               + [m._Xd, m._yd, m._maskd, bo._chunks_d, bo._sel_mask_d])
    if not all(t.is_cuda for t in tensors):
        raise AssertionError("%s: a tensor of a boptimizer built without "
                             "use_gpu is not on the card" % label)
    rec = {"wall_s": wall, "steps": bo.steps_done,
           "steps_per_s": bo.steps_done / wall,
           "points": len(bo.indices_all),
           "best_found": float(np.nanmax(np.asarray(
               bo.target_func_vals[-1], float))),
           "path": path, "launches": launches,
           "n_train": int(m._Xd.shape[0]), "dtype": str(m.dtype)}
    log("[bo] %-26s %.3f s, %.2f steps/s, %d points, best found %.4f, %s, "
        "n = %d, %s, launches %s" % (
            label, wall, rec["steps_per_s"], rec["points"],
            rec["best_found"], path, rec["n_train"], rec["dtype"],
            launches))
    if launches != expected:
        raise AssertionError("%s: launches %s, the code implies %s"
                             % (label, launches, expected))
    return bo, rec


def _host_ei(model, X_full, X_sparse):
    """The port's named EI as a custom callable, which takes the host loop
    (acquisition and ranking in numpy)."""
    from gpim_tpu_torch.gpbayes import acqfunc
    return acqfunc.expected_improvement(model, X_full, X_sparse)


def _check_path(label, rec, path):
    if rec["path"] != path:
        raise AssertionError("%s took the %s, not the %s"
                             % (label, rec["path"], path))


def _same_selection(label, a, b):
    """Two runs selected the same points and measured the same values, up
    to a tie: where they first part, the two picks' acquisition values must
    agree within ``TIE_ATOL`` of the run's largest value (EI far from the
    optimum is tiny, and at such a near-tie the host ranks in another
    order than the device); after that their data differ and are not
    compared. The steps before must agree to ``BO_RTOL``."""
    va, vb = np.asarray(a.vals_all), np.asarray(b.vals_all)
    scale = np.abs(vb).max()
    k = next((i for i, (x, y) in enumerate(zip(a.indices_all,
                                               b.indices_all)) if x != y),
             len(b.indices_all))
    gap = float(np.max(np.abs(va[:k] - vb[:k]) / (np.abs(vb[:k]) + scale),
                       initial=0.0))
    ok = gap <= BO_RTOL
    if k == len(b.indices_all):
        ok = ok and np.array_equal(a.y_sparse, b.y_sparse, equal_nan=True)
        log("[bo] %s: same indices and measured values: %s; acquisition "
            "values %.3e apart (relative, atol of the largest; limit %.0e)"
            % (label, ok, gap, BO_RTOL))
    else:
        tie = float(abs(va[k] - vb[k]) / scale)
        ok = ok and tie <= TIE_ATOL
        log("[bo] %s: the same %d points, then at step %d %s and %s, whose "
            "acquisition values (%.6e, %.6e) are %.3e of the largest apart "
            "(a tie within %.0e: %s); the steps before %.3e apart"
            % (label, k, k + 1, a.indices_all[k], b.indices_all[k], va[k],
               vb[k], tie, TIE_ATOL, tie <= TIE_ATOL, gap))
    if not ok:
        raise AssertionError("%s: the two runs selected different points"
                             % label)


def phase_bo(R, X, X_full):
    """The repo's three bo25 rows cold then warm, the full-width BO run on
    the spiral on the device step and on the host loop, a sparse surrogate
    (float32, then float64 on both paths), and bo25 EI in float64 on the
    card against the CPU.
    Returns (warm launches by path, warm records, the bo25 EI optimizer
    and the spiral one, for the profile)."""
    import torch
    from gpim_tpu_torch.examples import _data
    from gpim_tpu_torch import boptimizer
    _check_tie_order()
    grid, Xs, Xf, truth = bo25_data()
    seed25 = (grid, Xs, Xf)
    paths, rows = {}, {}
    # at the surrogate's default precision (float64 on the card), and
    # bo25_ei_explore also at precision="single"
    for label, kw in list(BO25_ROWS.items()) + [
            ("bo25_ei_explore_f32", dict(BO25_ROWS["bo25_ei_explore"],
                                         precision="single"))]:
        kw = dict(kw, gp_iterations=BO25_ITERATIONS)
        target = bo25_target
        if kw.get("simulate_measurement"):
            kw["y_true"], target = truth, None
        _run_bo(label + " cold", seed25, target, **kw)
        bo, rows[label] = _run_bo(label + " warm", seed25, target, **kw)
        paths[label] = rows[label]["launches"]
        want = torch.float32 if "precision" in kw else torch.float64
        if bo.surrogate_model.dtype != want:
            raise AssertionError("%s: the surrogate is %s, not %s" % (
                label, bo.surrogate_model.dtype, want))
        if label == "bo25_ei_explore":
            bo25 = bo
    log("[bo] bo25_ei_explore warm: %.3f s at the default (float64), %.3f s "
        "at precision=\"single\"" % (rows["bo25_ei_explore"]["wall_s"],
                                      rows["bo25_ei_explore_f32"]["wall_s"]))
    # the gates of benchmarks/suite.py:156-159,203-206
    sim = rows["bo25_ei_sim_device"]
    if not sim["best_found"] >= 0.95:
        raise AssertionError("bo25_ei_sim_device best found %.3f < 0.95"
                             % sim["best_found"])
    batch = rows["bo25_batch_explore"]
    if not batch["points"] > batch["steps"]:
        raise AssertionError("bo25_batch_explore measured %d points over %d "
                             "steps" % (batch["points"], batch["steps"]))

    # full width: the spiral scan as the seed, the field it masks as the
    # measurement, at the surrogate's default precision, float64, and the
    # BO's default jitter (1e-6): in float32 the Cholesky of this n = 6144
    # system fails (LinAlgError) even at the reconstructor's float32
    # jitter, 1e-4, once EI measures inside the scan's gaps at the learned
    # lengthscale of ~10 pixels - its round-off, ~n * eps * |A| = 4e-4,
    # exceeds noise + jitter there
    # (tests/test_torch_boptim.py::test_float32_spiral_bo_fails_its_cholesky
    # pins it at precision="single"). The device step runs it, then the
    # host loop (EI on the host, through a callable), which must select
    # the same points.
    y128 = _data._smooth_field((128, 128), sigma=(6.0, 6.0), seed=0)
    spiral = {}
    for path in ("device step", "host loop"):
        kw = dict(SPIRAL_BO, y_true=y128)
        if path == "host loop":
            kw["acquisition_function"] = _host_ei
        spiral[path], rec = _run_bo("spiral_bo %s" % path, (R, X, X_full),
                                    None, **kw)
        _check_path("spiral_bo", rec, path)
        if spiral[path].surrogate_model.dtype != torch.float64 or \
                spiral[path].steps_done != SPIRAL_BO["exploration_steps"]:
            raise AssertionError("spiral_bo %s: not a float64 run to its "
                                 "end at the default precision" % path)
        key = "spiral_bo" + ("" if path == "device step" else "_host_loop")
        rows[key], paths[key] = rec, rec["launches"]
    _same_selection("spiral_bo, device step vs host loop",
                    spiral["device step"], spiral["host loop"])

    # a sparse (VFE) surrogate in float32, then in float64 on both paths,
    # which must select the same points (float64: far from the seeds many
    # float32 predictions tie, and the host's ranking puts ties in another
    # order than the device's)
    kw = dict(BO_VFE, gp_iterations=BO25_ITERATIONS, y_true=truth,
              precision="single")
    _, rows["bo25_vfe"] = _run_bo("bo25_vfe", seed25, None, **kw)
    paths["bo25_vfe"] = rows["bo25_vfe"]["launches"]
    vfe = {}
    for path in ("device step", "host loop"):
        kw = dict(BO_VFE, gp_iterations=BO25_ITERATIONS, y_true=truth,
                  precision="double")
        if path == "host loop":
            kw["acquisition_function"] = _host_ei
        vfe[path], rec = _run_bo("bo25_vfe f64 %s" % path, seed25, None,
                                 **kw)
        _check_path("bo25_vfe f64", rec, path)
        rows["bo25_vfe_f64_" + path.replace(" ", "_")] = rec
    _same_selection("bo25_vfe f64, device step vs host loop",
                    vfe["device step"], vfe["host loop"])

    # bo25 EI in float64: the card against the CPU path
    out = {}
    for use_gpu in (True, False):
        kw = dict(BO25_ROWS["bo25_ei_explore"], gp_iterations=BO25_ITERATIONS,
                  precision="double", verbose=0,
                  filename=os.path.join(BO_DIR, "bo25_f64"))
        if not use_gpu:
            kw["use_gpu"] = False
        bo = boptimizer(Xs, grid, Xf, bo25_target, **kw)
        bo.run()
        out[use_gpu] = bo
    vals = [np.asarray(out[k].vals_all) for k in (True, False)]
    gap = float(np.max(np.abs(vals[0] - vals[1])
                       / (np.abs(vals[1]) + np.abs(vals[1]).max())))
    same = out[True].indices_all == out[False].indices_all
    log("[bo] bo25_ei_explore f64, CUDA vs CPU: same indices: %s; vals_all "
        "%.3e apart (relative, atol of the largest; limit %.0e)"
        % (same, gap, BO_RTOL))
    if not same or not gap <= BO_RTOL:
        raise AssertionError("bo25 EI float64: the card and the CPU disagree")
    log("[bo] warm records: " + json.dumps(rows))
    return paths, bo25, spiral["device step"]


# ---------------------------------------------------------------------------
# multi-output GP
# ---------------------------------------------------------------------------

def _multi_expected(model, n_test):
    """Kernel launches a vreconstructor run implies. Independent: K2 once
    an Adam step (all channels in one launch), K3 too for RBF, K1 once an
    Adam step for Matern52 (its backward's distances); correlated: K1 once
    an Adam step (Kx). Prediction: K1 once for the training Gram and once
    a test chunk."""
    steps = int(model.iterations)
    n_chunks = -(-n_test // min(MULTI_CHUNK, -(-n_test // 128) * 128))
    predict = 1 + n_chunks
    if not model.independent:
        return _counts(sqdist=steps + predict)
    rbf = model.kernel_type == "RBF"
    return _counts(sqdist=predict + (0 if rbf else steps),
                   masked_system=steps,
                   rbf_bwd_reductions=steps if rbf else 0)


def _run_multi(label, data, **kwargs):
    """One vreconstructor run (train and predict), built without use_gpu
    unless ``kwargs`` say otherwise; checks its launches, its shapes, NaNs
    and that every model tensor is on its device. Returns (model, mean,
    sd, hyperparams, record)."""
    import torch
    from gpim_tpu_torch import vreconstructor
    X, Y, Xt = data[:3]
    kw = dict(MULTI, **kwargs)
    model = vreconstructor(X, Y, Xt, verbose=0, **kw)
    on_card = model.device.type == "cuda"
    if on_card:
        torch.cuda.synchronize()
    _reset_launches()
    t0 = time.perf_counter()
    with _spans() as recorder:
        mean, sd, hp = model.run()
    total = time.perf_counter() - t0
    launches = _read_launches()
    ph = _phases(recorder)
    n_test = int(np.prod(Xt.shape[1:]))
    rec = {"train_s": ph["train"]["first_s"],
           "predict_s": ph["predict"]["first_s"], "total_s": total,
           "step_ms": 1e3 * ph["train"]["first_s"] / kw["iterations"],
           "launches": launches, "n_train": int(model._Xd.shape[0]),
           "tasks": model.num_tasks, "dtype": str(model.dtype)}
    log("[multi] %-24s train %.3f s (%.2f ms a step), predict %.3f s, total "
        "%.3f s, n = %d, T = %d, %s, %s, launches %s, final lengthscale "
        "range [%.3f, %.3f], loss %.6g" % (
            label, rec["train_s"], rec["step_ms"], rec["predict_s"], total,
            rec["n_train"], rec["tasks"], rec["dtype"],
            "independent" if model.independent else "correlated", launches,
            hp["lengthscale"][-1].min(), hp["lengthscale"][-1].max(),
            model.losses[-1]))
    if mean.shape != Xt.shape[1:] + (model.num_tasks,) \
            or sd.shape != mean.shape:
        raise AssertionError("%s: prediction has the wrong shape" % label)
    if np.isnan(mean).any() or np.isnan(sd).any():
        raise AssertionError("%s: prediction has NaNs" % label)
    if on_card:
        expected = _multi_expected(model, n_test)
        if launches != expected:
            raise AssertionError("%s: launches %s, the code implies %s"
                                 % (label, launches, expected))
        tensors = (list(model.u.values()) + list(model._bounds().values())
                   + [model._Xd, model._Yd]
                   + ([model._maskd] if model.independent else []))
        if not all(t.is_cuda for t in tensors):
            raise AssertionError("%s: a tensor of a vreconstructor built "
                                 "without use_gpu is not on the card" % label)
    return model, mean, sd, hp, rec


def _time_linalg(A):
    """The batched dense linear algebra of one eels64 Adam step, each way
    it could run, in device ms (CUDA events around 3 warm calls): the
    batched Cholesky against a loop over the tasks, the triangular inverse
    (one batched solve against I; a loop; ``cholesky_inverse``, which gives
    A^-1 without L^-1), and A^-1 = V^T V."""
    import torch
    from gpim_tpu_torch.ops.tri import tri_inverse

    def ms(fn, reps=3):
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    L = torch.linalg.cholesky_ex(A)[0]
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    out = {
        "cholesky_batched": ms(lambda: torch.linalg.cholesky_ex(A)),
        "cholesky_loop": ms(lambda: [torch.linalg.cholesky_ex(a) for a in A]),
        "tri_inverse_batched": ms(lambda: tri_inverse(L)),
        "tri_inverse_loop": ms(lambda: [torch.linalg.solve_triangular(
            li, eye, upper=False) for li in L]),
        "cholesky_inverse": ms(lambda: torch.cholesky_inverse(L)),
    }
    V = tri_inverse(L)
    out["VtV_gemm"] = ms(lambda: V.mT @ V)
    log("[multi] eels64 dense linear algebra, device ms a call at %s "
        "float32: %s" % (list(A.shape), json.dumps(
            {k: round(v, 4) for k, v in out.items()})))
    return out


def phase_multi(eels6, eels64):
    """The suite's eels6 and eels64 rows cold then warm (the rmse gate of
    eels64), eels6 correlated, eels6 float32 against float64, small
    problems card against CPU in both modes, and the eels64 dense linear
    algebra timed. Returns the warm runs' launches by path."""
    import torch
    from gpim_tpu_torch import dtypes
    from gpim_tpu_torch.gpreg import multi
    paths, recs = {}, {}
    _run_multi("eels6 f32 cold", eels6)
    m6, mean6, sd6, hp6, recs["eels6"] = _run_multi("eels6 f32 warm", eels6)
    paths["eels6"] = recs["eels6"]["launches"]

    _run_multi("eels64 f32 cold", eels64)
    torch.cuda.reset_peak_memory_stats()
    m64, mean, _, _, recs["eels64"] = _run_multi("eels64 f32 warm", eels64)
    paths["eels64"] = recs["eels64"]["launches"]
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    # benchmarks/suite.py:510-514
    Y, fields = eels64[1], eels64[3]
    obs = ~np.isnan(Y)
    rmse = float(np.sqrt(np.mean((mean[obs] - fields[obs]) ** 2)))
    gate = 0.5 * float(np.nanstd(Y))
    recs["eels64"].update(rmse_vs_truth=rmse, peak_gib=peak,
                          channel_iters_per_s=64 * MULTI["iterations"]
                          / recs["eels64"]["total_s"])
    log("[multi] eels64 rmse_vs_truth %.5f (gate < %.5f), %.1f channel "
        "iterations/s, peak device memory %.2f GiB" % (
            rmse, gate, recs["eels64"]["channel_iters_per_s"], peak))
    if not rmse < gate:
        raise AssertionError("eels64 rmse %.4f >= %.4f" % (rmse, gate))

    # the batched Cholesky and inverse of one eels64 step, timed
    p = multi._constrain_task(m64.u, m64._bounds())
    from gpim_tpu_torch.kernels.functional import rbf
    A = multi._masked_gram(rbf, p, m64._Xd, m64._maskd, m64.jitter)
    del m64, p
    recs["eels64_linalg_ms"] = _time_linalg(A)
    del A
    torch.cuda.empty_cache()

    _run_multi("eels6_correlated f32 cold", eels6, independent=False)
    _, cmean, csd, _, recs["eels6_correlated"] = _run_multi(
        "eels6_correlated f32 warm", eels6, independent=False)
    paths["eels6_correlated"] = recs["eels6_correlated"]["launches"]

    # eels6 in float64 at the float32 jitter against the float32 run
    _, mean64, sd64, h64, recs["eels6_f64"] = _run_multi(
        "eels6 f64", eels6, precision="double",
        jitter=dtypes.default_jitter(torch.float32))
    diffs = {
        "mean_atol": float(np.abs(mean6 - mean64).max()),
        "sd_atol": float(np.abs(sd6 - sd64).max()),
        "ls_rtol": float(np.max(np.abs(hp6["lengthscale"][-1]
                                       - h64["lengthscale"][-1])
                                / np.abs(h64["lengthscale"][-1]))),
        "noise_rtol": float(np.max(np.abs(hp6["noise"][-1]
                                          - h64["noise"][-1])
                                   / np.abs(h64["noise"][-1]))),
    }
    log("[cross-check] eels6 f32 vs f64: %s (limits %s)"
        % (json.dumps(diffs), json.dumps(MULTI_CROSS_TOL)))
    for k, lim in MULTI_CROSS_TOL.items():
        if not diffs[k] <= lim:
            raise AssertionError("eels6 f32 vs f64 %s %.3e > %.0e"
                                 % (k, diffs[k], lim))

    # small problems in float64, both modes: the card against the CPU
    small = small_vector_data()
    for kernel, independent in (("RBF", True), ("Matern52", True),
                                ("RBF", False)):
        out = {}
        for use_gpu in (True, False):
            kw = dict(kernel=kernel, independent=independent, iterations=20,
                      precision="double")
            if not use_gpu:
                kw["use_gpu"] = False
            out[use_gpu] = _run_multi(
                "small %s %s %s" % (kernel, "ind" if independent else "corr",
                                    "card" if use_gpu else "cpu"),
                small, **kw)
        worst = max(float(np.max(np.abs(g - c)) / np.max(np.abs(c)))
                    for g, c in zip(
                        out[True][1:3] + (out[True][3]["lengthscale"],),
                        out[False][1:3] + (out[False][3]["lengthscale"],)))
        log("[cross-check] small 12x12x3 %s %s, CUDA vs CPU (f64): max diff "
            "/ max value %.3e (limit %.0e)" % (
                kernel, "independent" if independent else "correlated",
                worst, SMALL_RTOL))
        if not worst <= SMALL_RTOL:
            raise AssertionError("CUDA and CPU multi-output paths disagree")
    log("[multi] warm records: " + json.dumps(recs))
    return paths


def phase_multi_profile(eels6, eels64):
    """MULTI_PROFILE_STEPS warm training steps of eels6 and eels64 (all
    channels at once) and of eels6 correlated: device ms by kernel, idle
    share, host ops."""
    from gpim_tpu_torch import vreconstructor
    for label, data, kw in (("eels6", eels6, {}), ("eels64", eels64, {}),
                            ("eels6_correlated", eels6,
                             {"independent": False})):
        model = vreconstructor(*data[:3], verbose=0, **dict(MULTI, **kw))
        model.train(iterations=1)
        model.iterations = MULTI_PROFILE_STEPS
        _report_profile(label, "warm f32 training steps", MULTI_PROFILE_STEPS,
                        _profiled(model.train), host_ops=8)


# ---------------------------------------------------------------------------
# structured-kernel GP (skreconstructor)
# ---------------------------------------------------------------------------

def _cg_trips(k, cap):
    """The iterations batched_pcg runs, one mvm each, for ``k`` realized
    ones under ``cap``: it reads whether every column has converged only
    every ski.CG_EXIT_CHECK_EVERY iterations, so it runs on to the next
    multiple of that (at least one multiple)."""
    from gpim_tpu_torch.ops import ski
    every = ski.CG_EXIT_CHECK_EVERY
    return min(int(cap), max(every, every * -(-int(k) // every)))


def _ski_k4_launches(eng):
    """K4 launches of an off-lattice run (every W^T is one): a training
    step, one a CG iteration the loop runs and two in the surrogate
    backward (the operator's W^T, and the gather's gradient, which is W^T
    too); in predict one a solve iteration (capped at cg_iters, at
    precond_rank 0 at ski.PREDICT_CG_ITERS) and one for the mean, and at
    rank 0 one a Lanczos step and one for the test cross rows."""
    from gpim_tpu_torch.ops import ski
    train = sum(_cg_trips(k, eng.cg_iters) + 2 for k in eng.last_cg_iters)
    if eng.precond_rank > 0:
        return train + _cg_trips(eng.last_predict_cg_iters, eng.cg_iters) + 1
    return (train + _cg_trips(eng.last_predict_cg_iters,
                              ski.PREDICT_CG_ITERS) + 1 + eng.rank + 1)


def _sk_expected(model, n_test):
    """Kernel launches an skreconstructor run implies. Kronecker: K1 once a
    grid axis an Adam step (its factor), and in predict once a factor and
    once a factor a chunk (the cross rows). Masked lattice (d axes, S
    training segments): K1 once an axis each Adam step (the factors, built
    once for all CG iterations and the surrogate backward) and each
    segment (the preconditioner's rebuild; none at precond_rank 0), and in
    predict once an axis for the solve's factors and once an axis for the
    cross factors of a Cartesian test grid (or once an axis a chunk of
    scattered points): d (steps + S + 2) for a grid. Off-lattice (d axes,
    S segments): K1 once an axis each Adam step and each segment, and once
    an axis in predict (the factors serve the solve, the eigen-root and
    the mean): d (steps + S + 1); at precond_rank 0 no segment builds a
    preconditioner, d (steps + 1); K4 as _ski_k4_launches counts. Dense
    (the multi-output engine at one task): K2 each Adam step, K3 too for
    RBF, K1 each step for Matern52 (its backward's distances), and in
    predict K1 for the Gram and once a chunk. Spectral: none."""
    steps = int(model.iterations)
    n_chunks = -(-n_test // min(SK_CHUNK, -(-n_test // 128) * 128))
    if model.kernel_type == "Spectral":
        return _counts()
    if model._mgrid_engine is not None:
        from gpim_tpu_torch.gpreg import mgrid_model
        eng = model._mgrid_engine
        d = len(eng.grid_shape)
        grid = n_test == int(np.prod(model.fulldims)) and \
            mgrid_model.cartesian_axes_from_points(
                model.Xtest, model.fulldims) is not None
        predict = 2 * d if grid else d * (1 + -(-n_test // min(
            SK_CHUNK, max(128, n_test))))
        rebuilds = len(eng.last_segments) if eng.precond_rank > 0 else 0
        return _counts(sqdist=d * (steps + rebuilds) + predict)
    if model._ski_engine is not None:
        eng = model._ski_engine
        d = len(eng.grid_shape)
        rebuilds = len(eng.last_segments) if eng.precond_rank > 0 else 0
        return _counts(sqdist=d * (steps + rebuilds + 1),
                       interp_adjoint=_ski_k4_launches(eng))
    if model._kron_engine is not None:
        d = len(model._kron_engine.dims)
        return _counts(sqdist=d * (steps + 1 + n_chunks))
    rbf = model.kernel_type == "RBF"
    return _counts(sqdist=1 + n_chunks + (0 if rbf else steps),
                   masked_system=steps,
                   rbf_bwd_reductions=steps if rbf else 0)


def _run_sk(label, R, X, Xt, **kwargs):
    """One skreconstructor run (train and predict), built without use_gpu
    unless ``kwargs`` say otherwise; checks its launches, shapes, NaNs and
    that every model tensor is on its device. Returns (model, mean, sd,
    hyperparams, record); the record's rmse is at the observed points."""
    import torch
    from gpim_tpu_torch import skreconstructor
    model = skreconstructor(X, R, Xt, verbose=0, **kwargs)
    on_card = model.device.type == "cuda"
    if on_card:
        torch.cuda.synchronize()
    _reset_launches()
    t0 = time.perf_counter()
    with _spans() as recorder:
        mean, sd, hp = model.run()
    total = time.perf_counter() - t0
    launches = _read_launches()
    ph = _phases(recorder)
    obs = ~np.isnan(R)
    rmse = float(np.sqrt(np.mean((mean[obs] - R[obs]) ** 2)))
    route = ("spectral" if model.kernel_type == "Spectral" else "kronecker"
             if model._kron_engine is not None else "masked-lattice"
             if model._mgrid_engine is not None else "off-lattice"
             if model._ski_engine is not None else "dense")
    rec = {"train_s": ph["train"]["first_s"],
           "predict_s": ph["predict"]["first_s"], "total_s": total,
           "step_ms": 1e3 * ph["train"]["first_s"] / model.iterations,
           "rmse": rmse, "launches": launches, "route": route,
           "n_train": int(model._Xd.shape[0]), "dtype": str(model.dtype)}
    eng = model._mgrid_engine or model._ski_engine
    if eng is not None:
        rec["cg_iters"] = [int(i) for i in eng.last_cg_iters]
        rec["segments"] = eng.last_segments
        rec["precond_rank"] = eng.precond_rank
        log("[sk] %-27s realized CG iterations a step %s, segments %s"
            % (label, rec["cg_iters"], rec["segments"]))
    shown = ("lengthscale %s" % np.array2string(hp["lengthscale"][-1],
                                                  precision=4)
             if "lengthscale" in hp else "weights %s" % np.array2string(
                 hp["weights"][-1], precision=4))
    log("[sk] %-27s %s, train %.3f s (%.3f ms a step), predict %.3f s, total "
        "%.3f s, rmse %.5f, n = %d, %s, launches %s, %s, noise %.6g, loss "
        "%.6g" % (label, route, rec["train_s"], rec["step_ms"],
                  rec["predict_s"], total, rmse, rec["n_train"], rec["dtype"],
                  launches, shown, hp["noise"][-1], model.losses[-1]))
    if mean.shape != R.shape or sd.shape != R.shape:
        raise AssertionError("%s: prediction has the wrong shape" % label)
    if np.isnan(mean).any() or np.isnan(sd).any():
        raise AssertionError("%s: prediction has NaNs" % label)
    if on_card:
        expected = _sk_expected(model, int(np.prod(Xt.shape[1:])))
        if launches != expected:
            raise AssertionError("%s: launches %s, the code implies %s"
                                 % (label, launches, expected))
        tensors = (list(model.u.values()) + list(model._bounds().values())
                   + [model._Xd, model._yd, model._maskd])
        if model._kron_engine is not None:
            tensors += [model._Y_grid] + list(model._kron_engine._axes)
        if model._mgrid_engine is not None:
            eng = model._mgrid_engine
            tensors += eng._axes + [eng._mask, eng._y, eng._g0]
        if model._ski_engine is not None:
            eng = model._ski_engine
            tensors += eng._grids + [eng._idx, eng._wgt, eng._i0, eng._w0,
                                     eng._mask, eng._g0, eng._perm]
        if not all(t.is_cuda for t in tensors):
            raise AssertionError("%s: a tensor of an skreconstructor built "
                                 "without use_gpu is not on the card" % label)
    return model, mean, sd, hp, rec


def phase_sk(R, X, X_full, ckpfm):
    """ckpfm4d (Kronecker) cold then warm with its rmse gate and in float64
    against float32, the dense and spectral routes on the spiral with
    theirs, and small problems of every route card against CPU. Returns
    the warm runs' launches by path."""
    import torch
    from gpim_tpu_torch import dtypes, utils
    paths, recs = {}, {}
    Rk, Xk = ckpfm
    _run_sk("ckpfm4d f32 cold", Rk, Xk, Xk, **CKPFM)
    torch.cuda.reset_peak_memory_stats()
    m32, k32, s32, h32, recs["ckpfm4d"] = _run_sk("ckpfm4d f32 warm", Rk, Xk,
                                                 Xk, **CKPFM)
    recs["ckpfm4d"]["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    if m32._kron_engine is None or m32.dtype != torch.float32:
        raise AssertionError("ckpfm4d did not take the float32 Kronecker "
                             "route")
    paths["ckpfm4d"] = recs["ckpfm4d"]["launches"]
    # benchmarks/suite.py:292: rmse_fit over the whole slab
    if not recs["ckpfm4d"]["rmse"] < 0.1:
        raise AssertionError("ckpfm4d rmse_fit %.4f >= 0.1"
                             % recs["ckpfm4d"]["rmse"])

    # ckpfm4d in float64 at the float32 jitter against the float32 run
    _, k64, s64, h64, recs["ckpfm4d_f64"] = _run_sk(
        "ckpfm4d f64", Rk, Xk, Xk, precision="double",
        jitter=dtypes.default_jitter(torch.float32), **CKPFM)
    diffs = {
        "mean_atol": float(np.abs(k32 - k64).max()),
        "sd_atol": float(np.abs(s32 - s64).max()),
        "ls_rtol": float(np.max(np.abs(h32["lengthscale"][-1]
                                       - h64["lengthscale"][-1])
                                / np.abs(h64["lengthscale"][-1]))),
        "noise_rtol": float(abs(h32["noise"][-1] - h64["noise"][-1])
                            / abs(h64["noise"][-1])),
    }
    log("[cross-check] ckpfm4d f32 vs f64: %s (limits %s)"
        % (json.dumps(diffs), json.dumps(CKPFM_CROSS_TOL)))
    for k, lim in CKPFM_CROSS_TOL.items():
        if not diffs[k] <= lim:
            raise AssertionError("ckpfm4d f32 vs f64 %s %.3e > %.0e"
                                 % (k, diffs[k], lim))

    # the dense and spectral routes on the flagship's spiral
    _, _, _, _, recs["sk_dense_spiral"] = _run_sk(
        "spiral dense RBF f32", R, X, X_full, **SK_DENSE)
    _, _, _, _, recs["sk_spectral_spiral"] = _run_sk(
        "spiral spectral f32", R, X, X_full, **SK_SPECTRAL)
    for path in ("sk_dense_spiral", "sk_spectral_spiral"):
        paths[path] = recs[path]["launches"]
        if not recs[path]["rmse"] < 0.1:
            raise AssertionError("%s rmse_obs %.4f >= 0.1"
                                 % (path, recs[path]["rmse"]))

    # small problems of every route in float64: the card against the CPU
    Rs = small_data()
    Rg = small_grid_data()
    Xg = utils.get_full_grid(Rg)
    cases = [("dense RBF", Rs, dict(kernel="RBF")),
             ("dense Matern52", Rs, dict(kernel="Matern52")),
             ("spectral", Rs, dict(kernel="Spectral", n_mixtures=3)),
             ("kronecker RBF", Rg, dict(kernel="RBF", ski_min_points=256)),
             ("kronecker Matern52", Rg, dict(kernel="Matern52",
                                             ski_min_points=256))]
    for name, Rc, kw in cases:
        Xc, Xtc = ((Xg, Xg) if Rc is Rg else
                   (utils.get_sparse_grid(Rc), utils.get_full_grid(Rc)))
        out = {}
        for use_gpu in (True, False):
            extra = {} if use_gpu else {"use_gpu": False}
            _, mean, sd, hp, _ = _run_sk(
                "small %s %s" % (name, "card" if use_gpu else "cpu"), Rc, Xc,
                Xtc, iterations=20, learning_rate=0.1, precision="double",
                **kw, **extra)
            out[use_gpu] = (mean, sd, hp.get("lengthscale", hp.get(
                "weights")), hp["noise"])
        worst = max(float(np.max(np.abs(g - c)) / np.max(np.abs(c)))
                    for g, c in zip(out[True], out[False]))
        log("[cross-check] small %s, CUDA vs CPU (f64): max diff / max value "
            "%.3e (limit %.0e)" % (name, worst, SMALL_RTOL))
        if not worst <= SMALL_RTOL:
            raise AssertionError("CUDA and CPU skreconstructor paths "
                                 "disagree on %s" % name)
    log("[sk] warm records: " + json.dumps(recs))
    return paths


def phase_sk_profile(R, X, X_full, ckpfm):
    """PROFILE_STEPS warm training steps of ckpfm4d (float32, with the host
    time of its eigh calls) and of the spectral row."""
    from gpim_tpu_torch import skreconstructor
    for label, args, kw, keys in (
            ("ckpfm4d", (ckpfm[1], ckpfm[0], ckpfm[1]), CKPFM,
             ("aten::linalg_eigh",)),
            ("sk_spectral_spiral", (X, R, X_full), SK_SPECTRAL, ())):
        model = skreconstructor(*args, verbose=0, **kw)
        model.train(iterations=1)
        model.iterations = PROFILE_STEPS
        _report_profile(label, "warm %s training steps" % str(
            model.dtype).split(".")[-1], PROFILE_STEPS,
            _profiled(model.train), host_ops=8, host_keys=keys)


# ---------------------------------------------------------------------------
# the masked-lattice SKI route (skreconstructor on NaN-masked grids)
# ---------------------------------------------------------------------------

def ski_masked_data():
    """benchmarks/suite.py:305-314: a smoothed random 64x64x32 field, noise
    0.02, 70% of its (x, y) spectra removed; returns (R, truth)."""
    from scipy.ndimage import gaussian_filter
    rng = np.random.RandomState(2)
    shape = MGRID_ROWS["ski_masked64x64x32"][0]
    f = gaussian_filter(rng.randn(*shape), sigma=(4, 4, 2))
    f = (f - f.min()) / (f.max() - f.min())
    R = f + 0.02 * rng.randn(*shape)
    sites = rng.choice(shape[0] * shape[1], int(0.7 * shape[0] * shape[1]),
                       replace=False)
    R.reshape(-1, shape[2])[sites] = np.nan
    return R, f


def mgrid_data(shape):
    """benchmarks/suite.py:341-352: a smooth analytic cube, noise 0.02, 70%
    of its (x, y) spectra removed; returns (R, truth, rng), the generator
    left where the suite's gates draw from it."""
    rng = np.random.RandomState(0)
    xx, yy, zz = np.meshgrid(*[np.arange(s, dtype=np.float64)
                               for s in shape], indexing="ij")
    f = (np.sin(xx / 9.0) * np.cos(yy / 11.0)
         + np.exp(-((zz - 30.0) / 15.0) ** 2))
    f = (f - f.min()) / np.ptp(f)
    R = f + 0.02 * rng.randn(*shape)
    sites = rng.choice(shape[0] * shape[1], int(0.7 * shape[0] * shape[1]),
                       replace=False)
    R.reshape(-1, shape[2])[sites] = np.nan
    return R, f, rng


def small_lattice_data(seed=1, shape=(10, 9, 6)):
    """A smooth 10x9x6 cube, half its (x, y) spectra removed
    (tests/test_torch_mgrid.py:_lattice)."""
    rng = np.random.RandomState(seed)
    xx, yy, zz = np.meshgrid(*[np.arange(s, dtype=np.float64)
                               for s in shape], indexing="ij")
    f = np.sin(xx / 3.0) * np.cos(yy / 4.0) + 0.3 * np.sin(zz / 2.0)
    f = (f - f.min()) / np.ptp(f)
    R = f + 0.02 * rng.randn(*shape)
    sites = rng.choice(shape[0] * shape[1], int(0.5 * shape[0] * shape[1]),
                       replace=False)
    R.reshape(-1, shape[2])[sites] = np.nan
    return R


def _run_mgrid(label, R, truth, iterations, **kwargs):
    """One skreconstructor run of a masked-lattice row (_run_sk: launches
    against the code, shapes, NaNs, tensors on the card), which must take
    the masked-lattice route; adds rmse_vs_truth over the whole grid."""
    from gpim_tpu_torch import utils
    Xf = utils.get_full_grid(R)
    model, mean, sd, hp, rec = _run_sk(
        label, R, utils.get_sparse_grid(R), Xf, iterations=iterations,
        **dict(MGRID, **kwargs))
    if model._mgrid_engine is None:
        raise AssertionError("%s did not take the masked-lattice route"
                             % label)
    rec["rmse_vs_truth"] = float(np.sqrt(np.mean((mean - truth) ** 2)))
    rec["data_sd"] = float(np.nanstd(R))
    rec["n_obs"] = int((~np.isnan(R)).sum())
    log("[mgrid] %-27s G = %d, n_obs = %d, rmse_vs_truth %.5f, data sd "
        "%.4f" % (label, R.size, rec["n_obs"], rec["rmse_vs_truth"],
                  rec["data_sd"]))
    return model, mean, sd, hp, rec


def _mgrid_gates(label, model, mean, sd, R, truth, rng, rec, quality=True):
    """Every gate benchmarks/suite.py:369-446 raises on, drawn from the
    suite's generator in its order: rmse and the disagreement with an exact
    GP trained on 4000 observed points (reconstructor, 200 iterations) at
    2000 observed cells below 0.15 data sd; 1-sigma coverage >= 0.55 at
    2000 observed and 2000 unobserved cells; model sd^2 >= 0.8 of the exact
    posterior variance (ski.mgrid_exact_var_probe, 512 CG iterations at the
    model's preconditioner rank) at 32 observed and 32 unobserved cells.
    With ``quality`` False the rmse and the exact-4k cross-check are
    printed and only the variance gates raise: those two gates hold for
    the suite's smooth analytic cube, not for a rough random field
    (large_masked_ski --xl), whose own rmse gate the caller applies."""
    import torch
    from gpim_tpu_torch import reconstructor
    from gpim_tpu_torch.gpreg.multi import _constrain_task
    from gpim_tpu_torch.ops import ski
    shape = R.shape
    obs_idx = np.flatnonzero(~np.isnan(R).ravel())
    sub = rng.choice(obs_idx, 4000, replace=False)
    probe = rng.choice(obs_idx, 2000, replace=False)
    Xs = np.stack(np.unravel_index(sub, shape), 0).astype(np.float64)
    Xp = np.stack(np.unravel_index(probe, shape), 0).astype(np.float64)
    t0 = time.perf_counter()
    m_ex = reconstructor(Xs, R.ravel()[sub], Xp, kernel="RBF",
                         lengthscale=[[0.5] * 3, [50.0] * 3],
                         iterations=200, learning_rate=0.1, verbose=0)
    mean_ex, _, _ = m_ex.run()
    ex_s = time.perf_counter() - t0
    dis = float(np.sqrt(np.mean((mean.ravel()[probe] - mean_ex) ** 2)))
    sd_data = rec["data_sd"]
    z_obs = (R.ravel()[probe] - mean.ravel()[probe]) / sd.ravel()[probe]
    cov_obs = float(np.mean(np.abs(z_obs) < 1.0))
    uno_idx = np.flatnonzero(np.isnan(R).ravel())
    uno = rng.choice(uno_idx, 2000, replace=False)
    z_uno = (truth.ravel()[uno] - mean.ravel()[uno]) / sd.ravel()[uno]
    cov_uno = float(np.mean(np.abs(z_uno) < 1.0))
    eng = model._mgrid_engine
    cells = np.stack(np.unravel_index(
        np.concatenate([rng.choice(obs_idx, 32, replace=False),
                        rng.choice(uno_idx, 32, replace=False)]), shape), -1)
    from gpim_tpu_torch.ops import gram_kernels as gk
    k1_before = gk.sqdist.launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        p = _constrain_task({k: v[0] for k, v in model.u.items()},
                            model._bounds())
        var_ex = ski.mgrid_exact_var_probe(
            "RBF", {"lengthscale": p["lengthscale"],
                    "variance": p["variance"]},
            eng._axes, eng.grid_shape, eng._mask, p["noise"] + model.jitter,
            cells, cg_iters=512, rank=eng.precond_rank)
        var_ex = var_ex.cpu().numpy() + float(p["noise"])
    probe_s = time.perf_counter() - t0
    if model.device.type == "cuda" and \
            gk.sqdist.launches - k1_before != len(shape):
        raise AssertionError("%s: the variance probe launched K1 %d times, "
                             "the code implies %d" % (
                                 label, gk.sqdist.launches - k1_before,
                                 len(shape)))
    sd_at = sd[tuple(cells.T)]
    ratio = sd_at ** 2 / np.maximum(var_ex, 1e-12)
    rec.update({"xcheck_rmse_vs_exact4k": dis, "exact4k_s": ex_s,
                "sd_coverage_1s_obs": cov_obs,
                "sd_coverage_1s_unobs": cov_uno,
                "sd2_vs_exact_ratio_min": float(ratio.min()),
                "sd2_vs_exact_ratio_median": float(np.median(ratio)),
                "var_probe_s": probe_s})
    log("[mgrid] %-27s gates: rmse %.5f and exact-4k xcheck %.5f (< %.5f%s), "
        "coverage obs %.3f unobs %.3f (>= 0.55), sd^2 / exact var min %.3f "
        "median %.3f (>= 0.8); exact GP %.2f s, variance probe %.2f s"
        % (label, rec["rmse_vs_truth"], dis, 0.15 * sd_data,
           "" if quality else ", not gated", cov_obs,
           cov_uno, ratio.min(), np.median(ratio), ex_s, probe_s))
    if quality and not (rec["rmse_vs_truth"] < 0.15 * sd_data
                        and dis < 0.15 * sd_data):
        raise AssertionError("%s quality gate failed: rmse %.4f, xcheck "
                             "%.4f at data sd %.4f" % (
                                 label, rec["rmse_vs_truth"], dis, sd_data))
    if not (cov_obs >= 0.55 and cov_uno >= 0.55):
        raise AssertionError("%s variance gate failed: 1-sigma coverage obs "
                             "%.3f unobs %.3f" % (label, cov_obs, cov_uno))
    if not (ratio >= 0.8).all():
        raise AssertionError("%s variance gate failed: model sd^2 below 0.8 "
                             "of the exact posterior variance at %d/64 cells "
                             "(min ratio %.3f)" % (
                                 label, int((ratio < 0.8).sum()),
                                 ratio.min()))


def _time_mgrid_ops(model):
    """The masked-lattice CG's pieces at the model's shape, float32, device
    ms a call (CUDA events around a warm loop): the masked mvm on the
    (9, G) block batch-first and on its (G, 9) column twin, and P^-1/2 on
    the factored basis; beside the mvm's bound, the larger of its bytes
    (read v and the mask, write the result) over the memory rate and its
    operations (the d mode products, 2 b G sum_k g_k) over the f32 peak."""
    import torch
    from gpim_tpu_torch.gpreg import mgrid_model
    from gpim_tpu_torch.gpreg.multi import _constrain_task
    from gpim_tpu_torch.ops import ski
    eng = model._mgrid_engine
    G = eng._mask.shape[0]
    with torch.no_grad():
        u = {k: v[0] for k, v in model.u.items()}
        p = _constrain_task(u, model._bounds())
        factors = ski.grid_kernel_factors(
            "RBF", {"lengthscale": p["lengthscale"],
                    "variance": p["variance"]}, eng._axes)
        Qp, lam = mgrid_model._build_precond(
            u, eng._axes, eng._mask, model._bounds(), kernel="RBF",
            rank=eng.precond_rank)
        noise = p["noise"] + model.jitter
        pis, _ = ski.split_apply(Qp, lam, noise, vec_axis=1)
        V = torch.randn(eng._g0.shape[0] + 1, G, device="cuda",
                        dtype=eng._mask.dtype)
        Vc = V.mT.contiguous()
        bf = ski.make_masked_grid_mvm(eng.grid_shape, eng._mask, True)
        col = ski.make_masked_grid_mvm(eng.grid_shape, eng._mask, False)
        t_bytes = (2 * V.numel() + G) * V.element_size() / PEAK_BYTES_PER_S
        t_ops = 2 * V.numel() * sum(eng.grid_shape) / PEAK_OPS_PER_S[
            "float32"]
        out = {"mvm_bf_ms": _time_ms(lambda: bf(factors, noise, V), 20),
               "mvm_col_ms": _time_ms(lambda: col(factors, noise, Vc), 20),
               "pisqrt_ms": _time_ms(lambda: pis(V), 20),
               "mvm_bound_ms": 1e3 * max(t_bytes, t_ops),
               "mvm_bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    log("[mgrid] CG pieces at G = %d, %d rows, float32: masked mvm "
        "batch-first %.4f ms, column layout %.4f ms (bound %.4f ms, %s), "
        "P^-1/2 %.4f ms (rank %d)" % (
            G, V.shape[0], out["mvm_bf_ms"], out["mvm_col_ms"],
            out["mvm_bound_ms"], out["mvm_bound_by"], out["pisqrt_ms"],
            eng.precond_rank))
    return out


def _warm_start_rows(label, R, iters, **kwargs):
    """The masked-lattice engine of ``R``'s model trained ``iters`` steps
    from the model's initial parameters, cold and then warm-started
    (MaskedGridEngine.train(warm_start=True), gpim_tpu's experimental
    option, off skreconstructor's surface): each one's wall, realized CG
    iterations a step, segments and K1 launches (d (steps + segments)),
    and the final lengthscales' largest relative gap."""
    import torch
    from gpim_tpu_torch import skreconstructor, utils
    model = skreconstructor(utils.get_sparse_grid(R), R,
                            utils.get_full_grid(R), iterations=iters,
                            verbose=0, **dict(MGRID, **kwargs))
    eng = model._mgrid_engine
    if eng is None:
        raise AssertionError("%s did not take the masked-lattice route"
                             % label)
    u0 = {k: v[0] for k, v in model.u.items()}
    recs = {}
    for tag in ("cold", "warm"):
        torch.cuda.synchronize()
        _reset_launches()
        t0 = time.perf_counter()
        _, traj = eng.train(u0, model._bounds(), model.learning_rate,
                            model.jitter, iterations=iters,
                            record_cg_iters=True, warm_start=tag == "warm")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _read_launches()
        expected = len(eng.grid_shape) * (iters + len(eng.last_segments))
        recs[tag] = {"train_s": wall,
                     "cg_iters": [int(i) for i in eng.last_cg_iters],
                     "segments": list(eng.last_segments),
                     "launches": launches,
                     "ls": traj["lengthscale"][-1].cpu().numpy().tolist()}
        log("[mgrid] %-27s %s start: train %.3f s, realized CG iterations "
            "a step %s (%d in all), segments %s, launches %s" % (
                label, tag, wall, recs[tag]["cg_iters"],
                sum(recs[tag]["cg_iters"]), recs[tag]["segments"], launches))
        if launches != _counts(sqdist=expected):
            raise AssertionError("%s %s start: launches %s, the code implies "
                                 "K1 %d" % (label, tag, launches, expected))
        if not np.isfinite(traj["loss"].cpu().numpy()).all():
            raise AssertionError("%s %s start: a loss is not finite"
                                 % (label, tag))
    ls_c, ls_w = (np.asarray(recs[t]["ls"]) for t in ("cold", "warm"))
    recs["ls_rgap"] = float(np.max(np.abs(ls_w - ls_c) / np.abs(ls_c)))
    log("[mgrid] %-27s warm start against cold: final lengthscale %s "
        "against %s, largest relative gap %.3e; train %.3f s against %.3f s"
        % (label, np.array2string(ls_w, precision=4),
           np.array2string(ls_c, precision=4), recs["ls_rgap"],
           recs["warm"]["train_s"], recs["cold"]["train_s"]))
    return model, recs


def _memory_analysis(label, model):
    """MaskedGridEngine.train_memory_analysis at the row's iterations: the
    measured peak of a training run beside the analytic model."""
    eng = model._mgrid_engine
    out = eng.train_memory_analysis(
        {k: v[0] for k, v in model.u.items()}, model._bounds(),
        model.learning_rate, model.jitter, iterations=model.iterations)
    analytic = sum(out["analytic_bytes"].values())
    log("[mgrid] %-27s train_memory_analysis (%d steps): peak allocated "
        "%.3f GiB (%.3f GiB held before), the analytic model's buffers "
        "%.3f GiB: %s" % (
            label, model.iterations, out["peak_allocated_bytes"] / 2 ** 30,
            out["allocated_before_bytes"] / 2 ** 30, analytic / 2 ** 30,
            json.dumps(out["analytic_bytes"])))
    if not out["peak_allocated_bytes"] >= analytic:
        raise AssertionError("%s: the measured peak is below the analytic "
                             "model's buffers" % label)
    return out


def phase_mgrid():
    """The three masked-lattice rows of benchmarks/suite.py with their
    gates, ski_masked64x64x32 in float64 against float32, the warm-started
    CG beside the cold one on ski_masked64x64x32 and the 1M row, the 1M
    engine's memory accounting, and small problems card against CPU in
    float64. Returns (the warm runs' launches by path, the 1M row's warm
    model, ski_masked64x64x32's rmse_vs_truth)."""
    import torch
    from gpim_tpu_torch import dtypes, utils
    paths, recs = {}, {}

    R, truth = ski_masked_data()
    shape, iters = MGRID_ROWS["ski_masked64x64x32"]
    _run_mgrid("ski_masked64 f32 cold", R, truth, iters, ski=True)
    torch.cuda.reset_peak_memory_stats()
    m32, k32, s32, h32, recs["ski_masked64x64x32"] = _run_mgrid(
        "ski_masked64 f32 warm", R, truth, iters, ski=True)
    recs["ski_masked64x64x32"]["peak_gib"] = \
        torch.cuda.max_memory_allocated() / 2 ** 30
    paths["ski_masked64x64x32"] = recs["ski_masked64x64x32"]["launches"]
    # the suite reports this row's rmse and gates nothing: 70% of the
    # spectra of a smoothed random field are missing, so the mean alone
    # misses by ~1 data sd; a trained model must do clearly better
    if not recs["ski_masked64x64x32"]["rmse_vs_truth"] < 0.75 * recs[
            "ski_masked64x64x32"]["data_sd"]:
        raise AssertionError("ski_masked64x64x32 rmse_vs_truth %.4f >= 0.75 "
                             "data sd" % recs["ski_masked64x64x32"][
                                 "rmse_vs_truth"])
    _, k64, s64, h64, recs["ski_masked64_f64"] = _run_mgrid(
        "ski_masked64 f64", R, truth, iters, ski=True, precision="double",
        jitter=dtypes.default_jitter(torch.float32))
    diffs = {
        "mean_atol": float(np.abs(k32 - k64).max()),
        "sd_atol": float(np.abs(s32 - s64).max()),
        "ls_rtol": float(np.max(np.abs(h32["lengthscale"][-1]
                                       - h64["lengthscale"][-1])
                                / np.abs(h64["lengthscale"][-1]))),
        "noise_rtol": float(abs(h32["noise"][-1] - h64["noise"][-1])
                            / abs(h64["noise"][-1])),
    }
    log("[cross-check] ski_masked64 f32 vs f64: %s (limits %s)"
        % (json.dumps(diffs), json.dumps(MGRID_CROSS_TOL)))
    for k, lim in MGRID_CROSS_TOL.items():
        if not diffs[k] <= lim:
            raise AssertionError("ski_masked64 f32 vs f64 %s %.3e > %.0e"
                                 % (k, diffs[k], lim))
    del m32
    _, recs["ski_masked64x64x32_warm_start"] = _warm_start_rows(
        "ski_masked64x64x32", R, iters, ski=True)

    for row in ("mgrid_masked128x128x64", "mgrid_masked256x256x64"):
        shape, iters = MGRID_ROWS[row]
        R, truth, rng = mgrid_data(shape)
        if row == "mgrid_masked128x128x64":
            _run_mgrid(row + " f32 cold", R, truth, iters)
        torch.cuda.reset_peak_memory_stats()
        model, mean, sd, hp, rec = _run_mgrid(row + " f32 warm", R, truth,
                                              iters)
        rec["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        log("[mgrid] %-27s peak device memory %.2f GiB" % (row,
                                                          rec["peak_gib"]))
        _mgrid_gates(row, model, mean, sd, R, truth, rng, rec)
        recs[row], paths[row] = rec, rec["launches"]
        if row == "mgrid_masked128x128x64":
            recs[row]["ops"] = _time_mgrid_ops(model)
            model_1m = model
            del model, mean, sd
            fresh, recs[row + "_warm_start"] = _warm_start_rows(row, R, iters)
            recs[row + "_memory"] = _memory_analysis(row, fresh)
            del fresh
        else:
            del model, mean, sd
        torch.cuda.empty_cache()

    # small problems in float64: the card against the CPU
    Rs = small_lattice_data()
    Xs, Xts = utils.get_sparse_grid(Rs), utils.get_full_grid(Rs)
    for kernel in ("RBF", "Matern52"):
        out = {}
        for use_gpu in (True, False):
            extra = {} if use_gpu else {"use_gpu": False}
            m, mean, sd, hp, _ = _run_sk(
                "small mgrid %s %s" % (kernel, "card" if use_gpu else "cpu"),
                Rs, Xs, Xts, kernel=kernel, iterations=10,
                learning_rate=0.05, precision="double", ski_min_points=1,
                **extra)
            out[use_gpu] = (mean, sd, hp["lengthscale"], hp["noise"],
                            m._mgrid_engine.last_cg_iters)
        worst = max(float(np.max(np.abs(g - c)) / np.max(np.abs(c)))
                    for g, c in zip(out[True][:4], out[False][:4]))
        log("[cross-check] small mgrid %s, CUDA vs CPU (f64): max diff / "
            "max value %.3e (limit %.0e); CG iterations %s and %s" % (
                kernel, worst, SMALL_RTOL, out[True][4].tolist(),
                out[False][4].tolist()))
        if not worst <= SMALL_RTOL:
            raise AssertionError("CUDA and CPU masked-lattice paths disagree "
                                 "on %s" % kernel)
    log("[mgrid] warm records: " + json.dumps(recs))
    return paths, model_1m, recs["ski_masked64x64x32"]["rmse_vs_truth"]


def phase_mgrid_profile(model):
    """MGRID_PROFILE_STEPS warm float32 training steps of the 1M row (with
    the preconditioner rebuilds the schedule puts in them)."""
    model.iterations = MGRID_PROFILE_STEPS
    _report_profile("mgrid_masked128x128x64", "warm float32 training steps",
                    MGRID_PROFILE_STEPS, _profiled(model.train), host_ops=10,
                    host_keys=("aten::linalg_eigh",))


# ---------------------------------------------------------------------------
# the off-lattice SKI route (skreconstructor with lattice=False, or on
# scattered points)
# ---------------------------------------------------------------------------

def scattered_data(shape, seed):
    """Random coordinates shaped like a ``shape`` grid (each uniform over
    its axis's range), a smooth surface on them with noise 0.02, 10% of
    the points removed; returns (R, X, the full lattice of ``shape`` as
    the test points)."""
    from gpim_tpu_torch import utils
    rng = np.random.RandomState(seed)
    d = len(shape)
    span = (np.asarray(shape, np.float64) - 1).reshape((d,) + (1,) * d)
    X = rng.rand(d, *shape) * span
    f = np.sin(X[0] / 5.0) * np.cos(X[1] / 7.0)
    if d == 3:
        f = f + 0.3 * np.sin(X[2] / 4.0)
    R = f + 0.02 * rng.randn(*shape)
    gone = rng.rand(*shape) < 0.1
    R[gone] = np.nan
    X[:, gone] = np.nan
    return R, X, utils.get_full_grid(np.zeros(shape))


def _run_offlattice(label, R, truth, iterations, **kwargs):
    """One skreconstructor run of an off-lattice row (_run_sk: launches
    against the code, shapes, NaNs, tensors on the card), which must take
    the off-lattice route; adds rmse_vs_truth over the whole grid."""
    from gpim_tpu_torch import utils
    model, mean, sd, hp, rec = _run_sk(
        label, R, utils.get_sparse_grid(R), utils.get_full_grid(R),
        iterations=iterations, **dict(OFFLATTICE, **kwargs))
    if model._ski_engine is None:
        raise AssertionError("%s did not take the off-lattice route" % label)
    eng = model._ski_engine
    rec["rmse_vs_truth"] = float(np.sqrt(np.mean((mean - truth) ** 2)))
    rec["data_sd"] = float(np.nanstd(R))
    rec["n_obs"] = int((~np.isnan(R)).sum())
    rec["grid_shape"] = list(eng.grid_shape)
    log("[ski] %-27s inducing grid %s, n = %d (%d observed), rmse_vs_truth "
        "%.5f, data sd %.4f" % (label, eng.grid_shape, rec["n_train"],
                                rec["n_obs"], rec["rmse_vs_truth"],
                                rec["data_sd"]))
    return model, mean, sd, hp, rec


def _time_offlattice_ops(model):
    """The off-lattice CG's pieces at the model's shape, float32, device ms
    a call (CUDA events around a warm loop): the operator on the (9, n)
    block (and, for comparison, the same operator with its grid block in
    the (b, G) layout) and P^-1/2 on the dense (n, r) basis; beside each
    one's bound,
    the larger of its bytes over the memory rate and its operations over
    the f32 peak. The operator must read the block, the int64 corner
    indices and the weights and write the result; it scatters and gathers
    2^d corners a point (2 b n 2^d multiply-adds) and runs the d mode
    products (2 b G sum_k g_k). P^-1/2 reads the basis and the block and
    writes the result, 4 b n r operations."""
    import torch
    from gpim_tpu_torch.gpreg import ski_model
    from gpim_tpu_torch.gpreg.multi import _constrain_task
    from gpim_tpu_torch.ops import ski
    eng = model._ski_engine
    n, S = eng._idx.shape
    G = int(np.prod(eng.grid_shape))
    with torch.no_grad():
        u = {k: v[0] for k, v in model.u.items()}
        p = _constrain_task(u, model._bounds())
        factors = ski.grid_kernel_factors(
            "RBF", {"lengthscale": p["lengthscale"],
                    "variance": p["variance"]}, eng._grids)
        Qp, lam = ski_model._build_precond(
            u, eng._grids, eng._i0, eng._w0, eng._mask, model._bounds(),
            kernel="RBF", rank=eng.precond_rank)
        noise = p["noise"] + model.jitter
        pis, _ = ski.split_apply(Qp, lam, noise, vec_axis=1)
        V = torch.randn(eng._g0.shape[0] + 1, n, device="cuda",
                        dtype=eng._mask.dtype)
        b, item = V.shape[0], V.element_size()
        r = Qp.shape[1]
        flat = eng._idx.reshape(-1)
        gshape = tuple(eng.grid_shape)

        def mvm_bf(v):
            # the same operator with its grid block in the (b, G) layout:
            # index_add_ and index_select along dim 1
            u = v.new_zeros((b, G)).index_add_(
                1, flat, (v[:, :, None] * eng._wgt).reshape(b, n * S))
            t = ski.kron_mvm_bf(factors, u.reshape((b,) + gshape))
            return (t.reshape(b, G).index_select(1, flat).reshape(b, n, S)
                    * eng._wgt).sum(2) + noise * v
        mvm = ski.make_interp_mvm(eng._idx, eng._wgt, eng.grid_shape)
        ref = mvm(factors, noise, V)
        err = float((mvm_bf(V) - ref).abs().max() / ref.abs().max())
        if not err <= 1e-5:
            raise AssertionError("the (b, G) operator disagrees: %.3e" % err)
        out = {"mvm_ms": _time_ms(lambda: mvm(factors, noise, V), 20),
               "mvm_bf_ms": _time_ms(lambda: mvm_bf(V), 20),
               "pisqrt_ms": _time_ms(lambda: pis(V), 20)}
        for key, nbytes, ops in (
                ("mvm", (2 * b * n + n * S) * item + n * S * 8,
                 4 * b * n * S + 2 * b * G * sum(eng.grid_shape)),
                ("pisqrt", (2 * b * n + n * r) * item, 4 * b * n * r)):
            t_bytes = nbytes / PEAK_BYTES_PER_S
            t_ops = ops / PEAK_OPS_PER_S["float32"]
            out[key + "_bound_ms"] = 1e3 * max(t_bytes, t_ops)
            out[key + "_bound_by"] = ("bytes" if t_bytes >= t_ops
                                      else "operations")
    log("[ski] CG pieces at n = %d, G = %d, %d rows, float32: operator "
        "%.4f ms with its (G, b) grid block, %.4f ms with a (b, G) one "
        "(bound %.4f ms, %s), P^-1/2 %.4f ms (rank %d; bound %.4f ms, %s)"
        % (n, G, b, out["mvm_ms"], out["mvm_bf_ms"], out["mvm_bound_ms"],
            out["mvm_bound_by"], out["pisqrt_ms"], r,
            out["pisqrt_bound_ms"], out["pisqrt_bound_by"]))
    return out


def _small_offlattice_checks():
    """Random 2D and 3D coordinates, 9216 rows (>= ski_min_points), float64,
    10 iterations: the card against the CPU, trajectories, mean and sd
    within SMALL_RTOL, on the Nystrom variance path, on the Lanczos path
    (precond_rank=0, CG to convergence) and after predict(max_root=48)."""
    # Without the preconditioner CG needs ~160-210 iterations here: capped
    # at the default 64 its iterate is so far from converged that a
    # relative perturbation of 1e-14 moves the predictive mean by 1e-4
    # (measured on the CPU), and the card and the CPU, whose sums round
    # differently, would be compared on round-off. So that case lifts the
    # cap.
    cases = [("2D", (96, 96), {}),
             ("2D Lanczos", (96, 96), {"precond_rank": 0,
                                       "cg_iterations": 512}),
             ("3D", (24, 24, 16), {})]
    for name, shape, kw in cases:
        R, X, Xt = scattered_data(shape, seed=len(shape))
        out, models = {}, {}
        for use_gpu in (True, False):
            extra = {} if use_gpu else {"use_gpu": False}
            m, mean, sd, hp, _ = _run_sk(
                "small off-lattice %s %s" % (name, "card" if use_gpu
                                             else "cpu"), R, X, Xt,
                kernel="RBF", iterations=10, learning_rate=0.1,
                precision="double", **kw, **extra)
            if m._ski_engine is None:
                raise AssertionError("small off-lattice %s did not take "
                                     "the off-lattice route" % name)
            out[use_gpu] = [mean, sd, hp["lengthscale"], hp["noise"]]
            models[use_gpu] = m
        if name == "3D":
            for use_gpu, m in models.items():
                out[use_gpu] += list(m.predict(max_root=48))
        worst = max(float(np.max(np.abs(g - c)) / np.max(np.abs(c)))
                    for g, c in zip(out[True], out[False]))
        log("[cross-check] small off-lattice %s, CUDA vs CPU (f64): max "
            "diff / max value %.3e (limit %.0e); CG iterations %s and %s"
            % (name, worst, SMALL_RTOL,
               models[True]._ski_engine.last_cg_iters.tolist(),
               models[False]._ski_engine.last_cg_iters.tolist()))
        if not worst <= SMALL_RTOL:
            raise AssertionError("CUDA and CPU off-lattice paths disagree "
                                 "on %s" % name)


def phase_ski(mgrid64_rmse):
    """The two off-lattice rows, ski_offlattice64x64x32 twice warm (the two
    bit-equal) and in float64 against float32, the same cube at
    precond_rank=0 on both SKI routes, and small problems card against CPU
    in float64. Returns (the warm runs' launches by path, the 64x64x32
    row's warm model)."""
    import torch
    from gpim_tpu_torch import dtypes
    from gpim_tpu_torch.ops import ski
    paths, recs = {}, {}

    row = "ski_offlattice64x64x32"
    R, truth = ski_masked_data()
    iters = OFFLATTICE_ROWS[row][1]
    _run_offlattice(row + " f32 cold", R, truth, iters)
    torch.cuda.reset_peak_memory_stats()
    m32, k32, s32, h32, rec = _run_offlattice(row + " f32 warm", R, truth,
                                              iters)
    rec["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    recs[row], paths[row] = rec, rec["launches"]
    log("[ski] %-27s rmse_vs_truth %.5f; the masked-lattice route on the "
        "same cube %.5f (phase mgrid); data sd %.4f; peak device memory "
        "%.2f GiB" % (row, rec["rmse_vs_truth"], mgrid64_rmse,
                      rec["data_sd"], rec["peak_gib"]))
    # the suite's sanity gate of the masked row on the same cube
    if not rec["rmse_vs_truth"] < 0.75 * rec["data_sd"]:
        raise AssertionError("%s rmse_vs_truth %.4f >= 0.75 data sd"
                             % (row, rec["rmse_vs_truth"]))
    m32b, k32b, s32b, h32b, rec_b = _run_offlattice(
        row + " f32 warm again", R, truth, iters)
    rerun = {"mean": float(np.abs(k32 - k32b).max()),
             "sd": float(np.abs(s32 - s32b).max()),
             "lengthscale": float(np.abs(h32["lengthscale"]
                                         - h32b["lengthscale"]).max()),
             "noise": float(np.abs(h32["noise"] - h32b["noise"]).max()),
             "loss": float(np.abs(m32.losses - m32b.losses).max()),
             "same_cg_iters": rec_b["cg_iters"] == rec["cg_iters"]}
    rec["run_to_run"] = rerun
    log("[ski] %s two warm runs, largest differences (K4 sums in a fixed "
        "order, so all must be 0): %s" % (row, json.dumps(rerun)))
    if not (rerun["same_cg_iters"] and all(
            rerun[k] == 0.0 for k in ("mean", "sd", "lengthscale", "noise",
                                      "loss"))):
        raise AssertionError("%s: two float32 runs are not bit-equal: %s"
                             % (row, json.dumps(rerun)))
    del m32b
    _, k64, s64, h64, recs[row + "_f64"] = _run_offlattice(
        row + " f64", R, truth, iters, precision="double",
        jitter=dtypes.default_jitter(torch.float32))
    diffs = {
        "mean_atol": float(np.abs(k32 - k64).max()),
        "sd_atol": float(np.abs(s32 - s64).max()),
        "ls_rtol": float(np.max(np.abs(h32["lengthscale"][-1]
                                       - h64["lengthscale"][-1])
                                / np.abs(h64["lengthscale"][-1]))),
        "noise_rtol": float(abs(h32["noise"][-1] - h64["noise"][-1])
                            / abs(h64["noise"][-1])),
    }
    log("[cross-check] %s f32 vs f64: %s (limits %s)"
        % (row, json.dumps(diffs), json.dumps(OFFLATTICE_CROSS_TOL)))
    for k, lim in OFFLATTICE_CROSS_TOL.items():
        if not diffs[k] <= lim:
            raise AssertionError("%s f32 vs f64 %s %.3e > %.0e"
                                 % (row, k, diffs[k], lim))

    # the same cube without a preconditioner, on both SKI routes, at the
    # default cg_iterations: the predict solve runs to CG's tolerance under
    # ski.PREDICT_CG_ITERS, the variance is LOVE's
    for label, run in (("ski_offlattice64x64x32 rank 0", _run_offlattice),
                       ("ski_masked64x64x32 rank 0", _run_mgrid)):
        model, _, _, _, rec = run(label, R, truth, iters, precond_rank=0)
        eng = model._ski_engine or model._mgrid_engine
        rec["predict_cg_iters"] = eng.last_predict_cg_iters
        rec["lanczos_rank"] = eng.rank
        recs[label], paths[label] = rec, rec["launches"]
        log("[ski] %-27s rmse_vs_truth %.5f (gate < %.5f), realized "
            "predict CG iterations %d (cap %d), Lanczos rank %d, training "
            "CG iterations %d in all" % (
                label, rec["rmse_vs_truth"], 0.75 * rec["data_sd"],
                rec["predict_cg_iters"], ski.PREDICT_CG_ITERS,
                rec["lanczos_rank"], sum(rec["cg_iters"])))
        if not rec["rmse_vs_truth"] < 0.75 * rec["data_sd"]:
            raise AssertionError("%s rmse_vs_truth %.4f >= 0.75 data sd"
                                 % (label, rec["rmse_vs_truth"]))
        del model

    row = "ski_offlattice128x128x64"
    shape, iters = OFFLATTICE_ROWS[row]
    R, truth, _ = mgrid_data(shape)
    torch.cuda.reset_peak_memory_stats()
    model, _, _, _, rec = _run_offlattice(row + " f32", R, truth, iters)
    rec["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    log("[ski] %-27s peak device memory %.2f GiB" % (row, rec["peak_gib"]))
    rec["ops"] = _time_offlattice_ops(model)
    recs[row], paths[row] = rec, rec["launches"]
    del model
    torch.cuda.empty_cache()

    _small_offlattice_checks()
    log("[ski] warm records: " + json.dumps(recs))
    return paths, m32


def phase_ski_profile(model):
    """MGRID_PROFILE_STEPS warm float32 training steps of
    ski_offlattice64x64x32 (with the preconditioner rebuilds the schedule
    puts in them)."""
    model.iterations = MGRID_PROFILE_STEPS
    _report_profile("ski_offlattice64x64x32", "warm float32 training steps",
                    MGRID_PROFILE_STEPS, _profiled(model.train), host_ops=10,
                    host_keys=("aten::linalg_eigh",))


# ---------------------------------------------------------------------------
# the example runners (gpim_tpu_torch/examples) and the trace
# ---------------------------------------------------------------------------

def _gpr_expected(model, n_test):
    """Kernel launches a reconstructor run implies. Exact RBF: K2 and K3
    each Adam step, K1 for the training Gram and once a 4096-point test
    chunk; VFE: K1 for Kmm and Kmn each Adam step, both once more and once
    a chunk in predict."""
    steps = int(model.iterations)
    n_chunks = -(-n_test // 4096)
    if model.do_sparse:
        return _counts(sqdist=2 * steps + 2 + n_chunks)
    if model.kernel_type != "RBF":
        raise ValueError("no launch count for an exact %s run"
                         % model.kernel_type)
    return _counts(sqdist=1 + n_chunks, masked_system=steps,
                   rbf_bwd_reductions=steps)


def _workflow_expected(name, model, mean, mean2x=None):
    """Kernel launches an example workflow implies (a runner's run() or its
    notebook) but the BO's (_bo_expected): ``model`` is its model, ``mean``
    its prediction and ``mean2x`` the ckpfm workflow's 2x-dense one."""
    if name == "eels_parallel_gp":
        return _multi_expected(model, int(mean.size // mean.shape[-1]))
    if name in ("quickstart", "sparse_image_2d", "hyperspectral_3d_sparse"):
        return _gpr_expected(model, int(mean.size))
    expected = _sk_expected(model, int(mean.size))
    if mean2x is not None:
        # the 2x-dense predict: K1 once a factor and once a factor a chunk
        # of its cross rows
        d = len(model._kron_engine.dims)
        expected["sqdist"] += d * (1 + -(-int(mean2x.size) // SK_CHUNK))
    return expected


def _example_inputs(name, xl=False):
    """The runner's default data, made before its timed run."""
    mod = importlib.import_module("gpim_tpu_torch.examples." + name)
    if name == "large_masked_ski":
        return {"cube": mod.make_cube(mod.SHAPE_XL if xl else mod.SHAPE)}
    key = {"sparse_image_2d": "R", "hyperspectral_3d_sparse": "cubes",
           "eels_parallel_gp": "bands", "ckpfm_4d_ski": "R",
           "bayesian_optimization": "Z_sparse"}[name]
    return {key: mod.data()}


def _run_example(name, outdir, xl=False):
    """One runner's run() at its script's budget on the card (its default
    device), with its data made beforehand; returns (its output, the
    record: wall, train and predict s, peak GiB, launches against the
    counts its code implies)."""
    import torch
    mod = importlib.import_module("gpim_tpu_torch.examples." + name)
    inputs = _example_inputs(name, xl)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    t0 = time.perf_counter()
    with _spans() as recorder:
        out = mod.run(outdir=outdir, **inputs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _read_launches()
    rec = {"wall_s": wall, "peak_gib": torch.cuda.max_memory_allocated()
           / 2 ** 30, "launches": launches, "iterations": mod.ITERATIONS}
    if name == "bayesian_optimization":
        bo = out["bo"]
        expected = _bo_expected(bo)
        model = bo.surrogate_model
        rec.update(steps=bo.steps_done, steps_per_s=bo.steps_done / wall,
                   best_found=out["best_found"])
    else:
        model = out["model"]
        ph = _phases(recorder)
        rec.update(train_s=ph["train"]["first_s"],
                   predict_s=ph["predict"]["first_s"])
        expected = _workflow_expected(name, model, out["mean"],
                                      out.get("mean2x"))
        if name == "ckpfm_4d_ski":
            # the second predict call, the 2x-dense one: the mean of the
            # warm calls is that one call
            rec["predict2x_s"] = ph["predict"]["warm_s"]
    if model.device.type != "cuda":
        raise AssertionError("%s ran on %s, not the card"
                             % (name, model.device))
    rec["expected"] = expected
    if launches != expected:
        raise AssertionError("%s: launches %s, the code implies %s"
                             % (name, launches, expected))
    return out, rec


def phase_examples():
    """Each of the six runners' run() once, warm (every kernel is built by
    now), at its script's full budget on the card, and large_masked_ski
    also at --xl: wall, train and predict s, peak memory, the quality
    number its script prints, launches against the counts its code
    implies, and the gates of the matching suite row or phase: flagship
    rmse_obs < 0.1, VFE rmse_vs_truth < 0.1, ckpfm rmse_fit < 0.1, the
    masked 64^3 cube's rmse_vs_truth < 0.75 data sd (phase mgrid's), at
    --xl also the 1M row's variance gates; eels and the BO, which their
    scripts gate on nothing, finite output of the expected shape. Results
    and the BO's checkpoint go to a temporary directory, removed at the
    end. Returns the launches by path."""
    import shutil
    import tempfile
    outdir = tempfile.mkdtemp(prefix="chip_smoke_examples_")
    paths, recs = {}, {}
    try:
        for name, xl in (("sparse_image_2d", False),
                         ("hyperspectral_3d_sparse", False),
                         ("eels_parallel_gp", False), ("ckpfm_4d_ski", False),
                         ("large_masked_ski", False),
                         ("large_masked_ski", True),
                         ("bayesian_optimization", False)):
            label = name + (" --xl" if xl else "")
            out, rec = _run_example(name, outdir, xl)
            if name == "bayesian_optimization":
                steps = out["bo"].exploration_steps
                ok = (rec["steps"] == steps
                      and out["indices"].shape == (steps, 2)
                      and np.isfinite(out["best_found"])
                      and os.path.exists(os.path.join(
                          outdir, "boptim_results.npy")))
                number = ("best_found", out["best_found"], None)
            else:
                mean, sd = out["mean"], out["sd"]
                data = out["Y"] if name == "eels_parallel_gp" else out["R"]
                # eels predicts on a 2x denser (x, y) grid
                shape = ((2 * data.shape[0], 2 * data.shape[1])
                         + data.shape[2:] if name == "eels_parallel_gp"
                         else data.shape)
                ok = (mean.shape == sd.shape == shape
                      and np.isfinite(mean).all() and np.isfinite(sd).all())
                if name == "ckpfm_4d_ski":
                    ok = ok and out["mean2x"].shape == tuple(
                        2 * n for n in data.shape) \
                        and np.isfinite(out["mean2x"]).all() \
                        and np.isfinite(out["sd2x"]).all()
                if name == "large_masked_ski":
                    rec["data_sd"] = float(np.nanstd(out["R"]))
                number = {
                    "sparse_image_2d": ("rmse_obs", out.get("rmse_obs"), 0.1),
                    "hyperspectral_3d_sparse": (
                        "rmse_vs_truth", out.get("rmse_vs_truth"), 0.1),
                    "eels_parallel_gp": ("rmse_vs_bands",
                                         out.get("rmse_vs_bands"), None),
                    "ckpfm_4d_ski": ("rmse_fit", out.get("rmse_fit"), 0.1),
                    "large_masked_ski": (
                        "rmse_vs_truth", out.get("rmse_vs_truth"),
                        0.75 * rec.get("data_sd", 0.0)),
                }[name]
            rec[number[0]] = number[1]
            extra = ""
            if name == "hyperspectral_3d_sparse":
                extra = ", mean abs error %.5f" % out["mae"]
            if name == "ckpfm_4d_ski":
                extra = ", 2x-dense predict %.3f s" % rec["predict2x_s"]
            eng = getattr(out.get("model"), "_mgrid_engine", None)
            if eng is not None:
                rec["cg_iters"] = [int(i) for i in eng.last_cg_iters]
                rec["segments"] = list(eng.last_segments)
                extra = ", realized CG iterations a step %s, segments %s" % (
                    rec["cg_iters"], rec["segments"])
            log("[examples] %-26s wall %.3f s, train %s s, predict %s s, "
                "peak %.2f GiB, %s %.5f%s, launches %s (the code implies "
                "%s)%s" % (
                    label, rec["wall_s"], _fmt(rec.get("train_s")),
                    _fmt(rec.get("predict_s")), rec["peak_gib"], number[0],
                    number[1], "" if number[2] is None
                    else " (gate < %.5f)" % number[2], rec["launches"],
                    rec["expected"], extra))
            if not ok:
                raise AssertionError("%s: output not finite or of the wrong "
                                     "shape" % label)
            if number[2] is not None and not number[1] < number[2]:
                raise AssertionError("%s: %s %.5f >= %.5f"
                                     % (label, number[0], number[1],
                                        number[2]))
            if name == "large_masked_ski" and xl:
                R, truth = out["R"], out["truth"]
                model = out["model"]
                if model._mgrid_engine is None:
                    raise AssertionError("%s did not take the masked-lattice "
                                         "route" % label)
                _mgrid_gates(label, model, out["mean"], out["sd"], R, truth,
                             np.random.RandomState(0), rec, quality=False)
            key = "ex_" + name + ("_xl" if xl else "")
            recs[key], paths[key] = rec, rec["launches"]
            del out
    finally:
        shutil.rmtree(outdir, ignore_errors=True)
    log("[examples] records: " + json.dumps(recs))
    return paths


def _fmt(x):
    return "-" if x is None else "%.3f" % x


NOTEBOOK_DIR = os.path.join(_HERE, "gpim_tpu_torch", "examples", "notebooks")
NOTEBOOKS = ("quickstart", "sparse_image_2d", "hyperspectral_3d_sparse",
             "eels_parallel_gp", "ckpfm_4d_ski", "large_masked_ski",
             "bayesian_optimization")


def _model_tensors(model):
    """The tensors a model holds, directly or in a dict (its parameters,
    bounds, padded data)."""
    out = []
    for v in vars(model).values():
        for t in (v.values() if isinstance(v, dict) else (v,)):
            if hasattr(t, "is_cuda"):
                out.append(t)
    return out


def _notebook_gate(name, ns, cwd):
    """(what the gate reads, its value, its limit or None, the output is
    finite and of the expected shape)."""
    if name == "bayesian_optimization":
        bo = ns["boptim"]
        best = float(np.nanmax(np.asarray(bo.target_func_vals[-1], float)))
        ok = (bo.steps_done == bo.exploration_steps
              and np.asarray(bo.indices_all).shape == (bo.steps_done, 2)
              and np.isfinite(np.asarray(bo.gp_predictions[-1][0])).all()
              and os.path.exists(os.path.join(cwd, "boptim_results.npy")))
        return "best_found", best, None, ok and np.isfinite(best)
    mean, sd = ns["mean"], ns["sd"]
    ok = np.isfinite(mean).all() and np.isfinite(sd).all() and \
        mean.shape == sd.shape
    if name == "quickstart":
        truth = ns["truth"]
        return ("rmse_vs_truth", float(np.sqrt(np.mean((mean - truth) ** 2))),
                0.1, ok and mean.shape == truth.shape)
    if name == "sparse_image_2d":
        R = ns["R"]
        obs = ~np.isnan(R)
        return ("rmse_obs", float(np.sqrt(np.mean((mean[obs] - R[obs]) ** 2))),
                0.1, ok and mean.shape == R.shape)
    if name == "hyperspectral_3d_sparse":
        # phase vfe's gate: against the full cube, both scaled by its range
        from gpim_tpu_torch.examples import _data
        truth = _data.bepfm_cube(sparse=False)
        span = np.ptp(truth)
        return ("rmse_vs_truth",
                float(np.sqrt(np.mean(((mean - truth) / span) ** 2))), 0.1,
                ok and mean.shape == truth.shape)
    if name == "eels_parallel_gp":
        return ("max_abs_mean", float(np.abs(mean).max()), None,
                ok and mean.shape == (64, 64, 6))
    if name == "ckpfm_4d_ski":
        R = ns["R"]
        ok = ok and mean.shape == R.shape and \
            ns["mean2x"].shape == tuple(2 * n for n in R.shape) and \
            np.isfinite(ns["mean2x"]).all() and np.isfinite(ns["sd2x"]).all()
        return ("rmse_fit", float(np.sqrt(np.mean((mean - R) ** 2))), 0.1,
                ok)
    # large_masked_ski: phase mgrid's gate
    truth, R = ns["truth"], ns["R"]
    return ("rmse_vs_truth", float(ns["rmse"]), 0.75 * float(np.nanstd(R)),
            ok and mean.shape == truth.shape
            and ns["model"]._mgrid_engine is not None)


def phase_notebooks():
    """Each of the seven notebooks of gpim_tpu_torch/examples/notebooks
    once, warm (every kernel is built by now), at its full budget on the
    card: _notebook.execute(device="cuda") in a new temporary directory,
    removed afterwards, with what the notebook prints kept aside (its last
    line is logged). Prints its wall, peak memory and skipped cells (those
    tagged plot, and no other); gates read from its namespace
    (_notebook_gate); every model tensor on the card; K1-K4 launches
    against the counts its code implies (quickstart: K2 and K3 once an
    Adam step). Returns the launches by path."""
    import contextlib
    import io
    import shutil
    import tempfile
    import torch
    from gpim_tpu_torch.examples import _notebook
    paths, recs = {}, {}
    for name in NOTEBOOKS:
        path = os.path.join(NOTEBOOK_DIR, name + ".ipynb")
        plots = [i for i, _, tags in _notebook.code_cells(path, skip_tags=())
                 if _notebook.PLOT_TAG in tags]
        cwd = tempfile.mkdtemp(prefix="chip_smoke_notebook_")
        printed = io.StringIO()
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _reset_launches()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(printed):
                ns, skipped = _notebook.execute(path, device="cuda", cwd=cwd)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = _read_launches()
            gate = _notebook_gate(name, ns, cwd)
        finally:
            shutil.rmtree(cwd, ignore_errors=True)
        if name == "quickstart":
            # phase kernels held K1-K3 at the shapes of this image
            R, truth = quickstart_data()
            if not (np.array_equal(ns["R"], R, equal_nan=True)
                    and np.array_equal(ns["truth"], truth)):
                raise AssertionError("quickstart: its image is not "
                                     "quickstart_data()'s")
        if name == "bayesian_optimization":
            model = ns["boptim"].surrogate_model
            expected = _bo_expected(ns["boptim"])
        else:
            model = ns["model"]
            expected = _workflow_expected(name, model, ns["mean"],
                                          ns.get("mean2x"))
        tensors = _model_tensors(model)
        rec = {"wall_s": wall, "peak_gib": torch.cuda.max_memory_allocated()
               / 2 ** 30, "iterations": ns["ITERS"], "skipped": skipped,
               "launches": launches, "expected": expected, gate[0]: gate[1]}
        last = (printed.getvalue().strip().splitlines() or [""])[-1]
        log("[notebooks] %-24s wall %.3f s, peak %.2f GiB, %d iterations, "
            "plot cells skipped %s, %s %s%s, %d model tensors on %s, "
            "launches %s (the code implies %s); it printed %d lines, the "
            "last: %s" % (
                name, wall, rec["peak_gib"], ns["ITERS"], skipped, gate[0],
                "%.5f" % gate[1],
                "" if gate[2] is None else " (gate < %.5f)" % gate[2],
                len(tensors), sorted({str(t.device) for t in tensors}),
                launches, expected,
                len(printed.getvalue().splitlines()), last[:120]))
        if skipped != plots:
            raise AssertionError("%s: skipped cells %s, its plot cells %s"
                                 % (name, skipped, plots))
        if not gate[3]:
            raise AssertionError("%s: output not finite or of the wrong "
                                 "shape" % name)
        if gate[2] is not None and not gate[1] < gate[2]:
            raise AssertionError("%s: %s %.5f >= %.5f"
                                 % (name, gate[0], gate[1], gate[2]))
        if model.device.type != "cuda" or not tensors or \
                not all(t.is_cuda for t in tensors):
            raise AssertionError("%s: a model tensor is not on the card"
                                 % name)
        if launches != expected:
            raise AssertionError("%s: launches %s, the code implies %s"
                                 % (name, launches, expected))
        if name == "quickstart" and not (
                launches["masked_system"] == launches["rbf_bwd_reductions"]
                == ns["ITERS"]):
            raise AssertionError("quickstart: K2/K3 not once an Adam step")
        key = "nb_" + name
        recs[key], paths[key] = rec, launches
        del ns
    log("[notebooks] records: " + json.dumps(recs))
    return paths


def phase_trace(R, X, X_full):
    """utils.profiling.trace around a warm flagship run of PROFILE_STEPS
    training steps and its predict, TRACE_REPEATS times, a new model each
    time (run() trains on from a model's parameters): each exported Chrome
    trace must hold K1, K2 and K3 among its CUDA kernel events as often as
    the run launched them (K2 = K3 = the steps, K1 = 1 + 4 chunks); the
    same run untraced beside them, for the instrumentation's cost."""
    import glob
    import shutil
    import tempfile
    import torch
    from gpim_tpu_torch import reconstructor
    from gpim_tpu_torch.utils.profiling import trace

    def model():
        return reconstructor(X, R, X_full, kernel="RBF", precision="single",
                             iterations=PROFILE_STEPS, verbose=0)

    expected = _gpr_expected(model(), int(X_full[0].size))
    walls = {}
    for tag in ["untraced"] + ["traced %d" % i
                               for i in range(1, TRACE_REPEATS + 1)]:
        m = model()
        logdir = tempfile.mkdtemp(prefix="chip_smoke_trace_")
        try:
            torch.cuda.synchronize()
            _reset_launches()
            t0 = time.perf_counter()
            if tag == "untraced":
                m.run()
                torch.cuda.synchronize()
            else:
                # trace synchronises the card before it closes its window
                with trace(logdir):
                    m.run()
            walls[tag] = time.perf_counter() - t0
            files = glob.glob(os.path.join(logdir, "*.pt.trace.json"))
            events = []
            if files:
                with open(files[0]) as f:
                    events = json.load(f)["traceEvents"]
            size = sum(os.path.getsize(f) for f in files)
        finally:
            shutil.rmtree(logdir, ignore_errors=True)
        if _read_launches() != expected:
            raise AssertionError("trace: launches %s, the code implies %s"
                                 % (_read_launches(), expected))
        if len(files) != (tag != "untraced"):
            raise AssertionError("trace (%s): %d trace files"
                                 % (tag, len(files)))
        if tag == "untraced":
            continue
        kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
        found = {name: sum(k in n for n in kernels) for k, name in (
            ("sqdist_kernel", "sqdist"),
            ("masked_system_kernel", "masked_system"),
            ("rbf_bwd_kernel", "rbf_bwd_reductions"),
            ("interp_adjoint_kernel", "interp_adjoint"))}
        log("[trace] flagship, %d steps and predict, %s: %.3f s in "
            "utils.profiling.trace (%.3f s untraced); the trace (%.1f MB) "
            "holds %d CUDA kernel events, of them K1/K2/K3 %s (the run "
            "launched %s)" % (
                PROFILE_STEPS, tag, walls[tag], walls["untraced"],
                size / 1e6, len(kernels), found, expected))
        if found != expected:
            raise AssertionError("trace (%s): kernel events %s, the run "
                                 "launched %s" % (tag, found, expected))
    return walls


# ---------------------------------------------------------------------------
# phase parallel: mesh= on a one-rank NCCL world, and two ranks on the card
# ---------------------------------------------------------------------------

# A sharded run on a one-rank world runs the same operations as its
# unsharded twin (every collective over one rank is a copy), so float32
# results are held to 1e-6, every row alike (the off-lattice row's W^T is
# K4, which sums in a fixed order).
PARALLEL_RTOL = 1e-6
# Two ranks on one card: eels64's channels split 32 + 32 over 'task' (each
# channel's arithmetic is the same launch shape per task, so its results
# are expected bit for bit; the loss is a sum in another order), held to
# MULTI_CROSS_TOL and EELS64_BIT_EQUAL; the VFE's rows split 15424 + 15424 over 'grid' (B's row
# sums in another order, amplified by 400 float32 Adam steps, as between
# float32 and float64), held to VFE_CROSS_TOL and its rmse gate; the
# masked-lattice ski_masked64x64x32 in blocks of its first grid axis (32 +
# 32 of 64: the CG state, two all-to-alls in every mode product,
# all-reduced inner products), held to MGRID_CROSS_TOL and its rmse gate;
# both of these also to PARALLEL_LOSS0_RTOL.
# The step-0 loss of the VFE and masked rows on two ranks: the same
# parameters, only the order of the sums differs, so it is held to
# VFE_CROSS_TOL's step-0 limit (measured on an H100: 2.09e-7 and 0).
PARALLEL_LOSS0_RTOL = 1e-6
# eels64's channels on two ranks whose one-rank values they must equal bit
# for bit (all 64 did on an H100); its predictive sd is not among them (the
# variance's batched solves run 32 channels a call, and 0 of 64 channels
# were bit-equal, 2.5e-7 apart), so sd is held to MULTI_CROSS_TOL.
EELS64_BIT_EQUAL = ("mean", "hp_lengthscale", "hp_noise", "hp_outputscale")
PARALLEL_DIR = os.path.join(_HERE, "build", "chip_smoke", "parallel")
PARALLEL_ROWS = ("flagship", "bepfm3d_vfe", "eels6_correlated", "ckpfm4d",
                 "ski_masked64x64x32", "ski_offlattice64x64x32",
                 "bo25_ei_explore")


def _max_gaps(a, b):
    """Largest absolute and relative gap over every array of two result
    dicts (NaN in both places counts as equal)."""
    out = {}
    for k in a:
        x, y = np.asarray(a[k], float), np.asarray(b[k], float)
        same = np.isnan(x) & np.isnan(y)
        d = np.where(same, 0.0, np.abs(x - y))
        rel = d / np.maximum(np.abs(y), 1e-30)
        out[k] = (float(np.nanmax(d)) if d.size else 0.0,
                  float(np.nanmax(rel)) if d.size else 0.0)
    return out


def _parallel_twin(label, run):
    """Run ``run(mesh) -> result dict`` unsharded and with mesh=True on the
    one-rank world; the results must agree to PARALLEL_RTOL, the launches
    must be equal and the sharded run must have issued NCCL collectives.
    Returns the sharded run's launches and record."""
    from gpim_tpu_torch.parallel import distributed
    _reset_launches()
    t0 = time.perf_counter()
    twin = run(None)
    twin_s = time.perf_counter() - t0
    l_twin = _read_launches()
    distributed.reset_collective_counts()
    _reset_launches()
    t0 = time.perf_counter()
    got = run(True)
    wall = time.perf_counter() - t0
    launches = _read_launches()
    coll = distributed.collective_counts()
    gaps = _max_gaps(got, twin)
    bit_equal = all(g[0] == 0.0 for g in gaps.values())
    log("[parallel] %-22s one-rank NCCL mesh vs unsharded: walls %.3f s vs "
        "%.3f s, launches %s vs %s, %s, collectives %s" % (
            label, wall, twin_s, launches, l_twin,
            "bit-equal" if bit_equal else "largest gaps (abs, rel) %s" % {
                k: "%.2e, %.2e" % g for k, g in gaps.items()},
            json.dumps(coll)))
    for k, (d, rel) in gaps.items():
        if not (rel <= PARALLEL_RTOL or d == 0.0):
            raise AssertionError("%s: mesh=True %s is %.3e (rel %.3e) from "
                                 "its unsharded twin" % (label, k, d, rel))
    if launches != l_twin:
        raise AssertionError("%s: sharded launches %s, unsharded %s"
                             % (label, launches, l_twin))
    if not any(k.endswith("@nccl") and v["calls"] > 0
               for k, v in coll.items()):
        raise AssertionError("%s: the one-rank mesh issued no NCCL "
                             "collective" % label)
    return launches, {"wall_s": wall, "twin_wall_s": twin_s,
                      "bit_equal": bit_equal, "collectives": coll,
                      "gaps": gaps}


def _result(mean, sd, hp, losses):
    out = {"mean": mean, "sd": sd, "losses": losses}
    out.update({"hp_" + k: np.asarray(v) for k, v in hp.items()
                if np.size(v)})
    return out


def _parallel_one_rank(R, X, X_full, vfe, eels6, ckpfm):
    """Phase (a): every public name with mesh=True on a one-rank NCCL
    world against its unsharded twin."""
    from gpim_tpu_torch import (boptimizer, reconstructor, skreconstructor,
                                utils, vreconstructor)
    paths, recs = {}, {}

    def flagship(mesh):
        m = reconstructor(X, R, X_full, kernel="RBF", iterations=ITERATIONS,
                          precision="single", verbose=0, mesh=mesh)
        return _result(*m.run(), m.losses)

    def bepfm(mesh):
        m = reconstructor(*vfe[1::-1], vfe[2], precision="single", verbose=0,
                          mesh=mesh, **VFE)
        return _result(*m.run(), m.losses)

    def eels6_corr(mesh):
        m = vreconstructor(*eels6[:3], verbose=0, mesh=mesh,
                           **dict(MULTI, independent=False))
        return _result(*m.run(), m.losses)

    def ckpfm4d(mesh):
        m = skreconstructor(ckpfm[1], ckpfm[0], ckpfm[1], verbose=0,
                            mesh=mesh, **CKPFM)
        return _result(*m.run(), m.losses)

    Rs, truth = ski_masked_data()
    Xs, Xsf = utils.get_sparse_grid(Rs), utils.get_full_grid(Rs)

    def masked64(mesh):
        m = skreconstructor(Xs, Rs, Xsf, verbose=0, mesh=mesh,
                            iterations=MGRID_ROWS["ski_masked64x64x32"][1],
                            **MGRID)
        return _result(*m.run(), m.losses)

    def offlattice64(mesh):
        m = skreconstructor(Xs, Rs, Xsf, verbose=0, mesh=mesh,
                            iterations=OFFLATTICE_ROWS[
                                "ski_offlattice64x64x32"][1], **OFFLATTICE)
        return _result(*m.run(), m.losses)

    grid, Xb, Xbf, _ = bo25_data()

    def bo25(mesh):
        os.makedirs(BO_DIR, exist_ok=True)
        bo = boptimizer(Xb, grid, Xbf, bo25_target, verbose=0, mesh=mesh,
                        filename=os.path.join(BO_DIR, "parallel_bo25"),
                        gp_iterations=BO25_ITERATIONS,
                        **BO25_ROWS["bo25_ei_explore"])
        bo.run()
        m = bo.surrogate_model
        out = _result(*bo.gp_predictions[-1], m.hyperparams, m.losses)
        out["vals_all"] = np.asarray(bo.vals_all, float)
        out["indices_all"] = np.asarray(bo.indices_all, float)
        return out

    runs = {"flagship": flagship, "bepfm3d_vfe": bepfm,
            "eels6_correlated": eels6_corr, "ckpfm4d": ckpfm4d,
            "ski_masked64x64x32": masked64,
            "ski_offlattice64x64x32": offlattice64, "bo25_ei_explore": bo25}
    for label in PARALLEL_ROWS:
        paths["parallel_" + label], recs[label] = _parallel_twin(
            label, runs[label])
    return paths, recs


def _channels_equal(a, b, axis):
    """How many channels (indices along ``axis``) of two arrays are equal
    bit for bit."""
    return int(sum(np.array_equal(np.take(a, t, axis), np.take(b, t, axis))
                   for t in range(a.shape[axis])))


def _card2_spec(vfe, eels64, masked):
    """The inputs and spec of the two-rank world: eels64 task-sharded over
    a (2, 1) mesh, the BEPFM VFE row-sharded and ski_masked64x64x32
    block-sharded over a (2,) mesh, each run twice (cold, warm) in
    float32."""
    from gpim_tpu_torch import utils
    os.makedirs(PARALLEL_DIR, exist_ok=True)
    R, X, X_full, _ = vfe
    Xe, Ye, Xef, _ = eels64
    Rs = masked[0]
    np.savez(os.path.join(PARALLEL_DIR, "inputs.npz"), R=R, X=X,
             X_full=X_full, Xe=Xe, Ye=Ye, Xef=Xef, Rs=Rs,
             Xs=utils.get_sparse_grid(Rs), Xsf=utils.get_full_grid(Rs))
    runs = [{"name": "eels64", "model": "vreconstructor",
             "args": ["Xe", "Ye", "Xef"], "mesh": [2, 1], "repeat": 2,
             "kwargs": dict(MULTI, precision="single")},
            {"name": "bepfm3d_vfe", "model": "reconstructor",
             "args": ["X", "R", "X_full"], "mesh": True, "repeat": 2,
             "kwargs": dict(VFE, precision="single")},
            {"name": "ski_masked64x64x32", "model": "skreconstructor",
             "args": ["Xs", "Rs", "Xsf"], "mesh": True, "repeat": 2,
             "kwargs": dict(MGRID, precision="single", iterations=MGRID_ROWS[
                 "ski_masked64x64x32"][1])}]
    path = os.path.join(PARALLEL_DIR, "spec.json")
    with open(path, "w") as f:
        json.dump({"arrays": "inputs.npz", "runs": runs}, f)
    return path


def _parallel_two_ranks(vfe, eels64):
    """Phase (b): two ranks sharing the card over gloo, through
    ``python -m gpim_tpu_torch.parallel.mp_worker``, against one-rank
    (unsharded) runs of the same rows in this process."""
    from gpim_tpu_torch import (reconstructor, skreconstructor, utils,
                                vreconstructor)
    from gpim_tpu_torch.parallel import distributed
    masked = ski_masked_data()
    spec = _card2_spec(vfe, eels64, masked)
    t0 = time.perf_counter()
    distributed.launch_workers(
        [(["spec", "--spec", spec, "--device", "cuda", "--backend", "gloo"],
          2, PARALLEL_DIR, "card2")], timeout=600)
    world_s = time.perf_counter() - t0
    log("[parallel] two-rank world (gloo, one card): %.1f s from spawn to "
        "exit" % world_s)
    paths, recs = {}, {}
    one = {}
    m = vreconstructor(*eels64[:3], verbose=0, **MULTI)
    _reset_launches()
    one["eels64"] = _result(*m.run(), m.losses)
    one_l = {"eels64": _read_launches()}
    m = reconstructor(*vfe[1::-1], vfe[2], precision="single", verbose=0,
                      **VFE)
    _reset_launches()
    one["bepfm3d_vfe"] = _result(*m.run(), m.losses)
    one_l["bepfm3d_vfe"] = _read_launches()
    Rs, truth_s = masked
    m = skreconstructor(utils.get_sparse_grid(Rs), Rs,
                        utils.get_full_grid(Rs), verbose=0,
                        iterations=MGRID_ROWS["ski_masked64x64x32"][1],
                        **MGRID)
    _reset_launches()
    one["ski_masked64x64x32"] = _result(*m.run(), m.losses)
    one_l["ski_masked64x64x32"] = _read_launches()
    for name, tol in (("eels64", MULTI_CROSS_TOL),
                      ("bepfm3d_vfe", VFE_CROSS_TOL),
                      ("ski_masked64x64x32", MGRID_CROSS_TOL)):
        res, cnt = [], []
        for r in range(2):
            res.append(dict(np.load(os.path.join(
                PARALLEL_DIR, "%s_r%d.npz" % (name, r)))))
            with open(os.path.join(PARALLEL_DIR,
                                   "%s_r%d.json" % (name, r))) as f:
                cnt.append(json.load(f))
        for k in res[0]:
            if not np.array_equal(res[0][k], res[1][k], equal_nan=True):
                raise AssertionError("%s: ranks differ in %s" % (name, k))
        ref = one[name]
        gaps = _max_gaps(res[0], ref)
        mean, sd = res[0]["mean"], res[0]["sd"]
        ls, ls1 = res[0]["hp_lengthscale"][-1], ref["hp_lengthscale"][-1]
        n2, n1 = res[0]["hp_noise"][-1], ref["hp_noise"][-1]
        diffs = {"mean_atol": gaps["mean"][0], "sd_atol": gaps["sd"][0],
                 "ls_rtol": float(np.max(np.abs(ls - ls1) / np.abs(ls1))),
                 "noise_rtol": float(np.max(np.abs(n2 - n1)
                                            / np.abs(n1)))}
        limits = dict(tol)
        if name != "eels64":
            diffs["loss0_rtol"] = float(
                abs(res[0]["losses"][0] - ref["losses"][0])
                / abs(ref["losses"][0]))
            limits["loss0_rtol"] = PARALLEL_LOSS0_RTOL
        if name == "eels64":
            Y, fields = eels64[1], eels64[3]
            obs = ~np.isnan(Y)
            rmse = float(np.sqrt(np.mean((mean[obs] - fields[obs]) ** 2)))
            gate = 0.5 * float(np.nanstd(Y))
            per_task = {k: _channels_equal(res[0][k], ref[k],
                                           -1 if k in ("mean", "sd") else 1)
                        for k in ("mean", "sd", "hp_lengthscale",
                                  "hp_noise", "hp_outputscale")}
            extra = ("channels bit-equal to one rank's, of %d: %s; loss "
                     "series rel gap %.2e" % (
                         mean.shape[-1], json.dumps(per_task),
                         gaps["losses"][1]))
        elif name == "bepfm3d_vfe":
            truth = vfe[3]
            tnorm = (truth - truth.min()) / np.ptp(truth)
            rmse = float(np.sqrt(np.mean(
                ((mean - truth.min()) / np.ptp(truth) - tnorm) ** 2)))
            gate = 0.1
            per_task = None
            extra = "the step-0 loss in the gaps"
        else:
            # the suite's sanity gate of the masked row (phase mgrid)
            rmse = float(np.sqrt(np.mean((mean - truth_s) ** 2)))
            gate = 0.75 * float(np.nanstd(Rs))
            per_task = None
            extra = "the step-0 loss in the gaps"
        rec = {"wall_s": [c["wall_s"] for c in cnt],
               "one_rank_launches": one_l[name],
               "launches": [c["launches"] for c in cnt],
               "calls": [c["calls"] for c in cnt],
               "collectives": [c["collectives"] for c in cnt],
               "gaps": diffs, "rmse": rmse, "gate": gate,
               "bit_equal_tasks": per_task}
        recs[name] = rec
        for r in range(2):
            paths["parallel2_%s_r%d" % (name, r)] = cnt[r]["launches"]
            log("[parallel] %-12s rank %d: walls %s s (cold, warm), "
                "launches %s, kernel calls %s, collectives %s" % (
                    name, r, ["%.3f" % w for w in cnt[r]["wall_s"]],
                    cnt[r]["launches"], json.dumps(cnt[r]["calls"]),
                    json.dumps(cnt[r]["collectives"])))
        log("[parallel] %-12s 2 ranks vs one rank: %s (limits %s); %s; "
            "rmse %.5f (gate < %.5f); one-rank launches %s" % (
                name, json.dumps(diffs), json.dumps(
                    {k: limits[k] for k in diffs}), extra, rmse, gate,
                one_l[name]))
        if not rmse < gate:
            raise AssertionError("%s on two ranks: rmse %.4f >= %.4f"
                                 % (name, rmse, gate))
        for k, d in diffs.items():
            if not d <= limits[k]:
                raise AssertionError("%s: 2 ranks vs one rank %s %.3e > "
                                     "%.0e" % (name, k, d, limits[k]))
        if per_task is not None:
            T = mean.shape[-1]
            short = {k: per_task[k] for k in EELS64_BIT_EQUAL
                     if per_task[k] != T}
            if short:
                raise AssertionError(
                    "eels64 on two ranks: channels bit-equal to one rank's "
                    "only %s of %d" % (short, T))
        if not all(k.endswith("@gloo") for c in cnt
                   for k in c["collectives"]):
            raise AssertionError("%s: a collective left gloo" % name)
    _check_card2_shares(recs, vfe, eels64)
    for r, c in enumerate(recs["ski_masked64x64x32"]["collectives"]):
        if not c.get("all_to_all@gloo", {}).get("calls"):
            raise AssertionError("the masked row's rank %d issued no "
                                 "all-to-all: its mode products were not "
                                 "sharded" % r)
    return paths, recs


def _check_card2_shares(recs, vfe, eels64):
    """Each rank launched its kernels on its share only: eels64's K2/K3 on
    32 of the 64 channels, the VFE's Kmn on half of the padded rows."""
    T = eels64[1].shape[-1]
    for r, calls in enumerate(recs["eels64"]["calls"]):
        lead = {k.split()[1].split("x")[0] for k in calls}
        if lead != {str(T // 2)}:
            raise AssertionError("eels64 rank %d called kernels at %s, not "
                                 "on %d channels" % (r, calls, T // 2))
    n_pad = -(-int((~np.isnan(vfe[0])).sum()) // 128) * 128
    for r, calls in enumerate(recs["bepfm3d_vfe"]["calls"]):
        rows = [k for k in calls if k.startswith("sqdist")
                and "x%dx" % n_pad in k]
        half = [k for k in calls if k.startswith("sqdist")
                and "x%dx" % (n_pad // 2) in k]
        if rows or not half:
            raise AssertionError("VFE rank %d called K1 at %s, expected its "
                                 "%d of %d rows" % (r, calls, n_pad // 2,
                                                    n_pad))


def phase_parallel(R, X, X_full, vfe, eels6, eels64, ckpfm):
    """mesh= on every public name in a one-rank NCCL world against the
    unsharded twins, then two ranks sharing the card over gloo at full
    width. Returns (launches by path, records)."""
    import socket
    import torch.distributed as dist
    from gpim_tpu_torch.parallel import distributed
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    distributed.initialize("tcp://127.0.0.1:%d" % port, 1, 0,
                           backend="nccl")
    try:
        paths, recs = _parallel_one_rank(R, X, X_full, vfe, eels6, ckpfm)
    finally:
        dist.destroy_process_group()
    p2, r2 = _parallel_two_ranks(vfe, eels64)
    paths.update(p2)
    recs.update(r2)
    with open(os.path.join(PARALLEL_DIR, "records.json"), "w") as f:
        json.dump(recs, f, indent=1, default=str)
    return paths, recs


def kernel_records(kreport, paths):
    """The kernels line; ``paths`` maps each main path to its warm run's
    launch counts, and ``launches`` is their sum."""
    replaces = {"sqdist": "gpim_tpu/ops/pallas_gram.py:77",
                "masked_system": "gpim_tpu/ops/pallas_gram.py:186",
                "rbf_bwd_reductions": "gpim_tpu/ops/pallas_gram.py:283",
                # no Pallas counterpart: the port's index_add_ of W^T,
                # whose gpim_tpu counterpart is ski_mvm's sorted XLA scatter
                "interp_adjoint": "gpim_tpu/ops/ski.py:275"}
    library = {"sqdist": "torch.cdist, the nearest call: it returns the "
                         "root of this kernel's output",
               "interp_adjoint": "index_add_ of the weighted corner rows, "
                                 "the call this kernel replaced"}
    out = []
    for name in KERNELS:
        r = kreport[name]
        bound_ms, bound_by = r["bound"]
        out.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": replaces[name],
            "launches": sum(p[name] for p in paths.values()),
            "launches_per_path": {k: p[name] for k, p in paths.items()},
            "max_abs_err": r["err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_share": bound_ms / r["ms"],
            "library_ms": r["library_ms"],
            "library": library.get(name),
        })
        if name == "interp_adjoint":
            out[-1]["graph_ms"] = r["graph_ms"]
            out[-1]["ski_shapes"] = {
                row: {k: {
                    "shape": v["shape"], "kernel": v["kernel"],
                    "max_abs_err": v["err"],
                    "bit_equal_cpu": v.get("bit_equal_cpu"),
                    "ms": v["ms"], "graph_ms": v["graph_ms"],
                    "plain_ms": v["plain_ms"], "library_ms": v["library_ms"],
                    "bound_ms": v["bound"][0], "bound_by": v["bound"][1],
                    "bound_share": v["bound"][0] / v["ms"],
                    **({"operator": v["operator"]} if "operator" in v
                       else {})}
                    for k, v in recs.items()}
                for row, recs in r["ski_shapes"].items()}
            continue
        out[-1]["batched_shapes"] = {
            label: {"shape": v["shape"], "max_abs_err": v["err"],
                    "ms": v["ms"], "plain_ms": v["plain_ms"],
                    "bound_ms": v["bound"][0], "bound_by": v["bound"][1],
                    "bound_share": v["bound"][0] / v["ms"],
                    "library_ms": v["library_ms"]}
            for label, v in r["batched_shapes"].items()}
        for key in ("bo_shapes", "quickstart_shapes"):
            out[-1][key] = {
                label: {"shape": v["shape"], "max_abs_err": v["err"]}
                for label, v in r[key].items()}
        if name == "sqdist":
            for key in ("vfe_shapes", "kron_shapes", "mgrid_shapes",
                        "ski_shapes", "parallel_shapes"):
                out[-1][key] = {
                    label: {"shape": v["shape"], "max_abs_err": v["err"],
                            "ms": v["ms"], "plain_ms": v["plain_ms"],
                            "bound_ms": v["bound"][0],
                            "bound_by": v["bound"][1],
                            "bound_share": v["bound"][0] / v["ms"],
                            "library_ms": v["library_ms"]}
                    for label, v in r[key].items()}
    return out


def main():
    import torch
    phase_device()
    phase_build()
    R, X, X_full = flagship_data()
    vfe = vfe_data()
    eels6, eels64 = eels6_data(), eels64_data()
    ckpfm = ckpfm_data()
    kreport = phase_kernels(R, X, X_full, vfe, eels64, ckpfm)
    launches, f32 = phase_flagship(R, X, X_full)
    vfe_launches, vfe32 = phase_vfe(vfe)
    phase_cross_check(R, X, X_full, f32, vfe, vfe32)
    bo_paths, bo25, spiral_bo = phase_bo(R, X, X_full)
    multi_paths = phase_multi(eels6, eels64)
    sk_paths = phase_sk(R, X, X_full, ckpfm)
    mgrid_paths, model_1m, mgrid64_rmse = phase_mgrid()
    ski_paths, model_ski = phase_ski(mgrid64_rmse)
    par_paths, _ = phase_parallel(R, X, X_full, vfe, eels6, eels64, ckpfm)
    phase_profile("flagship", R, X, X_full, kernel="RBF")
    phase_profile("vfe", *vfe[:3], **VFE)
    phase_multi_profile(eels6, eels64)
    phase_sk_profile(R, X, X_full, ckpfm)
    phase_mgrid_profile(model_1m)
    phase_ski_profile(model_ski)
    phase_bo_profile("bo25_ei_explore", bo25)
    phase_bo_profile("spiral_bo", spiral_bo)
    del model_1m, model_ski, bo25, spiral_bo
    torch.cuda.empty_cache()
    ex_paths = phase_examples()
    nb_paths = phase_notebooks()
    phase_trace(R, X, X_full)
    print(json.dumps({"kernels": kernel_records(
        kreport, {"flagship": launches, "vfe": vfe_launches, **bo_paths,
                  **multi_paths, **sk_paths, **mgrid_paths,
                  **ski_paths, **ex_paths, **nb_paths, **par_paths})}),
        flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
