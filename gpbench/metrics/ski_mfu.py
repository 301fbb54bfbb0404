"""ski_mfu: the masked-lattice reconstruction's share of the H100 SXM's
peak in the job's precision, 67 TFLOP/s (float32 outside the tensor cores:
the program runs no TF32; the same figure as ``exact_mfu``).

A job's operations, counted from the program's shapes (this frozen copy of
what ``gpim_tpu_torch.ops.ski`` runs; a test holds it to the program's own
operations, counted by ``torch.utils.flop_counter`` on a small lattice):

- each realized CG iteration of a training solve applies the masked
  operator (d mode products) and P^-1/2 twice (each Q^T and Q: d mode
  products between the grid and its pruned modes and an r x r gemm) to all
  p + 1 right-hand sides;
- each Adam step adds P^-1/2 of the right-hand side, of the solutions and of
  the probes, the factors' distances, and the surrogate's backward: the
  operator on p + 1 rows forward, its factors' gradients and the inputs'
  gradients of the later modes;
- each training segment's preconditioner build: the factors' eigenpairs
  (9 g^3 each), the Nystrom core over the observed rows (2 n r^2) and its
  eigenpairs (9 r^3);
- the prediction: the build with uncapped modes, its CG iterations on one
  right-hand side, the mean (d mode products), and the Nystrom variance
  (the tables' products, the rows and their r x r gemm over every cell).

All jobs' operations over the sum of their clocks (jobs outside the traced
one), with the realized CG iterations and segments that the engine
counts."""

import math

PEAK_OPS_PER_S = {4: 67e12, 8: 67e12}


def pruned(grid, rank, capped):
    """Each axis's candidate modes: min(g_k, rank, cap), cap = max(16,
    ceil(4 rank^(1/d))) for the training preconditioner, none at
    prediction."""
    cap = (max(16, int(math.ceil(4.0 * rank ** (1.0 / len(grid)))))
           if capped else rank)
    return [min(g, rank, cap) for g in grid]


def mvm_ops(grid, b):
    """The masked operator on b rows: d mode products."""
    return 2.0 * b * math.prod(grid) * sum(grid)


def root_ops(grid, modes, rank, b):
    """P^-1/2 on b rows: Q^T (mode products from the grid down to the
    pruned modes, then the r x r rotation) and Q (back up)."""
    d = len(grid)
    down = sum(math.prod(modes[:k + 1]) * math.prod(grid[k:])
               for k in range(d))
    up = sum(math.prod(grid[:k + 1]) * math.prod(modes[k:])
             for k in range(d))
    return 2.0 * b * (down + up + 2 * rank * rank)


def iteration_ops(grid, modes, rank, b):
    """One CG iteration of the split operator on b rows."""
    return mvm_ops(grid, b) + 2.0 * root_ops(grid, modes, rank, b)


def distance_ops(grid):
    """The factors' squared distances (one (g, 1) x (1, g) product each)."""
    return 2.0 * sum(g * g for g in grid)


def step_ops(grid, rank, p, iters):
    """One Adam step with ``iters`` CG iterations, forward and backward."""
    b, modes = p + 1, pruned(grid, rank, True)
    return (iters * iteration_ops(grid, modes, rank, b)
            + root_ops(grid, modes, rank, 1 + b + p)
            + 2.0 * mvm_ops(grid, b)
            + 2.0 * b * math.prod(grid) * sum(grid[1:])
            + 3.0 * distance_ops(grid))


def build_ops(grid, rank, n_obs):
    """One preconditioner build."""
    return (distance_ops(grid) + 9.0 * sum(g ** 3 for g in grid)
            + 2.0 * n_obs * rank * rank + 9.0 * rank ** 3)


def predict_ops(grid, rank, n_obs, iters):
    """The prediction over every cell of the lattice."""
    G, modes = math.prod(grid), pruned(grid, rank, False)
    return (build_ops(grid, rank, n_obs)
            + iters * iteration_ops(grid, modes, rank, 1)
            + 2.0 * root_ops(grid, modes, rank, 1)
            + distance_ops(grid) + mvm_ops(grid, 1)
            + 2.0 * rank * sum(g * g for g in grid)
            + 2.0 * G * rank * rank)


def operations(job):
    grid, rank, p = job["grid"], job["rank"], job["probes"]
    cg, steps = job["cg_iters"], job["steps"]
    return (steps * step_ops(grid, rank, p, 0)
            + cg * iteration_ops(grid, pruned(grid, rank, True), rank, p + 1)
            + len(job["train_segments"]) * build_ops(grid, rank, job["n_obs"])
            + predict_ops(grid, rank, job["n_obs"], job["predict_cg_iters"]))


def read(run):
    jobs = [j for j in run.plain_jobs if "cg_iters" in j]
    if not jobs:
        return None
    ops = sum(operations(j) for j in jobs)
    peak = sum(j["clock_s"] * PEAK_OPS_PER_S[j["itemsize"]] for j in jobs)
    return 100.0 * ops / peak
