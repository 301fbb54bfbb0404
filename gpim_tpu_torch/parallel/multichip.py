"""
Multi-rank training and prediction of the independent multi-output GP (the
EELS "parallel GP") over a ('task', 'grid') mesh (counterpart of
``gpim_tpu/parallel/multichip.py``).

- 'task': the channels are independent, so each rank trains its
  ``T / task`` of them (K2 and K3 on its slice of the task axis) and no
  gradient crosses ranks; the recorded loss is the all-reduced sum, which
  is ``gpim_tpu``'s psum, and the trajectories and parameters are gathered.
- 'grid': the rows of each prediction tile shard across ranks; each rank
  solves its rows of its channels against the replicated factorization,
  then rows and channels are gathered.

A single GP's Cholesky stays rank-local ("shard the batch, replicate the
solver").
"""

import numpy as np
import torch

from gpim_tpu_torch.gpreg import engine, multi
from gpim_tpu_torch.parallel import distributed
from gpim_tpu_torch.parallel.mesh import (
    _check_count, axis_group, axis_rank, axis_size, build_mesh, predict_rows,
    replicate)

__all__ = ["make_mesh_2d", "squarest_split", "task_slice", "shard_multitask",
           "train_step_sharded", "predict_sharded",
           "assert_partitioned_predict", "dryrun"]


def make_mesh_2d(n_devices=None, task_axis=None):
    """A ('task', 'grid') mesh over the ranks of the world (``n_devices``,
    when given, must equal the world size). ``task_axis`` ranks shard the
    channels and the rest the prediction rows; by default the squarest
    split, task-major (``gpim_tpu``'s rule: 2 ranks give (1, 2), 4 give
    (2, 2), 8 give (2, 4))."""
    n = _check_count(n_devices)
    if task_axis is None:
        task_axis = squarest_split(n)[0]
    if n % task_axis:
        raise ValueError("task_axis %d does not divide %d ranks"
                         % (task_axis, n))
    return build_mesh((task_axis, n // task_axis), ("task", "grid"))


def squarest_split(n):
    """(task, grid) for ``n`` ranks: the largest divisor of n not above
    sqrt(n) shards the tasks, the rest the rows."""
    for t in range(int(np.sqrt(n)), 0, -1):
        if n % t == 0:
            return t, n // t
    return 1, n


def task_slice(num_tasks, mesh):
    """The channels this rank owns on the mesh's 'task' axis."""
    per = num_tasks // axis_size(mesh, "task")
    r = axis_rank(mesh, "task")
    return slice(r * per, (r + 1) * per)


def shard_multitask(u, X, Y, mask, mesh):
    """This rank's share of the independent multi-output training state:
    per-task parameters and target columns on its 'task' slice (made
    contiguous once, as the kernels need), inputs and mask whole."""
    s = task_slice(Y.shape[1], mesh)
    return ({k: v[s].contiguous() for k, v in u.items()}, X,
            Y[:, s].contiguous(), mask)


def train_step_sharded(u, X, Y, mask, bounds, lr, jitter, mesh, *, kernel,
                       iterations):
    """Task-sharded joint training from the full parameters ``u`` and
    targets ``Y`` (n, T) every rank holds: each rank trains its channels,
    the loss series is summed over 'task' and the parameters and
    trajectories are gathered. Returns (full u, full trajectory), the same
    on every rank."""
    group = axis_group(mesh, "task")
    u_l, X, Y_l, mask = shard_multitask(u, X, Y, mask, mesh)
    u_l, traj = multi.train_independent(u_l, X, Y_l, mask, bounds, lr,
                                        jitter, kernel=kernel,
                                        iterations=iterations)
    u = {k: distributed.all_gather(v, group, dim=0) for k, v in u_l.items()}
    out = {k: distributed.all_gather(v, group, dim=1)
           for k, v in traj.items() if k != "loss"}
    out["loss"] = distributed.all_reduce(traj["loss"], group)
    return u, out


def predict_sharded(u, X, Y, mask, bounds, jitter, chunks, mesh, *,
                    kernel):
    """Prediction over the tiles ``chunks`` (n_chunks, chunk, d): each rank
    computes its channels on its rows of every tile (replicated rows, with
    a warning, when the chunk size does not divide 'grid'), then rows and
    channels are gathered. Returns mean and var (n_chunks * chunk, T) on
    every rank."""
    u_l, X, Y_l, mask = shard_multitask(u, X, Y, mask, mesh)
    mean, var = predict_rows(
        lambda tiles: multi.predict_independent(
            u_l, X, Y_l, mask, bounds, jitter, tiles, kernel=kernel),
        chunks, mesh)
    both = distributed.all_gather(torch.stack([mean, var]),
                                  axis_group(mesh, "task"), dim=2)
    return both[0], both[1]


def _toy_problem(mesh, dtype, device):
    """The dryrun's problem: two channels a 'task' rank, 64 points in 2D."""
    from gpim_tpu_torch.kernels.transforms import positive_inverse
    T = 2 * axis_size(mesh, "task")
    n, d = 64, 2
    rng = np.random.RandomState(0)
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)  # noqa
    one = positive_inverse(t(1.0))
    u = {"lengthscale": t(np.zeros((T, d))),
         "outputscale": one.expand(T).clone(),
         "noise": one.expand(T).clone(), "mean": t(np.zeros(T))}
    bounds = {"ls_lo": t(np.zeros(d)), "ls_hi": t(np.full(d, 4.0))}
    return (u, t(rng.rand(n, d)), t(rng.rand(n, T)), t(np.ones(n)), bounds,
            rng.rand(96, d))


def _device(device):
    """``device``, or this rank's card when it is None (raises without
    one: the CPU is taken only when asked for)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def assert_partitioned_predict(mesh, chunk=32, dtype=torch.float64,
                               device=None):
    """Partition-regression probe: run the sharded multi-output predict and
    one training step and check from the kernel and collective counters
    that the work was partitioned, not silently replicated:

    - each rank's K1 launches cover only its channels and rows (the Gram's
      and every tile's leading axis is its ``T / task`` channels, each
      tile's rows ``chunk / grid``), and its K2 launch only its channels;
    - the prediction issued an all-gather;
    - a task-sharded loss (``task > 1``) issued an all-reduce.

    Runs on this rank's card unless ``device`` says otherwise. Raises
    AssertionError on a regression, returns True otherwise."""
    from gpim_tpu_torch.ops import gram_kernels
    device = _device(device)
    u, X, Y, mask, bounds, Xt = _toy_problem(mesh, dtype, device)
    T, task = Y.shape[1], axis_size(mesh, "task")
    grid = axis_size(mesh, "grid")
    chunks, _ = engine.chunk_rows(Xt, chunk)
    chunks = torch.as_tensor(chunks, dtype=dtype, device=device)
    with gram_kernels.log_calls() as calls:
        distributed.reset_collective_counts()
        predict_sharded(u, X, Y, mask, bounds, 1e-4, chunks, mesh,
                        kernel="RBF")
        pred = distributed.collective_counts()
        distributed.reset_collective_counts()
        train_step_sharded(u, X, Y, mask, bounds, 0.05, 1e-4, mesh,
                           kernel="RBF", iterations=1)
        train = distributed.collective_counts()
    n, d = X.shape
    rows = chunk // grid if chunk % grid == 0 else chunk
    want = {("sqdist", (T // task, n, n, d)),
            ("sqdist", (T // task, rows, n, d)),
            ("masked_system", (T // task, n, d)),
            ("rbf_bwd_reductions", (T // task, n, d))}
    got = {(name, shape) for name, _, shape in calls}
    if got != want:
        raise AssertionError("sharded multi-output run called the kernels "
                             "at %s, expected this rank's share %s"
                             % (sorted(got), sorted(want)))
    if axis_group(mesh, "grid") is not None and not any(
            k.startswith("all_gather") for k in pred):
        raise AssertionError("sharded predict issued no all-gather: %s"
                             % pred)
    if task > 1 and not any(k.startswith("all_reduce") for k in train):
        raise AssertionError("task-sharded training lost its cross-rank "
                             "loss reduction: %s" % train)
    return True


def dryrun(n_devices=None, dtype=torch.float64, device=None):
    """Run the task-sharded training step (2 iterations) and the
    row-sharded prediction on the world's ('task', 'grid') mesh at tiny
    shapes, with :func:`assert_partitioned_predict`, on this rank's card
    unless ``device`` says otherwise. Returns (loss, mean) as numpy, the
    same on every rank."""
    device = _device(device)
    mesh = make_mesh_2d(n_devices)
    u, X, Y, mask, bounds, Xt = _toy_problem(mesh, dtype, device)
    u = replicate(u, mesh)
    u_next, traj = train_step_sharded(u, X, Y, mask, bounds, 0.05, 1e-4,
                                      mesh, kernel="RBF", iterations=2)
    chunks, n_test = engine.chunk_rows(Xt, 32)
    mean, _ = predict_sharded(
        u_next, X, Y, mask, bounds, 1e-4,
        torch.as_tensor(chunks, dtype=dtype, device=device), mesh,
        kernel="RBF")
    loss = distributed.fetch(traj["loss"])
    mean = distributed.fetch(mean)[:n_test]
    assert np.isfinite(loss).all(), loss
    assert np.isfinite(mean).all()
    assert_partitioned_predict(mesh, dtype=dtype, device=device)
    return loss, mean
