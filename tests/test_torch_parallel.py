"""
The parallel layer of gpim_tpu_torch (``gpim_tpu_torch.parallel`` and
``mesh=`` on the public models) on the CPU over gloo.

One world of two processes (``python -m gpim_tpu_torch.parallel.mp_worker
spec``) runs every sharded scenario once in float64 on small data, one
process runs the same scenarios unsharded in the port, and this process
runs them through ``gpim_tpu`` with ``mesh=2`` on the conftest's virtual
CPU devices, all at once. Each
sharded result must equal the port's unsharded one to rtol 1e-9 (sharding
is a layout, not a change to the math), ``gpim_tpu``'s to rtol 1e-6, and
the two ranks must agree exactly.
"""

import json
import os
import threading
import warnings

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose, assert_array_equal


import gpim_tpu
from gpim_tpu.parallel import multichip as jmultichip
from gpim_tpu.utils import gridutils

import gpim_tpu_torch
from gpim_tpu_torch.parallel import distributed, mesh as meshmod, multichip

PORT_RTOL = 1e-9           # sharded vs the port's unsharded run, float64
JAX_RTOL = 1e-6            # sharded vs gpim_tpu's mesh=2 run, float64
GRAD_RTOL = 1e-10          # row-sharded VFE gradients vs one process
ATOL = 1e-12


def _toy_recon_data(n=14, missing=60, seed=3):
    """tests/test_parallel.py's 14x14 bump with 60 pixels missing."""
    rng = np.random.RandomState(seed)
    xx, yy = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    R = np.exp(-((xx - n / 2) ** 2 + (yy - n / 2) ** 2) / n).astype(float)
    Rn = R.copy()
    Rn.ravel()[rng.choice(n * n, missing, replace=False)] = np.nan
    return gridutils.get_sparse_grid(Rn), Rn, gridutils.get_full_grid(Rn)


def _vector_data(T=4):
    """tests/test_parallel.py's 12x12 four-channel field, 30% missing."""
    rng = np.random.RandomState(0)
    base = np.add.outer(np.sin(np.arange(12) / 3.0),
                        np.cos(np.arange(12) / 4.0))
    Y = np.stack([base * (1 + 0.2 * t) + 0.05 * rng.randn(12, 12)
                  for t in range(T)], -1)
    Y[rng.rand(12, 12) < 0.3] = np.nan
    X = gridutils.get_full_grid(Y[..., 0]).copy()
    X[:, np.isnan(Y[..., 0])] = np.nan
    return X, Y, gridutils.get_full_grid(Y[..., 0])


def _bo_target(idx):
    return float(np.exp(-((idx[0] - 5.) ** 2 + (idx[1] - 5.) ** 2) / 8))


def _arrays():
    X, Rn, Xf = _toy_recon_data()
    Xv, Yv, Xvf = _vector_data()
    Rk = np.add.outer(np.sin(np.arange(12) / 3.), np.cos(np.arange(12) / 4.))
    Xk = gridutils.get_full_grid(Rk)
    grid = np.full((12, 12), np.nan)
    for i, j in np.random.RandomState(1).randint(0, 12, (5, 2)):
        grid[i, j] = _bo_target((i, j))
    truth = np.array([[_bo_target((i, j)) for j in range(12)]
                      for i in range(12)])
    return {"X": X, "R": Rn, "Xf": Xf, "Xv": Xv, "Yv": Yv, "Xvf": Xvf,
            "Rk": Rk, "Xk": Xk, "Xbo": gridutils.get_sparse_grid(grid),
            "Rbo": grid, "Xbof": gridutils.get_full_grid(grid),
            "truth": truth}


_F64 = {"precision": "double"}
# name -> (model, positional arrays, kwargs, sharded mesh, action)
SCENARIOS = {
    "exact": ("reconstructor", ["X", "R", "Xf"],
              dict(kernel="RBF", iterations=8, **_F64), True, "run"),
    "vfe": ("reconstructor", ["X", "R", "Xf"],
            dict(kernel="RBF", iterations=8, sparse=True, indpoints=20,
                 **_F64), True, "run"),
    "vfe_matern": ("reconstructor", ["X", "R", "Xf"],
                   dict(kernel="Matern52", iterations=1, sparse=True,
                        indpoints=20, **_F64), True, "vfe_grad"),
    "vgpr_task": ("vreconstructor", ["Xv", "Yv", "Xvf"],
                  dict(kernel="RBF", independent=True, iterations=10,
                       **_F64), [2, 1], "run"),
    "vgpr_grid": ("vreconstructor", ["Xv", "Yv", "Xvf"],
                  dict(kernel="RBF", independent=True, iterations=10,
                       **_F64), True, "run"),
    "vgpr_corr": ("vreconstructor", ["Xv", "Yv", "Xvf"],
                  dict(kernel="RBF", independent=False, iterations=10,
                       task_rank=2, **_F64), [2, 1], "run"),
    "sk_dense": ("skreconstructor", ["X", "R", "Xf"],
                 dict(iterations=5, ski=False, **_F64), True, "run"),
    "sk_kron": ("skreconstructor", ["Xk", "Rk", "Xk"],
                dict(iterations=5, ski=True, ski_min_points=1, **_F64),
                True, "run"),
    "sk_masked": ("skreconstructor", ["X", "R", "Xf"],
                  dict(kernel="RBF", iterations=5, ski=True,
                       ski_min_points=1, **_F64), True, "run"),
    # precond_rank=0: unpreconditioned CG, the training alone (the masked
    # route's predict at rank 0 fails in gpim_tpu and unsharded alike)
    "sk_masked_rank0": ("skreconstructor", ["X", "R", "Xf"],
                        dict(kernel="RBF", iterations=5, ski=True,
                             ski_min_points=1, precond_rank=0, **_F64),
                        True, "train"),
    "sk_offlattice": ("skreconstructor", ["X", "R", "Xf"],
                      dict(kernel="RBF", iterations=5, ski=True,
                           ski_min_points=1, lattice=False, **_F64),
                      True, "run"),
    "bo": ("boptimizer", ["Xbo", "Rbo", "Xbof"],
           dict(acquisition_function="cb", exploration_steps=2,
                gp_iterations=5, simulate_measurement=True,
                y_true={"array": "truth"}, **_F64), True, "bo"),
}
# the same models through gpim_tpu on two of the virtual CPU devices (the
# gradient scenario is checked against the port's one-process gradients)
JAX_SCENARIOS = [k for k in SCENARIOS if k not in ("vfe_matern",
                                                   "vgpr_grid")]


def _kwargs(kw, arrays):
    return {k: (arrays[v["array"]] if isinstance(v, dict) else v)
            for k, v in kw.items()}


def _collect(model, action):
    """The results a worker writes for ``action``, from a model built in
    this process."""
    if action == "vfe_grad":
        from gpim_tpu_torch.parallel.mp_worker import _vfe_grad
        return _vfe_grad(model)
    if action == "train":
        model.train()
        out = {"losses": np.asarray(model.losses)}
        out.update({"hp_" + k: np.asarray(v)
                    for k, v in model.hyperparams.items()})
        return out
    if action == "bo":
        model.run()
        m = model.surrogate_model
        mean, sd = model.gp_predictions[-1]
        out = {"vals_all": np.asarray(model.vals_all, float),
               "indices_all": np.asarray(model.indices_all),
               "mean": np.asarray(mean), "sd": np.asarray(sd),
               "losses": np.asarray(m.losses)}
        out.update({"hp_" + k: np.asarray(v)
                    for k, v in m.hyperparams.items()})
        return out
    mean, sd, hp = model.run()
    out = {"mean": np.asarray(mean), "sd": np.asarray(sd),
           "losses": np.asarray(model.losses)}
    out.update({"hp_" + k: np.asarray(v) for k, v in hp.items()})
    return out


def _jax_mesh2(name, arrays, tmp):
    model, args, kw, _, action = SCENARIOS[name]
    kw = _kwargs(kw, arrays)
    pos = [arrays[a] for a in args]
    if model == "boptimizer":
        pos.append(None)
        kw["filename"] = os.path.join(tmp, "jax_bo")
    m = getattr(gpim_tpu, model)(*pos, verbose=0, mesh=2, **kw)
    return _collect(m, action)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Every scenario: the two ranks' results and counters, the port's
    unsharded results and gpim_tpu's mesh=2 results."""
    tmp = str(tmp_path_factory.mktemp("world"))
    arrays = _arrays()
    np.savez(os.path.join(tmp, "inputs.npz"), **arrays)
    specs = {}
    for tag, sharded in (("sharded", True), ("unsharded", False)):
        runs = [{"name": n, "model": m, "args": a, "kwargs": kw,
                 "mesh": mesh if sharded else None, "action": act}
                for n, (m, a, kw, mesh, act) in SCENARIOS.items()]
        specs[tag] = os.path.join(tmp, tag + ".json")
        with open(specs[tag], "w") as f:
            json.dump({"arrays": "inputs.npz", "runs": runs}, f)
    failure, dryrun = [], {}

    def background(fn):
        def run():
            try:
                fn()
            except Exception as e:      # re-raised below, in this thread
                failure.append(e)
        thread = threading.Thread(target=run)
        thread.start()
        return thread
    # one thread a worker: five worker processes share the cores with the
    # gpim_tpu runs of this process
    cpu = ["--device", "cpu", "--backend", "gloo"]
    old_threads = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"
    threads = [
        background(lambda: distributed.launch_workers(
            [(["spec", "--spec", specs["sharded"]] + cpu, 2, tmp, "world"),
             (["spec", "--spec", specs["unsharded"]] + cpu, 1,
              os.path.join(tmp, "one"), "one")], timeout=300)),
        background(lambda: dryrun.update(
            distributed.dryrun_multiprocess(timeout=300)))]
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            ref = {n: _jax_mesh2(n, arrays, tmp) for n in JAX_SCENARIOS}
    finally:
        for thread in threads:
            thread.join()
        if old_threads is None:
            del os.environ["OMP_NUM_THREADS"]
        else:
            os.environ["OMP_NUM_THREADS"] = old_threads
    if failure:
        raise failure[0]
    out = {}
    for n in SCENARIOS:
        ranks = [dict(np.load(os.path.join(tmp, "%s_r%d.npz" % (n, r))))
                 for r in range(2)]
        counts = []
        for r in range(2):
            with open(os.path.join(tmp, "%s_r%d.json" % (n, r))) as f:
                counts.append(json.load(f))
        port = dict(np.load(os.path.join(tmp, "one", "%s_r0.npz" % n)))
        out[n] = {"ranks": ranks, "counts": counts, "port": port,
                  "jax": ref.get(n)}
    out["dryrun_multiprocess"] = dryrun
    return out


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_sharded_run_matches_unsharded_and_gpim_tpu(world, name):
    w = world[name]
    r0, r1 = w["ranks"]
    assert sorted(r0) == sorted(w["port"])
    for key in r0:
        assert_array_equal(r1[key], r0[key], err_msg="ranks differ: " + key)
        rtol = GRAD_RTOL if key.startswith("grad_") else PORT_RTOL
        assert_allclose(r0[key], w["port"][key], rtol=rtol, atol=ATOL,
                        err_msg="sharded vs unsharded port: " + key)
        if w["jax"] is not None and key in w["jax"]:
            assert_allclose(r0[key], w["jax"][key], rtol=JAX_RTOL,
                            atol=1e-8, err_msg="port vs gpim_tpu: " + key)


def _ops(counts):
    return {k.split("@")[0]: v["calls"]
            for k, v in counts["collectives"].items()}


def test_collectives_are_the_expected_ones(world):
    """The counter shows what each sharded path must issue (the port's
    counterpart of gpim_tpu's compiled-program checks)."""
    iters = SCENARIOS["vfe"][2]["iterations"]
    # the VFE: one all-reduce forward and one backward a step, one in
    # predict; one all-gather of the predicted rows
    assert _ops(world["vfe"]["counts"][0]) == {
        "all_reduce": 2 * iters + 1, "all_gather": 1}
    # the exact model trains replicated: only the rows' all-gather
    assert _ops(world["exact"]["counts"][0]) == {"all_gather": 1}
    # task-sharded channels: one all-reduce of the loss series, gathers of
    # the 4 parameters, 3 trajectories, the rows and the channels
    assert _ops(world["vgpr_task"]["counts"][0]) == {
        "all_reduce": 1, "all_gather": 9}
    # the correlated mode: Kx/B/noise/Yc's gradient and the loss each
    # step, at's gather each step; the mean and variance's sum in predict
    c = _ops(world["vgpr_corr"]["counts"][0])
    assert c["all_reduce"] == 2 * 10 + 1 and c["all_gather"] == 10 + 1
    # the masked lattice without a preconditioner trains sharded: the
    # mode products' all-to-alls and CG's inner products, nothing gathered
    c = _ops(world["sk_masked_rank0"]["counts"][0])
    assert set(c) == {"all_to_all", "all_reduce"} and c["all_to_all"] > 0
    for name in ("sk_dense", "sk_kron", "sk_offlattice"):
        assert _ops(world[name]["counts"][0]) == {"all_gather": 1}, name
    for name in SCENARIOS:
        for key, v in world[name]["counts"][0]["collectives"].items():
            assert key.endswith("@gloo") and v["staged_calls"] == 0, name


def test_each_rank_calls_the_kernels_on_its_share_only(world):
    """K1/K2/K3 call shapes: the row-sharded VFE builds Kmn on half the
    padded rows; the task-sharded channels run K2/K3 on half the tasks."""
    n_pad, m = 256, 23              # 136 points padded; indpoints=20
    vfe = world["vfe"]["counts"][0]["calls"]
    # Kmm, Kmn on this rank's 128 training rows, Ks on its 128 test rows
    assert set(vfe) == {"sqdist 1x%dx%dx2" % (m, m),
                        "sqdist 1x%dx%dx2" % (m, n_pad // 2),
                        "sqdist 1x%dx%dx2" % (n_pad // 2, m)}
    ind = world["vgpr_task"]["counts"][0]["calls"]
    assert set(k.split()[0] for k in ind) == {
        "sqdist", "masked_system", "rbf_bwd_reductions"}
    assert all(k.split()[1].startswith("2x") for k in ind), ind


def test_squarest_split_matches_gpim_tpu():
    for n in range(1, 9):
        assert multichip.squarest_split(n) == tuple(
            jmultichip.make_mesh_2d(n).devices.shape), n


class _Mesh3(meshmod.LocalMesh):
    """A stand-in for a 3-rank 'grid' axis (rank 0 of it)."""

    def __init__(self):
        super().__init__(("grid",))
        self.shape = (3,)


def test_shard_chunk_rows_replicates_and_warns_once():
    mesh = _Mesh3()
    chunks = torch.zeros((2, 32, 2))
    meshmod._warned_replicated.clear()
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        out, sharded = meshmod.shard_chunk_rows(chunks, mesh)
        meshmod.shard_chunk_rows(chunks, mesh)     # second call: silent
    assert out is chunks and not sharded
    assert len([r for r in rec if "REPLICATED" in str(r.message)]) == 1
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        out, sharded = meshmod.shard_chunk_rows(torch.zeros((2, 30, 2)),
                                                mesh)
    assert sharded and out.shape == (2, 10, 2) and out.is_contiguous()
    assert not [r for r in rec if "REPLICATED" in str(r.message)]


@pytest.mark.parametrize("size,n", [(12, 3), (13, 3), (7, 2), (1, 2)])
def test_row_block_pads_the_last_row_and_covers_the_axis(size, n):
    """Every rank's block has one length; where n does not divide the axis
    it is padded with the last row, and the blocks in rank order, cut to
    the axis, are the axis (tensors and numpy arrays alike)."""
    x = np.arange(2 * size * 3, dtype=float).reshape(2, size, 3)
    for arr in (x, torch.as_tensor(x)):
        blocks = [meshmod.row_block(arr, n, r, axis=1) for r in range(n)]
        assert {b.shape for b in blocks} == {(2, -(-size // n), 3)}
        got = np.concatenate([np.asarray(b) for b in blocks], axis=1)
        assert_array_equal(got[:, :size], x)
        assert_array_equal(got[:, size:], np.repeat(
            x[:, -1:], got.shape[1] - size, axis=1))


def test_card_is_the_default_device(monkeypatch, tmp_path):
    """The dryrun, the partitioning probe and the worker run on the card
    unless the caller asks for the CPU; without a CUDA device they raise."""
    from gpim_tpu_torch.parallel import mp_worker
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        multichip.dryrun()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        multichip.assert_partitioned_predict(multichip.make_mesh_2d())
    with pytest.raises(SystemExit, match="no CUDA device"):
        mp_worker.main(["multitask", "--rank", "0", "--world", "1",
                        "--address", "tcp://127.0.0.1:1",
                        "--out", str(tmp_path)])


def test_indivisible_tasks_warn_and_run_unsharded():
    class Mesh2x1(meshmod.LocalMesh):
        def __init__(self):
            super().__init__(("task", "grid"))
            self.shape = (2, 1)
    rng = np.random.RandomState(0)
    Y = rng.rand(8, 8, 3)
    X = gridutils.get_full_grid(Y[..., 0])
    with pytest.warns(UserWarning, match="not divisible"):
        model = gpim_tpu_torch.vreconstructor(
            X, Y, X, independent=True, iterations=2, verbose=0,
            use_gpu=False, mesh=Mesh2x1())
    assert model._mesh is None


def test_integer_mesh_must_equal_the_world(monkeypatch):
    """mesh=n takes the whole world of n ranks (a departure from gpim_tpu,
    which takes the first n devices): another n raises and names the
    world size."""
    X, R, Xf = _toy_recon_data()
    with pytest.raises(ValueError, match=r"world size \(1\)"):
        gpim_tpu_torch.reconstructor(X, R, Xf, verbose=0, use_gpu=False,
                                     mesh=2)
    monkeypatch.setattr(distributed, "process_count", lambda: 2)
    with pytest.raises(ValueError, match=r"world size \(2\)"):
        meshmod.resolve_mesh(3)
    with pytest.raises(ValueError, match=r"world size \(2\)"):
        multichip.make_mesh_2d(3)


def test_one_rank_mesh_without_a_process_group_is_local():
    """With no process group, mesh=True or 1 is a one-rank mesh with no
    collectives: results equal mesh=None, and a mesh missing the needed
    axis raises."""
    assert not distributed.is_initialized()
    X, R, Xf = _toy_recon_data()
    kw = dict(kernel="RBF", iterations=3, sparse=True, indpoints=10,
              verbose=0, use_gpu=False)
    m0, s0, h0 = gpim_tpu_torch.reconstructor(X, R, Xf, **kw).run()
    model = gpim_tpu_torch.reconstructor(X, R, Xf, mesh=1, **kw)
    assert isinstance(model._mesh, meshmod.LocalMesh)
    distributed.reset_collective_counts()
    m1, s1, h1 = model.run()
    assert distributed.collective_counts() == {}
    assert_array_equal(m1, m0)
    assert_array_equal(s1, s0)
    with pytest.raises(ValueError, match="axes"):
        gpim_tpu_torch.reconstructor(X, R, Xf, mesh=meshmod.LocalMesh(
            ("task",)), **kw)


def test_masked_lattice_mesh_must_divide_the_leading_axes():
    """The masked-lattice route shards the first grid axis and reshards
    onto the second: a 'grid' axis that divides neither raises."""
    X, R, Xf = _toy_recon_data()                    # a 14 x 14 lattice
    with pytest.raises(ValueError, match="must divide the two leading"):
        gpim_tpu_torch.skreconstructor(X, R, Xf, verbose=0, use_gpu=False,
                                       ski_min_points=1, mesh=_Mesh3())


def test_copy_and_reduce_pair_without_a_group_are_identities():
    x = torch.randn(5, dtype=torch.float64, requires_grad=True)
    y = distributed.reduce_from_shards(
        distributed.copy_to_shards(x, None) * 2.0, None)
    y.sum().backward()
    assert_array_equal(y.detach().numpy(), 2.0 * x.detach().numpy())
    assert_array_equal(x.grad.numpy(), np.full(5, 2.0))


def test_dryrun_multiprocess(world):
    """dryrun_multiprocess() (run by the fixture beside the other worlds)
    passed its checks: ranks equal, one-process parity at rtol 1e-9."""
    report = world["dryrun_multiprocess"]
    assert set(report) == {"multitask", "vfe"}
    assert max(max(r.values()) for r in report.values()) < 1e-9


def test_parallel_package_imports_neither_jax_nor_gpim_tpu():
    import ast
    import pathlib
    root = pathlib.Path(gpim_tpu_torch.__file__).parent / "parallel"
    for path in root.glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     else [])
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "gpim_tpu"), (path, name)
