"""The masked-lattice SKI cell (``mgrid1m_recon``) on the CPU at a small
size: the port against the plain reference ``reference/ski_masked.py`` in
float64, the reference's stochastic estimator against the dense exact
values at thousands of probes, every planted fault caught by a run of the
harness, the frozen operation count of ``ski_mfu`` against the program's
own, and the cell's files against the program's defaults."""

import contextlib
import copy
import math
import time

import numpy as np
import pytest
import torch

from gpbench.harness import bench, faults, find, traffic

SPEC = bench.load_spec()
CELL = "mgrid1m_recon"
CPU = torch.device("cpu")
SHAPE = [10, 9, 6]
RANK = 32
# the small problem: the dense route would take it below ski_min_points,
# and a preconditioner of rank 32 of the 540 cells leaves CG some work
OPTIONS = {"ski_min_points": 1, "precond_rank": RANK}
REF = find.load("reference", "ski_masked")
find.load("loops", "sk_recon")          # adds the cell's faults to FAULTS


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _small(iterations=30):
    _, config, mix, _ = bench.cell(SPEC, CELL)
    mix = copy.deepcopy(mix)
    mix["field"]["shape"] = SHAPE
    mix.update(iterations=iterations, warmup_iterations=2)
    config = dict(config, precision="double", jitter={"sk_recon": 1e-5},
                  precond_rank=RANK, options=OPTIONS)
    return config, mix


def test_port_agrees_with_the_reference_in_float64():
    """The same probes, the same preconditioner built by each side's own
    code, CG on both sides to 100 eps of each right-hand side: every step's
    loss, the trajectories, the trained parameters, the mean and the
    Nystrom sd agree at 1e-9 relative (float64 rounding, which CG, eigh
    and the quadrature take in different orders on the two sides, read
    ~1e-13; Adam's normalised steps carry it through 30 steps)."""
    config, mix = _small()
    loop = bench.make_loop(config, mix, CPU)
    job = loop.make_job(2 ** 31 + 5, traffic.WINDOW, 0)
    model = loop._model(job["R"], 30)
    model.train()
    mean, sd = model.predict()
    segments = model._mgrid_engine.last_segments
    assert sum(segments) == 30 and len(segments) > 1
    out = REF.train(job["R"], segments, lr=0.1, jitter=1e-5, n_probes=8,
                    rank=RANK)
    assert out["max_cg"] > 8
    rmean, rsd, _ = REF.predict(out["lat"], out["u"], jitter=1e-5, rank=RANK)
    hp = REF.hyperparams(out["u"], out["lat"])
    np.testing.assert_allclose(model.losses, out["losses"], rtol=1e-9)
    np.testing.assert_allclose(model.hyperparams["lengthscale"],
                               out["lengthscale"], rtol=1e-9)
    np.testing.assert_allclose(model.hyperparams["noise"], out["noise"],
                               rtol=1e-9)
    u = {k: float(v.reshape(-1)[0]) for k, v in model.u.items()
         if k != "lengthscale"}
    assert math.log1p(math.exp(u["outputscale"])) == pytest.approx(
        hp["variance"], rel=1e-9)
    assert u["mean"] == pytest.approx(hp["mean"], rel=1e-9, abs=1e-12)
    np.testing.assert_allclose(mean, rmean.numpy(), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(sd, rsd.numpy(), rtol=1e-9)


def _dense(u, lat, jitter):
    """The exact loss and its gradient through the dense Cholesky, with
    the Gram matrix of ``reference/exact_gp.py``."""
    exact = find.load("reference", "exact_gp")
    w = {k: v.detach().clone().requires_grad_(True) for k, v in u.items()}
    ls = lat.h * torch.sigmoid(w["l"])
    v, noise = (torch.nn.functional.softplus(w[k]) for k in ("v", "noise"))
    X = torch.as_tensor(np.argwhere(np.ones(lat.shape, bool)),
                        dtype=torch.float64)
    A = (lat.mask[:, None] * exact._rbf(ls, v, X, X) * lat.mask[None, :]
         + (noise + jitter) * torch.eye(lat.G, dtype=torch.float64))
    L = torch.linalg.cholesky(A)
    yc = lat.mask * (lat.y - w["mu"])
    z = torch.linalg.solve_triangular(L, yc[:, None], upper=False)[:, 0]
    loss = (0.5 * (z * z).sum() + torch.log(torch.diagonal(L)).sum()
            + 0.5 * lat.n * math.log(2 * math.pi)
            - 0.5 * (lat.G - lat.n) * torch.log(noise + jitter)
            - (math.log(lat.h) + torch.nn.functional.logsigmoid(w["l"])
               + torch.nn.functional.logsigmoid(-w["l"])).sum())
    grads = torch.autograd.grad(loss, list(w.values()))
    return float(loss.detach()), dict(zip(w, grads))


def test_the_estimator_converges_to_the_dense_values():
    """On a 6x5x4 cube with half its spectra left out, at 4,096 probes in
    8 batches and a preconditioner of rank 8 built away from the point
    (any SPD P leaves the estimator unbiased), the SLQ loss and the
    trace-estimated gradient lie within 4 standard errors of the batch
    means from the dense Cholesky values, and those errors are small."""
    _, mix = _small()
    mix["field"]["shape"] = [6, 5, 4]
    mix["scan"] = dict(mix["scan"], remove=0.5)
    R = traffic.recon_job(mix, 11, traffic.WINDOW, 0)["R"]
    lat = REF.Lattice(R, torch.float64, CPU)
    u = REF.initial_u(lat)
    u = {"l": u["l"] + torch.tensor([0.8, 0.5, 1.1], dtype=torch.float64),
         "v": u["v"] - 0.3, "noise": u["noise"] - 2.0,
         "mu": u["mu"] + 0.4}
    pre = REF.Preconditioner(REF.factors(
        torch.tensor([1.0, 0.8, 1.2], dtype=torch.float64),
        torch.tensor(1.0, dtype=torch.float64), lat.axes), lat, 8, 16)
    loss, grad = _dense(u, lat, 1e-5)
    rng = np.random.default_rng(3)
    batches = []
    for _ in range(8):
        Z = torch.as_tensor(rng.choice([-1.0, 1.0], size=(512, lat.G)))
        got, g, _, _ = REF.estimate(u, lat, pre, Z, 1e-5)
        batches.append(np.concatenate([[got]] + [
            g[k].reshape(-1).numpy() for k in ("l", "v", "noise", "mu")]))
    batches = np.array(batches)
    want = np.concatenate([[loss]] + [grad[k].reshape(-1).numpy()
                                      for k in ("l", "v", "noise", "mu")])
    se = batches.std(0, ddof=1) / math.sqrt(len(batches))
    err = np.abs(batches.mean(0) - want)
    assert np.all(err <= 4 * se + 1e-9 * np.abs(want)), (err, se)
    assert np.all(se <= 0.01 * (np.abs(want) + 1.0)), (se, want)


@pytest.mark.parametrize("fault", [None, "cg_capped", "half_probes",
                                   "sk_mean_shift", "adam_unchanged"])
def test_a_broken_timed_path_is_not_correct(fault):
    """A run of the harness at the small size in float64 is correct, its
    numbers at rounding, and every per-layer metric that needs no card
    reads a number; with a fault planted in the timed path it is not
    correct."""
    config, mix = _small(iterations=10)
    with faults.FAULTS[fault]() if fault else contextlib.nullcontext():
        result, checks, _ = bench.run_cell(
            SPEC, CELL, 2 ** 31 + 7, 0.1, int(fault is None), CPU,
            time.perf_counter(), mix=mix, config=config)
    assert result["attempted"] >= 1 and result["failed"] == 0
    if fault is None:
        assert result["correct"], checks
        assert max(v for v, _ in checks.values()) < 1e-9, checks
        on_card = {"device_idle_pct.ski", "ski_peak_mem_gib"}
        assert set(result["metrics"]) == {
            m["name"] for m in bench.metrics_for(SPEC, CELL, "per_layer")
        } - on_card
        assert all(v["value"] > 0 for v in result["metrics"].values())
    else:
        assert result["correct"] is False, checks


def test_the_cards_time_is_read_over_the_jobs_adam_steps():
    """The cell's end-to-end metric, ``bo_device_ms_per_step``, reads the
    window's device seconds over the Adam steps of the loop's records."""
    import types
    config, mix = _small(iterations=4)
    loop = bench.make_loop(config, mix, CPU)
    rec = loop.run_job(loop.make_job(2 ** 31 + 9, traffic.WINDOW, 0))
    run = bench.Run(config, mix)
    run.jobs = [rec, rec]
    run.window_trace = types.SimpleNamespace(busy_s=0.4)
    assert bench.read_metric("bo_device_ms_per_step", run) == 1e3 * 0.4 / 8


def test_ski_mfu_counts_the_programs_operations():
    """The frozen count against torch's flop counter over the program's
    own training step (forward and backward, at the iterations it ran:
    the realized ones rounded up to the next exit check) and prediction,
    on a small lattice. The counter sees no eigh and no in-place Gram
    product, so those terms of the builds are left out of the comparison."""
    from torch.utils.flop_counter import FlopCounterMode
    from gpim_tpu_torch.gpreg import mgrid_model
    mfu = find.load("metrics", "ski_mfu")
    config, mix = _small()
    loop = bench.make_loop(config, mix, CPU)
    R = loop.make_job(5, traffic.WINDOW, 0)["R"]
    model = loop._model(R, 2)
    eng = model._mgrid_engine
    n = int(np.sum(~np.isnan(R)))
    u = {k: v[0] for k, v in model.u.items()}
    bounds = model._bounds()
    pre = mgrid_model._build_precond(u, eng._axes, eng._mask, bounds,
                                     kernel="RBF", rank=RANK)
    w = {k: v.clone().requires_grad_(True) for k, v in u.items()}
    with FlopCounterMode(display=False) as fc:
        loss, it = mgrid_model._loss(
            w, eng._axes, eng._mask, eng._g0, *pre, eng._y, bounds, 1e-5,
            kernel="RBF", grid_shape=eng.grid_shape, cg_iters=64,
            record_iters=True)
        loss.backward()
    ran = 4 * math.ceil(int(it) / 4)
    assert fc.get_total_flops() == mfu.step_ops(SHAPE, RANK, 8, ran)
    model.train()
    with FlopCounterMode(display=False) as fc:
        model.predict()
    ran = 4 * math.ceil(eng.last_predict_cg_iters / 4)
    unseen = (9 * sum(g ** 3 for g in SHAPE) + 2 * n * RANK ** 2
              + 9 * RANK ** 3)
    assert fc.get_total_flops() == mfu.predict_ops(SHAPE, RANK, n,
                                                   ran) - unseen
    # the cell's own shapes: each axis keeps 41 candidates of its modes
    assert mfu.pruned([128, 128, 64], 1024, True) == [41, 41, 41]


def test_the_cell_states_the_programs_defaults():
    """The configuration's solver settings are the route's own defaults at
    the cell's size (the cell passes none of them), its two cuts are the
    traffic's, and the traffic leaves 314,624 of the 1,048,576 cells
    observed."""
    _, config, mix, _ = bench.cell(SPEC, CELL)
    assert config["options"] == {}
    assert config["reduced"] == sorted(config["cuts"])
    assert config["iterations"] == mix["iterations"]
    assert config["spectral_bins"] == mix["field"]["shape"][2]
    R = traffic.recon_job(mix, 2 ** 31 + 3, traffic.WINDOW, 0)["R"]
    assert R.shape == (128, 128, 64)
    assert int(np.sum(~np.isnan(R))) == 314_624
    model = bench.make_loop(config, mix, CPU)._model(R, 30)
    eng = model._mgrid_engine
    assert model.jitter == config["jitter"]["sk_recon"]
    assert (eng.precond_rank, eng.cg_iters, eng._g0.shape[0]) == (
        config["precond_rank"], config["cg_iterations"], config["n_probes"])
    assert eng.seed == config["probe_seed"] and eng.dtype == torch.float32
