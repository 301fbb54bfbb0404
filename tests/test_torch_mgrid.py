"""
gpim_tpu_torch.gpreg.mgrid_model and skreconstructor's masked-lattice route
against gpim_tpu on the same numpy inputs: lattice detection; the engine's
training series (lengthscale, noise and loss at rtol 1e-6 in float64, the
realized CG iterations exactly, so the adaptive rebuild schedule is the
same) against JAX's host segment loop, cold and warm-started (with
batched CG from x0 and the segment loop's carry); prediction on the
Cartesian grid and at scattered points; the posterior against a dense
exact GP (the check of
tests/test_ski.py::test_masked_grid_engine_matches_dense_exact); run() in
RBF and Matern52 (float64, rtol 1e-6) and in float32 (1e-3); max_root
capping the preconditioner rank; update_data() between the dense,
masked-lattice and Kronecker routes; checkpoints both ways.
"""

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

import jax.numpy as jnp

import gpim_tpu
from gpim_tpu import utils as jutils
from gpim_tpu.gpreg import mgrid_model as jmgrid

import gpim_tpu_torch
from gpim_tpu_torch.gpreg import mgrid_model
from gpim_tpu_torch.kernels.transforms import (
    interval_inverse, positive_inverse)

SHAPE = (10, 9, 6)
ITERS = 10
# a full-rank preconditioner at this lr: the realized CG iterations cross
# the schedule's thresholds, so its segments are 2, 4, 4, 2
KW = dict(learning_rate=0.05, verbose=0, ski_min_points=1, cg_iterations=40,
          precond_rank=540)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _close(got, ref, rtol, err_msg=""):
    ref = np.asarray(ref)
    assert_allclose(np.asarray(got), ref, rtol=rtol,
                    atol=rtol * max(np.abs(ref).max(), 1e-30),
                    err_msg=err_msg)


def _lattice(seed=1, shape=SHAPE, frac=0.5):
    """A smooth cube with noise and ``frac`` of its (x, y) spectra removed,
    as the suite's masked rows make it; (R, X sparse, X full, truth)."""
    rng = np.random.RandomState(seed)
    xx, yy, zz = np.meshgrid(*[np.arange(s, dtype=np.float64)
                               for s in shape], indexing="ij")
    f = np.sin(xx / 3.0) * np.cos(yy / 4.0) + 0.3 * np.sin(zz / 2.0)
    f = (f - f.min()) / np.ptp(f)
    R = f + 0.02 * rng.randn(*shape)
    sites = rng.choice(shape[0] * shape[1], int(frac * shape[0] * shape[1]),
                       replace=False)
    R.reshape(-1, shape[2])[sites] = np.nan
    return R, jutils.get_sparse_grid(R), jutils.get_full_grid(R), f


@pytest.fixture(scope="module")
def trained():
    """Both packages' masked-lattice engines trained from the models' own
    initial parameters, ITERS Adam steps, float64, CG iterations
    recorded."""
    R, X, Xf, _ = _lattice()
    kw = dict(kernel="RBF", precision="double", **KW)
    jm = gpim_tpu.skreconstructor(X, R, Xf, **kw)
    pm = gpim_tpu_torch.skreconstructor(X, R, Xf, use_gpu=False, **kw)
    assert jm._mgrid_engine is not None and pm._mgrid_engine is not None
    ju, jt = jm._mgrid_engine.train(
        {k: v[0] for k, v in jm.u.items()}, jm._bounds(),
        jnp.asarray(KW["learning_rate"], jm.dtype),
        jnp.asarray(jm.jitter, jm.dtype), iterations=ITERS,
        record_cg_iters=True)
    pu, pt = pm._mgrid_engine.train(
        {k: v[0] for k, v in pm.u.items()}, pm._bounds(), KW["learning_rate"],
        pm.jitter, iterations=ITERS, record_cg_iters=True)
    return dict(R=R, X=X, Xf=Xf, jm=jm, pm=pm, ju=ju, jt=jt, pu=pu, pt=pt)


# --------------------------------------------------------------------------
# lattice detection
# --------------------------------------------------------------------------

def _detect_cases():
    R, X, Xf, _ = _lattice()
    Xs = X.copy()
    Xs[0][np.isfinite(Xs[0])] *= 1.0 + 1e-3 * np.random.RandomState(
        0).rand(int(np.isfinite(Xs[0]).sum()))
    Xn = X.copy()
    Xn[1] = np.where(np.isfinite(Xn[1]), Xn[1] ** 1.5, np.nan)
    Rl = R.copy()
    Rl[:, 3, :] = np.nan                      # a fully unmeasured line
    return {"masked": (X, R), "full": (Xf.reshape((3,) + SHAPE), R),
            "unmeasured line": (jutils.get_sparse_grid(Rl), Rl),
            "scaled": (X * 0.5 + 2.0, R), "jittered": (Xs, R),
            "non-uniform": (Xn, R), "wrong shape": (X[:2], R)}


@pytest.mark.parametrize("case", sorted(_detect_cases()))
def test_detect_masked_lattice_matches_gpim_tpu(case):
    X, R = _detect_cases()[case]
    ref = jmgrid.detect_masked_lattice(X, R)
    got = mgrid_model.detect_masked_lattice(X, R)
    assert (got is None) == (ref is None)
    assert (got is None) == (case in ("jittered", "non-uniform",
                                      "wrong shape"))
    for a, b in zip(got or [], ref or []):
        assert_allclose(a, b, rtol=0, atol=0)


def test_cartesian_axes_from_points_matches_gpim_tpu():
    _, _, Xf, _ = _lattice()
    pts = jutils.prepare_test_data(Xf)
    bent = pts.copy()
    bent[:, 2] = bent[:, 2] ** 1.3
    for X, dims in ((pts, SHAPE), (pts * 0.3, SHAPE), (bent, SHAPE),
                    (pts, (9, 10, 6))):
        ref = jmgrid.cartesian_axes_from_points(X, dims)
        got = mgrid_model.cartesian_axes_from_points(X, dims)
        assert (got is None) == (ref is None)
        for a, b in zip(got or [], ref or []):
            assert_allclose(a, b, rtol=0, atol=0)


# --------------------------------------------------------------------------
# the engine against gpim_tpu's host segment loop
# --------------------------------------------------------------------------

def test_engine_training_series_match_gpim_tpu(trained):
    jt, pt = trained["jt"], trained["pt"]
    for k in ("lengthscale", "noise", "loss"):
        _close(pt[k].numpy(), jt[k], 1e-6, k)
    np.testing.assert_array_equal(pt["cg_iters"].numpy(), jt["cg_iters"])
    eng = trained["pm"]._mgrid_engine
    np.testing.assert_array_equal(eng.last_cg_iters, jt["cg_iters"])
    # the adaptive schedule: segment lengths from the realized iterations
    segs, s_next, i = [], 2, 0
    while i < ITERS:
        s = min(s_next, ITERS - i)
        i += s
        segs.append(s)
        last = jt["cg_iters"][i - 1]
        s_next = (max(2, s // 2) if last >= 16 else
                  min(10, 2 * s) if last <= 8 else s_next)
    assert eng.last_segments == segs and len(set(segs)) > 1
    for k, v in trained["pu"].items():
        _close(v.numpy(), trained["ju"][k], 1e-6, k)


def test_engine_predictions_match_gpim_tpu(trained):
    """The Cartesian grid (cross factors, Nystrom variance) and scattered
    points (per-point cross rows, two chunks)."""
    jm, pm = trained["jm"], trained["pm"]
    ju = {k: jnp.asarray(v) for k, v in trained["ju"].items()}
    Xt = jutils.prepare_test_data(trained["Xf"])
    scattered = np.random.RandomState(3).rand(4200, 3) * (
        np.asarray(SHAPE) - 1)
    for pts, dims in ((Xt, SHAPE), (scattered, None)):
        ref = jm._mgrid_engine.predict(
            ju, jm._bounds(), jnp.asarray(jm.jitter, jm.dtype), pts, dims)
        got = pm._mgrid_engine.predict(trained["pu"], pm._bounds(),
                                       pm.jitter, pts, dims)
        for a, b in zip(got, ref):
            _close(a.numpy(), b, 1e-6)


def test_engine_matches_a_dense_exact_gp():
    """Exact in W on a masked lattice: the posterior mean and variance match
    a dense exact GP of the same product RBF up to CG tolerance and the
    Nystrom rank, on the lattice and on a 2x denser Cartesian grid; the
    scattered-point path within its interpolation-free cross rows."""
    rng = np.random.RandomState(0)
    g1, g2 = 16, 14
    axes = [np.arange(g1, dtype=np.float64), np.arange(g2, dtype=np.float64)]
    xx, yy = np.meshgrid(axes[0], axes[1], indexing="ij")
    Y = np.sin(xx / 3.0) + np.cos(yy / 4.0) + 0.05 * rng.randn(g1, g2)
    Y[rng.rand(g1, g2) < 0.4] = np.nan
    mask_grid = ~np.isnan(Y)
    eng = mgrid_model.MaskedGridEngine(
        "RBF", axes, mask_grid, Y, torch.float64, "cpu", cg_iters=256,
        precond_rank=g1 * g2, seed=0)
    bounds = {"ls_lo": torch.zeros(2, dtype=torch.float64),
              "ls_hi": torch.full((2,), 10.0, dtype=torch.float64)}
    ls_val, var_val, noise_val, mu = 2.5, 1.0, 0.05, 0.1
    t = lambda x: torch.as_tensor(x, dtype=torch.float64)  # noqa: E731
    u = {"lengthscale": interval_inverse(t([ls_val] * 2), bounds["ls_lo"],
                                         bounds["ls_hi"]),
         "outputscale": positive_inverse(t(var_val)),
         "noise": positive_inverse(t(noise_val)), "mean": t(mu)}
    X = np.stack([xx[mask_grid], yy[mask_grid]], -1)

    def k(a, b):
        d2 = (((a[:, None, :] - b[None, :, :]) / ls_val) ** 2).sum(-1)
        return var_val * np.exp(-0.5 * d2)

    Kd = k(X, X) + (noise_val + 1e-6) * np.eye(len(X))
    alpha = np.linalg.solve(Kd, Y[mask_grid] - mu)
    for dense_x in (1.0, 0.5):
        ta = [np.arange(0, g - 1 + 1e-9, dense_x) for g in (g1, g2)]
        tx, ty = np.meshgrid(*ta, indexing="ij")
        Xt = np.stack([tx.ravel(), ty.ravel()], -1)
        mean, var = eng.predict(u, bounds, 1e-6, Xt, (len(ta[0]),
                                                      len(ta[1])))
        Ks = k(Xt, X)
        assert_allclose(mean.numpy(), Ks @ alpha + mu, rtol=0, atol=2e-3)
        var_ref = var_val - np.einsum(
            "ij,ji->i", Ks, np.linalg.solve(Kd, Ks.T)) + noise_val
        assert_allclose(var.numpy(), var_ref, rtol=0.05, atol=2e-3)
    Xs = rng.rand(40, 2) * [[g1 - 1, g2 - 1]]
    mean, var = eng.predict(u, bounds, 1e-6, Xs, None)
    assert np.abs(mean.numpy() - (k(Xs, X) @ alpha + mu)).max() < 0.05
    assert (var.numpy() > 0).all()


# --------------------------------------------------------------------------
# skreconstructor on the masked-lattice route
# --------------------------------------------------------------------------

def _lattice_2d(seed=0, shape=(24, 22)):
    """A NaN-masked 2D image (40% of its pixels removed)."""
    rng = np.random.RandomState(seed)
    R = (np.sin(np.arange(shape[0])[:, None] / 4.0)
         + np.cos(np.arange(shape[1])[None, :] / 5.0)
         + 0.02 * rng.randn(*shape))
    R[rng.rand(*shape) < 0.4] = np.nan
    return R, jutils.get_sparse_grid(R), jutils.get_full_grid(R), None


@pytest.mark.parametrize("kernel, precision, data", [
    ("RBF", "double", _lattice), ("Matern52", "double", _lattice_2d),
    ("RBF", "single", _lattice_2d)])
def test_run_matches_gpim_tpu(kernel, precision, data):
    """The 3D case shares its programs with the engine tests above; the
    others are 2D, which gpim_tpu compiles faster."""
    R, X, Xf, _ = data()
    kw = dict(kernel=kernel, iterations=6, precision=precision, **KW)
    jm = gpim_tpu.skreconstructor(X, R, Xf, **kw)
    pm = gpim_tpu_torch.skreconstructor(X, R, Xf, use_gpu=False, **kw)
    assert pm._mgrid_engine is not None and pm._kron_engine is None
    mean_j, sd_j, hp_j = jm.run()
    mean, sd, hp = pm.run()
    assert mean.dtype == (np.float64 if precision == "double"
                          else np.float32)
    assert mean.shape == sd.shape == R.shape
    assert np.isfinite(mean).all() and np.isfinite(sd).all()
    if precision == "double":
        rtol, last = 1e-6, slice(None)
    else:
        rtol, last = 1e-3, slice(-1, None)
    _close(mean, mean_j, rtol)
    _close(sd, sd_j, rtol)
    assert set(hp) == set(hp_j)
    for k in hp:
        assert np.shape(hp[k]) == np.shape(hp_j[k]), k
        _close(hp[k][last], hp_j[k][last], rtol, k)
    _close(pm.losses[last], jm.losses[last], rtol)


def test_max_root_caps_the_preconditioner_rank(trained):
    """max_root caps the masked route's eigen-root (preconditioner and
    Nystrom variance) and never raises it: the capped prediction is that
    of a model built with the capped rank (gpim_tpu/gpreg/skgpr.py:357-376)."""
    pm = trained["pm"]
    pm.u = {k: v[None] for k, v in trained["pu"].items()}
    full = pm.predict(max_root=1000)
    assert pm._mgrid_engine.precond_rank == KW["precond_rank"]
    got = pm.predict(max_root=24)
    assert pm._mgrid_engine.precond_rank == 24
    ref = gpim_tpu_torch.skreconstructor(
        trained["X"], trained["R"], trained["Xf"], kernel="RBF",
        precision="double", use_gpu=False, **dict(KW, precond_rank=24))
    ref.u = pm.u
    for a, b in zip(got, ref.predict()):
        assert_allclose(a, b, rtol=0, atol=0)
    assert not np.allclose(got[1], full[1])
    pm.predict(max_root=1000)
    assert pm._mgrid_engine.precond_rank == 24
    pm._mgrid_engine.precond_rank = KW["precond_rank"]


def test_checkpoints_load_across_packages(trained, tmp_path):
    jm, pm = trained["jm"], trained["pm"]
    jm.u = {k: jnp.asarray(v)[None] for k, v in trained["ju"].items()}
    jm.save_model(str(tmp_path / "jax"))
    pm.load_model(str(tmp_path / "jax"))
    for a, b in zip(pm.predict(), jm.predict()):
        _close(a, b, 1e-6)
    pm.u = {k: v[None] for k, v in trained["pu"].items()}
    pm.save_model(str(tmp_path / "port.npz"))
    jm.load_model(str(tmp_path / "port.npz"))
    for a, b in zip(pm.predict(), jm.predict()):
        _close(a, b, 1e-6)


def test_update_data_moves_between_routes_and_keeps_the_time_series():
    """Dense (below ski_min_points), masked lattice, exact Kronecker (no
    NaN) and back to the masked lattice: each update_data() rebuilds the
    route, the hyperparameters continue warm and the series runs on."""
    R, X, Xf, truth = _lattice(shape=(8, 8, 6), frac=0.2)
    thin = R.copy()
    thin.reshape(-1)[np.random.RandomState(4).permutation(R.size)[120:]] = \
        np.nan
    m = gpim_tpu_torch.skreconstructor(
        jutils.get_sparse_grid(thin), thin, Xf, kernel="RBF", iterations=3,
        use_gpu=False, precision="double", verbose=0, ski_min_points=256)
    routes = []
    for data in (None, R, truth, R):
        if data is not None:
            m.update_data(Xf if data is truth else
                          jutils.get_sparse_grid(data), data)
        routes.append("kron" if m._kron_engine is not None else "mgrid"
                      if m._mgrid_engine is not None else "dense")
        m.train()
    assert routes == ["dense", "mgrid", "kron", "mgrid"]
    assert m.hyperparams["lengthscale"].shape == (12, 3)
    assert m.losses.shape == (12,)
    mean, sd = m.predict()
    assert np.isfinite(mean).all() and np.isfinite(sd).all()
    assert np.sqrt(np.mean((mean - truth) ** 2)) < 0.1


# --------------------------------------------------------------------------
# the warm-started CG (experimental in gpim_tpu, off the public surface)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("vec_axis", [0, 1])
def test_batched_pcg_warm_start_matches_gpim_tpu(vec_axis):
    """batched_cg from x0 with the original right-hand sides' tolerance
    reference (tests/test_round4_fixes.py:148-175): started at the
    solution it stops at once, started near it it lands on the same
    solution in fewer iterations than cold; solutions, tridiagonals and
    the realized count as gpim_tpu's."""
    from gpim_tpu.ops import ski as jski
    from gpim_tpu_torch.ops import ski
    rng = np.random.RandomState(0)
    n, b = 64, 4
    M = rng.randn(n, n)
    A = M @ M.T + n * np.eye(n)
    B = rng.randn(n, b)
    near = 1e-6 * rng.randn(n, b)
    tr = (lambda a: a) if vec_axis == 0 else (lambda a: np.asarray(a).T)
    jmvm = (lambda v: jnp.asarray(A) @ v) if vec_axis == 0 else \
        (lambda v: v @ jnp.asarray(A))
    tA = torch.as_tensor(A)
    mvm = (lambda v: tA @ v) if vec_axis == 0 else (lambda v: v @ tA)
    jB, tB = jnp.asarray(tr(B)), torch.as_tensor(tr(B))
    ref = jnp.sum(jB * jB, axis=vec_axis)
    jcold = jski.batched_cg(jmvm, jB, 200, vec_axis=vec_axis,
                            return_iters=True)
    cold = ski.batched_cg(mvm, tB, 200, vec_axis=vec_axis,
                          return_iters=True)
    for x0 in (None, np.array(jcold[0]), np.array(jcold[0]) + tr(near)):
        kw = {} if x0 is None else dict(tol_ref=ref)
        jout = jski.batched_cg(jmvm, jB, 200, vec_axis=vec_axis,
                               return_iters=True,
                               x0=None if x0 is None else jnp.asarray(x0),
                               **kw)
        out = ski.batched_cg(
            mvm, tB, 200, vec_axis=vec_axis, return_iters=True,
            x0=None if x0 is None else torch.as_tensor(x0),
            tol_ref=None if x0 is None else torch.as_tensor(np.array(ref)))
        assert int(out[3]) == int(jout[3])
        _close(out[0].numpy(), jout[0], 1e-10)
        live = slice(0, max(int(out[3]), 1))
        _close(out[1][live].numpy(), np.asarray(jout[1])[live], 1e-8)
        _close(out[2][live].numpy(), np.asarray(jout[2])[live], 1e-8)
        assert_allclose(out[0].numpy(), cold[0].numpy(), atol=1e-7)
        if x0 is not None:
            assert int(out[3]) < int(cold[3])
    assert_allclose(tr(A @ tr(cold[0].numpy())), tr(B), atol=1e-8)


def _ws_lattice():
    """tests/test_round4_fixes.py:177-215: a 20x20 bump with noise, 40% of
    the pixels missing; the engine's inputs and each package's u0 and
    bounds."""
    from gpim_tpu.kernels import transforms as jtr
    rng = np.random.RandomState(1)
    axes = [np.arange(20, dtype=np.float64), np.arange(20, dtype=np.float64)]
    xx, yy = np.meshgrid(axes[0], axes[1], indexing="ij")
    Y = np.exp(-((xx - 10) ** 2 + (yy - 10) ** 2) / 50.0)
    Y = Y + 0.02 * rng.randn(20, 20)
    Y[rng.rand(20, 20) < 0.4] = np.nan
    jb = {"ls_lo": jnp.zeros(2), "ls_hi": jnp.full(2, 10.0)}
    ju0 = {"lengthscale": jtr.interval_inverse(jnp.full(2, 1.0),
                                               jb["ls_lo"], jb["ls_hi"]),
           "outputscale": jtr.positive_inverse(jnp.asarray(1.0)),
           "noise": jtr.positive_inverse(jnp.asarray(1.0)),
           "mean": jnp.zeros(())}
    t = lambda a: torch.as_tensor(np.asarray(a))  # noqa: E731
    return axes, Y, (ju0, jb), ({k: t(v) for k, v in ju0.items()},
                                {k: t(v) for k, v in jb.items()})


@pytest.fixture(scope="module")
def warm():
    """30 Adam steps, float64, cg_iters 128, rank 256, lr 0.1, jitter
    1e-6: gpim_tpu's engine warm-started, the port's warm and cold."""
    axes, Y, (ju0, jb), (pu0, pb) = _ws_lattice()
    kw = dict(cg_iters=128, precond_rank=256, seed=0)
    je = jmgrid.MaskedGridEngine("RBF", axes, ~np.isnan(Y), Y, np.float64,
                                 **kw)
    _, jt = je.train(ju0, jb, 0.1, 1e-6, iterations=30,
                     record_cg_iters=True, warm_start=True)
    out = {"jt": jt}
    for tag in ("warm", "cold"):
        eng = mgrid_model.MaskedGridEngine("RBF", axes, ~np.isnan(Y), Y,
                                           torch.float64, "cpu", **kw)
        u, traj = eng.train(pu0, pb, 0.1, 1e-6, iterations=30,
                            record_cg_iters=True,
                            warm_start=tag == "warm")
        out[tag] = (eng, u, traj)
    return out


def test_warm_start_training_series_match_gpim_tpu(warm):
    jt = warm["jt"]
    eng, _, pt = warm["warm"]
    for k in ("lengthscale", "noise", "loss"):
        _close(pt[k].numpy(), jt[k], 1e-6, k)
    np.testing.assert_array_equal(pt["cg_iters"].numpy(), jt["cg_iters"])
    segs, s_next, i = [], 2, 0
    while i < 30:
        s = min(s_next, 30 - i)
        i += s
        segs.append(s)
        last = jt["cg_iters"][i - 1]
        s_next = (max(2, s // 2) if last >= 16 else
                  min(10, 2 * s) if last <= 8 else s_next)
    assert eng.last_segments == segs


def test_warm_and_cold_reach_the_same_fit(warm):
    """As gpim_tpu's test asserts: the gradient does not depend on the
    start up to the CG tolerance, so both reach the same hyperparameters;
    the warm solves need no more CG iterations a step here, fewer in all,
    and the recorded losses part only through the biased log-determinant."""
    _, _, tw = warm["warm"]
    _, _, tc = warm["cold"]
    assert_allclose(tw["lengthscale"][-1].numpy(),
                    tc["lengthscale"][-1].numpy(), rtol=0.05)
    assert_allclose(float(tw["noise"][-1]), float(tc["noise"][-1]),
                    rtol=0.1)
    it_w, it_c = tw["cg_iters"].numpy(), tc["cg_iters"].numpy()
    assert (it_w <= it_c).all() and it_w.sum() < it_c.sum()
    assert np.isfinite(tw["loss"].numpy()).all()


def test_adam_segments_resets_the_carry_at_each_segment():
    """engine.adam_segments with carry0: a step gets the previous step's
    carry within a segment and carry0() at each segment's start."""
    from gpim_tpu_torch.gpreg import engine
    seen = []

    def loss_iters(u, pre, carry):
        seen.append((pre, carry))
        return (u["x"] ** 2).sum(), torch.tensor(12.0), carry + 1
    builds = []

    def build(u):
        builds.append(len(seen))
        return len(builds)
    engine.adam_segments({"x": torch.ones(2, dtype=torch.float64)}, 0.1, 7,
                         build, loss_iters, carry0=lambda: 0)
    # 12 CG iterations hold every segment at 2 steps
    assert builds == [0, 2, 4, 6]
    assert seen == [(1, 0), (1, 1), (2, 0), (2, 1), (3, 0), (3, 1), (4, 0)]
