"""
gpim_tpu_torch's off-lattice SKI route against gpim_tpu on the same numpy
inputs: JAX's Rademacher draw (ops/prng.jax_rademacher, exactly); the
inducing grids and the interpolation (exactly); the interpolation operator
against both forms of JAX's ski_mvm; the Kronecker eigen-root; Lanczos; the
SKI loss and its gradients against JAX's custom VJP (float64 rtol 1e-6,
float32 1e-3, the same realized CG iterations); skreconstructor(ski=True,
lattice=False).run() on the 14x14x6 cube of
tests/test_ski.py::test_skreconstructor_masked_ski_end_to_end in float64
(the training series at rtol 1e-6, the realized CG iterations and segments
exactly, mean and sd) and on genuinely scattered 2D points in float32
(1e-3, NaN test rows); both variance paths (Nystrom and, at preconditioner
rank 0, Lanczos); max_root; checkpoints both ways; the engine's
permutation invariance (the twin of
tests/test_ski.py::test_ski_engine_sorted_internally); update_data() across
all four structured and dense routes. And the port's own pieces: K4's plain
version (W^T through W's CSR layout) against a dense W^T and against the
index_add_ it replaced, and the rank-0 predict, whose solve runs to CG's
tolerance past the training cap, against a dense solve.
"""

from functools import partial

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose, assert_array_equal
from scipy.ndimage import gaussian_filter

import jax
import jax.numpy as jnp

import gpim_tpu
from gpim_tpu import utils as jutils
from gpim_tpu.gpreg import ski_model as jski_model
from gpim_tpu.ops import ski as jski

import gpim_tpu_torch
from gpim_tpu_torch.gpreg import ski_model
from gpim_tpu_torch.gpreg.multi import _constrain_task
from gpim_tpu_torch.ops import gram_kernels as gk
from gpim_tpu_torch.ops import ski
from gpim_tpu_torch.ops.prng import jax_rademacher

SHAPE = (14, 14, 6)
KW = dict(kernel="RBF", iterations=6, learning_rate=0.1, verbose=0,
          ski=True, ski_min_points=1, lattice=False)


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


def _t(a, dtype=torch.float64):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def _cube():
    """tests/test_ski.py:419-434: a smoothed random 14x14x6 field, noise
    0.02, half its (x, y) spectra removed; (R, X sparse, X full, truth)."""
    rng = np.random.RandomState(1)
    f = gaussian_filter(rng.randn(*SHAPE), sigma=(2.5, 2.5, 1.2))
    f = (f - f.min()) / (f.max() - f.min())
    R = f + 0.02 * rng.randn(*SHAPE)
    sites = rng.choice(SHAPE[0] * SHAPE[1], int(0.5 * SHAPE[0] * SHAPE[1]),
                       replace=False)
    R.reshape(-1, SHAPE[2])[sites] = np.nan
    return R, jutils.get_sparse_grid(R), jutils.get_full_grid(R), f


def _scattered(seed=4, shape=(18, 16)):
    """Random 2D coordinates in [0, 10)^2 shaped like an image, 20% of them
    missing, a smooth surface on them, and a 12 x 12 test grid over the
    same square with its first row NaN."""
    rng = np.random.RandomState(seed)
    X = rng.rand(2, *shape) * 10.0
    R = np.sin(X[0] / 2.0) * np.cos(X[1] / 3.0) + 0.02 * rng.randn(*shape)
    gone = rng.rand(*shape) < 0.2
    R[gone] = np.nan
    X[:, gone] = np.nan
    Xt = np.stack(np.meshgrid(np.linspace(0, 10, 12), np.linspace(0, 10, 12),
                              indexing="ij"))
    Xt[:, 0] = np.nan
    return R, X, Xt


def _points(n, d, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.rand(n, d) * 10.0
    mask = (rng.rand(n) < 0.85).astype(float)
    return X, mask


@pytest.fixture(scope="module")
def cube_runs():
    """Both packages' skreconstructor on the cube's off-lattice route,
    float64, run() once each; gpim_tpu's realized CG iterations recorded
    from its segment programs."""
    R, X, Xf, f = _cube()
    jm = gpim_tpu.skreconstructor(X, R, Xf, precision="double", **KW)
    pm = gpim_tpu_torch.skreconstructor(X, R, Xf, precision="double",
                                        use_gpu=False, **KW)
    assert jm._ski_engine is not None and pm._ski_engine is not None
    segs = []
    train_seg = jski_model._train_seg

    def recording(*args, **kwargs):
        out = train_seg(*args, **kwargs)
        segs.append(np.asarray(out[2]["cg_iters"]))
        return out
    jski_model._train_seg = recording
    try:
        out_j = jm.run()
    finally:
        jski_model._train_seg = train_seg
    return dict(R=R, X=X, Xf=Xf, f=f, jm=jm, pm=pm, out_j=out_j,
                out_p=pm.run(), jit_segs=segs)


# --------------------------------------------------------------------------
# the pieces
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("shape", [(1,), (640,), (4, 33)])
@pytest.mark.parametrize("seed", [0, 3, 2 ** 33 + 5])
def test_rademacher_draw_is_jaxs(seed, shape, dtype):
    ref = np.asarray(jax.random.rademacher(jax.random.PRNGKey(seed),
                                           shape)).astype(dtype)
    got = jax_rademacher(seed, shape, dtype)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    assert_array_equal(got, ref)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("d", [2, 3])
def test_grid_and_interpolation_are_gpim_tpus(d, dtype):
    X, mask = _points(300, d)
    X = X.astype(dtype)
    for ratio in (1.0, 1.7):
        ref = jski.choose_grid(X, ratio=ratio)
        got = ski.choose_grid(X, ratio=ratio)
        for a, b in zip(got, ref):
            assert a.dtype == b.dtype
            assert_array_equal(a, b)
    for a, b in zip(ski.build_interp(X, got, mask) + ski.build_interp(X, got)
                    + ski.build_interp_sep(X, got),
                    jski.build_interp(X, ref, mask) + jski.build_interp(X, ref)
                    + jski.build_interp_sep(X, ref)):
        assert a.dtype == b.dtype
        assert_array_equal(a, b)


def _operator(d, n=120, seed=0):
    X, mask = _points(n, d, seed)
    grids = ski.choose_grid(X, ratio=1.5)
    idx, wgt = ski.build_interp(X, grids, mask)
    gshape = tuple(len(g) for g in grids)
    p = {"lengthscale": np.linspace(1.5, 2.5, d), "variance": 1.3}
    fj = jski.grid_kernel_factors(
        "RBF", {k: jnp.asarray(v) for k, v in p.items()},
        [jnp.asarray(g) for g in grids])
    fp = ski.grid_kernel_factors("RBF", {k: _t(v) for k, v in p.items()},
                                 [_t(g) for g in grids])
    return X, mask, grids, gshape, idx, wgt, fj, fp


@pytest.mark.parametrize("d", [2, 3])
def test_interp_mvm_matches_both_forms_of_ski_mvm(d):
    """Batch-first here, columns in gpim_tpu: the plain form on the points
    as given and the sorted-corner form on the points sorted by their
    lower corner."""
    X, mask, grids, gshape, idx, wgt, fj, fp = _operator(d)
    V = np.random.RandomState(1).randn(len(X), 4)
    mvm = ski.make_interp_mvm(_t(idx, torch.int64), _t(wgt), gshape)
    got = mvm(fp, _t(0.3), _t(V.T)).numpy().T
    jmvm = jax.jit(jski.ski_mvm, static_argnames=("grid_shape",
                                                  "sorted_corners"))
    plain = jmvm(fj, jnp.asarray(idx), jnp.asarray(wgt), 0.3, gshape,
                 jnp.asarray(V))
    _close(got, plain, 1e-12)
    perm = np.argsort(idx[:, 0], kind="stable")
    srt = jmvm(fj, jnp.asarray(idx[perm]), jnp.asarray(wgt[perm]), 0.3,
               gshape, jnp.asarray(V[perm]), sorted_corners=True)
    _close(got[perm], srt, 1e-12)
    _close(mvm(fp, _t(0.3), _t(V[:, 0])).numpy(), plain[:, 0], 1e-12)


@pytest.mark.parametrize("d", [2, 3])
def test_kron_eig_root_matches_gpim_tpu(d):
    """The same root up to the eigenvectors' signs (compared as L L^T), the
    padded rows exactly zero."""
    X, mask, grids, gshape, idx, wgt, fj, fp = _operator(d, n=60)
    i0, w0 = ski.build_interp_sep(X, grids)
    p = {"lengthscale": jnp.asarray(np.linspace(1.5, 2.5, d)),
         "variance": jnp.asarray(1.3)}
    ref = np.asarray(jski.kron_eig_root(
        "RBF", p, [jnp.asarray(g) for g in grids], gshape, jnp.asarray(i0),
        jnp.asarray(w0), 40, mask=jnp.asarray(mask)))
    got = ski.kron_eig_root(ski._kron_top_modes(fp, 40),
                            _t(i0, torch.int64), _t(w0), _t(mask)).numpy()
    assert got.shape == ref.shape == (len(X), 40)
    _close(got @ got.T, ref @ ref.T, 1e-10)
    assert np.abs(got[mask == 0]).max() == 0.0


def test_lanczos_matches_gpim_tpu():
    X, mask, grids, gshape, idx, wgt, fj, fp = _operator(2, n=80)
    v0 = jax_rademacher(5, (len(X),))
    Qj, Tj = jski.lanczos(
        lambda v: jski.ski_mvm(fj, jnp.asarray(idx), jnp.asarray(wgt), 0.2,
                               gshape, v), jnp.asarray(v0), 12)
    mvm = ski.make_interp_mvm(_t(idx, torch.int64), _t(wgt), gshape)
    Q, T = ski.lanczos(lambda v: mvm(fp, _t(0.2), v), _t(v0), 12)
    _close(T.numpy(), Tj, 1e-9)
    _close(Q.numpy(), Qj, 1e-9)


def _engines(dtype, n=200, d=2, precond_rank=24):
    X, mask = _points(n, d, seed=2)
    y = np.sin(X[:, 0] / 2.0) + np.cos(X[:, 1] / 3.0)
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    X, mask, y = (a.astype(np_dtype) for a in (X, mask, y * mask))
    grids = ski.choose_grid(X[mask > 0], ratio=1.0)
    kw = dict(cg_iters=60, precond_rank=precond_rank, seed=3)
    jeng = jski_model.SKIEngine("RBF", X, mask, grids, **kw)
    peng = ski_model.SKIEngine("RBF", X, mask, grids, dtype, "cpu", **kw)
    return X, mask, y, grids, jeng, peng


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_loss_and_gradients_match_jax_custom_vjp(dtype):
    """ski_model._loss (SKI marginal likelihood by split CG and SLQ, the
    surrogate backward, the padded-row and log-Jacobian terms) and its
    gradient in every parameter, from each package's own preconditioner."""
    X, mask, y, grids, jeng, peng = _engines(dtype)
    rtol = 1e-6 if dtype == torch.float64 else 1e-3
    np_dtype = X.dtype
    u0 = {"lengthscale": np.array([0.3, -0.2]),
          "outputscale": np.asarray(0.2), "noise": np.asarray(-2.0),
          "mean": np.asarray(0.1)}
    bounds = {"ls_lo": np.zeros(2), "ls_hi": np.full(2, 5.0)}
    ju = {k: jnp.asarray(v, np_dtype) for k, v in u0.items()}
    jb = {k: jnp.asarray(v, np_dtype) for k, v in bounds.items()}
    perm = jeng._perm
    Qj, lj = jski_model._build_precond(
        ju, jeng._grids, jeng._i0, jeng._w0, jeng._mask, jb, kernel="RBF",
        grid_shape=jeng.grid_shape, rank=jeng.precond_rank)
    lf = partial(jski_model._loss, kernel="RBF", grid_shape=jeng.grid_shape,
                 cg_iters=jeng.cg_iters, sorted_corners=True,
                 record_iters=True)
    (lossj, itj), gj = jax.jit(jax.value_and_grad(lf, has_aux=True))(
        ju, jeng._grids, jeng._idx, jeng._wgt, Qj, lj, jeng._g0,
        jnp.asarray(y[perm]), jnp.asarray(mask[perm]), jb,
        jnp.asarray(1e-5, np_dtype))
    pu = {k: _t(v, dtype).requires_grad_(True) for k, v in u0.items()}
    pb = {k: _t(v, dtype) for k, v in bounds.items()}
    Qp, lp = ski_model._build_precond(
        pu, peng._grids, peng._i0, peng._w0, peng._mask, pb, kernel="RBF",
        rank=peng.precond_rank)
    core = ski.ski_mll(peng._idx, peng._wgt, peng.grid_shape, peng.cg_iters,
                       peng._g0, return_iters=True)
    loss, it = ski_model._loss(
        pu, peng._grids, core, Qp, lp, _t(y, dtype)[peng._perm],
        _t(mask, dtype)[peng._perm], pb, 1e-5, kernel="RBF",
        record_iters=True)
    loss.backward()
    assert float(it) == float(itj) and 2 < float(it) < peng.cg_iters
    _close(loss.detach().numpy(), lossj, rtol)
    for k in u0:
        _close(pu[k].grad.numpy(), gj[k], rtol, k)


def test_engine_is_permutation_invariant():
    """The engine sorts its points internally: predictions do not depend
    on the order the caller gives the points in, and training stays
    finite and lowers the loss; 0 iterations give empty series."""
    rng = np.random.RandomState(3)
    n, d = 96, 2
    X = (rng.rand(n, d) * 5).astype(np.float32)
    yv = (np.sin(X[:, 0]) * np.cos(X[:, 1])
          + 0.05 * rng.randn(n)).astype(np.float32)
    mask = np.ones(n, np.float32)
    grids = ski.choose_grid(X, ratio=2.0)
    f32 = torch.float32
    u = {"lengthscale": torch.zeros(d), "noise": torch.tensor(0.0),
         "mean": torch.tensor(0.0), "outputscale": torch.tensor(0.0)}
    bounds = {"ls_lo": torch.tensor(0.05), "ls_hi": torch.tensor(10.0)}

    def run(Xo, yo):
        eng = ski_model.SKIEngine("RBF", Xo, mask, grids, f32, "cpu",
                                  cg_iters=96, precond_rank=32, seed=0)
        assert (eng._idx.diff(dim=0) >= 0).all()
        mean, var = eng.predict(u, _t(yo, f32), _t(mask, f32), bounds, 1e-6,
                                X[:8])
        return eng, mean.numpy(), var.numpy()

    eng, m1, v1 = run(X, yv)
    sh = np.random.RandomState(7).permutation(n)
    _, m2, v2 = run(X[sh], yv[sh])
    assert_allclose(m1, m2, rtol=1e-4, atol=1e-5)
    assert_allclose(v1, v2, rtol=1e-3, atol=1e-5)
    _, traj = eng.train(u, _t(yv, f32), _t(mask, f32), bounds, 0.05, 1e-6,
                        iterations=6)
    assert np.isfinite(traj["loss"].numpy()).all()
    assert traj["loss"][-1] < traj["loss"][0]
    u0, empty = eng.train(u, _t(yv, f32), _t(mask, f32), bounds, 0.05, 1e-6,
                          iterations=0)
    assert empty["lengthscale"].shape == (0, d)
    assert empty["noise"].shape == empty["loss"].shape == (0,)
    for k in u:
        assert torch.equal(u0[k], u[k])


# --------------------------------------------------------------------------
# skreconstructor on the off-lattice route
# --------------------------------------------------------------------------

def test_engine_training_series_and_cg_iters_match(cube_runs):
    """The series of run() at rtol 1e-6, the realized CG iterations of
    every step and the segments of the adaptive schedule exactly."""
    jm, pm = cube_runs["jm"], cube_runs["pm"]
    hp_j, hp = cube_runs["out_j"][2], cube_runs["out_p"][2]
    assert set(hp) == set(hp_j) == {"lengthscale", "noise"}
    for k in hp:
        assert hp[k].shape == hp_j[k].shape, k
        _close(hp[k], hp_j[k], 1e-6, k)
    _close(pm.losses, jm.losses, 1e-6)
    eng = pm._ski_engine
    assert_array_equal(eng.last_cg_iters,
                       np.concatenate(cube_runs["jit_segs"]))
    assert eng.last_segments == [len(s) for s in cube_runs["jit_segs"]]
    assert eng.grid_shape == jm._ski_engine.grid_shape == (10, 10, 10)
    assert eng.precond_rank == jm._ski_engine.precond_rank == 512
    for k, v in pm.u.items():
        _close(v.numpy(), jm.u[k], 1e-6, k)


def test_run_matches_gpim_tpu(cube_runs):
    """Mean and sd (the Nystrom variance) over the full cube."""
    mean_j, sd_j, _ = cube_runs["out_j"]
    mean, sd, _ = cube_runs["out_p"]
    assert mean.shape == sd.shape == SHAPE and mean.dtype == np.float64
    assert np.isfinite(mean).all() and np.isfinite(sd).all()
    _close(mean, mean_j, 1e-6)
    _close(sd, sd_j, 1e-6)
    assert np.sqrt(np.mean((mean - cube_runs["f"]) ** 2)) < 0.08


def test_lanczos_variance_path_matches_gpim_tpu(cube_runs):
    """At preconditioner rank 0 the solve is Jacobi-preconditioned CG and
    the variance LOVE's, from JAX's Rademacher start for the seed."""
    jm, pm = cube_runs["jm"], cube_runs["pm"]
    ranks = jm._ski_engine.precond_rank, pm._ski_engine.precond_rank
    jm._ski_engine.precond_rank = pm._ski_engine.precond_rank = 0
    try:
        out_j, out = jm.predict(), pm.predict()
    finally:
        jm._ski_engine.precond_rank, pm._ski_engine.precond_rank = ranks
    for a, b in zip(out, out_j):
        assert np.isfinite(a).all()
        _close(a, b, 1e-6)
    assert not np.allclose(out[1], cube_runs["out_p"][1])


def test_max_root_sets_the_lanczos_rank_and_caps_the_nystrom_rank(
        cube_runs):
    """max_root sets the Lanczos rank (at most n_pad) and caps the
    preconditioner and Nystrom rank, never raising it: the prediction is
    that of a model built with the capped rank."""
    pm = cube_runs["pm"]
    eng = pm._ski_engine
    full = pm.predict(max_root=1000)
    assert eng.precond_rank == 512 and eng.rank == 640
    got = pm.predict(max_root=24)
    assert eng.precond_rank == 24 and eng.rank == 24
    ref = gpim_tpu_torch.skreconstructor(
        cube_runs["X"], cube_runs["R"], cube_runs["Xf"], precision="double",
        use_gpu=False, **dict(KW, precond_rank=24))
    ref.u = pm.u
    for a, b in zip(got, ref.predict()):
        assert_array_equal(a, b)
    assert not np.allclose(got[1], full[1])
    pm.predict(max_root=1000)
    assert eng.precond_rank == 24
    eng.precond_rank, eng.rank = 512, 100


def test_checkpoints_load_across_packages(cube_runs, tmp_path):
    jm, pm = cube_runs["jm"], cube_runs["pm"]
    jm.save_model(str(tmp_path / "jax"))
    pm.load_model(str(tmp_path / "jax"))
    for a, b in zip(pm.predict(), jm.predict()):
        _close(a, b, 1e-6)
    pm.save_model(str(tmp_path / "port.npz"))
    jm.load_model(str(tmp_path / "port.npz"))
    for a, b in zip(pm.predict(), jm.predict()):
        _close(a, b, 1e-6)


def test_float32_run_on_scattered_points_matches_gpim_tpu():
    """Random 2D coordinates (no lattice), float32, rtol 1e-3; the NaN test
    row comes back NaN."""
    R, X, Xt = _scattered()
    kw = dict(KW, precision="single", iterations=4)
    kw.pop("lattice")
    jm = gpim_tpu.skreconstructor(X, R, Xt, **kw)
    pm = gpim_tpu_torch.skreconstructor(X, R, Xt, use_gpu=False, **kw)
    assert pm._ski_engine is not None and pm._mgrid_engine is None
    out_j, out = jm.run(), pm.run()
    for a, b in zip(out[:2], out_j[:2]):
        assert a.shape == (12, 12) and a.dtype == np.float32
        assert np.isnan(a[0]).all() and np.isfinite(a[1:]).all()
        _close(a[1:], b[1:], 1e-3)
    for k in out[2]:
        _close(out[2][k], out_j[2][k], 1e-3, k)


def test_update_data_moves_across_every_route():
    """Dense (below ski_min_points), off-lattice, exact Kronecker,
    off-lattice again and masked lattice: each update_data() rebuilds the
    route, the hyperparameters continue warm and the series runs on."""
    shape = (8, 8, 6)
    rng = np.random.RandomState(5)
    xx, yy, zz = np.meshgrid(*[np.arange(s, dtype=float) for s in shape],
                             indexing="ij")
    truth = np.sin(xx / 3.0) * np.cos(yy / 4.0) + 0.3 * np.sin(zz / 2.0)
    truth = (truth - truth.min()) / np.ptp(truth)
    R = truth + 0.02 * rng.randn(*shape)
    R.reshape(-1, shape[2])[rng.choice(64, 12, replace=False)] = np.nan
    thin = R.copy()
    thin.reshape(-1)[rng.permutation(R.size)[120:]] = np.nan
    Xf = jutils.get_full_grid(R)

    def bent(data):
        X = jutils.get_sparse_grid(data)
        X[0] = X[0] ** 1.2
        return X
    m = gpim_tpu_torch.skreconstructor(
        jutils.get_sparse_grid(thin), thin, Xf, kernel="RBF", iterations=3,
        use_gpu=False, precision="double", verbose=0, ski_min_points=256)
    routes = []
    for X, data in ((None, None), (bent(R), R), (Xf, truth), (bent(R), R),
                    (jutils.get_sparse_grid(R), R)):
        if data is not None:
            m.update_data(X, data)
        routes.append("kron" if m._kron_engine is not None else "mgrid"
                      if m._mgrid_engine is not None else "ski"
                      if m._ski_engine is not None else "dense")
        m.train()
    assert routes == ["dense", "ski", "kron", "ski", "mgrid"]
    assert m.hyperparams["lengthscale"].shape == (15, 3)
    assert m.losses.shape == (15,)
    mean, sd = m.predict()
    assert np.isfinite(mean).all() and np.isfinite(sd).all()
    assert np.sqrt(np.mean((mean - truth) ** 2)) < 0.1


# --------------------------------------------------------------------------
# K4's plain version and the rank-0 predict (the port's own)
# --------------------------------------------------------------------------

def _dense_w(idx, wgt, G):
    """W (n, G) from the corner indices and weights."""
    W = np.zeros((idx.shape[0], G))
    for s in range(idx.shape[1]):
        np.add.at(W, (np.arange(idx.shape[0]), idx[:, s]), wgt[:, s])
    return W


@pytest.mark.parametrize("b", [1, 9])
@pytest.mark.parametrize("d, n, ratio", [(2, 150, 1.7), (3, 90, 1.3)])
def test_interp_adjoint_plain_matches_a_dense_adjoint(d, n, ratio, b):
    """W^T v through the CSR layout against a dense numpy W^T v (1e-14 of
    the largest entry), on ragged grids (19^2 + padding, 8^3) whose cells
    are mostly empty; bit for bit the index_add_ expression it replaced;
    and a v that requires a gradient is refused rather than dropped."""
    X, mask = _points(n, d, seed=d)
    grids = ski.choose_grid(X, ratio=ratio)
    idx, wgt = ski.build_interp(X, grids, mask)
    G = int(np.prod([len(g) for g in grids]))
    idx_t, wgt_t = _t(idx, torch.int64), _t(wgt)
    lay = gk.interp_layout(idx_t, wgt_t, G)
    assert lay.rowptr.dtype == lay.src.dtype == torch.int32
    assert int(lay.rowptr[-1]) == idx.size and lay.G == G and lay.n == n
    counts = lay.rowptr.diff()
    assert (counts == 0).sum() > G // 3 and counts.max() > 2
    v = _t(np.random.RandomState(b).randn(b, n))
    got = gk.interp_adjoint(lay, v)
    ref = _dense_w(idx, wgt, G).T @ v.numpy().T
    assert got.shape == (G, b)
    _close(got.numpy(), ref, 1e-14)
    assert (got[counts == 0] == 0).all()
    old = v.new_zeros((G, b)).index_add_(
        0, idx_t.reshape(-1),
        (wgt_t[:, :, None] * v.mT[:, None, :]).reshape(idx.size, b))
    assert torch.equal(got, old)
    with pytest.raises(ValueError, match="gradient"):
        gk.interp_adjoint(lay, v.clone().requires_grad_(True))
    with torch.no_grad():
        gk.interp_adjoint(lay, v.clone().requires_grad_(True))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("b", [1, 9, 100])
@pytest.mark.parametrize("d, n, ratio, cluster, sort",
                         [(2, 150, 1.7, 0, False), (3, 90, 1.3, 0, False),
                          (2, 150, 1.7, 0, True), (3, 90, 1.3, 0, True),
                          (2, 400, 1.7, 300, True)])
def test_interp_adjoint_plain_sums_each_cell_in_entry_order(
        d, n, ratio, cluster, sort, b, dtype):
    """The order and rounding K4 reproduces on the card: the layout is a
    numpy recount of the corner indices (row pointers from a bincount,
    entries in a stable sort by cell; with the points sorted by their
    lower corner, as the SKI engine sorts them, each cell's first point
    of that corner, the corners' offsets, largest first, and the weights
    corner by corner in that order, else none of the three),
    and the plain version equals, bit for bit, a numpy sum over each cell's
    entries in increasing entry order from 0, each product and each sum
    rounded in ``dtype``; on ragged grids and on one where ``cluster``
    points share a cell."""
    X, mask = _points(n, d, seed=d + cluster)
    X[:cluster] = 5.01 + np.random.RandomState(1).rand(cluster, d) * 0.01
    grids = ski.choose_grid(X, ratio=ratio)
    idx, wgt = ski.build_interp(X, grids, mask)
    if sort:
        perm = np.argsort(idx[:, 0], kind="stable")
        idx, wgt, X = idx[perm], wgt[perm], X[perm]
    wgt = wgt.astype(dtype)
    G = int(np.prod([len(g) for g in grids]))
    lay = gk.interp_layout(_t(idx, torch.int64), torch.as_tensor(wgt), G)
    counts = np.bincount(idx.reshape(-1), minlength=G)
    order = np.argsort(idx.reshape(-1), kind="stable")
    assert_array_equal(lay.rowptr.numpy(), np.r_[0, np.cumsum(counts)])
    assert_array_equal(lay.src.numpy(), order // idx.shape[1])
    assert_array_equal(lay.wgt.numpy(), wgt.reshape(-1)[order])
    assert counts.max() >= max(cluster, 3)
    if sort:
        lower = np.bincount(idx[:, 0], minlength=G)
        assert_array_equal(lay.lcptr.numpy(), np.r_[0, np.cumsum(lower)])
        order = np.argsort(idx[0] - idx[0, 0])[::-1]
        assert lay.offsets == tuple(idx[0, order] - idx[0, 0])
        assert lay.lcptr.dtype == torch.int32
        assert_array_equal(lay.wrun.numpy(), wgt[:, order].T)
    else:
        assert lay.lcptr is None and lay.wrun is None \
            and lay.offsets is None
    v = np.random.RandomState(b).randn(b, n).astype(dtype)
    prods = lay.wgt.numpy()[:, None] * v.T[lay.src.numpy()]
    ref = np.zeros((G, b), dtype)
    start = lay.rowptr.numpy()[:-1]
    for j in range(counts.max()):
        cells = np.nonzero(counts > j)[0]
        ref[cells] = ref[cells] + prods[start[cells] + j]
    got = gk.interp_adjoint(lay, torch.as_tensor(v))
    assert got.dtype == torch.from_numpy(ref).dtype
    assert_array_equal(got.numpy(), ref)


def test_interp_layout_takes_no_corner_runs_when_corners_share_an_offset():
    """Points sorted by their lower corner, but on a grid with an axis of
    one point two corners land at one offset, so a cell's entries would
    interleave two runs: the layout keeps only its CSR form."""
    idx = torch.tensor([[0, 1, 1, 2], [1, 2, 2, 3]])
    lay = gk.interp_layout(idx, torch.rand(2, 4, dtype=torch.float64), 4)
    assert lay.lcptr is None and lay.wrun is None and lay.offsets is None
    assert_array_equal(lay.rowptr.numpy(), [0, 1, 4, 7, 8])


def _dense_rank0_mean(eng, u, y, mask, bounds, jitter, Xt):
    """The SKI mean w_*^T K_UU W^T (W K_UU W^T + noise I)^-1 yc by a dense
    solve, in the engine's sorted row order."""
    p = _constrain_task(u, bounds)
    factors = ski.grid_kernel_factors(
        "RBF", {"lengthscale": p["lengthscale"], "variance": p["variance"]},
        eng._grids)
    K = factors[0]
    for f in factors[1:]:
        K = torch.kron(K, f)
    G = K.shape[0]
    W = _t(_dense_w(eng._idx.numpy(), eng._wgt.numpy(), G))
    A = W @ K @ W.mT + (p["noise"] + jitter) * torch.eye(W.shape[0],
                                                          dtype=W.dtype)
    yc = (y[eng._perm] - p["mean"]) * mask[eng._perm]
    alpha = torch.linalg.solve(A, yc)
    t_idx, t_wgt = ski.build_interp(Xt, eng.grids_np)
    Wt = _t(_dense_w(t_idx, t_wgt, G))
    return (Wt @ (K @ (W.mT @ alpha)) + p["mean"]).numpy()


def test_rank0_predict_mean_matches_a_dense_solve(cube_runs):
    """At precond_rank 0 the cube's predict-time CG runs to its tolerance
    (not the training cap): its mean equals the dense solve of W K_UU W^T
    + noise I to rtol 1e-8 at the default cg_iterations."""
    pm = cube_runs["pm"]
    eng = pm._ski_engine
    assert eng.cg_iters == 64
    rank = eng.precond_rank
    eng.precond_rank = 0
    try:
        u = {k: v[0] for k, v in pm.u.items()}
        mean, _ = eng.predict(u, pm._yd, pm._maskd, pm._bounds(), pm.jitter,
                              pm.Xtest)
    finally:
        eng.precond_rank = rank
    ref = _dense_rank0_mean(eng, u, pm._yd, pm._maskd, pm._bounds(),
                            pm.jitter, pm.Xtest)
    assert 0 < eng.last_predict_cg_iters < ski.PREDICT_CG_ITERS
    _close(mean.numpy(), ref, 1e-8)


def test_rank0_predict_solve_runs_past_the_training_cap():
    """Scattered 2D points at noise 1e-3: the unpreconditioned predict
    solve needs far more than the training cap of 64 iterations, takes
    them under PREDICT_CG_ITERS, and its mean equals the dense solve to
    rtol 1e-8, while a solve stopped at 64 iterations is far from it."""
    rng = np.random.RandomState(4)
    n = 300
    X = rng.rand(n, 2) * 10.0
    y = _t(np.sin(X[:, 0] / 2.0) * np.cos(X[:, 1] / 3.0))
    mask = _t(np.ones(n))
    eng = ski_model.SKIEngine("RBF", X, np.ones(n), ski.choose_grid(X),
                              torch.float64, "cpu", precond_rank=0, seed=0)
    assert eng.cg_iters == 64
    bounds = {"ls_lo": _t(np.zeros(2)), "ls_hi": _t(np.full(2, 10.0))}
    from gpim_tpu_torch.kernels.transforms import (interval_inverse,
                                                   positive_inverse)
    u = {"lengthscale": interval_inverse(_t([2.0, 2.0]), bounds["ls_lo"],
                                         bounds["ls_hi"]),
         "outputscale": positive_inverse(_t(1.0)),
         "noise": positive_inverse(_t(1e-3)), "mean": _t(0.1)}
    Xt = X[:40] + 0.05
    mean, var = eng.predict(u, y, mask, bounds, 1e-6, Xt)
    assert 64 < eng.last_predict_cg_iters < ski.PREDICT_CG_ITERS
    ref = _dense_rank0_mean(eng, u, y, mask, bounds, 1e-6, Xt)
    _close(mean.numpy(), ref, 1e-8)
    assert np.isfinite(var.numpy()).all() and (var.numpy() > 0).all()
    short = ski.PREDICT_CG_ITERS
    try:
        ski.PREDICT_CG_ITERS = 64
        capped, _ = eng.predict(u, y, mask, bounds, 1e-6, Xt)
    finally:
        ski.PREDICT_CG_ITERS = short
    assert np.abs(capped.numpy() - ref).max() > 1e-6 * np.abs(ref).max()
