"""
gpim_tpu_torch.skreconstructor and the modules beneath it against gpim_tpu
on the same inputs (twins of tests/test_skgpr.py and of the Kronecker
routing test of tests/test_kron_exact.py): the spectral mixture kernel,
mll_from_gram and the spectral initialisation (values and gradients),
run() on every ported route (dense RBF and Matern52, spectral, exact
Kronecker on a small full grid with ski_min_points lowered: trajectories,
losses, mean and sd at rtol 1e-6 in float64 and 1e-3 in float32),
checkpoints read across packages both ways, the no-Xtest warning, NaN test
rows, step(), the options that raise and the routing of large masked
and off-lattice data.
"""

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

import jax
import jax.numpy as jnp

import gpim_tpu
from gpim_tpu import utils as jutils
from gpim_tpu.gpreg import engine as jengine
from gpim_tpu.gpreg import structured as jstructured
from gpim_tpu.kernels import functional as jfunctional

import gpim_tpu_torch
from gpim_tpu_torch.gpreg import engine, structured
from gpim_tpu_torch.kernels import functional

from tests.test_gpr import get_dummy_data

RTOL = {"double": 1e-6, "single": 1e-3}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _t(a, requires_grad=False):
    return torch.as_tensor(np.asarray(a)).requires_grad_(requires_grad)


def _close(got, ref, rtol, err_msg=""):
    ref = np.asarray(ref)
    assert_allclose(np.asarray(got), ref, rtol=rtol,
                    atol=rtol * max(np.abs(ref).max(), 1e-30),
                    err_msg=err_msg)


def _grid_data(seed=0, dims=(12, 12, 8)):
    """A smooth full 3D grid in [0, 1] with a little noise (the data of
    tests/test_kron_exact.py's routing test, smaller)."""
    rng = np.random.RandomState(seed)
    t = np.linspace(0, 4, dims[0])
    R = (np.sin(t)[:, None, None] * np.cos(t)[None, :, None]
         * np.linspace(1, 2, dims[2])[None, None, :])
    R = R + 0.01 * rng.randn(*R.shape)
    return (R - R.min()) / np.ptp(R)


def _sm_params(rng, Q=3, d=2):
    return {"weights": rng.rand(Q) + 0.2, "means": rng.rand(Q, d) * 0.3,
            "scales": rng.rand(Q, d) * 0.2 + 0.05}


# --------------------------------------------------------------------------
# the pieces: spectral kernel, mll_from_gram, spectral initialisation
# --------------------------------------------------------------------------

def test_spectral_mixture_and_its_gradient_match_gpim_tpu():
    rng = np.random.RandomState(0)
    X1, X2 = rng.rand(30, 2) * 8, rng.rand(20, 2) * 8
    p = _sm_params(rng)
    W = rng.randn(30, 20)
    pt = {k: _t(v, True) for k, v in p.items()}
    K = functional.get_kernel_fn("Spectral")(pt, _t(X1), _t(X2))
    (K * _t(W)).sum().backward()
    pj = {k: jnp.asarray(v) for k, v in p.items()}
    Kj = jfunctional.spectral_mixture(pj, jnp.asarray(X1), jnp.asarray(X2))
    grads = jax.grad(lambda q: jnp.sum(jfunctional.spectral_mixture(
        q, jnp.asarray(X1), jnp.asarray(X2)) * jnp.asarray(W)))(pj)
    assert_allclose(K.detach().numpy(), np.asarray(Kj), rtol=1e-12,
                    atol=1e-14)
    for k in p:
        assert_allclose(pt[k].grad.numpy(), np.asarray(grads[k]),
                        rtol=1e-10, atol=1e-12, err_msg=k)
    diag = functional.kernel_diag("Spectral", pt, _t(X1))
    assert_allclose(diag.detach().numpy(), np.asarray(jfunctional.kernel_diag(
        "Spectral", {k: jnp.asarray(v) for k, v in p.items()},
        jnp.asarray(X1))), rtol=1e-14)


def test_mll_from_gram_and_its_gradient_match_gpim_tpu():
    """Value, Cholesky status and the closed-form dK, dnoise, dym, with
    padding rows masked out, against JAX's custom VJP."""
    rng = np.random.RandomState(1)
    n, n_obs = 40, 31
    X = rng.rand(n, 2) * 5
    K = np.exp(-0.5 * ((X[:, None] - X[None]) ** 2).sum(-1) / 1.5 ** 2)
    mask = np.zeros(n)
    mask[:n_obs] = 1.0
    ym = rng.randn(n) * mask
    Kt, nt, yt = _t(K, True), _t(0.05, True), _t(ym, True)
    nll, info = engine.mll_from_gram(Kt, nt, yt, _t(mask), 1e-5)
    nll.backward()
    ref, g = jax.value_and_grad(jengine.mll_from_gram, argnums=(0, 1, 2))(
        jnp.asarray(K), jnp.asarray(0.05), jnp.asarray(ym),
        jnp.asarray(mask), jnp.asarray(1e-5))
    assert int(info) == 0
    assert_allclose(nll.item(), float(ref), rtol=1e-12)
    for got, want in zip((Kt.grad, nt.grad, yt.grad), g):
        assert_allclose(got.numpy(), np.asarray(want), rtol=1e-9,
                        atol=1e-12)


@pytest.mark.parametrize("precision", ["double", "single"])
def test_init_spectral_params_are_gpim_tpu_s(precision):
    """numpy's default_rng(seed) in both packages: the same numbers."""
    R = get_dummy_data()
    X_np, y_np = jutils.prepare_training_data(jutils.get_sparse_grid(R), R,
                                              precision=precision)
    dt = np.float64 if precision == "double" else np.float32
    for seed in (0, 3):
        got = structured.init_spectral_params(X_np, y_np, 4, seed, dt,
                                              torch.device("cpu"))
        ref = jstructured.init_spectral_params(X_np, y_np, 4, seed, dt)
        assert set(got) == set(ref)
        for k in ref:
            assert got[k].dtype == {np.float64: torch.float64,
                                    np.float32: torch.float32}[dt]
            assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                            rtol=1e-15 if dt == np.float64 else 1e-6,
                            err_msg=k)


# --------------------------------------------------------------------------
# run() on every ported route against gpim_tpu
# --------------------------------------------------------------------------

def _route_data(route):
    if route == "kron":
        R = _grid_data()
        X = jutils.get_full_grid(R)
        return X, R, X, dict(ski_min_points=256)
    R = get_dummy_data()
    return jutils.get_sparse_grid(R), R, jutils.get_full_grid(R), {}


RUNS = [("dense", "RBF", "double"), ("dense", "Matern52", "double"),
        ("spectral", "Spectral", "double"), ("kron", "RBF", "double"),
        ("kron", "Matern52", "double"),
        ("dense", "RBF", "single"), ("spectral", "Spectral", "single"),
        ("kron", "Matern52", "single")]


@pytest.mark.parametrize("route, kernel, precision", RUNS)
def test_run_matches_gpim_tpu(route, kernel, precision):
    X, R, Xt, extra = _route_data(route)
    kw = dict(kernel=kernel, iterations=5, learning_rate=0.1, verbose=0,
              precision=precision, **extra)
    if kernel == "Spectral":
        kw["n_mixtures"] = 3
    jm = gpim_tpu.skreconstructor(X, R, Xt, **kw)
    pm = gpim_tpu_torch.skreconstructor(X, R, Xt, use_gpu=False, **kw)
    assert (pm._kron_engine is not None) == (route == "kron") == (
        jm._kron_engine is not None)
    mean_j, sd_j, hp_j = jm.run()
    mean, sd, hp = pm.run()
    assert mean.shape == sd.shape == R.shape
    assert mean.dtype == (np.float64 if precision == "double"
                          else np.float32)
    assert not np.isnan(mean).any() and not np.isnan(sd).any()
    rtol = RTOL[precision]
    _close(mean, mean_j, rtol)
    _close(sd, sd_j, rtol)
    assert set(hp) == set(hp_j)
    for k in hp:
        assert np.shape(hp[k]) == np.shape(hp_j[k]), k
        _close(hp[k], hp_j[k], rtol, k)
    _close(pm.losses, jm.losses, rtol)


@pytest.mark.parametrize("route, kernel", [
    ("dense", "RBF"), ("spectral", "Spectral"), ("kron", "Matern52")])
def test_checkpoints_load_across_packages(tmp_path, route, kernel):
    """A gpim_tpu checkpoint predicts in the port as it does in gpim_tpu,
    and the port's checkpoint in gpim_tpu."""
    X, R, Xt, extra = _route_data(route)
    kw = dict(kernel=kernel, iterations=3, verbose=0, precision="double",
              **extra)
    jm = gpim_tpu.skreconstructor(X, R, Xt, **kw)
    pm = gpim_tpu_torch.skreconstructor(X, R, Xt, use_gpu=False, **kw)
    jm.train()
    jm.save_model(str(tmp_path / "jax"))
    pm.load_model(str(tmp_path / "jax"))
    assert all(t.dtype == torch.float64 for t in pm.u.values())
    for got, ref in zip(pm.predict(), jm.predict()):
        _close(got, ref, 1e-6)
    pm.train(iterations=3)
    pm.save_model(str(tmp_path / "port.npz"))
    jm2 = gpim_tpu.skreconstructor(X, R, Xt, **kw)
    jm2.load_model(str(tmp_path / "port.npz"))
    for got, ref in zip(pm.predict(), jm2.predict()):
        _close(got, ref, 1e-6)
    other = gpim_tpu_torch.skreconstructor(
        X, R, Xt, use_gpu=False, verbose=0,
        kernel="Matern52" if kernel == "RBF" else "RBF", **extra)
    with pytest.raises(ValueError, match="different model configuration"):
        other.load_model(str(tmp_path / "port.npz"))


# --------------------------------------------------------------------------
# surface: warnings, NaN rows, step(), routes, what raises
# --------------------------------------------------------------------------

def test_predict_without_test_grid_warns_and_nan_rows_stay_nan():
    """Xtest=None predicts at the training points with a UserWarning (a
    crash in the reference, skgpr.py:118-120); NaN test rows come back NaN
    and the others as gpim_tpu predicts them."""
    R = get_dummy_data()
    X = jutils.get_sparse_grid(R)
    m = gpim_tpu_torch.skreconstructor(X, R, None, iterations=1, verbose=0,
                                       use_gpu=False)
    m.train()
    with pytest.warns(UserWarning, match="training data"):
        mean, sd = m.predict()
    assert mean.shape == sd.shape == (m.X.shape[0],)
    jm = gpim_tpu.skreconstructor(X, R, None, iterations=1, verbose=0)
    jm.train()
    got = m.predict(X, num_batches=3)
    ref = jm.predict(X)
    nan = np.isnan(R)
    for a, b in zip(got, ref):
        assert np.isnan(a[nan]).all() and not np.isnan(a[~nan]).any()
        _close(a[~nan], b[~nan], 1e-6)


def test_step_raises_for_structured_and_spectral_and_ranks_on_dense():
    R = get_dummy_data()
    X, Xt = jutils.get_sparse_grid(R), jutils.get_full_grid(R)
    for kw in (dict(kernel="RBF"), dict(kernel="Spectral", ski=False)):
        m = gpim_tpu_torch.skreconstructor(X, R, Xt, verbose=0,
                                           use_gpu=False, **kw)
        with pytest.raises(NotImplementedError, match="structured or "
                           "spectral"):
            m.step()
    kw = dict(kernel="RBF", ski=False, iterations=3, verbose=0,
              precision="double")
    got = gpim_tpu_torch.skreconstructor(X, R, Xt, use_gpu=False,
                                         **kw).step(batch_size=5)
    ref = gpim_tpu.skreconstructor(X, R, Xt, **kw).step(batch_size=5)
    np.testing.assert_array_equal(got[1], ref[1])
    for a, b in zip((got[0],) + got[2:], (ref[0],) + ref[2:]):
        _close(a, b, 1e-6)


def test_routes_follow_gpim_tpu():
    """The exact Kronecker engine on a full grid at or above
    ski_min_points, the dense engine below it or with ski=False."""
    R = _grid_data()
    X = jutils.get_full_grid(R)
    for kw, kron in ((dict(ski_min_points=256), True), ({}, False),
                     (dict(ski_min_points=256, ski=False), False)):
        pm = gpim_tpu_torch.skreconstructor(X, R, X, use_gpu=False,
                                            verbose=0, **kw)
        assert (pm._kron_engine is not None) is kron
        assert pm._kron_engine is None or pm._kron_engine.dims == R.shape


def _thinned(R, keep, seed=4):
    """R with all but ``keep`` of its points NaN."""
    R = R.copy()
    R.reshape(-1)[np.random.RandomState(seed).permutation(R.size)[keep:]] = \
        np.nan
    return R


def test_update_data_continues_warm_as_gpim_tpu_does():
    """New observations replace the data and keep the trained
    hyperparameters; the time series runs on."""
    Rg = _grid_data(dims=(8, 8, 6))
    Xg = jutils.get_full_grid(Rg)
    kw = dict(kernel="RBF", iterations=3, verbose=0, precision="double")
    R1, R2 = _thinned(Rg, 100), _thinned(Rg, 120, seed=5)
    models = [gpim_tpu.skreconstructor(jutils.get_sparse_grid(R1), R1, Xg,
                                       **kw),
              gpim_tpu_torch.skreconstructor(jutils.get_sparse_grid(R1), R1,
                                             Xg, use_gpu=False, **kw)]
    for m in models:
        m.train()
        m.update_data(jutils.get_sparse_grid(R2), R2)
        m.train()
    (mean_j, sd_j), (mean, sd) = (m.predict() for m in models)
    _close(mean, mean_j, 1e-6)
    _close(sd, sd_j, 1e-6)
    assert models[1].hyperparams["lengthscale"].shape == (6, 3)
    for k in ("lengthscale", "noise"):
        _close(models[1].hyperparams[k], models[0].hyperparams[k], 1e-6, k)


def test_update_data_across_routes_keeps_the_time_series():
    """From the dense route to the Kronecker route by update_data():
    gpim_tpu's hyperparams concatenation raises a KeyError (the dense
    trajectory's outputscale, gpim_tpu/gpreg/skgpr.py:316); the port keeps
    the keys every route records."""
    Rg = _grid_data(dims=(8, 8, 6))
    Xg = jutils.get_full_grid(Rg)
    R1 = _thinned(Rg, 120)         # 128 padded rows < ski_min_points
    kw = dict(kernel="RBF", iterations=3, verbose=0, precision="double",
              ski_min_points=256)
    jm = gpim_tpu.skreconstructor(jutils.get_sparse_grid(R1), R1, Xg, **kw)
    pm = gpim_tpu_torch.skreconstructor(jutils.get_sparse_grid(R1), R1, Xg,
                                        use_gpu=False, **kw)
    for m in (jm, pm):
        m.train()
        m.update_data(Xg, Rg)
        assert m._kron_engine is not None
    with pytest.raises(KeyError, match="outputscale"):
        jm.train()
    pm.train()
    assert pm.hyperparams["lengthscale"].shape == (6, 3)
    assert pm.losses.shape == (6,)
    mean, sd = pm.predict()
    assert np.isfinite(mean).all() and np.isfinite(sd).all()


def _off_lattice(X):
    """The sparse grid with its coordinates bent off any uniform lattice."""
    X = X.copy()
    X[0] = X[0] ** 1.2
    return X


@pytest.mark.parametrize("kwargs, coords, expect", [
    (dict(mesh=True, ski_min_points=256), None, "_mgrid_engine"),
    (dict(kernel="RationalQuadratic"), None, "RBF, Matern52, Spectral"),
    (dict(ski_min_points=256, lattice=False), None, "_ski_engine"),
    (dict(ski_min_points=256), _off_lattice, "_ski_engine"),
    (dict(ski_min_points=256), None, "_mgrid_engine"),
])
def test_unported_routes_and_options_raise(kwargs, coords, expect):
    """An unknown kernel raises when the model is built; mesh= no longer
    does (the parallel layer; tests/test_torch_parallel.py runs it on every
    route), and a large NaN-masked lattice with it still takes the
    masked-lattice engine; large
    data off a uniform lattice, or any with lattice=False, builds the
    off-lattice SKI engine, and a large NaN-masked lattice the
    masked-lattice engine."""
    R = _grid_data()
    R[np.random.RandomState(2).rand(*R.shape) < 0.3] = np.nan
    X = jutils.get_sparse_grid(R)
    if coords is not None:
        X = coords(X)
    if expect.startswith("_"):
        m = gpim_tpu_torch.skreconstructor(X, R, verbose=0, use_gpu=False,
                                           **kwargs)
        engines = ("_kron_engine", "_mgrid_engine", "_ski_engine")
        assert [getattr(m, e) is not None for e in engines] == [
            e == expect for e in engines]
        return
    with pytest.raises(NotImplementedError, match=expect):
        gpim_tpu_torch.skreconstructor(X, R, verbose=0, use_gpu=False,
                                       **kwargs)


def test_default_device_is_the_card_and_raises_without_one(monkeypatch):
    """Built without use_gpu, the model asks for the CUDA device: with none
    it raises instead of quietly running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    R = get_dummy_data()
    with pytest.raises(RuntimeError, match="use_gpu=False"):
        gpim_tpu_torch.skreconstructor(jutils.get_sparse_grid(R), R,
                                       verbose=0)
