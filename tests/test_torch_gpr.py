"""
gpim_tpu_torch.reconstructor (exact and sparse branches) against
gpim_tpu.reconstructor on the same data: the twin of tests/test_gpr.py for
the port, plus checkpoint interchange from the JAX package to the port,
and the reference's fixes pinned on the port (a double checkpoint loaded
into a single model, the f32 predictive sd in the cancellation regime).
"""

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

import gpim_tpu
from gpim_tpu import utils as jutils

import gpim_tpu_torch
from gpim_tpu_torch.parallel.mesh import LocalMesh
from gpim_tpu_torch import utils
from gpim_tpu_torch.utils import profiling
from test_torch_cuda_kernels import sd_cancellation_case

KERNELS = ["RBF", "Matern52", "RationalQuadratic"]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def get_dummy_data(seed=0, nan_holes=200):
    """20x20 Gaussian bump with random NaN punch-outs (test_gpr.py:18-27)."""
    rng = np.random.RandomState(seed)
    h = 5
    xx, yy = np.meshgrid(np.arange(0, 100, h), np.arange(0, 100, h))
    Z = np.exp(-((xx - 25) ** 2 + (yy - 50) ** 2) / 300)
    for _ in range(nan_holes):
        Z[rng.randint(Z.shape[0]), rng.randint(Z.shape[1])] = np.nan
    return Z


@pytest.mark.parametrize("precision", ["double", "single"])
@pytest.mark.parametrize("kernel", KERNELS)
def test_run_matches_gpim_tpu(kernel, precision):
    R = get_dummy_data()
    X, X_full = utils.get_sparse_grid(R), utils.get_full_grid(R)
    kw = dict(kernel=kernel, iterations=10, learning_rate=0.1, verbose=0,
              precision=precision, use_gpu=False)
    mean, sd, hp = gpim_tpu_torch.reconstructor(X, R, X_full, **kw).run()
    mean_j, sd_j, hp_j = gpim_tpu.reconstructor(X, R, X_full, **kw).run()
    assert mean.shape == sd.shape == R.shape
    assert not np.isnan(mean).any() and not np.isnan(sd).any()
    assert mean.dtype == (np.float64 if precision == "double"
                          else np.float32)
    rtol = 1e-6 if precision == "double" else 1e-3
    assert_allclose(mean, mean_j, rtol=rtol, atol=rtol * np.abs(mean_j).max())
    assert_allclose(sd, sd_j, rtol=rtol)
    for k in ("lengthscale", "variance", "noise"):
        assert hp[k].shape == hp_j[k].shape
        assert_allclose(hp[k], hp_j[k], rtol=rtol, err_msg=k)
    assert hp["inducing_points"].shape == (0,)


@pytest.mark.parametrize("precision", ["double", "single"])
@pytest.mark.parametrize("kernel", KERNELS)
def test_sparse_run_matches_gpim_tpu(kernel, precision):
    """Twin of test_gpr.py::test_gpr_sparse_shapes, held against gpim_tpu:
    mean, sd and every hyperparams key, the inducing points included."""
    R = get_dummy_data()
    X, X_full = utils.get_sparse_grid(R), utils.get_full_grid(R)
    kw = dict(kernel=kernel, sparse=True, indpoints=24, iterations=6,
              learning_rate=0.1, verbose=0, precision=precision,
              use_gpu=False)
    mean, sd, hp = gpim_tpu_torch.reconstructor(X, R, X_full, **kw).run()
    mean_j, sd_j, hp_j = gpim_tpu.reconstructor(X, R, X_full, **kw).run()
    assert mean.shape == sd.shape == R.shape
    assert not np.isnan(mean).any() and not np.isnan(sd).any()
    rtol = 1e-6 if precision == "double" else 1e-3
    assert_allclose(mean, mean_j, rtol=rtol, atol=rtol * np.abs(mean_j).max())
    assert_allclose(sd, sd_j, rtol=rtol)
    assert set(hp) == set(hp_j)
    n_obs = int((~np.isnan(R)).sum())
    assert hp["inducing_points"].shape == (6, len(range(0, n_obs,
                                                        n_obs // 24)), 2)
    for k in hp:
        assert hp[k].shape == hp_j[k].shape, k
        assert_allclose(hp[k], hp_j[k], rtol=rtol,
                        atol=rtol * np.abs(hp_j[k]).max(), err_msg=k)


def test_nan_rows_restored():
    """Predicting on a grid with NaN coordinates gives NaN there and the
    JAX package's values elsewhere (EI/POI rely on it)."""
    R = get_dummy_data()
    X, X_full = utils.get_sparse_grid(R), utils.get_full_grid(R)
    kw = dict(iterations=5, verbose=0, precision="double", use_gpu=False)
    model = gpim_tpu_torch.reconstructor(X, R, X_full, **kw)
    model_j = gpim_tpu.reconstructor(X, R, X_full, **kw)
    model.train()
    model_j.train()
    mean, sd = model.predict(X)
    mean_j, sd_j = model_j.predict(X)
    holes = np.isnan(R)
    assert np.isnan(mean[holes]).all() and np.isnan(sd[holes]).all()
    assert np.isfinite(mean[~holes]).all() and np.isfinite(sd[~holes]).all()
    assert_allclose(mean, mean_j, rtol=1e-7, atol=1e-12)
    assert_allclose(sd, sd_j, rtol=1e-7)


def test_gpim_tpu_checkpoint_predicts_equally(tmp_path):
    """gpim_tpu save_model -> port load_model -> equal predictions."""
    R = get_dummy_data(seed=1)
    X, X_full = utils.get_sparse_grid(R), utils.get_full_grid(R)
    kw = dict(kernel="RationalQuadratic", iterations=8, verbose=0,
              precision="double", use_gpu=False)
    model_j = gpim_tpu.reconstructor(X, R, X_full, **kw)
    model_j.train()
    path = tmp_path / "ckpt.npz"
    model_j.save_model(str(path))
    mean_j, sd_j = model_j.predict()

    model = gpim_tpu_torch.reconstructor(X, R, X_full, **kw)
    model.load_model(str(path))
    assert all(v.dtype == torch.float64 for v in model.u.values())
    mean, sd = model.predict()
    assert_allclose(mean, mean_j, rtol=1e-9, atol=1e-12)
    assert_allclose(sd, sd_j, rtol=1e-9)

    # and the port's own checkpoint round-trips
    model.save_model(str(tmp_path / "port"))
    other = gpim_tpu_torch.reconstructor(X, R, X_full, **kw)
    other.load_model(str(tmp_path / "port"))
    assert_allclose(other.predict()[0], mean, rtol=1e-12)
    with pytest.raises(ValueError):
        gpim_tpu_torch.reconstructor(X, R, X_full, kernel="RBF", verbose=0,
                                     use_gpu=False).load_model(str(path))


def test_gpim_tpu_sparse_checkpoint_predicts_equally(tmp_path):
    """A gpim_tpu sparse model's save_model (u_Xu included) -> the port's
    load_model -> equal predictions; an exact model refuses it."""
    R = get_dummy_data(seed=2)
    X, X_full = utils.get_sparse_grid(R), utils.get_full_grid(R)
    kw = dict(kernel="Matern52", sparse=True, indpoints=30, iterations=8,
              verbose=0, precision="double", use_gpu=False)
    model_j = gpim_tpu.reconstructor(X, R, X_full, **kw)
    model_j.train()
    path = tmp_path / "sparse.npz"
    model_j.save_model(str(path))
    mean_j, sd_j = model_j.predict()

    model = gpim_tpu_torch.reconstructor(X, R, X_full, **kw)
    model.load_model(str(path))
    assert_allclose(model.u["Xu"].numpy(), np.asarray(model_j.u["Xu"]),
                    rtol=0)
    mean, sd = model.predict()
    assert_allclose(mean, mean_j, rtol=1e-9, atol=1e-12)
    assert_allclose(sd, sd_j, rtol=1e-9)
    with pytest.raises(ValueError):
        gpim_tpu_torch.reconstructor(
            X, R, X_full, kernel="Matern52", verbose=0,
            use_gpu=False).load_model(str(path))


def test_exact_gp_matches_closed_form():
    """Predictive mean/sd equal the closed-form dense GP with the learned
    hyperparameters (twin of the test of the same name in test_gpr.py)."""
    rng = np.random.RandomState(1)
    X = rng.rand(40, 2) * 10
    y = np.sin(X[:, 0]) + np.cos(X[:, 1])
    Xt = rng.rand(17, 2) * 10
    model = gpim_tpu_torch.reconstructor(
        X.T.reshape(2, 40), y.copy(), None, kernel='RBF',
        lengthscale=[[0.1, 0.1], [5.0, 5.0]], iterations=5,
        learning_rate=0.05, verbose=0, precision="double", use_gpu=False)
    model.train()
    mean, sd = model.predict(Xt.T.reshape(2, 17))
    ls = model.hyperparams["lengthscale"][-1]
    var = model.hyperparams["variance"][-1]
    noise = model.hyperparams["noise"][-1]

    def k(a, b):
        d2 = ((a[:, None, :] / ls - b[None, :, :] / ls) ** 2).sum(-1)
        return var * np.exp(-0.5 * d2)

    K = k(X, X) + (noise + model.jitter) * np.eye(40)
    Ks = k(Xt, X)
    mean_ref = Ks @ np.linalg.solve(K, y)
    var_ref = var - np.einsum(
        "ij,ji->i", Ks, np.linalg.solve(K, Ks.T)) + noise
    assert_allclose(mean, mean_ref.reshape(mean.shape), rtol=1e-6, atol=1e-8)
    assert_allclose(sd, np.sqrt(var_ref).reshape(sd.shape),
                    rtol=1e-6, atol=1e-8)


def test_update_data_and_retrain():
    R = get_dummy_data()
    X, X_full = utils.get_sparse_grid(R), utils.get_full_grid(R)
    model = gpim_tpu_torch.reconstructor(X, R, X_full, iterations=2,
                                         verbose=0, use_gpu=False)
    with profiling.spans() as rec:
        model.train()
        R2 = R.copy()
        for i, j in np.argwhere(np.isnan(R2))[:5]:
            R2[i, j] = 0.5
        model.update_data(utils.get_sparse_grid(R2), R2)
        model.train()
    assert len(model.hyperparams["lengthscale"]) == 4
    assert len(model.losses) == 4
    mean, _ = model.predict()
    assert mean.shape == R.shape
    assert rec.summary()["recon.train"]["calls"] == 2
    assert_allclose(model.current_lengthscale(),
                    model.hyperparams["lengthscale"][-1], rtol=1e-12)


def test_single_vs_double_precision_tolerance():
    """f32 tracks f64 on the same data and training run (twin of
    test_gpr.py::test_single_vs_double_precision_tolerance)."""
    rng = np.random.RandomState(5)
    R = np.exp(-((np.indices((16, 16))[0] - 8.0) ** 2 +
                 (np.indices((16, 16))[1] - 6.0) ** 2) / 20.0)
    R = R + 0.01 * rng.randn(16, 16)
    R[rng.rand(16, 16) < 0.4] = np.nan
    X, Xf = utils.get_sparse_grid(R), utils.get_full_grid(R)
    out = {}
    for prec in ("single", "double"):
        out[prec] = gpim_tpu_torch.reconstructor(
            X, R.copy(), Xf, kernel="RBF", iterations=60,
            learning_rate=0.05, verbose=0, precision=prec,
            use_gpu=False).run()
    m32, s32, h32 = out["single"]
    m64, s64, h64 = out["double"]
    assert_allclose(m32, m64, rtol=0, atol=5e-3)
    assert_allclose(s32, s64, rtol=0, atol=5e-3)
    assert_allclose(h32["lengthscale"][-1], h64["lengthscale"][-1],
                    rtol=1e-2)
    assert_allclose(h32["noise"][-1], h64["noise"][-1], rtol=0, atol=1e-3)


def test_predict_without_test_grid_warns_and_uses_training_points():
    R = get_dummy_data()
    model = gpim_tpu_torch.reconstructor(utils.get_sparse_grid(R), R, None,
                                         iterations=2, verbose=0,
                                         use_gpu=False)
    model.train()
    with pytest.warns(UserWarning, match="training data"):
        mean, sd = model.predict()
    assert mean.shape == (len(model.X),)


def test_default_placement_and_dtype_on_cpu():
    R = get_dummy_data()
    model = gpim_tpu_torch.reconstructor(utils.get_sparse_grid(R), R,
                                         verbose=0, use_gpu=False)
    assert model.device.type == "cpu"
    assert model.dtype == torch.float64 and model.jitter == 1e-5
    tensors = (list(model.u.values()) + list(model._bounds().values())
               + [model._Xd, model._yd, model._maskd])
    assert all(t.device.type == "cpu" and t.dtype == torch.float64
               for t in tensors)
    assert model._Xd.shape[0] % 128 == 0


@pytest.mark.parametrize("bad", [
    {"mesh": LocalMesh(("task",))}, {"mesh": 4}, {"kernel": "Spectral"},
    {"use_gpu": True}])
def test_unported_or_unavailable_options_raise(bad, monkeypatch):
    """An unknown kernel and a missing card raise; since the parallel
    layer, mesh= raises only for a mesh without a 'grid' axis or an integer
    other than the world size (1 without a process group)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    R = get_dummy_data()
    exc = {"use_gpu": RuntimeError, "mesh": ValueError}.get(
        next(iter(bad)), NotImplementedError)
    with pytest.raises(exc):
        gpim_tpu_torch.reconstructor(utils.get_sparse_grid(R), R,
                                     verbose=0, **{"use_gpu": False, **bad})


def test_default_device_is_the_card_and_raises_without_one(monkeypatch):
    """Built without use_gpu, the model asks for the CUDA device: with none
    it raises instead of quietly running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    R = get_dummy_data()
    with pytest.raises(RuntimeError, match="use_gpu=False"):
        gpim_tpu_torch.reconstructor(utils.get_sparse_grid(R), R, verbose=0)


def test_step_raises_until_gpbayes_is_ported():
    """step() raised NotImplementedError until the gpbayes slice was
    ported; now it trains, predicts and ranks as gpim_tpu's does (default
    acquisition: the predictive sd)."""
    R = get_dummy_data()
    X, X_full = utils.get_sparse_grid(R), utils.get_full_grid(R)
    kw = dict(iterations=5, verbose=0, precision="double", use_gpu=False)
    vals, inds, mean, sd = gpim_tpu_torch.reconstructor(
        X, R, X_full, **kw).step(batch_size=10)
    vals_j, inds_j, mean_j, sd_j = gpim_tpu.reconstructor(
        X, R, X_full, **kw).step(batch_size=10)
    assert inds == inds_j and len(inds) == 10
    assert mean.shape == sd.shape == (R.size,)
    assert_allclose(vals, vals_j, rtol=1e-6)
    assert_allclose(vals, sd[np.ravel_multi_index(np.array(inds).T,
                                                  R.shape)], rtol=0)
    assert_allclose(mean, mean_j, rtol=1e-6, atol=1e-6 * np.abs(mean_j).max())


def test_sparse_default_inducing_points_and_verbose_print(capsys):
    """indpoints=None takes a tenth of the observations, as gpim_tpu does,
    and verbose=2 prints their count."""
    R = get_dummy_data()
    X = utils.get_sparse_grid(R)
    kw = dict(sparse=True, verbose=2, use_gpu=False)
    model = gpim_tpu_torch.reconstructor(X, R, **kw)
    model_j = gpim_tpu.reconstructor(X, R, **kw)
    assert_allclose(model.u["Xu"].numpy(), np.asarray(model_j.u["Xu"]),
                    rtol=0)
    out = capsys.readouterr().out.splitlines()
    line = "# of inducing points for sparse GP regression: %d" % len(
        model.u["Xu"])
    assert out.count(line) == 2


def test_same_grids_as_gpim_tpu_utils():
    R = get_dummy_data()
    assert np.array_equal(utils.get_sparse_grid(R), jutils.get_sparse_grid(R),
                          equal_nan=True)


def test_load_model_casts_to_model_dtype(tmp_path):
    """tests/test_round2_fixes.py's fix on the port: a double checkpoint
    loaded into a single model casts every parameter and bound to
    float32, and the model predicts finite values."""
    R = get_dummy_data(seed=3, nan_holes=60)
    X, X_full = utils.get_sparse_grid(R), utils.get_full_grid(R)
    kw = dict(iterations=2, verbose=0, use_gpu=False)
    m64 = gpim_tpu_torch.reconstructor(X, R, X_full, precision="double",
                                       **kw)
    m64.train()
    path = str(tmp_path / "ck.npz")
    m64.save_model(path)
    m32 = gpim_tpu_torch.reconstructor(X, R, X_full, precision="single",
                                       **kw)
    m32.load_model(path)
    for k, v in m32.u.items():
        assert v.dtype == torch.float32, (k, v.dtype)
    for k, v in m32._bounds_np.items():
        assert v.dtype == np.float32, (k, v.dtype)
    assert all(v.dtype == torch.float32 for v in m32._bounds().values())
    mean, sd = m32.predict(verbose=0)
    assert mean.dtype == sd.dtype == np.float32
    assert np.isfinite(mean[~np.isnan(mean)]).all()


def test_predictive_sd_f32_small_noise_long_lengthscale():
    """tests/test_round3_fixes.py's case on the port's CPU path: the f32
    explicit-inverse predict against a float64 Cholesky twin, the mean
    within 1e-3 of its scale, the sd within 5e-3 of the prior sd and never
    negative (tests/test_torch_cuda_kernels.py has its card twin)."""
    mean_err, sd_err, sd_min = sd_cancellation_case(torch.device("cpu"))
    assert mean_err < 1e-3 and sd_err < 5e-3 and sd_min >= 0.0
