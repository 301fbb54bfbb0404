"""
gpim_tpu_torch.vreconstructor against gpim_tpu.vreconstructor on the same
data and initial parameters: run() in both modes and both kernels
(trajectories, mean and sd; float64 rtol 1e-6, float32 rtol 1e-3), the
Monte-Carlo predictor, checkpoints read across packages both ways, and the
twins of tests/test_vgpr.py's surface checks.

Most comparisons carry gpim_tpu's initial parameters across through
``gpim_tpu_torch.convert``; the correlated mode's initial task factor F is
also held to ``jax.random.normal(PRNGKey(seed))``, and one correlated run
starts both packages from the seed alone.
"""

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

import gpim_tpu
from gpim_tpu import utils as jutils

import gpim_tpu_torch
from gpim_tpu_torch import convert, utils

KERNELS = ["RBF", "Matern52"]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def get_vector_data(seed=0, n1=12, n2=12, d=3, nan_frac=0.3):
    """Small 2D grid with d output channels and NaN-ed out pixels
    (tests/test_vgpr.py:15-28)."""
    rng = np.random.RandomState(seed)
    xx, yy = np.meshgrid(np.arange(n1, dtype=float),
                         np.arange(n2, dtype=float), indexing="ij")
    base = np.exp(-((xx - 5) ** 2 + (yy - 7) ** 2) / 8.0)
    Y = np.stack([base * (k + 1) * 0.3 + 0.05 * rng.rand(n1, n2)
                  for k in range(d)], axis=-1)
    drop = rng.rand(n1, n2) < nan_frac
    Y[drop] = np.nan
    X = jutils.get_full_grid(Y[..., 0]).copy()
    X[:, drop] = np.nan
    return X, Y


def _pair(X, Y, Xtest, **kw):
    """The gpim_tpu model and the port's on the CPU, the port holding
    gpim_tpu's initial parameters."""
    jm = gpim_tpu.vreconstructor(X, Y, Xtest, verbose=0, **kw)
    pm = gpim_tpu_torch.vreconstructor(X, Y, Xtest, verbose=0, use_gpu=False,
                                       **kw)
    pm.u = convert.params_from_numpy(
        {k: np.asarray(v) for k, v in jm.u.items()}, pm.device, pm.dtype)
    return jm, pm


def _close(got, ref, rtol, err_msg=""):
    assert_allclose(got, ref, rtol=rtol, atol=rtol * np.abs(ref).max(),
                    err_msg=err_msg)


# float32 on RBF, whose independent training takes K2 and K3 (in JAX, its
# batched Pallas kernels in interpret mode)
RUNS = ([(k, ind, "double") for k in KERNELS for ind in (True, False)]
        + [("RBF", True, "single"), ("RBF", False, "single")])


@pytest.mark.parametrize("kernel, independent, precision", RUNS)
def test_run_matches_gpim_tpu(kernel, independent, precision):
    X, Y = get_vector_data()
    Xtest = utils.get_full_grid(Y[..., 0])
    jm, pm = _pair(X, Y, Xtest, kernel=kernel, independent=independent,
                   iterations=5, precision=precision)
    mean_j, sd_j, hp_j = jm.run()
    mean, sd, hp = pm.run()
    assert mean.shape == sd.shape == (12, 12, 3)
    assert not np.isnan(mean).any() and not np.isnan(sd).any()
    assert mean.dtype == (np.float64 if precision == "double"
                          else np.float32)
    rtol = 1e-6 if precision == "double" else 1e-3
    _close(mean, mean_j, rtol)
    _close(sd, sd_j, rtol)
    assert set(hp) == set(hp_j)
    for k in hp:
        assert hp[k].shape == hp_j[k].shape, k
        _close(hp[k], hp_j[k], rtol, k)
    _close(pm.losses, jm.losses, rtol)


@pytest.mark.parametrize("independent", [True, False])
def test_options_match_gpim_tpu(independent):
    """isotropic (one lengthscale a channel, or one in all), task_rank 2
    (correlated mode) and num_batches (the prediction chunk size)."""
    X, Y = get_vector_data()
    Xtest = utils.get_full_grid(Y[..., 0])
    jm, pm = _pair(X, Y, Xtest, independent=independent, iterations=4,
                   precision="double", isotropic=True, task_rank=2,
                   num_batches=2)
    mean_j, sd_j, hp_j = jm.run()
    mean, sd, hp = pm.run()
    _close(mean, mean_j, 1e-6)
    _close(sd, sd_j, 1e-6)
    assert hp["lengthscale"].shape == hp_j["lengthscale"].shape == (
        (4, 3, 1) if independent else (4, 1))
    for k in hp:
        _close(hp[k], hp_j[k], 1e-6, k)


def test_monte_carlo_predict_matches_gpim_tpu():
    """predict(n_samples=...) draws the reference's estimator from
    default_rng(0) around the same closed-form posterior."""
    X, Y = get_vector_data()
    Xtest = utils.get_full_grid(Y[..., 0])
    jm, pm = _pair(X, Y, Xtest, independent=True, precision="double")
    mean_j, sd_j = jm.predict(n_samples=20)
    mean, sd = pm.predict(n_samples=20)
    _close(mean, mean_j, 1e-6)
    _close(sd, sd_j, 1e-6)
    exact, _ = pm.predict()
    assert not np.array_equal(mean, exact)


@pytest.mark.parametrize("independent", [True, False])
def test_checkpoints_load_across_packages(tmp_path, independent):
    """A gpim_tpu checkpoint predicts in the port as it does in gpim_tpu,
    and the port's checkpoint in gpim_tpu."""
    X, Y = get_vector_data()
    Xtest = utils.get_full_grid(Y[..., 0])
    kw = dict(independent=independent, iterations=3, precision="double")
    jm, pm = _pair(X, Y, Xtest, **kw)
    jm.train()
    jm.save_model(str(tmp_path / "jax"))
    pm.load_model(str(tmp_path / "jax"))
    assert all(t.dtype == torch.float64 for t in pm.u.values())
    for got, ref in zip(pm.predict(), jm.predict()):
        _close(got, ref, 1e-6)
    pm.train(iterations=3)
    pm.save_model(str(tmp_path / "port.npz"))
    jm2 = gpim_tpu.vreconstructor(X, Y, Xtest, verbose=0, **kw)
    jm2.load_model(str(tmp_path / "port.npz"))
    for got, ref in zip(pm.predict(), jm2.predict()):
        _close(got, ref, 1e-6)
    other = gpim_tpu_torch.vreconstructor(
        X, Y, Xtest, verbose=0, use_gpu=False, independent=not independent)
    with pytest.raises(ValueError, match="different model configuration"):
        other.load_model(str(tmp_path / "port.npz"))


def test_vgpr_nan_row_dropping():
    """Rows with any NaN channel are dropped (gprutils.py:53-55 parity);
    the independent mode pads them to a 128-row bucket with a mask."""
    X, Y = get_vector_data(nan_frac=0.5)
    m = gpim_tpu_torch.vreconstructor(X, Y, None, iterations=1, verbose=0,
                                      independent=True, use_gpu=False)
    complete = ~np.isnan(Y).any(-1)
    assert m.y.shape == (complete.sum(), 3)
    assert m._Xd.shape == (128, 2) and m._Yd.shape == (128, 3)
    assert int(m._maskd.sum()) == complete.sum()


def test_predict_without_test_grid_warns_and_chunks_by_num_batches():
    """Xtest=None predicts at the training points with a UserWarning;
    num_batches only sets the chunk size."""
    X, Y = get_vector_data()
    m = gpim_tpu_torch.vreconstructor(X, Y, None, independent=False,
                                      iterations=2, verbose=0, use_gpu=False)
    m.train()
    with pytest.warns(UserWarning, match="training data"):
        mean, sd = m.predict()
    assert mean.shape == sd.shape == (len(m.X), 3)
    mean3, sd3 = m.predict(num_batches=3)
    assert_allclose(mean3, mean, rtol=1e-12)
    assert_allclose(sd3, sd, rtol=1e-12)


def test_default_device_is_the_card_and_raises_without_one(monkeypatch):
    """Built without use_gpu, the model asks for the CUDA device: with none
    it raises instead of quietly running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X, Y = get_vector_data()
    with pytest.raises(RuntimeError, match="use_gpu=False"):
        gpim_tpu_torch.vreconstructor(X, Y, verbose=0)


@pytest.mark.parametrize("kwargs, exc, match", [
    (dict(mesh=3), ValueError, r"world size \(1\)"),
    (dict(kernel="RationalQuadratic"), NotImplementedError, "RBF, Matern52"),
])
def test_unported_options_raise(kwargs, exc, match):
    """An unknown kernel raises; since the parallel layer, mesh= raises
    only for an integer other than the world size (1 without a process
    group)."""
    X, Y = get_vector_data()
    with pytest.raises(exc, match=match):
        gpim_tpu_torch.vreconstructor(X, Y, verbose=0, use_gpu=False,
                                      **kwargs)


SEED_CASES = [(seed, rank, precision) for seed in (0, 1, 7, 123456)
              for rank in (1, 2) for precision in ("double", "single")]


@pytest.mark.parametrize("seed, rank, precision", SEED_CASES)
def test_correlated_task_factor_is_seeded(seed, rank, precision):
    """The initial F is gpim_tpu's 0.1 jax.random.normal(PRNGKey(seed))
    draw: float64 to 1e-12, float32 to rtol 1e-5 (XLA's float32 erf_inv
    is a polynomial)."""
    import jax
    X, Y = get_vector_data()
    np_dtype = np.float64 if precision == "double" else np.float32
    F = gpim_tpu_torch.vreconstructor(
        X, Y, verbose=0, use_gpu=False, seed=seed, task_rank=rank,
        precision=precision).u["F"]
    ref = 0.1 * np.asarray(jax.random.normal(
        jax.random.PRNGKey(seed), (3, rank), dtype=np_dtype))
    assert F.shape == (3, rank) and F.numpy().dtype == np_dtype
    assert_allclose(F.numpy(), ref,
                    rtol=1e-12 if precision == "double" else 1e-5)


def test_correlated_run_from_the_seed_alone_matches_gpim_tpu():
    """No parameter carried across: one seed starts both packages at the
    same point, and the runs agree to float64 round-off."""
    X, Y = get_vector_data()
    Xtest = utils.get_full_grid(Y[..., 0])
    kw = dict(independent=False, iterations=5, precision="double", seed=11,
              task_rank=2, verbose=0)
    mean_j, sd_j, hp_j = gpim_tpu.vreconstructor(X, Y, Xtest, **kw).run()
    mean, sd, hp = gpim_tpu_torch.vreconstructor(X, Y, Xtest, use_gpu=False,
                                                 **kw).run()
    _close(mean, mean_j, 1e-6)
    _close(sd, sd_j, 1e-6)
    for k in hp:
        _close(hp[k], hp_j[k], 1e-6, k)
