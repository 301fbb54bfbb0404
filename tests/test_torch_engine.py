"""
gpim_tpu_torch.gpreg.engine against gpim_tpu.gpreg.engine on the same
inputs: the masked MLL and its closed-form gradient, Adam trajectories and
chunked prediction, in float64 (tight) and float32 (where the JAX package
runs its Pallas kernels, in interpret mode on the CPU).
"""

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

import jax
import jax.numpy as jnp

from gpim_tpu.gpreg import engine as jengine

from gpim_tpu_torch.gpreg import engine

KERNELS = ["RBF", "Matern52", "RationalQuadratic"]
DTYPES = {"f64": (np.float64, torch.float64), "f32": (np.float32,
                                                       torch.float32)}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _problem(kernel, np_dtype, n_obs=100, bucket=128, d=2, iso=False,
             seed=0):
    """Padded training set, mask, unconstrained parameters and bounds, as
    numpy arrays of ``np_dtype``."""
    rng = np.random.RandomState(seed)
    X = rng.rand(n_obs, d) * 10
    y = np.sin(X[:, 0]) + np.cos(X[:, 1]) + 0.05 * rng.randn(n_obs)
    Xp, _ = jengine.pad_rows(X, bucket)
    yp, _ = jengine.pad_rows(y, bucket)
    mask = np.zeros(len(Xp))
    mask[:n_obs] = 1.0
    nls = 1 if iso else d
    u = {"lengthscale": np.full(nls, -0.4), "variance": np.asarray(0.3),
         "noise": np.asarray(-2.0)}
    if kernel == "RationalQuadratic":
        u["alpha"] = np.asarray(0.2)
    bounds = {"ls_lo": np.zeros(nls), "ls_hi": np.full(nls, 5.0),
              "var_lo": np.asarray(1e-4), "var_hi": np.asarray(10.0)}
    cast = lambda a: np.asarray(a, np_dtype)  # noqa: E731
    return (cast(Xp), cast(yp), cast(mask), {k: cast(v) for k, v in u.items()},
            {k: cast(v) for k, v in bounds.items()})


def _jax(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _torch(tree, requires_grad=False):
    return {k: torch.as_tensor(v).requires_grad_(requires_grad)
            for k, v in tree.items()}


def _jitter(np_dtype):
    return 1e-5 if np_dtype == np.float64 else 1e-4


@pytest.mark.parametrize("prec", ["f64", "f32"])
@pytest.mark.parametrize("kernel", KERNELS)
def test_exact_loss_and_gradient_match_jax(kernel, prec):
    np_dtype, _ = DTYPES[prec]
    X, y, mask, u, bounds = _problem(kernel, np_dtype)
    jitter = _jitter(np_dtype)
    loss_j, g_j = jax.value_and_grad(
        lambda uu: jengine.exact_loss(
            uu, jnp.asarray(X), jnp.asarray(y), jnp.asarray(mask),
            _jax(bounds), jnp.asarray(jitter, np_dtype), kernel=kernel))(
        _jax(u))
    ut = _torch(u, requires_grad=True)
    loss = engine.exact_loss(ut, torch.as_tensor(X), torch.as_tensor(y),
                             torch.as_tensor(mask), _torch(bounds), jitter,
                             kernel=kernel)
    loss.backward()
    rtol = 1e-9 if prec == "f64" else 1e-4
    assert_allclose(loss.item(), float(loss_j), rtol=rtol)
    for k in u:
        g = ut[k].grad.numpy()
        ref = np.asarray(g_j[k])
        assert_allclose(g, ref, rtol=rtol, atol=rtol * np.abs(ref).max(),
                        err_msg=k)


@pytest.mark.parametrize("kernel", KERNELS)
def test_autodiff_nll_matches_jax_and_closed_form(kernel):
    """_exact_nll_autodiff against the JAX twin, and autograd through the
    Cholesky against the closed-form backward."""
    X, y, mask, u, bounds = _problem(kernel, np.float64, n_obs=60, bucket=64)
    p_j = jengine.constrain(_jax(u), _jax(bounds))
    ref = jengine._exact_nll_autodiff(p_j, jnp.asarray(X), jnp.asarray(y),
                                      jnp.asarray(mask), 1e-5, kernel)
    Xt, yt, mt = (torch.as_tensor(a) for a in (X, y, mask))
    ut = _torch(u, requires_grad=True)
    nll, info = engine._exact_nll_autodiff(
        engine.constrain(ut, _torch(bounds)), Xt, yt, mt, 1e-5, kernel)
    assert info.item() == 0
    assert_allclose(nll.item(), float(ref), rtol=1e-10)
    nll.backward()
    uf = _torch(u, requires_grad=True)
    p = engine.constrain(uf, _torch(bounds))
    fast, _ = engine._NLLFast.apply(kernel, p["lengthscale"], p["variance"],
                                    p["noise"], p.get("alpha"), Xt, yt, mt,
                                    1e-5)
    fast.backward()
    for k in u:
        assert_allclose(uf[k].grad.numpy(), ut[k].grad.numpy(), rtol=1e-7,
                        atol=1e-10, err_msg=k)


def test_isotropic_lengthscale_gradient_matches_jax():
    X, y, mask, u, bounds = _problem("RBF", np.float64, iso=True)
    g_j = jax.grad(lambda uu: jengine.exact_loss(
        uu, jnp.asarray(X), jnp.asarray(y), jnp.asarray(mask),
        _jax(bounds), 1e-5, kernel="RBF"))(_jax(u))
    ut = _torch(u, requires_grad=True)
    engine.exact_loss(ut, torch.as_tensor(X), torch.as_tensor(y),
                      torch.as_tensor(mask), _torch(bounds), 1e-5,
                      kernel="RBF").backward()
    assert ut["lengthscale"].grad.shape == (1,)
    assert_allclose(ut["lengthscale"].grad.numpy(),
                    np.asarray(g_j["lengthscale"]), rtol=1e-9)


@pytest.mark.parametrize("prec", ["f64", "f32"])
@pytest.mark.parametrize("kernel", KERNELS)
def test_train_trajectory_matches_jax(kernel, prec):
    np_dtype, _ = DTYPES[prec]
    X, y, mask, u, bounds = _problem(kernel, np_dtype)
    jitter, iters = _jitter(np_dtype), 20
    u_j, traj_j = jengine.train(
        _jax(u), jnp.asarray(X), jnp.asarray(y), jnp.asarray(mask),
        _jax(bounds), jnp.asarray(0.1, np_dtype),
        jnp.asarray(jitter, np_dtype), kernel=kernel, iterations=iters,
        sparse=False)
    u_t, traj_t = engine.train(
        _torch(u), torch.as_tensor(X), torch.as_tensor(y),
        torch.as_tensor(mask), _torch(bounds), 0.1, jitter, kernel=kernel,
        iterations=iters)
    rtol = 1e-6 if prec == "f64" else 1e-3
    for k in ("loss", "lengthscale", "variance", "noise"):
        assert traj_t[k].shape[0] == iters
        assert_allclose(traj_t[k].numpy(), np.asarray(traj_j[k]), rtol=rtol,
                        err_msg=k)
    for k in u:
        assert_allclose(u_t[k].numpy(), np.asarray(u_j[k]), rtol=rtol,
                        atol=rtol, err_msg=k)


@pytest.mark.parametrize("prec", ["f64", "f32"])
@pytest.mark.parametrize("kernel", KERNELS)
def test_predict_exact_matches_jax(kernel, prec):
    np_dtype, _ = DTYPES[prec]
    X, y, mask, u, bounds = _problem(kernel, np_dtype)
    jitter = _jitter(np_dtype)
    rng = np.random.RandomState(7)
    Xt = (rng.rand(200, 2) * 10).astype(np_dtype)
    chunks, n_test = jengine.chunk_rows(Xt, 128)
    mean_j, var_j = jengine.predict_exact(
        _jax(u), jnp.asarray(X), jnp.asarray(y), jnp.asarray(mask),
        _jax(bounds), jnp.asarray(jitter, np_dtype), jnp.asarray(chunks),
        kernel=kernel)
    mean, var = engine.predict_exact(
        _torch(u), torch.as_tensor(X), torch.as_tensor(y),
        torch.as_tensor(mask), _torch(bounds), jitter,
        torch.as_tensor(chunks), kernel=kernel)
    assert mean.shape == var.shape == (256,)
    rtol = 1e-6 if prec == "f64" else 1e-3
    mean_j, var_j = np.asarray(mean_j), np.asarray(var_j)
    assert_allclose(mean.numpy()[:n_test], mean_j[:n_test], rtol=rtol,
                    atol=rtol * np.abs(mean_j).max())
    assert_allclose(var.numpy()[:n_test], var_j[:n_test], rtol=rtol)
    assert (var >= 0).all()


def test_padding_invariance():
    """Loss and predictions are identical whatever the padding bucket
    (twin of test_gpr.py::test_padding_invariance)."""
    rng = np.random.RandomState(2)
    n, d = 37, 2
    X = rng.rand(n, d)
    y = rng.rand(n)
    u = {"lengthscale": torch.zeros(d, dtype=torch.float64),
         "variance": torch.tensor(0.3, dtype=torch.float64),
         "noise": torch.tensor(-1.0, dtype=torch.float64)}
    bounds = {"ls_lo": torch.zeros(d, dtype=torch.float64),
              "ls_hi": torch.full((d,), 10.0, dtype=torch.float64),
              "var_lo": torch.tensor(1e-4, dtype=torch.float64),
              "var_hi": torch.tensor(10.0, dtype=torch.float64)}
    Xt, _ = engine.chunk_rows(rng.rand(20, d), 32)
    losses, means = [], []
    for bucket in (37, 64, 128):
        Xp, _ = engine.pad_rows(X, bucket)
        yp, _ = engine.pad_rows(y, bucket)
        mask = np.zeros(len(Xp))
        mask[:n] = 1.0
        args = (u, torch.as_tensor(Xp), torch.as_tensor(yp),
                torch.as_tensor(mask), bounds, 1e-6)
        losses.append(engine.exact_loss(*args, kernel="RBF").item())
        means.append(engine.predict_exact(*args, torch.as_tensor(Xt),
                                          kernel="RBF")[0].numpy())
    assert_allclose(losses[0], losses[1], rtol=1e-10)
    assert_allclose(losses[0], losses[2], rtol=1e-10)
    assert_allclose(means[0], means[2], rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("bucket", [1, 16, 128])
def test_pad_and_chunk_rows_match_jax(bucket):
    arr = np.arange(70.0).reshape(35, 2)
    p_t, n_t = engine.pad_rows(arr, bucket)
    p_j, n_j = jengine.pad_rows(arr, bucket)
    assert n_t == n_j and np.array_equal(p_t, p_j)
    c_t, m_t = engine.chunk_rows(arr, bucket)
    c_j, m_j = jengine.chunk_rows(arr, bucket)
    assert m_t == m_j and np.array_equal(c_t, c_j)


def test_failed_cholesky_raises_after_training():
    X, y, mask, u, bounds = _problem("RBF", np.float64)
    with pytest.raises(torch.linalg.LinAlgError, match="train: Cholesky"):
        engine.train(_torch(u), torch.as_tensor(X), torch.as_tensor(y),
                     torch.as_tensor(mask), _torch(bounds), 0.1, -50.0,
                     kernel="RBF", iterations=3)


@pytest.mark.parametrize("loop", ["adam_steps", "adam_segments"])
def test_adam_step_as_a_no_op_leaves_the_parameters(monkeypatch, loop):
    """With ``torch.optim.Adam.step`` patched to a no-op (what
    ``gpbench``'s ``adam_unchanged`` fault does), both Adam loops return
    ``u0``, record it at every step and the same loss throughout: nothing
    but the optimizer's step moves the parameters. Unpatched, they move."""
    u0 = {"x": torch.tensor([1.0, -2.0], dtype=torch.float64)}
    sq = lambda u: (u["x"] ** 2).sum()  # noqa: E731

    def run():
        if loop == "adam_steps":
            return engine.adam_steps(lambda u: (sq(u), None), u0, 0.1, 5,
                                     factors=())
        return engine.adam_segments(u0, 0.1, 5, lambda u: None,
                                    lambda u, pre: (sq(u), torch.tensor(4.)))
    moved = run()[0]["x"]
    assert not torch.equal(moved, u0["x"])
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, *a, **k: None)
    u, u_traj, losses = run()[:3]
    assert torch.equal(u["x"], u0["x"])
    assert torch.equal(u_traj["x"], u0["x"].expand(5, 2))
    assert torch.equal(losses, torch.full((5,), 5.0, dtype=torch.float64))
