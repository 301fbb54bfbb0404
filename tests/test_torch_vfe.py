"""
gpim_tpu_torch's sparse (VFE) engine against gpim_tpu's on the same inputs:
the bound and its gradient in every parameter (the inducing points
included), the closed-form backward of the n-wide core, Adam trajectories,
chunked prediction, and the twins of tests/test_vfe.py.
"""

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

import jax
import jax.numpy as jnp

from gpim_tpu.gpreg import engine as jengine
from gpim_tpu.ops import linalg as jlinalg

from gpim_tpu_torch.gpreg import engine
from gpim_tpu_torch.kernels.transforms import (
    interval_inverse, positive_inverse)
from gpim_tpu_torch.ops import linalg
from gpim_tpu_torch.ops.tri import tri_inverse

KERNELS = ["RBF", "Matern52", "RationalQuadratic"]
DTYPES = {"f64": np.float64, "f32": np.float32}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _problem(kernel, np_dtype=np.float64, n_obs=90, bucket=128, m=17, d=2,
             seed=0):
    """Padded training set (mask 0 on the padding), inducing points (a
    jittered strided subsample), unconstrained parameters and bounds."""
    rng = np.random.RandomState(seed)
    X = rng.rand(n_obs, d) * 10
    y = np.sin(X[:, 0]) + np.cos(X[:, 1]) + 0.05 * rng.randn(n_obs)
    Xp, _ = jengine.pad_rows(X, bucket)
    yp, _ = jengine.pad_rows(y, bucket)
    mask = np.zeros(len(Xp))
    mask[:n_obs] = 1.0
    Xu = X[::n_obs // m][:m] + 0.1 * rng.rand(m, d)
    u = {"lengthscale": np.full(d, -0.4), "variance": np.asarray(0.3),
         "noise": np.asarray(-2.0), "Xu": Xu}
    if kernel == "RationalQuadratic":
        u["alpha"] = np.asarray(0.2)
    bounds = {"ls_lo": np.zeros(d), "ls_hi": np.full(d, 5.0),
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


# --------------------------------------------------------------------------
# twins of tests/test_vfe.py
# --------------------------------------------------------------------------

def _small(n=30, d=2, seed=0):
    """tests/test_vfe.py::_setup, as tensors."""
    rng = np.random.RandomState(seed)
    X = rng.rand(n, d) * 6
    y = np.sin(X[:, 0]) + 0.1 * rng.rand(n)
    bounds = {"ls_lo": torch.zeros(d, dtype=torch.float64),
              "ls_hi": torch.full((d,), 5.0, dtype=torch.float64),
              "var_lo": torch.tensor(1e-4, dtype=torch.float64),
              "var_hi": torch.tensor(10.0, dtype=torch.float64)}
    u = {"lengthscale": interval_inverse(
            torch.ones(d, dtype=torch.float64), bounds["ls_lo"],
            bounds["ls_hi"]),
         "variance": interval_inverse(
            torch.tensor(1.0, dtype=torch.float64), bounds["var_lo"],
            bounds["var_hi"]),
         "noise": positive_inverse(torch.tensor(0.2, dtype=torch.float64))}
    return torch.as_tensor(X), torch.as_tensor(y), bounds, u


def test_vfe_equals_exact_when_xu_is_x():
    X, y, bounds, u = _small()
    mask = torch.ones(len(X), dtype=torch.float64)
    exact = engine.exact_loss(u, X, y, mask, bounds, 1e-9, kernel="RBF")
    vfe = engine.vfe_loss(dict(u, Xu=X), X, y, mask, bounds, 1e-9,
                          kernel="RBF")
    assert_allclose(vfe.item(), exact.item(), rtol=1e-6)


def test_vfe_predictions_match_exact_when_xu_is_x():
    X, y, bounds, u = _small()
    mask = torch.ones(len(X), dtype=torch.float64)
    Xt = np.random.RandomState(1).rand(13, 2) * 6
    chunks = torch.as_tensor(engine.chunk_rows(Xt, 13)[0])
    m_e, v_e = engine.predict_exact(u, X, y, mask, bounds, 1e-9, chunks,
                                    kernel="RBF")
    m_s, v_s = engine.predict_vfe(dict(u, Xu=X), X, y, mask, bounds, 1e-9,
                                  chunks, kernel="RBF")
    assert_allclose(m_s.numpy(), m_e.numpy(), rtol=1e-5, atol=1e-7)
    assert_allclose(v_s.numpy(), v_e.numpy(), rtol=1e-4, atol=1e-7)


def test_vfe_bound_below_exact_mll():
    X, y, bounds, u = _small(n=40)
    mask = torch.ones(40, dtype=torch.float64)
    exact = engine.exact_loss(u, X, y, mask, bounds, 1e-9, kernel="RBF")
    vfe = engine.vfe_loss(dict(u, Xu=X[::4]), X, y, mask, bounds, 1e-9,
                          kernel="RBF")
    assert vfe.item() >= exact.item() - 1e-8


# --------------------------------------------------------------------------
# against gpim_tpu
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kernel", KERNELS)
def test_vfe_loss_and_gradient_match_jax(kernel):
    """Value and gradient in every parameter, the inducing points included,
    with padded (mask 0) rows, in float64."""
    X, y, mask, u, bounds = _problem(kernel)
    loss_j, g_j = jax.value_and_grad(
        lambda uu: jengine.vfe_loss(
            uu, jnp.asarray(X), jnp.asarray(y), jnp.asarray(mask),
            _jax(bounds), 1e-5, kernel=kernel))(_jax(u))
    ut = _torch(u, requires_grad=True)
    loss = engine.vfe_loss(ut, torch.as_tensor(X), torch.as_tensor(y),
                           torch.as_tensor(mask), _torch(bounds), 1e-5,
                           kernel=kernel)
    loss.backward()
    assert_allclose(loss.item(), float(loss_j), rtol=1e-8)
    assert set(u) == set(g_j)
    for k in u:
        ref = np.asarray(g_j[k])
        assert ut[k].grad.shape == ref.shape
        assert_allclose(ut[k].grad.numpy(), ref, rtol=1e-8,
                        atol=1e-8 * np.abs(ref).max(), err_msg=k)


def _wide_inputs(m=6, n=11, seed=3):
    rng = np.random.RandomState(seed)
    M = rng.randn(m, m)
    Lm = torch.linalg.cholesky(torch.as_tensor(M @ M.T + m * np.eye(m)))
    Vm = tri_inverse(Lm)
    Kmn = torch.as_tensor(rng.randn(m, n))
    ym = torch.as_tensor(rng.randn(n))
    noise = torch.tensor(0.37, dtype=torch.float64)
    return Vm, Kmn, ym, noise, Lm


def test_vfe_wide_gradcheck():
    """The closed-form backward against finite differences (Lm stays
    Vm^-1 at the point where the Jacobian is taken)."""
    Vm, Kmn, ym, noise, Lm = _wide_inputs()
    args = [t.clone().requires_grad_(True) for t in (Vm, Kmn, ym, noise)]
    assert torch.autograd.gradcheck(
        lambda *a: engine._VFEWide.apply(*a, Lm), args)


def test_vfe_wide_backward_matches_autograd_of_plain_forward():
    Vm, Kmn, ym, noise, Lm = _wide_inputs(m=9, n=40)
    rng = np.random.RandomState(4)
    dB = torch.as_tensor(rng.randn(9, 9))
    da = torch.as_tensor(rng.randn(9))
    dt = torch.tensor(0.7, dtype=torch.float64)

    def plain(Vm, Kmn, ym, noise):
        A = Vm @ Kmn / torch.sqrt(noise)
        return A @ A.T, A @ ym, (A * A).sum()

    def outputs_and_grads(fn):
        args = [t.clone().requires_grad_(True)
                for t in (Vm, Kmn, ym, noise)]
        outs = fn(*args)
        torch.autograd.backward(outs, (dB, da, dt))
        return outs, [x.grad for x in args]

    outs, grads = outputs_and_grads(
        lambda *a: engine._VFEWide.apply(*a, Lm))
    ref_outs, ref_grads = outputs_and_grads(plain)
    for o, r in zip(outs, ref_outs):
        torch.testing.assert_close(o, r, rtol=1e-12, atol=1e-12)
    for g, r in zip(grads, ref_grads):
        torch.testing.assert_close(g, r, rtol=1e-10, atol=1e-12)


def test_sym_syrk_and_solve_triangular_match_jax():
    rng = np.random.RandomState(5)
    M = rng.randn(7, 30)
    dQ = rng.randn(7, 7)
    Q_j, vjp = jax.vjp(jlinalg.sym_syrk, jnp.asarray(M))
    Mt = torch.as_tensor(M).requires_grad_(True)
    Q = linalg.sym_syrk(Mt)
    Q.backward(torch.as_tensor(dQ))
    assert_allclose(Q.detach().numpy(), np.asarray(Q_j), rtol=1e-12)
    assert_allclose(Mt.grad.numpy(), np.asarray(vjp(jnp.asarray(dQ))[0]),
                    rtol=1e-12)
    from jax.scipy.linalg import solve_triangular as jsolve
    L = np.tril(rng.rand(7, 7)) + 7 * np.eye(7)
    for b in (rng.randn(7), rng.randn(7, 3)):
        for lower, Lx in ((True, L), (False, L.T)):
            got = linalg.solve_triangular(torch.as_tensor(Lx),
                                          torch.as_tensor(b), lower=lower)
            ref = jsolve(jnp.asarray(Lx), jnp.asarray(b), lower=lower)
            assert got.shape == b.shape
            assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-12)


@pytest.mark.parametrize("prec", ["f64", "f32"])
@pytest.mark.parametrize("kernel", KERNELS)
def test_predict_vfe_matches_jax(kernel, prec):
    np_dtype = DTYPES[prec]
    X, y, mask, u, bounds = _problem(kernel, np_dtype)
    jitter = _jitter(np_dtype)
    Xt = (np.random.RandomState(7).rand(200, 2) * 10).astype(np_dtype)
    chunks, n_test = jengine.chunk_rows(Xt, 128)
    mean_j, var_j = jengine.predict_vfe(
        _jax(u), jnp.asarray(X), jnp.asarray(y), jnp.asarray(mask),
        _jax(bounds), jnp.asarray(jitter, np_dtype), jnp.asarray(chunks),
        kernel=kernel)
    mean, var = engine.predict_vfe(
        _torch(u), torch.as_tensor(X), torch.as_tensor(y),
        torch.as_tensor(mask), _torch(bounds), jitter,
        torch.as_tensor(chunks), kernel=kernel)
    assert mean.shape == var.shape == (256,)
    rtol = 1e-9 if prec == "f64" else 1e-3
    mean_j, var_j = np.asarray(mean_j), np.asarray(var_j)
    assert_allclose(mean.numpy()[:n_test], mean_j[:n_test], rtol=rtol,
                    atol=rtol * np.abs(mean_j).max())
    assert_allclose(var.numpy()[:n_test], var_j[:n_test], rtol=rtol)
    assert (var >= 0).all()


@pytest.mark.parametrize("prec", ["f64", "f32"])
def test_sparse_train_trajectory_matches_jax(prec):
    np_dtype = DTYPES[prec]
    X, y, mask, u, bounds = _problem("Matern52", np_dtype)
    jitter, iters = _jitter(np_dtype), 12
    u_j, traj_j = jengine.train(
        _jax(u), jnp.asarray(X), jnp.asarray(y), jnp.asarray(mask),
        _jax(bounds), jnp.asarray(0.05, np_dtype),
        jnp.asarray(jitter, np_dtype), kernel="Matern52", iterations=iters,
        sparse=True)
    u_t, traj_t = engine.train(
        _torch(u), torch.as_tensor(X), torch.as_tensor(y),
        torch.as_tensor(mask), _torch(bounds), 0.05, jitter,
        kernel="Matern52", iterations=iters, sparse=True)
    rtol = 1e-7 if prec == "f64" else 1e-3
    assert traj_t["inducing_points"].shape == (iters,) + u["Xu"].shape
    for k in ("loss", "lengthscale", "variance", "noise", "inducing_points"):
        ref = np.asarray(traj_j[k])
        assert_allclose(traj_t[k].numpy(), ref, rtol=rtol,
                        atol=rtol * np.abs(ref).max(), err_msg=k)
    for k in u:
        assert_allclose(u_t[k].numpy(), np.asarray(u_j[k]), rtol=rtol,
                        atol=rtol * 10, err_msg=k)


def test_failed_kmm_cholesky_raises_after_sparse_training():
    X, y, mask, u, bounds = _problem("RBF")
    with pytest.raises(torch.linalg.LinAlgError,
                       match="train: Cholesky of Kmm failed at step 0"):
        engine.train(_torch(u), torch.as_tensor(X), torch.as_tensor(y),
                     torch.as_tensor(mask), _torch(bounds), 0.1, -50.0,
                     kernel="RBF", iterations=3, sparse=True)
