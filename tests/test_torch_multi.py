"""
gpim_tpu_torch.gpreg.multi, and the task axis of the kernels and of the
engine beneath it, against gpim_tpu on the same inputs: the batched plain
K1, K2 and K3 against JAX's vmapped Pallas kernels (interpret mode on the
CPU), the independent and correlated losses with their gradients (the
repeated-eigenvalue task covariance included), Adam trajectories and both
predictions, in float64 (rtol 1e-6) and float32 (rtol 1e-3, where JAX runs
its batched Pallas kernels); and the twins of tests/test_vgpr.py's
closed-form checks.
"""

from functools import partial

import numpy as np
import pytest
import scipy.linalg as sla
import torch
from numpy.testing import assert_allclose

import jax
import jax.numpy as jnp

from gpim_tpu.gpreg import engine as jengine
from gpim_tpu.gpreg import multi as jmulti
from gpim_tpu.ops import gram as jgram
from gpim_tpu.ops import pallas_gram

from gpim_tpu_torch.gpreg import engine, multi
from gpim_tpu_torch.kernels.transforms import (
    interval_inverse, positive_inverse)
from gpim_tpu_torch.ops import gram, gram_kernels

KERNELS = ["RBF", "Matern52"]
DTYPES = {"f64": np.float64, "f32": np.float32}
RTOL = {"f64": 1e-6, "f32": 1e-3}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _jax(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _torch(tree, requires_grad=False):
    return {k: _t(v).requires_grad_(requires_grad) for k, v in tree.items()}


def _close(got, ref, rtol, err_msg=""):
    ref = np.asarray(ref)
    assert_allclose(np.asarray(got), ref, rtol=rtol,
                    atol=rtol * max(np.abs(ref).max(), 1e-30),
                    err_msg=err_msg)


def _independent_problem(np_dtype, T=3, n_obs=100, bucket=128, d=2, seed=0):
    """Padded rows, Y (n, T), mask, per-task unconstrained parameters that
    differ by task, and bounds, as numpy arrays of ``np_dtype``."""
    rng = np.random.RandomState(seed)
    X = rng.rand(n_obs, d) * 10
    Y = np.stack([np.sin(X[:, 0] / (1 + t)) + np.cos(X[:, 1]) * t
                  + 0.05 * rng.randn(n_obs) for t in range(T)], -1)
    Xp, _ = jengine.pad_rows(X, bucket)
    Yp, _ = jengine.pad_rows(Y, bucket)
    mask = np.zeros(len(Xp))
    mask[:n_obs] = 1.0
    u = {"lengthscale": -0.6 + 0.3 * rng.randn(T, d),
         "outputscale": 0.2 * rng.randn(T),
         "noise": -2.0 + 0.2 * rng.randn(T),
         "mean": 0.1 * rng.randn(T)}
    bounds = {"ls_lo": np.zeros(d), "ls_hi": np.full(d, 6.0)}
    cast = lambda a: np.asarray(a, np_dtype)  # noqa: E731
    return (cast(Xp), cast(Yp), cast(mask), {k: cast(v) for k, v in u.items()},
            {k: cast(v) for k, v in bounds.items()})


def _correlated_problem(np_dtype, T=4, n=24, d=2, seed=7, repeated=False):
    """X, Y (n, T), parameters and bounds; ``repeated``: a rank-1 F with an
    equal task_var, so B has T - 1 exactly repeated eigenvalues."""
    rng = np.random.RandomState(seed)
    X = rng.rand(n, d) * 4
    Y = rng.rand(n, T)
    u = {"lengthscale": np.full(d, 0.2), "noise": np.asarray(-1.5),
         "mean": rng.rand(T) * 0.1, "F": rng.rand(T, 1),
         "task_var": (np.full(T, -0.4) if repeated
                      else -0.4 + 0.3 * rng.randn(T))}
    bounds = {"ls_lo": np.zeros(d), "ls_hi": np.full(d, 6.0)}
    cast = lambda a: np.asarray(a, np_dtype)  # noqa: E731
    return (cast(X), cast(Y), {k: cast(v) for k, v in u.items()},
            {k: cast(v) for k, v in bounds.items()})


# --------------------------------------------------------------------------
# the kernels' task axis: batched plain versions against vmapped Pallas
# --------------------------------------------------------------------------

def _batched_inputs(T=2, n=128, d=2, seed=0):
    rng = np.random.RandomState(seed)
    X = (rng.rand(n, d) * 12).astype(np.float32)
    ls = np.array([[2.0, 3.0], [1.3, 0.9]], np.float32)[:T]
    mask = (rng.rand(n) > 0.2).astype(np.float32)
    return X, X[None] / ls[:, None, :], mask, rng


def test_batched_sqdist_plain_matches_vmapped_pallas():
    _, Xs, _, rng = _batched_inputs()
    B = Xs[:, ::-1].copy()
    ref = jax.vmap(pallas_gram.pairwise_sq_dist_pallas)(
        jnp.asarray(Xs), jnp.asarray(B))
    got = gram_kernels.sqdist(_t(Xs), _t(B))
    assert got.shape == (2, 128, 128)
    _close(got, ref, 1e-5)
    for t in range(2):     # each task is the unbatched call on its slice
        assert torch.equal(got[t], gram_kernels.sqdist(_t(Xs[t]), _t(B[t])))


@pytest.mark.parametrize("kernel", KERNELS)
def test_batched_masked_system_plain_matches_vmapped_pallas(kernel):
    _, Xs, mask, _ = _batched_inputs()
    v = np.array([0.7, 1.9], np.float32)
    nj = np.array([0.05, 0.003], np.float32)
    Kt_j, A_j = jax.vmap(partial(
        pallas_gram.fused_masked_system_pallas, kernel=kernel),
        in_axes=(0, None, 0, 0))(jnp.asarray(Xs), jnp.asarray(mask),
                                 jnp.asarray(v), jnp.asarray(nj))
    Kt, A = gram_kernels.masked_system(_t(Xs), _t(mask), _t(v), _t(nj),
                                       kernel=kernel)
    assert Kt.shape == A.shape == (2, 128, 128)
    _close(Kt, Kt_j, 2e-4)
    _close(A, A_j, 2e-4)
    for t in range(2):
        assert (torch.diagonal(Kt[t]) == float(v[t])).all()
        Kt1, A1 = gram_kernels.masked_system(_t(Xs[t]), _t(mask), _t(v[t]),
                                             _t(nj[t]), kernel=kernel)
        assert torch.equal(Kt[t], Kt1) and torch.equal(A[t], A1)


def test_batched_rbf_bwd_reductions_plain_matches_vmapped_pallas():
    X, Xs, mask, rng = _batched_inputs()
    T, n = Xs.shape[:2]
    Kt, A = gram_kernels.masked_system(
        _t(Xs), _t(mask), _t(np.float32([0.7, 1.9])),
        _t(np.float32([0.05, 0.02])), kernel="RBF")
    Ainv = torch.linalg.inv(A.double()).float().numpy()
    alpha = rng.randn(T, n).astype(np.float32) * mask
    ref = jax.vmap(pallas_gram.rbf_bwd_reductions_pallas,
                   in_axes=(0, 0, 0, None, None))(
        jnp.asarray(Ainv), jnp.asarray(Kt.numpy()), jnp.asarray(alpha),
        jnp.asarray(mask), jnp.asarray(X))
    got = gram_kernels.rbf_bwd_reductions(_t(Ainv), Kt, _t(alpha), _t(mask),
                                          _t(X))
    assert [tuple(g.shape) for g in got] == [(T,), (T, n), (T, n, 2), (T,)]
    for g, r, name in zip(got, ref, ("S1", "rw", "WX", "diagsum")):
        _close(g, r, 1e-3, name)
    for t in range(T):
        one = gram_kernels.rbf_bwd_reductions(_t(Ainv[t]), Kt[t],
                                              _t(alpha[t]), _t(mask), _t(X))
        for g, o in zip(got, one):
            _close(g[t], o, 1e-6)


def test_min_traffic_counts_shared_operands_once():
    """A batch of T reads each task's operands and the shared mask (and
    K3's X) once; T = 1 is the unbatched count."""
    for name, m in (("sqdist", 96), ("masked_system", None),
                    ("rbf_bwd_reductions", None)):
        assert (gram_kernels.min_traffic(name, 128, 2, m, 4, batch=1)
                == gram_kernels.min_traffic(name, 128, 2, m, 4))
    n, d, T = 2048, 2, 64
    r, w, _ = gram_kernels.min_traffic("masked_system", n, d, batch=T)
    assert w == T * 2 * n * n * 4 and r == (T * (n * d + 3) + n) * 4
    r, w, _ = gram_kernels.min_traffic("rbf_bwd_reductions", n, d, batch=T)
    assert r == (T * (2 * n * n + n) + n + n * d) * 4
    assert w == T * (2 + n + n * d) * 4


@pytest.mark.parametrize("prec", ["f64", "f32"])
def test_batched_pairwise_sq_dist_centres_and_snaps_each_task(prec):
    """The CPU norm-trick path reduces over the point axis only: each task
    is centred by its own mean and snapped at its own floor, as under JAX's
    vmap, so a task far from the origin does not move another's zeros."""
    np_dtype = DTYPES[prec]
    rng = np.random.RandomState(2)
    A = np.stack([rng.rand(40, 2) * 3, 500.0 + rng.rand(40, 2) * 3]
                 ).astype(np_dtype)
    B = A[:, ::2].copy()
    ref = jax.jit(jax.vmap(jgram.pairwise_sq_dist))(jnp.asarray(A),
                                                    jnp.asarray(B))
    got = gram.pairwise_sq_dist(_t(A), _t(B))
    _close(got, ref, 1e-10 if prec == "f64" else 1e-5)
    for t in range(2):
        assert torch.equal(got[t], gram.pairwise_sq_dist(_t(A[t]), _t(B[t])))
        assert (got[t][::2].diagonal() == 0).all()


# --------------------------------------------------------------------------
# the engine's task axis
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kernel", KERNELS)
def test_batched_nll_fast_is_each_task_unbatched(kernel):
    """_NLLFast with a task axis: every task's nll and gradients equal the
    unbatched call on that task's slice; the autodiff path agrees."""
    X, Yp, mask, u, bounds = _independent_problem(np.float64)
    p = multi._constrain_task(_torch(u), _torch(bounds))
    leaves = [p["lengthscale"], p["variance"], p["noise"]]
    leaves = [x.detach().requires_grad_(True) for x in leaves]
    y = _t(Yp.T).requires_grad_(True)
    nll, info = engine._NLLFast.apply(kernel, *leaves, None, _t(X), y,
                                      _t(mask), 1e-5)
    assert nll.shape == info.shape == (3,) and (info == 0).all()
    nll.sum().backward()
    for t in range(3):
        one = [x.detach()[t].clone().requires_grad_(True) for x in leaves]
        yt = y.detach()[t].clone().requires_grad_(True)
        nll_t, _ = engine._NLLFast.apply(kernel, *one, None, _t(X), yt,
                                         _t(mask), 1e-5)
        nll_t.backward()
        _close(nll[t].item(), nll_t.item(), 1e-12)
        for b, o in zip(leaves + [y], one + [yt]):
            _close(b.grad[t], o.grad, 1e-10)
    bp = multi._batched({k: v.detach() for k, v in p.items()})
    nll_a, _ = engine._exact_nll_autodiff(bp, _t(X), y.detach(), _t(mask),
                                          1e-5, kernel)
    # its Gram comes from the norm-trick distances, K2's from differences
    _close(nll_a, nll.detach(), 1e-10)


# --------------------------------------------------------------------------
# losses and gradients against gpim_tpu
# --------------------------------------------------------------------------

@pytest.mark.parametrize("prec", ["f64", "f32"])
@pytest.mark.parametrize("kernel", KERNELS)
def test_iv_loss_and_gradient_match_jax(kernel, prec):
    np_dtype = DTYPES[prec]
    X, Y, mask, u, bounds = _independent_problem(np_dtype)
    jitter = 1e-5 if prec == "f64" else 1e-4
    loss_j, g_j = jax.jit(jax.value_and_grad(partial(jmulti._iv_loss,
                                                     kernel=kernel)))(
        _jax(u), jnp.asarray(X), jnp.asarray(Y), jnp.asarray(mask),
        _jax(bounds), jnp.asarray(jitter, np_dtype))
    ut = _torch(u, requires_grad=True)
    loss, info = multi._iv_loss(ut, _t(X), _t(Y), _t(mask), _torch(bounds),
                                jitter, kernel=kernel)
    assert info.shape == (3,) and (info == 0).all()
    loss.backward()
    rtol = RTOL[prec]
    _close(loss.item(), float(loss_j), rtol)
    for k in u:
        _close(ut[k].grad, g_j[k], rtol, k)


@pytest.mark.parametrize("repeated", [False, True])
@pytest.mark.parametrize("kernel", KERNELS)
def test_corr_loss_and_gradient_match_jax(kernel, repeated):
    """Including B with T - 1 exactly repeated eigenvalues (rank-1 F, equal
    task_var; tests/test_vgpr.py:154), where autodiff through eigh fails."""
    X, Y, u, bounds = _correlated_problem(np.float64, repeated=repeated)
    loss_j, g_j = jax.jit(jax.value_and_grad(partial(jmulti._corr_loss,
                                                     kernel=kernel)))(
        _jax(u), jnp.asarray(X), jnp.asarray(Y), _jax(bounds),
        jnp.asarray(1e-8))
    ut = _torch(u, requires_grad=True)
    loss, info = multi._corr_loss(ut, _t(X), _t(Y), _torch(bounds), 1e-8,
                                  kernel=kernel)
    assert info.shape == (4,) and (info == 0).all()
    loss.backward()
    _close(loss.item(), float(loss_j), 1e-10)
    for k in u:
        g = ut[k].grad
        assert torch.isfinite(g).all(), k
        _close(g, g_j[k], 1e-6, k)


def test_corr_loss_gradient_matches_dense_autograd():
    """The closed-form backward against autograd through the dense
    (nT x nT) Cholesky, at repeated eigenvalues."""
    X, Y, u, bounds = _correlated_problem(np.float64, T=3, n=15,
                                          repeated=True)
    ut = _torch(u, requires_grad=True)
    multi._corr_loss(ut, _t(X), _t(Y), _torch(bounds), 1e-8,
                     kernel="RBF")[0].backward()
    ud = _torch(u, requires_grad=True)
    p = multi._constrain_corr(ud, _torch(bounds))
    from gpim_tpu_torch.kernels.functional import rbf
    n, T = Y.shape
    Kbig = torch.kron(rbf(p, _t(X), _t(X)), multi._task_cov(p))
    A = Kbig + (p["noise"] + 1e-8) * torch.eye(n * T, dtype=torch.float64)
    L = torch.linalg.cholesky(A)
    yc = (_t(Y) - p["mean"]).reshape(-1, 1)
    z = torch.linalg.solve_triangular(L, yc, upper=False)
    from gpim_tpu_torch.kernels.transforms import interval_log_jacobian
    nll = (0.5 * (z * z).sum() + torch.log(torch.diagonal(L)).sum()
           + 0.5 * n * T * multi._LOG_2PI
           - interval_log_jacobian(ud["lengthscale"], _t(bounds["ls_lo"]),
                                   _t(bounds["ls_hi"])))
    nll.backward()
    for k in u:
        _close(ut[k].grad, ud[k].grad, 1e-7, k)


# --------------------------------------------------------------------------
# training and prediction against gpim_tpu
# --------------------------------------------------------------------------

def _chunks(X, chunk, np_dtype):
    rng = np.random.RandomState(5)
    Xt = np.concatenate([X[:20], rng.rand(40, X.shape[1]) * 10])
    return np.asarray(jengine.chunk_rows(Xt, chunk)[0], np_dtype)


@pytest.mark.parametrize("prec", ["f64", "f32"])
@pytest.mark.parametrize("kernel", KERNELS)
def test_train_and_predict_independent_match_jax(kernel, prec):
    np_dtype = DTYPES[prec]
    X, Y, mask, u, bounds = _independent_problem(np_dtype)
    jitter = 1e-5 if prec == "f64" else 1e-4
    iters = 6
    u_j, traj_j = jmulti.train_independent(
        _jax(u), jnp.asarray(X), jnp.asarray(Y), jnp.asarray(mask),
        _jax(bounds), jnp.asarray(0.05, np_dtype),
        jnp.asarray(jitter, np_dtype), kernel=kernel, iterations=iters)
    u_t, traj = multi.train_independent(
        _torch(u), _t(X), _t(Y), _t(mask), _torch(bounds), 0.05, jitter,
        kernel=kernel, iterations=iters)
    rtol = RTOL[prec]
    assert set(traj) == set(traj_j)
    for k in traj:
        assert traj[k].shape == traj_j[k].shape, k
        _close(traj[k], traj_j[k], rtol, k)
    chunks = _chunks(X, 32, np_dtype)
    m_j, v_j = jmulti.predict_independent(
        u_j, jnp.asarray(X), jnp.asarray(Y), jnp.asarray(mask), _jax(bounds),
        jnp.asarray(jitter, np_dtype), jnp.asarray(chunks), kernel=kernel)
    m, v = multi.predict_independent(
        u_t, _t(X), _t(Y), _t(mask), _torch(bounds), jitter, _t(chunks),
        kernel=kernel)
    assert m.shape == v.shape == (64, 3)
    _close(m, m_j, rtol)
    _close(v, v_j, rtol)


@pytest.mark.parametrize("kernel", KERNELS)
def test_train_and_predict_correlated_match_jax(kernel):
    """In float64; float32 runs in tests/test_torch_vgpr.py."""
    prec = "f64"
    np_dtype = DTYPES[prec]
    X, Y, u, bounds = _correlated_problem(np_dtype, repeated=True)
    jitter = 1e-5 if prec == "f64" else 1e-4
    iters = 6
    u_j, traj_j = jmulti.train_correlated(
        _jax(u), jnp.asarray(X), jnp.asarray(Y), _jax(bounds),
        jnp.asarray(0.05, np_dtype), jnp.asarray(jitter, np_dtype),
        kernel=kernel, iterations=iters)
    u_t, traj = multi.train_correlated(
        _torch(u), _t(X), _t(Y), _torch(bounds), 0.05, jitter,
        kernel=kernel, iterations=iters)
    rtol = RTOL[prec]
    assert set(traj) == set(traj_j)
    for k in traj:
        assert traj[k].shape == traj_j[k].shape, k
        _close(traj[k], traj_j[k], rtol, k)
    chunks = _chunks(X, 16, np_dtype)
    m_j, v_j = jmulti.predict_correlated(
        u_j, jnp.asarray(X), jnp.asarray(Y), _jax(bounds),
        jnp.asarray(jitter, np_dtype), jnp.asarray(chunks), kernel=kernel)
    m, v = multi.predict_correlated(
        u_t, _t(X), _t(Y), _torch(bounds), jitter, _t(chunks),
        kernel=kernel)
    assert m.shape == v.shape == (64, 4)
    _close(m, m_j, rtol)
    _close(v, v_j, rtol)


def test_failed_task_cholesky_raises_with_its_task():
    """A step whose Cholesky fails in one channel raises after the loop,
    naming that channel."""
    X, Y, mask, u, bounds = _independent_problem(np.float64)
    u["noise"][1] = -60.0                 # noise ~ 1e-26 in channel 1
    X[:, :] = 1.0                         # coincident points: singular K
    with pytest.raises(torch.linalg.LinAlgError, match="task 1"):
        multi.train_independent(_torch(u), _t(X), _t(Y), _t(mask),
                                _torch(bounds), 0.05, 0.0, kernel="RBF",
                                iterations=2)


# --------------------------------------------------------------------------
# twins of tests/test_vgpr.py's closed-form checks
# --------------------------------------------------------------------------

def test_independent_matches_single_gpr():
    """Each channel of the independent multi-output GP equals a single
    output GP trained on that channel alone (same init and optimizer)."""
    rng = np.random.RandomState(3)
    n, d_in, T = 30, 2, 2
    X = rng.rand(n, d_in) * 8
    Y = np.stack([np.sin(X[:, 0]) + 0.1 * rng.rand(n),
                  np.cos(X[:, 1]) + 0.1 * rng.rand(n)], axis=-1)
    Xt = _t(jengine.chunk_rows(rng.rand(9, d_in) * 8, 9)[0])
    bounds = {"ls_lo": _t(np.zeros(d_in)), "ls_hi": _t(np.full(d_in, 6.0))}
    u_ls = interval_inverse(_t(np.full(d_in, 0.6)), bounds["ls_lo"],
                            bounds["ls_hi"])
    one = positive_inverse(_t(1.0))
    u = {"lengthscale": u_ls.repeat(T, 1), "outputscale": one.repeat(T),
         "noise": one.repeat(T), "mean": _t(np.zeros(T))}
    mask = _t(np.ones(n))
    kw = dict(kernel="RBF", iterations=20)
    u_fit, _ = multi.train_independent(u, _t(X), _t(Y), mask, bounds, 0.1,
                                       1e-6, **kw)
    m_joint, v_joint = multi.predict_independent(
        u_fit, _t(X), _t(Y), mask, bounds, 1e-6, Xt, kernel="RBF")
    for t in range(T):
        u_t = {k: v[t:t + 1] for k, v in u.items()}
        u_t_fit, _ = multi.train_independent(u_t, _t(X), _t(Y[:, t:t + 1]),
                                             mask, bounds, 0.1, 1e-6, **kw)
        m_t, v_t = multi.predict_independent(
            u_t_fit, _t(X), _t(Y[:, t:t + 1]), mask, bounds, 1e-6, Xt,
            kernel="RBF")
        assert_allclose(m_joint[:, t], m_t[:, 0], rtol=1e-8, atol=1e-10)
        assert_allclose(v_joint[:, t], v_t[:, 0], rtol=1e-8, atol=1e-10)


def _rbf_np(a, b, ls):
    return np.exp(-0.5 * (((a[:, None, :] - b[None, :, :]) / ls) ** 2
                          ).sum(-1))


def test_correlated_matches_dense_kronecker():
    """The rotated-basis Kronecker solver equals the dense nT x nT GP."""
    rng = np.random.RandomState(4)
    n, d_in, T = 18, 2, 3
    X = rng.rand(n, d_in) * 5
    Y = rng.rand(n, T)
    Xt = rng.rand(7, d_in) * 5
    bounds = {"ls_lo": _t(np.zeros(d_in)), "ls_hi": _t(np.full(d_in, 6.0))}
    ls, noise = np.full(d_in, 1.2), 0.3
    tv = rng.rand(T) + 0.5
    u = {"lengthscale": interval_inverse(_t(ls), bounds["ls_lo"],
                                         bounds["ls_hi"]),
         "noise": positive_inverse(_t(noise)), "mean": _t(rng.rand(T) * 0.1),
         "F": _t(rng.rand(T, 1)), "task_var": positive_inverse(_t(tv))}
    jitter = 1e-8
    mean, var = multi.predict_correlated(
        u, _t(X), _t(Y), bounds, jitter,
        _t(jengine.chunk_rows(Xt, 7)[0]), kernel="RBF")
    F, mu = u["F"].numpy(), u["mean"].numpy()
    B = F @ F.T + np.diag(tv)
    Kbig = np.kron(_rbf_np(X, X, ls), B) + (noise + jitter) * np.eye(n * T)
    alpha = np.linalg.solve(Kbig, (Y - mu[None, :]).reshape(-1))
    Ks = np.kron(_rbf_np(Xt, X, ls), B)
    mean_ref = (Ks @ alpha).reshape(-1, T) + mu[None, :]
    cov_ref = np.kron(_rbf_np(Xt, Xt, ls), B) - Ks @ np.linalg.solve(Kbig,
                                                                     Ks.T)
    var_ref = np.diag(cov_ref).reshape(-1, T) + noise
    assert_allclose(mean.numpy(), mean_ref, rtol=1e-6, atol=1e-8)
    assert_allclose(var.numpy(), var_ref, rtol=1e-6, atol=1e-8)


def test_independent_predict_closed_form_padded_grid():
    """A zero-padded masked grid with long lengthscales relative to the
    grid span (the regime of gpim_tpu's XLA:CPU miscompile), predicted
    against a numpy closed form."""
    rng = np.random.RandomState(0)
    size, T = 24, 4
    g = np.mgrid[0:size:1.0, 0:size:1.0]
    X_all = np.stack([g[0], g[1]], -1).reshape(-1, 2)
    obs = rng.rand(size * size) < 0.5
    Xn = X_all[obs]
    Yn = np.stack([np.sin(Xn[:, 0] / (4 + t)) * np.cos(Xn[:, 1] / 5.0)
                   for t in range(T)], -1) * 0.2 + 0.1
    Xp, n = engine.pad_rows(Xn, 128)
    Yp, _ = engine.pad_rows(Yn, 128)
    mask = np.zeros(len(Xp))
    mask[:n] = 1.0
    bounds = {"ls_lo": _t(np.full(2, 0.01)), "ls_hi": _t(np.full(2, 40.0))}
    ls = np.array([[8.7, 9.0], [7.5, 8.2], [9.3, 6.8], [8.0, 7.1]])
    outs = np.array([0.042, 0.05, 0.03, 0.045])
    noise = np.array([0.0028, 0.004, 0.002, 0.003])
    cmean = np.array([0.063, 0.05, 0.07, 0.04])
    u = {"lengthscale": interval_inverse(_t(ls), bounds["ls_lo"],
                                         bounds["ls_hi"]),
         "outputscale": positive_inverse(_t(outs)),
         "noise": positive_inverse(_t(noise)), "mean": _t(cmean)}
    jitter = 1e-5
    chunks, nt = engine.chunk_rows(X_all, 256)
    mean, var = multi.predict_independent(
        u, _t(Xp), _t(Yp), _t(mask), bounds, jitter, _t(chunks),
        kernel="RBF")
    mean, var = mean.numpy()[:nt], var.numpy()[:nt]
    for t in range(T):
        K = outs[t] * _rbf_np(Xn, Xn, ls[t]) + (noise[t] + jitter) * np.eye(n)
        L = np.linalg.cholesky(K)
        alpha = sla.cho_solve((L, True), Yn[:, t] - cmean[t])
        Ks = outs[t] * _rbf_np(X_all, Xn, ls[t])
        V = sla.solve_triangular(L, Ks.T, lower=True)
        assert_allclose(mean[:, t], Ks @ alpha + cmean[t], rtol=1e-7,
                        atol=1e-9)
        assert_allclose(var[:, t], outs[t] - (V * V).sum(0) + noise[t],
                        rtol=1e-6, atol=1e-9)
