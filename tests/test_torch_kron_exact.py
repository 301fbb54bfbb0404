"""
gpim_tpu_torch.ops.kron_exact and ski.grid_kernel_factors against gpim_tpu
on the same numpy inputs (twins of tests/test_kron_exact.py), float64:
the Kronecker NLL's value against JAX and a dense Cholesky, its factor,
noise and target gradients against JAX's custom VJP and against autograd
through the dense Cholesky, the chunked prediction against JAX and a dense
GP, detect_cartesian's outputs (the None cases included), and the grid
kernel factors of RBF and Matern52.
"""

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

import jax
import jax.numpy as jnp

from gpim_tpu.ops import kron_exact as jkron
from gpim_tpu.ops import ski as jski

from gpim_tpu_torch.ops import kron_exact, ski


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _t(a, requires_grad=False):
    return torch.as_tensor(np.asarray(a)).requires_grad_(requires_grad)


def _rbf_factor(g, ls, var=1.0):
    return var * np.exp(-0.5 * (g[:, None] - g[None, :]) ** 2 / ls ** 2)


def _setup(seed=0, dims=(5, 6, 7)):
    """Three RBF factors on random sorted axes, targets and a noise
    (tests/test_kron_exact.py:_setup), as numpy."""
    rng = np.random.RandomState(seed)
    axes = [np.sort(rng.rand(s) * 4) for s in dims]
    ls = [0.9, 1.3, 0.7]
    factors = [_rbf_factor(axes[k], ls[k], 1.4 if k == 0 else 1.0)
               for k in range(3)]
    return axes, ls, factors, rng.rand(*dims), 0.05


def _dense_nll_torch(factors, noise, Y):
    A = torch.kron(torch.kron(factors[0], factors[1]), factors[2])
    A = A + noise * torch.eye(A.shape[0], dtype=A.dtype)
    yf = Y.reshape(-1)
    L = torch.linalg.cholesky(A)
    z = torch.linalg.solve_triangular(L, yf[:, None], upper=False)[:, 0]
    return (0.5 * z @ z + torch.log(torch.diagonal(L)).sum()
            + 0.5 * yf.numel() * np.log(2 * np.pi))


def test_kron_nll_value_matches_gpim_tpu_and_dense():
    _, _, factors, Y, noise = _setup()
    got = kron_exact.kron_nll([_t(f) for f in factors], _t(noise), _t(Y))
    ref = float(jkron.kron_nll(tuple(jnp.asarray(f) for f in factors),
                               jnp.asarray(noise), jnp.asarray(Y)))
    dense = _dense_nll_torch([_t(f) for f in factors], _t(noise), _t(Y))
    assert_allclose(got.item(), ref, rtol=1e-12)
    assert_allclose(got.item(), dense.item(), rtol=1e-9)


def test_kron_nll_gradients_match_jax_vjp_and_dense_autograd():
    """The factor-level closed form: never eigh's backward."""
    _, _, factors, Y, noise = _setup()
    fs = [_t(f, True) for f in factors]
    nt, Yt = _t(noise, True), _t(Y, True)
    kron_exact.kron_nll(fs, nt, Yt).backward()
    got = [f.grad for f in fs] + [nt.grad, Yt.grad]

    g_jax = jax.grad(lambda f, n, y: jkron.kron_nll(tuple(f), n, y),
                     argnums=(0, 1, 2))(
        [jnp.asarray(f) for f in factors], jnp.asarray(noise),
        jnp.asarray(Y))
    ref = list(g_jax[0]) + [g_jax[1], g_jax[2]]

    fs2 = [_t(f, True) for f in factors]
    nt2, Yt2 = _t(noise, True), _t(Y, True)
    _dense_nll_torch(fs2, nt2, Yt2).backward()
    dense = [f.grad for f in fs2] + [nt2.grad, Yt2.grad]
    for a, b, c in zip(got, ref, dense):
        assert_allclose(a.numpy(), np.asarray(b), rtol=1e-10, atol=1e-13)
        assert_allclose(a.numpy(), c.numpy(), rtol=1e-7, atol=1e-10)


def test_kron_nll_one_dimension_matches_gpim_tpu():
    """A single grid axis: no mode is summed out of the trace part."""
    rng = np.random.RandomState(3)
    g = np.sort(rng.rand(9) * 3)
    K, Y = _rbf_factor(g, 0.8, 1.2), rng.rand(9)
    f, nt = _t(K, True), _t(0.1, True)
    val = kron_exact.kron_nll([f], nt, _t(Y))
    val.backward()
    ref, gj = jax.value_and_grad(
        lambda k, n: jkron.kron_nll((k,), n, jnp.asarray(Y)),
        argnums=(0, 1))(jnp.asarray(K), jnp.asarray(0.1))
    assert_allclose(val.item(), float(ref), rtol=1e-12)
    assert_allclose(f.grad.numpy(), np.asarray(gj[0]), rtol=1e-10,
                    atol=1e-13)
    assert_allclose(nt.grad.item(), float(gj[1]), rtol=1e-10)


def test_kron_predict_matches_gpim_tpu_and_dense_gp():
    axes, ls, factors, Y, noise = _setup()
    Xt = np.random.RandomState(1).rand(2, 9, 3) * 4     # two chunks of 9

    def cross(xp, k, xcol):
        d2 = (xcol[:, None] - xp.asarray(axes[k])[None, :]) ** 2 / ls[k] ** 2
        return (1.4 if k == 0 else 1.0) * xp.exp(-0.5 * d2)

    mean, var = kron_exact.kron_predict_chunks(
        [_t(f) for f in factors],
        [lambda x, k=k: cross(torch, k, x) for k in range(3)], _t(noise),
        _t(Y), _t(1.4), _t(Xt))
    jmean, jvar = jkron.kron_predict_chunks(
        tuple(jnp.asarray(f) for f in factors),
        [lambda x, k=k: cross(jnp, k, x) for k in range(3)],
        jnp.asarray(noise), jnp.asarray(Y), jnp.asarray(1.4),
        jnp.asarray(Xt))
    assert mean.shape == var.shape == (18,)
    assert_allclose(mean.numpy(), np.asarray(jmean), rtol=1e-12, atol=1e-14)
    assert_allclose(var.numpy(), np.asarray(jvar), rtol=1e-12, atol=1e-14)

    A = np.kron(np.kron(factors[0], factors[1]), factors[2])
    A = A + noise * np.eye(len(A))
    pts = Xt.reshape(-1, 3)
    E = [cross(np, k, pts[:, k]) for k in range(3)]
    rows = np.einsum("ba,bc,bd->bacd", *E).reshape(len(pts), -1)
    mean_ref = rows @ np.linalg.solve(A, Y.reshape(-1))
    var_ref = 1.4 - np.einsum("bi,ij,bj->b", rows, np.linalg.inv(A),
                              rows) + noise
    assert_allclose(mean.numpy(), mean_ref, rtol=1e-7, atol=1e-9)
    assert_allclose(var.numpy(), var_ref, rtol=1e-6, atol=1e-8)


def _grid(dims, scale=(1.0, 2.0, 0.5)):
    axes = [np.arange(s) * scale[k] for k, s in enumerate(dims)]
    mesh = np.meshgrid(*axes, indexing="ij")
    return np.stack([m.reshape(-1) for m in mesh], -1)


DETECT_CASES = {
    "full_grid": lambda: (_grid((3, 4, 2)), (3, 4, 2)),
    "one_dim": lambda: (np.arange(5.0)[:, None], (5,)),
    "wrong_count": lambda: (_grid((3, 4, 2))[:-1], (3, 4, 2)),
    "wrong_dims": lambda: (_grid((3, 4, 2)), (4, 3, 2)),
    "wrong_d": lambda: (_grid((3, 4, 2))[:, :2], (3, 4, 2)),
    "shuffled_rows": lambda: (_grid((3, 4, 2))[::-1].copy(), (3, 4, 2)),
    "perturbed": lambda: (_grid((3, 4, 2)) + np.where(
        np.arange(24)[:, None] == 5, 1e-3, 0.0), (3, 4, 2)),
}


@pytest.mark.parametrize("case", sorted(DETECT_CASES))
def test_detect_cartesian_matches_gpim_tpu(case):
    X, dims = DETECT_CASES[case]()
    got = kron_exact.detect_cartesian(X, dims)
    ref = jkron.detect_cartesian(X, dims)
    assert (got is None) == (ref is None)
    if case in ("full_grid", "one_dim"):
        assert got is not None
    if got is not None:
        assert len(got) == len(ref)
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kernel", ["RBF", "Matern52"])
def test_grid_kernel_factors_match_gpim_tpu(kernel):
    """One factor per axis, the variance on the first; Matern52's factor
    diagonals are exactly its variance (d2 == 0 at coincident points)."""
    grids = [np.arange(10.0), np.arange(6.0) * 0.5, np.linspace(0, 3, 4)]
    p = {"lengthscale": np.array([1.3, 0.7, 2.1]), "variance": np.asarray(0.8)}
    got = ski.grid_kernel_factors(kernel, {k: _t(v) for k, v in p.items()},
                                  [_t(g) for g in grids])
    ref = jski.grid_kernel_factors(
        kernel, {k: jnp.asarray(v) for k, v in p.items()},
        [jnp.asarray(g) for g in grids])
    assert [tuple(f.shape) for f in got] == [(10, 10), (6, 6), (4, 4)]
    for k, (a, b) in enumerate(zip(got, ref)):
        assert_allclose(a.numpy(), np.asarray(b), rtol=1e-13, atol=1e-15)
        diag = 0.8 if k == 0 else 1.0
        assert_allclose(torch.diagonal(a).numpy(), diag, rtol=1e-12)
