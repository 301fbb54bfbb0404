"""
gpim_tpu_torch kernels' plain versions and Gram building blocks against the
JAX package on the same inputs (the Pallas kernels run in interpret mode on
the CPU, as in test_pallas_gram.py). On the CPU every wrapper takes its
plain version, so these tests hold the arithmetic the CUDA kernels are
compared with on the card.
"""

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

import jax
import jax.numpy as jnp

from gpim_tpu.gpreg import engine as jengine
from gpim_tpu.kernels import functional as jfunctional
from gpim_tpu.kernels import transforms as jtransforms
from gpim_tpu.ops import gram as jgram
from gpim_tpu.ops import pallas_gram

from gpim_tpu_torch.kernels import functional, transforms
from gpim_tpu_torch.ops import gram, gram_kernels

KERNELS = ["RBF", "Matern52", "RationalQuadratic"]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _t(a):
    return torch.as_tensor(np.asarray(a))


# --------------------------------------------------------------------------
# K1: pairwise squared distances
# --------------------------------------------------------------------------

def test_sqdist_plain_matches_pallas():
    rng = np.random.RandomState(0)
    A = rng.rand(256, 3).astype(np.float32) * 50
    B = rng.rand(512, 3).astype(np.float32) * 50
    ref = pallas_gram.pairwise_sq_dist_pallas(jnp.asarray(A), jnp.asarray(B))
    out = gram_kernels.sqdist(_t(A), _t(B))
    assert out.dtype == torch.float32
    assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-2)


@pytest.mark.parametrize("fn", ["sqdist", "pairwise_sq_dist"])
def test_exact_zero_at_coincident_points(fn):
    rng = np.random.RandomState(1)
    A = _t(rng.rand(256, 2).astype(np.float32) * 1e4)
    f = gram_kernels.sqdist if fn == "sqdist" else gram.pairwise_sq_dist
    assert (torch.diagonal(f(A, A)) == 0.0).all()


def test_sqdist_gradients_match_jax_custom_vjp():
    rng = np.random.RandomState(2)
    A = rng.rand(256, 2).astype(np.float32) * 10
    B = rng.rand(256, 2).astype(np.float32) * 10
    G = rng.rand(256, 256).astype(np.float32)

    def f_pallas(a, b):
        return jnp.sum(pallas_gram.pairwise_sq_dist_pallas(a, b)
                       * jnp.asarray(G))

    gA_j, gB_j = jax.grad(f_pallas, argnums=(0, 1))(
        jnp.asarray(A), jnp.asarray(B))
    a, b = _t(A).requires_grad_(True), _t(B).requires_grad_(True)
    (gram_kernels.sqdist(a, b) * _t(G)).sum().backward()
    assert_allclose(a.grad.numpy(), np.asarray(gA_j), rtol=1e-4, atol=1e-3)
    assert_allclose(b.grad.numpy(), np.asarray(gB_j), rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_pairwise_sq_dist_matches_jax(dtype):
    """The CPU norm-trick path against gpim_tpu.ops.gram (Pallas in f32 at
    these tile-aligned shapes, the XLA norm trick in f64)."""
    rng = np.random.RandomState(3)
    A = (rng.rand(256, 2) * 20).astype(dtype)
    B = (rng.rand(128, 2) * 20).astype(dtype)
    ref = np.asarray(jgram.pairwise_sq_dist(jnp.asarray(A), jnp.asarray(B)))
    out = gram.pairwise_sq_dist(_t(A), _t(B)).numpy()
    if dtype == np.float64:
        assert_allclose(out, ref, rtol=1e-12, atol=1e-10)
    else:
        assert_allclose(out, ref, rtol=1e-4, atol=1e-3)


def test_pairwise_sq_dist_gradient_matches_jax():
    rng = np.random.RandomState(4)
    A = rng.rand(40, 2) * 5
    B = rng.rand(30, 2) * 5
    G = rng.rand(40, 30)
    gA_j = jax.grad(lambda a: jnp.sum(jgram.pairwise_sq_dist(
        a, jnp.asarray(B)) * G))(jnp.asarray(A))
    a = _t(A).requires_grad_(True)
    (gram.pairwise_sq_dist(a, _t(B)) * _t(G)).sum().backward()
    assert_allclose(a.grad.numpy(), np.asarray(gA_j), rtol=1e-10, atol=1e-10)


# --------------------------------------------------------------------------
# K2: fused masked system
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kernel", KERNELS)
def test_masked_system_plain_matches_pallas(kernel):
    rng = np.random.RandomState(0)
    n, d = 256, 3
    X = (rng.rand(n, d) * 20).astype(np.float32)
    mask = (rng.rand(n) > 0.15).astype(np.float32)
    ls = np.array([2.0, 3.0, 1.5], np.float32)
    v, noise, jitter = np.float32(0.7), np.float32(0.05), np.float32(1e-4)
    alpha = np.float32(1.3) if kernel == "RationalQuadratic" else None
    Xs = X / ls
    Kt_j, A_j = pallas_gram.fused_masked_system_pallas(
        jnp.asarray(Xs), jnp.asarray(mask), v, noise + jitter,
        None if alpha is None else jnp.asarray(alpha), kernel=kernel)
    Kt, A = gram_kernels.masked_system(
        _t(Xs), _t(mask), _t(v), _t(noise + jitter),
        None if alpha is None else _t(alpha), kernel=kernel)
    assert_allclose(Kt.numpy(), np.asarray(Kt_j), rtol=2e-4, atol=2e-5)
    assert_allclose(A.numpy(), np.asarray(A_j), rtol=2e-4, atol=2e-5)
    # k(x, x) is exactly v, padded rows are identity rows
    assert (torch.diagonal(Kt) == float(v)).all()
    pad = np.flatnonzero(mask == 0)
    assert_allclose(A.numpy()[pad][:, pad], np.eye(len(pad)))


# --------------------------------------------------------------------------
# K3: RBF backward reductions
# --------------------------------------------------------------------------

def test_rbf_bwd_reductions_plain_matches_pallas():
    rng = np.random.RandomState(1)
    n, d = 256, 2
    Ainv = rng.rand(n, n).astype(np.float32)
    Ainv = 0.5 * (Ainv + Ainv.T)
    Kt = rng.rand(n, n).astype(np.float32)
    Kt = 0.5 * (Kt + Kt.T)
    alpha = rng.rand(n).astype(np.float32)
    mask = (rng.rand(n) > 0.2).astype(np.float32)
    X = rng.rand(n, d).astype(np.float32)
    ref = pallas_gram.rbf_bwd_reductions_pallas(
        *(jnp.asarray(a) for a in (Ainv, Kt, alpha, mask, X)))
    s1, rw, wx, dg = gram_kernels.rbf_bwd_reductions(
        *(_t(a) for a in (Ainv, Kt, alpha, mask, X)))
    assert rw.shape == (n,) and wx.shape == (n, d)
    assert_allclose(float(s1), float(ref[0]), rtol=1e-5)
    assert_allclose(rw.numpy(), np.asarray(ref[1]), rtol=1e-4, atol=1e-4)
    assert_allclose(wx.numpy(), np.asarray(ref[2]), rtol=1e-4, atol=1e-4)
    assert_allclose(float(dg), float(ref[3]), rtol=1e-5)


def test_cpu_wrappers_take_plain_versions_and_count_nothing():
    rng = np.random.RandomState(5)
    X = _t(rng.rand(16, 2))
    mask = torch.ones(16, dtype=torch.float64)
    before = (gram_kernels.sqdist.launches,
              gram_kernels.masked_system.launches,
              gram_kernels.rbf_bwd_reductions.launches)
    gram_kernels.sqdist(X, X)
    Kt, A = gram_kernels.masked_system(
        X, mask, _t(1.0), _t(0.1), kernel="RBF")
    gram_kernels.rbf_bwd_reductions(torch.linalg.inv(A), Kt,
                                    torch.ones(16, dtype=torch.float64),
                                    mask, X)
    after = (gram_kernels.sqdist.launches,
             gram_kernels.masked_system.launches,
             gram_kernels.rbf_bwd_reductions.launches)
    assert before == after


# --------------------------------------------------------------------------
# covariance functions and bijectors
# --------------------------------------------------------------------------

def _params(kernel, dtype=np.float64):
    p = {"lengthscale": np.array([1.7, 2.4], dtype),
         "variance": np.asarray(0.8, dtype)}
    if kernel == "RationalQuadratic":
        p["alpha"] = np.asarray(1.4, dtype)
    return p


@pytest.mark.parametrize("kernel", KERNELS)
def test_kernel_functions_match_jax(kernel):
    rng = np.random.RandomState(6)
    X1 = rng.rand(50, 2) * 8
    X2 = rng.rand(30, 2) * 8
    p = _params(kernel)
    ref = jfunctional.get_kernel_fn(kernel)(
        {k: jnp.asarray(v) for k, v in p.items()},
        jnp.asarray(X1), jnp.asarray(X2))
    out = functional.get_kernel_fn(kernel)(
        {k: _t(v) for k, v in p.items()}, _t(X1), _t(X2))
    assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-10, atol=1e-12)
    diag = functional.kernel_diag(kernel, {k: _t(v) for k, v in p.items()},
                                  _t(X1))
    assert_allclose(diag.numpy(), np.asarray(jfunctional.kernel_diag(
        kernel, {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(X1))))


def test_spectral_and_unknown_kernels_raise():
    """The spectral mixture is a kernel of the port now; a name neither
    package knows raises."""
    assert functional.get_kernel_fn("Spectral") is functional.spectral_mixture
    assert set(functional.KERNELS) == set(jfunctional.KERNELS)
    with pytest.raises(NotImplementedError):
        functional.get_kernel_fn("Periodic")


def test_transforms_match_jax():
    u = np.linspace(-30.0, 30.0, 61)
    lo, hi = np.array(0.5), np.array(7.0)
    ut, lot, hit = _t(u), _t(lo), _t(hi)
    assert_allclose(transforms.interval_forward(ut, lot, hit).numpy(),
                    np.asarray(jtransforms.interval_forward(u, lo, hi)),
                    rtol=1e-14)
    assert_allclose(transforms.interval_log_jacobian(ut, lot, hit).item(),
                    float(jtransforms.interval_log_jacobian(u, lo, hi)),
                    rtol=1e-13)
    # no softplus threshold: equal to jax.nn.softplus above 20 as well
    assert_allclose(transforms.positive_forward(ut).numpy(),
                    np.asarray(jtransforms.positive_forward(u)), rtol=1e-15)
    x = np.array([1e-3, 0.3, 1.0, 5.0, 40.0])
    assert_allclose(transforms.positive_inverse(_t(x)).numpy(),
                    np.asarray(jtransforms.positive_inverse(x)), rtol=1e-12)
    xs = np.array([0.5, 0.6, 3.0, 6.99, 7.0])
    assert_allclose(transforms.interval_inverse(_t(xs), lot, hit).numpy(),
                    np.asarray(jtransforms.interval_inverse(xs, lo, hi)),
                    rtol=1e-12)


def test_kernel_from_sqdist_twin_of_engine():
    """K2's plain kernel values equal the JAX engine's _kernel_from_sqdist
    on the same squared distances."""
    s = np.linspace(0.0, 40.0, 101)
    for kernel in KERNELS:
        p = _params(kernel)
        ref = jengine._kernel_from_sqdist(
            kernel, {k: jnp.asarray(v) for k, v in p.items()},
            jnp.asarray(s))
        out = gram_kernels._kernel_plain(
            kernel, _t(s), _t(p["variance"]),
            _t(p["alpha"]) if "alpha" in p else None)
        assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-12,
                        err_msg=kernel)
