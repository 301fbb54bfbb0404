"""
The CUDA kernels of gpim_tpu_torch against their plain PyTorch versions, on
the card: ragged shapes (the kernels mask partial tiles themselves), every
feature count up to 8, both dtypes, determinism, the K1 gradient, the
wrappers' validation and launch counts, and the closed-form MLL gradient
against the CPU path.

Needs a CUDA device and skips without one. Imports no JAX, so it runs on a
machine without it (there the repo's conftest, which imports JAX, is left
out):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py
"""

import numpy as np
import pytest
import torch

from gpim_tpu_torch.gpreg import engine
from gpim_tpu_torch.ops import gram_kernels as gk

pytestmark = pytest.mark.cuda

DTYPES = [torch.float32, torch.float64]
# normalized max error against the float64 plain version; K3 sums n terms
# per row in another order (see the wrappers' docstrings)
TOL = {torch.float32: 1e-5, torch.float64: 1e-12}
TOL_K3 = {torch.float32: 1e-4, torch.float64: 1e-12}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rand(shape, dtype, dev, scale=1.0, seed=0):
    g = np.random.RandomState(seed)
    return torch.as_tensor(g.rand(*shape) * scale, dtype=dtype, device=dev)


def _close(out, ref, scale, dtype, tol=TOL):
    err = (out.double() - ref.double()).abs().max().item()
    assert err <= tol[dtype] * max(float(scale), 1e-300), err


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,m,d", [(1, 1, 1), (33, 65, 3), (100, 37, 8),
                                   (257, 129, 2)])
def test_sqdist_ragged(dev, dtype, n, m, d):
    A = _rand((n, d), dtype, dev, 30.0, seed=1)
    B = _rand((m, d), dtype, dev, 30.0, seed=2)
    B[: min(n, m) // 2] = A[: min(n, m) // 2]
    out = gk.sqdist(A, B)
    ref = gk.sqdist_plain(A.double(), B.double())
    _close(out, ref, ref.abs().max(), dtype)
    k = min(n, m) // 2
    assert (torch.diagonal(out[:k, :k]) == 0).all()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kernel", ["RBF", "Matern52", "RationalQuadratic"])
@pytest.mark.parametrize("n", [1, 45, 130])
def test_masked_system_ragged(dev, dtype, kernel, n):
    Xs = _rand((n, 3), dtype, dev, 4.0)
    mask = (_rand((n,), dtype, dev, seed=3) > 0.2).to(dtype)
    v, nj = torch.tensor(0.7, dtype=dtype, device=dev), \
        torch.tensor(0.01, dtype=dtype, device=dev)
    a = torch.tensor(1.3, dtype=dtype, device=dev) \
        if kernel == "RationalQuadratic" else None
    Kt, A = gk.masked_system(Xs, mask, v, nj, a, kernel=kernel)
    Kr, Ar = gk.masked_system_plain(
        Xs.double(), mask.double(), v.double(), nj.double(),
        None if a is None else a.double(), kernel=kernel)
    _close(Kt, Kr, 0.7, dtype)
    _close(A, Ar, 1.0, dtype)
    assert (torch.diagonal(Kt) == v).all()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,d", [(1, 1), (37, 3), (300, 8), (1000, 2)])
def test_rbf_bwd_reductions_ragged_and_deterministic(dev, dtype, n, d):
    M = _rand((n, n), dtype, dev, seed=4)
    Ainv = M @ M.T / n + torch.eye(n, dtype=dtype, device=dev)
    Kt = _rand((n, n), dtype, dev, seed=5)
    Kt = 0.5 * (Kt + Kt.T)
    alpha = _rand((n,), dtype, dev, seed=6) - 0.5
    mask = (_rand((n,), dtype, dev, seed=7) > 0.1).to(dtype)
    X = _rand((n, d), dtype, dev, 10.0, seed=8)
    got = gk.rbf_bwd_reductions(Ainv, Kt, alpha, mask, X)
    again = gk.rbf_bwd_reductions(Ainv, Kt, alpha, mask, X)
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    d64 = [t.double() for t in (Ainv, Kt, alpha, mask, X)]
    ref = gk.rbf_bwd_reductions_plain(*d64)
    absW = ((d64[0] - d64[2][:, None] * d64[2][None, :]).abs()
            * d64[1].abs())
    row = absW.sum(dim=1).max()
    scales = (absW.sum(), row, row * 10.0, d64[0].diagonal().abs().sum())
    assert got[1].shape == (n,) and got[2].shape == (n, d)
    for g_, r_, s_ in zip(got, ref, scales):
        _close(g_, r_, s_, dtype, TOL_K3)


def test_sqdist_gradient_on_cuda(dev):
    A = _rand((70, 3), torch.float64, dev, 5.0, seed=9).requires_grad_(True)
    B = _rand((50, 3), torch.float64, dev, 5.0, seed=10).requires_grad_(True)
    G = _rand((70, 50), torch.float64, dev, seed=11)
    (gk.sqdist(A, B) * G).sum().backward()
    Ac = A.detach().cpu().requires_grad_(True)
    Bc = B.detach().cpu().requires_grad_(True)
    d2 = ((Ac[:, None, :] - Bc[None, :, :]) ** 2).sum(-1)
    (d2 * G.cpu()).sum().backward()
    torch.testing.assert_close(A.grad.cpu(), Ac.grad, rtol=1e-12, atol=1e-10)
    torch.testing.assert_close(B.grad.cpu(), Bc.grad, rtol=1e-12, atol=1e-10)


def test_each_launch_counts_once(dev):
    X = _rand((64, 2), torch.float32, dev)
    mask = torch.ones(64, dtype=torch.float32, device=dev)
    v = torch.tensor(1.0, device=dev)
    before = (gk.sqdist.launches, gk.masked_system.launches,
              gk.rbf_bwd_reductions.launches)
    gk.sqdist(X, X)
    Kt, A = gk.masked_system(X, mask, v, v * 0.1, kernel="RBF")
    gk.rbf_bwd_reductions(A, Kt, mask, mask, X)
    after = (gk.sqdist.launches, gk.masked_system.launches,
             gk.rbf_bwd_reductions.launches)
    assert [b - a for a, b in zip(before, after)] == [1, 1, 1]


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    X = _rand((16, 2), torch.float32, dev)
    with pytest.raises(ValueError, match="d <= 8"):
        gk.sqdist(_rand((16, 9), torch.float32, dev), _rand((4, 9),
                                                           torch.float32,
                                                           dev))
    with pytest.raises(ValueError, match="contiguous"):
        gk.sqdist(_rand((2, 16), torch.float32, dev).T, X)
    with pytest.raises(TypeError):
        gk.sqdist(X, X.double())
    with pytest.raises(TypeError):
        gk.sqdist(X.half(), X.half())
    with pytest.raises(ValueError):
        gk.sqdist(X, X.cpu())
    with pytest.raises(ValueError):
        gk.masked_system(X, torch.ones(15, device=dev), 1.0, 0.1,
                         kernel="RBF")


@pytest.mark.parametrize("kernel", ["RBF", "Matern52", "RationalQuadratic"])
def test_closed_form_loss_and_gradient_cuda_vs_cpu(dev, kernel):
    rng = np.random.RandomState(12)
    n_obs, n = 90, 128
    X = np.zeros((n, 2))
    X[:n_obs] = rng.rand(n_obs, 2) * 10
    y = np.zeros(n)
    y[:n_obs] = np.sin(X[:n_obs, 0]) + 0.05 * rng.randn(n_obs)
    mask = np.zeros(n)
    mask[:n_obs] = 1.0
    u0 = {"lengthscale": np.array([-0.4, 0.1]), "variance": np.asarray(0.3),
          "noise": np.asarray(-2.0)}
    if kernel == "RationalQuadratic":
        u0["alpha"] = np.asarray(0.2)
    bounds = {"ls_lo": np.zeros(2), "ls_hi": np.full(2, 5.0),
              "var_lo": np.asarray(1e-4), "var_hi": np.asarray(10.0)}
    out = {}
    for device in (dev, torch.device("cpu")):
        t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
        u = {k: t(v).requires_grad_(True) for k, v in u0.items()}
        loss = engine.exact_loss(u, t(X), t(y), t(mask),
                                 {k: t(v) for k, v in bounds.items()}, 1e-5,
                                 kernel=kernel)
        loss.backward()
        out[device.type] = [loss.detach().cpu()] + [
            u[k].grad.cpu() for k in u0]
    for a, b in zip(out["cuda"], out["cpu"]):
        torch.testing.assert_close(a, b, rtol=1e-9, atol=1e-12)
