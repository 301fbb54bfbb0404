"""
The CUDA kernels of gpim_tpu_torch against their plain PyTorch versions, on
the card: ragged shapes (the kernels mask partial tiles themselves; K1
shifts each row's 16-byte vectors to the row's own boundaries where m is not
a multiple of the vector width, and K2 and K3 take their scalar
instantiation where n is not), operands and outputs that do not start
16-byte aligned, every feature count up to 8, both dtypes, determinism, the
K1 gradient, the wrappers' validation and launch counts, and the
closed-form MLL and VFE gradients against the CPU path. One test, of the
bytes the kernels' bounds count, runs on the CPU.

The tests marked ``cuda`` need a CUDA device and skip without one. The file
imports no JAX, so it runs on a machine without it (there the repo's
conftest, which imports JAX, is left out):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py
"""

import numpy as np
import pytest
import torch

from gpim_tpu_torch.gpreg import engine
from gpim_tpu_torch.ops import gram_kernels as gk

cuda = pytest.mark.cuda

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


def _check_sqdist(out, A, B, dtype):
    """out against the float64 plain version; the first min(n, m) // 2
    points of A and B coincide and must give exactly 0."""
    ref = gk.sqdist_plain(A.double(), B.double())
    _close(out, ref, ref.abs().max(), dtype)
    k = min(len(A), len(B)) // 2
    assert (torch.diagonal(out[:k, :k]) == 0).all()


def _sqdist_inputs(n, m, d, dtype, dev):
    A = _rand((n, d), dtype, dev, 30.0, seed=1)
    B = _rand((m, d), dtype, dev, 30.0, seed=2)
    B[: min(n, m) // 2] = A[: min(n, m) // 2]
    return A, B


# m % 4 == 0 (f32) or m % 2 == 0 (f64) with an aligned output takes the
# vector path; every other m the shifted one (1027: the VFE's Kmm and Ks)
SQDIST_M = [1, 3, 4, 5, 127, 128, 129, 1027]
SQDIST_N = [1, 63, 64, 65, 1000]


@cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", range(1, 9))
@pytest.mark.parametrize("n", SQDIST_N)
@pytest.mark.parametrize("m", SQDIST_M)
def test_sqdist_ragged(dev, dtype, m, n, d):
    A, B = _sqdist_inputs(n, m, d, dtype, dev)
    _check_sqdist(gk.sqdist(A, B), A, B, dtype)


def _shifted(t, elems):
    """A contiguous copy of t that starts ``elems`` elements past a
    16-byte boundary."""
    buf = torch.empty(t.numel() + 4, dtype=t.dtype, device=t.device)
    s = buf[elems:elems + t.numel()].view(t.shape)
    s.copy_(t)
    assert s.is_contiguous()
    assert s.data_ptr() % 16 == elems * t.element_size() % 16
    return s


@cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m", [128, 129])
def test_sqdist_misaligned_operands_and_output(dev, dtype, m):
    """A and B 4 or 8 bytes off a 16-byte boundary through the wrapper, and
    an output that starts 1 (and, in f32, 2 and 3) elements off one through
    the C entry point: each row's vectors shift to its own boundaries."""
    n, d = 65, 3
    A, B = _sqdist_inputs(n, m, d, dtype, dev)
    _check_sqdist(gk.sqdist(_shifted(A, 1), _shifted(B, 1)), A, B, dtype)
    for off in range(1, 16 // A.element_size()):
        buf = torch.full((n * m + 4,), float("nan"), dtype=dtype, device=dev)
        out = buf[off:off + n * m].view(n, m)
        gk._launch("gpim_sqdist", dtype, gk._ptr(A), gk._ptr(B),
                   gk._ptr(out), n, m, d, gk._stream(A))
        torch.cuda.synchronize()
        _check_sqdist(out, A, B, dtype)
        # nothing written outside the output
        assert torch.isnan(buf[:off]).all()
        assert torch.isnan(buf[off + n * m:]).all()


# n % 4 == 0 (f32) or n % 2 == 0 (f64) takes the 16-byte vector path
RAGGED_N = [1, 3, 4, 45, 127, 128, 129, 130, 1000]


@cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kernel", ["RBF", "Matern52", "RationalQuadratic"])
@pytest.mark.parametrize("n", RAGGED_N)
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


def _bwd_inputs(n, d, dtype, dev):
    M = _rand((n, n), dtype, dev, seed=4)
    Ainv = M @ M.T / n + torch.eye(n, dtype=dtype, device=dev)
    Kt = _rand((n, n), dtype, dev, seed=5)
    Kt = 0.5 * (Kt + Kt.T)
    alpha = _rand((n,), dtype, dev, seed=6) - 0.5
    mask = (_rand((n,), dtype, dev, seed=7) > 0.1).to(dtype)
    X = _rand((n, d), dtype, dev, 10.0, seed=8)
    return Ainv, Kt, alpha, mask, X


def _check_bwd(got, inputs, dtype):
    n, d = inputs[4].shape
    d64 = [t.double() for t in inputs]
    ref = gk.rbf_bwd_reductions_plain(*d64)
    absW = ((d64[0] - d64[2][:, None] * d64[2][None, :]).abs()
            * d64[1].abs())
    row = absW.sum(dim=1).max()
    scales = (absW.sum(), row, row * 10.0, d64[0].diagonal().abs().sum())
    assert got[1].shape == (n,) and got[2].shape == (n, d)
    for g_, r_, s_ in zip(got, ref, scales):
        _close(g_, r_, s_, dtype, TOL_K3)


@cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", [1, 2, 3, 8])
@pytest.mark.parametrize("n", RAGGED_N[:-2] + [300, 1000])
def test_rbf_bwd_reductions_ragged_and_deterministic(dev, dtype, n, d):
    inputs = _bwd_inputs(n, d, dtype, dev)
    got = gk.rbf_bwd_reductions(*inputs)
    again = gk.rbf_bwd_reductions(*inputs)
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    _check_bwd(got, inputs, dtype)


@cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_rbf_bwd_reductions_misaligned_operands(dev, dtype):
    """Contiguous operands that start one element (4 or 8 bytes) past a
    16-byte boundary, at an n the vector path takes when aligned: the
    alignment check sends the call to the scalar instantiation."""
    n, d = 128, 2
    inputs = _bwd_inputs(n, d, dtype, dev)
    shifted = []
    for t in inputs:
        buf = torch.empty(t.numel() + 1, dtype=dtype, device=dev)
        s = buf[1:].view(t.shape)
        s.copy_(t)
        assert s.is_contiguous() and s.data_ptr() % 16 != 0
        shifted.append(s)
    _check_bwd(gk.rbf_bwd_reductions(*shifted), inputs, dtype)


@cuda
def test_rbf_bwd_reductions_bitwise_deterministic_at_flagship_size(dev):
    """n = 6144 in f32: many blocks finish in a different order each run,
    and the sums still come out bitwise equal."""
    inputs = _bwd_inputs(6144, 2, torch.float32, dev)
    first = gk.rbf_bwd_reductions(*inputs)
    for _ in range(3):
        for a, b in zip(first, gk.rbf_bwd_reductions(*inputs)):
            assert torch.equal(a, b)
    _check_bwd(first, inputs, torch.float32)


def test_min_traffic_counts_each_byte_once():
    """The bytes behind each kernel's bound (chip_smoke.py): every input
    read once, every output written once, at the flagship's shapes."""
    f32 = 4
    n, d = 6144, 2
    read, written, _ = gk.min_traffic("masked_system", n, d)
    assert written == 2 * n * n * f32 == 301_989_888
    assert read == (n * d + n + 3) * f32
    read, written, _ = gk.min_traffic("rbf_bwd_reductions", n, d)
    assert read == (2 * n * n + 2 * n + n * d) * f32
    assert written == (n + n * d + 2) * f32
    read, written, _ = gk.min_traffic("sqdist", 4096, d, m=n)
    assert (read, written) == ((4096 + n) * d * f32, 4096 * n * f32)
    read8, written8, _ = gk.min_traffic("masked_system", n, d, itemsize=8)
    assert (read8, written8) == (2 * (n * d + n + 3) * f32, 2 * 301_989_888)


@cuda
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


@cuda
@pytest.mark.parametrize("m", [128, 1027])
def test_sqdist_gradient_of_one_point_set_against_itself(dev, m):
    """Kmm = k(Xu, Xu): the same tensor in both arguments, so autograd adds
    K1's two gradients; against the CPU path's."""
    X = _rand((m, 3), torch.float64, dev, 5.0, seed=13).requires_grad_(True)
    G = _rand((m, m), torch.float64, dev, seed=14)
    (gk.sqdist(X, X) * G).sum().backward()
    Xc = X.detach().cpu().requires_grad_(True)
    (gk.sqdist_plain(Xc, Xc) * G.cpu()).sum().backward()
    torch.testing.assert_close(X.grad.cpu(), Xc.grad, rtol=1e-11, atol=1e-9)


@cuda
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


@cuda
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
    with pytest.raises(ValueError, match="needs alpha"):
        gk.masked_system(X, torch.ones(16, device=dev), 1.0, 0.1,
                         kernel="RationalQuadratic")


@cuda
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


@cuda
@pytest.mark.parametrize("kernel", ["RBF", "Matern52", "RationalQuadratic"])
def test_vfe_loss_and_gradient_cuda_vs_cpu(dev, kernel):
    """The VFE bound and its gradient in every parameter, the inducing
    points included, through K1 on the card against the CPU path, f64."""
    rng = np.random.RandomState(15)
    n_obs, n, m = 150, 256, 37
    X = np.zeros((n, 3))
    X[:n_obs] = rng.rand(n_obs, 3) * 10
    y = np.zeros(n)
    y[:n_obs] = np.sin(X[:n_obs, 0]) + 0.05 * rng.randn(n_obs)
    mask = np.zeros(n)
    mask[:n_obs] = 1.0
    u0 = {"lengthscale": np.array([-0.4, 0.1, 0.0]),
          "variance": np.asarray(0.3), "noise": np.asarray(-2.0),
          "Xu": X[:n_obs:4][:m] + 0.1}
    if kernel == "RationalQuadratic":
        u0["alpha"] = np.asarray(0.2)
    bounds = {"ls_lo": np.zeros(3), "ls_hi": np.full(3, 5.0),
              "var_lo": np.asarray(1e-4), "var_hi": np.asarray(10.0)}
    out = {}
    for device in (dev, torch.device("cpu")):
        t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
        u = {k: t(v).requires_grad_(True) for k, v in u0.items()}
        before = gk.sqdist.launches
        loss = engine.vfe_loss(u, t(X), t(y), t(mask),
                               {k: t(v) for k, v in bounds.items()}, 1e-5,
                               kernel=kernel)
        loss.backward()
        if device.type == "cuda":
            assert gk.sqdist.launches - before == 2      # Kmm and Kmn
        out[device.type] = [loss.detach().cpu()] + [
            u[k].grad.cpu() for k in u0]
    for a, b in zip(out["cuda"], out["cpu"]):
        torch.testing.assert_close(a, b, rtol=1e-8, atol=1e-10)
