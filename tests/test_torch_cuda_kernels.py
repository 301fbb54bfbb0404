"""
The CUDA kernels of gpim_tpu_torch against their plain PyTorch versions, on
the card: ragged shapes (the kernels mask partial tiles themselves; K1
shifts each row's 16-byte vectors to the row's own boundaries where m is not
a multiple of the vector width, and K2 and K3 take their scalar
instantiation where n is not), operands and outputs that do not start
16-byte aligned, every feature count up to 8, both dtypes, determinism, the
K1 gradient, the wrappers' validation and launch counts, and the
closed-form MLL and VFE gradients against the CPU path; and the task axis
of all three (T = 1, 3 and 64 problems in one launch, ragged n, K3's
determinism task by task, unbatched calls the same launch as one task) with
the multi-output losses and gradients against the CPU path; and K1 at the
exact Kronecker route's one-feature shapes, with the Kronecker and spectral
losses and gradients against the CPU path; K1 at the masked-lattice and
off-lattice SKI routes' factor shapes, with their operators and losses
against the CPU path; K4, the off-lattice interpolation adjoint, against
its plain version on ragged grids with empty cells, bit-equal run to run
and to the plain version on the CPU (also where one cell's entries span
chunks), and launched by an off-lattice run(); the f32 predictive sd in the
cancellation regime; utils.profiling.trace holding every kernel a run
launched. One test, of the bytes the kernels' bounds count,
runs on the CPU.

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
                   gk._ptr(out), n, m, d, 1, gk._stream(A))
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
    # K4 at the 1M off-lattice cube, the SKI engine's layout: v, the
    # weights corner by corner, the corner pointers, the (G, b) output;
    # ~35 MB
    pts, G, b = 314624, 70 ** 3, 9
    read, written, ops = gk.min_traffic("interp_adjoint", pts, 3, m=G,
                                        batch=b)
    assert read == (pts * b + 8 * pts + G + 1) * f32
    assert written == G * b * f32 and ops == 2 * 8 * pts * b
    assert 35.0e6 < read + written < 35.2e6


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


# --------------------------------------------------------------------------
# The task axis (the multi-output GP): T problems in one launch
# --------------------------------------------------------------------------

TASKS = [1, 3, 64]


def _per_task_close(out, ref, scale, dtype, tol=TOL):
    """``out`` against ``ref`` task by task, each at its own scale."""
    for o, r, s in zip(out, ref, scale):
        _close(o, r, s, dtype, tol)


@cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("tasks", TASKS)
@pytest.mark.parametrize("n, m", [(45, 129), (128, 128), (130, 5)])
def test_batched_sqdist_against_plain(dev, dtype, tasks, n, m):
    """(T, n, d) x (T, m, d): every task against the plain version, exact
    zeros at each task's coincident points, on the vector path (m = 128)
    and the shifted one (m = 129, 5), where a task's rows start at other
    16-byte offsets than the first task's."""
    A = _rand((tasks, n, 3), dtype, dev, 30.0, seed=1)
    B = _rand((tasks, m, 3), dtype, dev, 30.0, seed=2)
    k = min(n, m) // 2
    B[:, :k] = A[:, :k]
    out = gk.sqdist(A, B)
    assert out.shape == (tasks, n, m)
    ref = gk.sqdist_plain(A.double(), B.double())
    _per_task_close(out, ref, ref.abs().amax(dim=(1, 2)), dtype)
    assert (torch.diagonal(out[:, :k, :k], dim1=-2, dim2=-1) == 0).all()
    last = gk.sqdist(A[-1].contiguous(), B[-1].contiguous())
    _close(out[-1], last, ref[-1].abs().max(), dtype)


@cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kernel", ["RBF", "Matern52", "RationalQuadratic"])
@pytest.mark.parametrize("tasks", TASKS)
@pytest.mark.parametrize("n", [45, 128, 130])
def test_batched_masked_system_against_plain(dev, dtype, kernel, tasks, n):
    """Xs (T, n, d) with T values of v, noise + jitter and alpha, the mask
    shared; n = 45 takes the scalar instantiation, 128 and 130 (f64) the
    vector one."""
    Xs = _rand((tasks, n, 3), dtype, dev, 4.0)
    mask = (_rand((n,), dtype, dev, seed=3) > 0.2).to(dtype)
    v = 0.5 + _rand((tasks,), dtype, dev, seed=4)
    nj = 0.01 * _rand((tasks,), dtype, dev, seed=5)
    a = (1.0 + _rand((tasks,), dtype, dev, seed=6)
         if kernel == "RationalQuadratic" else None)
    Kt, A = gk.masked_system(Xs, mask, v, nj, a, kernel=kernel)
    assert Kt.shape == A.shape == (tasks, n, n)
    Kr, Ar = gk.masked_system_plain(
        Xs.double(), mask.double(), v.double(), nj.double(),
        None if a is None else a.double(), kernel=kernel)
    _per_task_close(Kt, Kr, v, dtype)
    _per_task_close(A, Ar, v + 1.0, dtype)
    assert (torch.diagonal(Kt, dim1=-2, dim2=-1) == v[:, None]).all()
    Kl, Al = gk.masked_system(Xs[-1].contiguous(), mask, v[-1], nj[-1],
                              None if a is None else a[-1], kernel=kernel)
    _close(Kt[-1], Kl, v[-1], dtype)
    _close(A[-1], Al, v[-1] + 1.0, dtype)


def _batched_bwd_inputs(tasks, n, d, dtype, dev):
    M = _rand((tasks, n, n), dtype, dev, seed=4)
    Ainv = M @ M.mT / n + torch.eye(n, dtype=dtype, device=dev)
    Kt = _rand((tasks, n, n), dtype, dev, seed=5)
    Kt = 0.5 * (Kt + Kt.mT)
    alpha = _rand((tasks, n), dtype, dev, seed=6) - 0.5
    mask = (_rand((n,), dtype, dev, seed=7) > 0.1).to(dtype)
    X = _rand((n, d), dtype, dev, 10.0, seed=8)
    return Ainv, Kt, alpha, mask, X


def _check_batched_bwd(got, inputs, dtype):
    Ainv, Kt, alpha, mask, X = [t.double() for t in inputs]
    tasks, n = alpha.shape
    assert [tuple(g.shape) for g in got] == [
        (tasks,), (tasks, n), (tasks, n, X.shape[1]), (tasks,)]
    for t in range(tasks):
        absW = ((Ainv[t] - alpha[t][:, None] * alpha[t][None, :]).abs()
                * Kt[t].abs())
        row = absW.sum(dim=1).max()
        scales = (absW.sum(), row, row * 10.0,
                  Ainv[t].diagonal().abs().sum())
        ref = gk.rbf_bwd_reductions_plain(Ainv[t], Kt[t], alpha[t], mask, X)
        for g_, r_, s_ in zip(got, ref, scales):
            _close(g_[t], r_, s_, dtype, TOL_K3)


@cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("tasks", TASKS)
@pytest.mark.parametrize("n", [45, 128, 300])
def test_batched_rbf_bwd_reductions_against_plain_and_deterministic(
        dev, dtype, tasks, n):
    """Ainv, Kt (T, n, n), alpha (T, n), mask and X shared: every task
    against the plain version, and bitwise the same in every run (each
    task sums its blocks in a fixed order)."""
    inputs = _batched_bwd_inputs(tasks, n, 2, dtype, dev)
    got = gk.rbf_bwd_reductions(*inputs)
    for _ in range(2):
        for a, b in zip(got, gk.rbf_bwd_reductions(*inputs)):
            assert torch.equal(a, b)
    _check_batched_bwd(got, inputs, dtype)


@cuda
def test_batched_rbf_bwd_reductions_bitwise_deterministic_per_task(dev):
    """T = 64 at n = 1024 in f32: 8192 blocks finishing in another order
    each run, 64 finish counters; every task's sums bitwise the same."""
    inputs = _batched_bwd_inputs(64, 1024, 2, torch.float32, dev)
    first = gk.rbf_bwd_reductions(*inputs)
    for _ in range(3):
        for a, b in zip(first, gk.rbf_bwd_reductions(*inputs)):
            assert torch.equal(a, b)


@cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_unbatched_calls_are_the_batched_kernel_at_one_task(dev, dtype):
    """An unbatched call and a batched call of one task are the same launch
    and give the same bits, for all three kernels."""
    A = _rand((200, 3), dtype, dev, 30.0, seed=1)
    B = _rand((129, 3), dtype, dev, 30.0, seed=2)
    assert torch.equal(gk.sqdist(A, B), gk.sqdist(A[None], B[None])[0])
    mask = (_rand((200,), dtype, dev, seed=3) > 0.2).to(dtype)
    v, nj = _rand((1,), dtype, dev, seed=4), _rand((1,), dtype, dev, seed=5)
    one = gk.masked_system(A, mask, v[0], nj[0], kernel="RBF")
    batched = gk.masked_system(A[None], mask, v, nj, kernel="RBF")
    for a, b in zip(one, batched):
        assert torch.equal(a, b[0])
    inputs = _batched_bwd_inputs(1, 200, 3, dtype, dev)
    batched = gk.rbf_bwd_reductions(*inputs)
    one = gk.rbf_bwd_reductions(inputs[0][0], inputs[1][0], inputs[2][0],
                                *inputs[3:])
    for a, b in zip(one, batched):
        assert torch.equal(a, b[0])


@cuda
def test_a_batched_call_is_one_launch_and_checks_its_shapes(dev):
    X = _rand((5, 64, 2), torch.float32, dev)
    mask = torch.ones(64, dtype=torch.float32, device=dev)
    v = torch.ones(5, device=dev)
    before = (gk.sqdist.launches, gk.masked_system.launches,
              gk.rbf_bwd_reductions.launches)
    gk.sqdist(X, X)
    Kt, A = gk.masked_system(X, mask, v, v * 0.1, kernel="RBF")
    gk.rbf_bwd_reductions(A, Kt, X[..., 0].contiguous(), mask, X[0])
    after = (gk.sqdist.launches, gk.masked_system.launches,
             gk.rbf_bwd_reductions.launches)
    assert [b - a for a, b in zip(before, after)] == [1, 1, 1]
    with pytest.raises(ValueError, match="scalars must have shape"):
        gk.masked_system(X, mask, v[0], v[0], kernel="RBF")
    with pytest.raises(ValueError, match="do not pair"):
        gk.sqdist(X, X[:4])
    with pytest.raises(ValueError, match="expected"):
        gk.rbf_bwd_reductions(A, Kt, mask, mask, X[0])


def _multi_problem(rng, n_obs=90, n=128, T=3):
    X = np.zeros((n, 2))
    X[:n_obs] = rng.rand(n_obs, 2) * 10
    Y = np.zeros((n, T))
    Y[:n_obs] = np.stack([np.sin(X[:n_obs, 0] / (1 + t))
                          + 0.05 * rng.randn(n_obs) for t in range(T)], -1)
    mask = np.zeros(n)
    mask[:n_obs] = 1.0
    return X, Y, mask


@cuda
@pytest.mark.parametrize("kernel", ["RBF", "Matern52"])
def test_multi_output_losses_and_gradients_cuda_vs_cpu(dev, kernel):
    """The independent loss (K2 and, for RBF, K3 with a task axis) and the
    correlated loss (K1) with their gradients, card against CPU, f64."""
    from gpim_tpu_torch.gpreg import multi
    rng = np.random.RandomState(16)
    X, Y, mask = _multi_problem(rng)
    T = Y.shape[1]
    u_iv = {"lengthscale": -0.5 + 0.2 * rng.randn(T, 2),
            "outputscale": 0.1 * rng.randn(T), "noise": np.full(T, -2.0),
            "mean": 0.1 * rng.randn(T)}
    u_corr = {"lengthscale": np.array([-0.4, 0.1]), "noise": np.asarray(-1.5),
              "mean": 0.1 * rng.randn(T), "F": rng.rand(T, 1),
              "task_var": np.full(T, -0.4)}
    bounds = {"ls_lo": np.zeros(2), "ls_hi": np.full(2, 6.0)}
    out = {}
    for device in (dev, torch.device("cpu")):
        t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
        b = {k: t(v) for k, v in bounds.items()}
        u1 = {k: t(v).requires_grad_(True) for k, v in u_iv.items()}
        u2 = {k: t(v).requires_grad_(True) for k, v in u_corr.items()}
        before = (gk.masked_system.launches, gk.rbf_bwd_reductions.launches)
        l1 = multi._iv_loss(u1, t(X), t(Y), t(mask), b, 1e-5,
                            kernel=kernel)[0]
        l1.backward()
        if device.type == "cuda":
            assert (gk.masked_system.launches - before[0],
                    gk.rbf_bwd_reductions.launches - before[1]) == (
                        1, 1 if kernel == "RBF" else 0)
        n_obs = int(mask.sum())
        l2 = multi._corr_loss(u2, t(X[:n_obs]), t(Y[:n_obs]), b, 1e-5,
                              kernel=kernel)[0]
        l2.backward()
        out[device.type] = [l1.detach().cpu(), l2.detach().cpu()] + [
            u[k].grad.cpu() for u in (u1, u2) for k in u]
    for a, b in zip(out["cuda"], out["cpu"]):
        torch.testing.assert_close(a, b, rtol=1e-8, atol=1e-10)


# --------------------------------------------------------------------------
# The structured-kernel slice: K1 at d = 1 on the Kronecker shapes, the
# Kronecker and spectral losses card against CPU
# --------------------------------------------------------------------------

# the 10 x 10 x 64 x 5 cKPFM grid: each factor (G, G), each predict chunk's
# cross rows (4096, G), one feature
KRON_SHAPES = [(10, 10), (64, 64), (5, 5), (4096, 64), (4096, 10),
               (4096, 5)]


@cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n, m", KRON_SHAPES)
def test_sqdist_at_the_kronecker_shapes(dev, dtype, n, m):
    """Grid coordinates over a lengthscale: the factor diagonals, and every
    cross row at a grid point, are exactly 0."""
    g = torch.arange(m, dtype=dtype, device=dev)[:, None] / 1.7
    x = (torch.arange(n, device=dev) % m).to(dtype)[:, None] / 1.7
    out = gk.sqdist(x, g)
    _close(out, gk.sqdist_plain(x.double(), g.double()),
           float(m - 1) ** 2 / 1.7 ** 2, dtype)
    rows = torch.arange(n, device=dev)
    assert (out[rows, rows % m] == 0).all()


def _kron_problem(rng, dims=(6, 5, 4)):
    axes = [np.arange(s, dtype=float) for s in dims]
    Y = rng.rand(*dims)
    u = {"lengthscale": np.array([0.3, -0.2, 0.1]),
         "outputscale": np.asarray(0.2), "noise": np.asarray(-2.0),
         "mean": np.asarray(0.4)}
    bounds = {"ls_lo": np.zeros(3), "ls_hi": np.full(3, 5.0)}
    return axes, Y, u, bounds


@cuda
@pytest.mark.parametrize("kernel", ["RBF", "Matern52"])
def test_kronecker_loss_and_gradient_cuda_vs_cpu(dev, kernel):
    """The exact Kronecker loss (one K1 launch a factor, eigh, the
    factor-level backward) and its gradient, card against CPU, f64."""
    from gpim_tpu_torch.gpreg import kron_model
    axes, Y, u0, bounds = _kron_problem(np.random.RandomState(17))
    out = {}
    for device in (dev, torch.device("cpu")):
        t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
        u = {k: t(v).requires_grad_(True) for k, v in u0.items()}
        before = gk.sqdist.launches
        loss, _ = kron_model._loss(u, [t(a) for a in axes], t(Y),
                                   {k: t(v) for k, v in bounds.items()},
                                   1e-5, kernel)
        loss.backward()
        if device.type == "cuda":
            assert gk.sqdist.launches - before == len(axes)
        out[device.type] = [loss.detach().cpu()] + [
            u[k].grad.cpu() for k in u0]
    for a, b in zip(out["cuda"], out["cpu"]):
        torch.testing.assert_close(a, b, rtol=1e-9, atol=1e-12)


@cuda
def test_spectral_loss_and_gradient_cuda_vs_cpu(dev):
    """The spectral mixture loss (plain PyTorch Gram, mll_from_gram's
    closed-form backward) and its gradient, card against CPU, f64; no
    kernel of the package is launched."""
    from gpim_tpu_torch.gpreg import structured
    rng = np.random.RandomState(18)
    n_obs, n = 90, 128
    X = np.zeros((n, 2))
    X[:n_obs] = rng.rand(n_obs, 2) * 10
    y = np.zeros(n)
    y[:n_obs] = np.sin(X[:n_obs, 0]) + 0.05 * rng.randn(n_obs)
    mask = np.zeros(n)
    mask[:n_obs] = 1.0
    u0 = {"weights": rng.randn(3) * 0.3, "means": rng.randn(3, 2) - 2.0,
          "scales": rng.randn(3, 2) - 1.5, "noise": np.asarray(-2.0),
          "mean": np.asarray(0.1)}
    out = {}
    for device in (dev, torch.device("cpu")):
        t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
        u = {k: t(v).requires_grad_(True) for k, v in u0.items()}
        before = (gk.sqdist.launches, gk.masked_system.launches,
                  gk.rbf_bwd_reductions.launches)
        loss, info = structured._sm_loss(u, t(X), t(y), t(mask), 1e-5)
        loss.backward()
        assert int(info) == 0
        assert (gk.sqdist.launches, gk.masked_system.launches,
                gk.rbf_bwd_reductions.launches) == before
        out[device.type] = [loss.detach().cpu()] + [
            u[k].grad.cpu() for k in u0]
    for a, b in zip(out["cuda"], out["cpu"]):
        torch.testing.assert_close(a, b, rtol=1e-9, atol=1e-12)


# --------------------------------------------------------------------------
# The masked-lattice slice: K1 at its factor shapes (d = 1), the masked
# operator, the split solve and the SKI loss card against CPU
# --------------------------------------------------------------------------

# ski_masked64x64x32, mgrid_masked128x128x64 and mgrid_masked256x256x64:
# each factor (G, G), and predict's cross factors on the same grid
MGRID_SHAPES = [(32, 32), (64, 64), (128, 128), (256, 256)]


@cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n, m", MGRID_SHAPES)
def test_sqdist_at_the_masked_lattice_shapes(dev, dtype, n, m):
    g = torch.arange(m, dtype=dtype, device=dev)[:, None] / 12.0
    out = gk.sqdist(g[:n], g)
    _close(out, gk.sqdist_plain(g[:n].double(), g.double()),
           float(m - 1) ** 2 / 144.0, dtype)
    assert (torch.diagonal(out) == 0).all()


def _mgrid_problem(rng, gshape=(12, 10, 7)):
    axes = [np.arange(g, dtype=float) for g in gshape]
    mask = (rng.rand(int(np.prod(gshape))) < 0.6).astype(float)
    y = rng.rand(mask.size) * mask
    u = {"lengthscale": np.array([0.3, -0.2, 0.1]),
         "outputscale": np.asarray(0.2), "noise": np.asarray(-2.0),
         "mean": np.asarray(0.4)}
    bounds = {"ls_lo": np.zeros(3), "ls_hi": np.full(3, 5.0)}
    g0 = np.random.default_rng(0).choice([-1.0, 1.0], size=(8, mask.size))
    return gshape, axes, mask, y, u, bounds, g0


@cuda
@pytest.mark.parametrize("kernel", ["RBF", "Matern52"])
def test_masked_lattice_loss_and_gradient_cuda_vs_cpu(dev, kernel):
    """The masked-lattice SKI loss (the factored preconditioner, split CG,
    SLQ, the surrogate backward; one K1 launch a factor) and its gradient,
    card against CPU, f64, with the same realized CG iterations."""
    from gpim_tpu_torch.gpreg import mgrid_model
    gshape, axes, mask, y, u0, bounds, g0 = _mgrid_problem(
        np.random.RandomState(19))
    out = {}
    for device in (dev, torch.device("cpu")):
        t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
        u = {k: t(v).requires_grad_(True) for k, v in u0.items()}
        tb = {k: t(v) for k, v in bounds.items()}
        taxes = [t(a) for a in axes]
        Qp, lam = mgrid_model._build_precond(u, taxes, t(mask), tb,
                                             kernel=kernel, rank=100)
        before = gk.sqdist.launches
        loss, it = mgrid_model._loss(
            u, taxes, t(mask), t(g0), Qp, lam, t(y), tb, 1e-5,
            kernel=kernel, grid_shape=gshape, cg_iters=60,
            record_iters=True)
        loss.backward()
        if device.type == "cuda":
            assert gk.sqdist.launches - before == len(axes)
        out[device.type] = [loss.detach().cpu(), it.cpu()] + [
            u[k].grad.cpu() for k in u0]
    assert float(out["cuda"][1]) == float(out["cpu"][1])
    for a, b in zip(out["cuda"], out["cpu"]):
        torch.testing.assert_close(a, b, rtol=1e-9, atol=1e-12)


@cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_masked_operator_and_split_solve_cuda_vs_cpu(dev, dtype):
    """The masked mvm in both layouts and the split-preconditioned solve on
    the factored basis, card against CPU."""
    from gpim_tpu_torch.ops import ski
    gshape, axes, mask, y, _, _, _ = _mgrid_problem(
        np.random.RandomState(20))
    V = np.random.RandomState(21).randn(3, mask.size)
    out = {}
    for device in (dev, torch.device("cpu")):
        t = lambda a: torch.as_tensor(a, dtype=dtype,  # noqa: E731
                                      device=device)
        p = {"lengthscale": t([2.0, 1.5, 1.2]), "variance": t(1.3)}
        factors = ski.grid_kernel_factors("RBF", p, [t(a) for a in axes])
        noise = t(0.05)
        bf = ski.make_masked_grid_mvm(gshape, t(mask), batch_first=True)
        col = ski.make_masked_grid_mvm(gshape, t(mask))
        q, lam, _, _ = ski.mgrid_split_root(factors, t(mask), 100)
        pis, _ = ski.split_apply(q, lam, noise, vec_axis=1)
        X, _, _, k = ski.split_pcg(lambda v: bf(factors, noise, v), pis,
                                   t(V), 100, return_iters=True, vec_axis=1)
        out[device.type] = [bf(factors, noise, t(V)).cpu(),
                            col(factors, noise, t(V.T)).mT.cpu(), X.cpu()]
        torch.testing.assert_close(out[device.type][0],
                                   out[device.type][1])
    f64 = dtype == torch.float64
    for a, b in zip(out["cuda"][:2], out["cpu"][:2]):
        torch.testing.assert_close(a, b, rtol=1e-12 if f64 else 1e-5,
                                   atol=1e-12 if f64 else 1e-5)
    # CG stops at a relative residual of 100 eps: in float32 the two
    # solutions agree to that times the split operator's condition number
    X, Xc = out["cuda"][2], out["cpu"][2]
    scale = float(Xc.abs().max())
    assert float((X - Xc).abs().max()) <= (1e-9 if f64 else 2e-3) * scale


# --------------------------------------------------------------------------
# The off-lattice slice: K1 at its inducing-grid factor shapes (d = 1), the
# interpolation operator and the off-lattice SKI loss card against CPU
# --------------------------------------------------------------------------

# ski_offlattice64x64x32 and ski_offlattice128x128x64: choose_grid's 36 and
# 70 points a dimension, each factor (g, g)
SKI_SHAPES = [(36, 36), (70, 70)]


@cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n, m", SKI_SHAPES)
def test_sqdist_at_the_off_lattice_shapes(dev, dtype, n, m):
    step = 63.0 / (m - 3)
    g = torch.as_tensor(np.linspace(-step, 63.0 + step, m)[:, None] / 12.0,
                        dtype=dtype, device=dev)
    out = gk.sqdist(g[:n], g)
    _close(out, gk.sqdist_plain(g[:n].double(), g.double()),
           float(g.max() - g.min()) ** 2, dtype)
    assert (torch.diagonal(out) == 0).all()


def _ski_problem(rng, n=700, d=3):
    from gpim_tpu_torch.ops import ski
    X = rng.rand(n, d) * 12.0
    mask = (rng.rand(n) < 0.9).astype(float)
    grids = ski.choose_grid(X, ratio=1.2)
    u = {"lengthscale": np.array([0.3, -0.2, 0.1])[:d],
         "outputscale": np.asarray(0.2), "noise": np.asarray(-2.0),
         "mean": np.asarray(0.4)}
    bounds = {"ls_lo": np.zeros(d), "ls_hi": np.full(d, 6.0)}
    y = np.sin(X[:, 0] / 3.0) * mask
    return X, mask, grids, y, u, bounds


@cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_off_lattice_operator_cuda_vs_cpu(dev, dtype):
    """W K_UU W^T v + noise v (K4's sum onto the grid, mode products,
    gather) on a (5, n) block, card against CPU: the mode products' gemms
    sum in another order, so the two agree to round-off."""
    from gpim_tpu_torch.ops import ski
    X, mask, grids, _, _, _ = _ski_problem(np.random.RandomState(22))
    idx, wgt = ski.build_interp(X, grids, mask)
    V = np.random.RandomState(23).randn(5, len(X))
    out = {}
    for device in (dev, torch.device("cpu")):
        t = lambda a: torch.as_tensor(a, dtype=dtype,  # noqa: E731
                                      device=device)
        p = {"lengthscale": t([2.0, 1.5, 1.2]), "variance": t(1.3)}
        factors = ski.grid_kernel_factors("RBF", p, [t(g) for g in grids])
        mvm = ski.make_interp_mvm(
            torch.as_tensor(idx, dtype=torch.int64, device=device), t(wgt),
            tuple(len(g) for g in grids))
        out[device.type] = mvm(factors, t(0.05), t(V)).cpu()
    f64 = dtype == torch.float64
    torch.testing.assert_close(out["cuda"], out["cpu"],
                               rtol=1e-12 if f64 else 1e-5,
                               atol=1e-12 if f64 else 1e-5)


@cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_off_lattice_loss_and_gradient_cuda_vs_cpu(dev, dtype):
    """The off-lattice SKI loss (the dense Nystrom preconditioner of the
    interpolated eigen-root, split CG, SLQ, the surrogate backward; one K1
    launch a grid factor) and its gradient, card against CPU, with the
    same realized CG iterations in float64; float32 within 1e-3."""
    from gpim_tpu_torch.gpreg import ski_model
    from gpim_tpu_torch.ops import ski
    X, mask, grids, y, u0, bounds = _ski_problem(np.random.RandomState(24))
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    out = {}
    for device in (dev, torch.device("cpu")):
        eng = ski_model.SKIEngine("RBF", X.astype(np_dtype),
                                  mask.astype(np_dtype), grids, dtype,
                                  device, cg_iters=60, precond_rank=100,
                                  seed=1)
        t = lambda a: torch.as_tensor(a, dtype=dtype,  # noqa: E731
                                      device=device)
        u = {k: t(v).requires_grad_(True) for k, v in u0.items()}
        tb = {k: t(v) for k, v in bounds.items()}
        Qp, lam = ski_model._build_precond(
            u, eng._grids, eng._i0, eng._w0, eng._mask, tb, kernel="RBF",
            rank=eng.precond_rank)
        core = ski.ski_mll(eng._idx, eng._wgt, eng.grid_shape,
                           eng.cg_iters, eng._g0, return_iters=True)
        before = gk.sqdist.launches
        loss, it = ski_model._loss(
            u, eng._grids, core, Qp, lam, t(y)[eng._perm],
            t(mask)[eng._perm], tb, 1e-5, kernel="RBF", record_iters=True)
        loss.backward()
        if device.type == "cuda":
            assert gk.sqdist.launches - before == len(grids)
        out[device.type] = [loss.detach().cpu(), it.cpu()] + [
            u[k].grad.cpu() for k in u0]
    f64 = dtype == torch.float64
    if f64:
        assert float(out["cuda"][1]) == float(out["cpu"][1])
    for a, b in zip(out["cuda"], out["cpu"]):
        torch.testing.assert_close(a, b, rtol=1e-9 if f64 else 1e-3,
                                   atol=1e-12 if f64 else 1e-3)


# ---------------------------------------------------------------------------
# the f32 predictive sd in the cancellation regime (the twin of
# tests/test_round3_fixes.py::test_predictive_sd_f32_small_noise_long_
# lengthscale): cuSOLVER's Cholesky and the triangular inverse round
# otherwise than the CPU's
# ---------------------------------------------------------------------------

def sd_cancellation_case(device):
    """engine.predict_exact in float32 on ``device`` against a
    backward-stable float64 numpy twin (Cholesky solves, no explicit
    inverse) at tiny noise and a lengthscale of half the domain, where the
    posterior sd collapses toward sqrt(noise) near the data: returns (the
    largest mean error over the largest |mean|, the largest sd error over
    the prior sd, the smallest sd)."""
    from gpim_tpu_torch.kernels.transforms import (interval_inverse,
                                                   positive_inverse)
    rng = np.random.RandomState(3)
    n, m = 256, 128
    X64 = rng.uniform(0.0, 20.0, size=(n, 2))
    y64 = np.sin(0.3 * X64[:, 0]) * np.cos(0.2 * X64[:, 1])
    Xt64 = rng.uniform(0.0, 20.0, size=(m, 2))
    ls, var, noise, jitter = 10.0, 1.0, 1e-4, 1e-6

    def k64(A, B):
        d2 = ((A[:, None, :] - B[None, :, :]) ** 2).sum(-1)
        return var * np.exp(-0.5 * d2 / ls ** 2)

    A = k64(X64, X64) + (noise + jitter) * np.eye(n)
    L = np.linalg.cholesky(A)
    Ks = k64(Xt64, X64)
    mean64 = Ks @ np.linalg.solve(A, y64)
    V = np.linalg.solve(L, Ks.T)
    sd64 = np.sqrt(var - np.sum(V * V, axis=0) + noise)

    t = lambda a: torch.as_tensor(np.asarray(a, np.float32),  # noqa: E731
                                  device=device)
    bounds = {"ls_lo": t([0.1, 0.1]), "ls_hi": t([20.0, 20.0]),
              "var_lo": t(1e-4), "var_hi": t(10.0)}
    u = {"lengthscale": interval_inverse(t([ls, ls]), bounds["ls_lo"],
                                         bounds["ls_hi"]),
         "variance": interval_inverse(t(var), bounds["var_lo"],
                                      bounds["var_hi"]),
         "noise": positive_inverse(t(noise))}
    mean32, var32 = engine.predict_exact(
        u, t(X64), t(y64), t(np.ones(n)), bounds, t(jitter),
        t(Xt64).reshape(1, m, 2), kernel="RBF", noiseless=False)
    mean32 = mean32.cpu().numpy()
    sd32 = np.sqrt(var32.cpu().numpy())
    return (np.max(np.abs(mean32 - mean64)) / np.max(np.abs(mean64)),
            np.max(np.abs(sd32 - sd64)) / np.sqrt(var), float(sd32.min()))


@cuda
def test_predictive_sd_f32_small_noise_long_lengthscale(dev):
    """On the card: the mean within 1e-3 of its scale, the sd within 5e-3
    of the prior sd and never negative."""
    mean_err, sd_err, sd_min = sd_cancellation_case(dev)
    assert mean_err < 1e-3 and sd_err < 5e-3 and sd_min >= 0.0


# ---------------------------------------------------------------------------
# K4: the interpolation adjoint
# ---------------------------------------------------------------------------

# normalized by the largest sum of |w v| over a cell: a few f32 roundings
TOL_K4 = {torch.float32: 1e-6, torch.float64: 1e-12}


def _k4_problem(dev, dtype, d, n, ratio, seed=0, cluster=0, sort=False):
    """W's layout for n random points (the first ``cluster`` of them in
    one cell) on choose_grid's grid, on ``dev``; with ``sort`` the points
    sorted by their lower corner, as the SKI engine sorts them."""
    from gpim_tpu_torch.ops import ski
    rng = np.random.RandomState(seed)
    X = rng.rand(n, d) * 10.0
    X[:cluster] = 5.01 + rng.rand(cluster, d) * 0.01
    mask = (rng.rand(n) < 0.85).astype(float)
    grids = ski.choose_grid(X, ratio=ratio)
    idx, wgt = ski.build_interp(X, grids, mask)
    if sort:
        perm = np.argsort(idx[:, 0], kind="stable")
        idx, wgt = idx[perm], wgt[perm]
    G = int(np.prod([len(g) for g in grids]))
    return gk.interp_layout(
        torch.as_tensor(idx, dtype=torch.int64, device=dev),
        torch.as_tensor(wgt, dtype=dtype, device=dev), G)


@cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b", [1, 9, 100])
@pytest.mark.parametrize("d, n, ratio", [(2, 3000, 1.9), (3, 5000, 1.25)])
def test_interp_adjoint_matches_plain(dev, dtype, b, d, n, ratio):
    """Ragged grids (G not a multiple of the block) with many empty cells,
    which come out exactly 0; two launches bit-equal; one launch counted."""
    lay = _k4_problem(dev, dtype, d, n, ratio)
    counts = lay.rowptr.diff()
    assert (counts == 0).any() and lay.G * b % 256 != 0
    v = _rand((b, n), dtype, dev, seed=b) - 0.5
    before = gk.interp_adjoint.launches
    out = gk.interp_adjoint(lay, v)
    again = gk.interp_adjoint(lay, v)
    assert gk.interp_adjoint.launches - before == 2
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    assert (out[counts == 0] == 0).all()
    lay64 = lay._replace(wgt=lay.wgt.double())
    ref = gk.interp_adjoint_plain(lay64, v.double())
    scale = gk.interp_adjoint_plain(lay64._replace(wgt=lay64.wgt.abs()),
                                    v.double().abs()).max()
    _close(out, ref, scale, dtype, TOL_K4)


@cuda
@pytest.mark.parametrize("runs", [True, False])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b", [1, 9, 100])
@pytest.mark.parametrize("d, n, ratio, cluster, sort",
                         [(2, 3000, 1.9, 0, False), (3, 5000, 1.25, 0, False),
                          (2, 3000, 1.9, 0, True), (3, 5000, 1.25, 0, True),
                          (2, 9000, 1.9, 6000, True)])
def test_interp_adjoint_equals_the_cpu_plain_version_bit_for_bit(
        dev, monkeypatch, runs, dtype, b, d, n, ratio, cluster, sort):
    """K4 sums each cell in the plain version's order and rounding, so it
    gives the plain version's bits on the CPU: on the ragged grids with
    the points in any order (the CSR kernel) and sorted by their lower
    corner (the runs kernel, a warp of cells reading 32 points of a run at
    a time), and where one cell holds 6000 entries, so that its sum goes
    on across ~190 such chunks of its runs. ``runs`` takes the runs kernel
    at any size (else only from the wrapper's threshold on)."""
    monkeypatch.setattr(gk, "_RUNS_MIN_OUTPUTS", 0 if runs else 2 ** 62)
    lay = _k4_problem(dev, dtype, d, n, ratio, cluster=cluster, sort=sort)
    assert (lay.lcptr is not None) == sort
    if cluster:
        assert int(lay.rowptr.diff().max()) > 4096
    v = _rand((b, n), dtype, dev, seed=b) - 0.5
    out = gk.interp_adjoint(lay, v)
    again = gk.interp_adjoint(lay, v)
    cpu = gk.interp_adjoint_plain(
        gk.InterpLayout(lay.rowptr.cpu(), lay.src.cpu(), lay.wgt.cpu(),
                        lay.n, lay.G), v.cpu())
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    assert torch.equal(out.cpu(), cpu)


@cuda
def test_interp_adjoint_checks_its_operands(dev, monkeypatch):
    """Wrong shapes, dtypes and index types raise, for both layouts."""
    monkeypatch.setattr(gk, "_RUNS_MIN_OUTPUTS", 0)
    lay = _k4_problem(dev, torch.float32, 2, 200, 1.5)
    v = torch.rand(3, 200, device=dev)
    with pytest.raises(ValueError, match="gradient"):
        gk.interp_adjoint(lay, v.clone().requires_grad_(True))
    with pytest.raises(ValueError):
        gk.interp_adjoint(lay, v[:, :199])
    with pytest.raises(ValueError):
        gk.interp_adjoint(lay, torch.rand(200, 3, device=dev).mT)
    with pytest.raises(TypeError):
        gk.interp_adjoint(lay, v.double())
    with pytest.raises(ValueError):
        gk.interp_adjoint(lay._replace(src=lay.src.long()), v)
    sorted_lay = _k4_problem(dev, torch.float32, 2, 200, 1.5, sort=True)
    with pytest.raises(ValueError):
        gk.interp_adjoint(sorted_lay._replace(
            lcptr=sorted_lay.lcptr.long()), v)
    with pytest.raises(ValueError):
        gk.interp_adjoint(sorted_lay._replace(
            wrun=sorted_lay.wrun[:, 1:].contiguous()), v)


@cuda
def test_an_off_lattice_run_launches_k4_and_repeats_bit_for_bit(dev):
    """skreconstructor(lattice=False) on the card: every mvm of training
    and predict goes through K4 (no index_add_), and two runs in float32
    give the same mean, sd and series bit for bit."""
    import gpim_tpu_torch
    from gpim_tpu_torch import utils
    rng = np.random.RandomState(5)
    shape = (16, 14, 6)
    R = rng.rand(*shape)
    R.reshape(-1, shape[2])[rng.choice(16 * 14, 100, replace=False)] = \
        np.nan
    X, Xf = utils.get_sparse_grid(R), utils.get_full_grid(R)
    runs = []
    for _ in range(2):
        m = gpim_tpu_torch.skreconstructor(
            X, R, Xf, kernel="RBF", iterations=4, learning_rate=0.1,
            verbose=0, ski=True, ski_min_points=1, lattice=False,
            precision="single")
        assert m._ski_engine is not None
        before = gk.interp_adjoint.launches
        mean, sd, hp = m.run()
        runs.append([mean, sd, hp["lengthscale"], hp["noise"], m.losses])
        assert gk.interp_adjoint.launches - before > 4
    for a, b in zip(*runs):
        assert np.array_equal(a, b)


@cuda
def test_a_trace_holds_every_kernel_the_run_launched(dev, tmp_path):
    """utils.profiling.trace around five warm exact RBF runs of a few steps
    and their predict, a new model each: each Chrome trace holds K1, K2 and
    K3 as CUDA kernel events exactly as often as the run launched them."""
    import json

    import gpim_tpu_torch
    from gpim_tpu_torch import utils
    from gpim_tpu_torch.utils.profiling import trace
    rng = np.random.RandomState(3)
    R = rng.rand(48, 48)
    R[rng.rand(48, 48) < 0.5] = np.nan
    X, Xf = utils.get_sparse_grid(R), utils.get_full_grid(R)

    def model():
        return gpim_tpu_torch.reconstructor(
            X, R, Xf, kernel="RBF", iterations=4, precision="single",
            verbose=0)

    model().run()
    names = (("sqdist_kernel", gk.sqdist),
             ("masked_system_kernel", gk.masked_system),
             ("rbf_bwd_kernel", gk.rbf_bwd_reductions))
    for i in range(5):
        m = model()
        before = [w.launches for _, w in names]
        logdir = tmp_path / str(i)
        with trace(str(logdir)):
            m.run()
        launched = [w.launches - b for (_, w), b in zip(names, before)]
        assert launched[1] == launched[2] == 4 and launched[0] > 0
        (path,) = logdir.glob("*.pt.trace.json")
        events = json.loads(path.read_text())["traceEvents"]
        kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
        assert [sum(k in n for n in kernels) for k, _ in names] == launched
