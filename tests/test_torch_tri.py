"""
The explicit inverse ``A^-1 = V^T V``, ``V = L^-1`` (``ops/tri.py``):
``tri_inverse`` and ``tri_gram`` on their blocked route against the library
calls they replace from the crossover on, the library calls' own bits
below it, the engagement counters, the exact GP's loss and gradients
through both routes, and the autograd rule (under autograd the library
route, whatever the size). And ``chol_and_inverse``: K5's plain version
(``gram_kernels.chol_inverse_plain``, the kernel's algorithm) against
``cholesky_ex`` and ``solve_triangular`` with its ``info``, the route's
choice (the library pair for CPU tensors, above order 128 and under
autograd), and the exact GP's loss, gradients and prediction at BO's order
through K5's route (its plain version, put in by monkeypatch) against the
library pair.

On the CPU the crossover and leaf size are lowered so that the blocked
route runs at small orders. The test marked ``cuda`` runs the module's own
constants at the spiral's padded order on the card and skips without one.
The file imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_tri.py
"""

import numpy as np
import pytest
import torch

from gpim_tpu_torch.gpreg import engine, multi, structured
from gpim_tpu_torch.ops import gram_kernels as gk
from gpim_tpu_torch.ops import linalg, tri


@pytest.fixture
def small_blocks(monkeypatch):
    """Blocked route from order 512 on, leaves of 128 to 255."""
    monkeypatch.setattr(tri, "_BLOCKED_MIN", 512)
    monkeypatch.setattr(tri, "_LEAF", 128)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _factor(shape, dtype=torch.float64, device="cpu", seed=0):
    """The Cholesky factor of ``I + W W^T / n``, ``W`` seeded."""
    n = shape[-1]
    g = torch.Generator().manual_seed(seed)
    W = torch.randn(shape, generator=g, dtype=torch.float64)
    A = W @ W.mT / n + torch.eye(n, dtype=torch.float64)
    return torch.linalg.cholesky_ex(A.to(dtype).to(device)).L


def _library(L):
    eye = torch.eye(L.shape[-1], dtype=L.dtype, device=L.device)
    V = torch.linalg.solve_triangular(L, eye, upper=False)
    return V, V.mT @ V


def _gap(x, ref):
    return ((x.double() - ref.double()).abs().max()
            / ref.double().abs().max()).item()


def _counts():
    return tri.tri_inverse.blocked, tri.tri_gram.blocked


@pytest.mark.parametrize("shape", [(640, 640), (1664, 1664), (3, 768, 768),
                                   (2, 3, 640, 640)],
                         ids=["n640", "n1664", "batched3x768", "batched2x3x640"])
def test_blocked_matches_library(small_blocks, shape):
    L = _factor(shape)
    V_ref, G_ref = _library(L)
    before = _counts()
    V = tri.tri_inverse(L)
    G = tri.tri_gram(V)
    assert _counts() == (before[0] + 1, before[1] + 1)
    assert V.shape == G.shape == L.shape
    assert _gap(V, V_ref) <= 1e-12
    assert _gap(G, G_ref) <= 1e-12
    assert torch.equal(V.triu(1), torch.zeros_like(V))
    assert torch.equal(G, G.mT)


def test_tree_splits_on_multiples_of_128(small_blocks, monkeypatch):
    """Every split of an uneven order lies on a multiple of 128; the leaves
    tile the diagonal; 6144 and 6016 bisect at the module's own leaf."""
    for n in (1664, 2944, 6016):
        nodes, leaves = tri._tree(n)
        assert all(h % 128 == 0 and 0 < h < s for _, _, s, h in nodes)
        assert [o for _, o, _ in leaves] == list(
            np.cumsum([0] + [s for _, _, s in leaves[:-1]]))
        assert sum(s for _, _, s in leaves) == n
        assert all(128 <= s < 256 for _, _, s in leaves)
    monkeypatch.setattr(tri, "_LEAF", 256)
    assert tri._tree(6144)[1] == [(4, 384 * i, 384) for i in range(16)]
    assert [s for _, _, s in tri._tree(6016)[1]] == [384] * 15 + [256]
    # one batched call a level on the uniform tree
    assert [k for _, k in tri._runs(tri._tree(6144)[0],
                                    lambda b: b[::2])] == [1, 2, 4, 8]


@pytest.mark.parametrize("n", [128, 640, 1664])
def test_library_bits_below_crossover(n):
    """Below the module's crossover both functions are the library calls,
    bit for bit, and count nothing."""
    assert n < tri._BLOCKED_MIN
    L = _factor((n, n))
    V_ref, G_ref = _library(L)
    before = _counts()
    V = tri.tri_inverse(L)
    assert torch.equal(V, V_ref)
    assert torch.equal(tri.tri_gram(V), G_ref)
    assert _counts() == before


def test_never_blocked_at_256_or_less(monkeypatch):
    monkeypatch.setattr(tri, "_BLOCKED_MIN", 1)
    monkeypatch.setattr(tri, "_LEAF", 1)
    before = _counts()
    for n in (128, 256):
        L = _factor((n, n))
        V_ref, G_ref = _library(L)
        assert torch.equal(tri.tri_inverse(L), V_ref)
        assert torch.equal(tri.tri_gram(V_ref), G_ref)
    assert _counts() == before


def test_autograd_takes_library_route(small_blocks):
    """A factor that asks for a gradient keeps the library route (the VFE's
    ``Vm = tri_inverse(Lm)``): the same bits, no count, and the gradient of
    the library solve. Without grad mode the same factor is blocked."""
    L0 = _factor((640, 640))
    L = L0.clone().requires_grad_(True)
    before = _counts()
    V = tri.tri_inverse(L)
    G = tri.tri_gram(V)
    assert _counts() == before
    V_ref, G_ref = _library(L0)
    assert torch.equal(V.detach(), V_ref)
    assert torch.equal(G.detach(), G_ref)
    G.sum().backward()
    L1 = L0.clone().requires_grad_(True)
    _library(L1)[1].sum().backward()
    assert torch.equal(L.grad, L1.grad)
    with torch.no_grad():
        tri.tri_gram(tri.tri_inverse(L))
    assert _counts() == (before[0] + 1, before[1] + 1)


def _exact_problem(n_obs, bucket, device="cpu", seed=0):
    """An RBF exact-GP problem of ``n_obs`` points on a 2-D grid, padded to
    ``bucket`` rows, with constrained hyperparameters that ask for grads."""
    g = np.random.RandomState(seed)
    side = int(np.ceil(np.sqrt(n_obs)))
    xy = np.stack(np.meshgrid(np.arange(side), np.arange(side)), -1)
    X = np.zeros((bucket, 2))
    X[:n_obs] = xy.reshape(-1, 2)[:n_obs]
    y = np.zeros(bucket)
    y[:n_obs] = np.sin(X[:n_obs, 0] / 5) * np.cos(X[:n_obs, 1] / 7) \
        + 0.05 * g.randn(n_obs)
    mask = np.zeros(bucket)
    mask[:n_obs] = 1.0
    t = lambda a: torch.as_tensor(a, dtype=torch.float64,  # noqa: E731
                                  device=device)
    params = {"ls": t([3.0, 4.0]), "variance": t(1.3), "noise": t(0.02)}
    for v in params.values():
        v.requires_grad_(True)
    return params, t(X), t(y), t(mask)


def _nll_step(params, X, y, mask):
    """One ``_NLLFast`` forward and backward: the loss and the gradients."""
    for v in params.values():
        v.grad = None
    nll, info = engine._NLLFast.apply("RBF", params["ls"],
                                      params["variance"], params["noise"],
                                      None, X, y, mask, 1e-5)
    assert info.item() == 0
    nll.backward()
    return nll.item(), {k: v.grad.clone() for k, v in params.items()}


def test_nllfast_through_both_routes(monkeypatch):
    """The exact GP's loss and gradients agree through both routes, and a
    step at an order past the crossover counts one blocked run of each
    function, a BO-size step none."""
    problem = _exact_problem(600, 640)
    loss_lib, grads_lib = _nll_step(*problem)
    monkeypatch.setattr(tri, "_BLOCKED_MIN", 512)
    monkeypatch.setattr(tri, "_LEAF", 128)
    before = _counts()
    loss_blk, grads_blk = _nll_step(*problem)
    assert _counts() == (before[0] + 1, before[1] + 1)
    assert abs(loss_blk - loss_lib) <= 1e-10 * abs(loss_lib)
    for k in grads_lib:
        assert torch.allclose(grads_blk[k], grads_lib[k], rtol=1e-10,
                              atol=0), k
    _nll_step(*_exact_problem(35, 128))
    assert _counts() == (before[0] + 1, before[1] + 1)


def test_mll_from_gram_gradients_through_both_routes(monkeypatch):
    """``mll_from_gram`` (the spectral model's loss) through both routes."""
    _, X, y, mask = _exact_problem(600, 640)
    K = torch.exp(-0.5 * torch.cdist(X, X) ** 2 / 9.0).requires_grad_(True)
    noise = torch.tensor(0.02, dtype=torch.float64, requires_grad=True)

    def step():
        K.grad = noise.grad = None
        nll, _ = engine.mll_from_gram(K, noise, y * mask, mask, 1e-5)
        nll.backward()
        return nll.item(), K.grad.clone(), noise.grad.clone()

    ref = step()
    monkeypatch.setattr(tri, "_BLOCKED_MIN", 512)
    monkeypatch.setattr(tri, "_LEAF", 128)
    before = _counts()
    out = step()
    assert _counts() == (before[0] + 1, before[1] + 1)
    assert abs(out[0] - ref[0]) <= 1e-10 * abs(ref[0])
    for a, b in zip(out[1:], ref[1:]):
        assert _gap(a, b) <= 1e-10


def _spd(shape, dtype=torch.float64, seed=0):
    """``I + W W^T / n`` (eigenvalues in [1, 5]), ``W`` seeded."""
    n = shape[-1]
    g = torch.Generator().manual_seed(seed)
    W = torch.randn(shape, generator=g, dtype=torch.float64)
    return (W @ W.mT / n + torch.eye(n, dtype=torch.float64)).to(dtype)


def _library_pair(A):
    L, info = torch.linalg.cholesky_ex(A)
    return L, _library(L)[0], info


# K5 against the library pair: float64 to 1e-13 of the largest entry,
# float32 to 1e-5 (both read ~1e-16 and ~1e-7 at these orders)
CHOL_TOL = {torch.float64: 1e-13, torch.float32: 1e-5}


@pytest.mark.parametrize("tasks", [None, 8], ids=["single", "tasks8"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("n", [1, 2, 35, 127, 128])
def test_chol_inverse_plain_matches_library(n, dtype, tasks):
    """K5's algorithm (its plain version) gives the library pair's factor
    and inverse, zero above the diagonal, with info 0 a matrix."""
    shape = (n, n) if tasks is None else (tasks, n, n)
    A = _spd(shape, dtype)
    L, V, info = gk.chol_inverse_plain(A)
    L_ref, V_ref, info_ref = _library_pair(A)
    assert L.shape == V.shape == A.shape and L.dtype == V.dtype == dtype
    assert info.shape == info_ref.shape and info.dtype == torch.int32
    assert not info.any()
    assert _gap(L, L_ref) <= CHOL_TOL[dtype]
    assert _gap(V, V_ref) <= CHOL_TOL[dtype]
    assert torch.equal(L.triu(1), torch.zeros_like(L))
    assert torch.equal(V.triu(1), torch.zeros_like(V))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("k", [1, 36, 128])
def test_chol_inverse_plain_info(k, dtype):
    """On a batch whose second matrix has a leading minor of order k that
    is not positive definite, info is cholesky_ex's: 0, then k."""
    A = _spd((3, 128, 128), dtype)
    A[1, k - 1, k - 1] = -5.0
    info = gk.chol_inverse_plain(A)[2]
    assert info.tolist() == torch.linalg.cholesky_ex(A).info.tolist() \
        == [0, k, 0]


_K5 = gk.chol_inverse          # the wrapper, whose launches count


@pytest.fixture
def k5_spy(monkeypatch):
    """Counts the route's calls of K5's wrapper."""
    calls = []

    def spy(A):
        calls.append(tuple(A.shape))
        return _K5(A)

    monkeypatch.setattr(gk, "chol_inverse", spy)
    return calls


def test_chol_and_inverse_keeps_the_library_pair_on_the_cpu(k5_spy):
    """A CPU tensor takes safe_cholesky then tri_inverse, bit for bit, and
    launches nothing."""
    launches = _K5.launches
    for shape in ((128, 128), (8, 35, 35), (129, 129)):
        A = _spd(shape)
        L, V, info = tri.chol_and_inverse(A)
        L_ref, info_ref = linalg.safe_cholesky(A)
        assert torch.equal(L, L_ref) and torch.equal(info, info_ref)
        assert torch.equal(V, tri.tri_inverse(L_ref))
    assert k5_spy == [] and _K5.launches == launches


def test_chol_and_inverse_route_by_order_and_autograd(monkeypatch, k5_spy):
    """On a device that takes K5 (the CPU here, by monkeypatch, where the
    wrapper runs its plain version), orders 1 to 128 take K5, and order
    129, the spiral's 6144 (on the meta device: the choice alone) and an
    A that asks for a gradient take the library pair."""
    monkeypatch.setattr(tri, "_KERNEL_DEVICES", ("cpu", "meta", "cuda"))
    taken = []
    monkeypatch.setattr(tri, "safe_cholesky", lambda A: (
        taken.append(tuple(A.shape)) or linalg.safe_cholesky(A)))
    monkeypatch.setattr(tri, "tri_inverse", lambda L: L)
    for shape in ((1, 1), (128, 128), (8, 128, 128)):
        tri.chol_and_inverse(_spd(shape))
    assert k5_spy == [(1, 1), (128, 128), (8, 128, 128)] and taken == []
    monkeypatch.setattr(tri, "safe_cholesky", lambda A: (
        taken.append(tuple(A.shape)) or (A, None)))
    tri.chol_and_inverse(_spd((129, 129)))
    tri.chol_and_inverse(torch.empty((6144, 6144), device="meta",
                                     dtype=torch.float64))
    tri.chol_and_inverse(_spd((128, 128)).requires_grad_(True))
    assert taken == [(129, 129), (6144, 6144), (128, 128)]
    assert len(k5_spy) == 3


def test_nllfast_through_k5_route(monkeypatch, k5_spy):
    """``_NLLFast``'s loss and gradients at BO's order (35 points padded to
    128) through K5's route, its plain version on the CPU, against the
    library pair; one K5 call a forward."""
    problem = _exact_problem(35, 128)
    loss_lib, grads_lib = _nll_step(*problem)
    assert k5_spy == []
    monkeypatch.setattr(tri, "_KERNEL_DEVICES", ("cpu", "cuda"))
    loss_k5, grads_k5 = _nll_step(*problem)
    assert k5_spy == [(128, 128)]
    assert abs(loss_k5 - loss_lib) <= 1e-12 * abs(loss_lib)
    for k in grads_lib:
        assert torch.allclose(grads_k5[k], grads_lib[k], rtol=1e-10,
                              atol=0), k


def test_mll_from_gram_through_k5_route(monkeypatch, k5_spy):
    """``mll_from_gram``'s loss and gradients at order 128 through K5's
    route against the library pair."""
    _, X, y, mask = _exact_problem(35, 128)
    K = torch.exp(-0.5 * torch.cdist(X, X) ** 2 / 9.0).requires_grad_(True)
    noise = torch.tensor(0.02, dtype=torch.float64, requires_grad=True)

    def step():
        K.grad = noise.grad = None
        nll, _ = engine.mll_from_gram(K, noise, y * mask, mask, 1e-5)
        nll.backward()
        return nll.item(), K.grad.clone(), noise.grad.clone()

    ref = step()
    monkeypatch.setattr(tri, "_KERNEL_DEVICES", ("cpu", "cuda"))
    out = step()
    assert k5_spy == [(128, 128)]
    assert abs(out[0] - ref[0]) <= 1e-12 * abs(ref[0])
    for a, b in zip(out[1:], ref[1:]):
        assert _gap(a, b) <= 1e-10


def test_predict_exact_through_k5_route(monkeypatch, k5_spy):
    """A BO-size exact GP (35 observed pixels of a 10 x 10 image, padded
    to 128) predicts the same mean and sd through K5's route (its plain
    version on the CPU) as through the library pair."""
    import gpim_tpu_torch
    from gpim_tpu_torch import utils
    rng = np.random.RandomState(5)
    R = np.sin(np.arange(100.0).reshape(10, 10) / 7.0)
    R.ravel()[rng.permutation(100)[35:]] = np.nan
    model = gpim_tpu_torch.reconstructor(
        utils.get_sparse_grid(R), R, utils.get_full_grid(R), kernel="RBF",
        iterations=3, use_gpu=False, verbose=0)
    model.train()
    mean_lib, sd_lib = model.predict()
    assert k5_spy == []
    monkeypatch.setattr(tri, "_KERNEL_DEVICES", ("cpu", "cuda"))
    mean_k5, sd_k5 = model.predict()
    assert k5_spy == [(128, 128)]
    np.testing.assert_allclose(mean_k5, mean_lib, rtol=0, atol=1e-10)
    np.testing.assert_allclose(sd_k5, sd_lib, rtol=0, atol=1e-10)


def _predict_case(model):
    """A call of ``model``'s predictor on a small float64 problem whose
    factorisations are all of order <= 128, and their shapes as K5 sees
    them."""
    g = np.random.RandomState(3)
    n, m, T, d = 60, 24, 3, 2
    t = lambda a: torch.as_tensor(np.asarray(a, np.float64))  # noqa: E731
    X = t(g.rand(n, d) * 8.0)
    mask = t((np.arange(n) < 50).astype(float))
    Xtest = t(g.rand(2, 32, d) * 8.0)
    y = torch.sin(X[:, 0] / 2.0) * torch.cos(X[:, 1] / 3.0) * mask
    ls_b = {"ls_lo": t(np.zeros(d)), "ls_hi": t(np.full(d, 6.0))}
    if model == "vfe":
        u = {"lengthscale": t([-0.3, -0.5]), "variance": t(0.3),
             "noise": t(-3.0), "Xu": X[::n // m][:m] + 0.05}
        bounds = dict(ls_b, var_lo=t(1e-4), var_hi=t(10.0))
        return (lambda: engine.predict_vfe(u, X, y, mask, bounds, 1e-6,
                                           Xtest, kernel="RBF"),
                [(m, m), (m, m)])
    if model == "independent":
        Y = torch.stack([y * (1.0 + k) + 0.1 * k for k in range(T)], -1)
        u = {"lengthscale": t(-0.4 + 0.2 * g.randn(T, d)),
             "outputscale": t(0.1 * g.randn(T)),
             "noise": t(-3.0 + 0.2 * g.randn(T)), "mean": t(0.1 * g.randn(T))}
        return (lambda: multi.predict_independent(
            u, X, Y, mask, ls_b, 1e-6, Xtest, kernel="RBF"), [(T, n, n)])
    if model == "correlated":
        Y = torch.stack([y * (1.0 + k) for k in range(T)], -1)
        u = {"lengthscale": t([0.2, 0.3]), "noise": t(-3.0),
             "mean": t(0.1 * g.rand(T)), "F": t(g.rand(T, 1)),
             "task_var": t(-0.4 + 0.3 * g.randn(T))}
        return (lambda: multi.predict_correlated(
            u, X, Y, ls_b, 1e-6, Xtest, kernel="RBF"), [(T, n, n)])
    u = structured.init_spectral_params(X.numpy()[:50], y.numpy()[:50], 2,
                                        0, np.float64, "cpu")
    return (lambda: structured.predict_spectral(u, X, y, mask, 1e-6, Xtest),
            [(n, n)])


@pytest.mark.parametrize("model",
                         ["vfe", "independent", "correlated", "spectral"])
def test_predict_through_k5_route(monkeypatch, k5_spy, model):
    """``predict_vfe`` (Kmm and B), ``predict_independent`` at 3 tasks,
    ``predict_correlated`` at 3 rotated tasks and ``predict_spectral``, at
    orders <= 128, take K5's route (its plain version on the CPU) once a
    factorisation and predict the library pair's mean and sd."""
    predict, shapes = _predict_case(model)
    mean_lib, var_lib = predict()
    assert k5_spy == []
    monkeypatch.setattr(tri, "_KERNEL_DEVICES", ("cpu", "cuda"))
    mean_k5, var_k5 = predict()
    assert k5_spy == shapes
    torch.testing.assert_close(mean_k5, mean_lib, rtol=0, atol=1e-10)
    torch.testing.assert_close(var_k5.sqrt(), var_lib.sqrt(), rtol=0,
                               atol=1e-10)


@pytest.mark.cuda
def test_blocked_at_spiral_order_on_card(dev):
    """At n = 6144 on the card, with the module's own constants: float64
    within 1e-11 of the library route; float32 no further from the float64
    result than four times the library route's own float32 gap (a
    triangular inverse's rounding grows with the factor's condition
    number, so no absolute float32 tolerance holds; the two routes round
    alike). A spiral-size exact GP step counts one blocked run of each
    function, a BO-size step none."""
    n = 6144
    L64 = _factor((n, n), device=dev)
    V_ref, G_ref = _library(L64)
    V, G = tri.tri_inverse(L64), tri.tri_gram(V_ref)
    assert _gap(V, V_ref) <= 1e-11
    assert _gap(G, G_ref) <= 1e-11
    assert torch.equal(V.triu(1), torch.zeros_like(V))
    assert torch.equal(G, G.mT)
    L32 = L64.float()
    V32_ref, G32_ref = _library(L32)
    V32 = tri.tri_inverse(L32)
    G32 = tri.tri_gram(V32)
    assert _gap(V32, V_ref) <= 4 * _gap(V32_ref, V_ref)
    assert _gap(G32, G_ref) <= 4 * _gap(G32_ref, G_ref)
    before = _counts()
    _nll_step(*_exact_problem(6036, n, device=dev))
    assert _counts() == (before[0] + 1, before[1] + 1)
    _nll_step(*_exact_problem(35, 128, device=dev))
    assert _counts() == (before[0] + 1, before[1] + 1)
