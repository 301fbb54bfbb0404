"""
The explicit inverse ``A^-1 = V^T V``, ``V = L^-1`` (``ops/tri.py``):
``tri_inverse`` and ``tri_gram`` on their blocked route against the library
calls they replace from the crossover on, the library calls' own bits
below it, the engagement counters, the exact GP's loss and gradients
through both routes, and the autograd rule (under autograd the library
route, whatever the size).

On the CPU the crossover and leaf size are lowered so that the blocked
route runs at small orders. The test marked ``cuda`` runs the module's own
constants at the spiral's padded order on the card and skips without one.
The file imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_tri.py
"""

import numpy as np
import pytest
import torch

from gpim_tpu_torch.gpreg import engine
from gpim_tpu_torch.ops import tri


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
