"""
gpim_tpu_torch.ops.ski's masked-lattice core against gpim_tpu on the same
numpy inputs (twins of the masked-grid tests of tests/test_ski.py): the
masked operator in both layouts against JAX and a dense Kronecker matrix
(rtol 1e-10, float64); the factored split root (lam_n, the P^-1/2
operator, logdet P at rtol 1e-8) with dim_cap "auto" and None, and its mode
selection on a grid with two equal axes (exactly tied products); batched
PCG and split PCG (solutions, tridiagonals and the realized iteration
count, with columns that freeze early), and the host-exit cadence giving
bit-identical outputs; the SLQ log-determinant; the masked-lattice MLL's
value and gradients against JAX's custom VJP with the same probes (rtol
1e-6 in float64, 1e-3 in float32); the grid predictor and the exact
variance probe; and, in the port alone, the factored root against the
dense split root of the materialised grid root.
"""

from functools import partial

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

import jax
import jax.numpy as jnp

from gpim_tpu.ops import ski as jski

from gpim_tpu_torch.ops import ski

GSHAPE = (30, 8, 6)
RANK = 120          # dim_cap "auto" = 20 < 30: the cap binds on axis 0


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _t(a, requires_grad=False):
    return torch.as_tensor(np.asarray(a)).requires_grad_(requires_grad)


def _close(got, ref, rtol, err_msg=""):
    ref = np.asarray(ref)
    assert_allclose(np.asarray(got), ref, rtol=rtol,
                    atol=rtol * max(np.abs(ref).max(), 1e-30),
                    err_msg=err_msg)


def _setup(seed=0, gshape=GSHAPE, dtype=np.float64):
    """Lattice axes, RBF parameters and a 60% mask, as numpy."""
    rng = np.random.RandomState(seed)
    axes = [np.arange(g, dtype=dtype) * 0.7 for g in gshape]
    p = {"lengthscale": np.asarray([2.1, 1.7, 1.4], dtype),
         "variance": np.asarray(1.3, dtype)}
    mask = (rng.rand(int(np.prod(gshape))) < 0.6).astype(dtype)
    return rng, axes, p, mask


@partial(jax.jit, static_argnames=("dim_cap",))
def _jroot(p, axes, mask, dim_cap="auto"):
    """gpim_tpu's split root, compiled once a dtype and dim_cap."""
    return jski.mgrid_split_root("RBF", p, list(axes), GSHAPE, mask, RANK,
                                 dim_cap=dim_cap)


def _both(axes, p, mask):
    """The same inputs for gpim_tpu (jnp) and the port (tensors), and the
    port's kernel factors."""
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: _t(v) for k, v in p.items()}
    jaxes = [jnp.asarray(a) for a in axes]
    taxes = [_t(a) for a in axes]
    return (jp, jaxes, jnp.asarray(mask)), (tp, taxes, _t(mask)), \
        ski.grid_kernel_factors("RBF", tp, taxes)


@pytest.mark.parametrize("batch_first", [False, True])
def test_masked_grid_mvm_matches_gpim_tpu_and_dense(batch_first):
    rng, axes, p, mask = _setup()
    (jp, jaxes, jmask), (_, _, tmask), factors = _both(axes, p, mask)
    noise = 0.05
    G = mask.shape[0]
    V = rng.randn(G, 3)
    Vin = V.T if batch_first else V
    ref = jski.make_masked_grid_mvm("RBF", jaxes, GSHAPE, jmask,
                                    batch_first=batch_first)(
        jp, noise, jnp.asarray(Vin))
    got = ski.make_masked_grid_mvm(GSHAPE, tmask, batch_first=batch_first)(
        factors, _t(noise), _t(Vin))
    _close(got, ref, 1e-10)
    K = factors[0].numpy()
    for f in factors[1:]:
        K = np.kron(K, f.numpy())
    A = mask[:, None] * K * mask[None, :] + noise * np.eye(G)
    _close(got.numpy() if batch_first else got.numpy().T, (A @ V).T, 1e-10)


@pytest.mark.parametrize("dim_cap", ["auto", None])
def test_mgrid_split_root_matches_gpim_tpu(dim_cap):
    """The same eigenspace (selected modes, Nystrom spectrum) and the same
    P^-1/2 operator and logdet P; eigenvector signs may differ between the
    two LAPACKs, the operator does not."""
    rng, axes, p, mask = _setup()
    (jp, jaxes, jmask), (_, _, tmask), factors = _both(axes, p, mask)
    jq, jlam, _, jmodes = _jroot(jp, jaxes, jmask, dim_cap=dim_cap)
    q, lam, _, modes = ski.mgrid_split_root(factors, tmask, RANK,
                                            dim_cap=dim_cap)
    assert [U.shape for U in q.Us] == [tuple(U.shape) for U in jq.Us]
    assert q.Us[0].shape[1] == (20 if dim_cap == "auto" else 30)
    np.testing.assert_array_equal(q.mflat.numpy(), np.asarray(jq.mflat))
    _close(modes[0], jmodes[0], 1e-8)
    _close(np.sort(lam.numpy()), np.sort(np.asarray(jlam)), 1e-8)
    noise = 0.05
    jpis, jld = jski.split_apply(jq, jlam, jnp.asarray(noise), vec_axis=1)
    pis, ld = ski.split_apply(q, lam, _t(noise), vec_axis=1)
    V = rng.randn(3, mask.shape[0])
    _close(pis(_t(V)), jpis(jnp.asarray(V)), 1e-8)
    _close(ld, jld, 1e-8)
    # the column layout applies the same operator
    pis0, _ = ski.split_apply(q, lam, _t(noise), vec_axis=0)
    _close(pis0(_t(V.T.copy())).numpy().T, pis(_t(V)), 1e-12)


def test_mode_selection_breaks_exact_ties_as_lax_top_k():
    """Two equal grid axes give exactly tied products lam_i lam_j =
    lam_j lam_i; at a rank that splits a tied pair, the port selects the
    modes gpim_tpu's lax.top_k selects (the lower flat index first)."""
    gshape = (16, 16, 5)
    _, axes, p, mask = _setup(gshape=gshape)
    p["lengthscale"] = np.asarray([1.9, 1.9, 1.2])
    p["variance"] = np.asarray(1.0)     # the first factor carries it
    (jp, jaxes, jmask), _, factors = _both(axes, p, mask)
    prod = np.ones(1)
    for f in factors:       # in the order both packages multiply
        prod = (prod[:, None] * np.linalg.eigvalsh(f.numpy())[None, ::-1])
        prod = prod.reshape(-1)
    srt = np.sort(prod)[::-1]
    rank = next(r for r in range(8, 200) if srt[r - 1] == srt[r])
    _, jUs, jmdim = jski._kron_top_modes("RBF", jp, jaxes, rank)
    q, _, _, _ = ski.mgrid_split_root(factors, _t(mask), rank, dim_cap=None)
    jflat = np.ravel_multi_index([np.asarray(m) for m in jmdim],
                                 [U.shape[1] for U in jUs])
    np.testing.assert_array_equal(q.mflat.numpy(), np.sort(jflat))


def test_factored_root_is_the_dense_split_root():
    """The factored basis (mode products, the sorted mode gather/scatter,
    the r x r rotation) is the same operator as the dense split_root of
    the materialised root grid_kr_rows: the same Nystrom spectrum, P^-1/2
    and logdet P, and P^-1 against a dense solve."""
    rng, axes, p, mask = _setup()
    _, (_, _, tmask), factors = _both(axes, p, mask)
    noise = _t(0.05)
    q, lam, _, (lam_top, _, _, sel) = ski.mgrid_split_root(
        factors, tmask, RANK)
    Lp = ski.grid_kr_rows(sel, lam_top, tmask)
    Qd, lam_d, _ = ski.split_root(Lp)
    _close(np.sort(lam.numpy()), np.sort(lam_d.numpy()), 1e-10)
    pis, ld = ski.split_apply(q, lam, noise)
    pis_d, ld_d = ski.split_apply(Qd, lam_d, noise)
    V = _t(rng.randn(mask.shape[0], 3))
    _close(pis(V), pis_d(V), 1e-10)
    _close(ld, ld_d, 1e-12)
    P = (Lp @ Lp.mT).numpy() + 0.05 * np.eye(mask.shape[0])
    _close(pis(pis(V)), np.linalg.solve(P, V.numpy()), 1e-8)


def _spd_problem(n=40, seed=3):
    """An SPD matrix, its diagonal preconditioner and right-hand sides
    whose first column is 0 (frozen before the first iteration) and whose
    last is an eigenvector of the preconditioned operator (converged after
    one)."""
    rng = np.random.RandomState(seed)
    M = rng.randn(n, n)
    A = 0.3 * M @ M.T / n + np.diag(1.0 + rng.rand(n))
    dinv = 1.0 / np.diag(A)
    B = rng.randn(n, 4)
    B[:, 0] = 0.0
    lam, vec = np.linalg.eig(A * dinv[None, :])
    B[:, -1] = np.real(vec[:, np.argmax(np.real(lam))])
    return A, dinv, B


def test_batched_pcg_matches_gpim_tpu():
    A, dinv, B = _spd_problem()
    iters = 30
    jX, jTd, jTo, jk = jski.batched_pcg(
        lambda v: jnp.asarray(A) @ v, lambda r: jnp.asarray(dinv)[:, None] * r,
        jnp.asarray(B), iters, return_iters=True)
    X, Td, To, k = ski.batched_pcg(
        lambda v: _t(A) @ v, lambda r: _t(dinv)[:, None] * r, _t(B), iters,
        return_iters=True)
    assert int(k) == int(jk) and 0 < int(k) < iters
    _close(X, jX, 1e-10)
    _close(Td, jTd, 1e-10)
    _close(To, jTo, 1e-10)
    Td = Td.numpy()
    # the frozen columns' tridiagonals are the identity block after their
    # convergence, the zero column's from the start
    assert (Td[:, 0] == 1.0).all() and (Td[1:, -1] == 1.0).all()
    assert_allclose(X.numpy(), np.linalg.solve(A, B), atol=1e-8)


def test_host_exit_cadence_gives_bit_identical_results(monkeypatch):
    """Reading the exit test on the host every iteration, every 3 or never
    gives the same bits: iterations after every column froze change
    nothing, and the realized count is counted on the device."""
    A, dinv, B = _spd_problem()
    outs = []
    for every in (1, 3, 1000):
        monkeypatch.setattr(ski, "CG_EXIT_CHECK_EVERY", every)
        outs.append(ski.batched_pcg(
            lambda v: _t(A) @ v, lambda r: _t(dinv)[:, None] * r, _t(B), 60,
            return_iters=True))
    assert int(outs[0][3]) < 60
    for out in outs[1:]:
        for a, b in zip(out, outs[0]):
            assert torch.equal(a, b)


def test_split_pcg_on_the_masked_operator_matches_gpim_tpu():
    rng, axes, p, mask = _setup()
    (jp, jaxes, jmask), (_, _, tmask), factors = _both(axes, p, mask)
    noise = 0.05
    jq, jlam, _, _ = _jroot(jp, jaxes, jmask)
    q, lam, _, _ = ski.mgrid_split_root(factors, tmask, RANK)
    B = rng.randn(3, mask.shape[0])
    jmvm = jski.make_masked_grid_mvm("RBF", jaxes, GSHAPE, jmask,
                                     batch_first=True)
    jpis, _ = jski.split_apply(jq, jlam, jnp.asarray(noise), vec_axis=1)
    jX, jTd, jTo, jk = jski.split_pcg(
        lambda v: jmvm(jp, noise, v), jpis, jnp.asarray(B), 100,
        return_iters=True, vec_axis=1)
    mvm = ski.make_masked_grid_mvm(GSHAPE, tmask, batch_first=True)
    pis, _ = ski.split_apply(q, lam, _t(noise), vec_axis=1)
    X, Td, To, k = ski.split_pcg(lambda v: mvm(factors, _t(noise), v), pis,
                                 _t(B), 100, return_iters=True, vec_axis=1)
    assert int(k) == int(jk) and int(k) < 100
    _close(X, jX, 1e-8)
    live = slice(0, int(k))
    _close(Td[live], jTd[live], 1e-6)
    _close(To[live], jTo[live], 1e-6)


def test_slq_from_tridiag_matches_gpim_tpu():
    rng = np.random.RandomState(4)
    m, p = 12, 5
    td = rng.rand(m, p) + 2.0
    to = rng.rand(m, p) * 0.5
    td[9:, 1], to[8:, 1] = 1.0, 0.0           # a column frozen early
    sq = rng.rand(p) * 10
    ref = jski._slq_from_tridiag(jnp.asarray(td), jnp.asarray(to),
                                 jnp.asarray(sq))
    _close(ski._slq_from_tridiag(_t(td), _t(to), _t(sq)), ref, 1e-12)
    # no row reached (a warm start at the solution): JAX's all-identity
    # tridiagonals give 0, as the port's empty ones do
    ident = jski._slq_from_tridiag(jnp.ones((m, p)), jnp.zeros((m, p)),
                                   jnp.asarray(sq))
    assert float(ident) == 0.0
    assert float(ski._slq_from_tridiag(_t(td[:0]), _t(to[:0]), _t(sq))) == 0


@pytest.mark.parametrize("precision", ["double", "single"])
def test_ski_mll_value_and_gradients_match_jax_vjp(precision):
    """Value and gradients (lengthscale, variance, noise, yc) of the
    masked-lattice MLL against jax.value_and_grad of gpim_tpu's custom VJP,
    with the same Rademacher probes and each package's own
    preconditioner."""
    dtype = np.float64 if precision == "double" else np.float32
    rtol = 1e-6 if precision == "double" else 1e-3
    rng, axes, p, mask = _setup(dtype=dtype)
    (jp, jaxes, jmask), (tp, taxes, tmask), _ = _both(axes, p, mask)
    G = mask.shape[0]
    g0 = np.random.default_rng(0).choice(np.asarray([-1.0, 1.0], dtype),
                                         size=(8, G))
    y = (rng.randn(G) * mask).astype(dtype)
    noise = np.asarray(0.05, dtype)
    jq, jlam, _, _ = _jroot(jp, jaxes, jmask)
    jcore = jski.ski_mll_from_mvm(
        jski.make_masked_grid_mvm("RBF", jaxes, GSHAPE, jmask,
                                  batch_first=True), 60, jnp.asarray(g0),
        vec_axis=1)
    jv, jg = jax.jit(jax.value_and_grad(
        lambda pp, nn, yy: jcore(pp, nn, yy, jq, jlam), argnums=(0, 1, 2)))(
        jp, jnp.asarray(noise), jnp.asarray(y))
    with torch.no_grad():
        q, lam, _, _ = ski.mgrid_split_root(
            ski.grid_kernel_factors("RBF", tp, taxes), tmask, RANK)
    core = ski.ski_mll_from_mvm(
        ski.make_masked_grid_mvm(GSHAPE, tmask, batch_first=True), 60,
        _t(g0), return_iters=True)
    tp = {k: v.requires_grad_(True) for k, v in tp.items()}
    tn, ty = _t(noise, True), _t(y, True)
    v, it = core(ski.grid_kernel_factors("RBF", tp, taxes), tn, ty, q, lam)
    v.backward()
    assert 0 < float(it) < 60 and not it.requires_grad
    _close(v.detach(), jv, rtol)
    _close(tp["lengthscale"].grad, jg[0]["lengthscale"], rtol)
    _close(tp["variance"].grad, jg[0]["variance"], rtol)
    _close(tn.grad, jg[1], rtol)
    _close(ty.grad, jg[2], rtol)


def test_grid_predictor_and_exact_variance_probe_match_gpim_tpu():
    """The Cartesian-grid predictor (a 2x denser test grid: exact cross
    factors, the Nystrom variance) and the exact posterior variance at a
    few cells, observed and unobserved."""
    rng, axes, p, mask = _setup()
    (jp, jaxes, jmask), (tp, taxes, tmask), _ = _both(axes, p, mask)
    yc = rng.randn(mask.shape[0]) * mask
    noise = 0.05
    t_axes = [np.arange(0, 0.7 * (g - 1) + 1e-9, 0.35) for g in GSHAPE]
    mean_j, var_j = jax.jit(jski.make_grid_predictor(
        "RBF", jaxes, GSHAPE, 200, RANK))(
        jp, noise, jmask, jnp.asarray(yc), [jnp.asarray(a) for a in t_axes],
        jp["variance"])
    mean, var = ski.make_grid_predictor("RBF", taxes, GSHAPE, 200, RANK)(
        tp, _t(noise), tmask, _t(yc), [_t(a) for a in t_axes],
        tp["variance"])
    _close(mean, mean_j, 1e-6)
    _close(var, var_j, 1e-6)
    cells = np.stack([rng.randint(0, g, 6) for g in GSHAPE], -1)
    ref = jax.jit(lambda pp: jski.mgrid_exact_var_probe(
        "RBF", pp, jaxes, GSHAPE, jmask, noise, cells, cg_iters=200,
        rank=RANK))(jp)
    got = ski.mgrid_exact_var_probe("RBF", tp, taxes, GSHAPE, tmask,
                                    _t(noise), cells, cg_iters=200,
                                    rank=RANK)
    _close(got, ref, 1e-6)
