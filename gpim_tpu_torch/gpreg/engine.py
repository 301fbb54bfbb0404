"""
Functional GP core on tensors (counterpart of ``gpim_tpu/gpreg/engine.py``):
the exact marginal likelihood and the sparse Titsias VFE bound.

- Observations are NaN-compacted on host and padded to a bucket size; a 0/1
  mask folds the padding out of the marginal likelihood exactly (padded
  rows/cols of the covariance become identity rows, padded targets zeros).
- Hyperparameters are optimized in unconstrained space with the interval
  log-Jacobians added to the objective (the MAP objective of Pyro's
  Uniform-prior Trace_ELBO).
- The RBF / Matern52 / RationalQuadratic marginal likelihood has a
  closed-form backward (:class:`_NLLFast`); on CUDA its forward runs kernel
  K2 and its RBF backward kernel K3 (:mod:`gpim_tpu_torch.ops.gram_kernels`).
- The masked system and :class:`_NLLFast` also take a leading task axis
  (per-task hyperparameters and targets, a shared X and mask): T problems
  whose kernels run as one launch each, the batch that ``gpim_tpu``'s
  ``vmap`` over output channels gives (:mod:`gpim_tpu_torch.gpreg.multi`).
- Training is a Python loop of ``torch.optim.Adam`` steps that never waits
  for the device (:func:`adam_steps`, shared with the multi-output GP):
  losses, raw parameters and Cholesky status are recorded into preallocated
  device tensors and read once after the loop.
- :func:`mll_from_gram` is the masked NLL of a Gram matrix built
  elsewhere (the spectral mixture's), with the closed-form dNLL/dK.
- The sparse path is the Titsias variational free energy (VFE) bound with
  trainable inducing points ``Xu``; its n-wide core (:class:`_VFEWide`) has
  a closed-form backward. On CUDA its Gram matrices Kmm and Kmn, and the
  per-chunk Ks of its predictor, run kernel K1.
- Prediction runs over fixed-size chunks of the test grid.
"""

import math

import numpy as np
import torch

from gpim_tpu_torch.kernels.functional import get_kernel_fn, kernel_diag
from gpim_tpu_torch.kernels.transforms import (
    interval_forward, interval_log_jacobian, positive_forward)
from gpim_tpu_torch.ops import gram_kernels
from gpim_tpu_torch.ops.gram import pairwise_sq_dist
from gpim_tpu_torch.ops.linalg import safe_cholesky, solve_triangular
from gpim_tpu_torch.ops.tri import tri_gram, tri_inverse
from gpim_tpu_torch.parallel.distributed import (
    all_reduce, copy_to_shards, reduce_from_shards)
from gpim_tpu_torch.utils import profiling

__all__ = [
    "constrain", "exact_loss", "mll_from_gram", "vfe_loss", "train",
    "predict_exact", "predict_vfe", "pad_rows", "chunk_rows",
]

_LOG_2PI = math.log(2.0 * math.pi)
_SQRT5 = math.sqrt(5.0)
_FAST_KERNELS = ("RBF", "Matern52", "RationalQuadratic")
_MAX_SEGMENT = 10       # the SKI engines' longest segment between rebuilds


# --------------------------------------------------------------------------
# Parameter handling
# --------------------------------------------------------------------------

def constrain(u, bounds):
    """Map unconstrained parameters to their constrained domains.

    Keys of ``u``: 'lengthscale', 'variance', 'noise', optional 'alpha'
    (RationalQuadratic), optional 'Xu' (inducing points, unconstrained).
    ``bounds``: 'ls_lo', 'ls_hi', 'var_lo', 'var_hi'. Leading batch axes of
    ``u`` broadcast against the bounds.
    """
    p = {
        "lengthscale": interval_forward(
            u["lengthscale"], bounds["ls_lo"], bounds["ls_hi"]),
        "variance": interval_forward(
            u["variance"], bounds["var_lo"], bounds["var_hi"]),
        "noise": positive_forward(u["noise"]),
    }
    if "alpha" in u:
        p["alpha"] = positive_forward(u["alpha"])
    if "Xu" in u:
        p["Xu"] = u["Xu"]
    return p


def _log_jacobian(u, bounds):
    """Interval-transform log-Jacobian (the MAP prior term)."""
    return (interval_log_jacobian(u["lengthscale"],
                                  bounds["ls_lo"], bounds["ls_hi"]) +
            interval_log_jacobian(u["variance"],
                                  bounds["var_lo"], bounds["var_hi"]))


def _record(p):
    """Per-iteration hyperparameter snapshot (the public `hyperparams`
    contract)."""
    rec = {"lengthscale": p["lengthscale"], "variance": p["variance"],
           "noise": p["noise"]}
    if "Xu" in p:
        rec["inducing_points"] = p["Xu"]
    return rec


# --------------------------------------------------------------------------
# Masked marginal likelihoods
# --------------------------------------------------------------------------

def _masked_system(K, noise, mask, jitter):
    """Replace padded rows/cols of (K + noise I) with identity rows; ``K``
    (..., n, n) with one noise per leading index."""
    mm = mask[:, None] * mask[None, :]
    eye = torch.eye(K.shape[-1], dtype=K.dtype, device=K.device)
    diag_fix = (1.0 - mask) * eye
    return mm * (K + (noise + jitter)[..., None, None] * eye) + diag_fix


def _nll_core(L, z, mask):
    """0.5 |z|^2 + masked log det + n_eff/2 log 2 pi, one per leading
    index of ``L`` (..., n, n) and ``z`` (..., n)."""
    return (0.5 * (z * z).sum(-1)
            + (torch.log(torch.diagonal(L, dim1=-2, dim2=-1)) * mask).sum(-1)
            + 0.5 * mask.sum() * _LOG_2PI)


def _exact_loss_info(u, X, y, mask, bounds, jitter, kernel):
    p = constrain(u, bounds)
    if kernel in _FAST_KERNELS:
        nll, info = _NLLFast.apply(kernel, p["lengthscale"], p["variance"],
                                   p["noise"], p.get("alpha"), X, y, mask,
                                   jitter)
    else:
        nll, info = _exact_nll_autodiff(p, X, y, mask, jitter, kernel)
    return nll - _log_jacobian(u, bounds), info


def exact_loss(u, X, y, mask, bounds, jitter, *, kernel):
    """Masked negative log marginal likelihood + MAP prior terms."""
    return _exact_loss_info(u, X, y, mask, bounds, jitter, kernel)[0]


def _exact_nll_autodiff(p, X, y, mask, jitter, kernel):
    """Masked NLL differentiated by autograd through the Cholesky; returns
    ``(nll, info)`` with the Cholesky status of :func:`safe_cholesky`.
    With a task axis, ``p`` holds the kernel functions' batched layout
    (lengthscale (T, 1, d), variance (T, 1, 1)), noise (T,) and ``y``
    (T, n); nll and info are (T,)."""
    kfn = get_kernel_fn(kernel)
    A = _masked_system(kfn(p, X, X), p["noise"], mask, jitter)
    L, info = safe_cholesky(A)
    # quadratic form via one triangular solve: y^T A^-1 y = |L^-1 y|^2
    z = torch.linalg.solve_triangular(L, (y * mask)[..., None],
                                      upper=False)[..., 0]
    return _nll_core(L, z, mask), info


# --------------------------------------------------------------------------
# Closed-form MLL gradient (RBF / Matern52 / RationalQuadratic)
#
#     dNLL/dA = 0.5 (A^-1 - alpha alpha^T),   alpha = A^-1 y
# With base = (A^-1 - alpha alpha^T) . mm (mm the padding-mask outer product):
#     dNLL/dnoise = 0.5 (sum_i Ainv_ii m_i^2 - |alpha|^2)
#     dNLL/dv     = 0.5 sum(base . K) / v
#     dNLL/dl_k   = (sum_i x_ik^2 rowsum(W)_i - x_k^T W x_k) / l_k^3,
#                   W = base . G
# Per-kernel G: RBF G = K; Matern52 G = (5/3) v (1 + sqrt5 r) exp(-sqrt5 r);
# RationalQuadratic G = v (1 + s/(2a))^(-a-1), plus
#     dNLL/da = 0.5 sum(base . K . (-log u + s / (2a + s))),  u = 1 + s/(2a).
# (gpim_tpu/gpreg/engine.py:136-290.)
# --------------------------------------------------------------------------

class _NLLFast(torch.autograd.Function):
    """Masked NLL of the constrained hyperparameters with the closed-form
    backward. Returns ``(nll, info)``; ``info`` is the Cholesky status,
    non-differentiable.

    Unbatched: ``ls`` (d,) or (1,), ``variance``, ``noise`` (and the RQ
    ``alpha``) 0-d, ``y`` (n,). With a leading task axis of T (the
    independent multi-output GP): ``ls`` (T, d) or (T, 1), the scalars
    (T,), ``y`` (T, n), while ``X`` (n, d) and ``mask`` (n,) are shared;
    nll and info are then (T,), and K2, the Cholesky, the triangular inverse
    and K3 each run once for all T tasks.
    """

    @staticmethod
    def forward(ctx, kernel, ls, variance, noise, alpha, X, y, mask, jitter):
        Xs = X / ls[..., None, :]
        # one fused pass producing K and the masked system together (K2 on
        # CUDA); the backward recomputes s when the kernel needs it
        Kt, A = gram_kernels.masked_system(Xs, mask, variance, noise + jitter,
                                           alpha, kernel=kernel)
        L, info = safe_cholesky(A)
        # explicit L^-1: z now, and both backward solves become gemms
        V = tri_inverse(L)
        z = (V @ (y * mask)[..., None])[..., 0]
        ctx.kernel = kernel
        ctx.save_for_backward(ls, variance, alpha, X, mask, V, Kt, z)
        ctx.mark_non_differentiable(info)
        return _nll_core(L, z, mask), info

    @staticmethod
    def backward(ctx, g, _g_info):
        ls, v, a_rq, X, mask, V, Kt, z = ctx.saved_tensors
        kernel = ctx.kernel
        alpha = (V.mT @ z[..., None])[..., 0]             # A^-1 (y . m)
        Ainv = tri_gram(V)
        d_alpha = None
        if kernel == "RBF":
            # one pass over Ainv and Kt computes every matrix reduction (K3)
            s1, rw, WX, diagsum = gram_kernels.rbf_bwd_reductions(
                Ainv, Kt, alpha, mask, X)
            dv = 0.5 * g * s1 / v
            dn = 0.5 * g * (diagsum - (alpha * alpha).sum(-1))
        else:
            mat = lambda t: t[..., None, None]  # noqa: E731  per-task scalar
            mm = mask[:, None] * mask[None, :]
            base = (Ainv - alpha[..., :, None] * alpha[..., None, :]) * mm
            dv = 0.5 * g * (base * Kt).sum(dim=(-2, -1)) / v
            dn = 0.5 * g * ((torch.diagonal(Ainv, dim1=-2, dim2=-1)
                             * mask * mask).sum(-1)
                            - (alpha * alpha).sum(-1))
            Xs = X / ls[..., None, :]
            s = pairwise_sq_dist(Xs, Xs)             # K1 on CUDA
            if kernel == "Matern52":
                r = torch.sqrt(s + 1e-12)
                G = (5.0 / 3.0) * mat(v) * (1.0 + _SQRT5 * r) * torch.exp(
                    -_SQRT5 * r)
            else:  # RationalQuadratic
                u_ = 1.0 + s / (2.0 * mat(a_rq))
                G = mat(v) * u_ ** (-mat(a_rq) - 1.0)
                d_alpha = 0.5 * g * (
                    base * Kt * (-torch.log(u_) + s / (2.0 * mat(a_rq) + s))
                ).sum(dim=(-2, -1))
            W = base * G
            rw = W.sum(dim=-1)
            WX = W @ X
        per_dim = g[..., None] * ((X * X * rw[..., :, None]).sum(dim=-2)
                                  - (X * WX).sum(dim=-2))
        if ls.shape[-1] == 1 and X.shape[1] > 1:
            # isotropic: one lengthscale scales every dim
            dls = per_dim.sum(dim=-1, keepdim=True) / ls ** 3
        else:
            dls = per_dim / ls ** 3
        dy = g[..., None] * alpha if ctx.needs_input_grad[6] else None
        # X and mask are never trained in the exact path; jitter is constant
        return None, dls, dv, dn, d_alpha, None, dy, None, None


class _MLLFromGram(torch.autograd.Function):
    """Masked NLL of an (unmasked) Gram matrix, with the closed-form
    dNLL/dK (gpim_tpu/gpreg/engine.py:293-340). Returns ``(nll, info)``;
    ``info`` is the Cholesky status, non-differentiable.

        dNLL/dK     = 0.5 (A^-1 - alpha alpha^T) . (m m^T)
        dNLL/dnoise = 0.5 (sum_i Ainv_ii m_i - |alpha|^2)
        dNLL/dym    = alpha,                       alpha = A^-1 ym

    The JAX backward asks for ``Precision.HIGH`` on ``V.T @ V``; here every
    float32 product is full float32 (TF32 is off package-wide).
    """

    @staticmethod
    def forward(ctx, K, noise, ym, mask, jitter):
        A = _masked_system(K, noise, mask, jitter)
        L, info = safe_cholesky(A)
        V = tri_inverse(L)          # both backward solves become gemms
        z = V @ ym
        ctx.save_for_backward(V, z, mask)
        ctx.mark_non_differentiable(info)
        return _nll_core(L, z, mask), info

    @staticmethod
    def backward(ctx, g, _g_info):
        V, z, mask = ctx.saved_tensors
        alpha = V.T @ z                                   # A^-1 ym
        Ainv = tri_gram(V)
        mm = mask[:, None] * mask[None, :]
        dK = (0.5 * g) * (Ainv - alpha[:, None] * alpha[None, :]) * mm
        dnoise = (0.5 * g) * ((torch.diagonal(Ainv) * mask).sum()
                              - torch.dot(alpha, alpha))
        # mask and jitter are constants of the training problem
        return dK, dnoise, g * alpha, None, None


def mll_from_gram(K, noise, ym, mask, jitter):
    """Masked exact NLL core (quadratic + masked log det + n_eff/2 log 2 pi)
    of a precomputed Gram matrix ``K`` (n, n) and the Cholesky status:
    ``(nll, info)``. ``ym`` must already be centred and masked. Only K,
    noise and ym get gradients, in closed form (:class:`_MLLFromGram`), so
    autograd differentiates the Gram build alone and never the Cholesky."""
    return _MLLFromGram.apply(K, noise, ym, mask, jitter)


# --------------------------------------------------------------------------
# Sparse (VFE) bound with trainable inducing points
# --------------------------------------------------------------------------

def _enter_rows(tensors, group):
    """The replicated ``tensors`` as they enter a rank's row-local work:
    packed into one vector through :func:`copy_to_shards
    <gpim_tpu_torch.parallel.distributed.copy_to_shards>`, so their
    row-local gradients are summed over ``group`` by one all-reduce."""
    flat = copy_to_shards(torch.cat([t.reshape(-1) for t in tensors]), group)
    return [v.reshape(t.shape) for t, v in zip(
        tensors, flat.split([t.numel() for t in tensors]))]


def _vfe_loss_info(u, X, y, mask, bounds, jitter, kernel, group=None):
    """The VFE bound and the Cholesky status of Kmm and B. ``X``, ``y`` and
    ``mask`` may be one rank's share of the rows, ``group`` the ranks that
    hold the others: every row sum (B - I, a, t, the diagonal's sum, the
    row count and |ym|^2) leaves through one :func:`reduce_from_shards`,
    and the parameters and Vm enter the rows through :func:`_enter_rows`,
    so each rank's loss and gradients are the whole problem's. With
    ``group`` None the same graph runs on all rows without collectives."""
    kfn = get_kernel_fn(kernel)
    p = constrain(u, bounds)
    Xu = p["Xu"]
    noise = p["noise"]
    m = Xu.shape[0]
    eye = torch.eye(m, dtype=X.dtype, device=X.device)
    # Xu enters Kmm twice: autograd adds K1's gradient in both arguments
    Kmm = kfn(p, Xu, Xu) + jitter * eye
    Lm, info_m = safe_cholesky(Kmm)
    # explicit Lm^-1 turns the wide (m, n) triangular solve into a gemm
    Vm = tri_inverse(Lm)
    keys = sorted(p)
    rows = _enter_rows([p[k] for k in keys] + [Vm], group)
    pr = dict(zip(keys, rows[:-1]))
    Kmn = kfn(pr, pr["Xu"], X) * mask[None, :]
    ym = y * mask
    G, a, t = _VFEWide.apply(rows[-1], Kmn, ym, pr["noise"], Lm)
    kdiag = kernel_diag(kernel, pr, X) * mask
    sums = reduce_from_shards(torch.cat([
        G.reshape(-1), a, torch.stack([t, kdiag.sum(), mask.sum(),
                                       torch.dot(ym, ym)])]), group)
    B = eye + sums[:m * m].reshape(m, m)
    a = sums[m * m:m * m + m]
    t, kdiag_sum, n_obs, yy = sums[m * m + m:]
    LB, info_b = safe_cholesky(B)
    c = solve_triangular(LB, a, lower=True) / torch.sqrt(noise)
    trace_term = kdiag_sum / noise - t
    nll = (0.5 * n_obs * (_LOG_2PI + torch.log(noise))
           + torch.log(torch.diagonal(LB)).sum()
           + 0.5 * yy / noise
           - 0.5 * torch.dot(c, c)
           + 0.5 * trace_term)
    return nll - _log_jacobian(u, bounds), torch.stack([info_m, info_b])


def vfe_loss(u, X, y, mask, bounds, jitter, *, kernel, group=None):
    """Masked Titsias VFE bound (negated) with trainable inducing points
    ``u['Xu']`` + MAP prior terms (gpim_tpu/gpreg/engine.py:344-375); with
    ``group``, ``X``, ``y`` and ``mask`` are this rank's rows."""
    return _vfe_loss_info(u, X, y, mask, bounds, jitter, kernel, group)[0]


class _VFEWide(torch.autograd.Function):
    """The n-wide core of the VFE bound, with a closed-form backward
    (gpim_tpu/gpreg/engine.py:378-446).

    Returns (G, a, t): G = A A^T, a = A ym, t = sum(A^2), where
    A = Vm Kmn / sqrt(noise) is the whitened feature matrix (B = I + G,
    summed over the row shards first). Whitening BEFORE squaring keeps B's
    conditioning that of the whitened features in float32. The backward
    runs one n-wide gemm: the identities A Kmn^T = sqrt(noise) G Lm^T and
    Kmn ym = sqrt(noise) Lm a, which hold for any subset of the rows, turn
    dVm and dnoise into m^3 and m^2 work. ``Lm`` must be Vm^-1; it only
    evaluates those identities and takes no gradient (its gradient arrives
    through Vm).
    """

    @staticmethod
    def forward(ctx, Vm, Kmn, ym, noise, Lm):
        A = (Vm @ Kmn) / torch.sqrt(noise)
        G = A @ A.T
        a = A @ ym
        ctx.save_for_backward(A, G, a, noise, Lm, ym)
        return G, a, (A * A).sum()

    @staticmethod
    def backward(ctx, dG, da, dt):
        A, G, a, noise, Lm, ym = ctx.saved_tensors
        eye = torch.eye(A.shape[0], dtype=A.dtype, device=A.device)
        # dA = (dG + dG^T + 2 dt I) A + da ym^T =: S A + da ym^T
        S = dG + dG.T + 2.0 * dt * eye
        # dKmn = Vm^T dA / sqrt(noise), Vm^T = Lm^-T: fold S through the
        # same whitened A (one wide gemm) plus a rank-1 term
        M1 = solve_triangular(Lm.T, S, lower=False)
        w = solve_triangular(Lm.T, da, lower=False)
        dKmn = (M1 @ A + w[:, None] * ym[None, :]) / torch.sqrt(noise)
        dVm = S @ (G @ Lm.T) + torch.outer(da, Lm @ a)
        dym = A.T @ da
        # noise enters only through A's 1/sqrt(noise)
        dnoise = -((S * G).sum() + torch.dot(da, a)) / (2.0 * noise)
        return dVm, dKmn, dym, dnoise, None


# --------------------------------------------------------------------------
# Training: a host loop of Adam steps that never waits for the device
# --------------------------------------------------------------------------

def _check_cholesky(infos, what, factors=("",)):
    """Raise if any recorded Cholesky status is nonzero (one host sync).
    ``infos`` is (steps, len(factors)) or flat, one status per factor (per
    task, for the multi-output GP)."""
    with profiling.wait("cholesky"):
        infos = infos.cpu().numpy().reshape(-1, len(factors))
    bad = np.argwhere(infos)
    if bad.size:
        step, f = bad[0]
        raise torch.linalg.LinAlgError(
            "%s: Cholesky%s failed at step %d (leading minor of order %d is "
            "not positive definite)" % (
                what, " of " + factors[f] if factors[f] else "", step,
                infos[step, f]))


_VFE_FACTORS = ("Kmm", "B")


def adam_steps(loss_info, u0, lr, iterations, factors=("",)):
    """Run ``iterations`` Adam steps on ``loss_info(u) -> (loss, info)``;
    returns (final u, raw trajectory {key: (iterations, ...)}, losses).

    The trajectory holds the post-update unconstrained parameters of every
    iteration, the losses the pre-update loss. Adam is
    ``torch.optim.Adam``, whose update m_hat / (sqrt(v_hat) + 1e-8) is
    optax.adam's. Nothing in the loop reads a device value: ``info``, the
    Cholesky status of each of ``factors``, is recorded every step and
    checked once at the end, and a failure raises
    ``torch.linalg.LinAlgError``. A loss with no Cholesky factor passes
    ``factors=()`` and returns ``info`` None. The optimizer's construction
    is an ``adam.init`` span and each iteration an ``adam.step`` span
    (:mod:`gpim_tpu_torch.utils.profiling`).
    """
    u = {k: v.detach().clone().requires_grad_(True) for k, v in u0.items()}
    with profiling.span("adam.init"):
        # the process's first optimizer imports torch._dynamo
        opt = torch.optim.Adam(list(u.values()), lr=lr)
    first = next(iter(u.values()))
    dev = first.device
    losses = torch.empty((iterations,), dtype=first.dtype, device=dev)
    infos = torch.zeros((iterations, len(factors)), dtype=torch.int32,
                        device=dev)
    u_traj = {k: torch.empty((iterations,) + tuple(v.shape), dtype=v.dtype,
                             device=dev) for k, v in u.items()}
    for i in range(iterations):
        with profiling.span("adam.step"):
            opt.zero_grad(set_to_none=True)
            loss, info = loss_info(u)
            loss.backward()
            opt.step()
            with torch.no_grad():
                losses[i] = loss
                if factors:
                    infos[i] = info
                for k, v in u.items():
                    u_traj[k][i] = v
    if factors:
        _check_cholesky(infos, "train", factors)
    return {k: v.detach() for k, v in u.items()}, u_traj, losses


def adam_segments(u0, lr, iterations, build_precond, loss_iters,
                  carry0=None):
    """Adam in training segments between preconditioner rebuilds, the host
    loop of the SKI engines (gpim_tpu/gpreg/mgrid_model.py:596-642,
    gpim_tpu/gpreg/ski_model.py:209-245). ``build_precond(u)`` returns the
    preconditioner a segment uses and ``loss_iters(u, precond)`` the loss
    and its realized CG iterations. With ``carry0``, a step also carries a
    state within a segment: ``loss_iters(u, precond, carry)`` returns (loss,
    iterations, next carry), and each segment starts from ``carry0()`` (the
    warm-started CG's solutions, reset where the basis is rebuilt, as
    gpim_tpu's ``_train_seg`` starts each segment from zeros). A segment
    of 2 steps comes first, then
    each is twice as long (up to 10) while the last step needed
    at most 8 CG iterations, and half as long (at least 2) when it needed 16
    or more; the host reads that one value a segment.

    Returns (final u, raw trajectory {key: (iterations, ...)}, losses,
    realized CG iterations (iterations,) on the device, segment lengths):
    the post-update parameters and the pre-update loss of every step, as
    :func:`adam_steps` records them; the Adam moments carry across
    segments.
    """
    u = {k: v.detach().clone().requires_grad_(True) for k, v in u0.items()}
    opt = torch.optim.Adam(list(u.values()), lr=lr)
    first = next(iter(u.values()))
    losses = torch.empty((iterations,), dtype=first.dtype,
                         device=first.device)
    its = torch.empty_like(losses)
    u_traj = {k: torch.empty((iterations,) + tuple(v.shape), dtype=v.dtype,
                             device=first.device) for k, v in u.items()}
    segments = []
    i, s_next = 0, 2
    while i < iterations:
        s = min(s_next, iterations - i)
        precond = build_precond(u)
        carry = None if carry0 is None else carry0()
        for _ in range(s):
            opt.zero_grad(set_to_none=True)
            if carry0 is None:
                loss, it = loss_iters(u, precond)
            else:
                loss, it, carry = loss_iters(u, precond, carry)
            loss.backward()
            opt.step()
            with torch.no_grad():
                losses[i], its[i] = loss, it
                for k, v in u.items():
                    u_traj[k][i] = v
            i += 1
        segments.append(s)
        last_it = float(its[i - 1])                   # one read a segment
        if last_it >= 16.0:
            s_next = max(2, s // 2)
        elif last_it <= 8.0:
            s_next = min(_MAX_SEGMENT, s * 2)
    return ({k: v.detach() for k, v in u.items()}, u_traj, losses, its,
            segments)


def train(u0, X, y, mask, bounds, lr, jitter, *, kernel, iterations,
          sparse=False, group=None):
    """Run ``iterations`` Adam steps (:func:`adam_steps`) on the exact MLL
    or, with ``sparse``, the VFE bound (``u0`` then holds 'Xu'); returns
    (final_u, trajectory dict).

    The trajectory holds the post-update constrained hyperparameters of
    every iteration (and the inducing points, when sparse) plus the
    pre-update loss. The Cholesky status of every step (of Kmm and B, when
    sparse) is checked once at the end. With ``group`` (sparse only),
    ``X``, ``y`` and ``mask`` are this rank's share of the rows, and every
    rank takes the same steps as one process on all of them.
    """
    if sparse:
        loss_info = lambda uu: _vfe_loss_info(  # noqa: E731
            uu, X, y, mask, bounds, jitter, kernel, group)
    elif group is not None:
        raise ValueError("the exact MLL trains on all rows of every rank")
    else:
        loss_info = lambda uu: _exact_loss_info(  # noqa: E731
            uu, X, y, mask, bounds, jitter, kernel)
    with profiling.span("engine.train", cpu=True):
        u, u_traj, losses = adam_steps(
            loss_info, u0, lr, iterations, _VFE_FACTORS if sparse else ("",))
        with torch.no_grad():
            # constrain the raw trajectory in one batched pass
            traj = _record(constrain(u_traj, bounds))
    traj["loss"] = losses
    return u, traj


# --------------------------------------------------------------------------
# Prediction: chunk by chunk over the test grid
# --------------------------------------------------------------------------

@torch.no_grad()
def predict_exact(u, X, y, mask, bounds, jitter, Xtest_chunks, *,
                  kernel, noiseless=False):
    """Exact GP predictive mean/variance over chunked test points.

    ``Xtest_chunks`` has shape (n_chunks, chunk, d); chunks run one after
    another so peak memory stays at one (n, chunk) block. Variance includes
    observation noise unless ``noiseless``.
    """
    with profiling.span("engine.predict"):
        kfn = get_kernel_fn(kernel)
        with profiling.span("predict.factor"):
            p = constrain(u, bounds)
            A = _masked_system(kfn(p, X, X), p["noise"], mask, jitter)
            L, info = safe_cholesky(A)
            # one explicit L^-1 turns every per-chunk triangular solve
            # into a gemm
            V = tri_inverse(L)
            alpha = V.T @ (V @ (y * mask))
        n_chunks, chunk = Xtest_chunks.shape[:2]
        means = torch.empty((n_chunks, chunk), dtype=X.dtype,
                            device=X.device)
        variances = torch.empty_like(means)
        for c in range(n_chunks):
            with profiling.span("predict.chunk"):
                xc = Xtest_chunks[c]
                Ks = kfn(p, xc, X) * mask[None, :]
                means[c] = Ks @ alpha
                W = V @ Ks.T
                var = kernel_diag(kernel, p, xc) - (W * W).sum(dim=0)
                if not noiseless:
                    var = var + p["noise"]
                variances[c] = var.clamp_min(0.0)
        _check_cholesky(info, "predict")
    return means.reshape(-1), variances.reshape(-1)


@torch.no_grad()
def predict_vfe(u, X, y, mask, bounds, jitter, Xtest_chunks, *,
                kernel, noiseless=False, group=None):
    """Sparse (VFE) GP predictive mean/variance over chunked test points
    (``u`` holds 'Xu'); chunks run one after another, as in
    :func:`predict_exact`. With ``group``, ``X``, ``y`` and ``mask`` are
    this rank's share of the training rows, and their (m, m) and (m,) sums
    are all-reduced over it once."""
    kfn = get_kernel_fn(kernel)
    p = constrain(u, bounds)
    Xu = p["Xu"]
    noise = p["noise"]
    eye = torch.eye(Xu.shape[0], dtype=X.dtype, device=X.device)
    Kmm = kfn(p, Xu, Xu) + jitter * eye
    Kmn = kfn(p, Xu, X) * mask[None, :]
    Lm, info_m = safe_cholesky(Kmm)
    # one explicit inverse each: every per-chunk triangular solve below
    # becomes a gemm
    Vm = tri_inverse(Lm)
    A = (Vm @ Kmn) / torch.sqrt(noise)
    del Kmn
    m = A.shape[0]
    sums = all_reduce(torch.cat([(A @ A.T).reshape(-1), A @ (y * mask)]),
                      group)
    del A
    LB, info_b = safe_cholesky(eye + sums[:m * m].reshape(m, m))
    VB = tri_inverse(LB)
    c = (VB @ sums[m * m:]) / torch.sqrt(noise)
    n_chunks, chunk = Xtest_chunks.shape[:2]
    means = torch.empty((n_chunks, chunk), dtype=X.dtype, device=X.device)
    variances = torch.empty_like(means)
    for i in range(n_chunks):
        xc = Xtest_chunks[i]
        w1 = Vm @ kfn(p, xc, Xu).T                        # (m, chunk)
        w2 = VB @ w1                                      # (m, chunk)
        means[i] = w2.T @ c
        var = (kernel_diag(kernel, p, xc) - (w1 * w1).sum(dim=0)
               + (w2 * w2).sum(dim=0))
        if not noiseless:
            var = var + noise
        variances[i] = var.clamp_min(0.0)
    _check_cholesky(torch.stack([info_m, info_b]), "predict", _VFE_FACTORS)
    return means.reshape(-1), variances.reshape(-1)


# --------------------------------------------------------------------------
# Host-side shape plumbing (numpy)
# --------------------------------------------------------------------------

def pad_rows(arr, bucket):
    """Pad axis 0 up to the next multiple of ``bucket`` (with zeros).

    Returns (padded, original_length).
    """
    n = arr.shape[0]
    n_pad = int(-(-max(n, 1) // bucket) * bucket)
    if n_pad == n:
        return arr, n
    pad = [(0, n_pad - n)] + [(0, 0)] * (arr.ndim - 1)
    return np.pad(arr, pad), n


def chunk_rows(arr, chunk):
    """Zero-pad axis 0 to a multiple of ``chunk`` and reshape to
    (n_chunks, chunk, ...). Returns (chunked, original_length)."""
    padded, n = pad_rows(arr, chunk)
    return padded.reshape((-1, chunk) + arr.shape[1:]), n
