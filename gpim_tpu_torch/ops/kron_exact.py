"""
Exact Kronecker GP inference for full Cartesian grids (Saatchi 2011) on
tensors (counterpart of ``gpim_tpu/ops/kron_exact.py``).

When the training data covers a full (no-NaN) Cartesian product grid, the
product-form grid kernel factorises exactly:

    A = (K_1 (x) ... (x) K_d) + noise I
      = ((x)_d Q_d) diag(prod_d lam_d + noise) ((x)_d Q_d)^T

with one small ``eigh`` per dimension. The marginal likelihood, its
gradient, the predictive mean and the predictive variance are then closed
form: the heavy operations are per-dimension mode products (gemms).

The gradient never differentiates ``eigh``: 1D kernel factors have
near-degenerate eigenvalue pairs, which make eigh's backward explode.
:class:`_KronNLL` instead gives the factor-level cotangent, the exact
partial trace of dNLL/dA = 0.5 (A^-1 - a a^T) over the Kronecker pattern
(gpim_tpu/ops/kron_exact.py:154-177):

    dNLL/dK_k = 0.5 Q_k diag(t_k) Q_k^T - 0.5 sym(mat_k(a) W mat_k(a)^T)
    t_k(i)    = sum_{idx w/o k} [prod_{d != k} lam_d] / denom
    W         = (x)_{d != k} K_d   (applied as mode products)

so only the small factor matrices take gradients, and autograd chains them
through the kernel build.
"""

import math

import numpy as np
import torch

__all__ = [
    "detect_cartesian", "kron_nll", "kron_predict_chunks", "modeprod",
]

_LOG_2PI = math.log(2.0 * math.pi)


# --------------------------------------------------------------------------
# host-side structure detection
# --------------------------------------------------------------------------

def detect_cartesian(X_flat, dims, rtol=1e-7):
    """If the (n, d) coordinate rows are exactly the C-order flattening of a
    Cartesian product over ``dims``, return the per-dim 1D coordinate arrays
    (numpy); else None."""
    dims = tuple(int(s) for s in dims)
    n, d = X_flat.shape
    if d != len(dims) or n != int(np.prod(dims)):
        return None
    axes = []
    for k in range(d):
        coord = X_flat[:, k].reshape(dims)
        # must vary only along axis k
        ref = [slice(None) if a == k else slice(0, 1) for a in range(d)]
        vec = coord[tuple(ref)].reshape(-1)
        expect = vec.reshape([-1 if a == k else 1 for a in range(d)])
        tol = rtol * (np.abs(vec).max() + 1.0)
        if not np.allclose(coord, expect, atol=tol, rtol=0):
            return None
        axes.append(np.ascontiguousarray(vec))
    return axes


# --------------------------------------------------------------------------
# mode products
# --------------------------------------------------------------------------

def modeprod(mats, T):
    """Apply mats[k] along mode k of tensor T: out = (x)_k mats[k] . T.
    mats[k] may be None (identity)."""
    for k, M in enumerate(mats):
        if M is None:
            continue
        T = torch.movedim(torch.tensordot(M, T, dims=([1], [k])), 0, k)
    return T


def _lam_tensor(lams):
    """Outer product of the per-dim eigenvalue vectors."""
    d = len(lams)
    out = lams[0].reshape((-1,) + (1,) * (d - 1))
    for k in range(1, d):
        shape = [1] * d
        shape[k] = -1
        out = out * lams[k].reshape(shape)
    return out


def _lam_except(lams, k):
    """Outer product of the eigenvalue vectors of every dim but k,
    broadcastable to the full tensor shape (size 1 along axis k)."""
    d = len(lams)
    out = None
    for j in range(d):
        if j == k:
            continue
        shape = [1] * d
        shape[j] = -1
        v = lams[j].reshape(shape)
        out = v if out is None else out * v
    if out is None:
        out = torch.ones((1,) * d, dtype=lams[0].dtype,
                         device=lams[0].device)
    return out


def _eigh_factors(factors):
    """Eigenvalues clamped at 0 (SPD up to round-off) and eigenvectors of
    each factor."""
    lams, Qs = [], []
    for K in factors:
        lam, Q = torch.linalg.eigh(K)
        lams.append(lam.clamp_min(0.0))
        Qs.append(Q)
    return lams, Qs


# --------------------------------------------------------------------------
# marginal likelihood with the factor-level backward
# --------------------------------------------------------------------------

class _KronNLL(torch.autograd.Function):
    """0.5 [y^T A^-1 y + logdet A + n log 2 pi] for A = (x)factors + noise
    I; arguments (noise, Yc, *factors)."""

    @staticmethod
    def forward(ctx, noise, Yc, *factors):
        lams, Qs = _eigh_factors(factors)
        Ye = modeprod([Q.T for Q in Qs], Yc)
        denom = _lam_tensor(lams) + noise
        w = Ye / denom
        nll = (0.5 * (Ye * w).sum() + 0.5 * torch.log(denom).sum()
               + 0.5 * Yc.numel() * _LOG_2PI)
        ctx.d = len(factors)
        ctx.save_for_backward(denom, w, *factors, *lams, *Qs)
        return nll

    @staticmethod
    def backward(ctx, g):
        d = ctx.d
        denom, w = ctx.saved_tensors[:2]
        factors, lams, Qs = (ctx.saved_tensors[2 + i * d:2 + (i + 1) * d]
                             for i in range(3))
        inv = 1.0 / denom
        alpha = modeprod(Qs, w)                       # real-space A^-1 Yc
        dnoise = 0.5 * g * (inv.sum() - (w * w).sum())
        dYc = g * alpha
        dfactors = []
        for k in range(d):
            # trace part: contract inv . prod_{j != k} lam_j over every
            # mode but k
            t_k = inv * _lam_except(lams, k)
            others = tuple(a for a in range(d) if a != k)
            if others:      # an empty dim tuple would reduce every dim
                t_k = t_k.sum(dim=others)
            trace_part = (Qs[k] * t_k[None, :]) @ Qs[k].T
            # quadratic part: W = (x)_{j != k} K_j applied to alpha
            T = modeprod([factors[j] if j != k else None for j in range(d)],
                         alpha)
            Ak = torch.movedim(alpha, k, 0).reshape(alpha.shape[k], -1)
            Tk = torch.movedim(T, k, 0).reshape(T.shape[k], -1)
            quad_part = Ak @ Tk.T
            quad_part = 0.5 * (quad_part + quad_part.T)
            dfactors.append(g * 0.5 * (trace_part - quad_part))
        return (dnoise, dYc, *dfactors)


def kron_nll(factors, noise, Yc):
    """0.5 [y^T A^-1 y + logdet A + n log 2pi] for A = (x)factors + noise I.

    ``factors``: sequence of per-dim (G_k, G_k) kernel matrices; ``noise``:
    a 0-d tensor; ``Yc``: the mean-centred observations, shaped
    (G_1, ..., G_d). Differentiable in all three, by the closed form of
    :class:`_KronNLL`.
    """
    return _KronNLL.apply(noise, Yc, *factors)


# --------------------------------------------------------------------------
# prediction: closed-form mean and per-point variance, chunk by chunk
# --------------------------------------------------------------------------

@torch.no_grad()
def kron_predict_chunks(factors, cross_fns, noise, Yc, kss, Xtest_chunks,
                        noiseless=False):
    """Predictive mean and variance at arbitrary test points.

    ``cross_fns``: per-dim functions e_k(x_col) -> (chunk, G_k)
    cross-covariance rows (dim 0's carries the output variance, as the
    factors do). ``kss``: the prior variance k(x, x). ``Xtest_chunks``
    (n_chunks, chunk, d); the chained contractions keep each chunk's
    intermediate at (chunk, G_2 * ... * G_d).
    """
    lams, Qs = _eigh_factors(factors)
    denom = _lam_tensor(lams) + noise
    alpha = modeprod(Qs, modeprod([Q.T for Q in Qs], Yc) / denom)
    inv = 1.0 / denom
    d = len(factors)
    n_chunks, chunk = Xtest_chunks.shape[:2]
    means = torch.empty((n_chunks, chunk), dtype=Yc.dtype, device=Yc.device)
    variances = torch.empty_like(means)
    for c in range(n_chunks):
        xc = Xtest_chunks[c]
        E = [cross_fns[k](xc[:, k]) for k in range(d)]
        # mean: contract alpha with the per-point cross vectors, mode by
        # mode; the first mode is a plain gemm (chunk, G1) x (G1, rest)
        T = torch.einsum("bi,i...->b...", E[0], alpha)
        for k in range(1, d):
            T = torch.einsum("bi,bi...->b...", E[k], T)
        means[c] = T
        # variance: the same chain with B_k = (E_k Q_k)^2 against 1/denom
        B0 = E[0] @ Qs[0]
        V = torch.einsum("bi,i...->b...", B0 * B0, inv)
        for k in range(1, d):
            Bk = E[k] @ Qs[k]
            V = torch.einsum("bi,bi...->b...", Bk * Bk, V)
        var = kss - V
        if not noiseless:
            var = var + noise
        variances[c] = var.clamp_min(0.0)
    return means.reshape(-1), variances.reshape(-1)
