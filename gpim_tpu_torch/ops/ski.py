"""
Structured-kernel-interpolation building blocks on tensors (counterpart of
``gpim_tpu/ops/ski.py``): the solver core of the SKI routes, the
masked-lattice operator and the off-lattice interpolation operator.

With data on the Cartesian data lattice (NaNs at unmeasured cells, as
``utils.get_sparse_grid`` gives it) the inducing grid equals the data grid
and the SKI operator is

    A v = M . K_UU (M . v) + (noise + jitter) v,   K_UU = (x)_k K_k,

per-dimension mode products (gemms) and elementwise masks, no gather and
no scatter (:func:`make_masked_grid_mvm`). Around it:

- split-preconditioned CG (:func:`split_pcg`): plain CG on
  P^-1/2 A P^-1/2, with P = noise I + Q diag(lam_n) Q^T applied through an
  orthonormal Nystrom basis of the Kronecker eigen-root
  (:func:`split_root`, :func:`split_apply`). The Woodbury form of P^-1
  loses every digit in float32 at a million cells (see the block comment
  above :func:`_orth_eig`). On the masked lattice the basis stays factored
  (:class:`KronRoot`): per-dimension eigenvector tables, a sorted mode
  index and an r x r rotation, never a (G, r) matrix;
- stochastic Lanczos quadrature of the log-determinant from the CG
  tridiagonals (:func:`_slq_from_tridiag`, one batched ``eigh`` on the
  host), and its
  gradient by Hutchinson trace estimation (:func:`ski_mll_from_mvm`, an
  ``autograd.Function`` whose backward differentiates a surrogate
  quadratic in the operator; nothing differentiates through CG or
  ``eigh``);
- prediction on a Cartesian test grid with exact per-dimension
  cross-covariances and the Nystrom variance of the same eigen-root
  (:func:`make_grid_predictor`), and the exact posterior variance at a few
  cells by CG (:func:`mgrid_exact_var_probe`).

Data off the lattice goes through linear interpolation onto a Cartesian
inducing grid (:func:`choose_grid`, :func:`build_interp`): the operator is
A v = W K_UU W^T v + (noise + jitter) v (:func:`make_interp_mvm`), W^T the
sum of the 2^d weighted corners onto each cell (K4, a CSR segmented sum in
a fixed order, so the card gives one answer run to run), W a gather. Its
preconditioner is the dense Nystrom basis of the interpolated Kronecker
eigen-root (:func:`kron_eig_root`, :func:`split_root`), and its predictor
(:func:`make_ski_predictor`) takes the Nystrom variance of that root or, at
preconditioner rank 0, the LOVE variance of a Lanczos factorisation
(:func:`lanczos`, :func:`love_var`). The masked lattice's predictor does
the same at rank 0 (:func:`mgrid_solve_core`); both routes then run the
predict-time CG to its tolerance (:data:`PREDICT_CG_ITERS`).

Every kernel factor and cross factor is built by the kernel functions, so
on a CUDA tensor its distances are one K1 launch at d = 1. The operator
takes its factors as arguments: a loss evaluation builds them once and
every CG iteration reuses them (``gpim_tpu`` rebuilds them inside every
mvm and leaves the hoisting to XLA).

TPU workarounds of ``gpim_tpu`` not carried here: the
``optimization_barrier`` pins (eager PyTorch fuses nothing), the batch-first
rationale of 128-lane tiling, the sorted-corner form of ``ski_mvm`` (one
sorted scatter and grid rolls, for XLA's TPU scatter lowering; the plain
form's semantics are kept) and the dense one-hot interpolation gemm of
``kron_eig_root`` (for slow minor-dimension gathers; a row gather gives the
same root). The batch-first layout (probes as rows) stays the CG layout all
the same: every CG vector is then a contiguous row and every mode product a
plain or strided-batched gemm.

The masked lattice's training also runs sharded (:class:`GridShard`): each
rank holds a block of the first grid axis of every G-sized vector, the
mode products reshard it with two all-to-alls (:func:`kron_mvm_bf_sharded`,
``gpim_tpu``'s ``shard_map`` form), CG's inner products, the Nystrom core
and the likelihood's sums are all-reduced, and the trace-estimated
gradients of the kernel factors are summed over the ranks.
"""

import math
from typing import NamedTuple, Tuple

import numpy as np
import torch

from gpim_tpu_torch.kernels.functional import get_kernel_fn
from gpim_tpu_torch.ops import gram_kernels as gk
from gpim_tpu_torch.ops.kron_exact import modeprod
from gpim_tpu_torch.ops.linalg import safe_cholesky, solve_triangular
from gpim_tpu_torch.ops.prng import jax_rademacher
from gpim_tpu_torch.parallel.distributed import (
    all_gather, all_reduce, all_to_all)

__all__ = [
    "grid_kernel_factors", "kron_mvm_bf", "GridShard", "kron_shardable",
    "kron_mvm_bf_sharded", "make_masked_grid_mvm", "KronRoot",
    "split_root", "split_apply",
    "mgrid_split_root", "batched_pcg", "batched_cg", "split_pcg",
    "ski_mll_from_mvm", "grid_kr_rows", "grid_nystrom_var",
    "grid_cross_factors", "make_grid_predictor", "mgrid_exact_var_probe",
    "kernel_self_diag", "GridSolve", "mgrid_solve_core", "love_var",
    "grid_love_var", "points_love_var", "PREDICT_CG_ITERS",
    "choose_grid", "build_interp", "build_interp_sep", "make_interp_mvm",
    "kron_eig_root", "ski_mll", "lanczos", "make_ski_predictor",
]

# CG reads whether every column has converged on the host only every this
# many iterations (each read waits for the device). The iterations after
# the last column froze change nothing (see batched_pcg), so the results
# are those of an exit test on every iteration.
CG_EXIT_CHECK_EVERY = 4
# row blocks of the Nystrom core and of the grid variance: ~256 MB each
_BLOCK_BYTES = 256 * 1024 * 1024
# The cap of the unpreconditioned predict-time solve (precond_rank 0, both
# SKI routes), which otherwise runs to CG's relative-residual test: on ~9k
# scattered points it needs ~160-210 iterations, and under the training cap
# (cg_iterations, 64 by default) its mean moved by 1e-4 for a 1e-14 change
# of the inputs. A departure: gpim_tpu caps this solve at cg_iterations.
PREDICT_CG_ITERS = 1024


# --------------------------------------------------------------------------
# kernel factors and mode products
# --------------------------------------------------------------------------

def _factor_params(p, k, d):
    """The 1D kernel parameters of grid axis ``k``: its lengthscale, and
    the output variance on the first axis only."""
    ls = torch.broadcast_to(p["lengthscale"], (d,))
    pk = {"lengthscale": ls[k][None],
          "variance": p["variance"] if k == 0 else 1.0}
    if "alpha" in p:
        pk["alpha"] = p["alpha"]
    return pk


def grid_kernel_factors(kernel, p, grids):
    """Dense 1D kernel factors K_k (G_k, G_k), one per grid axis; the output
    variance multiplies the first factor (product form per dimension,
    gpim_tpu/ops/ski.py:137-160). On a CUDA tensor each factor's distances
    are one K1 launch at (G_k, 1) x (G_k, 1).

    ``gpim_tpu`` pins the factors behind an ``optimization_barrier`` against
    a TPU miscompile of the fused factor build; eager PyTorch fuses nothing
    and needs none.
    """
    kfn = get_kernel_fn(kernel)
    d = len(grids)
    return [kfn(_factor_params(p, k, d), g[:, None], g[:, None])
            for k, g in enumerate(grids)]


def grid_cross_factors(kernel, p, grids, test_axes):
    """Per-dim 1D cross-covariances C_k = k_1d(test_axis, grid_axis), shaped
    (m_k, g_k); the output variance multiplies C_0. The grid kernel is a
    product of 1D kernels, so (x)_k C_k is the exact train-test
    cross-covariance. One K1 launch each on a CUDA tensor."""
    kfn = get_kernel_fn(kernel)
    d = len(grids)
    return [kfn(_factor_params(p, k, d), t[:, None], g[:, None])
            for k, (t, g) in enumerate(zip(test_axes, grids))]


def _mode_bf(t, M, k):
    """Apply M (m, n) along grid axis ``k`` of the batch-first tensor ``t``
    (b, n_1, ..., n_d), whose axis k + 1 has n entries: out[..., i, ...] =
    sum_x M[i, x] t[..., x, ...]. One gemm, strided-batched for a middle
    axis, with no transposed copy of ``t``."""
    shape = t.shape
    pre = math.prod(shape[:k + 1])
    post = math.prod(shape[k + 2:])
    if post == 1:
        out = t.reshape(pre, shape[k + 1]) @ M.mT
    else:
        out = torch.matmul(M, t.reshape(pre, shape[k + 1], post))
    return out.reshape(shape[:k + 1] + (M.shape[0],) + shape[k + 2:])


def kron_mvm_bf(factors, t):
    """Batch-first mode products: ``t`` is (b, g_1, ..., g_d) and factor k
    is applied as sum_x factors[k][x, m] t[..., x, ...], i.e. factors[k]^T
    (pass the transpose of a non-symmetric factor; kernel Gram factors are
    symmetric)."""
    for k, f in enumerate(factors):
        t = _mode_bf(t, f.mT, k)
    return t


class GridShard(NamedTuple):
    """This rank's block of the first grid axis: rows ``start`` to
    ``start + rows`` of ``g_1``, one of ``n`` equal blocks over the ranks of
    ``group``. Every G-sized vector of the masked lattice is then its
    contiguous block of G / n cells."""
    group: object
    n: int
    start: int
    rows: int


def kron_shardable(grid_shape, n):
    """True when the sharded mode products apply to ``n`` ranks: ``n``
    divides both leading grid axes (the shard axis and the axis the
    all-to-all parks it on), as ``gpim_tpu``'s ``kron_shardable``."""
    return (len(grid_shape) >= 2 and grid_shape[0] % n == 0
            and grid_shape[1] % n == 0)


class _AllToAllAxes(torch.autograd.Function):
    """Reshard a tensor over ``group``'s n ranks: split its axis ``split``
    into n blocks, send block j to rank j, and concatenate the blocks
    received along axis ``concat`` in rank order. The gradient takes the
    inverse path."""

    @staticmethod
    def forward(ctx, t, group, n, split, concat):
        ctx.args = (group, n, split, concat)
        x = t.unflatten(split, (n, t.shape[split] // n)).movedim(split, 0)
        y = all_to_all(x.contiguous(), group)
        return y.movedim(0, concat).flatten(concat, concat + 1)

    @staticmethod
    def backward(ctx, g):
        group, n, split, concat = ctx.args
        return (_AllToAllAxes.apply(g, group, n, concat, split), None, None,
                None, None)


def kron_mvm_bf_sharded(factors, t, shard):
    """:func:`kron_mvm_bf` for ``t`` (b, g_1 / n, g_2, ..., g_d), this
    rank's block of the first grid axis (``gpim_tpu/ops/ski.py:196-238``):
    the unsharded axes are contracted locally, one all-to-all parks the
    shard on axis 2 so that axis 1 is whole and contracted, and one more
    puts it back. Every intermediate stays shard-sized; the communication
    is two all-to-alls of the block. Needs :func:`kron_shardable`;
    differentiable."""
    d = len(factors)
    for k in range(d - 1, 0, -1):
        t = _mode_bf(t, factors[k].mT, k)
    t = _AllToAllAxes.apply(t, shard.group, shard.n, 2, 1)
    t = _mode_bf(t, factors[0].mT, 0)
    return _AllToAllAxes.apply(t, shard.group, shard.n, 1, 2)


def make_masked_grid_mvm(grid_shape, mask_flat, batch_first=False,
                         shard=None):
    """mvm(factors, noise_pj, v) = M . (x)factors (M . v) + noise_pj v, the
    masked-lattice operator; ``v`` is (G,) or (G, b), or batch-first (b, G)
    with ``batch_first`` (the CG layout). ``mask_flat`` (G,) is 1 at
    observed cells. The factors come from :func:`grid_kernel_factors`,
    built once by the caller for as many products as it needs. With a
    :class:`GridShard` (batch-first only), ``v`` and ``mask_flat`` are this
    rank's block of the cells and, over more than one rank, the mode
    products are the sharded ones."""
    grid_shape = tuple(int(s) for s in grid_shape)
    if batch_first:
        kron = kron_mvm_bf
        if shard is not None:
            grid_shape = (shard.rows,) + grid_shape[1:]
            if shard.n > 1:
                kron = lambda fs, t: kron_mvm_bf_sharded(  # noqa: E731
                    fs, t, shard)

        def mvm(factors, noise_pj, v):
            squeeze = v.dim() == 1
            if squeeze:
                v = v[None, :]
            b = v.shape[0]
            t = kron(factors, (v * mask_flat).reshape((b,) + grid_shape))
            out = mask_flat * t.reshape(b, -1) + noise_pj * v
            return out[0] if squeeze else out
        return mvm

    def mvm(factors, noise_pj, v):
        squeeze = v.dim() == 1
        if squeeze:
            v = v[:, None]
        b = v.shape[1]
        # gpim_tpu's kron_mvm: (x)_k K_k along the grid modes
        t = modeprod(factors, (v * mask_flat[:, None]).reshape(
            grid_shape + (b,))).reshape(-1, b)
        out = mask_flat[:, None] * t + noise_pj * v
        return out[:, 0] if squeeze else out
    return mvm


# --------------------------------------------------------------------------
# the Kronecker eigenspace
# --------------------------------------------------------------------------

def _decode_flat(flat, grid_shape):
    """Per-dim indices from flat row-major indices."""
    rem = flat
    out = []
    for g in reversed(grid_shape):
        out.append(rem % g)
        rem = torch.div(rem, g, rounding_mode="floor")
    return out[::-1]


def _kron_top_modes(factors, rank, dim_cap=None):
    """Per-dim ``eigh`` and the top-``rank`` Kronecker modes: (lam_top
    (rank,) descending, pruned per-dim eigenvector tables Us [(g_k, r_k)],
    per-dim mode indices mdim [(rank,)] into them). Each per-dim spectrum
    is pruned to its top min(g_k, rank, dim_cap) values first
    (gpim_tpu/ops/ski.py:378-417: lossless at the rank, a heuristic under a
    tighter ``dim_cap``).

    The selection is a stable descending sort, where ``gpim_tpu`` takes
    ``lax.top_k``: two equal grid axes give exactly tied products
    lam_i lam_j = lam_j lam_i, and both put the lower flat index first, so
    the ports pick the same modes at the rank boundary.
    """
    cap = rank if dim_cap is None else min(rank, int(dim_cap))
    lams, Us = [], []
    for f in factors:
        lam, U = torch.linalg.eigh(f)                 # ascending
        r_k = int(min(f.shape[0], cap))
        lams.append(lam.flip(0)[:r_k])
        Us.append(U.flip(1)[:, :r_k])
    lam_prod = lams[0]
    for lam in lams[1:]:
        lam_prod = (lam_prod[:, None] * lam[None, :]).reshape(-1)
    rank = int(min(rank, lam_prod.shape[0]))
    lam_sorted, order = torch.sort(lam_prod, descending=True, stable=True)
    lam_top = lam_sorted[:rank].clamp_min(0.0)
    mdim = _decode_flat(order[:rank], tuple(lam.shape[0] for lam in lams))
    return lam_top, Us, mdim


# --------------------------------------------------------------------------
# split preconditioning: the float32-stable form of the Woodbury solve
# --------------------------------------------------------------------------
#
# P^-1 = (noise I + L L^T)^-1 by the Woodbury identity computes
# (v - L C^-1 L^T v) / noise, a difference of two terms that agree to
# ~noise/lam in the top eigenspace: at G ~ 1.2M and lam_max/noise ~ 3e5 its
# float32 round-off exceeds the true value, r^T P^-1 r goes negative and
# the solve is lost (gpim_tpu/ops/ski.py:420-446). Plain CG on the split
# operator P^-1/2 A P^-1/2 with P^+-1/2 through an orthonormal Nystrom
# basis
#
#     N = L^T L = Un lam_n Un^T,   Q = L Un lam_n^-1/2   (Q^T Q = I),
#     P^-1/2 v = v/sqrt(noise) + Q [(1/sqrt(lam_n+noise)
#                                    - 1/sqrt(noise)) (Q^T v)]
#
# amplifies round-off by only sqrt(lam/noise); (Q, lam_n) does not depend
# on the noise, so it is built once a training segment.


def _orth_eig(N):
    """Eigendecomposition of a Nystrom core N = L^T L, pruned: (lam_n
    clamped at 0 and zeroed below 1e-6 of its largest, Un, inv_root with the
    pruned columns zeroed)."""
    lam_n, Un = torch.linalg.eigh(N)
    lam_n = lam_n.clamp_min(0.0)
    good = lam_n > 1e-6 * lam_n.max()
    inv_root = torch.where(good, lam_n.clamp_min(1e-30).rsqrt(),
                           torch.zeros_like(lam_n))
    return torch.where(good, lam_n, torch.zeros_like(lam_n)), Un, inv_root


def split_root(Lp):
    """Orthonormal Nystrom basis of a dense preconditioner root Lp (n, r):
    (Q, lam_n, Un) with Q^T Q = I on the kept columns and
    Lp Lp^T = Q diag(lam_n) Q^T."""
    if Lp.shape[1] == 0:
        return Lp, Lp.new_zeros((0,)), Lp.new_zeros((0, 0))
    lam_n, Un, inv_root = _orth_eig(Lp.mT @ Lp)
    return Lp @ (Un * inv_root[None, :]), lam_n, Un


class KronRoot(NamedTuple):
    """Factored orthonormal Nystrom basis of the masked Kronecker
    eigen-root, Lp = M . ((x)_k U_k)[:, sel] . diag(rl), Q = Lp C with
    C = Un lam_n^-1/2. Products with Q and Q^T are d mode products, a
    gather or scatter of r entries of the pruned mode tensor and one r x r
    gemm: the (G, r) matrix is never formed."""
    Us: Tuple[torch.Tensor, ...]  # pruned per-dim eigenvector tables (g_k, r_k)
    mflat: torch.Tensor           # (r,) int64 flat mode index into the
    #                               pruned tensor, ascending
    rl: torch.Tensor              # (r,) sqrt(lam_top), in mflat order
    C: torch.Tensor               # (r, r) Un diag(lam_n^-1/2)
    mask: torch.Tensor            # (G,) observed-cell mask (this rank's
    #                               block, sharded; Us[0] then its rows)
    group: object = None          # the ranks holding the other blocks
    n_total: int = 0              # G over every block (0: mask's length)


def _kron_root_ops(q):
    """(QT, Qm) of a :class:`KronRoot`, batch-first: QT maps (b, G) to
    (b, r), Qm maps (b, r) to (b, G)."""
    grid_shape = tuple(U.shape[0] for U in q.Us)
    pruned = tuple(U.shape[1] for U in q.Us)
    G, Gp = math.prod(grid_shape), math.prod(pruned)

    def QT(v):
        b = v.shape[0]
        t = (q.mask * v).reshape((b,) + grid_shape)
        for k, U in enumerate(q.Us):
            t = _mode_bf(t, U.mT, k)                  # applies U_k^T
        sel = all_reduce(t.reshape(b, Gp).index_select(1, q.mflat), q.group)
        return (sel * q.rl) @ q.C

    def Qm(w):
        b = w.shape[0]
        c = q.rl * (w @ q.C.mT)
        t = w.new_zeros((b, Gp)).index_copy_(1, q.mflat, c)
        t = t.reshape((b,) + pruned)
        for k, U in enumerate(q.Us):
            t = _mode_bf(t, U, k)                     # applies U_k
        return q.mask * t.reshape(b, G)

    return QT, Qm


def split_apply(Q, lam_n, noise_pj, vec_axis=0, group=None):
    """(pisqrt, logdetP) for P = noise_pj I + Q diag(lam_n) Q^T:
    ``pisqrt(v)`` applies P^-1/2 to a vector (n,) or to a block, (n, b) for
    ``vec_axis`` 0 or batch-first (b, n) for 1; ``logdetP`` is exact. ``Q``
    is a dense (n, r) basis (:func:`split_root`) or a :class:`KronRoot`
    (:func:`mgrid_split_root`). Rank 0 gives pisqrt = v / sqrt(noise).
    With ``group``, a dense ``Q`` holds this rank's equal block of the rows
    of every rank's (the sharded masked lattice's empty rank-0 basis), so
    logdetP counts the rows of all of them."""
    s = noise_pj.rsqrt()
    dd = (lam_n + noise_pj).rsqrt() - s
    if isinstance(Q, KronRoot):
        QT, Qm = _kron_root_ops(Q)
        n_total = Q.n_total or Q.mask.shape[0]

        def apply_bf(v):
            return s * v + Qm(QT(v) * dd)
    else:
        n_total = Q.shape[0] * (1 if group is None
                                else torch.distributed.get_world_size(group))

        def apply_bf(v):
            return s * v + ((v @ Q) * dd) @ Q.mT

    def pisqrt(v):
        if v.dim() == 1:
            return apply_bf(v[None, :])[0]
        return apply_bf(v) if vec_axis == 1 else apply_bf(v.mT).mT

    logdetP = (n_total * torch.log(noise_pj)
               + torch.log1p(lam_n / noise_pj).sum())
    return pisqrt, logdetP


def _kr_gram(sel, lam_top, mask_flat, block_bytes=_BLOCK_BYTES):
    """N = Lp^T Lp of the masked Kronecker eigen-root Lp = diag(mask)
    KR(sel) diag(sqrt(lam_top)) (gpim_tpu/ops/ski.py:610-645), from the
    observed cells' rows alone: a masked row of Lp is zero, so the sum
    over the n_obs rows is the sum over all G (at 30% observed, 0.3 of
    the gemm). Each row is a product of d gathered rows of the mode
    tables, built a block of about ``block_bytes`` at a time, so the
    (G, r) root is never held whole. Reading the number of observed cells
    waits for the device once."""
    r = int(lam_top.shape[0])
    root_lam = lam_top.sqrt()
    obs = torch.nonzero(mask_flat).squeeze(1)
    grid_shape = tuple(int(s.shape[0]) for s in sel)
    nb = max(1, block_bytes // max(lam_top.element_size() * r, 1))
    N = lam_top.new_zeros((r, r))
    for i in range(0, obs.shape[0], nb):
        cells = obs[i:i + nb]
        cols = root_lam * mask_flat[cells, None]
        for s, idx in zip(sel, _decode_flat(cells, grid_shape)):
            cols = cols * s.index_select(0, idx)
        N.addmm_(cols.mT, cols)
    return N


def mgrid_split_root(factors, mask_flat, rank, dim_cap="auto",
                     shard=None):
    """:func:`split_root` of the masked-lattice operator, factored: returns
    (KronRoot, lam_n, Un, modes) with modes = (lam_top, Us, mdim, sel) in the
    ascending flat-mode order every piece shares (``sel[k]`` =
    Us[k][:, mdim[k]], what prediction consumes). Noise-independent; no
    (G, r) matrix is formed (:func:`_kr_gram`).

    ``dim_cap``: "auto" caps each dimension's candidates at ~4 rank^(1/d)
    (right for the training preconditioner, where a cap can only cost CG
    iterations); None selects uncapped, as prediction must, because its
    Nystrom variance uses this eigenspace with no CG behind it.

    With a :class:`GridShard`, ``mask_flat`` is this rank's block of the
    cells: the Nystrom core is summed over the ranks, the basis applies to
    blocks (its first table holds this rank's rows), and the modes stay
    whole.
    """
    d = len(factors)
    if dim_cap == "auto":
        dim_cap = max(16, int(np.ceil(4.0 * rank ** (1.0 / max(d, 1)))))
    lam_top, Us, mdim = _kron_top_modes(factors, rank, dim_cap=dim_cap)
    flat = mdim[0]
    for k in range(1, d):
        flat = flat * Us[k].shape[1] + mdim[k]
    mflat, order = torch.sort(flat)
    lam_top = lam_top[order]
    mdim = [m[order] for m in mdim]
    sel = [U[:, m] for U, m in zip(Us, mdim)]
    if shard is None:
        N = _kr_gram(sel, lam_top, mask_flat)
        q = KronRoot(Us=tuple(Us), mflat=mflat, rl=lam_top.sqrt(), C=None,
                     mask=mask_flat)
    else:
        rows = slice(shard.start, shard.start + shard.rows)
        N = all_reduce(_kr_gram([sel[0][rows]] + sel[1:], lam_top,
                                mask_flat), shard.group)
        q = KronRoot(Us=(Us[0][rows],) + tuple(Us[1:]), mflat=mflat,
                     rl=lam_top.sqrt(), C=None, mask=mask_flat,
                     group=shard.group, n_total=shard.n * mask_flat.shape[0])
    lam_n, Un, inv_root = _orth_eig(N)
    q = q._replace(C=Un * inv_root[None, :])
    return q, lam_n, Un, (lam_top, Us, mdim, sel)


# --------------------------------------------------------------------------
# conjugate gradients
# --------------------------------------------------------------------------

def batched_pcg(mvm, pinv, B, iters, return_iters=False, vec_axis=0,
                x0=None, tol_ref=None, group=None):
    """Preconditioned CG for A X = B, all columns at once
    (gpim_tpu/ops/ski.py:698-799): returns (X, t_diags, t_offs[, realized
    iterations]). ``vec_axis`` 0: B is (n, b), a solution per column; 1:
    B is (b, n) batch-first, a solution per row (mvm and pinv take the same
    layout).

    ``x0`` (B's shape) starts the solve there: X = x0 + the CG solution of
    A D = B - A x0, and the tridiagonals then belong to the residual's
    Lanczos process, not B's. ``tol_ref`` (one value a solution) replaces
    |B|^2 as the reference of the relative exit test; pass the original
    right-hand sides' norms with ``x0``, or the test tightens with the
    smaller initial residual and the warm start saves nothing.

    With ``group`` (batch-first only), each rank holds a block of every
    vector's entries (``mvm`` and ``pinv`` take blocks): the inner products
    are all-reduced over it, so every rank takes the same steps and exits
    at the same iteration.

    Converged columns freeze: their state stops and their remaining
    tridiagonal rows stay the preallocated identity block (t_diag = 1,
    t_off = 0), which contributes exactly 0 to the SLQ quadrature. The
    tridiagonals (iters, b) are the Lanczos matrices of the preconditioned
    operator.

    ``iters`` is a cap: ``gpim_tpu``'s while_loop stops once every column
    is frozen. Here the host reads that only every
    ``CG_EXIT_CHECK_EVERY`` iterations; an iteration after every column froze writes alpha = 0,
    beta = 0, t_diag = 1 and t_off = 0, so X, R, P and the tridiagonals do
    not change and the outputs are those of an exit test every iteration.
    The realized count (the while_loop's trip count) is counted on the
    device: one for each iteration that began with a live column.
    """
    if vec_axis == 0:
        out = batched_pcg(lambda v: mvm(v.mT).mT, lambda r: pinv(r.mT).mT,
                          B.mT, iters, return_iters, 1,
                          None if x0 is None else x0.mT, tol_ref)
        return (out[0].mT,) + tuple(out[1:])
    if x0 is None:
        X, R = torch.zeros_like(B), B
    else:
        X, R = x0, B - mvm(x0)
    Z = pinv(R)
    P = Z
    rz, rs0 = all_reduce(torch.stack([(R * Z).sum(1), (R * R).sum(1)]),
                         group)
    eps = torch.finfo(B.dtype).eps
    tol = (rs0 if tol_ref is None else tol_ref).clamp_min(1e-30) \
        * (100.0 * eps) ** 2
    b = B.shape[0]
    Td = B.new_ones((iters, b))
    To = B.new_zeros((iters, b))
    alpha_prev = torch.ones_like(rz)
    beta_prev = torch.zeros_like(rz)
    done = rs0 < tol
    k_real = torch.zeros((), dtype=torch.int64, device=B.device)
    zero, one = torch.zeros_like(rz), torch.ones_like(rz)
    for k in range(iters):
        if k and k % CG_EXIT_CHECK_EVERY == 0 and bool(done.all()):
            break
        live = ~done
        k_real += live.any()
        AP = mvm(P)
        denom = all_reduce((P * AP).sum(1), group)
        pos = denom > 0
        alpha = torch.where(live & pos, rz / torch.where(pos, denom, one),
                            zero)
        X = X + alpha[:, None] * P
        R = R - alpha[:, None] * AP
        Z = pinv(R)
        rz_new, rs_new = all_reduce(
            torch.stack([(R * Z).sum(1), (R * R).sum(1)]), group)
        beta = torch.where(live, rz_new / torch.where(rz > 0, rz, one), zero)
        P = torch.where(live[:, None], Z + beta[:, None] * P, P)
        safe_alpha = torch.where(alpha > 0, alpha, one)
        safe_alpha_prev = torch.where(alpha_prev > 0, alpha_prev, one)
        done_new = done | (rs_new < tol) | ~pos | (rz_new <= 0)
        Td[k] = torch.where(live, 1.0 / safe_alpha
                            + beta_prev / safe_alpha_prev, one)
        To[k] = torch.where(live & ~done_new,
                            beta.clamp_min(0.0).sqrt() / safe_alpha, zero)
        rz, alpha_prev, beta_prev, done = rz_new, alpha, beta, done_new
    if return_iters:
        return X, Td, To, k_real
    return X, Td, To


def batched_cg(mvm, B, iters, vec_axis=0, return_iters=False, x0=None,
               tol_ref=None, group=None):
    """Unpreconditioned :func:`batched_pcg` (same frozen-column contract,
    the same warm start, the same sharding)."""
    return batched_pcg(mvm, lambda r: r, B, iters, vec_axis=vec_axis,
                       return_iters=return_iters, x0=x0, tol_ref=tol_ref,
                       group=group)


def split_pcg(mvm, pisqrt, B, iters, return_iters=False, vec_axis=0,
              group=None):
    """Split-preconditioned CG for A X = B: plain CG on
    P^-1/2 A P^-1/2 from P^-1/2 B, mapped back by P^-1/2. Same outputs as
    :func:`batched_pcg`; mvm and pisqrt share ``vec_axis``'s layout."""
    out = batched_pcg(lambda v: pisqrt(mvm(pisqrt(v))), lambda r: r,
                      pisqrt(B), iters, return_iters=return_iters,
                      vec_axis=vec_axis, group=group)
    return (pisqrt(out[0]),) + tuple(out[1:])


def _slq_from_tridiag(t_diags, t_offs, probe_sqnorms):
    """sum_i |z_i|^2 e1^T log(T_i) e1 / p over the probes' tridiagonals
    (columns of t_diags / t_offs), one batched ``eigh`` of the (p, m, m)
    matrices on the host (the CPU's LAPACK takes ~0.1 ms where the card's
    batched Jacobi takes milliseconds and waits for the device all the
    same); the result comes back on the tridiagonals' device. Pass only
    the rows that CG reached (:func:`batched_pcg`'s realized count): the
    identity tail beyond them is decoupled from e1 and adds exactly 0."""
    if t_diags.shape[0] == 0:                 # no iteration: all identity
        return t_diags.new_zeros(())
    d = t_diags.mT.cpu()
    o = t_offs.mT[:, :-1].cpu()
    T = torch.diag_embed(d) + torch.diag_embed(o, 1) + torch.diag_embed(o, -1)
    lam, U = torch.linalg.eigh(T)
    vals = probe_sqnorms.cpu() * (U[:, 0, :] ** 2
                                  * torch.log(lam.clamp_min(1e-30))).sum(1)
    return vals.mean().to(t_diags.device)


# --------------------------------------------------------------------------
# marginal likelihood with trace-estimated gradients
# --------------------------------------------------------------------------

class _SKIMLL(torch.autograd.Function):
    """0.5 yc^T A^-1 yc + 0.5 logdet A, the realized CG iterations and the
    split-space solutions for A = mvm(factors, noise_pj, .), the solve
    started from ``X0`` (None: zeros); see :func:`ski_mll_from_mvm`. With
    ``group``, the G-sized vectors are this rank's blocks: their inner
    products and the factors' and noise's gradients are summed over it."""

    @staticmethod
    def forward(ctx, mvm, cg_iters, g0, Q, lam_n, X0, group, noise_pj, yc,
                *factors):
        pisqrt, logdetP = split_apply(Q, lam_n, noise_pj, vec_axis=1,
                                        group=group)
        B = torch.cat([pisqrt(yc[None, :]), g0])
        Xt, t_diags, t_offs, k_real = batched_cg(
            lambda v: pisqrt(mvm(factors, noise_pj, pisqrt(v))), B,
            cg_iters, vec_axis=1, return_iters=True, x0=X0,
            tol_ref=(None if X0 is None
                     else all_reduce((B * B).sum(1), group)), group=group)
        X = pisqrt(Xt)
        alpha, solves = X[0], X[1:]                  # A^-1 yc, A^-1 z_i
        w = pisqrt(g0)                               # P^-1 z = P^-1/2 z~
        reached = int(k_real)          # rows beyond it are the identity
        sums = all_reduce(torch.cat([torch.dot(yc, alpha)[None],
                                     (g0 * g0).sum(1)]), group)
        logdet = logdetP + _slq_from_tridiag(
            t_diags[:reached, 1:], t_offs[:reached, 1:], sums[1:])
        out = 0.5 * sums[0] + 0.5 * logdet
        ctx.mvm = mvm
        ctx.group = group
        ctx.save_for_backward(noise_pj, alpha, solves, w, *factors)
        iters = k_real.to(out.dtype)
        ctx.mark_non_differentiable(iters, Xt)
        return out, iters, Xt

    @staticmethod
    def backward(ctx, g, _g_iters, _g_x):
        noise_pj, alpha, solves, w, *factors = ctx.saved_tensors
        # d quad = -0.5 a^T (dA) a;  d logdet = tr(A^-1 dA) ~= (1/p) sum_i
        # s_i^T (dA) w_i with s_i = A^-1 z_i, w_i = P^-1 z_i: the surrogate
        # below has these derivatives in the factors and the noise, and
        # autograd carries them on through the kernel build
        with torch.enable_grad():
            fs = [f.detach().requires_grad_(True) for f in factors]
            nz = noise_pj.detach().requires_grad_(True)
            Av = ctx.mvm(fs, nz, torch.cat([alpha[None, :], w]))
            surrogate = (-0.5 * torch.dot(alpha, Av[0])
                         + 0.5 * (solves * Av[1:]).sum() / solves.shape[0])
            grads = torch.autograd.grad(surrogate, [nz] + fs)
        flat = all_reduce(torch.cat([gr.reshape(-1) for gr in grads]),
                          ctx.group)
        grads = [v.reshape(gr.shape) for gr, v in zip(
            grads, flat.split([gr.numel() for gr in grads]))]
        return (None, None, None, None, None, None, None, g * grads[0],
                g * alpha, *(g * gf for gf in grads[1:]))


def ski_mll_from_mvm(mvm, cg_iters, g0, return_iters=False, warm_start=False,
                     group=None):
    """Returns core(factors, noise_pj, yc, Q, lam_n) = 0.5 yc^T A^-1 yc +
    0.5 logdet A for A = mvm(factors, noise_pj, .), batch-first (the mvm
    takes (b, G) blocks), with split-preconditioned CG solves, the SLQ
    log-determinant and trace-estimated gradients (the BBMM estimator,
    gpim_tpu/ops/ski.py:852-1057).

    ``(Q, lam_n)`` is the orthonormal Nystrom form of the preconditioner
    P = noise I + Q diag(lam_n) Q^T (:func:`mgrid_split_root`). It may be
    stale: every estimator is exact in expectation for any SPD P, so
    staleness costs only CG iterations; no gradient flows into it. ``g0``
    (p, G) are the probes z~ of the split operator with E[z~ z~^T] = I:
    logdet A = logdet P + E[SLQ of P^-1/2 A P^-1/2]. The gradient of the
    log-determinant is (1/p) sum_i s_i^T (dA) w_i with s_i = A^-1 z_i and
    w_i = P^-1 z_i, unbiased without differentiating the preconditioner.

    Gradients flow to ``factors``, ``noise_pj`` and ``yc`` (as g alpha);
    build the factors with autograd on and they reach the lengthscales and
    the variance through the kernel build. With ``return_iters`` the core
    returns (loss, realized CG iterations as a float tensor, which takes no
    gradient).

    ``warm_start`` (experimental, as in ``gpim_tpu``, ski.py:985-1042):
    core(factors, noise_pj, yc, Q, lam_n, X0) starts the split-space solve
    from ``X0`` (p + 1, G), e.g. the previous Adam step's solutions within
    a training segment (its basis is fixed there), with the exit test
    against |B|^2 of the original right-hand sides, and returns (loss,
    (X_new, realized CG iterations)). The gradient is the cold one (from
    the converged solves, which do not depend on the start up to the CG
    tolerance; X0 takes no gradient). The SLQ log-determinant comes from
    the residual's tridiagonals, which is biased once X0 != 0, so the
    recorded loss is approximate, in ``gpim_tpu`` as here.

    With ``group``, ``g0``, ``yc`` and every block the mvm takes are this
    rank's share of the cells (a :class:`GridShard` mvm, a sharded
    ``Q``): the loss and its gradients are the whole problem's on every
    rank.
    """
    if warm_start:
        def core_ws(factors, noise_pj, yc, Q, lam_n, X0):
            out, iters, X = _SKIMLL.apply(mvm, cg_iters, g0, Q, lam_n, X0,
                                          group, noise_pj, yc, *factors)
            return out, (X, iters)
        return core_ws

    def core(factors, noise_pj, yc, Q, lam_n):
        out, iters, _ = _SKIMLL.apply(mvm, cg_iters, g0, Q, lam_n, None,
                                      group, noise_pj, yc, *factors)
        return (out, iters) if return_iters else out
    return core


# --------------------------------------------------------------------------
# prediction on the masked lattice
# --------------------------------------------------------------------------

def _kr_block(sel, i, tb):
    """Rows i .. i + tb of the leading axis of KR(sel): (tb * rest, r)."""
    r = sel[0].shape[1]
    cols = sel[0][i:i + tb, None, :]
    for s in sel[1:]:
        cols = (cols[:, :, None, :] * s[None, None, :, :]).reshape(
            cols.shape[0], -1, r)
    return cols.reshape(-1, r)


def grid_kr_rows(sel, lam_top, mask_flat=None):
    """The (prod m_k, rank) Kronecker eigen-root on a grid: row
    (i_1..i_d) of column m is prod_k sel[k][i_k, m] sqrt(lam_m), masked by
    ``mask_flat`` if given."""
    out = _kr_block(sel, 0, sel[0].shape[0]) * lam_top.sqrt()
    return out if mask_flat is None else out * mask_flat[:, None]


def _rows_per_block(r, rest, itemsize):
    """Rows of a leading axis such that an (r, rows, rest) block of this
    item size stays within :data:`_BLOCK_BYTES`."""
    return max(1, _BLOCK_BYTES // (itemsize * r * max(rest, 1)))


def grid_nystrom_var(sel, Bmat, kss):
    """Nystrom predictive variance over a Cartesian test grid:
    kss - row_norms^2(Lt Bmat), with Lt's rows built a block of the leading
    axis at a time (the whole (M, rank) Lt is never held). ``Bmat``
    (rank, rank) carries the sqrt(lam) scaling and the Nystrom rotation
    (:func:`_nystrom_bmat`)."""
    rest = math.prod(s.shape[0] for s in sel[1:])
    tb = _rows_per_block(Bmat.shape[0], rest, Bmat.element_size())
    sq = torch.cat([(_kr_block(sel, i, tb) @ Bmat).square().sum(1)
                    for i in range(0, sel[0].shape[0], tb)])
    return (kss - sq).clamp_min(0.0)


def _nystrom_bmat(lam_top, noise_pj, lam_n, Un):
    """Nystrom rotation: with K_UU ~= U_r Lam U_r^T and A ~= Lp Lp^T +
    noise I, diag(K_* A^-1 K_*^T) is row_norms^2 of Lt Bmat with
    Lt = C U_r (the test-side root before its Lam^-1/2) and
    Bmat = Lam^-1/2 Un sqrt(lam_n / (lam_n + noise)), where
    Lp^T Lp = Un lam_n Un^T."""
    scale = (lam_n / (lam_n + noise_pj)).sqrt()
    inv_root = lam_top.clamp_min(1e-12 * lam_top.max()).rsqrt()
    return inv_root[:, None] * (Un * scale[None, :])


def kernel_self_diag(kernel, p, n, dtype):
    """k(x, x) of the product-form grid kernels: the variance (each 1D
    factor is 1 at zero distance for every supported family)."""
    del kernel
    return torch.ones(n, dtype=dtype, device=p["variance"].device) \
        * p["variance"]


class GridSolve(NamedTuple):
    """The predict-time solve of the masked lattice
    (:func:`mgrid_solve_core`): ``am`` = M alpha, grid-shaped and whole on
    every rank, the realized CG iterations, and the variance's root: the
    Nystrom rotation ``Bmat`` and mode tables ``sel`` at preconditioner
    rank > 0, else the Lanczos basis ``MQ`` (r, *grid_shape), zero at the
    masked cells and whole on every rank, and its tridiagonal ``T``."""
    am: torch.Tensor
    cg_iters: torch.Tensor
    Bmat: torch.Tensor = None
    sel: list = None
    MQ: torch.Tensor = None
    T: torch.Tensor = None


def mgrid_solve_core(kernel, p, grids, grid_shape, mask_flat, rank,
                     cg_iters, noise_pj, yc_flat, shard=None, lanczos_rank=0,
                     seed=0):
    """The predict-time solve of the masked lattice, a :class:`GridSolve`.
    At preconditioner ``rank`` > 0: split-preconditioned CG for alpha =
    A^-1 yc on the factored basis, capped at ``cg_iters``, uncapped mode
    selection (the Nystrom variance uses this eigenspace with no CG behind
    it), and the Nystrom rotation. At rank 0 (a departure: ``gpim_tpu``
    raises there, in ``_kr_gram``): plain CG to its tolerance under
    :data:`PREDICT_CG_ITERS`, and ``lanczos_rank`` Lanczos steps on the
    masked operator from JAX's Rademacher draw for ``seed`` times the mask,
    the root of the LOVE variance. The kernel factors are built once, for
    the basis and every mvm. With a :class:`GridShard` the solve runs on
    this rank's block of the cells (``mask_flat`` and ``yc_flat`` are
    blocks; CG's and Lanczos's inner products are all-reduced) and alpha
    and the Lanczos basis are gathered whole."""
    factors = grid_kernel_factors(kernel, p, grids)
    mvm = make_masked_grid_mvm(grid_shape, mask_flat, batch_first=True,
                               shard=shard)
    group = None if shard is None else shard.group
    if rank == 0:
        alpha, _, _, its = batched_cg(
            lambda v: mvm(factors, noise_pj, v), yc_flat[None, :],
            PREDICT_CG_ITERS, vec_axis=1, return_iters=True, group=group)
        v0 = torch.as_tensor(jax_rademacher(
            seed, (math.prod(grid_shape),), str(yc_flat.dtype).split(".")[-1]),
            device=yc_flat.device)
        if shard is not None:
            v0 = v0.reshape(grid_shape)[
                shard.start:shard.start + shard.rows].reshape(-1)
        Q, T = lanczos(lambda v: mvm(factors, noise_pj, v), v0 * mask_flat,
                       lanczos_rank, group)
        am, MQ = alpha[0] * mask_flat, Q * mask_flat
        if shard is not None:
            am, MQ = all_gather(am, group), all_gather(MQ, group, dim=1)
        return GridSolve(am.reshape(tuple(grid_shape)), its,
                         MQ=MQ.reshape((-1,) + tuple(grid_shape)), T=T)
    Qs, lam_n, Un, (lam_top, _, _, sel) = mgrid_split_root(
        factors, mask_flat, rank, dim_cap=None, shard=shard)
    pisqrt, _ = split_apply(Qs, lam_n, noise_pj, vec_axis=1)
    alpha, _, _, its = split_pcg(lambda v: mvm(factors, noise_pj, v), pisqrt,
                                 yc_flat[None, :], cg_iters, vec_axis=1,
                                 return_iters=True, group=group)
    am = alpha[0] * mask_flat
    if shard is not None:
        am = all_gather(am, shard.group)
    return GridSolve(am.reshape(tuple(grid_shape)), its,
                     Bmat=_nystrom_bmat(lam_top, noise_pj, lam_n, Un),
                     sel=sel)


def love_var(T, c_blocks, kss):
    """The LOVE predictive variance without the noise, kss -
    |L_T^-1 c_*|^2, with L_T the Cholesky factor of the Lanczos tridiagonal
    T + 1e-6 tr(T) / r I and c_* = K_*U Q^T, over the columns of the
    (r, m_j) blocks that ``c_blocks`` yields in turn (both SKI routes'
    rank-0 predictors; gpim_tpu/ops/ski.py:1181-1195)."""
    r = T.shape[0]
    LT, _ = safe_cholesky(
        T + 1e-6 * torch.trace(T) / r
        * torch.eye(r, dtype=T.dtype, device=T.device))
    return kss - torch.cat([solve_triangular(LT, c, lower=True).square()
                            .sum(0) for c in c_blocks])


def grid_love_var(C_list, MQ, T, kss):
    """:func:`love_var` over the Cartesian test grid of the cross factors
    ``C_list`` [(m_k, g_k)]: c_* = (x)_k C_k (M Q) for the Lanczos basis
    ``MQ`` (r, g_1, ..., g_d), built a block of the test grid's leading
    axis at a time, so no block exceeds :data:`_BLOCK_BYTES`."""
    r = MQ.shape[0]
    rest = math.prod(max(C.shape[0], C.shape[1]) for C in C_list[1:])
    tb = _rows_per_block(r, rest, MQ.element_size())

    def blocks():
        for i in range(0, C_list[0].shape[0], tb):
            t = _mode_bf(MQ, C_list[0][i:i + tb], 0)
            for k in range(1, len(C_list)):
                t = _mode_bf(t, C_list[k], k)
            yield t.reshape(r, -1)
    return love_var(T, blocks(), kss)


def points_love_var(E, MQ, T, kss):
    """:func:`love_var` at scattered test points with per-point cross rows
    ``E`` [(m, g_k)]: column j of c_* contracts (M Q) mode by mode with
    row j of every E_k, a block of points at a time within
    :data:`_BLOCK_BYTES`."""
    r = MQ.shape[0]
    sb = _rows_per_block(r, math.prod(MQ.shape[2:]), MQ.element_size())

    def blocks():
        for j in range(0, E[0].shape[0], sb):
            t = torch.einsum("bi,ri...->rb...", E[0][j:j + sb], MQ)
            for Ek in E[1:]:
                t = torch.einsum("bi,rbi...->rb...", Ek[j:j + sb], t)
            yield t
    return love_var(T, blocks(), kss)


def make_grid_predictor(kernel, grids, grid_shape, cg_iters, precond_rank,
                        shard=None, lanczos_rank=0, seed=0):
    """Returns predict(p, noise_pj, mask_flat, yc_flat, t_axes, kss) ->
    (mean, var) over the Cartesian test grid of per-dim axes ``t_axes``:
    mean = (x)_k C_k (M alpha) with the exact cross-covariances C_k, var
    (without the observation noise) the Nystrom extension of the
    eigen-root that preconditions the solve or, at ``precond_rank`` 0, the
    LOVE variance of ``lanczos_rank`` Lanczos steps
    (:func:`mgrid_solve_core`). With a :class:`GridShard` the solve is
    sharded; the test axes are the caller's. ``predict.cg_iters`` holds
    the last call's realized CG iterations."""
    def predict(p, noise_pj, mask_flat, yc_flat, t_axes, kss):
        sol = mgrid_solve_core(
            kernel, p, grids, grid_shape, mask_flat, precond_rank,
            cg_iters, noise_pj, yc_flat, shard, lanczos_rank, seed)
        predict.cg_iters = sol.cg_iters
        C_list = grid_cross_factors(kernel, p, grids, t_axes)
        mean = modeprod(C_list, sol.am).reshape(-1)
        if sol.T is not None:
            return mean, grid_love_var(C_list, sol.MQ, sol.T,
                                       kss).clamp_min(0.0)
        var = grid_nystrom_var([C @ s for C, s in zip(C_list, sol.sel)],
                               sol.Bmat, kss)
        return mean, var
    return predict


def mgrid_exact_var_probe(kernel, p, grids, grid_shape, mask_flat,
                          noise_pj, cells, cg_iters=256, rank=1024):
    """Exact posterior variance at a few lattice cells, by CG: the check of
    the rank-truncated Nystrom variance. For cell c, var_c = k(c, c) -
    (M k_c)^T A^-1 (M k_c), with k_c = K[:, c] a Kronecker column; the
    masked rows decouple exactly, so this is the dense posterior variance
    of the observed points. One batched split-CG solve; ``cells`` (n_c, d)
    integer grid indices; returns (n_c,) without the noise term."""
    factors = grid_kernel_factors(kernel, p, grids)
    cells = np.asarray(cells)
    n_c = cells.shape[0]
    cols = None
    for k, f in enumerate(factors):
        idx = torch.as_tensor(cells[:, k], device=f.device)
        fk = f.index_select(1, idx).mT                # (n_c, g_k)
        cols = fk if cols is None else (cols[:, :, None]
                                        * fk[:, None, :]).reshape(n_c, -1)
    kss = kernel_self_diag(kernel, p, n_c, cols.dtype)
    B = cols * mask_flat
    mvm = make_masked_grid_mvm(grid_shape, mask_flat, batch_first=True)
    Qs, lam_n, _, _ = mgrid_split_root(factors, mask_flat, rank,
                                       dim_cap=None)
    pisqrt, _ = split_apply(Qs, lam_n, noise_pj, vec_axis=1)
    X, _, _ = split_pcg(lambda v: mvm(factors, noise_pj, v), pisqrt, B,
                        cg_iters, vec_axis=1)
    return (kss - (B * X).sum(1)).clamp_min(0.0)


# --------------------------------------------------------------------------
# off-lattice data: grid interpolation (host side, numpy)
# --------------------------------------------------------------------------

def choose_grid(X, ratio=1.0, min_size=8, max_size=512):
    """Per-dim 1D inducing grids for the points ``X`` (n, d): g = ratio *
    n^(1/d) points, clipped to [min_size, max_size], over the data range
    padded by one step at each end (g + 2 points in ``X``'s dtype; the grids
    gpim_tpu/ops/ski.py:60-72 chooses)."""
    n, d = X.shape
    g = int(max(min_size, min(max_size, round(ratio * n ** (1.0 / d)))))
    grids = []
    for k in range(d):
        lo, hi = float(np.min(X[:, k])), float(np.max(X[:, k]))
        span = max(hi - lo, 1e-6)
        step = span / (g - 1) if g > 1 else span
        grids.append(np.linspace(lo - step, hi + step, g + 2,
                                 dtype=X.dtype))
    return grids


def _lower_corners(X, grids):
    """Per-dim lower grid index (int64, at most g_k - 2) and lower weight
    (float64, as ``gpim_tpu`` computes it) of each point."""
    i0, w0 = [], []
    for k, g in enumerate(grids):
        t = (X[:, k] - g[0]) / (g[1] - g[0])
        i = np.clip(np.floor(t).astype(np.int64), 0, len(g) - 2)
        i0.append(i)
        w0.append(1.0 - np.clip(t - i, 0.0, 1.0))
    return i0, w0


def build_interp(X, grids, mask=None):
    """Linear-interpolation weights of each point onto the Cartesian grid:
    (idx, wgt), (n, 2^d) int32 row-major flat grid indices and weights of
    the cell's corners (corner s takes the upper index along dim k where
    bit k of s is set). Rows with ``mask`` 0 get zero weights, so padding
    is inert (gpim_tpu/ops/ski.py:75-108)."""
    n, d = X.shape
    sizes = [len(g) for g in grids]
    i0, w0 = _lower_corners(X, grids)
    S = 1 << d
    idx = np.zeros((n, S), np.int64)
    wgt = np.ones((n, S), X.dtype)
    for s in range(S):
        flat = np.zeros(n, np.int64)
        w = np.ones(n, X.dtype)
        for k in range(d):
            bit = (s >> k) & 1
            flat = flat * sizes[k] + i0[k] + bit
            w = w * ((1.0 - w0[k]) if bit else w0[k])
        idx[:, s] = flat
        wgt[:, s] = w
    if mask is not None:
        wgt = wgt * np.asarray(mask, X.dtype)[:, None]
    return idx.astype(np.int32), wgt


def build_interp_sep(X, grids):
    """The separable form of :func:`build_interp`: each point's lower grid
    index (int32) and lower weight per dimension, (n, d) each; the corner
    weights are their products (gpim_tpu/ops/ski.py:111-130)."""
    i0, w0 = _lower_corners(X, grids)
    return np.stack(i0, 1).astype(np.int32), np.stack(w0, 1).astype(X.dtype)


# --------------------------------------------------------------------------
# off-lattice data: the interpolation operator and its eigen-root
# --------------------------------------------------------------------------

def _interp_apply(idx, wgt, t):
    """W t: each point's 2^d corners gathered from the (G, b) grid block
    ``t`` and weighted; returns the batch-first (b, n)."""
    n, S = idx.shape
    return (t.index_select(0, idx.reshape(-1)).reshape(n, S, -1)
            * wgt[:, :, None]).sum(1).mT


class _InterpApply(torch.autograd.Function):
    """:func:`_interp_apply` whose gradient in ``t`` is W^T g by K4 over
    W's CSR ``layout``: ``index_select``'s own backward is ``index_add_``,
    whose CUDA atomics add in no fixed order (the SKI loss's surrogate
    backward differentiates the operator through this gather). On the CPU
    both add in the same order, so the gradient is the same bit for bit."""

    @staticmethod
    def forward(ctx, t, idx, wgt, layout):
        ctx.layout = layout
        return _interp_apply(idx, wgt, t)

    @staticmethod
    def backward(ctx, g):
        return gk.interp_adjoint(ctx.layout, g.contiguous()), None, None, \
            None


def make_interp_mvm(idx, wgt, grid_shape, layout=None):
    """mvm(factors, noise_pj, v) = W (x)_k factors_k W^T v + noise_pj v, the
    SKI operator of off-lattice points (gpim_tpu/ops/ski.py:239-301, its
    plain form), batch-first: ``v`` is (n,) or (b, n). ``idx`` (int64) and
    ``wgt`` (n, 2^d) come from :func:`build_interp`; the factors from
    :func:`grid_kernel_factors`, built once by the caller. W^T is K4
    (:func:`gram_kernels.interp_adjoint`) over the CSR ``layout`` of W
    (:func:`gram_kernels.interp_layout`, built here when not given and
    kept as ``mvm.layout``); its (G, b) grid block feeds the mode products,
    and W is a gather whose gradient in the grid block is K4 again, so a
    backward through the operator runs no ``index_add_`` either."""
    grid_shape = tuple(int(s) for s in grid_shape)
    G = math.prod(grid_shape)
    if layout is None:
        layout = gk.interp_layout(idx, wgt, G)

    def mvm(factors, noise_pj, v):
        squeeze = v.dim() == 1
        if squeeze:
            v = v[None, :]
        b = v.shape[0]
        t = modeprod(factors, gk.interp_adjoint(
            layout, v.contiguous()).reshape(grid_shape + (b,)))
        out = _InterpApply.apply(t.reshape(G, b), idx, wgt, layout) \
            + noise_pj * v
        return out[0] if squeeze else out
    mvm.layout = layout
    return mvm


def kron_eig_root(modes, i0, w0, mask=None):
    """Rank-r root L = W U_r sqrt(Lam_r) of the SKI kernel's top Kronecker
    eigenspace, K_hat = W K_UU W^T ~= L L^T (gpim_tpu/ops/ski.py:314-375).
    The grid eigenvectors and the corner weights both factor per dimension,
    so column m of L is

        prod_k ( w0_k U_k[i0_k, m_k] + (1 - w0_k) U_k[i0_k + 1, m_k] ):

    d row gathers of the per-dim tables, O(n r d), nothing G-sized.
    ``modes`` = (lam_top, Us, mdim) from :func:`_kron_top_modes`, shared by
    the training- and test-side roots (they must span the same eigenspace);
    ``i0`` (int64) and ``w0`` (n, d) from :func:`build_interp_sep`;
    ``mask`` (n,) zeroes padded rows. ``gpim_tpu`` interpolates each table
    by a dense (n, g_k) one-hot gemm, for the TPU's slow minor-dimension
    gathers; the row gather gives the same root to round-off."""
    lam_top, Us, mdim = modes
    out = None
    for k, (U, m) in enumerate(zip(Us, mdim)):
        U_sel = U[:, m]                                  # (g_k, r)
        w = w0[:, k, None]
        cols = U_sel.index_select(0, i0[:, k]).mul_(w)
        cols.addcmul_(U_sel.index_select(0, i0[:, k] + 1), 1.0 - w)
        out = cols if out is None else out.mul_(cols)
    out.mul_(lam_top.sqrt())
    return out if mask is None else out.mul_(mask[:, None])


def ski_mll(idx, wgt, grid_shape, cg_iters, g0, return_iters=False,
            layout=None):
    """:func:`ski_mll_from_mvm` over the interpolation operator
    (gpim_tpu/ops/ski.py:844-882): core(factors, noise_pj, yc, Q, lam_n),
    with ``g0`` (p, n) the batch-first probes and (Q, lam_n) the dense
    Nystrom basis of :func:`kron_eig_root` through :func:`split_root`;
    ``layout`` as in :func:`make_interp_mvm`."""
    return ski_mll_from_mvm(make_interp_mvm(idx, wgt, grid_shape, layout),
                            cg_iters, g0, return_iters=return_iters)


# --------------------------------------------------------------------------
# off-lattice prediction: the SKI mean, the Nystrom or LOVE variance
# --------------------------------------------------------------------------

def lanczos(mvm, v0, rank, group=None):
    """``rank`` Lanczos steps on ``mvm`` from ``v0`` (n,) with full
    reorthogonalisation (gpim_tpu/ops/ski.py:1064-1089): returns Q (rank, n)
    and the tridiagonal T (rank, rank). A breakdown divides by 1e-30 rather
    than stopping, as there, so nothing waits for the device. With
    ``group``, ``v0`` and every vector ``mvm`` takes are this rank's block
    of the entries: the dots, the norms and the reorthogonalisation's
    products are all-reduced over it, so every rank holds its block of the
    same Q and the whole T."""
    def norm(x):
        return x.norm() if group is None else all_reduce(
            torch.dot(x, x), group).sqrt()
    q = v0 / norm(v0).clamp_min(1e-30)
    Q = v0.new_zeros((rank,) + tuple(v0.shape))
    alphas, betas = v0.new_empty(rank), v0.new_empty(rank)
    q_prev, beta = torch.zeros_like(q), v0.new_zeros(())
    for k in range(rank):
        w = mvm(q)
        alpha = all_reduce(torch.dot(q, w), group)
        w = w - alpha * q - beta * q_prev
        # rows k and on of Q are still zero
        w = w - Q.mT @ all_reduce(Q @ w, group)
        beta = norm(w)
        Q[k] = q
        alphas[k], betas[k] = alpha, beta
        q_prev, q = q, w / beta.clamp_min(1e-30)
    T = (torch.diag(alphas) + torch.diag(betas[:-1], 1)
         + torch.diag(betas[:-1], -1))
    return Q, T


def make_ski_predictor(kernel, grids, grid_shape, idx, wgt, i0, w0, mask,
                       cg_iters, rank, precond_rank=0, layout=None):
    """Returns predict(p, noise_pj, yc, test_idx, test_wgt, t_i0, t_w0, kss,
    seed) -> (mean, var), the SKI posterior at the test points
    (gpim_tpu/ops/ski.py:1092-1199), without the noise term:

        mean_* = w_*^T K_UU W^T alpha,   alpha = A^-1 yc.

    With ``precond_rank`` > 0 the solve is split-preconditioned by the
    Kronecker eigen-root, capped at ``cg_iters``, and the variance is the
    Nystrom extension of the same root: kss - row_norms^2(Lt Un
    sqrt(lam_n / (lam_n + noise))), with Lp^T Lp = Un lam_n Un^T for the
    training-side root Lp and Lt the test-side root. At 0 the solve is
    Jacobi-preconditioned CG run to its tolerance under
    :data:`PREDICT_CG_ITERS` (a departure: ``gpim_tpu`` caps it at
    ``cg_iters``), and the variance LOVE's (:func:`love_var`) with
    c_* = w_*^T K_UU W^T Q^T and Q, T from ``rank`` Lanczos steps on A,
    started from JAX's Rademacher draw for ``seed``. ``idx``, ``wgt``,
    ``i0``, ``w0`` and ``mask`` are the training points' interpolation,
    ``layout`` W's CSR form (:func:`make_interp_mvm`); the kernel factors
    are built once a call (d K1 launches on CUDA). ``predict.cg_iters``
    holds the last call's realized CG iterations."""
    grid_shape = tuple(int(s) for s in grid_shape)
    G = math.prod(grid_shape)
    op = make_interp_mvm(idx, wgt, grid_shape, layout)

    def predict(p, noise_pj, yc, test_idx, test_wgt, t_i0, t_w0, kss, seed):
        factors = grid_kernel_factors(kernel, p, grids)

        def kuu_wt(v):                                  # (b, n) -> (G, b)
            b = v.shape[0]
            return modeprod(factors, gk.interp_adjoint(
                op.layout, v.contiguous()).reshape(grid_shape + (b,))
            ).reshape(G, b)

        def mvm(v):
            return op(factors, noise_pj, v)
        if precond_rank > 0:
            modes = _kron_top_modes(factors, precond_rank)
            Qs, lam_n, Un = split_root(kron_eig_root(modes, i0, w0, mask))
            pisqrt, _ = split_apply(Qs, lam_n, noise_pj, vec_axis=1)
            alpha, _, _, its = split_pcg(mvm, pisqrt, yc[None, :], cg_iters,
                                         return_iters=True, vec_axis=1)
        else:
            alpha, _, _, its = batched_pcg(
                mvm, lambda r: r / noise_pj, yc[None, :], PREDICT_CG_ITERS,
                return_iters=True, vec_axis=1)
        predict.cg_iters = its
        mean = _interp_apply(test_idx, test_wgt, kuu_wt(alpha))[0]
        if precond_rank > 0:
            H = kron_eig_root(modes, t_i0, t_w0) @ Un
            var = kss - H.mul_((lam_n / (lam_n + noise_pj)).sqrt()).square_(
            ).sum(1)
        else:
            v0 = torch.as_tensor(
                jax_rademacher(seed, (yc.shape[0],),
                               str(yc.dtype).split(".")[-1]),
                device=yc.device)
            Q, T = lanczos(mvm, v0, rank)
            var = love_var(
                T, [_interp_apply(test_idx, test_wgt, kuu_wt(Q))], kss)
        return mean, var.clamp_min(0.0)

    return predict
