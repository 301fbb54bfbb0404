"""
Explicit inverse of a lower-triangular factor and the Gram matrix of one
(counterpart of ``gpim_tpu/ops/tri.py``): ``A^-1 = V^T V`` with
``V = L^-1`` from the Cholesky factor, LAPACK's ``potri`` as two steps.

Below the crossover each function is one library call,
``solve_triangular(L, I)`` or ``V.mT @ V``. From ``_BLOCKED_MIN`` on, a
matrix takes a blocked route that uses its triangles. Both routes split
the matrix by bisection on multiples of 128 into leaves of about
``_LEAF``:

- ``tri_inverse``: ``L = [[L11, 0], [L21, L22]]`` has the inverse
  ``[[V11, 0], [-V22 L21 V11, V22]]``. The leaves are solved against the
  identity, runs of equal leaves in one batched call; every off-diagonal
  block is two gemms, assembled in place into one preallocated output
  (concatenating level by level is what made the JAX package's first
  version lose). About 2n^3/3 gemm flops against the solve's n^3 in one
  sequential chain.
- ``tri_gram``: for ``V = [[A, 0], [B, C]]``,
  ``V^T V = [[A^T A + B^T B, B^T C], [C^T B, C^T C]]``. Only the lower
  blocks are computed (2n^3/3 gemm flops against the general product's
  2n^3); the upper ones are their transposed copies, so the result is
  exactly symmetric.

Measured on an H100 80GB HBM3 at 700 W (``tools/tri_design.py``, the
numbers in ``PERF.md``): at n = 6144 in float64 the library pair takes
17.5 ms (the solve 10.2 ms, of it 3.6 ms in a gemm that its trsm runs
inside; the product 7.3 ms) and the blocked pair 7.0 ms; in float32 17.6
against 7.8 ms. The blocked pair wins in both precisions at every size
measured from 3072^2 elements up: n = 3072 to 6144, and task axes of 3 to
8 at n = 2048, 16 at 1024, 64 at 512 and 64 at 2048 (45.0 against
19.7 ms in float64). Below that it loses or ties (its ~40 launches cost
more than the work saved): n <= 1027, float64 at n = 2048, 6 tasks at
640. Leaves of 512 or more run one trsm each and give up a third of the
gain.

The blocked route is taken only where no gradient is asked of its input
(it writes into preallocated outputs); under autograd both functions stay
the library calls. Each function counts its blocked runs in a plain int
attribute (``tri_inverse.blocked``, ``tri_gram.blocked``).
"""

import torch

__all__ = ["tri_inverse", "tri_gram"]

# The crossover: a matrix of this order or more takes the blocked route, and
# so does a batch of matrices with as many elements in all (module docstring).
_BLOCKED_MIN = 3072
# Bisect a block while it is at least twice this; split on multiples of
# _SPLIT, so every padded n can take the route.
_LEAF = 256
_SPLIT = 128


def _takes_blocked(M):
    """Whether ``M`` (a square matrix, or a batch of them) takes the
    blocked route: by its size, the elements of the whole batch. Never at
    n <= 256, so BO's padded n stays on the library calls whatever the
    constants."""
    n = M.shape[-1]
    return (n > 256 and M.numel() >= _BLOCKED_MIN ** 2
            and not (torch.is_grad_enabled() and M.requires_grad))


def _tree(n):
    """The bisection of an order-``n`` matrix: internal blocks
    ``(depth, offset, size, split)`` by depth, then along the diagonal, and
    leaves ``(depth, offset, size)`` along the diagonal."""
    nodes, leaves = [], []

    def visit(d, o, s):
        if s < 2 * _LEAF:
            leaves.append((d, o, s))
            return
        h = _SPLIT * ((s + _SPLIT) // (2 * _SPLIT))
        nodes.append((d, o, s, h))
        visit(d + 1, o, h)
        visit(d + 1, o + h, s - h)

    visit(0, 0, n)
    nodes.sort()
    return nodes, leaves


def _runs(blocks, key):
    """Consecutive diagonal blocks (offset second, size third) that share
    ``key``, as ``(first block, count)``: each run is one batched call."""
    runs = []
    for b in blocks:
        last = runs[-1] if runs else None
        if (last and key(last[0]) == key(b)
                and last[0][1] + last[1] * last[0][2] == b[1]):
            last[1] += 1
        else:
            runs.append([b, 1])
    return runs


def _batched(M):
    """``M`` as a (batch, n, n) view where its strides allow (a copy
    otherwise), and the shape to give the result back."""
    n = M.shape[-1]
    return (M.unsqueeze(0) if M.dim() == 2 else M.reshape(-1, n, n)), M.shape


def _blocks(M, r, c, rows, cols, k, step):
    """``k`` rows-by-cols blocks of each matrix of ``M`` (batch, n, n), the
    first at (r, c), each next ``step`` further down the diagonal, as one
    view: (batch, rows, cols) for one block, (k, rows, cols) of one matrix,
    else (batch, k, rows, cols)."""
    if k == 1:
        return M[:, r:r + rows, c:c + cols]
    sb, sr, sc = M.stride()
    shape, strides = (k, rows, cols), (step * (sr + sc), sr, sc)
    if M.shape[0] > 1:
        shape, strides = (M.shape[0],) + shape, (sb,) + strides
    return M.as_strided(shape, strides, M.storage_offset() + r * sr + c * sc)


def _bmm(a, b, out=None, add=False):
    """``a @ b`` of :func:`_blocks` views by batched gemms, written into
    ``out`` in place (added to it with ``add``) or into a new tensor: one
    gemm over the blocks of one matrix or over the tasks of one block, one
    a block where there are both."""
    if a.dim() == 4:
        if out is None:
            out = a.new_empty(a.shape[:-1] + b.shape[-1:])
        for i in range(a.shape[1]):
            _bmm(a[:, i], b[:, i], out[:, i], add)
    elif out is None:
        out = torch.bmm(a, b)
    elif add:
        out.baddbmm_(a, b)
    else:
        torch.bmm(a, b, out=out)
    return out


def _tri_inverse_blocked(L):
    L, shape = _batched(L)
    nodes, leaves = _tree(L.shape[-1])
    V = torch.zeros(L.shape, dtype=L.dtype, device=L.device)
    for (_, o, s), k in _runs(leaves, lambda b: b[2]):
        eye = torch.eye(s, dtype=L.dtype, device=L.device)
        _blocks(V, o, o, s, s, k, s).copy_(torch.linalg.solve_triangular(
            _blocks(L, o, o, s, s, k, s), eye, upper=False))
    # deepest blocks first: V11 and V22 are whole when their pair combines
    for (_, o, s, h), k in reversed(_runs(nodes, lambda b: b[::2])):
        w = s - h
        T = _bmm(_blocks(L, o + h, o, w, h, k, s),
                 _blocks(V, o, o, h, h, k, s))
        T.neg_()
        _bmm(_blocks(V, o + h, o + h, w, w, k, s), T,
             out=_blocks(V, o + h, o, w, h, k, s))
    return V.reshape(shape)


def _tri_gram_blocked(V):
    V, shape = _batched(V)
    n = V.shape[-1]
    nodes, leaves = _tree(n)
    G = torch.empty(V.shape, dtype=V.dtype, device=V.device)
    # A block's diagonal square is empty (fresh) until an ancestor adds
    # B^T B over it: a top child never is, a bottom child as its parent.
    # Fresh squares are written, the others added to, parents first.
    fresh = {(0, n): True}
    for _, o, s, h in nodes:
        fresh[(o, h)] = False
        fresh[(o + h, s - h)] = fresh[(o, s)]
    for (_, o, s, h), k in _runs(nodes, lambda b: b[::2] + (fresh[b[1:3]],)):
        w = s - h
        Bk = _blocks(V, o + h, o, w, h, k, s)
        for out, a in ((_blocks(G, o, o, h, h, k, s), Bk),
                       (_blocks(G, o + h, o, w, h, k, s),
                        _blocks(V, o + h, o + h, w, w, k, s))):
            _bmm(a.mT, Bk, out=out, add=not fresh[(o, s)])
    for (_, o, s), k in _runs(leaves, lambda b: (b[2], fresh[b[1:]])):
        D = _blocks(V, o, o, s, s, k, s)
        _bmm(D.mT, D, out=_blocks(G, o, o, s, s, k, s),
             add=not fresh[(o, s)])
    # the upper blocks are the lower ones transposed, bit for bit; the
    # largest last, so that the L2 cache holds A^-1 for its reader
    for (_, o, s), k in _runs(leaves, lambda b: b[2]):
        D = _blocks(G, o, o, s, s, k, s)
        lower = torch.ones(s, s, dtype=torch.bool, device=V.device).tril()
        D.copy_(torch.where(lower, D, D.mT))
    for (_, o, s, h), k in reversed(_runs(nodes, lambda b: b[::2])):
        _blocks(G, o, o + h, h, s - h, k, s).copy_(
            _blocks(G, o + h, o, s - h, h, k, s).mT)
    return G.reshape(shape)


def tri_inverse(L):
    """Inverse of a lower-triangular matrix: ``solve_triangular(L, I)``,
    or its blocked form from ``_BLOCKED_MIN`` on (module docstring)."""
    if _takes_blocked(L):
        tri_inverse.blocked += 1
        return _tri_inverse_blocked(L)
    eye = torch.eye(L.shape[-1], dtype=L.dtype, device=L.device)
    return torch.linalg.solve_triangular(L, eye, upper=False)


tri_inverse.blocked = 0


def tri_gram(V):
    """``V^T V`` of a lower-triangular ``V`` (``A^-1`` from ``V = L^-1``):
    ``V.mT @ V``, or its blocked form from ``_BLOCKED_MIN`` on (module
    docstring)."""
    if _takes_blocked(V):
        tri_gram.blocked += 1
        return _tri_gram_blocked(V)
    return V.mT @ V


tri_gram.blocked = 0
