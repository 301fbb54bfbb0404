"""
The three kernels of the exact-GP and VFE paths, and the interpolation
adjoint of the off-lattice SKI route: CUDA for Hopper, each beside its
plain PyTorch version. Counterpart of ``gpim_tpu/ops/pallas_gram.py``
(K1-K3); K4 has no Pallas counterpart (see its section).

Dispatch rule, the same for every wrapper: a CPU tensor takes the plain
version; a CUDA tensor launches the kernel (``csrc/gram_kernels.cu``, built
at first use by :mod:`gpim_tpu_torch.ops._build`) or raises. There is no
fallback from CUDA to the plain version. The kernels are templated on
float32 and float64, so every CUDA call goes through a kernel whatever the
precision.

Every wrapper and plain version of K1-K3 takes an optional leading task
axis: T independent problems in one call, the batch that ``gpim_tpu``'s
``vmap`` over output channels gives its Pallas kernels
(``gpim_tpu/gpreg/multi.py``).
Per-task operands carry it; the padding mask, and K3's unscaled X, are
shared. On CUDA the T problems are one launch, and an unbatched call is the
same kernel at T = 1.

Each wrapper counts its launches in a plain int attribute
(``sqdist.launches``, ``masked_system.launches``,
``rbf_bwd_reductions.launches``, ``interp_adjoint.launches``),
incremented where the kernel is launched and nowhere else, so a run can
show that its main path went through the kernels; a batched call is one
launch. Inside :func:`log_calls`, every call
of K1, K2 or K3, on either device, also records its kernel, device type and
operand shape, so a sharded run can show what share each rank computed.
Wrappers check device, dtype, shape
and contiguity, allocate their outputs with ``torch.empty``, launch on the
current stream and never synchronise.
"""

import contextlib
import ctypes
import math
from typing import NamedTuple

import torch

from gpim_tpu_torch.ops import _build

__all__ = [
    "MAX_D", "KERNEL_IDS", "min_traffic", "log_calls", "note_call",
    "sqdist", "sqdist_plain",
    "masked_system", "masked_system_plain",
    "rbf_bwd_reductions", "rbf_bwd_reductions_plain",
    "InterpLayout", "interp_layout", "interp_adjoint",
    "interp_adjoint_plain",
]

MAX_D = 8                    # feature count the CUDA kernels take
KERNEL_IDS = {"RBF": 0, "Matern52": 1, "RationalQuadratic": 2}
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
# grid.y limits: K1 tiles have 32 rows, K2 tiles 64 (csrc/gram_kernels.cu);
# the task axis is grid.z (K1, K2) or grid.y (K3)
_MAX_SQDIST_ROWS = 65535 * 32
_MAX_SYSTEM_ROWS = 65535 * 64
_MAX_TASKS = 65535
_SQRT5 = math.sqrt(5.0)


def min_traffic(name, n, d, m=None, itemsize=4, batch=1):
    """(bytes read, bytes written, operations) of one call of kernel
    ``name`` at these shapes: each input read once and each output written
    once, whatever the kernel reads again; operations per element as the
    RBF form of its arithmetic does them, an exp counted as one. ``m`` is
    K1's column count, ``batch`` the number of tasks; the operands that the
    tasks share (the mask, K3's X) count once. For K4 (``interp_adjoint``)
    ``n`` is the points, ``d`` their dimension (2^d corners each), ``m``
    the grid cells G and ``batch`` the block's columns b: it reads the
    block, each entry's weight and int32 point and the int32 row pointers,
    and writes the (G, b) block; a multiply and an add an entry and
    column."""
    T = batch
    if name == "sqdist":
        return (T * (n * d + m * d) * itemsize, T * n * m * itemsize,
                T * 3 * d * n * m)
    if name == "masked_system":
        # Xs and 3 scalars a task, the shared mask -> Kt, A
        return ((T * (n * d + 3) + n) * itemsize, T * 2 * n * n * itemsize,
                T * (3 * d + 6) * n * n)
    if name == "rbf_bwd_reductions":
        # Ainv, Kt, alpha a task, the shared mask and X -> S1, rw, WX,
        # diagsum a task
        return ((T * (2 * n * n + n) + n + n * d) * itemsize,
                T * (2 + n + n * d) * itemsize, T * (2 * d + 6) * n * n)
    if name == "interp_adjoint":
        nnz = n * 2 ** d
        return (T * n * itemsize + nnz * (itemsize + 4) + (m + 1) * 4,
                m * T * itemsize, 2 * nnz * T)
    raise ValueError(name)


_CALLS = []         # the open logs of log_calls()


@contextlib.contextmanager
def log_calls():
    """Yields a list that receives ``(kernel, device type, shape)`` for
    every K1, K2 and K3 call while the block runs: K1 ``(T, n, m, d)``, K2
    and K3 ``(T, n, d)``, T = 1 unbatched."""
    log = []
    _CALLS.append(log)
    try:
        yield log
    finally:
        _CALLS.remove(log)


def note_call(name, t, n, m_or_d, *rest):
    """Record one call of kernel ``name`` on the device of ``t`` in every
    open :func:`log_calls` log."""
    if _CALLS:
        entry = (name, t.device.type,
                 (t.shape[0] if t.dim() == 3 else 1, int(n), int(m_or_d))
                 + tuple(int(r) for r in rest))
        for log in _CALLS:
            log.append(entry)


def _tasks(name, t, ndim):
    """The task count of ``t``, which has ``ndim`` dimensions unbatched and
    one more with a leading task axis."""
    if t.dim() == ndim:
        return 1
    if t.dim() == ndim + 1 and t.shape[0] <= _MAX_TASKS:
        return t.shape[0]
    raise ValueError("%s: expected %d dimensions, or %d with at most %d "
                     "tasks, got shape %s" % (name, ndim, ndim + 1,
                                              _MAX_TASKS, tuple(t.shape)))


def _check_cuda(name, tensors, d=None):
    """Validate the operands of a CUDA launch; returns their dtype."""
    first = tensors[0]
    dtype = first.dtype
    if dtype not in _SUFFIX:
        raise TypeError("%s: CUDA kernel takes float32 or float64, got %s"
                        % (name, dtype))
    for t in tensors:
        if not t.is_cuda or t.device != first.device:
            raise ValueError("%s: every operand must be on %s"
                             % (name, first.device))
        if t.dtype != dtype:
            raise TypeError("%s: mixed dtypes %s and %s"
                            % (name, dtype, t.dtype))
        if not t.is_contiguous():
            raise ValueError("%s: operands must be contiguous" % name)
    if d is not None and not 1 <= d <= MAX_D:
        raise ValueError("%s: CUDA kernel takes 1 <= d <= %d features, got %d"
                         % (name, MAX_D, d))
    return dtype


def _launch(entry, dtype, *args):
    lib = _build.load_library()
    rc = getattr(lib, "%s_%s" % (entry, _SUFFIX[dtype]))(*args)
    if rc != 0:
        raise RuntimeError("%s launch failed: CUDA error %d (%s)" % (
            entry, rc, lib.gpim_error_string(rc).decode()))


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def _stream(t):
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


# ---------------------------------------------------------------------------
# K1: pairwise squared distances
#
# Replaces pairwise_sq_dist_pallas (gpim_tpu/ops/pallas_gram.py:93-103,
# pallas_call at :77, body _sqdist_kernel :53-59). Bound by the n*m values
# it writes (d <= 8 flops per value): 100 MB at the flagship's (4096, 6144)
# f32 cross-Gram, 127 MB at the VFE's (1027, 30848) Kmn, every training
# step. So the kernel is built for its stores, as K2 is: a block owns 32
# rows x 128 columns (f32; 64 in f64), each thread writes one 16-byte
# streaming (evict-first) store per row from column points held in
# registers, the tile's row points are staged once, and d is a template
# argument. Where rows do not start 16-byte aligned (m not a multiple of
# the vector width, or a misaligned output) each row's vectors shift to
# their own boundaries and the few head and tail columns are written one
# by one. Direct per-feature
# differences make coincident points exactly 0, with no norm-trick snap.
# The backward is the closed form of pallas_gram.py:110-119 in torch.matmul
# (the JAX backward is plain XLA too). With a task axis, (T, n, d) x
# (T, m, d) -> (T, n, m) is one launch over a grid of T tile planes: at the
# multi-output predict's (64, 2048, 2048) chunk it writes 1.07 GB in f32.
# ---------------------------------------------------------------------------

def sqdist_plain(A, B):
    """(..., n, d) x (..., m, d) -> (..., n, m) squared distances by
    per-feature differences, summed in feature order (the kernel's order);
    A and B share their leading task axes."""
    acc = torch.zeros(A.shape[:-1] + (B.shape[-2],), dtype=A.dtype,
                      device=A.device)
    for k in range(A.shape[-1]):
        diff = A[..., :, k, None] - B[..., None, :, k]
        acc = acc + diff * diff
    return acc


def _sqdist_forward(A, B):
    if not A.is_cuda:
        return sqdist_plain(A, B)
    tasks = _tasks("sqdist", A, 2)
    n, d = A.shape[-2:]
    m = B.shape[-2]
    dtype = _check_cuda("sqdist", (A, B), d)
    if B.shape[:-2] != A.shape[:-2] or B.shape[-1] != d:
        raise ValueError("sqdist: shapes %s and %s do not pair"
                         % (tuple(A.shape), tuple(B.shape)))
    if n > _MAX_SQDIST_ROWS:
        raise ValueError("sqdist: at most %d rows, got %d"
                         % (_MAX_SQDIST_ROWS, n))
    out = torch.empty(A.shape[:-1] + (m,), dtype=dtype, device=A.device)
    _launch("gpim_sqdist", dtype, _ptr(A), _ptr(B), _ptr(out), n, m, d,
            tasks, _stream(A))
    sqdist.launches += 1
    return out


class _SqDist(torch.autograd.Function):
    @staticmethod
    def forward(ctx, A, B):
        ctx.save_for_backward(A, B)
        return _sqdist_forward(A, B)

    @staticmethod
    def backward(ctx, g):
        # d(d2_ij)/dA_ik = 2 (A_ik - B_jk)
        A, B = ctx.saved_tensors
        dA = dB = None
        if ctx.needs_input_grad[0]:
            dA = 2.0 * (A * g.sum(dim=-1, keepdim=True) - g @ B)
        if ctx.needs_input_grad[1]:
            dB = 2.0 * (B * g.sum(dim=-2)[..., None] - g.mT @ A)
        return dA, dB


def sqdist(A, B):
    """K1 wrapper: pairwise squared Euclidean distances, (n, d) x (m, d) ->
    (n, m), or (T, n, d) x (T, m, d) -> (T, n, m) task by task in one
    launch, differentiable in both arguments. On CUDA, float32 agrees with
    :func:`sqdist_plain` to a few ulp of the largest distance (the kernel
    may contract the sum into FMAs); coincident points give exactly 0."""
    return _SqDist.apply(A, B)


sqdist.launches = 0


# ---------------------------------------------------------------------------
# K2: fused masked training system
#
# Replaces fused_masked_system_pallas (pallas_gram.py:168-210, pallas_call
# at :186, body _system_kernel :134-165). Bound by the 2 n^2 values it
# writes: at the flagship's n = 6144, 302 MB (f32) per Adam step. So the
# kernel is built for its stores: a block owns 64 rows x 128 columns (f32;
# 64 in f64), each thread writes one 16-byte vector of Kt and one of A per
# row from column points held in registers, and the tile's row points are
# staged once. Where n is not a multiple of the vector width the same
# kernel runs with one element per thread. The kernel family is a template
# argument; the scalars (v, noise + jitter, alpha) are passed as device
# scalars, so no Adam step copies one to the host and the wrapper launches
# nothing else. Not differentiable: the caller (engine._NLLFast) owns the
# gradient. With a task axis, Xs (T, n, d) and the scalars (T,) give Kt and
# A (T, n, n) in one launch, the mask shared: at the multi-output training
# step's T = 64, n = 2048 it writes 2.15 GB in f32.
# ---------------------------------------------------------------------------

def _kernel_plain(kernel, s, variance, alpha):
    if kernel == "RBF":
        return variance * torch.exp(-0.5 * s)
    if kernel == "Matern52":
        r = torch.sqrt(s + 1e-12)
        return (variance * (1.0 + _SQRT5 * r + (5.0 / 3.0) * r * r)
                * torch.exp(-_SQRT5 * r))
    if kernel == "RationalQuadratic":
        return variance * torch.exp(-alpha * torch.log1p(s / (2.0 * alpha)))
    raise NotImplementedError(kernel)


def masked_system_plain(Xs, mask, variance, noise_plus_jitter, alpha=None,
                        *, kernel):
    """(Kt, A) from scaled inputs: Kt = v k(s) with its diagonal exactly v,
    A = (m m^T) . (Kt + (noise + jitter) I) + (I - diag m); with a task
    axis on ``Xs``, the scalars are one a task."""
    n = Xs.shape[-2]
    v, nj, a = (None if x is None else torch.as_tensor(
        x, dtype=Xs.dtype, device=Xs.device)[..., None, None]
        for x in (variance, noise_plus_jitter, alpha))
    K = _kernel_plain(kernel, sqdist_plain(Xs, Xs), v, a)
    eye = torch.eye(n, dtype=Xs.dtype, device=Xs.device)
    K = torch.where(eye.bool(), v, K)
    mm = mask[:, None] * mask[None, :]
    A = mm * (K + nj * eye) + (1.0 - mask)[:, None] * eye
    return K, A


def masked_system(Xs, mask, variance, noise_plus_jitter, alpha=None, *,
                  kernel):
    """K2 wrapper: (Kt, A) from scaled inputs ``Xs`` (n, d) and the 0/1
    padding ``mask`` (n,) in one pass; or, with ``Xs`` (T, n, d) and the
    scalars (T,), Kt and A (T, n, n) for T tasks in one launch. ``alpha``
    only for RationalQuadratic. On CUDA, float32 agrees with
    :func:`masked_system_plain` to about 1e-6 of v (one exp of a distance
    that differs by a few ulp)."""
    note_call("masked_system", Xs, *Xs.shape[-2:])
    if not Xs.is_cuda:
        return masked_system_plain(Xs, mask, variance, noise_plus_jitter,
                                   alpha, kernel=kernel)
    if kernel not in KERNEL_IDS:
        raise NotImplementedError(kernel)
    tasks = _tasks("masked_system", Xs, 2)
    n, d = Xs.shape[-2:]
    dtype = _check_cuda("masked_system", (Xs, mask), d)
    if mask.shape != (n,):
        raise ValueError("masked_system: mask must be (%d,), got %s"
                         % (n, tuple(mask.shape)))
    if n > _MAX_SYSTEM_ROWS:
        raise ValueError("masked_system: at most %d rows, got %d"
                         % (_MAX_SYSTEM_ROWS, n))
    if kernel == "RationalQuadratic" and alpha is None:
        raise ValueError("masked_system: RationalQuadratic needs alpha")
    # device scalars of the kernel's dtype, one a task; a CUDA tensor of
    # that dtype and shape passes through as it is
    scalars = []
    for x in (variance, noise_plus_jitter, alpha):
        if x is not None:
            x = torch.as_tensor(x, dtype=dtype, device=Xs.device)
            if x.shape != Xs.shape[:-2]:
                raise ValueError("masked_system: scalars must have shape %s, "
                                 "got %s" % (tuple(Xs.shape[:-2]),
                                             tuple(x.shape)))
            x = x.contiguous()
        scalars.append(x)
    v, nj, a = scalars
    Kt = torch.empty(Xs.shape[:-1] + (n,), dtype=dtype, device=Xs.device)
    A = torch.empty_like(Kt)
    _launch("gpim_masked_system", dtype, _ptr(Xs), _ptr(mask), _ptr(v),
            _ptr(nj), None if a is None else _ptr(a), _ptr(Kt), _ptr(A), n,
            d, KERNEL_IDS[kernel], tasks, _stream(Xs))
    masked_system.launches += 1
    return Kt, A


masked_system.launches = 0


# ---------------------------------------------------------------------------
# K3: closed-form RBF backward reductions
#
# Replaces rbf_bwd_reductions_pallas (pallas_gram.py:270-321, pallas_call
# at :283, body _bwd_red_kernel :228-267). Bound by the 2 n^2 values it
# reads (Ainv and Kt): 302 MB per Adam step at n = 6144 in f32; W is never
# written. So the kernel is built for its loads: each warp owns two whole
# rows (the TPU kernel carried row sums across its sequential column grid,
# which Hopper blocks cannot do) and reads them in 16-byte vectors, with the
# column side (alpha, mask, X) loaded once for both rows. The scalar sums
# come from the same launch: the last block to finish adds the blocks' sums
# in block order. Every sum has a fixed order, so the f32 result is the
# same in every run. Where n is not a multiple of the vector width, or an
# operand does not start 16-byte aligned, the same kernel runs with one
# element per thread. rw comes out as (n,), not the TPU's (n, 128) lane
# broadcast. With a task axis, Ainv and Kt (T, n, n) are read in one launch
# whose grid.y is the task (2.15 GB in f32 at T = 64, n = 2048); each task
# has its own finish counter and partials, so the fixed order, and the
# run-to-run f32 result, hold task by task.
# ---------------------------------------------------------------------------

def rbf_bwd_reductions_plain(Ainv, Kt, alpha, mask, X):
    """(S1, rw, WX, diagsum) with W = (Ainv - a a^T) . (m m^T) . Kt; with a
    task axis on Ainv, Kt and alpha, one of each a task."""
    W = ((Ainv - alpha[..., :, None] * alpha[..., None, :])
         * (mask[:, None] * mask[None, :]) * Kt)
    return (W.sum(dim=(-2, -1)), W.sum(dim=-1), W @ X,
            (torch.diagonal(Ainv, dim1=-2, dim2=-1) * mask * mask).sum(-1))


_COUNTERS = {}


def _block_counters(device, stream, tasks):
    """K3's zeroed finish counters, one a task, for launches on ``stream``:
    launches on one stream run in order, and each leaves its counters at
    zero again."""
    key = (device, stream.value)
    if key not in _COUNTERS or len(_COUNTERS[key]) < tasks:
        _COUNTERS[key] = torch.zeros(tasks, dtype=torch.int32, device=device)
    return _COUNTERS[key]


def rbf_bwd_reductions(Ainv, Kt, alpha, mask, X):
    """K3 wrapper: one pass over Ainv and Kt giving
    (S1 scalar, rw (n,), WX (n, d), diagsum scalar); with Ainv, Kt
    (T, n, n) and alpha (T, n), the same T times in one launch, as
    (S1 (T,), rw (T, n), WX (T, n, d), diagsum (T,)), mask (n,) and X
    (n, d) shared.

    On CUDA in float32, each output agrees with the float64
    :func:`rbf_bwd_reductions_plain` of the same inputs to 1e-4 of its
    scale, the largest row sum of |W| (an n-term f32 sum in another
    order); in float64 to 1e-12 of it."""
    note_call("rbf_bwd_reductions", Ainv, *X.shape)
    if not Ainv.is_cuda:
        return rbf_bwd_reductions_plain(Ainv, Kt, alpha, mask, X)
    tasks = _tasks("rbf_bwd_reductions", Ainv, 2)
    lead = Ainv.shape[:-2]
    n, d = X.shape
    dtype = _check_cuda("rbf_bwd_reductions", (Ainv, Kt, alpha, mask, X), d)
    if Ainv.shape != lead + (n, n) or Kt.shape != lead + (n, n) \
            or alpha.shape != lead + (n,) or mask.shape != (n,):
        raise ValueError("rbf_bwd_reductions: expected Ainv, Kt %s, alpha %s "
                         "and mask (%d,)" % (lead + (n, n), lead + (n,), n))
    dev = X.device
    rw = torch.empty(lead + (n,), dtype=dtype, device=dev)
    wx = torch.empty(lead + (n, d), dtype=dtype, device=dev)
    partials = torch.empty((2 * max(n, 1) * tasks,), dtype=dtype, device=dev)
    sums = torch.empty((2 * tasks,), dtype=dtype, device=dev)
    stream = _stream(X)
    _launch("gpim_rbf_bwd_reductions", dtype, _ptr(Ainv), _ptr(Kt),
            _ptr(alpha), _ptr(mask), _ptr(X), _ptr(rw), _ptr(wx),
            _ptr(partials), _ptr(_block_counters(dev, stream, tasks)),
            _ptr(sums), n, d, tasks, stream)
    rbf_bwd_reductions.launches += 1
    return (sums[:tasks].reshape(lead), rw, wx,
            sums[tasks:].reshape(lead))


rbf_bwd_reductions.launches = 0


# ---------------------------------------------------------------------------
# K4: the interpolation adjoint W^T v of the off-lattice SKI operator
#
# No Pallas counterpart: it replaces the index_add_ of the port's
# ops/ski.py, whose counterpart in gpim_tpu is the sorted scatter-add of
# ski_mvm (gpim_tpu/ops/ski.py:275, an XLA scatter with
# indices_are_sorted). index_add_ on CUDA adds float atomics in no fixed
# order, so two runs of one training differ. Here the (point, corner)
# entries are sorted by their grid cell once a data set, stably (a CSR
# layout, :func:`interp_layout`), and one thread sums one (cell, column)
# output over its cell's entries in increasing entry order: no atomics, one
# answer in every run, and the order in which index_add_ on the CPU adds.
# Bound by bytes: it reads the block v, the sorted weights, the entries'
# points and the row pointers once and writes the (G, b) block, ~45 MB at
# the 1M off-lattice cube (n = 314624, G = 70^3, b = 9), against 2
# operations an entry and column. The threads are (cell, column) pairs,
# the column fastest: the b threads of a cell read each entry's weight and
# point once between them (a broadcast), a cell's output row is one
# contiguous store, and neighbouring cells read neighbouring points (the
# points are sorted by their lower corner). Products and sums are rounded
# one by one (no FMA), as the plain version rounds them. Not
# differentiable: the SKI loss's backward differentiates the operator in
# its factors and noise, never in v, and the wrapper raises on a v that
# requires a gradient rather than drop it. It is also the gradient of the
# operator's gather W (ops/ski.py _InterpApply), whose index_select would
# otherwise backpropagate through index_add_.
# ---------------------------------------------------------------------------

class InterpLayout(NamedTuple):
    """The interpolation weights W (n points, G cells) in CSR form by
    cell: cell g's entries are ``rowptr[g]`` to ``rowptr[g + 1] - 1``,
    entry k the weight ``wgt[k]`` of point ``src[k]``, in increasing
    (point, corner) order within each cell."""
    rowptr: torch.Tensor     # (G + 1,) int32
    src: torch.Tensor        # (n 2^d,) int32
    wgt: torch.Tensor        # (n 2^d,) the weights, in entry order
    n: int
    G: int


def interp_layout(idx, wgt, G):
    """:class:`InterpLayout` of the corner indices and weights ``idx``,
    ``wgt`` (n, 2^d) of ``ski.build_interp`` on a grid of ``G`` cells, on
    their device: ``perm``, the stable argsort of ``idx``'s flat entries,
    gives each entry's point (``perm`` // 2^d) and weight; the row pointers
    come from a count of the entries a cell. Built once a data set; reading
    the count's length waits for the device once."""
    n, S = idx.shape
    if n * S >= 2 ** 31:
        raise ValueError("interp_layout: %d entries do not fit int32"
                         % (n * S))
    flat = idx.reshape(-1).long()
    perm = torch.argsort(flat, stable=True)
    counts = torch.bincount(flat, minlength=G)
    if counts.shape[0] != G:
        raise ValueError("interp_layout: a corner index is >= G = %d" % G)
    rowptr = torch.zeros(G + 1, dtype=torch.int32, device=idx.device)
    rowptr[1:] = counts.cumsum(0)
    src = torch.div(perm, S, rounding_mode="floor").to(torch.int32)
    return InterpLayout(rowptr, src, wgt.reshape(-1)[perm].contiguous(),
                        n, G)


def interp_adjoint_plain(layout, v):
    """W^T v as a (G, b) block for the batch-first block ``v`` (b, n):
    ``index_add_`` of each entry's weighted row onto its cell, in entry
    order (on the CPU index_add_ adds one index after another, so each
    cell's sum runs in the kernel's order)."""
    G = layout.G
    cell = torch.repeat_interleave(
        torch.arange(G, device=v.device), layout.rowptr.diff().long(),
        output_size=layout.src.shape[0])
    rows = v.mT.index_select(0, layout.src.long())
    return v.new_zeros((G, v.shape[0])).index_add_(
        0, cell, layout.wgt[:, None] * rows)


def interp_adjoint(layout, v):
    """K4 wrapper: W^T v, (b, n) -> (G, b), for the
    :class:`InterpLayout` ``layout`` of W. On CUDA every output is one
    thread's sum in a fixed order, so the result is the same in every run;
    float32 agrees with the float64 :func:`interp_adjoint_plain` to about
    1e-7 of the cell's sum of |w v| (a short f32 sum, each term rounded),
    float64 to round-off."""
    if v.requires_grad and torch.is_grad_enabled():
        raise ValueError("interp_adjoint: v requires a gradient, which K4 "
                         "does not give; detach it")
    if v.dim() != 2 or v.shape[1] != layout.n:
        raise ValueError("interp_adjoint: v must be (b, %d), got %s"
                         % (layout.n, tuple(v.shape)))
    if not v.is_cuda:
        return interp_adjoint_plain(layout, v)
    dtype = _check_cuda("interp_adjoint", (v, layout.wgt))
    for t in (layout.rowptr, layout.src):
        if t.device != v.device or t.dtype != torch.int32 \
                or not t.is_contiguous():
            raise ValueError("interp_adjoint: the layout's indices must be "
                             "contiguous int32 on %s" % v.device)
    b = v.shape[0]
    out = torch.empty((layout.G, b), dtype=dtype, device=v.device)
    _launch("gpim_interp_adjoint", dtype, _ptr(layout.rowptr),
            _ptr(layout.src), _ptr(layout.wgt), _ptr(v), _ptr(out),
            layout.G, layout.n, b, _stream(v))
    interp_adjoint.launches += 1
    return out


interp_adjoint.launches = 0
