"""
The exact-GP path's three kernels: CUDA for Hopper, each beside its plain
PyTorch version. Counterpart of ``gpim_tpu/ops/pallas_gram.py``.

Dispatch rule, the same for every wrapper: a CPU tensor takes the plain
version; a CUDA tensor launches the kernel (``csrc/gram_kernels.cu``, built
at first use by :mod:`gpim_tpu_torch.ops._build`) or raises. There is no
fallback from CUDA to the plain version. The kernels are templated on
float32 and float64, so every CUDA call goes through a kernel whatever the
precision.

Each wrapper counts its launches in a plain int attribute
(``sqdist.launches``, ``masked_system.launches``,
``rbf_bwd_reductions.launches``), incremented where the kernel is launched
and nowhere else, so a run can show that its main path went through the
kernels. Wrappers check device, dtype, shape and contiguity, allocate their
outputs with ``torch.empty``, launch on the current stream and never
synchronise.
"""

import ctypes
import math

import torch

from gpim_tpu_torch.ops import _build

__all__ = [
    "MAX_D", "KERNEL_IDS", "min_traffic",
    "sqdist", "sqdist_plain",
    "masked_system", "masked_system_plain",
    "rbf_bwd_reductions", "rbf_bwd_reductions_plain",
]

MAX_D = 8                    # feature count the CUDA kernels take
KERNEL_IDS = {"RBF": 0, "Matern52": 1, "RationalQuadratic": 2}
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
# grid.y limits: K1 tiles have 32 rows, K2 tiles 64 (csrc/gram_kernels.cu)
_MAX_SQDIST_ROWS = 65535 * 32
_MAX_SYSTEM_ROWS = 65535 * 64
_SQRT5 = math.sqrt(5.0)


def min_traffic(name, n, d, m=None, itemsize=4):
    """(bytes read, bytes written, operations) of one call of kernel
    ``name`` at these shapes: each input read once and each output written
    once, whatever the kernel reads again; operations per element as the
    RBF form of its arithmetic does them, an exp counted as one. ``m`` is
    K1's column count."""
    if name == "sqdist":
        return (n * d + m * d) * itemsize, n * m * itemsize, 3 * d * n * m
    if name == "masked_system":
        # Xs, mask, 3 scalars -> Kt, A
        return ((n * d + n + 3) * itemsize, 2 * n * n * itemsize,
                (3 * d + 6) * n * n)
    if name == "rbf_bwd_reductions":
        # Ainv, Kt, alpha, mask, X -> S1, rw, WX, diagsum
        return ((2 * n * n + 2 * n + n * d) * itemsize,
                (2 + n + n * d) * itemsize, (2 * d + 6) * n * n)
    raise ValueError(name)


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
# it writes (d <= 8 flops per value): at the flagship's (4096, 6144) f32
# cross-Gram, 100 MB. The kernel writes every output once, a warp storing
# 32 neighbouring columns of one row, with the tile's A rows in shared
# memory and each thread's B point in registers. Direct per-feature
# differences make coincident points exactly 0, with no norm-trick snap.
# The backward is the closed form of pallas_gram.py:110-119 in torch.matmul
# (the JAX backward is plain XLA too).
# ---------------------------------------------------------------------------

def sqdist_plain(A, B):
    """(n, d) x (m, d) -> (n, m) squared distances by per-feature
    differences, summed in feature order (the kernel's order)."""
    acc = torch.zeros((A.shape[0], B.shape[0]), dtype=A.dtype,
                      device=A.device)
    for k in range(A.shape[1]):
        diff = A[:, k, None] - B[None, :, k]
        acc = acc + diff * diff
    return acc


def _sqdist_forward(A, B):
    if not A.is_cuda:
        return sqdist_plain(A, B)
    n, d = A.shape
    m = B.shape[0]
    dtype = _check_cuda("sqdist", (A, B), d)
    if B.shape[1] != d:
        raise ValueError("sqdist: feature counts differ, %d and %d"
                         % (d, B.shape[1]))
    if n > _MAX_SQDIST_ROWS:
        raise ValueError("sqdist: at most %d rows, got %d"
                         % (_MAX_SQDIST_ROWS, n))
    out = torch.empty((n, m), dtype=dtype, device=A.device)
    _launch("gpim_sqdist", dtype, _ptr(A), _ptr(B), _ptr(out), n, m, d,
            _stream(A))
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
            dA = 2.0 * (A * g.sum(dim=1, keepdim=True) - g @ B)
        if ctx.needs_input_grad[1]:
            dB = 2.0 * (B * g.sum(dim=0)[:, None] - g.T @ A)
        return dA, dB


def sqdist(A, B):
    """K1 wrapper: pairwise squared Euclidean distances, (n, d) x (m, d) ->
    (n, m), differentiable in both arguments. On CUDA, float32 agrees with
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
# gradient.
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
    A = (m m^T) . (Kt + (noise + jitter) I) + (I - diag m)."""
    n = Xs.shape[0]
    K = _kernel_plain(kernel, sqdist_plain(Xs, Xs), variance, alpha)
    eye = torch.eye(n, dtype=Xs.dtype, device=Xs.device)
    K = torch.where(eye.bool(), variance, K)
    mm = mask[:, None] * mask[None, :]
    A = mm * (K + noise_plus_jitter * eye) + (1.0 - mask)[:, None] * eye
    return K, A


def masked_system(Xs, mask, variance, noise_plus_jitter, alpha=None, *,
                  kernel):
    """K2 wrapper: (Kt, A) from scaled inputs ``Xs`` (n, d) and the 0/1
    padding ``mask`` (n,) in one pass. ``alpha`` only for
    RationalQuadratic. On CUDA, float32 agrees with
    :func:`masked_system_plain` to about 1e-6 of v (one exp of a distance
    that differs by a few ulp)."""
    if not Xs.is_cuda:
        return masked_system_plain(Xs, mask, variance, noise_plus_jitter,
                                   alpha, kernel=kernel)
    if kernel not in KERNEL_IDS:
        raise NotImplementedError(kernel)
    n, d = Xs.shape
    dtype = _check_cuda("masked_system", (Xs, mask), d)
    if mask.shape != (n,):
        raise ValueError("masked_system: mask must be (%d,), got %s"
                         % (n, tuple(mask.shape)))
    if n > _MAX_SYSTEM_ROWS:
        raise ValueError("masked_system: at most %d rows, got %d"
                         % (_MAX_SYSTEM_ROWS, n))
    if kernel == "RationalQuadratic" and alpha is None:
        raise ValueError("masked_system: RationalQuadratic needs alpha")
    # device scalars of the kernel's dtype; a 0-d CUDA tensor of that dtype
    # passes through as it is
    v, nj, a = (None if x is None else
                torch.as_tensor(x, dtype=dtype, device=Xs.device).reshape(())
                for x in (variance, noise_plus_jitter, alpha))
    Kt = torch.empty((n, n), dtype=dtype, device=Xs.device)
    A = torch.empty((n, n), dtype=dtype, device=Xs.device)
    _launch("gpim_masked_system", dtype, _ptr(Xs), _ptr(mask), _ptr(v),
            _ptr(nj), None if a is None else _ptr(a), _ptr(Kt), _ptr(A), n,
            d, KERNEL_IDS[kernel], _stream(Xs))
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
# broadcast.
# ---------------------------------------------------------------------------

def rbf_bwd_reductions_plain(Ainv, Kt, alpha, mask, X):
    """(S1, rw, WX, diagsum) with W = (Ainv - a a^T) . (m m^T) . Kt."""
    W = ((Ainv - alpha[:, None] * alpha[None, :])
         * (mask[:, None] * mask[None, :]) * Kt)
    return (W.sum(), W.sum(dim=1), W @ X,
            (torch.diagonal(Ainv) * mask * mask).sum())


_COUNTERS = {}


def _block_counter(device, stream):
    """K3's zeroed finish counter for launches on ``stream``: launches on
    one stream run in order, and each leaves the counter at zero again."""
    key = (device, stream.value)
    if key not in _COUNTERS:
        _COUNTERS[key] = torch.zeros(1, dtype=torch.int32, device=device)
    return _COUNTERS[key]


def rbf_bwd_reductions(Ainv, Kt, alpha, mask, X):
    """K3 wrapper: one pass over Ainv and Kt giving
    (S1 scalar, rw (n,), WX (n, d), diagsum scalar).

    On CUDA in float32, each output agrees with the float64
    :func:`rbf_bwd_reductions_plain` of the same inputs to 1e-4 of its
    scale, the largest row sum of |W| (an n-term f32 sum in another
    order); in float64 to 1e-12 of it."""
    if not Ainv.is_cuda:
        return rbf_bwd_reductions_plain(Ainv, Kt, alpha, mask, X)
    n, d = X.shape
    dtype = _check_cuda("rbf_bwd_reductions", (Ainv, Kt, alpha, mask, X), d)
    if Ainv.shape != (n, n) or Kt.shape != (n, n) \
            or alpha.shape != (n,) or mask.shape != (n,):
        raise ValueError("rbf_bwd_reductions: expected Ainv, Kt (%d, %d) and "
                         "alpha, mask (%d,)" % (n, n, n))
    dev = X.device
    rw = torch.empty((n,), dtype=dtype, device=dev)
    wx = torch.empty((n, d), dtype=dtype, device=dev)
    partials = torch.empty((2 * max(n, 1),), dtype=dtype, device=dev)
    sums = torch.empty((2,), dtype=dtype, device=dev)
    stream = _stream(X)
    _launch("gpim_rbf_bwd_reductions", dtype, _ptr(Ainv), _ptr(Kt),
            _ptr(alpha), _ptr(mask), _ptr(X), _ptr(rw), _ptr(wx),
            _ptr(partials), _ptr(_block_counter(dev, stream)), _ptr(sums), n,
            d, stream)
    rbf_bwd_reductions.launches += 1
    return sums[0], rw, wx, sums[1]


rbf_bwd_reductions.launches = 0
