#!/usr/bin/env python3
"""
Design measurements of kernel K1 (pairwise squared distances) on one CUDA
card, float32.

    python3 tools/k1_design.py variants
    python3 tools/k1_design.py compare TREE [TREE ...]

``variants`` builds a sweep of K1's 16-byte-store design (rows per block,
warps per block, plain or streaming stores) from a source it writes into
``build/k1_design/``, checks each against the plain version, and times it
at the flagship's predict shape (4096 x 6144, d = 2), the VFE's Kmn
(1027 x 30848, d = 3) and a 6144 x 6144 square: CUDA events around a warm
loop of 50 launches, two rounds, beside the shape's bound (bytes over
3.35 TB/s).

``compare`` times the kernel wrappers (``gpim_tpu_torch.ops.gram_kernels``)
of each tree given (a checkout's root; each in its own process, in the
order given): K1 (``sqdist``) at the flagship and VFE shapes, three replays
of a CUDA graph of 50 calls; K2 (``masked_system``, RBF) and K3
(``rbf_bwd_reductions``) at the flagship's n = 6144, d = 2, three warm
loops of 50 launches (as ``chip_smoke.py`` times them); CUDA events, all
unbatched calls. Unpack a parent commit with ``git archive`` into a
gitignored directory and give it twice, around this tree, to compare the
two on one card.
"""

import ctypes
import itertools
import json
import os
import subprocess
import sys
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PEAK_BYTES_PER_S = 3.35e12
REPS = 50

ROWS = (32, 64, 128, 256)
WARPS = (4, 8)
STREAM = (False, True)
DS = (2, 3)

_KERNEL = r'''
#include <cuda_runtime.h>
#include <cstdint>
template <int D, int ROWS, int WARPS, bool STREAM>
__global__ void __launch_bounds__(WARPS * 32)
k1v(const float* __restrict__ A, const float* __restrict__ B,
    float* __restrict__ out, int64_t n, int64_t m) {
  __shared__ float a_s[ROWS][D];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t row0 = static_cast<int64_t>(blockIdx.y) * ROWS;
  const int64_t c0 = (static_cast<int64_t>(blockIdx.x) * 32 + lane) * 4;
  for (int e = threadIdx.x; e < ROWS * D; e += WARPS * 32) {
    const int64_t g = row0 + e / D;
    a_s[e / D][e % D] = g < n ? A[g * D + e % D] : 0.f;
  }
  float b[4][D];
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int k = 0; k < D; ++k) b[q][k] = c0 + q < m ? B[(c0 + q) * D + k] : 0.f;
  __syncthreads();
  if (c0 >= m) return;
#pragma unroll 4
  for (int i = 0; i < ROWS / WARPS; ++i) {
    const int64_t row = row0 + warp + i * WARPS;
    if (row >= n) break;
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < D; ++k) {
        const float df = a_s[row - row0][k] - b[e][k];
        acc += df * df;
      }
      v[e] = acc;
    }
    float4* p = reinterpret_cast<float4*>(out + row * m + c0);
    const float4 q = make_float4(v[0], v[1], v[2], v[3]);
    if (STREAM) __stcs(p, q); else *p = q;
  }
}
template <int D, int ROWS, int WARPS, bool STREAM>
int launch(const float* A, const float* B, float* out, int64_t n, int64_t m,
           cudaStream_t s) {
  const dim3 grid(static_cast<unsigned>((m / 4 + 31) / 32),
                  static_cast<unsigned>((n + ROWS - 1) / ROWS));
  k1v<D, ROWS, WARPS, STREAM><<<grid, WARPS * 32, 0, s>>>(A, B, out, n, m);
  return static_cast<int>(cudaGetLastError());
}
extern "C" int k1v_launch(int i, const float* A, const float* B, float* out,
                          int64_t n, int64_t m, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m % 4 != 0) return 1;
  switch (i) {
@CASES@
  }
  return 2;
}
'''


def _variants():
    """(rows, warps, stream, d) of every instantiation, in case order."""
    return list(itertools.product(ROWS, WARPS, STREAM, DS))


def _write_source(path):
    cases = "\n".join(
        "    case %d: return launch<%d, %d, %d, %s>(A, B, out, n, m, s);"
        % (i, d, rows, warps, "true" if stream else "false")
        for i, (rows, warps, stream, d) in enumerate(_variants()))
    with open(path, "w") as f:
        f.write(_KERNEL.replace("@CASES@", cases))


def _time_loop(launch, reps=REPS):
    import torch
    for _ in range(3):
        launch()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        launch()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def variants():
    import torch
    sys.path.insert(0, _ROOT)
    from gpim_tpu_torch.ops import _build
    from gpim_tpu_torch.ops import gram_kernels as gk
    out_dir = os.path.join(_ROOT, "build", "k1_design")
    os.makedirs(out_dir, exist_ok=True)
    src = os.path.join(out_dir, "k1_variants.cu")
    so = os.path.join(out_dir, "k1_variants.so")
    _write_source(src)
    t0 = time.time()
    subprocess.run([_build.find_nvcc(), "-gencode",
                    "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                    "-shared", "-Xcompiler", "-fPIC", "-o", so, src],
                   check=True)
    print("nvcc %.1f s" % (time.time() - t0), flush=True)
    lib = ctypes.CDLL(so)
    P, I64, INT = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.k1v_launch.argtypes = [INT, P, P, P, I64, I64, P]
    stream = P(torch.cuda.current_stream().cuda_stream)
    table = _variants()
    for label, n, m, d in (("flagship", 4096, 6144, 2),
                           ("Kmn", 1027, 30848, 3),
                           ("square", 6144, 6144, 2)):
        g = torch.Generator().manual_seed(0)
        A = (torch.rand(n, d, generator=g) * 30).cuda()
        B = (torch.rand(m, d, generator=g) * 30).cuda()
        ref = gk.sqdist_plain(A.double(), B.double())
        out = torch.empty(n, m, device="cuda")
        bound = ((n + m) * d + n * m) * 4 / PEAK_BYTES_PER_S * 1e3
        times = {}
        for _ in range(2):
            for i, (rows, warps, streaming, vd) in enumerate(table):
                if vd != d:
                    continue
                args = (P(A.data_ptr()), P(B.data_ptr()),
                        P(out.data_ptr()), n, m, stream)
                out.fill_(float("nan"))
                if lib.k1v_launch(i, *args) != 0:
                    raise RuntimeError("variant %d did not launch" % i)
                torch.cuda.synchronize()
                err = ((out.double() - ref).abs().max()
                       / ref.abs().max()).item()
                if not err <= 1e-6:
                    raise AssertionError("variant %d: error %.3e" % (i, err))
                key = "rows %3d, warps %d, %s stores" % (
                    rows, warps, "streaming" if streaming else "plain")
                times.setdefault(key, []).append(
                    _time_loop(lambda: lib.k1v_launch(i, *args)))
        print("== %s %d x %d, d = %d: bound %.4f ms" % (label, n, m, d, bound))
        for key, ts in sorted(times.items(), key=lambda kv: min(kv[1])):
            print("  %-36s %s ms  %.0f%% of bound"
                  % (key, " ".join("%.4f" % t for t in ts),
                     100 * bound / min(ts)), flush=True)
        del A, B, out, ref
        torch.cuda.empty_cache()


def _loop_ms(fn):
    """Device ms a call: CUDA events around a warm loop of REPS calls."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPS):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / REPS


def time_tree(root):
    """Kernel wrapper times of the tree at ``root``; prints one JSON line."""
    import torch
    sys.path.insert(0, root)
    from gpim_tpu_torch.ops import _build
    from gpim_tpu_torch.ops import gram_kernels as gk
    if not os.path.realpath(gk.__file__).startswith(os.path.realpath(root)):
        raise RuntimeError("imported %s, not the tree's" % gk.__file__)
    _build.build()
    out = {}
    for label, n, m, d in (("flagship", 4096, 6144, 2),
                           ("Kmn", 1027, 30848, 3), ("Kmm", 1027, 1027, 3),
                           ("Ks", 4096, 1027, 3)):
        g = torch.Generator().manual_seed(0)
        A = (torch.rand(n, d, generator=g) * 30).cuda()
        B = (torch.rand(m, d, generator=g) * 30).cuda()
        ref = gk.sqdist_plain(A.double(), B.double())
        err = ((gk.sqdist(A, B).double() - ref).abs().max()
               / ref.abs().max()).item()
        for _ in range(3):
            gk.sqdist(A, B)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(REPS):
                gk.sqdist(A, B)
        graph.replay()
        torch.cuda.synchronize()
        ts = []
        for _ in range(3):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            graph.replay()
            end.record()
            end.synchronize()
            ts.append(start.elapsed_time(end) / REPS)
        out[label] = {"ms": ts, "normalized_err": err}
        del graph
    n, d = 6144, 2
    g = torch.Generator().manual_seed(1)
    Xs = (torch.rand(n, d, generator=g) * 30).cuda()
    mask = (torch.rand(n, generator=g) > 0.02).float().cuda()
    v, nj = torch.tensor(0.08).cuda(), torch.tensor(3e-3).cuda()
    Ainv, Kt = (torch.rand(n, n, generator=g).cuda() for _ in range(2))
    alpha = torch.rand(n, generator=g).cuda()
    k2 = [_loop_ms(lambda: gk.masked_system(Xs, mask, v, nj, kernel="RBF"))
          for _ in range(3)]
    k3 = [_loop_ms(lambda: gk.rbf_bwd_reductions(Ainv, Kt, alpha, mask, Xs))
          for _ in range(3)]
    print(json.dumps({"tree": root, "k1": out, "k2_ms": k2, "k3_ms": k3}),
          flush=True)


def main(argv):
    if argv[:1] == ["variants"]:
        variants()
    elif argv[:1] == ["compare"] and len(argv) > 1:
        for tree in argv[1:]:
            subprocess.run([sys.executable, os.path.abspath(__file__),
                            "_tree", os.path.abspath(tree)], check=True)
    elif argv[:1] == ["_tree"] and len(argv) == 2:
        time_tree(argv[1])
    else:
        sys.exit(__doc__)


if __name__ == "__main__":
    main(sys.argv[1:])
