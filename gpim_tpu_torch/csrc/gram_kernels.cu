// Hand-written CUDA kernels of the exact-GP and sparse (VFE) training and
// prediction paths, for Hopper (sm_90a). Counterpart:
// gpim_tpu/ops/pallas_gram.py.
//
// K1 sqdist          (n, d) x (m, d) -> (n, m) squared distances
// K2 masked_system   Kt and the masked training system A, in one pass
// K3 rbf_bwd         the reductions of the closed-form RBF MLL backward
// K4 interp_adjoint  W^T v of the off-lattice SKI operator, a CSR segmented
//                    sum in a fixed order (no Pallas counterpart)
//
// K1-K3 take a leading task axis (T independent problems in one
// launch, the batch that gpim_tpu's vmap over output channels gives its
// Pallas kernels) on its own grid axis: blockIdx.z for K1 and K2,
// blockIdx.y for K3. Per-task operands advance by the task's stride; the
// padding mask (K2, K3) and K3's unscaled X are shared by every task. An
// unbatched call is T = 1. Offsets are int64: at T = 64 and n = 2048 one
// (T, n, n) tensor holds 2.7e8 elements.
//
// Every kernel is an elementwise-plus-reduction pass with d <= 8 features
// (K4 a sum of a few weighted rows a cell), so none has a tensor-core
// product to win: K1 and K2 are bound by the bytes they write, K3 and K4 by
// the bytes they read. The designs keep those accesses
// coalesced and touch every output or input element exactly once.
//
// Plain C interface (loaded with ctypes), one entry point per kernel and
// dtype. Each entry point launches on the caller's stream, never
// synchronises, allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxD = 8;         // largest feature count the kernels take
constexpr int kDistWarps = 8;    // K1 block: 8 warps ...
constexpr int kDistRows = 32;    // ... over a tile of 32 rows x 32 V columns
constexpr int kSysWarps = 8;     // K2 block: 8 warps ...
constexpr int kSysRows = 64;     // ... over a tile of 64 rows x 32 V columns
constexpr int kBwdWarps = 4;     // K3 block: 4 warps ...
constexpr int kBwdRowsPerWarp = 2;  // ... of 2 rows each
constexpr int kBwdRows = kBwdWarps * kBwdRowsPerWarp;

// Elements in one 16-byte access: 4 floats or 2 doubles.
template <typename T>
constexpr int kVec = 16 / static_cast<int>(sizeof(T));

constexpr int kRBF = 0;
constexpr int kMatern52 = 1;
constexpr int kRationalQuadratic = 2;

__device__ __forceinline__ float dexp(float x) { return expf(x); }
__device__ __forceinline__ double dexp(double x) { return exp(x); }
__device__ __forceinline__ float dsqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double dsqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float dlog1p(float x) { return log1pf(x); }
__device__ __forceinline__ double dlog1p(double x) { return log1p(x); }

inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// V consecutive elements: one 16-byte access when V == kVec<T> (the caller
// guarantees the address is 16-byte aligned), else one scalar access.
template <typename T, int V>
__device__ __forceinline__ void load_vec(const T* __restrict__ p, T* x) {
  if constexpr (V == 1) {
    x[0] = p[0];
  } else if constexpr (sizeof(T) == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    x[0] = q.x;
    x[1] = q.y;
    x[2] = q.z;
    x[3] = q.w;
  } else {
    const double2 q = *reinterpret_cast<const double2*>(p);
    x[0] = q.x;
    x[1] = q.y;
  }
}

template <typename T, int V>
__device__ __forceinline__ void store_vec(T* __restrict__ p, const T* x) {
  if constexpr (V == 1) {
    p[0] = x[0];
  } else if constexpr (sizeof(T) == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  } else {
    *reinterpret_cast<double2*>(p) = make_double2(x[0], x[1]);
  }
}

// One 16-byte streaming (evict-first) store of kVec<T> elements, for an
// output that is written once and not read again by the same kernel.
template <typename T>
__device__ __forceinline__ void stream_vec(T* __restrict__ p, const T* x) {
  if constexpr (sizeof(T) == 4) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(x[0], x[1], x[2], x[3]));
  } else {
    __stcs(reinterpret_cast<double2*>(p), make_double2(x[0], x[1]));
  }
}

// Stage ROWS rows of a row-major (rows, d) matrix into shared memory, zero
// past the last row and past feature d.
template <int ROWS, typename T>
__device__ __forceinline__ void stage_rows(const T* __restrict__ src,
                                           int64_t rows, int d, int64_t row0,
                                           T (*dst)[kMaxD]) {
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  for (int e = tid; e < ROWS * kMaxD; e += blockDim.x * blockDim.y) {
    const int r = e / kMaxD;
    const int k = e % kMaxD;
    const int64_t g = row0 + r;
    dst[r][k] = (g < rows && k < d) ? src[g * d + k] : T(0);
  }
}

// Features of one point into registers, zero past feature d.
template <typename T>
__device__ __forceinline__ void load_point(const T* __restrict__ src,
                                           int64_t row, int64_t rows, int d,
                                           T (&dst)[kMaxD]) {
#pragma unroll
  for (int k = 0; k < kMaxD; ++k) {
    dst[k] = (row < rows && k < d) ? src[row * d + k] : T(0);
  }
}

// Squared distance by direct per-feature differences, in feature order:
// (a - b)^2 is exactly 0 when a == b, so coincident points give exactly 0
// whether or not the compiler contracts the sum into FMAs.
template <typename T>
__device__ __forceinline__ T sq_dist(const T* a, const T (&b)[kMaxD], int d) {
  T acc = T(0);
#pragma unroll
  for (int k = 0; k < kMaxD; ++k) {
    if (k < d) {
      const T diff = a[k] - b[k];
      acc += diff * diff;
    }
  }
  return acc;
}

// ---------------------------------------------------------------------------
// K1: pairwise squared distances (pallas_gram.py _sqdist_kernel).
// Bound by the n m values it writes (100 MB for the flagship's 4096 x 6144
// f32 cross-Gram, 127 MB for the VFE's 1027 x 30848 Kmn), so the design
// serves the stores, as K2's does. A block of 8 warps owns a tile of 32
// rows x 32 V columns (V = 4 floats or 2 doubles); each thread keeps the
// points of its V columns in registers and writes one 16-byte vector per
// row, so a warp stores 512 contiguous bytes of a row per instruction. The
// tile's 32 row points are staged in shared memory once and read as
// broadcasts. d is a template argument: the feature loop unrolls with no
// runtime test and every point stays in registers. Every store is a
// streaming (evict-first) store: the kernel never reads its output, and
// on an H100 streaming stores came closer to the bound than plain ones at
// every tile size tried (tools/k1_design.py variants).
//
// Rows start 16-byte aligned only when m is a multiple of V and the output
// is aligned. Otherwise (SHIFT) row r's 16-byte boundaries sit s_r columns
// past a multiple of V, with s_r in [0, V) known from r m and the output's
// offset. A thread then holds 2V - 1 column points, writes the V columns
// that start at its first one plus s_r as one 16-byte vector (a switch on
// s_r keeps every register index a constant), and the thread of column 0
// writes the row's first s_r columns as scalars; a vector that would cross
// the row's end is written as scalars. So every shape keeps the 16-byte
// body, and every output element is written exactly once.
//
// Distances are direct per-feature differences summed in feature order:
// coincident points give exactly 0.
//
// Task axis: blockIdx.z picks the task. A and the output are read as
// (T n) rows, so a tile's rows are the task's rows and its 16-byte shifts
// are counted from the whole output's start; B starts m d elements past
// the previous task's. Only one more index than an unbatched launch stays
// live in the row loop (kernel parameters cost no registers, offset
// pointers would).
// ---------------------------------------------------------------------------
template <typename T, int D>
__device__ __forceinline__ T sq_dist_d(const T (&a)[D], const T (&b)[D]) {
  T acc = T(0);
#pragma unroll
  for (int k = 0; k < D; ++k) {
    const T diff = a[k] - b[k];
    acc += diff * diff;
  }
  return acc;
}

// v[e] = |a - b[S + e]|^2 for the V columns that start S points in
template <int S, typename T, int V, int D, int P>
__device__ __forceinline__ void dists_from(const T (&a)[D],
                                           const T (&b)[P][D], T (&v)[V]) {
#pragma unroll
  for (int e = 0; e < V; ++e) v[e] = sq_dist_d<T, D>(a, b[S + e]);
}

template <typename T, int V, int D, int P>
__device__ __forceinline__ void dists_shifted(const T (&a)[D],
                                              const T (&b)[P][D], int s,
                                              T (&v)[V]) {
  if constexpr (P == V) {
    dists_from<0>(a, b, v);
  } else if constexpr (V == 4) {
    switch (s) {
      case 0: dists_from<0>(a, b, v); break;
      case 1: dists_from<1>(a, b, v); break;
      case 2: dists_from<2>(a, b, v); break;
      default: dists_from<3>(a, b, v); break;
    }
  } else {
    if (s == 0) {
      dists_from<0>(a, b, v);
    } else {
      dists_from<1>(a, b, v);
    }
  }
}

template <typename T, int V, int D, bool SHIFT>
__global__ void __launch_bounds__(kDistWarps * 32)
    sqdist_kernel(const T* __restrict__ A, const T* __restrict__ B,
                  T* __restrict__ out, int64_t n, int64_t m, int out_off) {
  constexpr int P = SHIFT ? 2 * V - 1 : V;  // column points a thread holds
  __shared__ T a_s[kDistRows][D];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t row0 = static_cast<int64_t>(blockIdx.y) * kDistRows;
  // the tile's first row among the (T n) rows of A and the output
  const int64_t grow0 = static_cast<int64_t>(blockIdx.z) * n + row0;
  const int rows = static_cast<int>(n - row0 < kDistRows ? n - row0
                                                         : kDistRows);
  const int64_t c0 = (static_cast<int64_t>(blockIdx.x) * 32 + lane) * V;
  for (int e = threadIdx.x; e < kDistRows * D; e += blockDim.x) {
    a_s[e / D][e % D] = e / D < rows ? A[(grow0 + e / D) * D + e % D] : T(0);
  }
  const T* __restrict__ Bt = B + static_cast<int64_t>(blockIdx.z) * m * D;
  T b[P][D];
#pragma unroll
  for (int q = 0; q < P; ++q) {
#pragma unroll
    for (int k = 0; k < D; ++k) {
      b[q][k] = c0 + q < m ? Bt[(c0 + q) * D + k] : T(0);
    }
  }
  __syncthreads();
  if (c0 >= m) return;
#pragma unroll
  for (int i = 0; i < kDistRows / kDistWarps; ++i) {
    const int r = warp + i * kDistWarps;
    if (r >= rows) break;
    const int64_t g = grow0 + r;  // the output row
    T a[D];
#pragma unroll
    for (int k = 0; k < D; ++k) a[k] = a_s[r][k];
    T* __restrict__ out_row = out + g * m;
    // warp-uniform: every lane of the warp works on this row
    const int s =
        SHIFT ? static_cast<int>((V - (out_off + g * m) % V) % V) : 0;
    T v[V];
    dists_shifted<T, V, D, P>(a, b, s, v);
    const int64_t col = c0 + s;
    if (col + V <= m) {
      stream_vec<T>(out_row + col, v);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) {
        if (col + e < m) __stcs(out_row + col + e, v[e]);
      }
    }
    if (SHIFT && c0 == 0) {  // the row's head, before its first boundary
#pragma unroll
      for (int e = 0; e < V - 1; ++e) {
        if (e < s && e < m) __stcs(out_row + e, sq_dist_d<T, D>(a, b[e]));
      }
    }
  }
}

// ---------------------------------------------------------------------------
// K2: fused masked training system (pallas_gram.py _system_kernel), writing
//   Kt = v k(s)  with the diagonal set to exactly v (global row == col),
//   A  = (m m^T) . (Kt + (noise + jitter) I) + (I - diag m).
// Bound by the 2 n^2 values it writes (302 MB at n = 6144 in f32), so the
// design serves the stores. A block of 8 warps owns a tile of 64 rows x
// 32 V columns; each thread owns V neighbouring columns, keeps their points
// and masks in registers, and writes one 16-byte vector of Kt and one of A
// per row (V = 4 floats or 2 doubles): a warp stores 512 contiguous bytes
// of a row per instruction. The tile's 64 row points and masks are staged
// in shared memory once, and the three scalars (v, noise + jitter, alpha,
// each a device scalar, so no Adam step copies one to the host) are read
// once per thread. The diagonal and the (I - diag m) term are decided per
// element. V = 1 is the scalar instantiation of the same code: the
// launcher takes it when n is not a multiple of kVec (rows then do not
// start 16-byte aligned) or an output is misaligned. Task axis: blockIdx.z
// picks the task, whose Xs, Kt and A start n d and n^2 elements past the
// previous task's, with its own v, noise + jitter and alpha; the mask is
// shared.
// ---------------------------------------------------------------------------
template <typename T, int KERNEL>
__device__ __forceinline__ T kernel_value(T s, T v, T alpha) {
  if (KERNEL == kRBF) {
    return v * dexp(T(-0.5) * s);
  } else if (KERNEL == kMatern52) {
    const T sqrt5 = T(2.2360679774997896964);
    const T r = dsqrt(s + T(1e-12));
    return v * (T(1) + sqrt5 * r + T(5.0 / 3.0) * r * r) * dexp(-sqrt5 * r);
  } else {
    return v * dexp(-alpha * dlog1p(s / (T(2) * alpha)));
  }
}

template <typename T, int KERNEL, int V>
__global__ void __launch_bounds__(kSysWarps * 32)
    masked_system_kernel(const T* __restrict__ Xs, const T* __restrict__ mask,
                         const T* __restrict__ variance,
                         const T* __restrict__ noise_jitter,
                         const T* __restrict__ rq_alpha, T* __restrict__ Kt,
                         T* __restrict__ A, int64_t n, int d) {
  __shared__ T x_s[kSysRows][kMaxD];
  __shared__ T m_s[kSysRows];
  const int64_t task = blockIdx.z;
  Xs += task * n * d;
  Kt += task * n * n;
  A += task * n * n;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t row0 = static_cast<int64_t>(blockIdx.y) * kSysRows;
  const int64_t col0 = (static_cast<int64_t>(blockIdx.x) * 32 + lane) * V;
  stage_rows<kSysRows>(Xs, n, d, row0, x_s);
  if (threadIdx.x < kSysRows) {
    const int64_t g = row0 + threadIdx.x;
    m_s[threadIdx.x] = g < n ? mask[g] : T(0);
  }
  T b[V][kMaxD];
  T m_col[V];
#pragma unroll
  for (int e = 0; e < V; ++e) {
    load_point(Xs, col0 + e, n, d, b[e]);
    m_col[e] = col0 + e < n ? mask[col0 + e] : T(0);
  }
  const T v = variance[task];
  const T nj = noise_jitter[task];
  const T alpha = KERNEL == kRationalQuadratic ? rq_alpha[task] : T(0);
  __syncthreads();
  // With V > 1, n % V == 0: a thread's V columns are all in range or none.
  if (col0 >= n) return;
#pragma unroll 2
  for (int r = warp; r < kSysRows; r += kSysWarps) {
    const int64_t row = row0 + r;
    if (row >= n) break;
    T a[kMaxD];
#pragma unroll
    for (int k = 0; k < kMaxD; ++k) a[k] = x_s[r][k];
    const T m_row = m_s[r];
    T kv[V];
    T av[V];
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const bool diag = row == col0 + e;
      const T k = diag ? v : kernel_value<T, KERNEL>(sq_dist(a, b[e], d), v,
                                                     alpha);
      kv[e] = k;
      av[e] = m_row * m_col[e] * (k + (diag ? nj : T(0))) +
              (diag ? T(1) - m_row : T(0));
    }
    const int64_t off = row * n + col0;
    store_vec<T, V>(Kt + off, kv);
    store_vec<T, V>(A + off, av);
  }
}

// ---------------------------------------------------------------------------
// K3: closed-form RBF backward reductions (pallas_gram.py _bwd_red_kernel).
// With W = (Ainv - a a^T) . (m m^T) . Kt:
//   rw_i = sum_j W_ij,  WX = W @ X,  dg_i = Ainv_ii m_i^2,
//   S1 = sum_i rw_i,    diagsum = sum_i dg_i.
// Bound by the 2 n^2 values it reads (Ainv and Kt, 302 MB at n = 6144 in
// f32), so the design serves the loads, and reads each element of both
// once (Ainv from a gemm is not bitwise symmetric, so no half is skipped).
// The TPU kernel carried row sums across its sequential column grid;
// Hopper blocks run in no order, so a warp owns whole rows. Each warp takes
// 2 rows at once: per step a lane loads one 16-byte vector of each of its
// rows of Ainv and Kt (V = 4 floats or 2 doubles; 2 KB a warp, from 4
// independent loads) and one of the column side (alpha, mask and the V
// points of X, d a template argument so those stay in registers), which
// the 2 rows then share. Row sums stay in registers and meet in shuffles.
// The scalar sums come from the same launch: each block writes the sums of
// its rows' rw and dg, and the last block to finish (a counter in device
// memory, after a __threadfence) adds the blocks' sums in block order and
// resets the counter. The counter is the only atomic: every sum has a
// fixed order, so the f32 result is the same in every run. V = 1 is the
// scalar instantiation, taken for n not a multiple of kVec or a misaligned
// operand. Task axis: blockIdx.y picks the task, whose Ainv, Kt, alpha, rw
// and wx start n^2, n^2, n, n and n d elements past the previous task's;
// mask and X are shared. Each task has its own finish counter and its own
// slice of 2 gridDim.x partials, and its last block adds them in block
// order, so the determinism holds per task. S1 of task t lands in sums[t],
// its diagsum in sums[T + t]. The row pointers carry the task's offset;
// the outputs' offsets are formed after the main loop, so that the loop
// holds one more pointer (the task's alpha) than an unbatched launch
// (kernel parameters cost no registers, offset pointers would).
// ---------------------------------------------------------------------------
template <typename T>
__device__ __forceinline__ T warp_sum(T x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    x += __shfl_down_sync(0xffffffffu, x, off);
  }
  return x;
}

template <typename T>
constexpr int kBwdMinBlocks = sizeof(T) == 4 ? 6 : 3;

template <typename T, int V, int D>
__global__ void __launch_bounds__(kBwdWarps * 32, kBwdMinBlocks<T>)
    rbf_bwd_kernel(const T* __restrict__ Ainv, const T* __restrict__ Kt,
                   const T* __restrict__ alpha, const T* __restrict__ mask,
                   const T* __restrict__ X, T* __restrict__ rw,
                   T* __restrict__ wx, T* __restrict__ partials,
                   unsigned int* __restrict__ counter, T* __restrict__ sums,
                   int64_t n) {
  constexpr int R = kBwdRowsPerWarp;
  __shared__ T rw_s[kBwdRows];
  __shared__ T dg_s[kBwdRows];
  __shared__ T sum_s[2][kBwdWarps];
  __shared__ bool last_s;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t row0 =
      static_cast<int64_t>(blockIdx.x) * kBwdRows + warp * R;
  const int64_t task_row0 = static_cast<int64_t>(blockIdx.y) * n;
  const T* __restrict__ alpha_t = alpha + task_row0;

  // The warp's rows; one past n (odd n) repeats row0 and is not written.
  // A row's offset in Ainv and Kt (the same layout) is one index: the loop
  // holds R indices where R pointers a matrix would cost twice the
  // registers.
  T a_row[R];
  T m_row[R];
  int64_t roff[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int64_t row = row0 + r < n ? row0 + r : row0;
    a_row[r] = row0 < n ? alpha_t[row] : T(0);
    m_row[r] = row0 < n ? mask[row] : T(0);
    roff[r] = (task_row0 + row) * n;
  }
  T acc_rw[R];
  T acc_wx[R][D];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    acc_rw[r] = T(0);
#pragma unroll
    for (int k = 0; k < D; ++k) acc_wx[r][k] = T(0);
  }
  if (row0 < n) {  // uniform across the warp
    const int64_t steps = n / V;  // n % V == 0 when V > 1
#pragma unroll 2
    for (int64_t c = lane; c < steps; c += 32) {
      const int64_t j0 = c * V;
      T al[V];
      T mk[V];
      T xv[V * D];
      T ai[R][V];
      T kk[R][V];
      load_vec<T, V>(alpha_t + j0, al);
      load_vec<T, V>(mask + j0, mk);
#pragma unroll
      for (int q = 0; q < D; ++q) load_vec<T, V>(X + j0 * D + q * V, xv + q * V);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        load_vec<T, V>(Ainv + roff[r] + j0, ai[r]);
        load_vec<T, V>(Kt + roff[r] + j0, kk[r]);
      }
#pragma unroll
      for (int e = 0; e < V; ++e) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const T w =
              (ai[r][e] - a_row[r] * al[e]) * (m_row[r] * mk[e]) * kk[r][e];
          acc_rw[r] += w;
#pragma unroll
          for (int k = 0; k < D; ++k) acc_wx[r][k] += w * xv[e * D + k];
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    acc_rw[r] = warp_sum(acc_rw[r]);
#pragma unroll
    for (int k = 0; k < D; ++k) acc_wx[r][k] = warp_sum(acc_wx[r][k]);
  }
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int64_t row = row0 + r;
      T rwv = T(0);
      T dgv = T(0);
      if (row < n) {
        const int64_t g = static_cast<int64_t>(blockIdx.y) * n + row;
        rw[g] = acc_rw[r];
#pragma unroll
        for (int k = 0; k < D; ++k) wx[g * D + k] = acc_wx[r][k];
        rwv = acc_rw[r];
        dgv = Ainv[roff[r] + row] * m_row[r] * m_row[r];
      }
      rw_s[warp * R + r] = rwv;
      dg_s[warp * R + r] = dgv;
    }
  }
  // this task's slice of the partials
  T* __restrict__ part =
      partials + 2 * static_cast<int64_t>(blockIdx.y) * gridDim.x;
  __syncthreads();
  if (threadIdx.x == 0) {
    T prw = T(0);
    T pdg = T(0);
    for (int i = 0; i < kBwdRows; ++i) {
      prw += rw_s[i];
      pdg += dg_s[i];
    }
    part[blockIdx.x] = prw;
    part[gridDim.x + blockIdx.x] = pdg;
    __threadfence();  // the sums reach L2 before the counter moves
    last_s = atomicAdd(counter + blockIdx.y, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last_s) return;

  // Last block: every block's sums are in L2; add them in block order.
  T sa = T(0);
  T sb = T(0);
  for (unsigned i = threadIdx.x; i < gridDim.x; i += blockDim.x) {
    sa += __ldcg(part + i);
    sb += __ldcg(part + gridDim.x + i);
  }
  sa = warp_sum(sa);
  sb = warp_sum(sb);
  if (lane == 0) {
    sum_s[0][warp] = sa;
    sum_s[1][warp] = sb;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    sa = T(0);
    sb = T(0);
    for (int w = 0; w < kBwdWarps; ++w) {
      sa += sum_s[0][w];
      sb += sum_s[1][w];
    }
    sums[blockIdx.y] = sa;
    sums[gridDim.y + blockIdx.y] = sb;
    counter[blockIdx.y] = 0u;  // ready for the next launch on this stream
  }
}

// ---------------------------------------------------------------------------
// Launchers
// ---------------------------------------------------------------------------
constexpr int kMaxTasks = 65535;  // grid.y / grid.z limit

template <typename T, int D>
void launch_sqdist_d(const T* A, const T* B, T* out, int64_t n, int64_t m,
                     int tasks, cudaStream_t s) {
  constexpr int V = kVec<T>;
  const int64_t groups = (m + V - 1) / V;  // V-column groups per row
  const dim3 grid(static_cast<unsigned>((groups + 31) / 32),
                  static_cast<unsigned>((n + kDistRows - 1) / kDistRows),
                  static_cast<unsigned>(tasks));
  const dim3 block(kDistWarps * 32);
  // the output's offset past a 16-byte boundary, in elements
  const int off = static_cast<int>(
      reinterpret_cast<uintptr_t>(out) / sizeof(T) % V);
  if (off == 0 && m % V == 0) {
    sqdist_kernel<T, V, D, false><<<grid, block, 0, s>>>(A, B, out, n, m, 0);
  } else {
    sqdist_kernel<T, V, D, true><<<grid, block, 0, s>>>(A, B, out, n, m, off);
  }
}

template <typename T>
int launch_sqdist(const T* A, const T* B, T* out, int64_t n, int64_t m, int d,
                  int tasks, void* stream) {
  if (tasks < 0 || tasks > kMaxTasks) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0 || m == 0 || tasks == 0) {
    return static_cast<int>(cudaGetLastError());
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define GPIM_SQDIST_CASE(D)                              \
  case D:                                                \
    launch_sqdist_d<T, D>(A, B, out, n, m, tasks, s);    \
    break;
  switch (d) {
    GPIM_SQDIST_CASE(1)
    GPIM_SQDIST_CASE(2)
    GPIM_SQDIST_CASE(3)
    GPIM_SQDIST_CASE(4)
    GPIM_SQDIST_CASE(5)
    GPIM_SQDIST_CASE(6)
    GPIM_SQDIST_CASE(7)
    GPIM_SQDIST_CASE(8)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef GPIM_SQDIST_CASE
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int V>
int launch_masked_system_v(const T* Xs, const T* mask, const T* variance,
                           const T* noise_jitter, const T* rq_alpha, T* Kt,
                           T* A, int64_t n, int d, int kernel, int tasks,
                           cudaStream_t s) {
  const dim3 grid(static_cast<unsigned>((n + 32 * V - 1) / (32 * V)),
                  static_cast<unsigned>((n + kSysRows - 1) / kSysRows),
                  static_cast<unsigned>(tasks));
  const dim3 block(kSysWarps * 32);
  switch (kernel) {
    case kRBF:
      masked_system_kernel<T, kRBF, V><<<grid, block, 0, s>>>(
          Xs, mask, variance, noise_jitter, rq_alpha, Kt, A, n, d);
      break;
    case kMatern52:
      masked_system_kernel<T, kMatern52, V><<<grid, block, 0, s>>>(
          Xs, mask, variance, noise_jitter, rq_alpha, Kt, A, n, d);
      break;
    case kRationalQuadratic:
      masked_system_kernel<T, kRationalQuadratic, V><<<grid, block, 0, s>>>(
          Xs, mask, variance, noise_jitter, rq_alpha, Kt, A, n, d);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_masked_system(const T* Xs, const T* mask, const T* variance,
                         const T* noise_jitter, const T* rq_alpha, T* Kt,
                         T* A, int64_t n, int d, int kernel, int tasks,
                         void* stream) {
  if ((kernel == kRationalQuadratic && rq_alpha == nullptr) || tasks < 0 ||
      tasks > kMaxTasks) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0 || tasks == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n % kVec<T> == 0 && aligned16(Kt) && aligned16(A)) {
    return launch_masked_system_v<T, kVec<T>>(Xs, mask, variance,
                                              noise_jitter, rq_alpha, Kt, A,
                                              n, d, kernel, tasks, s);
  }
  return launch_masked_system_v<T, 1>(Xs, mask, variance, noise_jitter,
                                      rq_alpha, Kt, A, n, d, kernel, tasks,
                                      s);
}

template <typename T, int V, int D>
void launch_rbf_bwd_vd(const T* Ainv, const T* Kt, const T* alpha,
                       const T* mask, const T* X, T* rw, T* wx, T* partials,
                       unsigned int* counter, T* sums, int64_t n, int tasks,
                       cudaStream_t s) {
  // at least one block a task, so n == 0 still writes zero sums
  const int64_t blocks = n > 0 ? (n + kBwdRows - 1) / kBwdRows : 1;
  const dim3 grid(static_cast<unsigned>(blocks),
                  static_cast<unsigned>(tasks));
  rbf_bwd_kernel<T, V, D><<<grid, kBwdWarps * 32, 0, s>>>(
      Ainv, Kt, alpha, mask, X, rw, wx, partials, counter, sums, n);
}

template <typename T, int V>
int launch_rbf_bwd_v(const T* Ainv, const T* Kt, const T* alpha,
                     const T* mask, const T* X, T* rw, T* wx, T* partials,
                     unsigned int* counter, T* sums, int64_t n, int d,
                     int tasks, cudaStream_t s) {
#define GPIM_BWD_CASE(D)                                                     \
  case D:                                                                    \
    launch_rbf_bwd_vd<T, V, D>(Ainv, Kt, alpha, mask, X, rw, wx, partials,   \
                               counter, sums, n, tasks, s);                  \
    break;
  switch (d) {
    GPIM_BWD_CASE(1)
    GPIM_BWD_CASE(2)
    GPIM_BWD_CASE(3)
    GPIM_BWD_CASE(4)
    GPIM_BWD_CASE(5)
    GPIM_BWD_CASE(6)
    GPIM_BWD_CASE(7)
    GPIM_BWD_CASE(8)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef GPIM_BWD_CASE
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_rbf_bwd(const T* Ainv, const T* Kt, const T* alpha, const T* mask,
                   const T* X, T* rw, T* wx, T* partials,
                   unsigned int* counter, T* sums, int64_t n, int d,
                   int tasks, void* stream) {
  if (tasks < 0 || tasks > kMaxTasks) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (tasks == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n % kVec<T> == 0 && aligned16(Ainv) && aligned16(Kt) &&
      aligned16(alpha) && aligned16(mask) && aligned16(X)) {
    return launch_rbf_bwd_v<T, kVec<T>>(Ainv, Kt, alpha, mask, X, rw, wx,
                                        partials, counter, sums, n, d, tasks,
                                        s);
  }
  return launch_rbf_bwd_v<T, 1>(Ainv, Kt, alpha, mask, X, rw, wx, partials,
                                counter, sums, n, d, tasks, s);
}


// ---------------------------------------------------------------------------
// K4: the interpolation adjoint W^T v (no Pallas counterpart; it replaces
// the index_add_ of the port's off-lattice operator, whose gpim_tpu
// counterpart is ski_mvm's sorted XLA scatter, gpim_tpu/ops/ski.py:275).
// index_add_'s float atomics add in no fixed order on the card, so two runs
// of one training differed. The (point, corner) entries come sorted by cell
// once a data set (CSR: rowptr, and each entry's point src and weight w),
// and one thread computes one output (cell g, column c) as
//
//   out[g, c] = sum_{k = rowptr[g]}^{rowptr[g + 1] - 1} w[k] v[c, src[k]]
//
// in increasing k: no atomics and one answer in every run. Each product and
// each sum is rounded on its own (__fmul_rn/__fadd_rn, no FMA), as the
// plain version's index_add_ rounds them. Bound by bytes (the block v, the
// entries, the row pointers, the (G, b) output: ~45 MB at the 1M cube, b =
// 9). Threads are (cell, column) pairs with the column fastest: the b
// threads of a cell read each entry's w and src together (one broadcast),
// a warp stores contiguous output, and neighbouring cells read neighbouring
// points, which come sorted by their lower corner. An empty cell writes 0.
// The same kernel is the gradient of the operator's gather W in the SKI
// loss's backward.
// ---------------------------------------------------------------------------
constexpr int kAdjThreads = 256;

__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}

template <typename T>
__global__ void __launch_bounds__(kAdjThreads)
    interp_adjoint_kernel(const int* __restrict__ rowptr,
                          const int* __restrict__ src,
                          const T* __restrict__ w, const T* __restrict__ v,
                          T* __restrict__ out, int64_t total, int64_t n,
                          int b) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kAdjThreads +
                    threadIdx.x;
  if (t >= total) return;
  const int64_t g = t / b;
  const T* __restrict__ vc = v + (t - g * b) * n;
  const int end = rowptr[g + 1];
  T acc = T(0);
  for (int k = rowptr[g]; k < end; ++k) {
    acc = add_rn(acc, mul_rn(w[k], vc[src[k]]));
  }
  out[t] = acc;
}

template <typename T>
int launch_interp_adjoint(const int* rowptr, const int* src, const T* w,
                          const T* v, T* out, int64_t G, int64_t n, int b,
                          void* stream) {
  if (G < 0 || n < 0 || b < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t total = G * b;
  if (total == 0) return static_cast<int>(cudaGetLastError());
  const int64_t blocks = (total + kAdjThreads - 1) / kAdjThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  interp_adjoint_kernel<T><<<static_cast<unsigned>(blocks), kAdjThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      rowptr, src, w, v, out, total, n, b);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* gpim_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Every entry point takes T = tasks problems laid out one after another
// (tasks = 1 for an unbatched call; at most 65535).
int gpim_sqdist_f32(const float* A, const float* B, float* out, int64_t n,
                    int64_t m, int d, int tasks, void* stream) {
  return launch_sqdist<float>(A, B, out, n, m, d, tasks, stream);
}

int gpim_sqdist_f64(const double* A, const double* B, double* out, int64_t n,
                    int64_t m, int d, int tasks, void* stream) {
  return launch_sqdist<double>(A, B, out, n, m, d, tasks, stream);
}

// variance, noise_jitter and rq_alpha hold one value a task; rq_alpha may be
// null unless kernel is RationalQuadratic.
int gpim_masked_system_f32(const float* Xs, const float* mask,
                           const float* variance, const float* noise_jitter,
                           const float* rq_alpha, float* Kt, float* A,
                           int64_t n, int d, int kernel, int tasks,
                           void* stream) {
  return launch_masked_system<float>(Xs, mask, variance, noise_jitter,
                                     rq_alpha, Kt, A, n, d, kernel, tasks,
                                     stream);
}

int gpim_masked_system_f64(const double* Xs, const double* mask,
                           const double* variance, const double* noise_jitter,
                           const double* rq_alpha, double* Kt, double* A,
                           int64_t n, int d, int kernel, int tasks,
                           void* stream) {
  return launch_masked_system<double>(Xs, mask, variance, noise_jitter,
                                      rq_alpha, Kt, A, n, d, kernel, tasks,
                                      stream);
}

// partials holds 2 values per block of each task (at least 2 max(n, 1) a
// task is enough); counter is one zeroed unsigned int per task, left at
// zero again; sums holds S1 of every task, then diagsum of every task.
int gpim_rbf_bwd_reductions_f32(const float* Ainv, const float* Kt,
                                const float* alpha, const float* mask,
                                const float* X, float* rw, float* wx,
                                float* partials, unsigned int* counter,
                                float* sums, int64_t n, int d, int tasks,
                                void* stream) {
  return launch_rbf_bwd<float>(Ainv, Kt, alpha, mask, X, rw, wx, partials,
                               counter, sums, n, d, tasks, stream);
}

int gpim_rbf_bwd_reductions_f64(const double* Ainv, const double* Kt,
                                const double* alpha, const double* mask,
                                const double* X, double* rw, double* wx,
                                double* partials, unsigned int* counter,
                                double* sums, int64_t n, int d, int tasks,
                                void* stream) {
  return launch_rbf_bwd<double>(Ainv, Kt, alpha, mask, X, rw, wx, partials,
                                counter, sums, n, d, tasks, stream);
}

// K4: out (G, b) = W^T v for the batch-first block v (b, n), W in CSR form
// by cell (rowptr (G + 1), and each entry's point src and weight w).
int gpim_interp_adjoint_f32(const int* rowptr, const int* src, const float* w,
                            const float* v, float* out, int64_t G, int64_t n,
                            int b, void* stream) {
  return launch_interp_adjoint<float>(rowptr, src, w, v, out, G, n, b,
                                      stream);
}

int gpim_interp_adjoint_f64(const int* rowptr, const int* src,
                            const double* w, const double* v, double* out,
                            int64_t G, int64_t n, int b, void* stream) {
  return launch_interp_adjoint<double>(rowptr, src, w, v, out, G, n, b,
                                       stream);
}

}  // extern "C"
