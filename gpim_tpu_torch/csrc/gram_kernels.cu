// Hand-written CUDA kernels of the exact-GP and sparse (VFE) training and
// prediction paths, for Hopper (sm_90a). Counterpart:
// gpim_tpu/ops/pallas_gram.py.
//
// K1 sqdist          (n, d) x (m, d) -> (n, m) squared distances
// K2 masked_system   Kt and the masked training system A, in one pass
// K3 rbf_bwd         the reductions of the closed-form RBF MLL backward
// K4 interp_adjoint  W^T v of the off-lattice SKI operator, a CSR segmented
//                    sum in a fixed order (no Pallas counterpart)
// K5 chol_inverse     the Cholesky factor L of an SPD matrix of order <= 128
//                    and L^-1, one block a matrix (no Pallas counterpart)
//
// K1-K3 take a leading task axis (T independent problems in one
// launch, the batch that gpim_tpu's vmap over output channels gives its
// Pallas kernels) on its own grid axis: blockIdx.z for K1 and K2,
// blockIdx.y for K3. Per-task operands advance by the task's stride; the
// padding mask (K2, K3) and K3's unscaled X are shared by every task. An
// unbatched call is T = 1. Offsets are int64: at T = 64 and n = 2048 one
// (T, n, n) tensor holds 2.7e8 elements.
//
// K1-K4 are elementwise-plus-reduction passes with d <= 8 features (K4 a
// sum of a few weighted rows a cell), so none has a tensor-core product to
// win: K1 and K2 are bound by the bytes they write, K3 and K4 by the bytes
// they read. The designs keep those accesses coalesced and touch every
// output or input element exactly once. K5 is a small dense factorisation
// held in one SM's shared memory (see its section).
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
// and each output (cell g, column c) is
//
//   out[g, c] = sum_{k = rowptr[g]}^{rowptr[g + 1] - 1} w[k] v[c, src[k]]
//
// summed by one thread from 0 in increasing k, each product and each sum
// rounded on its own (__fmul_rn/__fadd_rn, no FMA): the order and the
// rounding of the plain version's index_add_ on the CPU, so the card gives
// its bits, in every run. Bound by bytes.
//
// Two kernels compute it. What costs is reading v at the entries' points:
// a warp of (cell, column) threads touches a line of v for each of the b
// rows in every load.
//
// interp_adjoint_runs_kernel, for the layout of points sorted by their
// lower corner with every corner at a fixed offset from it (the SKI
// engine's; lcptr[g] is the first point whose lower corner is >= g). Cell
// g's entries are then its 2^d corner groups: for each corner offset o,
// largest first, the points lcptr[g - o] to lcptr[g - o + 1] - 1, which is
// their CSR order. A warp owns 32 consecutive cells, a lane each, and CG
// columns. For each corner the 32 cells' points are one run of
// consecutive points; the warp reads it 32 points at a time, coalesced:
// the weights of that corner (wrun, the weights corner by corner) and CG
// rows of v, and each lane forms its point's products. Each lane then
// takes, in order, the products of its own cell's points in those 32 from
// the lanes that hold them (a shuffle a column) and adds them; the next
// chunk's loads are in flight meanwhile. Nothing else is read: no src, no
// rowptr (~35 MB at the 1M cube, b = 9). The outputs go out through shared
// memory, one contiguous store a warp.
//
// interp_adjoint_kernel, for any other layout and for blocks too small
// for the runs kernel to fill the card (the wrapper's choice): one thread
// an output, the column fastest, reading its terms' weights, points and v
// from device memory.
//
// An empty cell writes 0. The same kernels are the gradient of the
// operator's gather W in the SKI loss's backward.
// ---------------------------------------------------------------------------
constexpr int kAdjThreads = 256;
constexpr int kRunWarps = 4;   // warps a block of the runs kernel
constexpr int kAdjRuns = 8;    // most corners the runs kernel takes (d <= 3)

// the corner offsets, largest first, passed by value
struct AdjOffsets {
  int o[kAdjRuns];
};

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

// a[i] of a register array, i known only at run time
__device__ __forceinline__ int pick(const int (&a)[kAdjRuns], int i) {
  int out = a[0];
#pragma unroll
  for (int q = 1; q < kAdjRuns; ++q) {
    if (q == i) out = a[q];
  }
  return out;
}

// the chunk after (r, base): 32 points on, or the next corner's run that
// holds points (base >= end when none is left); lo, last as below
__device__ __forceinline__ void next_chunk(const int (&lo)[kAdjRuns],
                                           const int (&last)[kAdjRuns],
                                           int runs, int& r, int& base,
                                           int& end) {
  base += 32;
  while (base >= end && r + 1 < runs) {
    ++r;
    base = __shfl_sync(0xffffffffu, pick(lo, r), 0);
    end = __shfl_sync(0xffffffffu, pick(last, r), 31);
  }
}

// a chunk's weight and CG values of v at this lane's point
template <typename T, int CG>
__device__ __forceinline__ void load_chunk(const T* __restrict__ wrun,
                                           const T* __restrict__ vt,
                                           int64_t n, int nc, int r,
                                           int base, int end, int lane,
                                           T& wp, T (&x)[CG]) {
  const int p = base + lane;
  wp = p < end ? wrun[static_cast<int64_t>(r) * n + p] : T(0);
#pragma unroll
  for (int c = 0; c < CG; ++c) {
    x[c] = p < end && c < nc ? vt[static_cast<int64_t>(c) * n + p] : T(0);
  }
}

template <typename T, int CG>
__global__ void __launch_bounds__(kRunWarps * 32)
    interp_adjoint_runs_kernel(const int* __restrict__ lcptr,
                               const T* __restrict__ wrun,
                               const T* __restrict__ v, AdjOffsets offs,
                               int runs, T* __restrict__ out, int64_t G,
                               int64_t n, int b) {
  __shared__ T stage[kRunWarps][32 * CG];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t g0 =
      (static_cast<int64_t>(blockIdx.x) * kRunWarps + warp) * 32;
  if (g0 >= G) return;
  const int c0 = blockIdx.y * CG;
  const int nc = min(CG, b - c0);
  const int64_t g1 = g0 + 32 < G ? g0 + 32 : G;
  const int64_t g = g0 + lane < g1 ? g0 + lane : g1;  // past g1: no points
  const T* __restrict__ vt = v + static_cast<int64_t>(c0) * n;
  // every corner's pointers at once: this lane's points of corner r are
  // lo[r] to (lane + 1's lo[r]) - 1, lane 31's end at last[r]
  int lo[kAdjRuns] = {}, last[kAdjRuns] = {};
#pragma unroll
  for (int r = 0; r < kAdjRuns; ++r) {
    if (r < runs) {
      const int64_t a = g - offs.o[r], z = g1 - offs.o[r];
      lo[r] = lcptr[a < 0 ? 0 : a];
      if (lane == 31) last[r] = lcptr[z < 0 ? 0 : z];
    }
  }
  T acc[CG];
#pragma unroll
  for (int c = 0; c < CG; ++c) acc[c] = T(0);
  // the chunks in entry order; the next one's weight and values load
  // while this one's products are added
  int r = -1, base = -32, end = 0;
  next_chunk(lo, last, runs, r, base, end);
  T wp, x[CG];
  load_chunk<T, CG>(wrun, vt, n, nc, r, base, end, lane, wp, x);
  while (base < end) {
    int r2 = r, base2 = base, end2 = end;
    next_chunk(lo, last, runs, r2, base2, end2);
    T wp2, x2[CG];
    load_chunk<T, CG>(wrun, vt, n, nc, r2, base2, end2, lane, wp2, x2);
    T prod[CG];
#pragma unroll
    for (int c = 0; c < CG; ++c) prod[c] = mul_rn(wp, x[c]);
    // this lane's points of the chunk are held by lanes first - base on
    const int mine = pick(lo, r);
    int stop = __shfl_down_sync(0xffffffffu, mine, 1);
    if (lane == 31) stop = pick(last, r);
    const int first = max(mine, base);
    const int count = max(min(stop, base + 32) - first, 0);
    const int most = __reduce_max_sync(0xffffffffu, count);
    for (int j = 0; j < most; ++j) {
      const int from = (first - base + j) & 31;
#pragma unroll
      for (int c = 0; c < CG; ++c) {
        const T t = __shfl_sync(0xffffffffu, prod[c], from);
        if (j < count) acc[c] = add_rn(acc[c], t);
      }
    }
    r = r2;
    base = base2;
    end = end2;
    wp = wp2;
#pragma unroll
    for (int c = 0; c < CG; ++c) x[c] = x2[c];
  }
  const int ncells = static_cast<int>(g1 - g0);
  T* __restrict__ ot = out + g0 * b + c0;
  if (nc == b) {  // the warp's outputs are one contiguous block
    T* st = stage[warp];
#pragma unroll
    for (int c = 0; c < CG; ++c) {
      if (c < nc) st[lane * nc + c] = acc[c];
    }
    __syncwarp();
    for (int i = lane; i < ncells * nc; i += 32) ot[i] = st[i];
  } else if (lane < ncells) {
#pragma unroll
    for (int c = 0; c < CG; ++c) {
      if (c < nc) ot[static_cast<int64_t>(lane) * b + c] = acc[c];
    }
  }
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

template <typename T, int CG>
int launch_interp_runs(const int* lcptr, const T* wrun, const T* v,
                       const AdjOffsets& offs, int runs, T* out, int64_t G,
                       int64_t n, int b, cudaStream_t stream) {
  const int64_t blocks = (G + 32 * kRunWarps - 1) / (32 * kRunWarps);
  const int64_t groups = (b + CG - 1) / CG;
  if (blocks > 0x7fffffffLL || groups > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  interp_adjoint_runs_kernel<T, CG>
      <<<dim3(static_cast<unsigned>(blocks), static_cast<unsigned>(groups)),
         kRunWarps * 32, 0, stream>>>(lcptr, wrun, v, offs, runs, out, G, n,
                                      b);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_interp_adjoint(const int* rowptr, const int* src, const T* w,
                          const T* v, const int* lcptr, const T* wrun,
                          const int* offsets, int runs, T* out, int64_t G,
                          int64_t n, int b, void* stream) {
  if (G < 0 || n < 0 || b < 0 || runs < 0 || runs > kAdjRuns ||
      (lcptr != nullptr) != (runs > 0) || (lcptr != nullptr && !wrun)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (G == 0 || b == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (lcptr != nullptr) {
    AdjOffsets offs = {};
    for (int j = 0; j < runs; ++j) offs.o[j] = offsets[j];
    // columns a warp: b itself up to 9, then 16 at a time
    if (b == 1) return launch_interp_runs<T, 1>(lcptr, wrun, v, offs, runs,
                                                out, G, n, b, s);
    if (b == 2) return launch_interp_runs<T, 2>(lcptr, wrun, v, offs, runs,
                                                out, G, n, b, s);
    if (b <= 4) return launch_interp_runs<T, 4>(lcptr, wrun, v, offs, runs,
                                                out, G, n, b, s);
    if (b <= 9) return launch_interp_runs<T, 9>(lcptr, wrun, v, offs, runs,
                                                out, G, n, b, s);
    return launch_interp_runs<T, 16>(lcptr, wrun, v, offs, runs, out, G, n,
                                     b, s);
  }
  const int64_t total = G * b;
  const int64_t blocks = (total + kAdjThreads - 1) / kAdjThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  interp_adjoint_kernel<T><<<static_cast<unsigned>(blocks), kAdjThreads, 0,
                             s>>>(rowptr, src, w, v, out, total, n, b);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// K5: the Cholesky factor of a small SPD matrix and its inverse, one block a
// matrix (no Pallas counterpart: gpim_tpu factors with XLA's Cholesky and
// triangular solve, gpim_tpu/ops/linalg.py, gpim_tpu/ops/tri.py). It
// replaces cholesky_ex (cuSOLVER's getrf_wo_pivot) and
// solve_triangular(L, I) (cuBLAS's trsm) at n <= 128, BO's padded order,
// where the pair took ~90 us a call for 2 n^3 / 3 = 1.4 MFLOP in float64:
// two library launches, each a few blocks that wait on each other.
//
// A float64 matrix of order 128 (128 KB) fits in one SM's shared memory,
// so one block factors it and inverts the factor without touching device
// memory in between. Bound on one SM by the n sequential pivots (a shuffle,
// a reciprocal square root and an FMA each) and by the n^3 / 3 FMAs of the
// trailing updates on the SM's FP64 (FP32) lanes. The design:
//
// - A, padded to np = a multiple of 16 with the identity (so its factor
//   and inverse are diag(L, I) and diag(V, I), exactly), lives in shared
//   memory M. Only its lower triangle is read, as cholesky_ex reads it,
//   all of it in one round of loads (64 a thread at n = 128).
// - Right-looking, by panels of 16 columns. Warp 0 factors a panel's
//   16 x 16 diagonal block L_pp, a lane a row, passing each pivot on ahead
//   of the block's other updates (the pivot row's own update comes first);
//   the block's columns go to PT (k-major, two buffers) for the other rows,
//   the reciprocal pivots to rinv. L leaves a panel at a time, from PT,
//   row by row.
// - Then, a thread a right-hand side (np of them, so 4 warps share the
//   reads of L_pp), two triangular solves with L_pp: the rows below the
//   block (L_r = A_r L_pp^-T) and row block p of V = L^-1 (L_pp^-1 B_p, B_p
//   what the earlier panels left in the row block, the identity in its
//   diagonal block). That row block of V is final, and goes out at once.
// - One trailing update then serves both factors. Below the panel, row r
//   loses sum_k P[r][k] Q[c][k] in every column c <= r: for c right of the
//   panel Q = P (the Cholesky's Schur complement), for c up to the panel's
//   last column Q^T = row block p of V (the inverse's elimination, the
//   panel's own columns starting from zero). 16 threads a 16 x 16 tile,
//   4 x 4 register tiles, the operands read as 4-vectors from shared
//   memory. Warps 0 and 4, which share a scheduler, update the next
//   panel's diagonal block first (1 x 4 register tiles), and warp 0
//   factors it with the scheduler to itself, while the six other warps
//   write the panel's columns of L and update the rest (look-ahead).
// - Each matrix has a second block, on another SM, that writes the zeros
//   above the diagonals of L and V: half of the bytes the card would
//   otherwise drain from the first block's SM.
//
// info has cholesky_ex's meaning: 0, or the 1-based order of the first
// leading minor whose pivot is not > 0 (NaN included). After a failure L
// and V hold whatever the arithmetic left. Every product is in the input's
// precision: fma in T, no tensor cores, no TF32.
// ---------------------------------------------------------------------------
constexpr int kCholNB = 16;         // panel width
constexpr int kCholMaxN = 128;      // largest order
constexpr int kCholThreads = 256;   // 8 warps

__device__ __forceinline__ float drsqrt(float x) { return rsqrtf(x); }
__device__ __forceinline__ double drsqrt(double x) { return rsqrt(x); }

// 4 consecutive elements of shared memory as two 8-byte (float) or 16-byte
// (double) accesses: rows of M start on such a boundary
template <typename T>
__device__ __forceinline__ void lds4(const T* p, T (&x)[4]) {
  if constexpr (sizeof(T) == 4) {
    const float2 u = reinterpret_cast<const float2*>(p)[0];
    const float2 v = reinterpret_cast<const float2*>(p)[1];
    x[0] = u.x;
    x[1] = u.y;
    x[2] = v.x;
    x[3] = v.y;
  } else {
    const double2 u = reinterpret_cast<const double2*>(p)[0];
    const double2 v = reinterpret_cast<const double2*>(p)[1];
    x[0] = u.x;
    x[1] = u.y;
    x[2] = v.x;
    x[3] = v.y;
  }
}

template <typename T>
__device__ __forceinline__ void sts4(T* p, const T (&x)[4]) {
  if constexpr (sizeof(T) == 4) {
    reinterpret_cast<float2*>(p)[0] = make_float2(x[0], x[1]);
    reinterpret_cast<float2*>(p)[1] = make_float2(x[2], x[3]);
  } else {
    reinterpret_cast<double2*>(p)[0] = make_double2(x[0], x[1]);
    reinterpret_cast<double2*>(p)[1] = make_double2(x[2], x[3]);
  }
}

// Warp 0: factor the diagonal block at (k0, k0) of M in registers, lane
// rho (and its shadow rho + 16) row k0 + rho. The block's columns go to
// PT (PT[j * ps + k0 + rho]), the reciprocal pivots to rinv; fail keeps
// the first failing pivot's order.
template <typename T>
__device__ __forceinline__ void chol_diag(const T* __restrict__ M, int ld,
                                          T* __restrict__ PT,
                                          T* __restrict__ rinv, int ps,
                                          int k0, int lane, int& fail) {
  constexpr int NB = kCholNB;
  constexpr unsigned kAll = 0xffffffffu;
  const int rho = lane % NB;
  T a[NB];
#pragma unroll
  for (int q = 0; q < NB; q += 4) {
    T t[4];
    lds4(M + (k0 + rho) * ld + k0 + q, t);
#pragma unroll
    for (int u = 0; u < 4; ++u) a[q + u] = t[u];
  }
  T d = __shfl_sync(kAll, a[0], 0);
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    if (!(d > T(0)) && fail == 0) fail = k0 + j + 1;
    const T r = drsqrt(d);
    const T l = rho > j ? a[j] * r : (rho == j ? d * r : a[j]);
    a[j] = l;
    // the next pivot first: row j + 1's own update of its diagonal, the
    // same fma as the update below gives it
    if (j + 1 < NB) d = __shfl_sync(kAll, fma(-l, l, a[j + 1]), j + 1);
    if (lane < NB) PT[j * ps + k0 + lane] = l;
    if (lane == 0) rinv[k0 + j] = r;
    __syncwarp();
#pragma unroll
    for (int c = j + 1; c < NB; ++c) {
      a[c] = fma(-l, PT[j * ps + k0 + c], a[c]);
    }
  }
}

// x = L_pp^-1 x for the factored diagonal block at k0 (columns in PT, the
// reciprocal pivots in rinv), by forward substitution
template <typename T>
__device__ __forceinline__ void chol_solve(const T* __restrict__ PT,
                                           const T* __restrict__ rinv,
                                           int ps, int k0,
                                           T (&x)[kCholNB]) {
  constexpr int NB = kCholNB;
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    x[j] *= rinv[k0 + j];
    // L_pp[jj][j], jj > j, four at a time from a 4-aligned start
#pragma unroll
    for (int q = (j + 1) / 4 * 4; q < NB; q += 4) {
      T col[4];
      lds4(PT + j * ps + k0 + q, col);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (q + u > j) x[q + u] = fma(-x[j], col[u], x[q + u]);
      }
    }
  }
}

// The trailing update of one R x 4 register tile (R = 1 or 4; thread sub
// of 16 * 4 / R) of the 16 x 16 tile (bi, bj) below panel k0 .. t0 - 1
// (module comment); register tiles wholly above the diagonal are skipped.
template <typename T, int R>
__device__ __forceinline__ void chol_tile(T* __restrict__ M, int ld,
                                          const T* __restrict__ PT, int ps,
                                          int k0, int bi, int bj, int sub) {
  constexpr int NB = kCholNB;
  const int t0 = k0 + NB;
  const int r0 = bi * NB + sub / 4 * R;
  const int c0 = bj * NB + sub % 4 * 4;
  if (c0 > r0 + R - 1) return;
  T acc[R][4];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    if (c0 >= k0 && c0 < t0) {
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = T(0);
    } else {
      lds4(M + (r0 + i) * ld + c0, acc[i]);
    }
  }
  const T* bsrc = c0 < t0 ? M + k0 * ld + c0 : PT + c0;
  const int bstride = c0 < t0 ? ld : ps;
#pragma unroll
  for (int k = 0; k < NB; ++k) {
    T av[R];
    T bv[4];
    if constexpr (R == 4) {
      lds4(PT + k * ps + r0, av);
    } else {
      av[0] = PT[k * ps + r0];
    }
    lds4(bsrc + k * bstride, bv);
#pragma unroll
    for (int i = 0; i < R; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fma(-av[i], bv[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < R; ++i) sts4(M + (r0 + i) * ld + c0, acc[i]);
}

template <typename T>
__global__ void __launch_bounds__(kCholThreads, 1)
    chol_inverse_kernel(const T* __restrict__ A, T* __restrict__ L,
                        T* __restrict__ V, int* __restrict__ info, int n) {
  constexpr int NB = kCholNB;
  extern __shared__ __align__(16) unsigned char chol_smem[];
  T* M = reinterpret_cast<T*>(chol_smem);
  const int np = (n + NB - 1) / NB * NB;
  const int ld = np + 2;            // rows 16-byte aligned, 2 banks apart
  // two panel buffers, k-major, rows ps apart: a row's 16 values in 16
  // (float) or 8 (double) banks
  const int ps = np + 2;
  T* PT0 = M + np * ld;
  T* rinv = PT0 + 2 * NB * ps;      // the reciprocal pivots
  const int64_t off = static_cast<int64_t>(blockIdx.x / 2) * n * n;
  A += off;
  L += off;
  V += off;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  if (blockIdx.x % 2) {
    // the helper block of the matrix, on another SM: the zeros above the
    // diagonals of L and V, half of their bytes
    for (int r = tid / 32; r < n; r += kCholThreads / 32) {
      for (int c = r + 1 + lane; c < n; c += 32) {
        L[r * n + c] = T(0);
        V[r * n + c] = T(0);
      }
    }
    return;
  }
  {
    // warp w loads rows w, w + 8, ..., lane columns lane + 32 q: every load
    // in flight at once
    constexpr int kRows = kCholMaxN / (kCholThreads / 32);
    constexpr int kCols = kCholMaxN / 32;
    const int warp = tid / 32;
    T v[kRows][kCols];
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      const int r = warp + kCholThreads / 32 * u;
#pragma unroll
      for (int q = 0; q < kCols; ++q) {
        const int c = lane + 32 * q;
        v[u][q] = r < n && c <= r ? A[r * n + c] : T(r == c ? 1 : 0);
      }
    }
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      const int r = warp + kCholThreads / 32 * u;
#pragma unroll
      for (int q = 0; q < kCols; ++q) {
        const int c = lane + 32 * q;
        if (r < np && c < np) M[r * ld + c] = v[u][q];
      }
    }
  }
  __syncthreads();
  int fail = 0;
  const int blocks = np / NB;
  if (tid < 32) chol_diag(M, ld, PT0, rinv, ps, 0, lane, fail);
  __syncthreads();
  for (int p = 0; p < blocks; ++p) {
    const int k0 = p * NB;
    const int t0 = k0 + NB;
    T* PT = PT0 + (p & 1) * NB * ps;          // panel p
    T* PTn = PT0 + ((p + 1) & 1) * NB * ps;   // panel p + 1
    const int below = np - t0;
    if (tid < np) {
      // a thread a right-hand side: the panel's rows below its diagonal
      // block, then the columns of row block p of V (final, so written
      // out)
      const int row = t0 + tid;
      const int c = tid - below;
      T x[NB];
      if (tid < below) {
#pragma unroll
        for (int q = 0; q < NB; q += 4) {
          T t[4];
          lds4(M + row * ld + k0 + q, t);
#pragma unroll
          for (int u = 0; u < 4; ++u) x[q + u] = t[u];
        }
      } else {
#pragma unroll
        for (int k = 0; k < NB; ++k) {
          x[k] = c < k0 ? M[(k0 + k) * ld + c] : T(c - k0 == k ? 1 : 0);
        }
      }
      chol_solve(PT, rinv, ps, k0, x);
      if (tid < below) {
#pragma unroll
        for (int j = 0; j < NB; ++j) PT[j * ps + row] = x[j];
      } else {
#pragma unroll
        for (int k = 0; k < NB; ++k) {
          M[(k0 + k) * ld + c] = x[k];
          if (c < n && k0 + k < n && c <= k0 + k) {
            V[(k0 + k) * n + c] = x[k];
          }
        }
      }
    }
    __syncthreads();
    if (tid < 32 || tid / 32 == kCholThreads / 64) {
      if (t0 < np) {
        // look-ahead: warps 0 and 4 (warp w runs on scheduler w % 4)
        // update the next diagonal block; warp 0 then factors it, with
        // the scheduler to itself
        chol_tile<T, 1>(M, ld, PT, ps, k0, p + 1, p + 1, tid % 32 +
                        (tid < 32 ? 0 : 32));
        asm volatile("bar.sync 1, 64;" ::: "memory");
        if (tid < 32) chol_diag(M, ld, PTn, rinv, ps, t0, lane, fail);
      }
    } else {
      // the six warps of the other three schedulers: panel p's columns of
      // L below the diagonal from PT, row by row (coalesced), then the
      // other tiles (bi, bj), bj <= bi, bi > p, by rows
      const int t = tid < kCholThreads / 2 ? tid - 32 : tid - 64;
      for (int e = t; e < (n - k0) * NB; e += kCholThreads - 64) {
        const int row = k0 + e / NB;
        const int j = e % NB;
        if (row >= k0 + j) L[row * n + k0 + j] = PT[j * ps + row];
      }
      const int tiles = t0 < np
          ? (blocks * (blocks + 1) - (p + 1) * (p + 2)) / 2 : 0;
      for (int w = t / NB; w < tiles; w += (kCholThreads - 64) / NB) {
        int bi = p + 1;
        int bj = w;
        while (bj > bi) {
          bj -= bi + 1;
          ++bi;
        }
        if (bi != p + 1 || bj != p + 1) {
          chol_tile<T, 4>(M, ld, PT, ps, k0, bi, bj, tid % NB);
        }
      }
    }
    __syncthreads();
  }
  if (tid == 0) info[blockIdx.x / 2] = fail;
}

template <typename T>
constexpr size_t chol_smem_bytes(int np) {
  return static_cast<size_t>((np + 2 * kCholNB) * (np + 2) + np) *
         sizeof(T);
}

template <typename T>
int launch_chol_inverse(const T* A, T* L, T* V, int* info, int n,
                        int64_t batch, void* stream) {
  if (n < 1 || n > kCholMaxN || batch < 0 || batch > 0x3fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch == 0) return static_cast<int>(cudaGetLastError());
  // more than 48 KB of shared memory only once the kernel is allowed it,
  // once a device
  static unsigned long long allowed = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64 || !((allowed >> dev) & 1ULL)) {
    err = cudaFuncSetAttribute(
        chol_inverse_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(chol_smem_bytes<T>(kCholMaxN)));
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < 64) allowed |= 1ULL << dev;
  }
  const int np = (n + kCholNB - 1) / kCholNB * kCholNB;
  chol_inverse_kernel<T>
      <<<static_cast<unsigned>(2 * batch), kCholThreads,
         chol_smem_bytes<T>(np),
         static_cast<cudaStream_t>(stream)>>>(A, L, V, info, n);
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
// by cell (rowptr (G + 1), and each entry's point src and weight w). When
// the points come sorted by their lower corner, also lcptr (G + 1), wrun
// (2^d, n: the weights corner by corner, in the order of offs) and offs
// (runs <= 8 corner offsets, largest first, in host memory); else null,
// null, null and 0.
int gpim_interp_adjoint_f32(const int* rowptr, const int* src, const float* w,
                            const float* v, const int* lcptr,
                            const float* wrun, const int* offs, int runs,
                            float* out, int64_t G, int64_t n, int b,
                            void* stream) {
  return launch_interp_adjoint<float>(rowptr, src, w, v, lcptr, wrun, offs,
                                      runs, out, G, n, b, stream);
}

int gpim_interp_adjoint_f64(const int* rowptr, const int* src,
                            const double* w, const double* v,
                            const int* lcptr, const double* wrun,
                            const int* offs, int runs, double* out,
                            int64_t G, int64_t n, int b, void* stream) {
  return launch_interp_adjoint<double>(rowptr, src, w, v, lcptr, wrun, offs,
                                       runs, out, G, n, b, stream);
}

// K5: L, V = L^-1 and info for each of batch matrices A of order n <= 128,
// laid out one after another; only A's lower triangle is read. L and V are
// written whole (zeros above the diagonal), info one int a matrix.
int gpim_chol_inverse_f32(const float* A, float* L, float* V, int* info,
                          int n, int64_t batch, void* stream) {
  return launch_chol_inverse<float>(A, L, V, info, n, batch, stream);
}

int gpim_chol_inverse_f64(const double* A, double* L, double* V, int* info,
                          int n, int64_t batch, void* stream) {
  return launch_chol_inverse<double>(A, L, V, info, n, batch, stream);
}

}  // extern "C"
