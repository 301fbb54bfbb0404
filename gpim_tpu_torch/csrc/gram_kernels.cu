// Hand-written CUDA kernels of the exact-GP training and prediction path,
// for Hopper (sm_90a). Counterpart: gpim_tpu/ops/pallas_gram.py.
//
// K1 sqdist          (n, d) x (m, d) -> (n, m) squared distances
// K2 masked_system   Kt and the masked training system A, in one pass
// K3 rbf_bwd         the reductions of the closed-form RBF MLL backward
//
// Every kernel is an elementwise-plus-reduction pass with d <= 8 features,
// so none has a tensor-core product to win: K1 and K2 are bound by the bytes
// they write, K3 by the bytes it reads. The designs keep those accesses
// coalesced and touch every output or input element exactly once.
//
// Plain C interface (loaded with ctypes), one entry point per kernel and
// dtype. Each entry point launches on the caller's stream, never
// synchronises, allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxD = 8;         // largest feature count the kernels take
constexpr int kTile = 32;        // K1/K2 output tile: kTile rows x kTile cols
constexpr int kBlockRows = 8;    // K1/K2 block: (kTile, kBlockRows) threads
constexpr int kRowsPerThread = kTile / kBlockRows;
constexpr int kWarpsPerBlock = 8;  // K3: one warp per row
constexpr int kSumThreads = 1024;  // K3 second pass: one block

constexpr int kRBF = 0;
constexpr int kMatern52 = 1;
constexpr int kRationalQuadratic = 2;

__device__ __forceinline__ float dexp(float x) { return expf(x); }
__device__ __forceinline__ double dexp(double x) { return exp(x); }
__device__ __forceinline__ float dsqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double dsqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float dlog1p(float x) { return log1pf(x); }
__device__ __forceinline__ double dlog1p(double x) { return log1p(x); }

// Stage kTile rows of a row-major (rows, d) matrix into shared memory,
// zero past the last row and past feature d.
template <typename T>
__device__ __forceinline__ void stage_rows(const T* __restrict__ src,
                                           int64_t rows, int d, int64_t row0,
                                           T (*dst)[kMaxD]) {
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  for (int e = tid; e < kTile * kMaxD; e += blockDim.x * blockDim.y) {
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
// Block (32, 8) owns a 32 x 32 output tile. The tile's A rows sit in shared
// memory (read as broadcasts), each thread keeps its B column in registers,
// and a warp stores 32 neighbouring columns of one row: coalesced 128-byte
// (f32) rows of the row-major output.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void sqdist_kernel(const T* __restrict__ A, const T* __restrict__ B,
                              T* __restrict__ out, int64_t n, int64_t m,
                              int d) {
  __shared__ T a_s[kTile][kMaxD];
  const int64_t row0 = static_cast<int64_t>(blockIdx.y) * kTile;
  const int64_t col = static_cast<int64_t>(blockIdx.x) * kTile + threadIdx.x;
  stage_rows(A, n, d, row0, a_s);
  T b[kMaxD];
  load_point(B, col, m, d, b);
  __syncthreads();
  if (col >= m) return;
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int r = threadIdx.y + i * kBlockRows;
    const int64_t row = row0 + r;
    if (row < n) out[row * m + col] = sq_dist(a_s[r], b, d);
  }
}

// ---------------------------------------------------------------------------
// K2: fused masked training system (pallas_gram.py _system_kernel).
// Same tiling as K1 over the (n, n) output, writing both
//   Kt = v k(s)  with the diagonal set to exactly v (global row == col),
//   A  = (m m^T) . (Kt + (noise + jitter) I) + (I - diag m).
// The scalars (v, noise + jitter, alpha) come from a device buffer, so the
// caller never copies them to the host.
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

template <typename T, int KERNEL>
__global__ void masked_system_kernel(const T* __restrict__ Xs,
                                     const T* __restrict__ mask,
                                     const T* __restrict__ scal,
                                     T* __restrict__ Kt, T* __restrict__ A,
                                     int64_t n, int d) {
  __shared__ T a_s[kTile][kMaxD];
  __shared__ T m_s[kTile];
  const int64_t row0 = static_cast<int64_t>(blockIdx.y) * kTile;
  const int64_t col = static_cast<int64_t>(blockIdx.x) * kTile + threadIdx.x;
  stage_rows(Xs, n, d, row0, a_s);
  if (threadIdx.y == 0) {
    const int64_t g = row0 + threadIdx.x;
    m_s[threadIdx.x] = g < n ? mask[g] : T(0);
  }
  T b[kMaxD];
  load_point(Xs, col, n, d, b);
  const T v = scal[0];
  const T noise_jitter = scal[1];
  const T alpha = scal[2];
  const T m_col = col < n ? mask[col] : T(0);
  __syncthreads();
  if (col >= n) return;
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int r = threadIdx.y + i * kBlockRows;
    const int64_t row = row0 + r;
    if (row >= n) continue;
    const bool diag = row == col;
    const T k = diag ? v : kernel_value<T, KERNEL>(sq_dist(a_s[r], b, d), v,
                                                   alpha);
    const T m_row = m_s[r];
    const int64_t off = row * n + col;
    Kt[off] = k;
    A[off] = m_row * m_col * (k + (diag ? noise_jitter : T(0))) +
             (diag ? T(1) - m_row : T(0));
  }
}

// ---------------------------------------------------------------------------
// K3: closed-form RBF backward reductions (pallas_gram.py _bwd_red_kernel).
// With W = (Ainv - a a^T) . (m m^T) . Kt:
//   rw_i = sum_j W_ij,  WX = W @ X,  dg_i = Ainv_ii m_i^2,
//   S1 = sum_i rw_i,    diagsum = sum_i dg_i.
// The TPU kernel carried row sums across its sequential column grid; Hopper
// blocks run in no order, so one warp owns one row: its lanes stride over
// the columns (coalesced reads of Ainv and Kt), keep rw and the d entries of
// WX in registers and reduce them with shuffles. A second one-block kernel
// sums rw and dg. No atomics: the f32 result is the same in every run.
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
__global__ void rbf_bwd_rows_kernel(const T* __restrict__ Ainv,
                                    const T* __restrict__ Kt,
                                    const T* __restrict__ alpha,
                                    const T* __restrict__ mask,
                                    const T* __restrict__ X,
                                    T* __restrict__ rw, T* __restrict__ wx,
                                    T* __restrict__ dg, int64_t n, int d) {
  const int lane = threadIdx.x & 31;
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= n) return;  // row is uniform across the warp
  const T a_row = alpha[row];
  const T m_row = mask[row];
  const T* __restrict__ ainv_row = Ainv + row * n;
  const T* __restrict__ k_row = Kt + row * n;
  T acc_rw = T(0);
  T acc_wx[kMaxD];
#pragma unroll
  for (int k = 0; k < kMaxD; ++k) acc_wx[k] = T(0);
  for (int64_t j = lane; j < n; j += 32) {
    const T w = (ainv_row[j] - a_row * alpha[j]) * (m_row * mask[j]) * k_row[j];
    acc_rw += w;
#pragma unroll
    for (int k = 0; k < kMaxD; ++k) {
      if (k < d) acc_wx[k] += w * X[j * d + k];
    }
  }
  acc_rw = warp_sum(acc_rw);
#pragma unroll
  for (int k = 0; k < kMaxD; ++k) {
    if (k < d) acc_wx[k] = warp_sum(acc_wx[k]);
  }
  if (lane == 0) {
    rw[row] = acc_rw;
#pragma unroll
    for (int k = 0; k < kMaxD; ++k) {
      if (k < d) wx[row * d + k] = acc_wx[k];
    }
    dg[row] = ainv_row[row] * m_row * m_row;
  }
}

template <typename T>
__global__ void sum_pair_kernel(const T* __restrict__ a,
                                const T* __restrict__ b, T* __restrict__ out,
                                int64_t n) {
  __shared__ T part_a[kSumThreads / 32];
  __shared__ T part_b[kSumThreads / 32];
  T sa = T(0);
  T sb = T(0);
  for (int64_t i = threadIdx.x; i < n; i += blockDim.x) {
    sa += a[i];
    sb += b[i];
  }
  sa = warp_sum(sa);
  sb = warp_sum(sb);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) {
    part_a[warp] = sa;
    part_b[warp] = sb;
  }
  __syncthreads();
  if (warp == 0) {
    const int nwarps = blockDim.x >> 5;
    sa = lane < nwarps ? part_a[lane] : T(0);
    sb = lane < nwarps ? part_b[lane] : T(0);
    sa = warp_sum(sa);
    sb = warp_sum(sb);
    if (lane == 0) {
      out[0] = sa;
      out[1] = sb;
    }
  }
}

// ---------------------------------------------------------------------------
// Launchers
// ---------------------------------------------------------------------------
inline dim3 tile_grid(int64_t rows, int64_t cols) {
  return dim3(static_cast<unsigned>((cols + kTile - 1) / kTile),
              static_cast<unsigned>((rows + kTile - 1) / kTile));
}

template <typename T>
int launch_sqdist(const T* A, const T* B, T* out, int64_t n, int64_t m, int d,
                  void* stream) {
  if (n > 0 && m > 0) {
    sqdist_kernel<T><<<tile_grid(n, m), dim3(kTile, kBlockRows), 0,
                       static_cast<cudaStream_t>(stream)>>>(A, B, out, n, m,
                                                             d);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_masked_system(const T* Xs, const T* mask, const T* scal, T* Kt,
                         T* A, int64_t n, int d, int kernel, void* stream) {
  if (n > 0) {
    const dim3 grid = tile_grid(n, n);
    const dim3 block(kTile, kBlockRows);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (kernel) {
      case kRBF:
        masked_system_kernel<T, kRBF><<<grid, block, 0, s>>>(Xs, mask, scal,
                                                             Kt, A, n, d);
        break;
      case kMatern52:
        masked_system_kernel<T, kMatern52><<<grid, block, 0, s>>>(
            Xs, mask, scal, Kt, A, n, d);
        break;
      case kRationalQuadratic:
        masked_system_kernel<T, kRationalQuadratic><<<grid, block, 0, s>>>(
            Xs, mask, scal, Kt, A, n, d);
        break;
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_rbf_bwd(const T* Ainv, const T* Kt, const T* alpha, const T* mask,
                   const T* X, T* rw, T* wx, T* dg, T* sums, int64_t n, int d,
                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n > 0) {
    const unsigned blocks =
        static_cast<unsigned>((n + kWarpsPerBlock - 1) / kWarpsPerBlock);
    rbf_bwd_rows_kernel<T><<<blocks, kWarpsPerBlock * 32, 0, s>>>(
        Ainv, Kt, alpha, mask, X, rw, wx, dg, n, d);
  }
  sum_pair_kernel<T><<<1, kSumThreads, 0, s>>>(rw, dg, sums, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* gpim_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int gpim_sqdist_f32(const float* A, const float* B, float* out, int64_t n,
                    int64_t m, int d, void* stream) {
  return launch_sqdist<float>(A, B, out, n, m, d, stream);
}

int gpim_sqdist_f64(const double* A, const double* B, double* out, int64_t n,
                    int64_t m, int d, void* stream) {
  return launch_sqdist<double>(A, B, out, n, m, d, stream);
}

int gpim_masked_system_f32(const float* Xs, const float* mask,
                           const float* scal, float* Kt, float* A, int64_t n,
                           int d, int kernel, void* stream) {
  return launch_masked_system<float>(Xs, mask, scal, Kt, A, n, d, kernel,
                                     stream);
}

int gpim_masked_system_f64(const double* Xs, const double* mask,
                           const double* scal, double* Kt, double* A,
                           int64_t n, int d, int kernel, void* stream) {
  return launch_masked_system<double>(Xs, mask, scal, Kt, A, n, d, kernel,
                                      stream);
}

int gpim_rbf_bwd_reductions_f32(const float* Ainv, const float* Kt,
                                const float* alpha, const float* mask,
                                const float* X, float* rw, float* wx,
                                float* dg, float* sums, int64_t n, int d,
                                void* stream) {
  return launch_rbf_bwd<float>(Ainv, Kt, alpha, mask, X, rw, wx, dg, sums, n,
                               d, stream);
}

int gpim_rbf_bwd_reductions_f64(const double* Ainv, const double* Kt,
                                const double* alpha, const double* mask,
                                const double* X, double* rw, double* wx,
                                double* dg, double* sums, int64_t n, int d,
                                void* stream) {
  return launch_rbf_bwd<double>(Ainv, Kt, alpha, mask, X, rw, wx, dg, sums, n,
                                d, stream);
}

}  // extern "C"
