// Fleet banded LU for Hopper (sm_90a): K9 factor+solve, K10 solve,
// K11 factor.  Built with nvcc into a shared library with a plain C
// interface and bound with ctypes (tenscalc_tpu_torch/kkt/banded_lu.py).
//
// Replaces the Pallas TPU kernels of tenscalc_tpu/kkt/banded_lu.py:
//   K9  tc_banded_lu_factor_solve <- _lu_factor_solve_kernel (:309-423)
//   K10 tc_banded_lu_solve        <- _lu_solve_kernel        (:252-306)
//   K11 tc_banded_lu_factor       <- _lu_factor_kernel       (:175-249)
//
// What is computed, per instance: an unpivoted LU of an unsymmetric band
// matrix A of half-bandwidth W held as full band storage of width 2W+1,
//   row c = [A[c,c], A[c+1,c], ..., A[c+W,c], A[c,c+1], ..., A[c,c+W]].
// Factoring happens in place: row c becomes [d_c, l_1..l_W, u_1..u_W]
// with the pivot d_c clamped (Cheng-Higham: d <- sign(d) * max(|d|,
// clamp), sign(0) = +), the multipliers l_i = A[c+i,c] / d_c and the raw
// U entries u_q = A[c,c+q].  Step c updates the trailing square
//   A[c+i, c+q] -= l_i * u_q,   i, q = 1..W.
// The solve is a unit-lower forward sweep y_c -> y_{c+i} -= l_i y_c and a
// backward sweep x_c = (y_c - sum_q u_q x_{c+q}) / d_c.
//
// Layout.  The wrapper hands the kernels band (n, 2W+1, B) and vectors
// (n, B), batch fastest, the layout of the TPU kernels' lanes: thread b
// owns instance b, and the 32 threads of a warp read 32 neighbouring
// floats with each load.
//
// Arithmetic.  The order is the TPU kernel's: the clamp, then
// l = row / d, then each trailing entry minus its product (the product
// rounded first), and in the backward sweep a sequential sum over q, a
// subtraction and a division.  The _rn intrinsics keep nvcc from
// contracting products and sums into fused multiply-adds, so the kernel
// rounds exactly as the plain PyTorch version beside its wrapper does.
// The 8-row blocks of the TPU kernel exist for Mosaic's sublane tiling
// and are not copied: rows past n are masked instead of padded.
//
// What bounds it.  At the MPC-MHE fleet's shapes (B = 1024, n = 290,
// W = 10) K9 moves about 52.3 MB (band and rhs in, factor and x out),
// about 15.6 us at the card's 3.35 TB/s; K10 about 27.3 MB (8.2 us);
// K11 about 49.9 MB (14.9 us).  The real limit is latency: each thread
// runs a chain of n = 290 dependent elimination steps, each waiting on
// loads from memory, and one thread per instance fills only
// B / 128 = 8 of the 132 SMs at B = 1024.  Making them fast (several
// threads an instance, more instances an SM) is later work.
//
// Register window.  Step c touches rows c..c+W.  Of row c+i it needs the
// lower entries p = 0..W-i (A[c+i+p, c+i]) and the upper entries
// q = 1..W-i (A[c+i, c+i+q]): the others have not been touched by any
// earlier step and are loaded only when the window reaches them.  The
// window is (W+1)^2 floats (121 at W = 10), held in registers by full
// unrolling over the template width (W = 1..12; larger widths would
// spill and are refused).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxW = 12;

__device__ __forceinline__ float clamp_pivot(float d, float clamp) {
  if (clamp > 0.0f) {
    const float sgn = d >= 0.0f ? 1.0f : -1.0f;
    const float a = fabsf(d);
    // keeps NaN (a comparison with NaN is false), as jnp.maximum does
    d = __fmul_rn(sgn, a < clamp ? clamp : a);
  }
  return d;
}

__device__ __forceinline__ float load_or_zero(const float* p, size_t i,
                                              bool ok) {
  return ok ? p[i] : 0.0f;
}

// Factor rows 0..n-1 of instance b in registers and write the factored
// band.  With SOLVE the forward sweep rides along: y = L^{-1} rhs is
// formed right-looking as each row is factored, and y_c is stored into x
// for the backward sweep.
template <int W, bool SOLVE>
__device__ __forceinline__ void lu_factor_rows(const float* __restrict__ band,
                                              float* fband,
                                              const float* __restrict__ rhs,
                                              float* x, int n, int B, int b,
                                              float clamp) {
  constexpr int R = 2 * W + 1;
  // lo[i][p] = current A[c+i+p, c+i], p <= W-i;
  // up[i][q-1] = current A[c+i, c+i+q], q <= W-i
  float lo[W + 1][W + 1];
  float up[W + 1][W];
  float xw[W + 1];  // forward-sweep values of rows c..c+W
#pragma unroll
  for (int i = 0; i <= W; ++i) {
    const bool ok = i < n;
#pragma unroll
    for (int p = 0; p + i <= W; ++p) {
      lo[i][p] = load_or_zero(band, (size_t)(i * R + p) * B + b, ok);
    }
#pragma unroll
    for (int q = 1; q + i <= W; ++q) {
      up[i][q - 1] = load_or_zero(band, (size_t)(i * R + W + q) * B + b, ok);
    }
    if (SOLVE) xw[i] = load_or_zero(rhs, (size_t)i * B + b, ok);
  }
  for (int c = 0; c < n; ++c) {
    const float d = clamp_pivot(lo[0][0], clamp);
    float l[W + 1];
    l[0] = 0.0f;
#pragma unroll
    for (int k = 1; k <= W; ++k) l[k] = __fdiv_rn(lo[0][k], d);
    float* out = fband + (size_t)(c * R) * B + b;
    out[0] = d;
#pragma unroll
    for (int k = 1; k <= W; ++k) out[(size_t)k * B] = l[k];
#pragma unroll
    for (int k = 1; k <= W; ++k) out[(size_t)(W + k) * B] = up[0][k - 1];
    // trailing update of rows c+m: the sub/diagonal entries p get
    // l_{m+p} * u_m, the super entries q get u_{m+q} * l_m
#pragma unroll
    for (int m = 1; m <= W; ++m) {
      const float um = up[0][m - 1];
#pragma unroll
      for (int p = 0; p + m <= W; ++p) {
        lo[m][p] = __fsub_rn(lo[m][p], __fmul_rn(l[m + p], um));
      }
#pragma unroll
      for (int q = 1; q + m <= W; ++q) {
        up[m][q - 1] = __fsub_rn(up[m][q - 1], __fmul_rn(up[0][m + q - 1], l[m]));
      }
    }
    if (SOLVE) {
      const float y = xw[0];
#pragma unroll
      for (int i = 1; i <= W; ++i) xw[i] = __fsub_rn(xw[i], __fmul_rn(l[i], y));
      x[(size_t)c * B + b] = y;
    }
    // slide the window down one row; each row gains its outermost lower
    // and upper entries fresh from memory
#pragma unroll
    for (int i = 0; i < W; ++i) {
#pragma unroll
      for (int p = 0; p + i < W; ++p) lo[i][p] = lo[i + 1][p];
#pragma unroll
      for (int q = 1; q + i < W; ++q) up[i][q - 1] = up[i + 1][q - 1];
      const int row = c + 1 + i;
      const bool ok = row < n;
      lo[i][W - i] = load_or_zero(band, (size_t)(row * R + W - i) * B + b, ok);
      up[i][W - i - 1] =
          load_or_zero(band, (size_t)(row * R + 2 * W - i) * B + b, ok);
      if (SOLVE) xw[i] = xw[i + 1];
    }
    const int last = c + 1 + W;
    lo[W][0] = load_or_zero(band, (size_t)(last * R) * B + b, last < n);
    if (SOLVE) xw[W] = load_or_zero(rhs, (size_t)last * B + b, last < n);
  }
}

// Forward sweep against a factored band: y = L^{-1} rhs into x.
template <int W>
__device__ __forceinline__ void lu_forward_rows(const float* __restrict__ fband,
                                               const float* __restrict__ rhs,
                                               float* x, int n, int B, int b) {
  constexpr int R = 2 * W + 1;
  float xw[W + 1];
#pragma unroll
  for (int i = 0; i <= W; ++i) xw[i] = load_or_zero(rhs, (size_t)i * B + b, i < n);
  for (int c = 0; c < n; ++c) {
    const float y = xw[0];
#pragma unroll
    for (int i = 1; i <= W; ++i) {
      xw[i] = __fsub_rn(xw[i], __fmul_rn(fband[(size_t)(c * R + i) * B + b], y));
    }
    x[(size_t)c * B + b] = y;
#pragma unroll
    for (int i = 0; i < W; ++i) xw[i] = xw[i + 1];
    const int last = c + 1 + W;
    xw[W] = load_or_zero(rhs, (size_t)last * B + b, last < n);
  }
}

// Backward sweep U x = y in place, left-looking: x_{c+1..c+W} are final
// when row c is reached and stay in registers (0 past the last row).
// K9 reads here what the same thread wrote in its factor sweep, so these
// pointers are not __restrict__.
template <int W>
__device__ __forceinline__ void lu_backward_rows(const float* fband, float* x,
                                                int n, int B, int b) {
  constexpr int R = 2 * W + 1;
  float xn[W + 1];  // xn[q] = final x[c+q], q = 1..W
#pragma unroll
  for (int q = 0; q <= W; ++q) xn[q] = 0.0f;
  for (int c = n - 1; c >= 0; --c) {
    const float* row = fband + (size_t)(c * R) * B + b;
    float acc = 0.0f;
#pragma unroll
    for (int q = 1; q <= W; ++q) {
      acc = __fadd_rn(acc, __fmul_rn(row[(size_t)(W + q) * B], xn[q]));
    }
    const float xc = __fdiv_rn(__fsub_rn(x[(size_t)c * B + b], acc), row[0]);
    x[(size_t)c * B + b] = xc;
#pragma unroll
    for (int q = W; q > 1; --q) xn[q] = xn[q - 1];
    xn[1] = xc;
  }
}

template <int W>
__global__ void __launch_bounds__(kThreads)
lu_factor_solve_kernel(const float* __restrict__ band,
                       const float* __restrict__ rhs, float* fband, float* x,
                       int n, int B, float clamp) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  lu_factor_rows<W, true>(band, fband, rhs, x, n, B, b, clamp);
  lu_backward_rows<W>(fband, x, n, B, b);
}

template <int W>
__global__ void __launch_bounds__(kThreads)
lu_solve_kernel(const float* __restrict__ fband, const float* __restrict__ rhs,
                float* x, int n, int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  lu_forward_rows<W>(fband, rhs, x, n, B, b);
  lu_backward_rows<W>(fband, x, n, B, b);
}

template <int W>
__global__ void __launch_bounds__(kThreads)
lu_factor_kernel(const float* __restrict__ band, float* __restrict__ fband,
                 int n, int B, float clamp) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  lu_factor_rows<W, false>(band, fband, nullptr, nullptr, n, B, b, clamp);
}

inline dim3 grid_for(int B) { return dim3((B + kThreads - 1) / kThreads); }

}  // namespace

#define TC_FOR_EACH_W(X) \
  X(1) X(2) X(3) X(4) X(5) X(6) X(7) X(8) X(9) X(10) X(11) X(12)

extern "C" {

int tc_banded_lu_max_w() { return kMaxW; }

// Each entry point launches on the given stream and returns
// cudaGetLastError() (cudaErrorInvalidValue for an unsupported w).
int tc_banded_lu_factor_solve(int w, const float* band, const float* rhs,
                              float* fband, float* x, int n, int B,
                              float clamp, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (w) {
#define X(WW)                                                          \
  case WW:                                                             \
    lu_factor_solve_kernel<WW><<<grid_for(B), kThreads, 0, s>>>(       \
        band, rhs, fband, x, n, B, clamp);                             \
    break;
    TC_FOR_EACH_W(X)
#undef X
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

int tc_banded_lu_solve(int w, const float* fband, const float* rhs, float* x,
                       int n, int B, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (w) {
#define X(WW)                                                          \
  case WW:                                                             \
    lu_solve_kernel<WW><<<grid_for(B), kThreads, 0, s>>>(fband, rhs, x, n, B); \
    break;
    TC_FOR_EACH_W(X)
#undef X
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

int tc_banded_lu_factor(int w, const float* band, float* fband, int n, int B,
                        float clamp, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (w) {
#define X(WW)                                                          \
  case WW:                                                             \
    lu_factor_kernel<WW><<<grid_for(B), kThreads, 0, s>>>(band, fband, n, B, clamp); \
    break;
    TC_FOR_EACH_W(X)
#undef X
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

const char* tc_banded_lu_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
