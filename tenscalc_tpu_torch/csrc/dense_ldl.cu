// Dense unpivoted LDL^T for Hopper (sm_90a): K4 fleet factor, K5 fleet
// solve, K6 single factor, K7 single solve, K8 single factor+solve.
// Built with nvcc into a shared library with a plain C interface and
// bound with ctypes (tenscalc_tpu_torch/kkt/dense_ldl.py).
//
// Replaces the Pallas TPU kernels of tenscalc_tpu/kkt/fleet.py and
// tenscalc_tpu/kkt/pallas_ldl.py:
//   K4 tc_dense_ldl_fleet_factor  <- fleet.py      _fleet_factor_kernel (:68-113)
//   K5 tc_dense_ldl_fleet_solve   <- fleet.py      _fleet_solve_kernel  (:116-159)
//   K6 tc_dense_ldl_factor        <- pallas_ldl.py _ldl_kernel          (:42-105)
//   K7 tc_dense_ldl_solve         <- pallas_ldl.py _solve_kernel        (:108-137)
//   K8 tc_dense_ldl_factor_solve  <- pallas_ldl.py _factor_solve_kernel (:140-147)
//
// What is computed, per instance: the unpivoted LDL^T of a symmetric
// n x n matrix, pivots clamped (Cheng-Higham) d <- sign(d) max(|d|, clamp)
// with sign(0) = +, by n right-looking rank-1 steps.  Step c reads row c
// of the working matrix (row c == column c), forms r_k = M[c, k] / d_c for
// k > c and updates the trailing block M[i, k] (i, k > c).  Row c of the
// output holds column c of the unit-lower L: zeros before c, then at c
// the pivot (K4, the fleet layout) or 1 (K6/K8, Lt = L^T), then
// L[c+1.., c].  The solves run a forward scatter with L (row c of the
// factor times y_c), a division by d and a backward gather (a dot of row
// c with x).  Rows past n are masked, not padded.
//
// Arithmetic.  Each kernel keeps its TPU kernel's order: K4 updates
// M[i, k] -= (d_c * r_i) * r_k (fleet.py:104), K6 M[i, k] -= d_c * (r_i * r_k)
// (pallas_ldl.py:79-82), the forward sweeps x_i -= y_c * L[c, i], the
// backward sweeps x_c -= sum_{i>c} L[c, i] x_i.  The _rn intrinsics keep
// nvcc from contracting products and sums into fused multiply-adds.  The
// backward sums have a fixed tree: each thread of a group of T (a warp
// for K5, the CTA for K7/K8) adds the products of its indices i = tid
// (mod T) in increasing order, the warp then sums by butterfly (xor 16,
// 8, 4, 2, 1), and the warps' sums are added in warp order.  The plain
// PyTorch versions beside the wrappers form the same numbers in the same
// order, so the two agree to the last bit.  K6's 128-wide panels and
// MXU trailing GEMM exist for the TPU and are not copied: every step here
// is a rank-1 update, so for n > 128 K6 rounds differently from the TPU
// kernel (not from its plain version).
//
// Layout and what bounds each kernel.
//   K4: one CTA per instance, thread k owns column k (n <= 160 threads),
//       the matrix in shared memory (4 KB at n = 32, 100 KB at n = 160).
//       At the sls fleet (B = 1024, n = 32) it must move ~4.4 MB (1.3 us at
//       3.35 TB/s) and do ~22 MFLOP (0.3 us at 67 TFLOP/s): byte-bound on
//       paper, latency-bound in fact -- n dependent steps of two barriers
//       each, one warp per CTA.
//   K5: one warp per instance, four instances a CTA; x in shared memory,
//       the factor read row by row from global memory (a warp's load is
//       one contiguous row segment).  n dependent forward steps and n
//       dependent backward reductions: latency-bound.
//   K6/K7/K8: one CTA per instance (a grid of one on the single-instance
//       route), T = min(512, 32 ceil(n / 32)) threads, thread t owning
//       columns t, t + T, ...  The working matrix lives in shared memory
//       while it fits (n <= 240, 227 KB), else in place in the output Lt
//       in global memory, where it stays L2-resident (3.2 MB at n = 896).
//       K8 keeps the factor where K6 left it for the substitutions.  At
//       n = 32 these are pure latency (a few microseconds of barriers;
//       measured 36-58 us on an H100 80GB HBM3 at 700 W, PERF.md: ~1.5 us
//       a step of two barriers and a dependent shared-memory chain);
//       at n = 896 one SM does ~0.5 GFLOP in 896 dependent steps, each
//       thread streaming its columns' trailing rows through L2 in groups of
//       eight loads.

#include <cuda_runtime.h>
#include <math.h>

// The fleet's largest n and the K6-K8 block size cap are the binding's
// (kkt/dense_ldl.py), given on the compiler's command line.
#if !defined(TC_FLEET_MAX_N) || !defined(TC_MAX_THREADS)
#error "build with -DTC_FLEET_MAX_N=... -DTC_MAX_THREADS=... (kkt/dense_ldl.py)"
#endif

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kFleetMaxN = TC_FLEET_MAX_N;  // K4/K5: threads of K4, K5's x buffer
constexpr int kMaxThreads = TC_MAX_THREADS; // K6/K7/K8 (one block an SM in the
                                            // launch bounds: without it ptxas
                                            // caps K6 at 40 registers and spills)
constexpr int kSmemMaxN = 240;     // n (n + 1) + 32 floats within 227 KB
constexpr int kSolveWarps = 4;     // K5: instances (warps) per CTA
constexpr int kRowGroup = 8;       // K6/K8: trailing rows updated per batch of loads

__device__ __forceinline__ float clamp_pivot(float d, float clamp) {
  if (clamp > 0.0f) {
    const float sgn = d >= 0.0f ? 1.0f : -1.0f;
    const float a = fabsf(d);
    // keeps NaN (a comparison with NaN is false), as jnp.maximum does
    d = __fmul_rn(sgn, a < clamp ? clamp : a);
  }
  return d;
}

template <bool kWarp>
__device__ __forceinline__ void group_sync() {
  if (kWarp) {
    __syncwarp();
  } else {
    __syncthreads();
  }
}

// Solve (L diag(d) L^T) x = b for one instance by a group of T threads
// (one warp when kWarp, else the whole CTA).  Row c of Lr holds L[c+1.., c]
// at columns c+1..n-1 (its diagonal and lower part are never read).  xs
// (shared, n floats) holds b on entry and x on exit; red is shared scratch
// of T / 32 floats (unused when kWarp).
template <bool kWarp>
__device__ __forceinline__ void ldl_solve_rows(const float* Lr, const float* d,
                                               float* xs, float* red, int n,
                                               int tid, int T) {
  for (int c = 0; c < n; ++c) {
    const float yc = xs[c];
    for (int i = c + 1 + tid; i < n; i += T) {
      xs[i] = __fsub_rn(xs[i], __fmul_rn(yc, Lr[(size_t)c * n + i]));
    }
    group_sync<kWarp>();
  }
  for (int i = tid; i < n; i += T) xs[i] = __fdiv_rn(xs[i], d[i]);
  group_sync<kWarp>();
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nw = T >> 5;
  const int span = ((n + T - 1) / T) * T;
  for (int c = n - 1; c >= 0; --c) {
    float acc = 0.0f;
    for (int i = ((c + 1) / T) * T + tid; i < span; i += T) {
      const float p = (i > c && i < n) ? __fmul_rn(Lr[(size_t)c * n + i], xs[i]) : 0.0f;
      acc = __fadd_rn(acc, p);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      acc = __fadd_rn(acc, __shfl_xor_sync(kFull, acc, off));
    }
    float tot = 0.0f;
    if (kWarp) {
      tot = __fadd_rn(tot, acc);
    } else {
      if (lane == 0) red[warp] = acc;
      __syncthreads();
      for (int w = 0; w < nw; ++w) tot = __fadd_rn(tot, red[w]);
    }
    if (tid == 0) xs[c] = __fsub_rn(xs[c], tot);
    group_sync<kWarp>();
  }
}

// K6's elimination on the working matrix M (shared or global, leading
// dimension n) by the CTA.  On return row c of M holds Lt[c, :] (zeros
// before c, 1 at c, L[c+1.., c] after it), also written to Lt when M is
// not Lt itself; d holds the pivots.  r is shared scratch of n floats.
__device__ __forceinline__ void ldl_factor_rows(float* M, float* Lt, float* d,
                                                float* r, int n, float clamp,
                                                int tid, int T) {
  for (int c = 0; c < n; ++c) {
    const float dc = clamp_pivot(M[(size_t)c * n + c], clamp);
    for (int k = tid; k < n; k += T) {
      r[k] = k > c ? __fdiv_rn(M[(size_t)c * n + k], dc) : 0.0f;
    }
    if (tid == 0) d[c] = dc;
    __syncthreads();
    for (int k = tid; k < n; k += T) {
      const float v = k > c ? r[k] : (k == c ? 1.0f : 0.0f);
      M[(size_t)c * n + k] = v;
      if (Lt != M) Lt[(size_t)c * n + k] = v;
      if (k > c) {
        // rows in groups of kRowGroup: the loads of a group are issued
        // before its stores, which the compiler cannot reorder itself (M
        // and r may alias for all it knows); from global memory one row
        // at a time would wait a full L2 latency per element
        const float rk = r[k];
        int i = c + 1;
        for (; i + kRowGroup <= n; i += kRowGroup) {
          float m[kRowGroup], ri[kRowGroup];
#pragma unroll
          for (int u = 0; u < kRowGroup; ++u) {
            m[u] = M[(size_t)(i + u) * n + k];
            ri[u] = r[i + u];
          }
#pragma unroll
          for (int u = 0; u < kRowGroup; ++u) {
            M[(size_t)(i + u) * n + k] =
                __fsub_rn(m[u], __fmul_rn(dc, __fmul_rn(ri[u], rk)));
          }
        }
        for (; i < n; ++i) {
          float* m = M + (size_t)i * n + k;
          *m = __fsub_rn(*m, __fmul_rn(dc, __fmul_rn(r[i], rk)));
        }
      }
    }
    __syncthreads();
  }
}

// K4: thread k owns column k of one instance's matrix in shared memory.
__global__ void __launch_bounds__(kFleetMaxN)
fleet_factor_kernel(const float* __restrict__ A, float* __restrict__ L,
                    float* __restrict__ d, int n, float clamp) {
  extern __shared__ float smem[];
  float* M = smem;          // n * n
  float* r = smem + n * n;  // n
  const int k = threadIdx.x;
  const size_t nn = (size_t)n * n;
  const size_t base = (size_t)blockIdx.x * nn;
  for (size_t idx = k; idx < nn; idx += blockDim.x) M[idx] = A[base + idx];
  __syncthreads();
  for (int j = 0; j < n; ++j) {
    const float dj = clamp_pivot(M[j * n + j], clamp);
    float rk = 0.0f;
    if (k < n) {
      if (k > j) rk = __fdiv_rn(M[j * n + k], dj);
      r[k] = rk;
      L[base + (size_t)j * n + k] = k > j ? rk : (k == j ? dj : 0.0f);
    }
    if (k == 0) d[(size_t)blockIdx.x * n + j] = dj;
    __syncthreads();
    if (k > j && k < n) {
      for (int i = j + 1; i < n; ++i) {
        M[i * n + k] = __fsub_rn(M[i * n + k], __fmul_rn(__fmul_rn(dj, r[i]), rk));
      }
    }
    __syncthreads();
  }
}

// K5: one warp per instance against K4's factor (the pivot copy on the
// diagonal is never read).
__global__ void __launch_bounds__(kSolveWarps * 32)
fleet_solve_kernel(const float* __restrict__ L, const float* __restrict__ d,
                   const float* __restrict__ rhs, float* __restrict__ x,
                   int n, int B) {
  __shared__ float xs_all[kSolveWarps][kFleetMaxN];
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kSolveWarps + (threadIdx.x >> 5);
  if (b >= B) return;  // the whole warp: only warp barriers below
  float* xs = xs_all[threadIdx.x >> 5];
  const size_t vb = (size_t)b * n;
  for (int i = lane; i < n; i += 32) xs[i] = rhs[vb + i];
  __syncwarp();
  ldl_solve_rows<true>(L + vb * n, d + vb, xs, nullptr, n, lane, 32);
  for (int i = lane; i < n; i += 32) x[vb + i] = xs[i];
}

// K6: one CTA per instance; the working matrix in shared memory when
// in_smem, else in place in Lt.
__global__ void __launch_bounds__(kMaxThreads, 1)
ldl_factor_kernel(const float* __restrict__ A, float* Lt, float* __restrict__ d,
                  int n, float clamp, int in_smem) {
  extern __shared__ float smem[];
  const size_t nn = (size_t)n * n;
  float* Ltb = Lt + blockIdx.x * nn;
  float* M = in_smem ? smem : Ltb;
  float* r = in_smem ? smem + nn : smem;
  for (size_t idx = threadIdx.x; idx < nn; idx += blockDim.x) {
    M[idx] = A[blockIdx.x * nn + idx];
  }
  __syncthreads();
  ldl_factor_rows(M, Ltb, d + (size_t)blockIdx.x * n, r, n, clamp,
                  threadIdx.x, blockDim.x);
}

// K7: one CTA per instance against K6's factor Lt.
__global__ void __launch_bounds__(kMaxThreads, 1)
ldl_solve_kernel(const float* __restrict__ Lt, const float* __restrict__ d,
                 const float* __restrict__ rhs, float* __restrict__ x, int n) {
  extern __shared__ float smem[];
  float* xs = smem;      // n
  float* red = smem + n; // 32
  const size_t vb = (size_t)blockIdx.x * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) xs[i] = rhs[vb + i];
  __syncthreads();
  ldl_solve_rows<false>(Lt + vb * n, d + vb, xs, red, n, threadIdx.x, blockDim.x);
  for (int i = threadIdx.x; i < n; i += blockDim.x) x[vb + i] = xs[i];
}

// K8: K6 then K7 in one launch, the substitutions reading the factor where
// the elimination left it (shared memory when it fits).
__global__ void __launch_bounds__(kMaxThreads, 1)
ldl_factor_solve_kernel(const float* __restrict__ A, const float* __restrict__ rhs,
                        float* Lt, float* d, float* __restrict__ x,
                        int n, float clamp, int in_smem) {
  extern __shared__ float smem[];
  const size_t nn = (size_t)n * n;
  const size_t vb = (size_t)blockIdx.x * n;
  float* Ltb = Lt + blockIdx.x * nn;
  float* M = in_smem ? smem : Ltb;
  float* r = in_smem ? smem + nn : smem;  // n floats, then 32 for red
  for (size_t idx = threadIdx.x; idx < nn; idx += blockDim.x) {
    M[idx] = A[blockIdx.x * nn + idx];
  }
  __syncthreads();
  ldl_factor_rows(M, Ltb, d + vb, r, n, clamp, threadIdx.x, blockDim.x);
  float* xs = r;
  for (int i = threadIdx.x; i < n; i += blockDim.x) xs[i] = rhs[vb + i];
  __syncthreads();
  ldl_solve_rows<false>(M, d + vb, xs, r + n, n, threadIdx.x, blockDim.x);
  for (int i = threadIdx.x; i < n; i += blockDim.x) x[vb + i] = xs[i];
}

bool valid_threads(int threads) {
  return threads >= 32 && threads <= kMaxThreads && threads % 32 == 0;
}

size_t fleet_smem(int n) { return sizeof(float) * ((size_t)n * n + n); }

size_t single_smem(int n, bool in_smem) {
  return sizeof(float) * ((in_smem ? (size_t)n * n : 0) + n + 32);
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace

extern "C" {

// Once per device, before the first launch: the opt-in to dynamic shared
// memory above the 48 KB default, at the most each kernel can ask for.
int tc_dense_ldl_init() {
  cudaError_t e = allow_smem(fleet_factor_kernel, fleet_smem(kFleetMaxN));
  if (e == cudaSuccess) e = allow_smem(ldl_factor_kernel, single_smem(kSmemMaxN, true));
  if (e == cudaSuccess) {
    e = allow_smem(ldl_factor_solve_kernel, single_smem(kSmemMaxN, true));
  }
  return e;
}

// Each entry point launches on the given stream and returns
// cudaGetLastError() (cudaErrorInvalidValue for an unsupported shape).
int tc_dense_ldl_fleet_factor(const float* A, float* L, float* d, int n, int B,
                              float clamp, void* stream) {
  if (n < 1 || n > kFleetMaxN || B < 1) return cudaErrorInvalidValue;
  const int threads = ((n + 31) / 32) * 32;
  const size_t smem = fleet_smem(n);
  fleet_factor_kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      A, L, d, n, clamp);
  return cudaGetLastError();
}

int tc_dense_ldl_fleet_solve(const float* L, const float* d, const float* rhs,
                             float* x, int n, int B, void* stream) {
  if (n < 1 || n > kFleetMaxN || B < 1) return cudaErrorInvalidValue;
  const int grid = (B + kSolveWarps - 1) / kSolveWarps;
  fleet_solve_kernel<<<grid, kSolveWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      L, d, rhs, x, n, B);
  return cudaGetLastError();
}

int tc_dense_ldl_factor(const float* A, float* Lt, float* d, int n, int B,
                        int threads, float clamp, void* stream) {
  if (n < 1 || B < 1 || !valid_threads(threads)) {
    return cudaErrorInvalidValue;
  }
  const bool in_smem = n <= kSmemMaxN;
  const size_t smem = single_smem(n, in_smem);
  ldl_factor_kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      A, Lt, d, n, clamp, in_smem ? 1 : 0);
  return cudaGetLastError();
}

int tc_dense_ldl_solve(const float* Lt, const float* d, const float* rhs, float* x,
                       int n, int B, int threads, void* stream) {
  if (n < 1 || B < 1 || !valid_threads(threads)) {
    return cudaErrorInvalidValue;
  }
  ldl_solve_kernel<<<B, threads, single_smem(n, false),
                     static_cast<cudaStream_t>(stream)>>>(Lt, d, rhs, x, n);
  return cudaGetLastError();
}

int tc_dense_ldl_factor_solve(const float* A, const float* rhs, float* Lt, float* d,
                              float* x, int n, int B, int threads, float clamp,
                              void* stream) {
  if (n < 1 || B < 1 || !valid_threads(threads)) {
    return cudaErrorInvalidValue;
  }
  const bool in_smem = n <= kSmemMaxN;
  const size_t smem = single_smem(n, in_smem);
  ldl_factor_solve_kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      A, rhs, Lt, d, x, n, clamp, in_smem ? 1 : 0);
  return cudaGetLastError();
}

const char* tc_dense_ldl_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
