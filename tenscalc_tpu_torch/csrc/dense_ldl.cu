// Dense unpivoted LDL^T for Hopper (sm_90a): K4 fleet factor, K5 fleet
// solve, K6 single factor, K7 single solve, K8 single factor+solve.
// Built with nvcc into a shared library with a plain C interface and
// bound with ctypes (tenscalc_tpu_torch/kkt/dense_ldl.py).
//
// Replaces the Pallas TPU kernels of tenscalc_tpu/kkt/fleet.py and
// tenscalc_tpu/kkt/pallas_ldl.py:
//   K4 tc_dense_ldl_fleet_factor  <- fleet.py      _fleet_factor_kernel (:68-113)
//   K5 tc_dense_ldl_warp_solve    <- fleet.py      _fleet_solve_kernel  (:116-159)
//   K6 tc_dense_ldl_factor        <- pallas_ldl.py _ldl_kernel          (:42-105)
//   K7 tc_dense_ldl_warp_solve (n <= 32), tc_dense_ldl_solve (n > 32)
//                                 <- pallas_ldl.py _solve_kernel        (:108-137)
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
// c with x); they never read the diagonal, so one solve serves both
// layouts.  Rows past n are masked, not padded.
//
// Arithmetic.  Each kernel keeps its TPU kernel's order: K4 updates
// M[i, k] -= (d_c * r_i) * r_k (fleet.py:104), K6 M[i, k] -= d_c * (r_i * r_k)
// (pallas_ldl.py:79-82), the forward sweeps x_i -= y_c * L[c, i], the
// backward sweeps x_c -= sum_{i>c} L[c, i] x_i.  The _rn intrinsics keep
// nvcc from contracting products and sums into fused multiply-adds.  The
// backward sums have a fixed tree: each thread of a group of T (a warp
// for the warp solve, the CTA for K7/K8 above n = 32) adds the products
// of its indices i = tid (mod T) in increasing order, the warp then sums
// by butterfly (xor 16, 8, 4, 2, 1), and the warps' sums are added in
// warp order to 0.  The plain PyTorch versions beside the wrappers form
// the same numbers in the same order, so the two agree to the last bit.
// K6's 128-wide panels and MXU trailing GEMM exist for the TPU and are
// not copied: every step here is a rank-1 update, so for n > 128 K6
// rounds differently from the TPU kernel (not from its plain version).
//
// Layout and what bounds each kernel.
//   K4: a CTA of one warp an instance, lane l owning column k = 32 p + l
//       of panel p of the upper triangle.  At the sls fleet (B = 1024,
//       n = 32) it must move ~4.4 MB (1.3 us at 3.35 TB/s) and do ~22
//       MFLOP (0.3 us at 67 TFLOP/s); its n dependent steps make it
//       latency-bound unless the steps carry no barrier.  Registers route
//       (n <= 32): the warp factor below, in K4's rounding order.  Blocked
//       route (32 < n <= 160): the panels in order, each in 32-row blocks,
//       left-looking across blocks and right-looking inside one.  Block q
//       of column k is loaded into registers, then takes the updates of
//       every earlier step j < 32 q in increasing j (delayed updates:
//       W[i, j] = d_j L[i, j] read as float4 broadcasts from shared
//       memory, L[k, j] the lane's own), then its own 32 steps: the warp
//       factor's, by shuffles, on the diagonal block; on a block above it
//       the pivots and W are known, so only divisions and updates.  Every
//       element M[i, k] (i <= k) thus takes its subtractions in the plain
//       version's order, j = 0 .. i - 1, and the same bits.  A finished
//       block goes to the factor (coalesced rows) and to shared memory,
//       where L and W are packed upper triangles with rows padded to 16
//       bytes (27 KB at n = 80: eight CTAs an SM; 106 KB at n = 160: two).
//       The delayed updates, two FP32 operations and 1/8 of a broadcast
//       load each on 32 independent chains a lane, are issue-bound.
//   K5, and K7 at n <= 32 (the warp solve): one warp per instance and a
//       CTA per warp (two warps a CTA time within ~5% of one on an H100,
//       PERF.md; kkt/dense_ldl.py's solve_plan).  The work is n
//       dependent steps each way, so it is bound by latency; the design
//       keeps memory off that chain.  Lane i keeps x_i, x_{i+32}, ... in
//       registers.  At n <= 32 (the registers route) lane i also keeps
//       column i of the stored rows, L[c, i] for c < i, filled by n
//       independent coalesced row loads before the first step; above 32
//       (the staged route) the rows are copied into shared memory by
//       cp.async (the whole instance fits: 102,400 bytes at n = 160, two
//       CTAs an SM, one wave at every fleet shape), and the loop over a
//       chunk's 32 steps is unrolled four times, not fully.  A forward step is one shuffle
//       (y_c from lane c), a product and a subtraction.  A backward
//       step's butterfly runs on the terms of row c with x_{c+1} as it
//       was before its own step; what each lane receives does not
//       contain its own term, so the lane that owns x_{c+1} finishes the
//       sum with its new term and five additions, and one shuffle hands
//       the total to the lane of x_c.  The butterflies run a step ahead
//       of the chain, which is then ~8 dependent operations a step
//       instead of five shuffles.  At n = 32 the sweeps take ~2.3 us of
//       ~8.8 (H100, PERF.md); the rest is the launch and the loads and
//       stores of b, d and x.
//   K6 and K8 at n <= 32 (the warp factor): a CTA of one warp an
//       instance, lane k holding column k of the upper triangle, M[i, k]
//       for i <= k, in registers, filled by n coalesced row loads before
//       the first step (the lower triangle is not read).  The factor is n
//       dependent steps, so it is bound by latency: no block barrier and no
//       shared memory; the pivot and each r_i reach the lanes by shuffles,
//       and the chain of a step runs through the next pivot's own lane (its
//       r without a shuffle: the pivot's shuffle, the clamp, the division,
//       two products and a subtraction).  The steps are fully unrolled and
//       every lane runs every update (a predicate a row cost more than the
//       rows below the diagonal).  Step c leaves
//       L[k, c] in the register of row c, so the columns end as the warp
//       solve's RegFactor and K8 hands them to it without a reload; Lt and
//       d are written by n coalesced row stores.
//       dense_ldl_ablation.py times each of these choices undone.
//   K6/K7/K8 above n = 32: one CTA per instance, T = min(512,
//       32 ceil(n / 32)) threads, thread t owning columns t, t + T, ...
//       The working matrix lives in shared memory while it fits (n <= 240,
//       227 KB), else in place in the output Lt in global memory, where it
//       stays L2-resident (3.2 MB at n = 896).  K8 keeps the factor where
//       K6 left it for the substitutions.  At n = 896 one SM does ~0.5
//       GFLOP in 896 dependent steps, each thread streaming its columns'
//       trailing rows through L2 in groups of eight loads.

#include <cuda_runtime.h>
#include <math.h>

// The fleet's largest n, the K6-K8 block size cap and the shared memory
// a block can opt into are the binding's (kkt/dense_ldl.py), given on the
// compiler's command line.
#if !defined(TC_FLEET_MAX_N) || !defined(TC_MAX_THREADS) || !defined(TC_DENSE_SMEM_MAX)
#error "build with -DTC_FLEET_MAX_N=... -DTC_MAX_THREADS=... -DTC_DENSE_SMEM_MAX=... (kkt/dense_ldl.py)"
#endif

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kFleetMaxN = TC_FLEET_MAX_N;  // K4's and the warp solve's n
constexpr int kMaxThreads = TC_MAX_THREADS; // K6/K7/K8 (one block an SM in the
                                            // launch bounds: without it ptxas
                                            // caps K6 at 40 registers and spills)
constexpr size_t kSmemCap = TC_DENSE_SMEM_MAX;  // a block's opt-in cap
constexpr int kSmemMaxN = 240;     // n (n + 1) + 32 floats within the cap
static_assert(sizeof(float) * (kSmemMaxN * (kSmemMaxN + 1) + 32) <= kSmemCap,
              "K6/K8's working matrix must fit the shared-memory cap");
static_assert(sizeof(float) * kFleetMaxN * kFleetMaxN <= kSmemCap,
              "the warp solve's staged instance must fit the shared-memory cap");
// K4's blocked route: an instance's shared memory holds L and W = d L as
// packed upper triangles (row j from column 4 floor(j / 4) to n rounded up
// to 4, so each row and each 32-column block of it starts on 16 bytes),
// then d, then 32 floats the reads of the last panel's columns past n may
// run into.  panel_tri(n) is a triangle's floats, the offset of row n.
__host__ __device__ constexpr int panel_tri(int n) {
  return n * (4 * ((n + 3) / 4)) - 8 * (n / 4) * (n / 4 - 1) - 4 * (n / 4) * (n % 4);
}
__host__ __device__ constexpr size_t fleet_smem(int n) {
  return sizeof(float) * (2 * (size_t)panel_tri(n) + n + 32);
}
static_assert(fleet_smem(kFleetMaxN) <= kSmemCap,
              "K4's blocked route must fit the shared-memory cap");
constexpr int kRowGroup = 8;       // K6/K8: trailing rows updated per batch of loads
constexpr int kStagedUnroll = 4;  // see StepUnroll

__device__ __forceinline__ float clamp_pivot(float d, float clamp) {
  if (clamp > 0.0f) {
    const float sgn = d >= 0.0f ? 1.0f : -1.0f;
    const float a = fabsf(d);
    // keeps NaN (a comparison with NaN is false), as jnp.maximum does
    d = __fmul_rn(sgn, a < clamp ? clamp : a);
  }
  return d;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The factor as the warp solve reads it: at(c, k) is row c of the factor
// at column lane + 32 k, read only where that column is below n.
//
// Registers route (n <= 32): lane i's column of the stored rows, L[c, i]
// for c < i (0 elsewhere), loaded before the first step.
struct RegFactor {
  float l[32];
  __device__ __forceinline__ void load(const float* __restrict__ F, int n, int lane) {
#pragma unroll
    for (int c = 0; c < 32; ++c) l[c] = (lane > c && lane < n) ? F[c * n + lane] : 0.0f;
  }
  __device__ __forceinline__ float at(int c, int) const { return l[c]; }
  __device__ __forceinline__ void wait() const {}
};

// Staged route (32 < n <= 160): the instance's rows in shared memory (n x
// n floats; only the entries past each row's diagonal are copied).  The copies are in flight while b and d load; the forward
// sweep waits for all of them (waiting a chunk of 32 rows at a time
// measured the same, dense_ldl_ablation.py in PERF.md).
struct SmemFactor {
  float* s;
  int n, lane;
  __device__ __forceinline__ void stage(const float* __restrict__ F) const {
    for (int r = 0; r < n - 1; ++r) {
      for (int i = r + 1 + lane; i < n; i += 32) cp_async4(s + r * n + i, F + r * n + i);
    }
  }
  __device__ __forceinline__ float at(int c, int k) const { return s[c * n + lane + 32 * k]; }
  __device__ __forceinline__ void wait() const {
    cp_async_wait_all();
    __syncwarp();
  }
};

// Steps a warp solve's loop over the 32 rows of a chunk unrolls: all on
// the registers route (its factor columns are registers, indexed by the
// step), kStagedUnroll on the staged route, whose fully unrolled sweeps
// (~190 steps at n = 80) would not fit the instruction cache.
template <int NC>
struct StepUnroll {
  static constexpr int value = NC == 1 ? 32 : kStagedUnroll;
};

// Solve (L diag(d) L^T) x = b for one instance by one warp.  x holds b on
// entry (0 past n) and x on exit; lane i holds x_{i+32k} in x[k] and
// d_{i+32k} in dv[k] (1 past n).  The loops over chunks are unrolled, so
// the arrays are registers.
template <int NC, class Factor>
__device__ __forceinline__ void warp_solve(float (&x)[NC], const float (&dv)[NC],
                                           const Factor& lf, int n, int lane) {
  // forward: y_c from lane c, then x_i -= y_c L[c, i] for c < i < n
  lf.wait();
#pragma unroll
  for (int kc = 0; kc < NC; ++kc) {
#pragma unroll (StepUnroll<NC>::value)
    for (int cc = 0; cc < 32; ++cc) {
      const int c = 32 * kc + cc;
      const float y = __shfl_sync(kFull, x[kc], cc);
#pragma unroll
      for (int k = kc; k < NC; ++k) {
        const int i = lane + 32 * k;
        if (i > c && i < n) x[k] = __fsub_rn(x[k], __fmul_rn(y, lf.at(c, k)));
      }
    }
  }
#pragma unroll
  for (int k = 0; k < NC; ++k) {
    if (lane + 32 * k < n) x[k] = __fdiv_rn(x[k], dv[k]);
  }
  // backward: x_c -= sum_{i>c} L[c, i] x_i.  The plain version adds each
  // lane's terms to 0 and the total to 0; the terms here start without
  // the 0: that changes only the sign of a zero inside the tree, and the
  // total's own 0 + makes every zero +0 again.  The top step has no terms.
  float xprev = x[NC - 1];  // x[ko] as it was before the last step's update
#pragma unroll
  for (int kc = NC - 1; kc >= 0; --kc) {
#pragma unroll (StepUnroll<NC>::value)
    for (int cc = 31; cc >= 0; --cc) {
      const int c = 32 * kc + cc;
      if (c == 32 * NC - 1) continue;
      // x_{c+1}, finished by the last step, lives in lane lo, chunk ko
      const int ko = (c + 1) >> 5, lo = (c + 1) & 31;
      float stale = 0.0f, own = 0.0f;
#pragma unroll
      for (int k = kc; k < NC; ++k) {
        const int i = lane + 32 * k;
        const bool term = i > c && i < n;
        const float l = term ? lf.at(c, k) : 0.0f;  // rows past n are not read
        // the term with x[ko] from before its update, selected to 0 (never
        // 0 * x) at columns <= c or >= n
        const float xo = k == ko ? xprev : x[k];
        const float p = term ? __fmul_rn(l, xo) : 0.0f;
        stale = k == kc ? p : __fadd_rn(stale, p);
        // lane lo's own sum from column c+1 on (its columns before are
        // <= c); l and x are 0 past n
        if (k == ko) own = __fmul_rn(l, x[k]);
        if (k > ko) own = __fadd_rn(own, p);
      }
      // step c's butterfly on the stale terms: what a lane receives holds
      // no term of its own, so lane lo adds it to its own sum
      float v = stale;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float r = __shfl_xor_sync(kFull, v, off);
        v = __fadd_rn(v, r);
        own = __fadd_rn(own, r);
      }
      const float tot = __shfl_sync(kFull, __fadd_rn(0.0f, own), lo);
      xprev = x[kc];
      if (lane == cc) x[kc] = __fsub_rn(x[kc], tot);
    }
  }
}

// Load an instance's b and d into the warp solve's registers.
template <int NC>
__device__ __forceinline__ void load_vectors(float (&x)[NC], float (&dv)[NC],
                                             const float* rhs, const float* d,
                                             int n, int lane) {
#pragma unroll
  for (int k = 0; k < NC; ++k) {
    const int i = lane + 32 * k;
    x[k] = i < n ? rhs[i] : 0.0f;
    dv[k] = i < n ? d[i] : 1.0f;
  }
}

template <int NC>
__device__ __forceinline__ void store_x(float* out, const float (&x)[NC], int n, int lane) {
#pragma unroll
  for (int k = 0; k < NC; ++k) {
    if (lane + 32 * k < n) out[lane + 32 * k] = x[k];
  }
}

// The rank-1 update of a factor step, in its TPU kernel's rounding order.
enum class Rank1 {
  kPivotTimesProduct,  // K6: M[i, k] - d_c (r_i r_k)   (pallas_ldl.py:79-82)
  kScaledRowTimesR,    // K4: M[i, k] - (d_c r_i) r_k   (fleet.py:104)
};

template <Rank1 U>
__device__ __forceinline__ float rank1(float m, float dc, float ri, float rk) {
  if constexpr (U == Rank1::kPivotTimesProduct) {
    return __fsub_rn(m, __fmul_rn(dc, __fmul_rn(ri, rk)));
  } else {
    return __fsub_rn(m, __fmul_rn(__fmul_rn(dc, ri), rk));
  }
}

// Rows 32 q .. 32 q + 31 of column k of the upper triangle, A[i, k] for
// i <= k < n (0 elsewhere).
__device__ __forceinline__ void load_block(float (&m)[32], const float* __restrict__ A,
                                           int n, int q, int k) {
#pragma unroll
  for (int t = 0; t < 32; ++t) {
    const int i = 32 * q + t;
    m[t] = (i <= k && k < n) ? A[i * n + k] : 0.0f;
  }
}

// The steps of the unpivoted LDL^T of an n x n block (n <= 32) by one
// warp, in registers: lane k holds column k of the block's upper triangle.
// Step c takes d_c from lane c, clamps it, forms r_k = M[c, k] / d_c,
// keeps it in m[c] and updates m[i] for i > c with r_i from lane i.  Every
// lane runs every update (a warp issues them for all its lanes in any
// case): rows below a lane's diagonal and lanes past n hold values nothing
// reads.  On return lane k holds L[k, c] in m[c] for c < k (the rest is
// not defined) and its pivot in dk (1 past n).
template <Rank1 U>
__device__ __forceinline__ void warp_factor_steps(float (&m)[32], float& dk, int n,
                                                  int lane, float clamp) {
  dk = 1.0f;
  float piv = __shfl_sync(kFull, m[0], 0);  // M[c, c], from lane c
#pragma unroll
  for (int c = 0; c < 32; ++c) {
    if (c >= n) break;
    const float dc = clamp_pivot(piv, clamp);
    const float rk = __fdiv_rn(m[c], dc);
    m[c] = rk;
    if (lane == c) dk = dc;
    if (c + 1 < 32) {
      // the next pivot from lane c+1's own r, so no shuffle of r is on
      // the chain from one step to the next
      piv = __shfl_sync(kFull, rank1<U>(m[c + 1], dc, rk, rk), c + 1);
    }
#pragma unroll
    for (int i = c + 1; i < 32; ++i) {
      m[i] = rank1<U>(m[i], dc, __shfl_sync(kFull, rk, i), rk);
    }
  }
}

// The warp factor of one instance (n <= 32): lane k loads column k of the
// upper triangle and runs the n steps.
template <Rank1 U>
__device__ __forceinline__ void warp_factor(float (&m)[32], float& dk,
                                            const float* __restrict__ A, int n,
                                            int lane, float clamp) {
  load_block(m, A, n, 0, lane);
  warp_factor_steps<U>(m, dk, n, lane, clamp);
}

// Row c of the stored factor at lane k < n: 0 before the diagonal, then the
// pivot (K4's layout) or 1 (K6's Lt), then L[k, c]; and d.
template <bool kPivotOnDiagonal>
__device__ __forceinline__ void store_warp_factor(float* __restrict__ F,
                                                  float* __restrict__ d,
                                                  const float (&m)[32], float dk,
                                                  int n, int lane) {
  if (lane >= n) return;
#pragma unroll
  for (int c = 0; c < 32; ++c) {
    if (c >= n) break;
    F[c * n + lane] = c < lane ? m[c] : (c == lane ? (kPivotOnDiagonal ? dk : 1.0f) : 0.0f);
  }
  d[lane] = dk;
}

// K4's blocked route: an instance's finished L, W = d L and d in shared
// memory (the layout of panel_tri).  L[k, j] and W[k, j] sit at row j,
// column k > j, as the factor stores them.
struct PanelSmem {
  float* L;
  float* W;
  float* d;
  int n4;  // n rounded up to 4
  __device__ __forceinline__ PanelSmem(float* s, int n)
      : L(s), W(s + panel_tri(n)), d(s + 2 * panel_tri(n)), n4(4 * ((n + 3) / 4)) {}
  // row j's column c (c >= 4 floor(j / 4)) in a triangle
  __device__ __forceinline__ int at(int j, int c) const {
    const int a = j >> 2;
    return j * n4 - 8 * a * (a - 1) - 4 * a * (j & 3) + c - 4 * a;
  }
};

// W[c .. c + 3, j] at offset off of the W triangle: a broadcast, every lane
// reads the same 16 bytes (j is for dense_ldl_ablation.py's variant that
// forms W from L and d[j] here).
__device__ __forceinline__ float4 w4(const PanelSmem& s, int j, int off) {
  return *reinterpret_cast<const float4*>(s.W + off);
}

// The updates of steps 0 .. 32 q - 1 on block q of lane k's column, in
// increasing step order: m[t] -= W[32 q + t, j] L[k, j].  Two steps a trip,
// so the next step's loads are in flight during this one's updates.
__device__ __forceinline__ void delayed_updates(float (&m)[32], const PanelSmem& s, int q,
                                                int k) {
#pragma unroll 2
  for (int j = 0; j < 32 * q; ++j) {
    const float lk = s.L[s.at(j, k)];
    const int off = s.at(j, 32 * q);
#pragma unroll
    for (int g = 0; g < 8; ++g) {
      const float4 w = w4(s, j, off + 4 * g);
      m[4 * g] = __fsub_rn(m[4 * g], __fmul_rn(w.x, lk));
      m[4 * g + 1] = __fsub_rn(m[4 * g + 1], __fmul_rn(w.y, lk));
      m[4 * g + 2] = __fsub_rn(m[4 * g + 2], __fmul_rn(w.z, lk));
      m[4 * g + 3] = __fsub_rn(m[4 * g + 3], __fmul_rn(w.w, lk));
    }
  }
}

// Steps 32 q .. 32 q + 31 on a block above the lane's diagonal block: the
// pivots and W are known, so a step divides and updates the rows below it;
// m[c] becomes L[k, 32 q + c].  A warp barrier ends each step: without it
// ptxas hoists the W loads of all 32 steps (255 registers, ~1 KB spilled).
__device__ __forceinline__ void block_steps(float (&m)[32], const PanelSmem& s, int q) {
#pragma unroll
  for (int c = 0; c < 32; ++c) {
    const int j = 32 * q + c;
    const float rk = __fdiv_rn(m[c], s.d[j]);
    m[c] = rk;
    const int off = s.at(j, 32 * q);
#pragma unroll
    for (int g = (c + 1) / 4; g < 8; ++g) {
      const float4 w = w4(s, j, off + 4 * g);
      const float wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (4 * g + e > c) m[4 * g + e] = __fsub_rn(m[4 * g + e], __fmul_rn(wv[e], rk));
      }
    }
    __syncwarp();
  }
}

// A finished block above the diagonal block of column k < n: rows 32 q ..
// 32 q + 31 of the factor (a coalesced store a row), and L and W.
__device__ __forceinline__ void publish_block(float* __restrict__ L, const PanelSmem& s,
                                              const float (&m)[32], int n, int q, int k) {
  if (k >= n) return;
#pragma unroll
  for (int t = 0; t < 32; ++t) {
    const int j = 32 * q + t;
    const int o = s.at(j, k);
    L[j * n + k] = m[t];
    s.L[o] = m[t];
    s.W[o] = __fmul_rn(s.d[j], m[t]);
  }
}

// A finished diagonal block of panel p: the pivots to d (global and
// shared), then column k's rows 32 p .. n - 1 of the factor (L[k, j] before
// the diagonal, the pivot on it, 0 after), and L and W.
__device__ __forceinline__ void publish_diagonal(float* __restrict__ L, float* __restrict__ d,
                                                 const PanelSmem& s, const float (&m)[32],
                                                 float dk, int n, int p, int lane) {
  const int k = 32 * p + lane;
  if (k < n) s.d[k] = dk;
  __syncwarp();
  if (k >= n) return;
  d[k] = dk;
#pragma unroll
  for (int t = 0; t < 32; ++t) {
    const int j = 32 * p + t;
    if (j >= n) break;
    L[j * n + k] = t < lane ? m[t] : (t == lane ? dk : 0.0f);
    if (t < lane) {
      const int o = s.at(j, k);
      s.L[o] = m[t];
      s.W[o] = __fmul_rn(s.d[j], m[t]);
    }
  }
  for (int j = 32 * (p + 1); j < n; ++j) L[j * n + k] = 0.0f;
}

// Block q of panel p (lane k = 32 p + lane's column): loaded, its delayed
// updates, its steps (the warp factor's on the diagonal block), published.
template <bool kDiagonal>
__device__ __forceinline__ void panel_block(float (&m)[32], float& dk,
                                            const float* __restrict__ A,
                                            float* __restrict__ L, float* __restrict__ d,
                                            const PanelSmem& s, int n, int p, int q,
                                            int lane, float clamp) {
  const int k = 32 * p + lane;
  load_block(m, A, n, q, k);
  delayed_updates(m, s, q, k);
  if constexpr (kDiagonal) {
    warp_factor_steps<Rank1::kScaledRowTimesR>(m, dk, n - 32 * p, lane, clamp);
    publish_diagonal(L, d, s, m, dk, n, p, lane);
  } else {
    block_steps(m, s, q);
    publish_block(L, s, m, n, q, k);
  }
}

// Solve (L diag(d) L^T) x = b for one instance by a group of T threads (the
// CTA).  Row c of Lr holds L[c+1.., c] at columns c+1..n-1 (its diagonal
// and lower part are never read).  xs (shared, n floats) holds b on entry
// and x on exit; red is shared scratch of T / 32 floats.
__device__ __forceinline__ void ldl_solve_rows(const float* Lr, const float* d,
                                               float* xs, float* red, int n,
                                               int tid, int T) {
  for (int c = 0; c < n; ++c) {
    const float yc = xs[c];
    for (int i = c + 1 + tid; i < n; i += T) {
      xs[i] = __fsub_rn(xs[i], __fmul_rn(yc, Lr[(size_t)c * n + i]));
    }
    __syncthreads();
  }
  for (int i = tid; i < n; i += T) xs[i] = __fdiv_rn(xs[i], d[i]);
  __syncthreads();
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
    if (lane == 0) red[warp] = acc;
    __syncthreads();
    float tot = 0.0f;
    for (int w = 0; w < nw; ++w) tot = __fadd_rn(tot, red[w]);
    if (tid == 0) xs[c] = __fsub_rn(xs[c], tot);
    __syncthreads();
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

// K4: a CTA of one warp an instance; P = ceil(n / 32) panels (1: the
// registers route, the warp factor in K4's order; 2-5: the blocked route,
// fleet_smem(n) bytes of dynamic shared memory).  The launch bound of 64
// threads as the other warp kernels'.
template <int P>
__global__ void __launch_bounds__(64)
fleet_factor_kernel(const float* __restrict__ A, float* __restrict__ L,
                    float* __restrict__ d, int n, float clamp) {
  const int lane = threadIdx.x;
  const size_t nn = (size_t)n * n;
  A += blockIdx.x * nn;
  L += blockIdx.x * nn;
  d += (size_t)blockIdx.x * n;
  float m[32], dk;
  if constexpr (P == 1) {
    warp_factor<Rank1::kScaledRowTimesR>(m, dk, A, n, lane, clamp);
    store_warp_factor<true>(L, d, m, dk, n, lane);
  } else {
    extern __shared__ float smem[];
    const PanelSmem s(smem, n);
#pragma unroll 1
    for (int p = 0; p < P; ++p) {
#pragma unroll 1
      for (int q = 0; q < p; ++q) {
        panel_block<false>(m, dk, A, L, d, s, n, p, q, lane, clamp);
      }
      __syncwarp();  // the panel's W above its diagonal block, for every lane
      panel_block<true>(m, dk, A, L, d, s, n, p, p, lane, clamp);
      __syncwarp();  // the panel's W and d, for the next
    }
  }
}

// K5, and K7 at n <= 32: a CTA of one warp per instance against a factor
// in either layout; NC = ceil(n / 32) entries of x a lane (1: the
// registers route, 2-5: the staged route, n * n floats of dynamic shared
// memory).  The bound is 64 threads, not the 32 launched: under a bound of
// one warp ptxas schedules the registers route ~1 us slower on an H100
// (69 registers against 59; a register cap does not recover it), which
// dense_ldl_ablation.py's "bound of 32 threads" times.
template <int NC>
__global__ void __launch_bounds__(64)
warp_solve_kernel(const float* __restrict__ F, const float* __restrict__ d,
                  const float* __restrict__ rhs, float* __restrict__ x, int n) {
  const int lane = threadIdx.x;
  const size_t vb = (size_t)blockIdx.x * n;
  float xv[NC], dv[NC];
  // b and d first: loaded after the factor's columns, they left ptxas one
  // register short around the division's slow-path call (a 4-byte spill)
  if constexpr (NC == 1) {
    RegFactor lf;
    load_vectors(xv, dv, rhs + vb, d + vb, n, lane);
    lf.load(F + vb * n, n, lane);
    warp_solve<NC>(xv, dv, lf, n, lane);
  } else {
    extern __shared__ float smem[];
    const SmemFactor lf{smem, n, lane};
    lf.stage(F + vb * n);
    load_vectors(xv, dv, rhs + vb, d + vb, n, lane);
    warp_solve<NC>(xv, dv, lf, n, lane);
  }
  store_x(x + vb, xv, n, lane);
}

// K6 above n = 32: one CTA per instance; the working matrix in shared
// memory when in_smem, else in place in Lt.
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

// K7 above n = 32: one CTA per instance against K6's factor Lt.
__global__ void __launch_bounds__(kMaxThreads, 1)
ldl_solve_kernel(const float* __restrict__ Lt, const float* __restrict__ d,
                 const float* __restrict__ rhs, float* __restrict__ x, int n) {
  extern __shared__ float smem[];
  float* xs = smem;      // n
  float* red = smem + n; // 32
  const size_t vb = (size_t)blockIdx.x * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) xs[i] = rhs[vb + i];
  __syncthreads();
  ldl_solve_rows(Lt + vb * n, d + vb, xs, red, n, threadIdx.x, blockDim.x);
  for (int i = threadIdx.x; i < n; i += blockDim.x) x[vb + i] = xs[i];
}

// K6 at n <= 32: the warp factor, a CTA of one warp an instance (the
// launch bound of 64 threads as the warp solve's).
__global__ void __launch_bounds__(64)
ldl_warp_factor_kernel(const float* __restrict__ A, float* __restrict__ Lt,
                       float* __restrict__ d, int n, float clamp) {
  const int lane = threadIdx.x;
  const size_t nn = (size_t)n * n;
  float m[32], dk;
  warp_factor<Rank1::kPivotTimesProduct>(m, dk, A + blockIdx.x * nn, n, lane, clamp);
  store_warp_factor<false>(Lt + blockIdx.x * nn, d + (size_t)blockIdx.x * n, m, dk, n,
                           lane);
}

// K8 at n <= 32: the warp factor hands its columns to the warp solve in
// registers (lane k's L[k, c] is RegFactor::l[c]); b is loaded first.
__global__ void __launch_bounds__(64)
ldl_warp_factor_solve_kernel(const float* __restrict__ A, const float* __restrict__ rhs,
                             float* __restrict__ Lt, float* __restrict__ d,
                             float* __restrict__ x, int n, float clamp) {
  const int lane = threadIdx.x;
  const size_t nn = (size_t)n * n;
  const size_t vb = (size_t)blockIdx.x * n;
  float xv[1], dv[1];
  xv[0] = lane < n ? rhs[vb + lane] : 0.0f;
  RegFactor lf;
  warp_factor<Rank1::kPivotTimesProduct>(lf.l, dv[0], A + blockIdx.x * nn, n, lane, clamp);
  store_warp_factor<false>(Lt + blockIdx.x * nn, d + vb, lf.l, dv[0], n, lane);
  warp_solve<1>(xv, dv, lf, n, lane);
  store_x(x + vb, xv, n, lane);
}

// K8 above n = 32: K6 then K7 in one launch, the substitutions reading the
// factor where the elimination left it (shared memory when it fits).
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
  ldl_solve_rows(M, d + vb, xs, r + n, n, threadIdx.x, blockDim.x);
  for (int i = threadIdx.x; i < n; i += blockDim.x) x[vb + i] = xs[i];
}

// the warp solve's instantiations, by chunks of x a lane (kFleetMaxN = 160)
using WarpSolveKernel = void (*)(const float*, const float*, const float*, float*, int);
const WarpSolveKernel kWarpSolve[] = {warp_solve_kernel<1>, warp_solve_kernel<2>,
                                      warp_solve_kernel<3>, warp_solve_kernel<4>,
                                      warp_solve_kernel<5>};
static_assert(sizeof(kWarpSolve) / sizeof(kWarpSolve[0]) * 32 >= kFleetMaxN,
              "an instantiation for every chunk count up to the fleet's n");

// K4's instantiations, by panels
using FleetFactorKernel = void (*)(const float*, float*, float*, int, float);
const FleetFactorKernel kFleetFactor[] = {fleet_factor_kernel<1>, fleet_factor_kernel<2>,
                                          fleet_factor_kernel<3>, fleet_factor_kernel<4>,
                                          fleet_factor_kernel<5>};
static_assert(sizeof(kFleetFactor) / sizeof(kFleetFactor[0]) * 32 >= kFleetMaxN,
              "an instantiation for every panel count up to the fleet's n");

bool valid_threads(int threads) {
  return threads >= 32 && threads <= kMaxThreads && threads % 32 == 0;
}

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
  cudaError_t e = allow_smem(ldl_factor_kernel, single_smem(kSmemMaxN, true));
  if (e == cudaSuccess) {
    e = allow_smem(ldl_factor_solve_kernel, single_smem(kSmemMaxN, true));
  }
  for (const WarpSolveKernel k : kWarpSolve) {
    if (e == cudaSuccess) e = allow_smem(k, sizeof(float) * kFleetMaxN * kFleetMaxN);
  }
  // K4's blocked route: as many instances an SM as its shared memory allows
  // (eight at n = 80)
  for (const FleetFactorKernel k : kFleetFactor) {
    if (e == cudaSuccess) e = allow_smem(k, fleet_smem(kFleetMaxN));
    if (e == cudaSuccess) {
      e = cudaFuncSetAttribute(k, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    }
  }
  return e;
}

// Each entry point launches on the given stream and returns
// cudaGetLastError() (cudaErrorInvalidValue for an unsupported shape).
// K4: the registers route at n <= 32, the blocked route above (the
// binding's fleet_factor_plan).
int tc_dense_ldl_fleet_factor(const float* A, float* L, float* d, int n, int B,
                              float clamp, void* stream) {
  if (n < 1 || n > kFleetMaxN || B < 1) return cudaErrorInvalidValue;
  const int panels = (n + 31) / 32;
  const size_t smem = panels > 1 ? fleet_smem(n) : 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const FleetFactorKernel kernel = kFleetFactor[panels - 1];
  kernel<<<B, 32, smem, st>>>(A, L, d, n, clamp);
  return cudaGetLastError();
}

// K4's dynamic shared memory a CTA at order n (the binding's
// fleet_factor_plan holds its own to it); -1 outside 1..kFleetMaxN.
int tc_dense_ldl_fleet_factor_smem(int n) {
  if (n < 1 || n > kFleetMaxN) return -1;
  return n > 32 ? static_cast<int>(fleet_smem(n)) : 0;
}

// K5, and K7 at n <= 32: a CTA an instance (the binding's solve_plan).
int tc_dense_ldl_warp_solve(const float* F, const float* d, const float* rhs, float* x,
                            int n, int B, void* stream) {
  if (n < 1 || n > kFleetMaxN || B < 1) return cudaErrorInvalidValue;
  const int nc = (n + 31) / 32;
  const size_t smem = nc > 1 ? (size_t)n * n * sizeof(float) : 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const WarpSolveKernel kernel = kWarpSolve[nc - 1];
  kernel<<<B, 32, smem, st>>>(F, d, rhs, x, n);
  return cudaGetLastError();
}

// K6 and K8: the warp factor at n <= 32, a CTA of `threads` an instance
// above (the binding's factor_plan).
int tc_dense_ldl_factor(const float* A, float* Lt, float* d, int n, int B,
                        int threads, float clamp, void* stream) {
  if (n < 1 || B < 1 || !valid_threads(threads) || (n <= 32 && threads != 32)) {
    return cudaErrorInvalidValue;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 32) {
    ldl_warp_factor_kernel<<<B, 32, 0, st>>>(A, Lt, d, n, clamp);
    return cudaGetLastError();
  }
  const bool in_smem = n <= kSmemMaxN;
  const size_t smem = single_smem(n, in_smem);
  ldl_factor_kernel<<<B, threads, smem, st>>>(A, Lt, d, n, clamp, in_smem ? 1 : 0);
  return cudaGetLastError();
}

// K7 above n = 32.
int tc_dense_ldl_solve(const float* Lt, const float* d, const float* rhs, float* x,
                       int n, int B, int threads, void* stream) {
  if (n < 1 || B < 1 || !valid_threads(threads)) {
    return cudaErrorInvalidValue;
  }
  const size_t smem = single_smem(n, false);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  ldl_solve_kernel<<<B, threads, smem, st>>>(Lt, d, rhs, x, n);
  return cudaGetLastError();
}

int tc_dense_ldl_factor_solve(const float* A, const float* rhs, float* Lt, float* d,
                              float* x, int n, int B, int threads, float clamp,
                              void* stream) {
  if (n < 1 || B < 1 || !valid_threads(threads) || (n <= 32 && threads != 32)) {
    return cudaErrorInvalidValue;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 32) {
    ldl_warp_factor_solve_kernel<<<B, 32, 0, st>>>(A, rhs, Lt, d, x, n, clamp);
    return cudaGetLastError();
  }
  const bool in_smem = n <= kSmemMaxN;
  const size_t smem = single_smem(n, in_smem);
  ldl_factor_solve_kernel<<<B, threads, smem, st>>>(A, rhs, Lt, d, x, n, clamp,
                                                    in_smem ? 1 : 0);
  return cudaGetLastError();
}

const char* tc_dense_ldl_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
