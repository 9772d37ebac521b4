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
//   K6/K7/K8 above n = 32 (the tiles route): one instance's upper triangle
//       is spread over the SMs.  The factor is a launch a 32-column panel
//       (28 at n = 896) of one-warp CTAs: one on the panel's diagonal
//       block (the warp factor's steps) and one a 32 x 32 tile of the
//       trailing upper triangle (379 CTAs in the first launch at n = 896),
//       each redoing the diagonal block's steps and its two row blocks in
//       its own warp rather than waiting at a barrier, so the launch
//       boundary is the only synchronisation; the working matrix lives in a
//       scratch W (L2-resident, 3.2 MB at n = 896), Lt is written once.  At
//       n = 840 the ~99 M updates need ~10 us at the card's FP32 rate; what
//       bounds the route is each launch's chain of dependent steps (the
//       diagonal block, the row blocks, the tile's 32 updates an element).
//       K7, and K8 after its factor, solve by a CTA of block_threads(n) an
//       instance in 32-row blocks: a warp's chain on the diagonal block and
//       the CTA on the rest (the forward updates; the backward sums of the
//       later blocks, formed while the block before runs its rows), so the
//       sweeps have one or two block barriers a block, not one or two a row.

#include <cuda_runtime.h>
#include <math.h>

// The fleet's largest n, the solve's CTA cap above n = 32 and the shared memory
// a block can opt into are the binding's (kkt/dense_ldl.py), given on the
// compiler's command line.
#if !defined(TC_FLEET_MAX_N) || !defined(TC_MAX_THREADS) || !defined(TC_DENSE_SMEM_MAX)
#error "build with -DTC_FLEET_MAX_N=... -DTC_MAX_THREADS=... -DTC_DENSE_SMEM_MAX=... (kkt/dense_ldl.py)"
#endif

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kFleetMaxN = TC_FLEET_MAX_N;  // K4's and the warp solve's n
constexpr int kMaxThreads = TC_MAX_THREADS; // the tiles route's solve CTA
constexpr size_t kSmemCap = TC_DENSE_SMEM_MAX;  // a block's opt-in cap
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

// x / d as __fdiv_rn rounds it, without its slow path for a zero x (the
// range check sends a zero dividend there): with d finite and nonzero the
// quotient of +-0 is the product's signed zero.  The tiles route divides
// by it; columns past n and a KKT's zero blocks give it zeros.
__device__ __forceinline__ float div_rn(float x, float d) {
  const bool zero = x == 0.0f && d != 0.0f && fabsf(d) < INFINITY;
  const float q = __fdiv_rn(zero ? 1.0f : x, d);
  return zero ? __fmul_rn(x, d) : q;
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

// K6/K8 above n = 32, the tiles route: one launch a 32-column panel p,
// in order, of one-warp CTAs, tile_ctas(T) an instance (T = panels - 1 - p).
// The working matrix M (the upper triangle, leading dimension n) is A
// before launch 0 and the scratch W after; launch p reads only rows
// 32 p .. 32 p + 31 of it and writes only rows below them, so its CTAs
// need no barrier between them.
//   CTA 0: the warp factor's steps on the panel's diagonal block (the
//     pivots and L of steps 32 p ..), then its rows of Lt in the block's
//     columns (0 below the diagonal, 1 on it) and d.
//   CTA t >= 1: tile (I, K), p < I <= K (tile_of).  It redoes CTA 0's
//     steps in its own registers (no barrier waits for them), then forms
//     the L of row blocks I and K of the panel: each column's 32 entries
//     take the panel's steps, a division and the updates of the rows
//     below (the diagonal block's L and d broadcast from shared memory);
//     then it gives tile (I, K) the panel's 32 updates in step order,
//     M[i, k] -= d_c (L[i, c] L[k, c]) for c = 32 p .. 32 p + 31.  At
//     I == K it also writes row block K of Lt (L[k, c] at row c) and zeros
//     its mirror below the diagonal, the block (K, p).
// So every upper element takes its subtractions in step order c = 0 ..
// i - 1, as the plain version's, and every entry of Lt is written once.
// Each phase's steps are a loop, not unrolled: a CTA runs its code once,
// and fully unrolled (~10,000 instructions) it waited on instruction
// fetches (dense_ldl_ablation.py's "unrolled" variants, PERF.md).
constexpr int kFactorSmem = 4 * (3 * 32 * 32 + 32);  // Ls, ds, RI, RK

__host__ __device__ constexpr int tile_ctas(int t) { return 1 + t * (t + 1) / 2; }

// Tile (I, K) of CTA t >= 1 of launch p: tiles in column order, K = p + 1,
// p + 2, ..., and I = p + 1 .. K in each.
__device__ __forceinline__ void tile_of(int t, int p, int& I, int& K) {
  int a = 1;
  while (a * (a + 1) / 2 < t) ++a;
  K = p + a;
  I = p + t - a * (a - 1) / 2;
}

// The tiles route's steps run as loops whose bodies have no branch: slot
// j of a lane's registers holds row c + 1 + j of its column (row c in slot
// 0 at the step's start), every step updates the first S slots and shifts
// them down by one, and the step's r goes to shared memory.  Row c + 1 + j
// is past the block once j >= 31 - c, so steps 8 g .. 8 g + 7 update S =
// 31 - 8 g slots: rows past the block in them, and a lane's rows below its
// diagonal, hold values nothing reads.

// Steps c_begin .. c_begin + 7 of the warp factor (K6's rounding order) on
// the panel's diagonal block: the step's r to Ls[32 c + lane] (L[32 p +
// lane, 32 p + c] for c < lane), the lane's pivot to dk, and the next
// step's pivot, from lane c + 1's own r as in warp_factor_steps, to piv.
template <int S>
__device__ __forceinline__ void tile_diagonal_steps(float (&m)[32], float* Ls, float& dk,
                                                    float& piv, int c_begin, int lane,
                                                    float clamp) {
#pragma unroll 1
  for (int c = c_begin; c < c_begin + 8; ++c) {
    const float dc = clamp_pivot(piv, clamp);
    const float rk = div_rn(m[0], dc);
    Ls[32 * c + lane] = rk;
    dk = lane == c ? dc : dk;
    piv = __shfl_sync(kFull, rank1<Rank1::kPivotTimesProduct>(m[1], dc, rk, rk),
                      (c + 1) & 31);
#pragma unroll
    for (int j = 0; j < S; ++j) {
      const float ri = __shfl_sync(kFull, rk, (c + 1 + j) & 31);
      m[j] = rank1<Rank1::kPivotTimesProduct>(m[j + 1], dc, ri, rk);
    }
  }
}

// Steps c_begin .. c_begin + 7 on the panel's row blocks I and K (rI, rK:
// a lane's column of each), the diagonal block's L and d from Ls and ds;
// the step's L to RI[32 c + lane] and RK[32 c + lane].
template <int S>
__device__ __forceinline__ void tile_row_steps(float (&rI)[32], float (&rK)[32],
                                               const float* Ls, const float* ds, float* RI,
                                               float* RK, int c_begin, int lane) {
#pragma unroll 1
  for (int c = c_begin; c < c_begin + 8; ++c) {
    const float dc = ds[c];
    const float aI = div_rn(rI[0], dc), aK = div_rn(rK[0], dc);
    RI[32 * c + lane] = aI;
    RK[32 * c + lane] = aK;
    const float* lc = Ls + 33 * c + 1;  // lc[j] = L[32 p + c + 1 + j, 32 p + c]
#pragma unroll
    for (int j = 0; j < S; ++j) {
      const float l = lc[j];
      rI[j] = rank1<Rank1::kPivotTimesProduct>(rI[j + 1], dc, l, aI);
      rK[j] = rank1<Rank1::kPivotTimesProduct>(rK[j + 1], dc, l, aK);
    }
  }
}

__global__ void __launch_bounds__(64)
tile_factor_kernel(const float* __restrict__ A, float* W, float* __restrict__ Lt,
                   float* __restrict__ d, int n, int p, int per, float clamp) {
  extern __shared__ float smem[];
  float* Ls = smem;          // Ls[32 c + i]: L[32 p + i, 32 p + c]
  float* ds = smem + 1024;   // the panel's pivots
  float* RI = smem + 1056;   // RI[32 c + l]: L[32 I + l, 32 p + c]
  float* RK = smem + 2080;   // RK[32 c + l]: L[32 K + l, 32 p + c]
  const int lane = threadIdx.x;
  const int b = blockIdx.x / per, t = blockIdx.x % per;
  const size_t nn = (size_t)n * n;
  const float* M = (p == 0 ? A : W) + b * nn;
  W += b * nn;
  Lt += b * nn;
  d += (size_t)b * n;
  const int c0 = 32 * p;
  float m[32], dk;
  load_block(m, M, n, p, c0 + lane);
  // a tile's CTA loads its row blocks (a full panel: rows c0 .. c0 + 31 <
  // n; columns past n are 0) and its tile first, so the loads are in
  // flight during the diagonal block's steps
  int I = 0, K = 0;
  float rI[32], rK[32], tv[32];
  if (t != 0) {
    tile_of(t, p, I, K);
    const int kI = 32 * I + lane, kK = 32 * K + lane;
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      rI[c] = kI < n ? M[(size_t)(c0 + c) * n + kI] : 0.0f;
      rK[c] = kK < n ? M[(size_t)(c0 + c) * n + kK] : 0.0f;
    }
    load_block(tv, M, n, I, kK);
  }
  // all 32 steps, also past n in the last panel (its lanes and rows past n
  // hold values nothing reads)
  dk = 1.0f;
  float piv = __shfl_sync(kFull, m[0], 0);  // M[c, c], from lane c
  tile_diagonal_steps<31>(m, Ls, dk, piv, 0, lane, clamp);
  tile_diagonal_steps<23>(m, Ls, dk, piv, 8, lane, clamp);
  tile_diagonal_steps<15>(m, Ls, dk, piv, 16, lane, clamp);
  tile_diagonal_steps<7>(m, Ls, dk, piv, 24, lane, clamp);
  ds[lane] = dk;
  __syncwarp();
  if (t == 0) {
    const int k = c0 + lane;
    if (k >= n) return;
#pragma unroll 1
    for (int r = 0; r < 32 && c0 + r < n; ++r) {
      Lt[(size_t)(c0 + r) * n + k] = r < lane ? Ls[32 * r + lane] : (r == lane ? 1.0f : 0.0f);
    }
    d[k] = dk;
    return;
  }
  const int k = 32 * K + lane;
  // row blocks I and K
  tile_row_steps<31>(rI, rK, Ls, ds, RI, RK, 0, lane);
  tile_row_steps<23>(rI, rK, Ls, ds, RI, RK, 8, lane);
  tile_row_steps<15>(rI, rK, Ls, ds, RI, RK, 16, lane);
  tile_row_steps<7>(rI, rK, Ls, ds, RI, RK, 24, lane);
  __syncwarp();
#pragma unroll 1
  for (int c = 0; c < 32; ++c) {
    const float dc = ds[c], lk = RK[32 * c + lane];
#pragma unroll
    for (int g = 0; g < 8; ++g) {
      const float4 li = *reinterpret_cast<const float4*>(RI + 32 * c + 4 * g);
      tv[4 * g] = rank1<Rank1::kPivotTimesProduct>(tv[4 * g], dc, li.x, lk);
      tv[4 * g + 1] = rank1<Rank1::kPivotTimesProduct>(tv[4 * g + 1], dc, li.y, lk);
      tv[4 * g + 2] = rank1<Rank1::kPivotTimesProduct>(tv[4 * g + 2], dc, li.z, lk);
      tv[4 * g + 3] = rank1<Rank1::kPivotTimesProduct>(tv[4 * g + 3], dc, li.w, lk);
    }
  }
  if (k < n) {
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      if (32 * I + i <= k) W[(size_t)(32 * I + i) * n + k] = tv[i];
    }
  }
  if (I != K) return;
  if (k < n) {
#pragma unroll 1
    for (int c = 0; c < 32; ++c) Lt[(size_t)(c0 + c) * n + k] = RK[32 * c + lane];
  }
#pragma unroll 1
  for (int i = 0; i < 32; ++i) {
    if (32 * K + i < n) Lt[(size_t)(32 * K + i) * n + c0 + lane] = 0.0f;
  }
}

// K7 above n = 32, and K8's solve: a CTA of T = blockDim.x threads an
// instance, the threads of the backward sums' tree (n <= 2 T, so a thread
// holds at most two terms a row), x in shared memory.  Both sweeps go by
// 32-row blocks q.
//   Forward: warp 0 solves the diagonal block in registers (y_c by a
//     shuffle, its column of the block loaded before the steps), then every
//     thread gives its rows past the block the block's 32 updates in order.
//   Backward: thread t's slot holds the terms i = t and t + T, so of row
//     c in block q only warp wq = q mod (T / 32) holds terms of block q
//     itself (at one of its two indices); every other warp's terms are 0
//     or in later blocks.  Each slot of each of the block's rows goes to
//     shared memory (warp wq's holds its other term), and lane r of every
//     other warp adds its warp's 32 slots of row r in the butterfly's tree
//     (x + x^16, then ^8, ^4, ^2, ^1: the shuffles' numbers, without the
//     160 shuffles a warp a block that bound this step).  Then warp 0 runs
//     the block's rows in order, each a butterfly of (0 + own) + other
//     over warp wq's slots and the warps' sums added in order to 0.
//     While warp 0 runs block q's rows the other warps already form block
//     q - 1's slots and sums: only warp (q mod T / 32) holds terms of block
//     q there, and its slots take them, and its sum is formed, by warp 0
//     before block q - 1's rows.  (0 + a) + b has the same bits as (0 +
//     b) + a, signed zeros included, so a slot may take its terms in
//     either order, and a sum that starts at +0 is never -0, so adding +0
//     leaves it as it is.
// Each step is a loop whose body has no branch (the rows of a ragged last
// block run too, on lanes that hold no x), not unrolled code run once a
// block.  Shared memory (two of each but x, one for the block whose rows
// run and one for the next): the warps' sums of each row before warp wq
// and after it (32 x 16, 0 elsewhere), the diagonal block's columns (32 x
// 32), the L of block q's terms in the next block's slots (32 x 33), the
// slots (32 x 33 a warp), and x (n).
constexpr int kSlotFloats = 32 * 33;  // a warp's slots of a block, [row][lane]

__host__ __device__ constexpr size_t tile_solve_smem(int n, int threads) {
  return sizeof(float) *
         ((size_t)n + 2 * (2 * 32 * 16 + 32 * 32 + kSlotFloats * (1 + threads / 32)));
}

static_assert(tile_solve_smem(2 * kMaxThreads, kMaxThreads) <= kSmemCap,
              "the tiles route's solve must fit the shared-memory cap");

// The slots of warp wp (its lane l: the terms at i1 = 32 wp + l and i2 =
// i1 + T) of block base's rows r = r0, r0 + dr, ... < 32 (a row past a
// ragged block's end repeats its last), (0 + p1) + p2 over the terms at
// later blocks, to sl[33 r + l].  With pl given (the warp holding the
// terms of the block whose rows run meanwhile, [pend, pend + 32)), those
// terms count 0 here and their L entries go to pl[33 r + l] (0 where a
// lane has none).  G rows' loads are in flight at a time, the next G's
// while the G before are stored.
template <int G>
__device__ __forceinline__ void block_slots(const float* __restrict__ Lt,
                                            const float* xs, float* sl, float* pl, int n,
                                            int T, int base, int nb, int wp, int lane,
                                            int pend, int r0, int dr) {
  const int later = base + 32, i1 = 32 * wp + lane, i2 = i1 + T;
  const bool in1 = i1 >= later && i1 < n, in2 = i2 >= later && i2 < n;
  const bool pd1 = in1 && i1 >= pend && i1 < pend + 32;
  const bool pd2 = in2 && i2 >= pend && i2 < pend + 32;
  const bool t1 = in1 && !pd1, t2 = in2 && !pd2;
  const float x1 = t1 ? xs[i1] : 0.0f, x2 = t2 ? xs[i2] : 0.0f;
  float g1[G], g2[G];
#pragma unroll
  for (int r = 0; r < G; ++r) {
    const float* row = Lt + (size_t)(base + min(min(r0 + dr * r, 31), nb - 1)) * n;
    g1[r] = in1 ? row[i1] : 0.0f;
    g2[r] = in2 ? row[i2] : 0.0f;
  }
#pragma unroll 1
  for (int h = r0; h < 32; h += G * dr) {
#pragma unroll
    for (int r = 0; r < G; ++r) {
      const int rr = h + dr * r;
      const float p1 = t1 ? __fmul_rn(g1[r], x1) : 0.0f;
      const float p2 = t2 ? __fmul_rn(g2[r], x2) : 0.0f;
      if (rr < 32) {
        sl[33 * rr + lane] = __fadd_rn(__fadd_rn(0.0f, p1), p2);
        if (pl != nullptr) pl[33 * rr + lane] = pd1 ? g1[r] : (pd2 ? g2[r] : 0.0f);
      }
      // the next group's loads (past the last row, row 31 again)
      const float* row =
          Lt + (size_t)(base + min(min(h + G * dr + dr * r, 31), nb - 1)) * n;
      g1[r] = in1 ? row[i1] : 0.0f;
      g2[r] = in2 ? row[i2] : 0.0f;
    }
  }
}

// Lane r: the sum of a warp's 32 slots of row r (sl[33 r + 0 .. 31]) in the
// butterfly's tree, to pre or post at [16 r + wp] by whether warp wp comes
// before or after the block's own warp wq (0 to both for wq itself).
__device__ __forceinline__ void slot_sums(const float* sl, float* pre, float* post, int wp,
                                          int wq, int lane) {
  float a[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) a[j] = __fadd_rn(sl[33 * lane + j], sl[33 * lane + j + 16]);
#pragma unroll
  for (int h = 8; h > 0; h >>= 1) {
#pragma unroll
    for (int j = 0; j < h; ++j) a[j] = __fadd_rn(a[j], a[j + h]);
  }
  pre[16 * lane + wp] = wp < wq ? a[0] : 0.0f;
  post[16 * lane + wp] = wp > wq ? a[0] : 0.0f;
}

// The shared memory of one backward block.
struct SolveBlock {
  float* pre;    // [16 r + w]: row r's sum of warp w < wq, else 0
  float* post;   // [16 r + w]: row r's sum of warp w > wq, else 0
  float* ld;     // [32 r + l]: L[base + l, base + r], 0 for r >= l
  float* pl;     // [33 r + l]: the L entries of the pending terms
  float* slots;  // [kSlotFloats w + 33 r + l]: row r's slot of warp w lane l
  __device__ __forceinline__ explicit SolveBlock(float* s)
      : pre(s), post(s + 512), ld(s + 1024), pl(s + 2048), slots(s + 2048 + kSlotFloats) {}
};

// Block q's slots and sums.  By every warp before the first block's rows
// (pend = n: nothing pending); else by warps 1 .. nw - 1 while warp 0 runs
// the rows of block q + 1 (from pend): each its own slots and sums, warp
// 0's slots shared out by rows, the diagonal block's columns shared out;
// the warp holding block q + 1's terms leaves them, and its sums, and warp
// 0's sums, to warp 0 (solve_finish).
__device__ __forceinline__ void block_sums(const float* __restrict__ Lt, const float* xs,
                                           const SolveBlock& sb, int n, int T, int nw, int q,
                                           int pend, int warp, int lane, int tid) {
  const int base = 32 * q, nb = min(32, n - base), wq = q % nw;
  const bool ahead = pend < n;
  const int wpend = ahead ? (pend >> 5) % nw : -1;  // the warp holding pending terms
  const int first = ahead ? 32 : 0, stride = T - first;
  for (int e0 = tid - first; e0 < 1024; e0 += 4 * stride) {
    float lv[4];  // four loads in flight, then their stores
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int e = e0 + k * stride, r = e >> 5, l = e & 31;
      lv[k] = e < 1024 && l < nb && r < l ? Lt[(size_t)(base + r) * n + base + l] : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (e0 + k * stride < 1024) sb.ld[e0 + k * stride] = lv[k];
    }
  }
  const bool pending = warp == wpend;
  float* sl = sb.slots + kSlotFloats * warp;
  block_slots<16>(Lt, xs, sl, pending ? sb.pl : nullptr, n, T, base, nb, warp, lane,
                  ahead ? pend : n, 0, 1);
  if (ahead) {
    block_slots<4>(Lt, xs, sb.slots, wpend == 0 ? sb.pl : nullptr, n, T, base, nb, 0, lane,
                   pend, warp - 1, nw - 1);
  }
  __syncwarp();
  if (!pending) slot_sums(sl, sb.pre, sb.post, warp, wq, lane);
}

// K names the kernel the solve serves (7: K7; 8: K8's second half): the
// same code under two symbols, so that a profile tells them apart.
template <int K>
__global__ void __launch_bounds__(kMaxThreads)
tile_solve_kernel(const float* __restrict__ Lt, const float* __restrict__ d,
                  const float* __restrict__ rhs, float* __restrict__ x, int n) {
  extern __shared__ float smem[];
  const int T = blockDim.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nw = T >> 5;
  const int per = 2 * 32 * 16 + 32 * 32 + kSlotFloats * (1 + nw);  // one block's floats
  float* xs = smem + 2 * per;  // x
  const size_t vb = (size_t)blockIdx.x * n;
  Lt += vb * n;
  for (int e = tid; e < 1024; e += T) {  // the sums of warps past nw
    smem[e] = 0.0f;
    smem[per + e] = 0.0f;
  }
  for (int i = tid; i < n; i += T) xs[i] = rhs[vb + i];
  __syncthreads();
  const int blocks = (n + 31) / 32;
  for (int q = 0; q < blocks; ++q) {
    const int base = 32 * q, nb = min(32, n - base);
    if (warp == 0) {
      const bool in = lane < nb;
      float l[32];  // L[base + lane, base + c] for c < lane
#pragma unroll
      for (int c = 0; c < 32; ++c) {
        l[c] = in && c < lane ? Lt[(size_t)(base + c) * n + base + lane] : 0.0f;
      }
      float v = in ? xs[base + lane] : 0.0f;
      // all 32 steps (past nb no lane is in): no step ends in a branch
#pragma unroll
      for (int c = 0; c < 32; ++c) {
        const float y = __shfl_sync(kFull, v, c);
        if (in && lane > c) v = __fsub_rn(v, __fmul_rn(y, l[c]));
      }
      if (in) xs[base + lane] = v;
    }
    __syncthreads();
    if (base + 32 >= n) break;
    for (int i = base + 32 + tid; i < n; i += T) {
      float v = xs[i];
#pragma unroll
      for (int h = 0; h < 32; h += 16) {
        float l[16];  // sixteen of the block's rows at column i, their loads in flight
#pragma unroll
        for (int c = 0; c < 16; ++c) l[c] = Lt[(size_t)(base + h + c) * n + i];
#pragma unroll
        for (int c = 0; c < 16; ++c) v = __fsub_rn(v, __fmul_rn(xs[base + h + c], l[c]));
      }
      xs[i] = v;
    }
    __syncthreads();
  }
  for (int i = tid; i < n; i += T) xs[i] = __fdiv_rn(xs[i], d[vb + i]);
  __syncthreads();
  // the last block's sums, by every warp (no rows run meanwhile)
  block_sums(Lt, xs, SolveBlock(smem + ((blocks - 1) & 1) * per), n, T, nw, blocks - 1, n,
             warp, lane, tid);
  __syncthreads();
  for (int q = blocks - 1; q >= 0; --q) {
    const SolveBlock sb(smem + (q & 1) * per);
    const int base = 32 * q, nb = min(32, n - base), wq = q % nw;
    if (warp == 0) {
      const bool in = lane < nb;
      if (q + 1 < blocks) {
        // the slots of the warp holding block q + 1's terms take them (x of
        // block q + 1 is final), then its sums, and warp 0's
        const int wp = (q + 1) % nw, i = base + 32 + lane;
        const float xp = i < n ? xs[i] : 0.0f;
        float* sl = sb.slots + kSlotFloats * wp;
#pragma unroll 8
        for (int r = 0; r < 32; ++r) {
          sl[33 * r + lane] = __fadd_rn(sl[33 * r + lane], __fmul_rn(sb.pl[33 * r + lane], xp));
        }
        __syncwarp();
        slot_sums(sl, sb.pre, sb.post, wp, wq, lane);
        if (wp != 0) slot_sums(sb.slots, sb.pre, sb.post, 0, wq, lane);
        __syncwarp();
      }
      // lane r: 0 + the sums of warps 0 .. wq - 1 of row r (+0 for the others)
      float pre = 0.0f;
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const float4 s = *reinterpret_cast<const float4*>(sb.pre + 16 * lane + 4 * g);
        pre = __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(pre, s.x), s.y), s.z), s.w);
      }
      const float* oth = sb.slots + kSlotFloats * wq;  // warp wq's other terms
      float v = in ? xs[base + lane] : 0.0f;
      float vprev = v;  // x as it was before the last row's update
      // two rows a trip, so a row's butterfly (on the old x) runs beside
      // the chain of the row before it
#pragma unroll 2
      for (int r = 31; r >= 0; --r) {
        // the butterfly of row r runs on the slots with x_{r+1} (lane r + 1)
        // as it was before its own row: what a lane receives holds no
        // term of its own, so lane r + 1 finishes the exact sum with its
        // new term and the five received partials (at r = 31 no x is new)
        const float o = oth[33 * r + lane], l = sb.ld[32 * r + lane];
        const bool term = in && lane > r;
        float stale = __fadd_rn(__fadd_rn(0.0f, term ? __fmul_rn(l, vprev) : 0.0f), o);
        float own = __fadd_rn(__fadd_rn(0.0f, term ? __fmul_rn(l, v) : 0.0f), o);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          const float got = __shfl_xor_sync(kFull, stale, off);
          stale = __fadd_rn(stale, got);
          own = __fadd_rn(own, got);
        }
        // then the later warps' sums in order, +0 for the others
        float tot = __fadd_rn(__shfl_sync(kFull, pre, r), own);
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          const float4 s = *reinterpret_cast<const float4*>(sb.post + 16 * r + 4 * g);
          tot = __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(tot, s.x), s.y), s.z), s.w);
        }
        tot = __shfl_sync(kFull, tot, r == 31 ? 0 : r + 1);
        vprev = v;
        v = lane == r ? __fsub_rn(v, tot) : v;
      }
      if (in) xs[base + lane] = v;
    } else if (q > 0) {
      // meanwhile block q - 1's slots and sums but for the terms of block q
      block_sums(Lt, xs, SolveBlock(smem + ((q - 1) & 1) * per), n, T, nw, q - 1, base,
                 warp, lane, tid);
    }
    __syncthreads();
  }
  for (int i = tid; i < n; i += T) x[vb + i] = xs[i];
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

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// K6 and K8 above n = 32: the tiles route's launches, one a panel, W the
// scratch working matrix (B n x n floats, not A).
cudaError_t launch_tile_factor(const float* A, float* W, float* Lt, float* d, int n, int B,
                               float clamp, cudaStream_t st) {
  const int panels = (n + 31) / 32;
  for (int p = 0; p < panels; ++p) {
    const int per = tile_ctas(panels - 1 - p), grid = B * per;
    tile_factor_kernel<<<grid, 32, kFactorSmem, st>>>(A, W, Lt, d, n, p, per, clamp);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

// the tiles route's solve takes a tree of `threads` (the binding's
// block_threads) with at most two terms a thread
bool valid_tree(int n, int threads) {
  return valid_threads(threads) && n <= 2 * threads;
}

}  // namespace

extern "C" {

// Once per device, before the first launch: the opt-in to dynamic shared
// memory above the 48 KB default, at the most each kernel can ask for.
int tc_dense_ldl_init() {
  // the tiles route's solve: its slots, up to 164,096 bytes (n = 1024,
  // 512 threads)
  const size_t solve_smem = tile_solve_smem(2 * kMaxThreads, kMaxThreads);
  cudaError_t e = allow_smem(tile_solve_kernel<7>, solve_smem);
  if (e == cudaSuccess) e = allow_smem(tile_solve_kernel<8>, solve_smem);
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

// K6 and K8: the warp factor at n <= 32, the tiles route above (the
// binding's factor_plan).  W: the tiles route's scratch, unused at n <= 32.
int tc_dense_ldl_factor(const float* A, float* Lt, float* d, float* W, int n, int B,
                        float clamp, void* stream) {
  if (n < 1 || B < 1 || (n > 32 && W == nullptr)) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 32) {
    ldl_warp_factor_kernel<<<B, 32, 0, st>>>(A, Lt, d, n, clamp);
    return cudaGetLastError();
  }
  return launch_tile_factor(A, W, Lt, d, n, B, clamp, st);
}

// The tiles route's CTAs of launch p an instance at order n; -1 where
// the route has no such launch.
int tc_dense_ldl_factor_ctas(int n, int p) {
  const int panels = (n + 31) / 32;
  if (n <= 32 || p < 0 || p >= panels) return -1;
  return tile_ctas(panels - 1 - p);
}

// K7 above n = 32: a CTA of `threads` an instance.
int tc_dense_ldl_solve(const float* Lt, const float* d, const float* rhs, float* x,
                       int n, int B, int threads, void* stream) {
  if (n < 1 || B < 1 || !valid_tree(n, threads)) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  tile_solve_kernel<7><<<B, threads, tile_solve_smem(n, threads), st>>>(Lt, d, rhs, x, n);
  return cudaGetLastError();
}

// K8: the warp factor and the warp solve at n <= 32 (threads 32); above,
// the tiles route's factor, then its solve, a CTA of `threads` an
// instance, on the factor the launches before left in L2.
int tc_dense_ldl_factor_solve(const float* A, const float* rhs, float* Lt, float* d,
                              float* x, float* W, int n, int B, int threads, float clamp,
                              void* stream) {
  if (n < 1 || B < 1 || (n <= 32 && threads != 32) ||
      (n > 32 && (W == nullptr || !valid_tree(n, threads)))) {
    return cudaErrorInvalidValue;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 32) {
    ldl_warp_factor_solve_kernel<<<B, 32, 0, st>>>(A, rhs, Lt, d, x, n, clamp);
    return cudaGetLastError();
  }
  const cudaError_t e = launch_tile_factor(A, W, Lt, d, n, B, clamp, st);
  if (e != cudaSuccess) return e;
  tile_solve_kernel<8><<<B, threads, tile_solve_smem(n, threads), st>>>(Lt, d, rhs, x, n);
  return cudaGetLastError();
}

const char* tc_dense_ldl_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
