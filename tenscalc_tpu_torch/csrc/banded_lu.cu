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
// Layout.  The kernels take the band (B, n, 2W+1) and vectors (B, n) as
// the adapter builds them, instance-contiguous, and write the factored
// band in the same layout: no copy re-lays anything out around a launch.
//
// What bounds it.  At the MPC-MHE fleet's shapes (B = 1024, n = 290,
// W = 10) K9 moves about 52.3 MB (band and rhs in, factor and x out),
// about 15.6 us at the card's 3.35 TB/s; K10 about 27.3 MB (8.2 us);
// K11 about 49.9 MB (14.9 us); at the pursuit fleet's (B = 512, n = 585,
// W = 22) K9 about 110.2 MB (32.9 us) and K10 about 56.3 MB (16.8 us).
// Each instance is a chain of n dependent
// steps, and the backward sweep's sequential sum is a chain of about
// n (W + 3) dependent float32 operations (~20k cycles, ~12 us at
// n = 290, W = 10).
//
// The first design (one thread an instance, a (W+1)^2 register window,
// batch-fastest layout) was predicted "far above the byte bound, 8 of 132
// SMs busy"; measured on an H100 (PERF.md, the host's launch overhead
// inside): K9 0.4933 ms, K10 0.4695 ms, K11 0.3415 ms, 30-60x their
// bounds, each step waiting on a load from device memory.  This design
// was predicted to be bounded by the dependent chain (K9 ~0.04-0.07 ms,
// K10 ~0.02-0.04 ms); measured on the same card, K9 ~0.12 ms, K10 ~0.07
// ms, K11 ~0.10 ms the same way, and ~0.089, ~0.039 and ~0.062 ms of
// device time alone (PERF.md): a factor step takes ~380 cycles, and
// moving the chain's values from
// shared memory to shuffles did not shorten it.  The eight instances an
// SM run ~23 shared-memory and shuffle instructions each a step, often
// two-way bank conflicted: the factor is bound by the SM's shared-memory
// instruction throughput.  The sweeps are bound by their chains.
//
// This design.
// - A warp serves one instance, and a CTA serves G <= 4 instances (the
//   wrapper picks G so that B = 1024 fills all 132 SMs in one wave, two
//   CTAs an SM).  A warp synchronises with __syncwarp and never with a
//   block barrier.
// - The instance is staged in shared memory: 4-byte cp.async copies of
//   row chunks (32 rows), kept 3 chunks ahead, so elimination starts when
//   the first two chunks have landed.  The instance stride n (2W+1) * 4
//   bytes is in general not 16-byte aligned, which rules out TMA and
//   16-byte copies.  K9/K11 write each chunk of the factor back with
//   coalesced stores as soon as the elimination has passed it; K9's
//   backward sweep then reads the factor from shared memory, and K10
//   stages the factor once for both sweeps: each entry of the band is
//   read from device memory once.  x stays in shared memory between the
//   sweeps.
// - A factor step (factor_rows): lanes i and 16 + i (W <= 15), or lane i
//   alone (W = 16..31), own row i of the trailing square and update it
//   with their own l_i; the next pivot and numerators pass by shuffles;
//   one __syncwarp a step.  Above W = 31 (to 63) lane l owns rows l and
//   l + 32 (factor_rows_two_rows): the rows do not fit the warp's lanes
//   one a lane.
// - The forward sweep (forward_rows) keeps y of rows c..c+W in lanes
//   0..W: a shuffle, a product and a subtraction a row; above W = 31 two
//   rows a lane.  The backward sweep runs on one lane, its row loads one
//   row ahead of the chain (read at the row above W = 31).
// - Above W = 31 the width is a run-time argument of kernels instantiated
//   at two capacities (47, 63), the entries past W masked, and the window
//   reaches two chunks ahead (rows c..c+W+1 span three chunks).
// - Above the shared-memory cap (an instance of (n + W)(2W + 2) floats
//   over the block's opt-in) the same kernels keep a ring of 128 rows of
//   the band and of x instead of the whole of each: 128 (2W + 2) floats
//   an instance whatever n.  K9 and K10 store the factor and y a chunk at
//   a time as they go, the backward sweep streams both back from device
//   memory through the ring, and x leaves a chunk at a time.  The binding
//   picks the route and the rows an instance by size.
//
// - Above W = 63 (every width the planner hands over) the block route: a
//   CTA an instance, the factor in place on the output band in device
//   memory, four steps a sweep (see its section below).  At the
//   deconvolution game's (256, 3000, 381) the 256 windows outgrow the L2
//   and K9 is bound by their traffic (PERF.md).
//
// Arithmetic.  The order is the TPU kernel's: the clamp, then
// l = row / d, then each trailing entry minus its product (the product
// rounded first), and in the backward sweep a sequential sum over q,
// q = 1..W (on the block route a thread's terms, then a pairwise tree:
// backward_sum in kkt/fleet_banded.py), a subtraction and a division.
// Each entry is still updated
// once a step, in step order, whichever lane updates it, so the kernels
// round exactly as the plain PyTorch versions beside their wrapper.  The
// _rn intrinsics keep nvcc from contracting products and sums into fused
// multiply-adds.  Staged, shared memory holds W rows (and W entries of x)
// past n as padding that the last steps may write and nothing reads
// back; on the ring they land in rows of a chunk past n or of one
// already stored, which nothing reads back either.

#include <cuda_runtime.h>
#include <math.h>

// The chunk, ring and group sizes and the shared-memory cap are the
// binding's (kkt/banded_lu.py), given on the compiler's command line; so
// are the shared-memory rows an instance takes, given at each launch.
#if !defined(TC_LU_CHUNK_ROWS) || !defined(TC_LU_RING_ROWS) || \
    !defined(TC_LU_MAX_GROUP) || !defined(TC_LU_SMEM_MAX)
#error "build with -DTC_LU_CHUNK_ROWS=... -DTC_LU_RING_ROWS=... -DTC_LU_MAX_GROUP=... -DTC_LU_SMEM_MAX=... (kkt/banded_lu.py)"
#endif

namespace {

constexpr int kLaneRowW = 31;  // y of rows c..c+W in a warp's lanes
constexpr int kMaxW = 63;      // above kLaneRowW two rows a lane; the block route above
constexpr int kTeam = 32;                       // lanes an instance: a warp
constexpr int kMaxGroup = TC_LU_MAX_GROUP;      // instances a CTA
constexpr int kChunk = TC_LU_CHUNK_ROWS;        // rows a copy group
constexpr int kRing = TC_LU_RING_ROWS;          // rows of the ring route
constexpr int kDepth = kRing / kChunk - 1;      // chunks in flight
constexpr int kSmemMax = TC_LU_SMEM_MAX;        // a block's opt-in cap
static_assert(kChunk > kLaneRowW, "a chunk must hold the window's rows");
static_assert(kMaxW < 2 * kChunk && kMaxW < 2 * kTeam,
              "two chunks ahead hold the wide window's rows, two a lane");
static_assert((kRing & (kRing - 1)) == 0 && kRing % kChunk == 0 && kDepth >= 2,
              "the ring is a power of two of at least three chunks");

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

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Shared-memory row of band row r (and entry of x): all n rows, or a
// ring of kRing.
template <bool RING>
__device__ __forceinline__ int srow(int r) {
  return RING ? (r & (kRing - 1)) : r;
}

// Start copying chunk k of the band rows (and of the vector gr, when
// given) into shared memory; a chunk outside 0..K-1 copies nothing.
template <int W, bool RING>
__device__ __forceinline__ void start_chunk(float* sb, float* sx,
                                            const float* gb, const float* gr,
                                            int k, int n, int lane) {
  constexpr int R = 2 * W + 1;
  const int r0 = k * kChunk;
  if (k < 0 || r0 >= n) return;
  const int r1 = min(n, r0 + kChunk);
  float* dst = sb + srow<RING>(r0) * R;
  const float* src = gb + (size_t)r0 * R;
  const int cnt = (r1 - r0) * R;
  for (int i = lane; i < cnt; i += kTeam) cp_async4(dst + i, src + i);
  if (gr != nullptr) {
    float* xd = sx + srow<RING>(r0);
    for (int i = lane; i < r1 - r0; i += kTeam) cp_async4(xd + i, gr + r0 + i);
  }
}

// Store rows r0..r1-1 of x from shared memory to gx (the ring route's
// chunks of x, which shared memory does not keep whole).
template <bool RING>
__device__ __forceinline__ void store_rows(const float* sx, float* gx, int r0,
                                           int r1, int lane) {
  const float* src = sx + srow<RING>(r0);
  for (int i = lane; i < r1 - r0; i += kTeam) gx[r0 + i] = src[i];
}

// Factor rows 0..n-1 in shared memory and write the factored band to gf
// chunk by chunk, for W <= 15.  Lanes i and 16 + i (i = 1..W) own row i of the
// trailing square: both form l_i and together update A[c+i, c+j] -=
// l_i u_j for j = 1..W, an entry of band row c+j (j <= i, below the
// diagonal) or c+i (j > i, above).  Lane i's entry j = 1 is the next
// step's A[c+i, c+1]: lane 1's is the next pivot and lane i's the next
// numerator of lane i-1, so they pass by shuffles, and the chain of
// dependent steps (clamp, division, product, subtraction, shuffle) never
// waits on shared memory; the other entries are stored, and one
// __syncwarp a step orders them before the next step's loads.  Rows past
// n are padding that the updates may write and nothing reads back.  With
// SOLVE the forward sweep rides along: lane i also updates y_{c+i}, and
// y ends in sx for the backward sweep (the ring route stores each chunk
// of y to gy as it stores the factor's).
template <int W, bool SOLVE, bool RING>
__device__ __forceinline__ void factor_rows_two_lanes(float* sb, float* sx,
                                            const float* gb, const float* gr,
                                            float* gf, float* gy, int n,
                                            float clamp, int lane) {
  constexpr int R = 2 * W + 1;
  constexpr int H = (W + 1) / 2;  // entries a lane: half of a row
  // lanes i and 16 + i own row i; the first takes j = 1..H, the second
  // j = H+1..W, and both form l_i
  const int i = lane & 15, half = lane >> 4;
  const bool owner = i >= 1 && i <= W;
  // this lane's entries: band row offset from c, column, and (staged)
  // the offset of the entry from row c's first; jn of them
  const int jn = owner ? (half == 0 ? H : W - H) : 0;
  int trow[H], tcol[H], toff[H];
#pragma unroll
  for (int e = 0; e < H; ++e) {
    const int j = half * H + e + 1;
    trow[e] = j <= i ? j : i;
    tcol[e] = j <= i ? i - j : W + j - i;
    toff[e] = trow[e] * R + tcol[e];
  }
  const int K = (n + kChunk - 1) / kChunk;
  for (int k = 0; k < kDepth; ++k) {
    start_chunk<W, RING>(sb, sx, gb, SOLVE ? gr : nullptr, k, n, lane);
    cp_async_commit();
  }
  float piv = 0.0f, num = 0.0f;  // raw A[c, c] and A[c+i, c]
  for (int k = 0; k < K; ++k) {
    __syncwarp();  // chunk k-1's write-back has read its ring rows
    start_chunk<W, RING>(sb, sx, gb, SOLVE ? gr : nullptr, k + kDepth, n, lane);
    cp_async_commit();
    cp_async_wait<kDepth - 1>();  // chunks k and k+1 have landed
    __syncwarp();
    if (k == 0) {
      piv = sb[0];
      num = owner ? sb[i] : 0.0f;
    }
    const int c0 = k * kChunk, c1 = min(n, c0 + kChunk);
    for (int c = c0; c < c1; ++c) {
      float* row = sb + srow<RING>(c) * R;
      // every load before any store: the compiler may not reorder them
      float* tgt[H];
      float u[H], a[H];
#pragma unroll
      for (int e = 0; e < H; ++e) {
        tgt[e] = RING ? sb + srow<RING>(c + trow[e]) * R + tcol[e] : row + toff[e];
        u[e] = a[e] = 0.0f;
        if (e < jn) {
          u[e] = row[W + 1 + half * H + e];
          a[e] = *tgt[e];
        }
      }
      // A[c+1+W, c+1] is untouched by this step: lane W's next numerator
      const float tail = i == W ? sb[srow<RING>(c + 1) * R + W] : 0.0f;
      float yi = 0.0f, yc = 0.0f;
      if (SOLVE && owner && half == 0) {
        yi = sx[srow<RING>(c + i)];
        yc = sx[srow<RING>(c)];
      }
      const float d = clamp_pivot(piv, clamp);
      const float l = owner ? __fdiv_rn(num, d) : 0.0f;
      float v[H];
#pragma unroll
      for (int e = 0; e < H; ++e) v[e] = __fsub_rn(a[e], __fmul_rn(l, u[e]));
      piv = __shfl_sync(0xffffffffu, v[0], 1);
      const float next = __shfl_sync(0xffffffffu, v[0], (i + 1) & 15);
      num = i == W ? tail : next;
#pragma unroll
      for (int e = 0; e < H; ++e) {
        if (e < jn) *tgt[e] = v[e];
      }
      if (SOLVE && owner && half == 0) {
        sx[srow<RING>(c + i)] = __fsub_rn(yi, __fmul_rn(l, yc));
      }
      __syncwarp();
      // row c is final: its pivot and multipliers replace A[c, c] and
      // A[c+i, c], which no later step reads
      if (lane == 0) row[0] = d;
      if (owner && half == 0) row[i] = l;
    }
    __syncwarp();
    // rows c0..c1-1 (and their y) are final: store them while the next
    // chunk runs
    const float* src = sb + srow<RING>(c0) * R;
    float* dst = gf + (size_t)c0 * R;
    const int cnt = (c1 - c0) * R;
    for (int e = lane; e < cnt; e += kTeam) dst[e] = src[e];
    if (SOLVE && RING) store_rows<RING>(sx, gy, c0, c1, lane);
  }
}

// The same factor for W = 16..31, where a row of the trailing square has
// more entries than two lanes can share.  The lane map is written for
// kParts lanes a row (lanes i + kRowLanes * part, part < kParts, own row
// i); above W = 15 it is one lane a row: lane i (i = 1..W) forms l_i and
// updates its W entries, the next pivot and numerators passing by
// shuffles as above.  An entry's place is formed from (c, i, j) when it
// is loaded and again when it is stored, so a lane keeps only l, its u_j
// and its entries in registers (ptxas spills nothing at W = 31).  W <= 15
// keeps factor_rows_two_lanes, whose offsets and step targets stay in
// registers: on this function K9 at the MPC-MHE fleet's W = 10 took
// 11.6% longer (banded_lu_ablation.py; PERF.md).
template <int W, bool SOLVE, bool RING>
__device__ __forceinline__ void factor_rows_one_lane(float* sb, float* sx,
                                            const float* gb, const float* gr,
                                            float* gf, float* gy, int n,
                                            float clamp, int lane) {
  constexpr int R = 2 * W + 1;
  constexpr int kRowLanes = W <= 15 ? 16 : kTeam;  // rows the lanes cover
  constexpr int kParts = kTeam / kRowLanes;        // lanes a row
  constexpr int H = (W + kParts - 1) / kParts;     // entries a lane
  // lane i + kRowLanes * part (part < kParts) takes j = part*H+1 .. and
  // forms l_i
  const int i = lane & (kRowLanes - 1), part = lane / kRowLanes;
  const bool owner = i >= 1 && i <= W;
  const int jn = owner ? min(H, W - part * H) : 0;  // entries of this lane
  // entry e (j = part*H + e + 1) of row i at step c
  auto entry = [&](int c, int e) -> float* {
    const int j = part * H + e + 1;
    return j <= i ? sb + srow<RING>(c + j) * R + (i - j)
                  : sb + srow<RING>(c + i) * R + (W + j - i);
  };
  const int K = (n + kChunk - 1) / kChunk;
  for (int k = 0; k < kDepth; ++k) {
    start_chunk<W, RING>(sb, sx, gb, SOLVE ? gr : nullptr, k, n, lane);
    cp_async_commit();
  }
  float piv = 0.0f, num = 0.0f;  // raw A[c, c] and A[c+i, c]
  for (int k = 0; k < K; ++k) {
    __syncwarp();  // chunk k-1's write-back has read its ring rows
    start_chunk<W, RING>(sb, sx, gb, SOLVE ? gr : nullptr, k + kDepth, n, lane);
    cp_async_commit();
    cp_async_wait<kDepth - 1>();  // chunks k and k+1 have landed
    __syncwarp();
    if (k == 0) {
      piv = sb[0];
      num = owner ? sb[i] : 0.0f;
    }
    const int c0 = k * kChunk, c1 = min(n, c0 + kChunk);
    for (int c = c0; c < c1; ++c) {
      float* row = sb + srow<RING>(c) * R;
      // every load before any store: the compiler may not reorder them
      float u[H], a[H];
#pragma unroll
      for (int e = 0; e < H; ++e) {
        u[e] = a[e] = 0.0f;
        if (e < jn) {
          u[e] = row[W + 1 + part * H + e];
          a[e] = *entry(c, e);
        }
      }
      // A[c+1+W, c+1] is untouched by this step: lane W's next numerator
      const float tail = i == W ? sb[srow<RING>(c + 1) * R + W] : 0.0f;
      float yi = 0.0f, yc = 0.0f;
      if (SOLVE && owner && part == 0) {
        yi = sx[srow<RING>(c + i)];
        yc = sx[srow<RING>(c)];
      }
      const float d = clamp_pivot(piv, clamp);
      const float l = owner ? __fdiv_rn(num, d) : 0.0f;
#pragma unroll
      for (int e = 0; e < H; ++e) a[e] = __fsub_rn(a[e], __fmul_rn(l, u[e]));
      piv = __shfl_sync(0xffffffffu, a[0], 1);
      const float next = __shfl_sync(0xffffffffu, a[0], (i + 1) & (kRowLanes - 1));
      num = i == W ? tail : next;
#pragma unroll
      for (int e = 0; e < H; ++e) {
        if (e < jn) *entry(c, e) = a[e];
      }
      if (SOLVE && owner && part == 0) {
        sx[srow<RING>(c + i)] = __fsub_rn(yi, __fmul_rn(l, yc));
      }
      __syncwarp();
      // row c is final: its pivot and multipliers replace A[c, c] and
      // A[c+i, c], which no later step reads
      if (lane == 0) row[0] = d;
      if (owner && part == 0) row[i] = l;
    }
    __syncwarp();
    // rows c0..c1-1 (and their y) are final: store them while the next
    // chunk runs
    const float* src = sb + srow<RING>(c0) * R;
    float* dst = gf + (size_t)c0 * R;
    const int cnt = (c1 - c0) * R;
    for (int e = lane; e < cnt; e += kTeam) dst[e] = src[e];
    if (SOLVE && RING) store_rows<RING>(sx, gy, c0, c1, lane);
  }
}

// The factor of rows 0..n-1 on its lane map.
template <int W, bool SOLVE, bool RING>
__device__ __forceinline__ void factor_rows(float* sb, float* sx, const float* gb,
                                            const float* gr, float* gf, float* gy, int n,
                                            float clamp, int lane) {
  if constexpr (W <= 15) {
    factor_rows_two_lanes<W, SOLVE, RING>(sb, sx, gb, gr, gf, gy, n, clamp, lane);
  } else {
    factor_rows_one_lane<W, SOLVE, RING>(sb, sx, gb, gr, gf, gy, n, clamp, lane);
  }
}

// Forward sweep y = L^{-1} rhs against the factored band gf, staged chunk
// by chunk into shared memory; y ends in sx (the ring route stores each
// chunk of y to gy).  Lane i (0..W) holds y of row c+i: at row c lane 0's
// y_c is final, lanes 1..W subtract l_i y_c, lane 1's value is the next
// y_c (a shuffle) and the window shifts down one lane; the chain is a
// shuffle, a product and a subtraction a row.
template <int W, bool RING>
__device__ __forceinline__ void forward_rows(float* sb, float* sx,
                                             const float* gf, const float* gr,
                                             float* gy, int n, int lane) {
  constexpr int R = 2 * W + 1;
  const int K = (n + kChunk - 1) / kChunk;
  const int i = lane;
  const bool owner = i >= 1 && i <= W;
  for (int k = 0; k < kDepth; ++k) {
    start_chunk<W, RING>(sb, sx, gf, gr, k, n, lane);
    cp_async_commit();
  }
  float xw = 0.0f, y = 0.0f, l = 0.0f;  // y of row c+i, y_c, l_i of row c
  for (int k = 0; k < K; ++k) {
    __syncwarp();
    start_chunk<W, RING>(sb, sx, gf, gr, k + kDepth, n, lane);
    cp_async_commit();
    cp_async_wait<kDepth - 1>();  // chunks k and k+1 have landed
    __syncwarp();
    const int c0 = k * kChunk, c1 = min(n, c0 + kChunk);
    if (k == 0) {
      xw = i <= W && i < n ? sx[i] : 0.0f;
      y = __shfl_sync(0xffffffffu, xw, 0);
      l = owner ? sb[i] : 0.0f;
    }
    for (int c = c0; c < c1; ++c) {
      // row c+1 lies in chunk k or k+1, both landed
      const float ln = owner ? sb[srow<RING>(c + 1) * R + i] : 0.0f;
      const int last = c + 1 + W;
      const float xlast = i == W && last < n ? sx[srow<RING>(last)] : 0.0f;
      if (owner) xw = __fsub_rn(xw, __fmul_rn(l, y));
      if (i == 0) sx[srow<RING>(c)] = y;
      const float ynext = __shfl_sync(0xffffffffu, xw, 1);
      const float down = __shfl_down_sync(0xffffffffu, xw, 1);
      xw = i == W ? xlast : down;
      y = ynext;
      l = ln;
    }
    if (RING) {
      __syncwarp();  // lane 0's y of rows c0..c1-1
      store_rows<RING>(sx, gy, c0, c1, lane);
    }
  }
  __syncwarp();
}

// Backward sweep over rows c1-1 down to c0 of one chunk, on one lane:
// x_c = (y_c - sum_q u_q x_{c+q}) / d_c in place in sx, with
// x_{c+1..c+W} kept in xn (xn[q] = x[c+q], 0 past the last row) and row
// c-1 loaded while row c is worked on.
template <int W, bool RING>
__device__ __forceinline__ void backward_chunk(const float* sb, float* sx,
                                               float (&xn)[W + 1], int c0,
                                               int c1) {
  constexpr int R = 2 * W + 1;
  // u[q-1] = u_q and dy = (d, y) of the current row
  float u[W], dy[2];
  const float* row = sb + srow<RING>(c1 - 1) * R;
#pragma unroll
  for (int q = 0; q < W; ++q) u[q] = row[W + 1 + q];
  dy[0] = row[0];
  dy[1] = sx[srow<RING>(c1 - 1)];
  // row c, with row cn (c - 1 of this chunk, else c again) loaded
  // ahead; row c0 - 1 is loaded with the next chunk
  auto step = [&](int c, int cn) {
    const float* nrow = sb + srow<RING>(cn) * R;
    float un[W], dyn[2];
#pragma unroll
    for (int q = 0; q < W; ++q) un[q] = nrow[W + 1 + q];
    dyn[0] = nrow[0];
    dyn[1] = sx[srow<RING>(cn)];
    float acc = 0.0f;
#pragma unroll
    for (int q = 1; q <= W; ++q) acc = __fadd_rn(acc, __fmul_rn(u[q - 1], xn[q]));
    const float xc = __fdiv_rn(__fsub_rn(dy[1], acc), dy[0]);
    sx[srow<RING>(c)] = xc;
#pragma unroll
    for (int q = W; q > 1; --q) xn[q] = xn[q - 1];
    xn[1] = xc;
#pragma unroll
    for (int q = 0; q < W; ++q) u[q] = un[q];
    dy[0] = dyn[0];
    dy[1] = dyn[1];
  };
  if (c1 - c0 == kChunk) {
    // a whole chunk, unrolled: the window's shifts become renaming
#pragma unroll
    for (int r = kChunk - 1; r >= 0; --r) step(c0 + r, c0 + (r > 0 ? r - 1 : 0));
  } else {
    for (int c = c1 - 1; c >= c0; --c) step(c, c > c0 ? c - 1 : c);
  }
}

// Backward sweep U x = y in place in sx, left-looking, last chunk first.
// The staged route finds the factor and y in shared memory and leaves x
// there; the ring route streams the factor back from gf and y from gx
// and stores each chunk of x to gx.  One lane runs the chain.
template <int W, bool RING>
__device__ __forceinline__ void backward_rows(float* sb, float* sx,
                                              const float* gf, float* gx,
                                              int n, int lane) {
  const int K = (n + kChunk - 1) / kChunk;
  __syncwarp();  // the team's stores of the factor and y are visible
  if (RING) {
    for (int j = 0; j < kDepth; ++j) {
      start_chunk<W, RING>(sb, sx, gf, gx, K - 1 - j, n, lane);
      cp_async_commit();
    }
  }
  float xn[W + 1];
#pragma unroll
  for (int q = 0; q <= W; ++q) xn[q] = 0.0f;
  for (int j = 0; j < K; ++j) {
    const int k = K - 1 - j;
    const int c0 = k * kChunk, c1 = min(n, c0 + kChunk);
    if (RING) {
      __syncwarp();  // the chunk before has been read and stored
      start_chunk<W, RING>(sb, sx, gf, gx, k - kDepth, n, lane);
      cp_async_commit();
      cp_async_wait<kDepth>();  // chunk k has landed
      __syncwarp();
    }
    if (lane == 0) backward_chunk<W, RING>(sb, sx, xn, c0, c1);
    if (RING) {
      __syncwarp();  // lane 0's x of rows c0..c1-1
      store_rows<RING>(sx, gx, c0, c1, lane);
    }
  }
}

// This thread's lane in its instance's warp, and the instance b; false
// for a warp past B.
__device__ __forceinline__ bool team_of(int G, int B, int& lane, int& b) {
  lane = threadIdx.x & (kTeam - 1);
  b = blockIdx.x * G + threadIdx.x / kTeam;
  return b < B;
}

// The warp's slice of the block's shared memory: rows band rows, then
// rows entries of x.  The binding gives rows: all n and W of padding
// (staged), or kRing (the ring route).
template <int W>
__device__ __forceinline__ float* team_smem(int rows) {
  extern __shared__ float smem[];
  return smem + (threadIdx.x / kTeam) * rows * (2 * W + 2);
}

__device__ __forceinline__ void store_x(const float* sx, float* gx, int n,
                                        int lane) {
  __syncwarp();
  for (int i = lane; i < n; i += kTeam) gx[i] = sx[i];
}

template <int W, bool RING>
__global__ void __launch_bounds__(kTeam * kMaxGroup, 1)
lu_factor_solve_kernel(const float* __restrict__ band,
                       const float* __restrict__ rhs, float* fband, float* x,
                       int n, int B, int G, int rows, float clamp) {
  int lane, b;
  if (!team_of(G, B, lane, b)) return;
  constexpr int R = 2 * W + 1;
  float* sb = team_smem<W>(rows);
  float* sx = sb + rows * R;
  const size_t off = (size_t)b * n * R;
  float* gx = x + (size_t)b * n;
  factor_rows<W, true, RING>(sb, sx, band + off, rhs + (size_t)b * n,
                             fband + off, gx, n, clamp, lane);
  backward_rows<W, RING>(sb, sx, fband + off, gx, n, lane);
  if (!RING) store_x(sx, gx, n, lane);
}

template <int W, bool RING>
__global__ void __launch_bounds__(kTeam * kMaxGroup, 1)
lu_solve_kernel(const float* __restrict__ fband, const float* __restrict__ rhs,
                float* x, int n, int B, int G, int rows) {
  int lane, b;
  if (!team_of(G, B, lane, b)) return;
  constexpr int R = 2 * W + 1;
  float* sb = team_smem<W>(rows);
  float* sx = sb + rows * R;
  const float* gf = fband + (size_t)b * n * R;
  float* gx = x + (size_t)b * n;
  forward_rows<W, RING>(sb, sx, gf, rhs + (size_t)b * n, gx, n, lane);
  backward_rows<W, RING>(sb, sx, gf, gx, n, lane);
  if (!RING) store_x(sx, gx, n, lane);
}

template <int W, bool RING>
__global__ void __launch_bounds__(kTeam * kMaxGroup, 1)
lu_factor_kernel(const float* __restrict__ band, float* __restrict__ fband,
                 int n, int B, int G, int rows, float clamp) {
  int lane, b;
  if (!team_of(G, B, lane, b)) return;
  constexpr int R = 2 * W + 1;
  float* sb = team_smem<W>(rows);
  const size_t off = (size_t)b * n * R;
  factor_rows<W, false, RING>(sb, nullptr, band + off, nullptr, fband + off,
                              nullptr, n, clamp, lane);
}


// ---------------------------------------------------------------------------
// w = 32..63 (kLaneRowW < w <= kMaxW): the width a run-time argument, CAP
// the capacity of an instantiation, R = 2w + 1 a band row's floats.
// ---------------------------------------------------------------------------

// start_chunk at a run-time row length R
template <bool RING>
__device__ __forceinline__ void start_chunk_rt(float* sb, float* sx, const float* gb,
                                               const float* gr, int k, int n, int R,
                                               int lane) {
  const int r0 = k * kChunk;
  if (k < 0 || r0 >= n) return;
  const int r1 = min(n, r0 + kChunk);
  float* dst = sb + srow<RING>(r0) * R;
  const float* src = gb + (size_t)r0 * R;
  const int cnt = (r1 - r0) * R;
  for (int i = lane; i < cnt; i += kTeam) cp_async4(dst + i, src + i);
  if (gr != nullptr) {
    float* xd = sx + srow<RING>(r0);
    for (int i = lane; i < r1 - r0; i += kTeam) cp_async4(xd + i, gr + r0 + i);
  }
}

// Entry e (j = e + 1) of trailing row i at step c: A[c+i, c+j], in band
// row c+j at column i-j (j <= i) or band row c+i at column w+j-i (j > i).
template <bool RING>
__device__ __forceinline__ float* trailing_entry(float* sb, int c, int i, int e, int w,
                                                 int R) {
  const int j = e + 1;
  return j <= i ? sb + srow<RING>(c + j) * R + (i - j)
                : sb + srow<RING>(c + i) * R + (w + j - i);
}

// One trailing row's step: entries A[c+i, c+j] -= l u_j, j = 1..w, loaded
// together, updated, stored; returns the updated A[c+i, c+1].
template <int CAP, bool RING>
__device__ __forceinline__ float update_row(float* sb, const float (&u)[CAP], int c,
                                            int i, bool own, float l, int w, int R) {
  float a[CAP];
#pragma unroll
  for (int e = 0; e < CAP; ++e) {
    a[e] = own && e < w ? *trailing_entry<RING>(sb, c, i, e, w, R) : 0.0f;
  }
#pragma unroll
  for (int e = 0; e < CAP; ++e) a[e] = __fsub_rn(a[e], __fmul_rn(l, u[e]));
#pragma unroll
  for (int e = 0; e < CAP; ++e) {
    if (own && e < w) *trailing_entry<RING>(sb, c, i, e, w, R) = a[e];
  }
  return a[0];
}

// The factor for w = 32..63: lane l owns trailing rows i0 = l (l >= 1)
// and i1 = l + 32 (i1 <= w), forms their l_i and updates their w entries
// a row at a time.  The next pivot is row 1's updated first entry (lane
// 1); row i's next numerator is row i+1's: lane l+1's row of the same
// slot, and for row 31 lane 0's second row; row w takes A[c+1+w, c+1],
// untouched by the step.
template <int CAP, bool SOLVE, bool RING>
__device__ __forceinline__ void factor_rows_two_rows(float* sb, float* sx,
                                                     const float* gb, const float* gr,
                                                     float* gf, float* gy, int n, int w,
                                                     float clamp, int lane) {
  const int R = 2 * w + 1;
  const int i0 = lane, i1 = lane + kTeam;
  const bool own0 = i0 >= 1, own1 = i1 <= w;
  const int K = (n + kChunk - 1) / kChunk;
  for (int k = 0; k < kDepth; ++k) {
    start_chunk_rt<RING>(sb, sx, gb, SOLVE ? gr : nullptr, k, n, R, lane);
    cp_async_commit();
  }
  float piv = 0.0f, num0 = 0.0f, num1 = 0.0f;  // raw A[c, c], A[c+i0, c], A[c+i1, c]
  for (int k = 0; k < K; ++k) {
    __syncwarp();  // chunk k-1's write-back has read its ring rows
    start_chunk_rt<RING>(sb, sx, gb, SOLVE ? gr : nullptr, k + kDepth, n, R, lane);
    cp_async_commit();
    cp_async_wait<kDepth - 2>();  // chunks k, k+1 and k+2 have landed
    __syncwarp();
    if (k == 0) {
      piv = sb[0];
      num0 = own0 ? sb[i0] : 0.0f;
      num1 = own1 ? sb[i1] : 0.0f;
    }
    const int c0 = k * kChunk, c1 = min(n, c0 + kChunk);
#pragma unroll 1
    for (int c = c0; c < c1; ++c) {
      float* row = sb + srow<RING>(c) * R;
      float u[CAP];  // u_j = A[c, c+j]
#pragma unroll
      for (int e = 0; e < CAP; ++e) u[e] = e < w ? row[w + 1 + e] : 0.0f;
      // A[c+1+w, c+1] is untouched by this step: row w's next numerator
      const float tail = i1 == w ? sb[srow<RING>(c + 1) * R + w] : 0.0f;
      float yc = 0.0f, y0 = 0.0f, y1 = 0.0f;
      if (SOLVE) {
        yc = sx[srow<RING>(c)];
        if (own0) y0 = sx[srow<RING>(c + i0)];
        if (own1) y1 = sx[srow<RING>(c + i1)];
      }
      const float d = clamp_pivot(piv, clamp);
      const float l0 = own0 ? __fdiv_rn(num0, d) : 0.0f;
      const float l1 = own1 ? __fdiv_rn(num1, d) : 0.0f;
      const float f0 = update_row<CAP, RING>(sb, u, c, i0, own0, l0, w, R);
      const float f1 = update_row<CAP, RING>(sb, u, c, i1, own1, l1, w, R);
      piv = __shfl_sync(0xffffffffu, f0, 1);
      const float n0 = __shfl_sync(0xffffffffu, f0, (lane + 1) & (kTeam - 1));
      const float n1 = __shfl_sync(0xffffffffu, f1, (lane + 1) & (kTeam - 1));
      num0 = lane == kTeam - 1 ? n1 : n0;
      num1 = i1 == w ? tail : n1;
      if (SOLVE) {
        if (own0) sx[srow<RING>(c + i0)] = __fsub_rn(y0, __fmul_rn(l0, yc));
        if (own1) sx[srow<RING>(c + i1)] = __fsub_rn(y1, __fmul_rn(l1, yc));
      }
      __syncwarp();
      // row c is final: its pivot and multipliers replace A[c, c] and
      // A[c+i, c], which no later step reads
      if (lane == 0) row[0] = d;
      if (own0) row[i0] = l0;
      if (own1) row[i1] = l1;
    }
    __syncwarp();
    // rows c0..c1-1 (and their y) are final: store them while the next
    // chunk runs
    const float* src = sb + srow<RING>(c0) * R;
    float* dst = gf + (size_t)c0 * R;
    const int cnt = (c1 - c0) * R;
    for (int e = lane; e < cnt; e += kTeam) dst[e] = src[e];
    if (SOLVE && RING) store_rows<RING>(sx, gy, c0, c1, lane);
  }
}

// Forward sweep for w = 32..63: lane l holds y of rows c+l and c+32+l
// (the second while 32+l <= w); the window shifts down one row a step,
// lane 31's first row taking lane 0's second.
template <bool RING>
__device__ __forceinline__ void forward_rows_two(float* sb, float* sx, const float* gf,
                                                 const float* gr, float* gy, int n,
                                                 int w, int lane) {
  const int R = 2 * w + 1;
  const int K = (n + kChunk - 1) / kChunk;
  const int i0 = lane, i1 = lane + kTeam;
  const bool own0 = i0 >= 1, own1 = i1 <= w;
  for (int k = 0; k < kDepth; ++k) {
    start_chunk_rt<RING>(sb, sx, gf, gr, k, n, R, lane);
    cp_async_commit();
  }
  // y of rows c+i0 and c+i1, y_c, and l_i of row c
  float x0 = 0.0f, x1 = 0.0f, y = 0.0f, l0 = 0.0f, l1 = 0.0f;
  for (int k = 0; k < K; ++k) {
    __syncwarp();
    start_chunk_rt<RING>(sb, sx, gf, gr, k + kDepth, n, R, lane);
    cp_async_commit();
    cp_async_wait<kDepth - 2>();  // chunks k, k+1 and k+2 have landed
    __syncwarp();
    const int c0 = k * kChunk, c1 = min(n, c0 + kChunk);
    if (k == 0) {
      x0 = i0 < n ? sx[i0] : 0.0f;
      x1 = own1 && i1 < n ? sx[i1] : 0.0f;
      y = __shfl_sync(0xffffffffu, x0, 0);
      l0 = own0 ? sb[i0] : 0.0f;
      l1 = own1 ? sb[i1] : 0.0f;
    }
#pragma unroll 1
    for (int c = c0; c < c1; ++c) {
      const float* next = sb + srow<RING>(c + 1) * R;
      const float ln0 = own0 ? next[i0] : 0.0f;
      const float ln1 = own1 ? next[i1] : 0.0f;
      const int last = c + 1 + w;
      const float xlast = i1 == w && last < n ? sx[srow<RING>(last)] : 0.0f;
      if (own0) x0 = __fsub_rn(x0, __fmul_rn(l0, y));
      if (own1) x1 = __fsub_rn(x1, __fmul_rn(l1, y));
      if (lane == 0) sx[srow<RING>(c)] = y;
      const float ynext = __shfl_sync(0xffffffffu, x0, 1);
      const float d0 = __shfl_down_sync(0xffffffffu, x0, 1);
      const float d1 = __shfl_down_sync(0xffffffffu, x1, 1);
      const float s10 = __shfl_sync(0xffffffffu, x1, 0);
      x0 = lane == kTeam - 1 ? s10 : d0;
      x1 = i1 == w ? xlast : d1;
      y = ynext;
      l0 = ln0;
      l1 = ln1;
    }
    if (RING) {
      __syncwarp();  // lane 0's y of rows c0..c1-1
      store_rows<RING>(sx, gy, c0, c1, lane);
    }
  }
  __syncwarp();
}

// Backward sweep for w = 32..63, one lane: x_c = (y_c - sum_q u_q
// x_{c+q}) / d_c with x_{c+1..c+w} in registers, row c read as it is
// worked on.  Chunks move as in backward_rows.
template <int CAP, bool RING>
__device__ __forceinline__ void backward_rows_rt(float* sb, float* sx, const float* gf,
                                                 float* gx, int n, int w, int lane) {
  const int R = 2 * w + 1;
  const int K = (n + kChunk - 1) / kChunk;
  __syncwarp();  // the team's stores of the factor and y are visible
  if (RING) {
    for (int j = 0; j < kDepth; ++j) {
      start_chunk_rt<RING>(sb, sx, gf, gx, K - 1 - j, n, R, lane);
      cp_async_commit();
    }
  }
  float xn[CAP + 1];  // xn[q] = x_{c+q}
#pragma unroll
  for (int q = 0; q <= CAP; ++q) xn[q] = 0.0f;
  for (int j = 0; j < K; ++j) {
    const int k = K - 1 - j;
    const int c0 = k * kChunk, c1 = min(n, c0 + kChunk);
    if (RING) {
      __syncwarp();  // the chunk before has been read and stored
      start_chunk_rt<RING>(sb, sx, gf, gx, k - kDepth, n, R, lane);
      cp_async_commit();
      cp_async_wait<kDepth>();  // chunk k has landed
      __syncwarp();
    }
    if (lane == 0) {
#pragma unroll 1
      for (int c = c1 - 1; c >= c0; --c) {
        const float* row = sb + srow<RING>(c) * R;
        float acc = 0.0f;
#pragma unroll
        for (int q = 1; q <= CAP; ++q) {
          const float t = __fadd_rn(acc, __fmul_rn(row[w + q], xn[q]));
          acc = q <= w ? t : acc;
        }
        const float xc = __fdiv_rn(__fsub_rn(sx[srow<RING>(c)], acc), row[0]);
        sx[srow<RING>(c)] = xc;
#pragma unroll
        for (int q = CAP; q > 1; --q) xn[q] = xn[q - 1];
        xn[1] = xc;
      }
    }
    if (RING) {
      __syncwarp();  // lane 0's x of rows c0..c1-1
      store_rows<RING>(sx, gx, c0, c1, lane);
    }
  }
}

// The warp's slice of the block's shared memory at a run-time width
__device__ __forceinline__ float* team_smem_rt(int rows, int w) {
  extern __shared__ float smem[];
  return smem + (threadIdx.x / kTeam) * rows * (2 * w + 2);
}

template <int CAP, bool RING>
__global__ void __launch_bounds__(kTeam * kMaxGroup, 1)
lu_factor_solve_wide_kernel(const float* __restrict__ band,
                            const float* __restrict__ rhs, float* fband, float* x,
                            int n, int B, int G, int rows, int w, float clamp) {
  int lane, b;
  if (!team_of(G, B, lane, b)) return;
  const int R = 2 * w + 1;
  float* sb = team_smem_rt(rows, w);
  float* sx = sb + rows * R;
  const size_t off = (size_t)b * n * R;
  float* gx = x + (size_t)b * n;
  factor_rows_two_rows<CAP, true, RING>(sb, sx, band + off, rhs + (size_t)b * n,
                                        fband + off, gx, n, w, clamp, lane);
  backward_rows_rt<CAP, RING>(sb, sx, fband + off, gx, n, w, lane);
  if (!RING) store_x(sx, gx, n, lane);
}

template <int CAP, bool RING>
__global__ void __launch_bounds__(kTeam * kMaxGroup, 1)
lu_solve_wide_kernel(const float* __restrict__ fband, const float* __restrict__ rhs,
                     float* x, int n, int B, int G, int rows, int w) {
  int lane, b;
  if (!team_of(G, B, lane, b)) return;
  const int R = 2 * w + 1;
  float* sb = team_smem_rt(rows, w);
  float* sx = sb + rows * R;
  const float* gf = fband + (size_t)b * n * R;
  float* gx = x + (size_t)b * n;
  forward_rows_two<RING>(sb, sx, gf, rhs + (size_t)b * n, gx, n, w, lane);
  backward_rows_rt<CAP, RING>(sb, sx, gf, gx, n, w, lane);
  if (!RING) store_x(sx, gx, n, lane);
}

template <int CAP, bool RING>
__global__ void __launch_bounds__(kTeam * kMaxGroup, 1)
lu_factor_wide_kernel(const float* __restrict__ band, float* __restrict__ fband,
                      int n, int B, int G, int rows, int w, float clamp) {
  int lane, b;
  if (!team_of(G, B, lane, b)) return;
  float* sb = team_smem_rt(rows, w);
  const size_t off = (size_t)b * n * (2 * w + 1);
  factor_rows_two_rows<CAP, false, RING>(sb, nullptr, band + off, nullptr, fband + off,
                                         nullptr, n, w, clamp, lane);
}

// ---------------------------------------------------------------------------
// The block route (w > kMaxW, every width): a CTA an instance, in place in
// device memory, as csrc/fleet_banded.cu's block route.  The trailing
// square of (w + 1)^2 floats outgrows a warp's registers and, from
// w ~ 170, a block's shared memory, so the CTA copies the instance's band
// into the output band and factors it there, kSweep (4) steps a sweep
// (see block_lu_factor): the window (band rows c..c+w+3) moves through
// memory once every four steps, and each entry still takes its products
// in step order, each rounded first, as the plain version does.  At the game's
// (256, 3000, 381) the 256 windows (1.2 MB each) outgrow the L2, and the
// factor is bound by that traffic; a CTA holding several instances, so
// that the resident windows fit the L2, measured 3.2x slower (PERF.md).  The
// forward sweep runs a thread an offset, a barrier a row; the backward
// sweep's row sum is a thread's terms then a pairwise tree over the
// threads (backward_sum in kkt/fleet_banded.py), and one division.  x
// lives in the output vector throughout.  Rows past n are masked.
// ---------------------------------------------------------------------------

constexpr int kBlockMaxThreads = 1024;  // threads of a block-route CTA at most
constexpr int kSweep = 4;  // elimination steps a sweep over the window

// Threads of a block-route CTA (an offset 1..w each, whole warps, at most
// kBlockMaxThreads) and leaves of its reduction tree (the binding's
// block_threads and block_tree in kkt/fleet_banded.py).
inline int block_threads(int w) {
  const int t = kTeam * ((w + kTeam - 1) / kTeam);
  return t < kBlockMaxThreads ? t : kBlockMaxThreads;
}
inline int block_tree(int w) {
  int p = 1;
  while (p < block_threads(w)) p <<= 1;
  return p;
}

// dst[0..cnt) = src[0..cnt), the CTA's threads over the entries
__device__ __forceinline__ void block_copy(const float* src, float* dst, size_t cnt) {
  for (size_t i = threadIdx.x; i < cnt; i += blockDim.x) dst[i] = src[i];
}

// The sum of the CTA's partial sums v (one a thread) by a pairwise tree
// over P leaves (the blockDim.x partial sums, then zeros): each level
// adds the upper half to the lower, in shared memory down to 32 leaves,
// then by shuffles in warp 0.  The sum is thread 0's; the tree is free
// again after the caller's next block barrier.
__device__ __forceinline__ float block_tree_sum(float v, float* tree, int P) {
  const int t = threadIdx.x, T = blockDim.x;
  tree[t] = v;
  if (T + t < P) tree[T + t] = 0.0f;
  __syncthreads();
  for (int s = P / 2; s >= kTeam; s >>= 1) {
    if (t < s) tree[t] = __fadd_rn(tree[t], tree[t + s]);
    __syncthreads();
  }
  if (t < kTeam) {
    v = tree[t];
    for (int s = kTeam / 2; s >= 1; s >>= 1) {
      v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, s));
    }
  }
  return v;
}

// Step c's pivot row: the clamped pivot d, row[i] = l_i = row[i] / d
// (i = 1..w, a thread an offset), a block barrier; every thread has read
// row[0] before thread 0 stores d there.
__device__ __forceinline__ void block_lu_pivot(float* row, int w, float clamp) {
  const int t = threadIdx.x, T = blockDim.x;
  const float d = clamp_pivot(row[0], clamp);
  for (int i = 1 + t; i <= w; i += T) row[i] = __fdiv_rn(row[i], d);
  __syncthreads();
  if (t == 0) row[0] = d;
}

// Step j's update of band row r > j (relative to the sweep's first pivot
// row, `base`), in place: row r is step j's storage row m = r - j; its
// columns k <= w - m take l_{m+k} u_m, its columns w + q (q = 1..w - m)
// l_m u_{m+q}, from step j's pivot row; the threads over the entries.
__device__ __forceinline__ void block_lu_row_update(float* base, int w, int j, int r) {
  const int R = 2 * w + 1, t = threadIdx.x, T = blockDim.x;
  const float* l = base + (size_t)j * R;
  const float* u = l + w;
  float* dst = base + (size_t)r * R;
  const int m = r - j, e = w - m;
  for (int k = t; k <= 2 * e; k += T) {
    if (k <= e) {
      dst[k] = __fsub_rn(dst[k], __fmul_rn(l[m + k], u[m]));
    } else {
      const int q = k - e;
      dst[w + q] = __fsub_rn(dst[w + q], __fmul_rn(l[m], u[m + q]));
    }
  }
}

// Factor an instance's band A (n rows of 2w + 1 floats) in place, kSweep
// steps a sweep.  The sweep's pivot rows c..c+kSweep-1 go one at a time:
// pivot row c + j takes its earlier steps' updates, row by row (a block
// barrier each), and is then step c + j's pivot row.  Then each band row
// c + r, r = kSweep..w+kSweep-1, is loaded once and takes, entry by
// entry, the product of each step c + j that reaches it, in step order,
// each rounded before its subtraction: the plain version's roundings,
// while the window, which outgrows the L2 at the game's widths, moves
// through memory once every kSweep steps.  Step c + j's storage row for
// band row c + r is m = r - j: columns k <= w - m take l_{m+k} u_m,
// columns w + q (q <= w - m) l_m u_{m+q}, from pivot row c + j.
__device__ __forceinline__ void block_lu_factor(float* A, int n, int w, float clamp) {
  const int R = 2 * w + 1, t = threadIdx.x, T = blockDim.x;
  const int lane = t & (kTeam - 1), warp = t / kTeam, warps = T / kTeam;
  for (int c = 0; c < n; c += kSweep) {
    float* base = A + (size_t)c * R;
    const int np = min(kSweep, n - c);  // the sweep's pivot rows
    for (int j = 0; j < np; ++j) {
      block_lu_pivot(base + (size_t)j * R, w, clamp);
      for (int r = j + 1; r < np; ++r) {  // the later pivot rows take step j
        if (r - j <= w) block_lu_row_update(base, w, j, r);
        __syncthreads();
      }
    }
    if (np < kSweep) break;  // the last rows: nothing below them
    for (int r = kSweep + warp; r < w + kSweep && c + r < n; r += warps) {
      float* dst = base + (size_t)r * R;
      const int e = w - r + kSweep - 1;  // the last step's reach
      for (int k = lane; k <= 2 * e; k += kTeam) {
        const bool lower = k <= e;
        const int col = lower ? k : w + (k - e);
        float v = dst[col];
#pragma unroll
        for (int j = 0; j < kSweep; ++j) {
          const int m = r - j, ej = w - m;  // step j's storage row and reach
          const float* l = base + (size_t)j * R;
          const float* u = l + w;
          if (lower && m <= w && k <= ej) {
            v = __fsub_rn(v, __fmul_rn(l[m + k], u[m]));
          } else if (!lower && m <= w && k - e <= ej) {
            v = __fsub_rn(v, __fmul_rn(l[m], u[m + (k - e)]));
          }
        }
        dst[col] = v;
      }
    }
    __syncthreads();  // the next sweep's rows are final
  }
}

// Solve against an instance's factored band F (n rows of 2w + 1 floats)
// for x in place (x holds the right-hand side).
__device__ __forceinline__ void block_lu_solve(const float* F, float* x, int n, int w,
                                               float* tree, int P) {
  const int R = 2 * w + 1, t = threadIdx.x, T = blockDim.x;
  for (int c = 0; c < n; ++c) {
    const float* row = F + (size_t)c * R;
    const float y = x[c];
    for (int i = 1 + t; i <= w && c + i < n; i += T) {
      x[c + i] = __fsub_rn(x[c + i], __fmul_rn(row[i], y));
    }
    __syncthreads();  // y of row c + 1 is final
  }
  for (int c = n - 1; c >= 0; --c) {
    const float* row = F + (size_t)c * R;
    float acc = 0.0f;
    for (int q = 1 + t; q <= w; q += T) {
      acc = __fadd_rn(acc, __fmul_rn(row[w + q], c + q < n ? x[c + q] : 0.0f));
    }
    acc = block_tree_sum(acc, tree, P);
    if (t == 0) x[c] = __fdiv_rn(__fsub_rn(x[c], acc), row[0]);
    __syncthreads();  // x_c is final and the tree free
  }
}

// The block route's kernels: a CTA of block_threads(w) threads an
// instance, P = block_tree(w) floats of shared memory for the tree.
__global__ void __launch_bounds__(kBlockMaxThreads)
lu_factor_solve_block_kernel(const float* __restrict__ band, const float* __restrict__ rhs,
                             float* fband, float* x, int n, int w, int P, float clamp) {
  extern __shared__ float smem[];
  const size_t b = blockIdx.x, off = b * n * (2 * w + 1);
  block_copy(band + off, fband + off, (size_t)n * (2 * w + 1));
  block_copy(rhs + b * n, x + b * n, n);
  __syncthreads();
  block_lu_factor(fband + off, n, w, clamp);
  block_lu_solve(fband + off, x + b * n, n, w, smem, P);
}

__global__ void __launch_bounds__(kBlockMaxThreads)
lu_solve_block_kernel(const float* __restrict__ fband, const float* __restrict__ rhs,
                      float* x, int n, int w, int P) {
  extern __shared__ float smem[];
  const size_t b = blockIdx.x;
  block_copy(rhs + b * n, x + b * n, n);
  __syncthreads();
  block_lu_solve(fband + b * n * (2 * w + 1), x + b * n, n, w, smem, P);
}

__global__ void __launch_bounds__(kBlockMaxThreads)
lu_factor_block_kernel(const float* __restrict__ band, float* fband, int n, int w,
                       float clamp) {
  const size_t off = (size_t)blockIdx.x * n * (2 * w + 1);
  block_copy(band + off, fband + off, (size_t)n * (2 * w + 1));
  __syncthreads();
  block_lu_factor(fband + off, n, w, clamp);
}

// Grid, threads and shared memory of a block-route launch (the binding's
// plan: one instance a CTA, no ring); false for one the kernels do not take.
bool block_config(int n, int w, int B, int ring, int G, dim3& grid, dim3& threads,
                  size_t& smem, int& P) {
  if (n < 1 || B < 1 || w <= kMaxW || ring != 0 || G != 1) return false;
  grid = dim3(B);
  threads = dim3(block_threads(w));
  P = block_tree(w);
  smem = (size_t)P * sizeof(float);
  return true;
}

// The capacity a launch above kLaneRowW runs at
inline int wide_cap(int w) { return w <= 47 ? 47 : 63; }

template <typename K>
cudaError_t allow_smem(K kernel) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
  if (e == cudaSuccess) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  }
  return e;
}

template <int W>
cudaError_t allow_smem_w() {
  const cudaError_t es[] = {
      allow_smem(lu_factor_solve_kernel<W, false>), allow_smem(lu_factor_solve_kernel<W, true>),
      allow_smem(lu_solve_kernel<W, false>), allow_smem(lu_solve_kernel<W, true>),
      allow_smem(lu_factor_kernel<W, false>), allow_smem(lu_factor_kernel<W, true>)};
  for (cudaError_t e : es) {
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

template <int CAP>
cudaError_t allow_smem_wide() {
  const cudaError_t es[] = {
      allow_smem(lu_factor_solve_wide_kernel<CAP, false>),
      allow_smem(lu_factor_solve_wide_kernel<CAP, true>),
      allow_smem(lu_solve_wide_kernel<CAP, false>), allow_smem(lu_solve_wide_kernel<CAP, true>),
      allow_smem(lu_factor_wide_kernel<CAP, false>), allow_smem(lu_factor_wide_kernel<CAP, true>)};
  for (cudaError_t e : es) {
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

// Grid, block and shared memory of a launch (G warps of rows band rows
// and rows entries of x; the runtime refuses more than the opt-in);
// false for a shape the kernels do not take.
bool launch_config(int n, int w, int B, int G, int rows, dim3& grid, dim3& block,
                   size_t& smem) {
  if (n < 1 || B < 1 || G < 1 || G > kMaxGroup || w < 1 || w > kMaxW || rows < 1) {
    return false;
  }
  smem = (size_t)G * rows * (2 * w + 2) * sizeof(float);
  grid = dim3((B + G - 1) / G);
  block = dim3(kTeam * G);
  return true;
}

}  // namespace

#define TC_FOR_EACH_W(X)                                                      \
  X(1) X(2) X(3) X(4) X(5) X(6) X(7) X(8) X(9) X(10) X(11) X(12) X(13) X(14)  \
  X(15) X(16) X(17) X(18) X(19) X(20) X(21) X(22) X(23) X(24) X(25) X(26)     \
  X(27) X(28) X(29) X(30) X(31)
#define TC_FOR_EACH_CAP(X) X(47) X(63)

extern "C" {

int tc_banded_lu_max_w() { return kMaxW; }

// Once per device, before the first launch: the opt-in to dynamic shared
// memory up to the block cap, and the carveout that lets two 100 KB
// blocks share an SM.
int tc_banded_lu_init() {
  cudaError_t e = cudaSuccess;
#define X(WW) \
  if (e == cudaSuccess) e = allow_smem_w<WW>();
  TC_FOR_EACH_W(X)
#undef X
#define X(CC) \
  if (e == cudaSuccess) e = allow_smem_wide<CC>();
  TC_FOR_EACH_CAP(X)
#undef X
  return e;
}

// Each entry point launches on the given stream and returns
// cudaGetLastError() (cudaErrorInvalidValue for an unsupported shape,
// group or width).  ring selects the ring route, G the instances a CTA,
// rows the shared-memory rows an instance (the binding's launch plan).
int tc_banded_lu_factor_solve(int w, int ring, int G, int rows, const float* band,
                              const float* rhs, float* fband, float* x, int n,
                              int B, float clamp, void* stream) {
  dim3 grid, block;
  size_t smem;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w > kMaxW) {
    int P;
    if (!block_config(n, w, B, ring, G, grid, block, smem, P)) return cudaErrorInvalidValue;
    lu_factor_solve_block_kernel<<<grid, block, smem, s>>>(band, rhs, fband, x, n, w, P, clamp);
    return cudaGetLastError();
  }
  if (!launch_config(n, w, B, G, rows, grid, block, smem)) return cudaErrorInvalidValue;
  if (w > kLaneRowW) {
    switch (wide_cap(w)) {
#define X(CC)                                                                   \
  case CC:                                                                      \
    if (ring)                                                                   \
      lu_factor_solve_wide_kernel<CC, true><<<grid, block, smem, s>>>(band, rhs, fband, x, n, B, G, rows, w, clamp); \
    else                                                                        \
      lu_factor_solve_wide_kernel<CC, false><<<grid, block, smem, s>>>(band, rhs, fband, x, n, B, G, rows, w, clamp); \
    break;
      TC_FOR_EACH_CAP(X)
#undef X
    }
    return cudaGetLastError();
  }
  switch (w) {
#define X(WW)                                                                   \
  case WW:                                                                      \
    if (ring)                                                                   \
      lu_factor_solve_kernel<WW, true><<<grid, block, smem, s>>>(               \
          band, rhs, fband, x, n, B, G, rows, clamp);                           \
    else                                                                        \
      lu_factor_solve_kernel<WW, false><<<grid, block, smem, s>>>(              \
          band, rhs, fband, x, n, B, G, rows, clamp);                           \
    break;
    TC_FOR_EACH_W(X)
#undef X
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

int tc_banded_lu_solve(int w, int ring, int G, int rows, const float* fband,
                       const float* rhs, float* x, int n, int B, void* stream) {
  dim3 grid, block;
  size_t smem;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w > kMaxW) {
    int P;
    if (!block_config(n, w, B, ring, G, grid, block, smem, P)) return cudaErrorInvalidValue;
    lu_solve_block_kernel<<<grid, block, smem, s>>>(fband, rhs, x, n, w, P);
    return cudaGetLastError();
  }
  if (!launch_config(n, w, B, G, rows, grid, block, smem)) return cudaErrorInvalidValue;
  if (w > kLaneRowW) {
    switch (wide_cap(w)) {
#define X(CC)                                                                   \
  case CC:                                                                      \
    if (ring)                                                                   \
      lu_solve_wide_kernel<CC, true><<<grid, block, smem, s>>>(fband, rhs, x, n, B, G, rows, w); \
    else                                                                        \
      lu_solve_wide_kernel<CC, false><<<grid, block, smem, s>>>(fband, rhs, x, n, B, G, rows, w); \
    break;
      TC_FOR_EACH_CAP(X)
#undef X
    }
    return cudaGetLastError();
  }
  switch (w) {
#define X(WW)                                                                   \
  case WW:                                                                      \
    if (ring)                                                                   \
      lu_solve_kernel<WW, true><<<grid, block, smem, s>>>(                      \
          fband, rhs, x, n, B, G, rows);                                        \
    else                                                                        \
      lu_solve_kernel<WW, false><<<grid, block, smem, s>>>(                     \
          fband, rhs, x, n, B, G, rows);                                        \
    break;
    TC_FOR_EACH_W(X)
#undef X
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

int tc_banded_lu_factor(int w, int ring, int G, int rows, const float* band,
                        float* fband, int n, int B, float clamp, void* stream) {
  dim3 grid, block;
  size_t smem;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w > kMaxW) {
    int P;
    if (!block_config(n, w, B, ring, G, grid, block, smem, P)) return cudaErrorInvalidValue;
    lu_factor_block_kernel<<<grid, block, 0, s>>>(band, fband, n, w, clamp);
    return cudaGetLastError();
  }
  if (!launch_config(n, w, B, G, rows, grid, block, smem)) return cudaErrorInvalidValue;
  if (w > kLaneRowW) {
    switch (wide_cap(w)) {
#define X(CC)                                                                   \
  case CC:                                                                      \
    if (ring)                                                                   \
      lu_factor_wide_kernel<CC, true><<<grid, block, smem, s>>>(band, fband, n, B, G, rows, w, clamp); \
    else                                                                        \
      lu_factor_wide_kernel<CC, false><<<grid, block, smem, s>>>(band, fband, n, B, G, rows, w, clamp); \
    break;
      TC_FOR_EACH_CAP(X)
#undef X
    }
    return cudaGetLastError();
  }
  switch (w) {
#define X(WW)                                                                   \
  case WW:                                                                      \
    if (ring)                                                                   \
      lu_factor_kernel<WW, true><<<grid, block, smem, s>>>(                     \
          band, fband, n, B, G, rows, clamp);                                   \
    else                                                                        \
      lu_factor_kernel<WW, false><<<grid, block, smem, s>>>(                    \
          band, fband, n, B, G, rows, clamp);                                   \
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
