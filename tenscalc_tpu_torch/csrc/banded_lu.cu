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
// - Above W = 63 (every width the planner hands over) the block route:
//   the factor a CTA an instance in panels of nb steps (the panel's rows
//   in shared memory, factored left-looking, then a rank-nb update of the
//   trailing square in register tiles), the solve a warp an instance with
//   the factor's rows streamed through a shared-memory ring; K9 launches
//   the one, then the other (see its section below).
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
    !defined(TC_LU_MAX_GROUP) || !defined(TC_LU_SMEM_MAX) || \
    !defined(TC_LU_PANEL_THREADS) || !defined(TC_LU_SOLVE_RING)
#error "build with -DTC_LU_CHUNK_ROWS=... -DTC_LU_RING_ROWS=... -DTC_LU_MAX_GROUP=... -DTC_LU_SMEM_MAX=... -DTC_LU_PANEL_THREADS=... -DTC_LU_SOLVE_RING=... (kkt/banded_lu.py)"
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
// The block route (w > kMaxW, every width): a CTA an instance for the
// factor, a warp an instance for the solve.
//
// The factor (K11, and K9's first phase) takes panels of nb elimination
// steps (the binding's plan: nb pivot rows in shared memory, 64 at the
// game's w = 381).  A panel c..c+nb-1:
// 1. Its nb band rows come into shared memory by 4-byte cp.async, each in
//    a slot of S floats: band row c+j's lower columns 0..w (the matrix's
//    column c+j on and below the diagonal) at 0..w, its upper columns w+q
//    (row c+j right of the diagonal) at bU+q.  bU is w rounded up to 4 and
//    S is 1 mod 4, so that a step's factors at a 16-byte-aligned place of
//    the matrix are 16-byte aligned in shared memory.  An entry that an
//    earlier panel updated comes from the output band, any other from the
//    input band: the matrix's entry (i, j) takes its first product from
//    step max(i, j) - w.
// 2. Left-looking: band row c+j takes the products of steps c..c+j-1,
//    entry by entry in step order (a thread an entry; the steps that reach
//    it, a range worked out first, no branch in the loop), then its pivot
//    is clamped and its multipliers divided: two block barriers a step.
// 3. The panel's rows go back to the output band.
// 4. The rank-nb update of the trailing square, the matrix's rows and
//    columns c+nb..c+nb+w-1 (every entry a panel step reaches), in warp
//    tiles of 64 x 16 entries in the matrix's coordinates: the lower
//    triangle (an entry in its column's band row; lane l holds rows
//    64p + l and 64p + 32 + l of 16 columns) and the upper one (an entry
//    in its row's band row; a lane a column, of 16 rows) apart, so that
//    32 lanes load and store 32 consecutive floats.  Each entry is loaded
//    once, takes every panel step that reaches it in step order, and is
//    stored once; a step's 16 shared factors are four float4 broadcasts
//    and the lane's own two are scalar loads, for 32 products.  The first
//    steps of a tile at the square's far edge reach only part of its rows:
//    a select keeps the others as they are.
// Each entry takes its products in step order, each rounded before its
// subtraction (no FMA), and the pivot is clamped as the plain version
// does: bitwise.  The square (w^2 floats, 0.58 MB at w = 381) moves
// through memory once a panel, n / nb times.  The update is bound by the
// FP32 pipe (two instructions a product under the no-FMA contract); the
// left-looking panel by shared-memory loads (two a product).
//
// The solve (K10, and K9's second launch after the factor's): a warp an
// instance, G instances a CTA.  Each row's half of the factor (its l's
// for the forward sweep; its d and u's for the backward one) comes into
// a ring of kSolveRing slots by one bulk copy (TMA) of its
// 16-byte-aligned stretch, in groups of kSolveGroup rows whose copies
// complete on one mbarrier, three groups ahead; single entries of b and
// y by 4-byte cp.async; a sweep waits once a group.  The
// window of x that a row reaches lives in registers, 32 NL entries (NL =
// block_tree(w) / 32), lane l holding l + 32k, and moves by one entry a
// row (a shuffle a register).  What bounds a sweep is its chain of
// dependent rows: the forward one carries y (the next y is the entry
// after it minus one product, its other products a row old); the
// backward one carries x_c, whose row sum is backward_sum's tree
// (kkt/fleet_banded.py: T = block_threads(w) partial sums of a thread's
// terms from +0, padded with zeros to block_tree(w) leaves, each level
// adding the upper half to the lower): every leaf but u_1 x_{c+1} and
// every partial sum that lane 0 adds (a lane's registers' levels, then
// the five shuffle levels) is formed a row ahead, so x_c waits on a dozen
// additions in the tree's order, a subtraction and a division.  Each
// row's other work goes beside the chain.  y waits in the output vector
// between the sweeps.
//
// The solve a warp an instance takes w <= kBlockMaxThreads (1024), where
// the register window holds a row's reach and each thread of
// backward_sum's tree has one term; the factor's panel of 4 rows fits
// shared memory to w = 7252.  Past those widths each phase runs in
// device memory (the plan's group 0, or panel 0): a CTA of
// block_threads(w) threads an instance.  The factor copies
// the band into the output and factors it there, kInplaceSweep steps a
// sweep (the sweep's pivot rows one at a time, then each later row of
// the window loaded once and given the sweep's steps in order); the solve
// works in the output vector, a thread an offset, a block barrier a row,
// the backward sums a thread's terms and then backward_sum's tree in
// shared memory.  The same roundings in the same order: bitwise too.
// ---------------------------------------------------------------------------

constexpr int kBlockMaxThreads = 1024;  // threads of backward_sum's tree at most
constexpr int kPanelThreads = TC_LU_PANEL_THREADS;  // threads of a factor's CTA
constexpr int kTileRows = 2 * kTeam;  // a warp tile's rows (lower triangle), two a lane
constexpr int kTileCols = 16;         // a warp tile's columns: four float4 broadcasts
constexpr int kPanelPad = TC_LU_PANEL_PAD;  // floats a tile may read past the last slot
constexpr int kSolveRing = TC_LU_SOLVE_RING;  // factor rows in a solve's ring
constexpr int kSolveGroup = TC_LU_SOLVE_GROUP;  // rows a solve's copies land and are waited for together
constexpr int kSolveAhead = kSolveRing - kSolveGroup;  // rows staged ahead of a group
constexpr int kSolveMaxGroup = TC_LU_SOLVE_MAX_GROUP;  // solve instances a CTA, a warp each
constexpr int kInplaceSweep = 4;  // steps a sweep of the factor in device memory
// a lane's leaves of the tree: the kernels' instantiations (block_tree(w) / 32)
#define TC_FOR_EACH_LEAVES(X) X(2) X(4) X(8) X(16) X(32)
static_assert(kBlockMaxThreads / kTeam <= 32, "a lane's leaves are instantiated to 32");
static_assert(kPanelThreads % kTeam == 0 && kPanelThreads >= kTeam, "whole warps");
static_assert(kPanelPad >= kTileRows + kTileCols, "a tile's reads past the last slot");
static_assert((kSolveRing & (kSolveRing - 1)) == 0 && kSolveRing % kSolveGroup == 0 &&
                  kSolveAhead >= kSolveGroup && kSolveGroup <= kTeam,
              "the solve's ring is a power of two of whole groups, two at least");

// Threads of backward_sum's tree (an offset 1..w each, whole warps, at
// most kBlockMaxThreads) and its leaves (the binding's block_threads and
// block_tree in kkt/fleet_banded.py).
__host__ __device__ __forceinline__ int block_threads(int w) {
  const int t = kTeam * ((w + kTeam - 1) / kTeam);
  return t < kBlockMaxThreads ? t : kBlockMaxThreads;
}
__host__ __device__ __forceinline__ int block_tree(int w) {
  int p = 1;
  while (p < block_threads(w)) p <<= 1;
  return p;
}

// A panel slot: the upper columns from bU = panel_upper(w), S =
// panel_stride(w) floats, S - 1 a multiple of 4
__host__ __device__ __forceinline__ int panel_upper(int w) { return (w + 3) & ~3; }
__host__ __device__ __forceinline__ int panel_stride(int w) {
  const int s = panel_upper(w) + w + 1;
  return s + ((1 - s) & 3);
}
// A solve ring slot: the 16-byte chunk holding a row's column 0, then
// the 16-byte-aligned stretch holding w of its columns (at most w + 6
// floats)
__host__ __device__ __forceinline__ int solve_slot(int w) { return 4 + ((w + 6) & ~3); }
// Entries of a solve's x ring: a power of two past the farther of w and
// the register window (block_tree(w)), kSolveRing + 1 more
__host__ __device__ __forceinline__ int solve_xring(int w) {
  const int reach = w > block_tree(w) ? w : block_tree(w);
  int p = 1;
  while (p < reach + kSolveRing + 2) p <<= 1;
  return p;
}
// Floats of a solve warp's shared memory: its ring of rows, its x ring
// and an mbarrier (8 bytes) a group of the ring, for each sweep
__host__ __device__ __forceinline__ int solve_floats(int w) {
  return kSolveRing * solve_slot(w) + solve_xring(w) + 4 * (kSolveRing / kSolveGroup);
}
inline size_t panel_bytes(int w, int nb) {
  return sizeof(float) * ((size_t)nb * panel_stride(w) + kPanelPad);
}

// Panel rows c..c+np-1 into their slots (see the section's note), then a
// block barrier.
__device__ __forceinline__ void panel_load(float* sm, const float* A, const float* F, int c,
                                           int np, int w) {
  const int R = 2 * w + 1, S = panel_stride(w), bU = panel_upper(w);
  for (int j = 0; j < np; ++j) {
    const size_t g = (size_t)(c + j) * R;
    float* slot = sm + j * S;
    for (int col = threadIdx.x; col < R; col += blockDim.x) {
      const int off = col <= w ? col : col - w;  // the entry's distance from the diagonal
      const float* src = c > 0 && j + off < w ? F : A;
      cp_async4(slot + (col <= w ? col : bU + off), src + g + col);
    }
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
}

// Factor the panel's np rows in shared memory, left-looking.  Slot i
// holds step c+i's factors: l_x at i S + x, u_y at i S + bU + y.  Band row
// c+j's lower entry k (the matrix's (c+j+k, c+j)) takes l_{j-i+k} u_{j-i}
// of each step c+i with i >= j + k - w, its upper entry q ((c+j, c+j+q))
// l_{j-i} u_{j-i+q} of each with i >= j + q - w; from one step to the
// next both factors move S - 1 floats.  Then row c+j's pivot (thread 0's
// entry) is clamped and its multipliers divided by it.
__device__ __forceinline__ void panel_factor(float* sm, int np, int w, float clamp) {
  const int R = 2 * w + 1, S = panel_stride(w), S1 = S - 1, bU = panel_upper(w);
  const int t = threadIdx.x, T = blockDim.x;
  for (int j = 0; j < np; ++j) {
    float* row = sm + j * S;
    for (int e = t; e < R; e += T) {
      const bool lower = e <= w;
      const int off = lower ? e : e - w;
      const int i0 = max(0, j + off - w);
      const float* a = sm + i0 * S1 + (lower ? j + off : j);
      const float* b = sm + i0 * S1 + bU + (lower ? j : j + off);
      float* dst = row + (lower ? off : bU + off);
      float v = *dst;
      for (int i = i0; i < j; ++i, a += S1, b += S1) v = __fsub_rn(v, __fmul_rn(*a, *b));
      *dst = e == 0 ? clamp_pivot(v, clamp) : v;
    }
    __syncthreads();  // the pivot and the row's products are in place
    const float d = row[0];
    for (int k = 1 + t; k <= w; k += T) row[k] = __fdiv_rn(row[k], d);
    __syncthreads();  // the multipliers are in place
  }
}

// The panel's np rows from shared memory to the output band F.
__device__ __forceinline__ void panel_store(const float* sm, float* F, int c, int np, int w) {
  const int R = 2 * w + 1, S = panel_stride(w), bU = panel_upper(w);
  for (int j = 0; j < np; ++j) {
    float* dst = F + (size_t)(c + j) * R;
    const float* slot = sm + j * S;
    for (int col = threadIdx.x; col < R; col += blockDim.x) {
      dst[col] = slot[col <= w ? col : bU + col - w];
    }
  }
}

// A lane's 16 broadcast factors of a step: four aligned float4 loads.
__device__ __forceinline__ void load16(const float* p, float (&u)[kTileCols]) {
  const float4* p4 = reinterpret_cast<const float4*>(p);
#pragma unroll
  for (int k = 0; k < kTileCols / 4; ++k) {
    const float4 v = p4[k];
    u[4 * k] = v.x;
    u[4 * k + 1] = v.y;
    u[4 * k + 2] = v.z;
    u[4 * k + 3] = v.w;
  }
}

// One warp tile of the rank-nb update after panel c (the trailing square's
// entry (I, J) is the matrix's (c+nb+I, c+nb+J)).  Lower (UPPER false):
// entries I >= J, lane rows P = I = p0 + lane + 32h, columns Q = J =
// q0..q0+15, each in band row c+nb+J at column I - J; its step s factor
// is l at slot s's I + nb - s (the lane's own) times u at bU + J + nb - s
// (broadcast).  Upper: entries I < J, P = J, Q = I, in band row c+nb+I at
// column w + J - I, the lane's own factor u and the broadcast one l.
// Either way entry (P, Q) takes steps s >= P + nb - w (its reach; P is
// max(I, J)) of the panel's nb, in order; its source is the output band
// if an earlier panel reached it (P < w - nb), else the input band.
template <bool UPPER>
__device__ __forceinline__ void trailing_tile(const float* sm, const float* A, float* F, int c,
                                              int nb, int w, int qmax, int p0, int q0,
                                              int lane) {
  constexpr int H = kTileRows / kTeam, C = kTileCols;
  const int R = 2 * w + 1, S1 = panel_stride(w) - 1, bU = panel_upper(w);
  const size_t first = (size_t)(c + nb) * R + (UPPER ? w : 0);
  float* G = F + first;  // entry (P, Q) at G[Q R + P - Q]
  float acc[H][C];
  int P[H], lo[H];
#pragma unroll
  for (int h = 0; h < H; ++h) {
    P[h] = p0 + kTeam * h + lane;
    lo[h] = P[h] + nb - w;
    const float* src = c > 0 && P[h] < w - nb ? G : A + first;
#pragma unroll
    for (int q = 0; q < C; ++q) {
      const int Q = q0 + q;
      const bool ok = P[h] < w && Q < qmax && (UPPER ? P[h] > Q : P[h] >= Q);
      acc[h][q] = ok ? src[(size_t)Q * R + P[h] - Q] : 0.0f;
    }
  }
  const float* own = sm + (UPPER ? bU : 0) + nb;  // + s (S - 1) + P
  const float* bc = sm + (UPPER ? 0 : bU) + nb + q0;  // + s (S - 1): 16 floats
  // from s1 on every row of the tile takes every step
  const int s0 = max(0, p0 + nb - w), s1 = max(0, min(p0 + kTileRows, w) - 1 + nb - w);
  for (int s = s0; s < s1; ++s) {
    float f[H], u[C];
    load16(bc + s * S1, u);
#pragma unroll
    for (int h = 0; h < H; ++h) f[h] = own[s * S1 + P[h]];
#pragma unroll
    for (int h = 0; h < H; ++h) {
      const bool on = s >= lo[h];
#pragma unroll
      for (int q = 0; q < C; ++q) {
        const float v = __fsub_rn(acc[h][q], __fmul_rn(f[h], u[q]));
        acc[h][q] = on ? v : acc[h][q];
      }
    }
  }
#pragma unroll 2
  for (int s = s1; s < nb; ++s) {
    float f[H], u[C];
    load16(bc + s * S1, u);
#pragma unroll
    for (int h = 0; h < H; ++h) f[h] = own[s * S1 + P[h]];
#pragma unroll
    for (int h = 0; h < H; ++h) {
#pragma unroll
      for (int q = 0; q < C; ++q) acc[h][q] = __fsub_rn(acc[h][q], __fmul_rn(f[h], u[q]));
    }
  }
#pragma unroll
  for (int h = 0; h < H; ++h) {
#pragma unroll
    for (int q = 0; q < C; ++q) {
      const int Q = q0 + q;
      if (P[h] < w && Q < qmax && (UPPER ? P[h] > Q : P[h] >= Q)) {
        G[(size_t)Q * R + P[h] - Q] = acc[h][q];
      }
    }
  }
}

// The rank-nb update after a full panel c: the trailing square's tiles
// (columns Q < qmax, band rows before n), lower and upper in turn, dealt
// to the warps round robin.
__device__ __forceinline__ void trailing_update(const float* sm, const float* A, float* F, int c,
                                                int nb, int n, int w) {
  const int qmax = min(w, n - c - nb);
  const int lane = threadIdx.x & (kTeam - 1), warp = threadIdx.x / kTeam;
  const int warps = blockDim.x / kTeam;
  const int npb = (w + kTileRows - 1) / kTileRows, nqb = (qmax + kTileCols - 1) / kTileCols;
  int k = 0;
  for (int qb = 0; qb < nqb; ++qb) {
    for (int pb = qb * kTileCols / kTileRows; pb < npb; ++pb, k += 2) {
      if (k % warps == warp) {
        trailing_tile<false>(sm, A, F, c, nb, w, qmax, pb * kTileRows, qb * kTileCols, lane);
      }
      if ((k + 1) % warps == warp) {
        trailing_tile<true>(sm, A, F, c, nb, w, qmax, pb * kTileRows, qb * kTileCols, lane);
      }
    }
  }
}

// Factor an instance's band A (n rows of 2w + 1 floats) into F, panels
// of nb steps (see the section's note); ends with a block barrier.
__device__ __forceinline__ void block_lu_factor(float* sm, const float* A, float* F, int n,
                                                int w, int nb, float clamp) {
  for (int c = 0; c < n; c += nb) {
    const int np = min(nb, n - c);
    panel_load(sm, A, F, c, np, w);
    panel_factor(sm, np, w, clamp);
    panel_store(sm, F, c, np, w);
    if (np == nb && c + nb < n) trailing_update(sm, A, F, c, nb, n, w);
    __syncthreads();  // F holds the next panel's rows; the slots are free
  }
}

// The solve's copies of factor rows: a bulk copy (TMA) of a 16-byte-aligned
// stretch of global memory into shared memory, its completion counted in
// bytes on an mbarrier of one arrival a phase.
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void bar_init(unsigned long long* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}
// the barriers' initialization, and the earlier generic writes to the
// ring, ordered before the bulk copies
__device__ __forceinline__ void bar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// The lane-predicated forms (p false: nothing) keep a warp from branching.
__device__ __forceinline__ void bar_expect(bool p, unsigned long long* bar, unsigned bytes) {
  asm volatile("{\n .reg .pred q;\n setp.ne.b32 q, %2, 0;\n"
               " @q mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n}\n"
               ::"r"(smem_addr(bar)), "r"(bytes), "r"(static_cast<int>(p)) : "memory");
}
__device__ __forceinline__ void bulk_copy(bool p, float* dst, const float* src, unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "{\n .reg .pred q;\n setp.ne.b32 q, %4, 0;\n"
      " @q cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n}\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar)), "r"(static_cast<int>(p))
      : "memory");
}
__device__ __forceinline__ void cp_async4_if(bool p, float* dst, const float* src) {
  asm volatile("{\n .reg .pred q;\n setp.ne.b32 q, %2, 0;\n"
               " @q cp.async.ca.shared.global [%0], [%1], 4;\n}\n"
               ::"r"(smem_addr(dst)), "l"(src), "r"(static_cast<int>(p)) : "memory");
}
__device__ __forceinline__ void bar_wait(unsigned long long* bar, unsigned parity) {
  asm volatile(
      "{\n .reg .pred p;\n LAB_WAIT:\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      " @p bra DONE;\n bra LAB_WAIT;\n DONE:\n}\n"
      ::"r"(smem_addr(bar)), "r"(parity) : "memory");
}

// p's offset in floats within its 16-byte chunk
__device__ __forceinline__ int chunk_offset(const float* p) {
  return static_cast<int>((reinterpret_cast<size_t>(p) >> 2) & 3);
}

// Start copying band row r's columns col0..col0+w-1 (and, with HEAD, the
// 16-byte chunk holding its column 0) into a ring slot: the chunk to
// slot[0..4), the columns' 16-byte-aligned stretch from slot[4], so that
// column col0 + i lands at slot[4 + chunk_offset(row + col0) + i]; one
// arrival on bar where arrive holds, the copies where p holds too (a row
// past the band arrives with no bytes).
template <bool HEAD>
__device__ __forceinline__ void solve_stage(bool arrive, bool p, float* slot, const float* row,
                                            int col0, int w, unsigned long long* bar) {
  const float* c = row + col0;
  const float* a = c - chunk_offset(c);
  const unsigned bytes = 16u * static_cast<unsigned>((chunk_offset(c) + w + 3) / 4);
  bar_expect(arrive, bar, p ? bytes + (HEAD ? 16u : 0u) : 0u);
  bulk_copy(arrive && p, slot + 4, a, bytes, bar);
  if (HEAD) bulk_copy(arrive && p, slot, row - chunk_offset(row), 16u, bar);
}

// Solve (L U) x = b against an instance's factored band F on one warp
// (solve_floats(w) floats of shared memory at sm, 16-byte aligned).  NL:
// a lane's leaves of backward_sum's tree, block_tree(w) / 32, w <=
// kBlockMaxThreads.  Both sweeps keep a window of WR = 32 NL entries of
// x in registers, lane l holding entries l + 32k (k < NL) past the row's
// first (the forward sweep: x_c.. ; the backward: x_{c+1}..), and move it
// by one entry a row with one shuffle a register.  Each sweep carries
// its chain of dependent rows in a few registers and works a row's
// independent part beside it: the forward sweep's next y is the entry
// after y, updated by y alone (its other products came a row earlier);
// the backward sweep's next sum is its tree with every leaf but u_1 x_c
// added up a row ahead (a lane's registers' partial sums, and the five
// shuffle levels' partners of lane 0), so x_c adds u_1 x_c and a dozen
// partial sums in the tree's order, a subtraction and a division.
// Factor rows arrive by bulk copies in groups of kSolveGroup rows, a
// group's copies on one mbarrier, three groups ahead; single entries of
// b and y by 4-byte cp.async, a group of them with each group of rows;
// a sweep waits once a group.  Lanes 0..7 start a group's copies, and
// every lane stores (x into its ring, y and x to memory 32 rows at a
// time), so no lane branches alone.  The forward sweep keeps the entries
// of its window from WR on (w >= WR: w = WR, a power of two) in the x
// ring.  Entries past n are zeros.
template <bool B>
struct Flag {  // a compile-time choice passed to a generic lambda
  static constexpr bool value = B;
};

template <int NL>
__device__ __forceinline__ void block_lu_solve(const float* F, const float* b, float* x,
                                               float* sm, int n, int w) {
  constexpr int D = kSolveRing, G = kSolveGroup, NG = D / G, AG = kSolveAhead / G;
  constexpr int WR = kTeam * NL, LOG_NL = NL >= 32 ? 5 : NL >= 16 ? 4 : NL >= 8 ? 3
                                                    : NL >= 4 ? 2 : 1;
  static_assert(NL >= 2 && (NL & (NL - 1)) == 0 && NL <= 32, "a lane's leaves");
  const int lane = threadIdx.x & (kTeam - 1), SL = solve_slot(w);
  const size_t R = 2 * (size_t)w + 1;
  float* xs = sm + D * SL;
  const int XM = solve_xring(w) - 1;
  unsigned long long* fbar = reinterpret_cast<unsigned long long*>(xs + XM + 1);
  unsigned long long* bbar = fbar + NG;
  if (lane == 0) {
    for (int i = 0; i < 2 * NG; ++i) bar_init(fbar + i, G);
    bar_fence_init();
  }
  __syncwarp();
  float v[NL], t[NL];
  // ---- forward: window v[k] = x_{c+lane+32k} (all products of rows
  // before c); y = y_c and x1 = x_{c+1} before row c's product, in every
  // lane; lane c mod 32 keeps y_c for x.  Row group j (rows jG..jG+G-1)
  // brings b's entries W2 + jG .. W2 + jG + G - 1 into the x ring (group
  // 0 also those from WR on), where rows from jG on first reach them.
  const int W2 = w > WR ? w : WR;
#pragma unroll
  for (int k = 0; k < NL; ++k) {
    const int e = lane + kTeam * k;
    v[k] = e < n ? b[e] : 0.0f;
  }
  float y = b[0], x1 = n > 1 ? b[1] : 0.0f, yk = 0.0f;
  auto forward_group = [&](int j) {  // start row group j's copies: a cp.async group
    const int r = j * G + lane;
    solve_stage<false>(lane < G, r < n, sm + (r % D) * SL, F + r * R, 1, w, fbar + j % NG);
    for (int e = (j == 0 ? WR : W2 + j * G) + lane; e < min(n, W2 + (j + 1) * G); e += kTeam) {
      cp_async4(xs + (e & XM), b + e);
    }
    cp_async_commit();
  };
  // row c: its products, the chain's next y, the window moved on; with
  // big (w >= WR) the window's entries from WR on in the x ring
  auto forward_row = [&](int c, auto big) {
    const float* l = sm + (c % D) * SL + 4 + chunk_offset(F + c * R + 1) - 1;  // l_o at l[o]
    const int m = min(w, n - 1 - c);  // offsets 1..m take row c's products
    const float yn = __fsub_rn(x1, __fmul_rn(l[1], y));  // y_{c+1}: the chain
    yk = lane == (c & (kTeam - 1)) ? y : yk;
#pragma unroll
    for (int k = 0; k < NL; ++k) {
      const int o = lane + kTeam * k;
      const float nv = __fsub_rn(v[k], __fmul_rn(l[min(o, w)], y));
      v[k] = o >= 1 && o <= m ? nv : v[k];
    }
    x1 = __shfl_sync(0xffffffffu, v[0], 2);  // x_{c+2} after row c
    if constexpr (decltype(big)::value) {
      for (int o = WR + lane; o <= m; o += kTeam) {
        float* e = xs + ((c + o) & XM);
        *e = __fsub_rn(*e, __fmul_rn(l[o], y));
      }
      __syncwarp();  // the ring's entries of this row are in place
    }
    const float top = lane == kTeam - 1 && c + WR < n ? xs[(c + WR) & XM] : 0.0f;
#pragma unroll
    for (int k = 0; k < NL; ++k) t[k] = __shfl_sync(0xffffffffu, v[k], (lane + 1) & (kTeam - 1));
#pragma unroll
    for (int k = 0; k < NL; ++k) {
      v[k] = lane == kTeam - 1 ? (k + 1 < NL ? t[k + 1 < NL ? k + 1 : k] : top) : t[k];
    }
    y = yn;
  };
  // a group's rows in one straight run (a whole group unrolled), so that
  // a row's chain and the rows' other work interleave; then the group's y
  auto forward_sweep = [&](auto big) {
    for (int j = 0; j < AG; ++j) forward_group(j);
    for (int j = 0; j * G < n; ++j) {
      forward_group(j + AG);
      cp_async_wait<AG>();  // row group j's entries of b
      bar_wait(fbar + j % NG, (j / NG) & 1);  // its rows
      __syncwarp();
      const int c0 = j * G, c1 = min(n, c0 + G);
      if (c1 == c0 + G) {
#pragma unroll
        for (int i = 0; i < G; ++i) forward_row(c0 + i, big);
      } else {
        for (int c = c0; c < c1; ++c) forward_row(c, big);
      }
      const int e = c0 + ((lane - c0) & (kTeam - 1));  // lane's row of these
      if (e < c1) x[e] = yk;
    }
  };
  if (w >= WR) {
    forward_sweep(Flag<true>());
  } else {
    forward_sweep(Flag<false>());
  }
  cp_async_wait<0>();
  asm volatile("membar.cta;\n" ::: "memory");  // the lanes' y, which they copy back below
  __syncwarp();
  // ---- backward: window v[k] = x_{c+1+lane+32k} (zeros past n); x_c =
  // (y_c - backward_sum(u_q x_{c+q})) / d_c.  Rows go in groups of G from
  // the last (row c is q = n-1-c from it); group j's y come into the x
  // ring with its rows, and x_c goes to x.  Carried from the row before (row c+1's): xp =
  // x_{c+1} and, for row c, lane 0's register partners pk[] and shuffle
  // partners ps[] of the tree, its u's, d and y.
  for (int i = lane; i < w; i += kTeam) xs[(n + i) & XM] = 0.0f;
  auto backward_group = [&](int j) {
    const int q = j * G + lane, r = n - 1 - q;
    solve_stage<true>(lane < G, r >= 0, sm + (q % D) * SL, F + r * R, w + 1, w, bbar + j % NG);
    cp_async4_if(lane < G && r >= 0, xs + (r & XM), x + r);
    cp_async_commit();
  };
  float pk[LOG_NL], ps[5], u1 = 0.0f, d = 1.0f, yc = 0.0f, xp = 0.0f, xk = 0.0f;
#pragma unroll
  for (int k = 0; k < NL; ++k) v[k] = 0.0f;
  // the partial sums of row c's tree but leaf 0 of lane 0, from the
  // window of row c (v, lane 0's v[0] not read) and its slot
  auto partials = [&](int c, int q) {
    const float* slot = sm + (q % D) * SL;
    const float* u = slot + 4 + chunk_offset(F + c * R + w + 1) - 1;  // u_o at u[o]
    float acc[NL];
    // leaf t = lane + 32 k: thread t's term u_{t+1} x_{c+1+t} (w <= T =
    // block_threads(w): one term at most), from +0 (a leaf with none
    // stays +0)
#pragma unroll
    for (int k = 0; k < NL; ++k) {
      const int i = lane + kTeam * k;
      const float a = __fadd_rn(0.0f, __fmul_rn(u[1 + min(i, w - 1)], v[k]));
      acc[k] = i < w ? a : 0.0f;
    }
    // the tree's levels down to 32 leaves pair a lane's registers k and
    // k + s; register 0's partner at each level is kept apart
    int j = 0;
#pragma unroll
    for (int s = NL / 2; s >= 1; s >>= 1, ++j) {
      pk[j] = acc[s];
#pragma unroll
      for (int k = 1; k < s; ++k) acc[k] = __fadd_rn(acc[k], acc[k + s]);
    }
    float sum = acc[0];  // every lane's but lane 0's: its whole tree
#pragma unroll
    for (int i = 0; i < LOG_NL; ++i) sum = __fadd_rn(sum, pk[i]);
    // the five shuffle levels: lane 0 takes its partner at each
    j = 0;
#pragma unroll
    for (int s = kTeam / 2; s >= 1; s >>= 1, ++j) {
      ps[j] = __shfl_down_sync(0xffffffffu, sum, s);
      sum = __fadd_rn(sum, ps[j]);
    }
    u1 = u[1];
    d = slot[chunk_offset(F + c * R)];
    yc = xs[c & XM];
  };
  // row c: the chain (lane 0's leaf 0, u_1 x_{c+1}, then its partners in
  // the tree's order), and beside it row c-1's window and partial sums
  // (at c = 0 formed and not read)
  auto backward_row = [&](int c) {
    float a = __fadd_rn(0.0f, __fmul_rn(u1, xp));
#pragma unroll
    for (int i = 0; i < LOG_NL; ++i) a = __fadd_rn(a, pk[i]);
#pragma unroll
    for (int i = 0; i < 5; ++i) a = __fadd_rn(a, ps[i]);
    const float xc = __fdiv_rn(__fsub_rn(yc, a), d);  // lane 0's
    // row c-1's window: row c's with x_{c+1} in lane 0's first register,
    // moved up one entry (x_c, lane 0's first register, not read)
    v[0] = lane == 0 ? xp : v[0];
#pragma unroll
    for (int k = 0; k < NL; ++k) {
      t[k] = __shfl_sync(0xffffffffu, v[k], (lane + kTeam - 1) & (kTeam - 1));
    }
#pragma unroll
    for (int k = 0; k < NL; ++k) v[k] = lane == 0 ? (k == 0 ? 0.0f : t[k > 0 ? k - 1 : 0]) : t[k];
    partials(c - 1, n - c);
    const float xb = __shfl_sync(0xffffffffu, xc, 0);
    xk = lane == (c & (kTeam - 1)) ? xb : xk;
    xp = xc;
  };
  // group j's rows (q = jG..jG+G-1) in one straight run, group j + 1's
  // copies waited for first (the group's last row forms the next one's
  // partial sums); then the group's x
  auto backward_sweep = [&]() {
    for (int j = 0; j < AG; ++j) backward_group(j);
    cp_async_wait<AG - 1>();  // group 0's y
    bar_wait(bbar, 0);  // its rows
    __syncwarp();
    partials(n - 1, 0);
    for (int j = 0; j * G < n; ++j) {
      backward_group(j + AG);
      cp_async_wait<AG - 1>();  // group j + 1's y
      bar_wait(bbar + (j + 1) % NG, ((j + 1) / NG) & 1);  // its rows
      __syncwarp();
      const int c0 = n - 1 - j * G, c1 = max(-1, c0 - G);  // rows c0 down to c1 + 1
      if (c1 == c0 - G) {
#pragma unroll
        for (int i = 0; i < G; ++i) backward_row(c0 - i);
      } else {
        for (int c = c0; c > c1; --c) backward_row(c);
      }
      const int e = c1 + 1 + ((lane - c1 - 1) & (kTeam - 1));  // lane's row of these
      if (e <= c0) x[e] = xk;
    }
  };
  backward_sweep();
  cp_async_wait<0>();
}

// ---- the phases in device memory (see the section's note)

// dst[0..cnt) = src[0..cnt), the CTA's threads over the entries
__device__ __forceinline__ void inplace_copy(const float* src, float* dst, size_t cnt) {
  for (size_t i = threadIdx.x; i < cnt; i += blockDim.x) dst[i] = src[i];
}

// The sum of the CTA's partial sums v (one a thread) by a pairwise tree
// over P leaves (the blockDim.x partial sums, then zeros): each level
// adds the upper half to the lower, in shared memory down to 32 leaves,
// then by shuffles in warp 0.  The sum is thread 0's; the tree is free
// again after the caller's next block barrier.
__device__ __forceinline__ float inplace_tree_sum(float v, float* tree, int P) {
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
__device__ __forceinline__ void inplace_pivot(float* row, int w, float clamp) {
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
__device__ __forceinline__ void inplace_row_update(float* base, int w, int j, int r) {
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

// Factor an instance's band A (n rows of 2w + 1 floats) in place,
// kInplaceSweep steps a sweep: the sweep's pivot rows c + j one at a
// time (each takes its earlier steps' updates, a block barrier a row,
// and is then step c + j's pivot row); then each band row c + r, r =
// kInplaceSweep..w+kInplaceSweep-1, is loaded once and takes, entry by
// entry, the product of each step c + j that reaches it, in step order.
// Step c + j's storage row for band row c + r is m = r - j: columns k <=
// w - m take l_{m+k} u_m, columns w + q (q <= w - m) l_m u_{m+q}.
__device__ __forceinline__ void inplace_lu_factor(float* A, int n, int w, float clamp) {
  constexpr int K = kInplaceSweep;
  const int R = 2 * w + 1, t = threadIdx.x, T = blockDim.x;
  const int lane = t & (kTeam - 1), warp = t / kTeam, warps = T / kTeam;
  for (int c = 0; c < n; c += K) {
    float* base = A + (size_t)c * R;
    const int np = min(K, n - c);  // the sweep's pivot rows
    for (int j = 0; j < np; ++j) {
      inplace_pivot(base + (size_t)j * R, w, clamp);
      for (int r = j + 1; r < np; ++r) {  // the later pivot rows take step j
        if (r - j <= w) inplace_row_update(base, w, j, r);
        __syncthreads();
      }
    }
    if (np < K) break;  // the last rows: nothing below them
    for (int r = K + warp; r < w + K && c + r < n; r += warps) {
      float* dst = base + (size_t)r * R;
      const int e = w - r + K - 1;  // the last step's reach
      for (int k = lane; k <= 2 * e; k += kTeam) {
        const bool lower = k <= e;
        const int col = lower ? k : w + (k - e);
        float v = dst[col];
#pragma unroll
        for (int j = 0; j < K; ++j) {
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
// for x in place (x holds the right-hand side); P = block_tree(w) floats
// of shared memory for the tree.
__device__ __forceinline__ void inplace_lu_solve(const float* F, float* x, int n, int w,
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
    acc = inplace_tree_sum(acc, tree, P);
    if (t == 0) x[c] = __fdiv_rn(__fsub_rn(x[c], acc), row[0]);
    __syncthreads();  // x_c is final and the tree free
  }
}

// The block route's kernels.  The factor (K11, and K9's first launch): a
// CTA of kPanelThreads threads an instance, panel_bytes(w, nb) of shared
// memory.  The solve (K10, and K9's second launch): G warps a CTA, an
// instance each, solve_floats(w) floats a warp.  K9 is the two launches
// in turn: a factor CTA's 100-200 KB of shared memory would otherwise sit
// idle through its instance's solve.  Either phase in device memory: a
// CTA of block_threads(w) threads an instance (the solve's tree in
// block_tree(w) floats of shared memory).
template <int NL>
__global__ void __launch_bounds__(kTeam * kSolveMaxGroup, 1)
lu_solve_block_kernel(const float* __restrict__ fband, const float* __restrict__ rhs,
                      float* x, int n, int B, int w) {
  extern __shared__ float smem[];
  const int g = threadIdx.x / kTeam;
  const size_t b = (size_t)blockIdx.x * (blockDim.x / kTeam) + g;
  if (b >= (size_t)B) return;
  block_lu_solve<NL>(fband + b * n * (2 * w + 1), rhs + b * n, x + b * n,
                     smem + (size_t)g * solve_floats(w), n, w);
}

__global__ void __launch_bounds__(kPanelThreads, 1)
lu_factor_block_kernel(const float* __restrict__ band, float* fband, int n, int w, int nb,
                       float clamp) {
  extern __shared__ float smem[];
  const size_t off = (size_t)blockIdx.x * n * (2 * w + 1);
  block_lu_factor(smem, band + off, fband + off, n, w, nb, clamp);
}

__global__ void __launch_bounds__(kBlockMaxThreads)
lu_solve_inplace_kernel(const float* __restrict__ fband, const float* __restrict__ rhs,
                        float* x, int n, int w) {
  extern __shared__ float smem[];
  const size_t b = blockIdx.x;
  inplace_copy(rhs + b * n, x + b * n, n);
  __syncthreads();
  inplace_lu_solve(fband + b * n * (2 * w + 1), x + b * n, n, w, smem, block_tree(w));
}

__global__ void __launch_bounds__(kBlockMaxThreads)
lu_factor_inplace_kernel(const float* __restrict__ band, float* fband, int n, int w,
                         float clamp) {
  const size_t off = (size_t)blockIdx.x * n * (2 * w + 1);
  inplace_copy(band + off, fband + off, (size_t)n * (2 * w + 1));
  __syncthreads();
  inplace_lu_factor(fband + off, n, w, clamp);
}

// Shared memory of a block-route launch of the factor (nb steps a panel;
// 0: in device memory) or of the solve (G instances a CTA; 0: in device
// memory), from the binding's plan; -1 for a plan the kernels do not
// take: a panel that is no multiple of 4 from 4 to w, a group past
// kSolveMaxGroup, a warp's solve past w = kBlockMaxThreads, or either
// past the block's shared-memory cap.
long long block_smem(int w, int G, int nb, bool factor) {
  if (w <= kMaxW) return -1;
  size_t smem;
  if (factor) {
    if (nb != 0 && (nb < 4 || nb % 4 != 0 || nb > w)) return -1;
    smem = nb == 0 ? 0 : panel_bytes(w, nb);
  } else {
    if (G < 0 || G > kSolveMaxGroup || (G > 0 && w > kBlockMaxThreads)) return -1;
    smem = sizeof(float) * (G == 0 ? (size_t)block_tree(w) : G * (size_t)solve_floats(w));
  }
  return smem <= (size_t)kSmemMax ? (long long)smem : -1;
}

// Grid, threads and shared memory of a block-route launch of the factor
// or of the solve, from the binding's plan: no ring, G instances a solve
// CTA, nb (the plan's rows) steps a factor panel (block_smem); false for
// one the kernels do not take.
bool block_config(int n, int w, int B, int ring, int G, int nb, bool factor,
                  dim3& grid, dim3& threads, size_t& smem) {
  const long long bytes = block_smem(w, G, nb, factor);
  if (n < 1 || B < 1 || ring != 0 || bytes < 0) return false;
  smem = (size_t)bytes;
  if (factor) {
    grid = dim3(B);
    threads = dim3(nb == 0 ? block_threads(w) : kPanelThreads);
  } else {
    grid = dim3(G == 0 ? B : (B + G - 1) / G);
    threads = dim3(G == 0 ? block_threads(w) : kTeam * G);
  }
  return true;
}

// The block route's factor launch: in panels of nb steps, or in device
// memory (nb = 0).
cudaError_t launch_block_factor(const float* band, float* fband, int n, int w, int nb,
                                float clamp, dim3 grid, dim3 block, size_t smem,
                                cudaStream_t s) {
  if (nb == 0) {
    lu_factor_inplace_kernel<<<grid, block, smem, s>>>(band, fband, n, w, clamp);
  } else {
    lu_factor_block_kernel<<<grid, block, smem, s>>>(band, fband, n, w, nb, clamp);
  }
  return cudaGetLastError();
}

// The block route's solve launch: a warp an instance at a lane's
// block_tree(w) / 32 leaves, or in device memory (G = 0).
cudaError_t launch_block_solve(const float* fband, const float* rhs, float* x, int n, int B,
                               int w, int G, dim3 grid, dim3 block, size_t smem,
                               cudaStream_t s) {
  if (G == 0) {
    lu_solve_inplace_kernel<<<grid, block, smem, s>>>(fband, rhs, x, n, w);
    return cudaGetLastError();
  }
  switch (block_tree(w) / kTeam) {
#define X(LL)                                                                   \
  case LL:                                                                      \
    lu_solve_block_kernel<LL><<<grid, block, smem, s>>>(fband, rhs, x, n, B, w);        \
    break;
    TC_FOR_EACH_LEAVES(X)
#undef X
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
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
#define X(LL) \
  if (e == cudaSuccess) e = allow_smem(lu_solve_block_kernel<LL>);
  TC_FOR_EACH_LEAVES(X)
#undef X
  if (e == cudaSuccess) e = allow_smem(lu_factor_block_kernel);
  return e;
}

// Shared memory of a block-route launch of the factor (factor != 0, nb
// steps a panel) or of the solve (G instances a CTA); 0 for a phase in
// device memory that needs none, -1 for a plan the kernels refuse.
long long tc_banded_lu_block_smem(int w, int G, int nb, int factor) {
  return block_smem(w, G, nb, factor != 0);
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
  if (w > kMaxW) {  // the factor, then the solve
    dim3 sgrid, sblock;
    size_t ssmem;
    if (!block_config(n, w, B, ring, G, rows, true, grid, block, smem) ||
        !block_config(n, w, B, ring, G, rows, false, sgrid, sblock, ssmem)) {
      return cudaErrorInvalidValue;
    }
    const cudaError_t e = launch_block_factor(band, fband, n, w, rows, clamp, grid, block, smem, s);
    if (e != cudaSuccess) return e;
    return launch_block_solve(fband, rhs, x, n, B, w, G, sgrid, sblock, ssmem, s);
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
    if (!block_config(n, w, B, ring, G, rows, false, grid, block, smem)) {
      return cudaErrorInvalidValue;
    }
    return launch_block_solve(fband, rhs, x, n, B, w, G, grid, block, smem, s);
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
    if (!block_config(n, w, B, ring, G, rows, true, grid, block, smem)) {
      return cudaErrorInvalidValue;
    }
    return launch_block_factor(band, fband, n, w, rows, clamp, grid, block, smem, s);
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
