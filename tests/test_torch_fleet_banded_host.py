"""csrc/fleet_banded.cu's kernels (K1 factor+solve, K2 solve, K3 factor)
run on the CPU, held bitwise against their plain versions.

The CUDA source is compiled with the host's g++ against a small
emulation of the CUDA pieces it uses: a CTA's threads (whole warps) run
as threads, ``__syncwarp`` is a barrier of the warp's 32 and
``__syncthreads`` one of the CTA's, a ``cp.async`` copies at once, shared
memory starts as NaN, the ``_rn`` intrinsics are the host's IEEE float
operations (no contraction), the hardware's reciprocal estimate is the
host's correctly rounded 1/d, and a shuffle is an exchange through one
of two banks of the warp's 32 slots at one warp barrier.  This checks the kernels' indexing,
staging, ring and look-ahead logic and the reciprocal division's rounding on any
machine; the card's own compiler, timing and registers are checked by
chip_smoke.py.  Skipped where there is no g++."""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import pytest
import torch

from tenscalc_tpu_torch.kkt import fleet_banded as tfb

torch.set_num_threads(1)

SOURCE = Path(tfb.__file__).resolve().parents[1] / "csrc" / "fleet_banded.cu"
CLAMP = 1e-7

HOST_CUDA = r"""
#pragma once
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>
#define __device__
#define __host__
#define __global__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__
using std::max;
using std::min;
struct alignas(16) float4 {
  float x, y, z, w;
};
inline float4 make_float4(float x, float y, float z, float w) { return {x, y, z, w}; }
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
inline thread_local dim3 threadIdx, blockIdx, blockDim(32), gridDim;
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum {
  cudaFuncAttributeMaxDynamicSharedMemorySize,
  cudaFuncAttributePreferredSharedMemoryCarveout,
  cudaSharedmemCarveoutMaxShared
};
template <typename K> cudaError_t cudaFuncSetAttribute(K, int, int) { return 0; }
inline cudaError_t cudaGetLastError() { return 0; }
inline const char* cudaGetErrorString(cudaError_t) { return ""; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
inline float __frcp_rn(float a) { return 1.0f / a; }
inline float __fmaf_rn(float a, float b, float c) { return std::fma(a, b, c); }
constexpr int kHostMaxWarps = 32;
inline std::unique_ptr<std::barrier<>> warp_barrier[kHostMaxWarps];  // 32 lanes each
inline std::unique_ptr<std::barrier<>> cta_barrier;  // blockDim.x threads
inline void __syncwarp() { warp_barrier[threadIdx.x >> 5]->arrive_and_wait(); }
inline void __syncthreads() { cta_barrier->arrive_and_wait(); }
// a shuffle: each lane posts its value in its warp's slot, then reads its
// source's; the lanes alternate between two banks of slots, so one warp
// barrier a shuffle suffices (a lane writes a bank again only after the
// next shuffle's barrier, which every lane reaches after its read)
inline float shfl_slot[kHostMaxWarps][2][32];
inline thread_local unsigned shfl_bank;
inline float __shfl_sync(unsigned, float v, int src) {
  float* slot = shfl_slot[threadIdx.x >> 5][shfl_bank ^= 1];
  slot[threadIdx.x & 31] = v;
  __syncwarp();
  return slot[src & 31];
}
inline float __shfl_xor_sync(unsigned mask, float v, int off) {
  return __shfl_sync(mask, v, (threadIdx.x & 31) ^ off);
}
inline float __shfl_down_sync(unsigned mask, float v, unsigned delta) {
  const unsigned l = threadIdx.x & 31;
  return __shfl_sync(mask, v, l + delta < 32 ? l + delta : l);
}
inline size_t __cvta_generic_to_shared(const void* p) { return (size_t)p; }
inline float __uint_as_float(unsigned u) { float f; std::memcpy(&f, &u, 4); return f; }
inline unsigned __float_as_uint(float f) { unsigned u; std::memcpy(&u, &f, 4); return u; }
inline unsigned long long atomicAdd(unsigned long long* p, unsigned long long v) {
  return __atomic_fetch_add(p, v, __ATOMIC_RELAXED);
}
alignas(16) inline float smem[HOST_SMEM_BYTES / 4];  // a CTA's shared memory
// a launch: the CTAs one after another, a CTA's threads (whole warps) as
// threads
template <typename K> struct Launch {
  dim3 grid, block;
  K kernel;
  template <typename... A> void operator()(A... a) {
    if (block.x % 32 != 0 || block.x / 32 > kHostMaxWarps) std::abort();
    for (unsigned w = 0; w < block.x / 32; ++w) warp_barrier[w] = std::make_unique<std::barrier<>>(32);
    cta_barrier = std::make_unique<std::barrier<>>(block.x);
    for (unsigned b = 0; b < grid.x; ++b) {
      std::fill(smem, smem + HOST_SMEM_BYTES / 4, NAN);
      std::vector<std::thread> lanes;
      for (unsigned t = 0; t < block.x; ++t)
        lanes.emplace_back([=, this] {
          blockIdx = dim3(b);
          threadIdx = dim3(t);
          blockDim = block;
          gridDim = grid;
          kernel(a...);
        });
      for (auto& lane : lanes) lane.join();
    }
  }
};
template <typename K> Launch<K> launch(dim3 grid, dim3 block, K kernel) {
  return {grid, block, kernel};
}
"""


def host_source(src: str, extra=()) -> str:
    """A CUDA source with its launches, cp.async and shared-memory
    declaration in host form, after the source's own ``extra`` rewrites;
    each rewrite must apply."""
    rewrites = [
        *extra,
        (r"(\w+(?:<[\w, ]+>)?)<<<(\w+), *(\w+)[^>]*>>>\(", r"launch(\2, \3, \1)("),
        (r"(void cp_async4\(float\* dst, const float\* src\) \{).*?\n\}",
         r"\1 *dst = *src; }"),
        (r"asm volatile\(.*?\);", ";"),
        (r"extern __shared__ float smem\[\];", ""),
    ]
    for pattern, repl in rewrites:
        src, count = re.subn(pattern, repl, src, flags=re.S)
        assert count > 0, f"the host rewrite {pattern!r} found nothing"
    return src


def build_host_library(d: Path, source: Path, defines, extra=()) -> ctypes.CDLL:
    """``source`` compiled with g++ against HOST_CUDA in directory ``d``,
    with the emulated card's shared memory the binding's opt-in cap (skips
    the test where there is no g++)."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the host emulation")
    (d / "cuda_runtime.h").write_text(HOST_CUDA)
    cpp = d / f"{source.stem}.cpp"
    cpp.write_text(host_source(source.read_text(), extra))
    out = d / f"lib{source.stem}_host.so"
    subprocess.run(
        [gxx, "-std=c++20", "-O1", "-ffp-contract=off", "-shared", "-fPIC",
         "-pthread", "-Wno-unknown-pragmas", f"-I{d}",
         f"-DHOST_SMEM_BYTES={tfb.SMEM_MAX}", *defines, "-o", str(out), str(cpp)],
        check=True, capture_output=True, timeout=300,
    )
    return ctypes.CDLL(str(out))


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    h = build_host_library(
        tmp_path_factory.mktemp("fleet_banded_host"), SOURCE,
        tfb.DEFINES,
        [(r'asm\("rcp\.approx\.ftz\.f32 %0, %1;" : "=f"\(y\) : "f"\(d\)\);',
          "y = 1.0f / d;")],
    )
    P, I, Fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    h.tc_fleet_banded_factor_solve.argtypes = [I, I, I, I, I, P, P, P, P, I, I, Fl, P]
    h.tc_fleet_banded_solve.argtypes = [I, I, I, I, I, P, P, P, I, I, P]
    h.tc_fleet_banded_factor.argtypes = [I, I, I, I, I, P, P, I, I, Fl, P]
    return h


def _band(B, n, w, seed, extreme):
    """Symmetric-indefinite bands with structural zeros and a zero pivot;
    ``extreme`` scales instances and entries outside 2^-60..2^60, where a
    step divides by __fdiv_rn instead of through the reciprocal."""
    g = torch.Generator().manual_seed(seed)
    band = torch.randn(B, n, w + 1, generator=g)
    sign = torch.where(torch.rand(B, n, generator=g) < 0.5, -1.0, 1.0)
    band[:, :, 0] = sign * (2 * w + 1 + torch.rand(B, n, generator=g))
    for i in range(1, w + 1):
        band[:, n - i:, i] = 0.0
    rhs = torch.randn(B, n, generator=g)
    band[:, ::7, 1] = 0.0
    band[:, min(5, n - 1), 0] = 0.0
    if extreme:
        band[1::4] *= 1e21
        band[2::4] *= 1e-25
        band[3::4, ::5, 1] = 1e-30
        rhs[::5] *= 1e-30
    return band, rhs


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal bit for bit, signed zeros included, NaN where the other has
    NaN (extreme magnitudes overflow some wide instances to NaN)."""
    nan = a.isnan()
    return (torch.equal(nan, b.isnan())
            and torch.equal(a[~nan].view(torch.int32), b[~nan].view(torch.int32)))


# (B, n, w, group, ring route, extreme magnitudes): the flagship width,
# the nonlinear unicycle fleet's band (n = 439, w = 9: staged, an
# instance a CTA), ragged groups, one row, the widest band, the group
# cap, and the ring (forced at small n) with n a whole number of chunks
# or not
CASES = [
    (5, 37, 4, 2, False, False),
    (3, 439, 9, 1, False, False),
    (2, 439, 9, 1, False, True),
    (7, 149, 4, 2, False, True),
    (3, 69, 9, 2, False, True),
    (3, 37, 1, 2, False, True),
    (3, 33, 8, 2, False, True),
    (4, 20, 16, 3, False, False),
    (2, 1, 1, 2, False, False),
    (33, 40, 3, 32, False, False),
    (2, 600, 4, 2, True, True),
    (2, 700, 9, 1, True, False),
    (3, 577, 16, 2, True, False),
    (2, 512, 1, 2, True, False),
]
# the wide route (a warp an instance, group 1) at the widths past the
# narrow route's 16: the quadcopter's (30), each capacity's edges (23/24,
# 31/32, 47/48, 63), staged and on the ring, with extreme magnitudes
CASES += [
    (2, 70, w, 1, False, w % 2 == 0) for w in (17, 24, 30, 31, 32, 48, 63)
] + [
    (2, 300, w, 1, True, w % 2 == 1) for w in (17, 24, 30, 31, 32, 48, 63)
] + [
    (3, 286, 30, 1, False, False),  # the quadcopter's band
    (2, 1, 40, 1, False, False),
    (2, 45, 40, 1, False, False),   # n shorter than a window past the first
]
assert all(n > tfb.RING_ROWS for _, n, _, _, ring, _ in CASES if ring)


@pytest.mark.parametrize("B,n,w,G,ring,extreme", CASES)
def test_kernels_on_the_host_equal_plain_versions(lib, B, n, w, G, ring, extreme):
    band, rhs = _band(B, n, w, seed=B + n + w, extreme=extreme)
    if w > tfb.NARROW_W:
        # a zero pivot no earlier step touches, and a tiny one: the clamp
        # decides both
        p = min(n - 1, w + 2)
        band[:, p, 0] = 0.0
        for c in range(max(0, p - w), p):
            band[:, c, p - c] = 0.0
        band[:, n // 2, 0] = -1e-12
    rows = tfb.instance_rows(n, w, ring)
    plan = (w, int(ring), G, rows, tfb.instance_floats(n, w, ring))
    pf, px = tfb.fleet_banded_factor_solve_plain(band, rhs, w, CLAMP)
    px2 = tfb.fleet_banded_solve_plain(pf, rhs, w)
    f, x, x2, f3 = (torch.empty_like(t) for t in (band, rhs, rhs, band))
    assert lib.tc_fleet_banded_factor_solve(*plan, band.data_ptr(), rhs.data_ptr(),
                                            f.data_ptr(), x.data_ptr(), n, B, CLAMP,
                                            None) == 0
    assert lib.tc_fleet_banded_solve(*plan, pf.data_ptr(), rhs.data_ptr(), x2.data_ptr(),
                                     n, B, None) == 0
    assert lib.tc_fleet_banded_factor(*plan, band.data_ptr(), f3.data_ptr(), n, B, CLAMP,
                                      None) == 0
    assert _same_bits(f, pf) and _same_bits(x, px)
    assert _same_bits(x2, px2)
    assert _same_bits(f3, pf)
    if w > tfb.NARROW_W:
        assert (pf[..., 0].abs() == CLAMP).any()


def test_host_launches_refuse_a_plan_the_kernels_do_not_take(lib):
    """The C entry points check the plan before launching."""
    band, rhs = _band(2, 37, 4, seed=1, extreme=False)
    f, x = torch.empty_like(band), torch.empty_like(rhs)
    good = (4, 0, 2, tfb.instance_rows(37, 4, False), tfb.instance_floats(37, 4, False))
    bad = [
        (4, 0, 2, 37, good[4]),           # fewer rows than n + w + 1
        (4, 1, 2, 64, good[4]),           # a ring that is not RING_ROWS
        (4, 0, 33, good[3], good[4]),     # a group past a warp
        (17, 0, 2, good[3], good[4]),     # a group on the wide route
        (tfb.MAX_W + 1, 0, 2, good[3], good[4]),  # a group on the block route
        (4, 0, 2, good[3], good[3]),      # a slice smaller than its rows
    ]
    for plan in bad:
        assert lib.tc_fleet_banded_factor_solve(*plan, band.data_ptr(), rhs.data_ptr(),
                                                f.data_ptr(), x.data_ptr(), 37, 2, CLAMP,
                                                None) != 0
