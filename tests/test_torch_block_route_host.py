"""The block route of csrc/fleet_banded.cu (K1-K3) and csrc/banded_lu.cu
(K9-K11), a CTA an instance for half-bandwidths past 63, run on the CPU
under the host emulation of tests/test_torch_fleet_banded_host.py and
held bitwise against the plain versions: the quick check of an edit to
the block route without a card.  Only one width of the warp routes is
instantiated (the block route is not a template).  The emulation runs a
CTA's threads as threads; to keep a thread taking several offsets of the
window (the route's case above 1024 threads) cheap, the CTA's thread cap
is lowered to 64 in the source and in the plain versions' order alike.
Skipped where there is no g++."""

import ctypes
from pathlib import Path

import pytest
import torch

from tenscalc_tpu_torch.kkt import banded_lu as tlu
from tenscalc_tpu_torch.kkt import fleet_banded as tfb
from test_torch_banded_lu_host import _band as lu_band
from test_torch_fleet_banded_host import _band as fb_band
from test_torch_fleet_banded_host import _same_bits, build_host_library

torch.set_num_threads(1)

CSRC = Path(tfb.__file__).resolve().parents[1] / "csrc"
# the warp routes' widths, cut to one each: the block route is no template
FB_ONLY = [(r"#define TC_FOR_EACH_W\(X\).*?X\(16\)\n", "#define TC_FOR_EACH_W(X) X(4)\n"),
           (r"#define TC_FOR_EACH_CAP\(X\)[^\n]*\n", "#define TC_FOR_EACH_CAP(X) X(31)\n"),
           (r'asm\("rcp\.approx\.ftz\.f32 %0, %1;" : "=f"\(y\) : "f"\(d\)\);',
            "y = 1.0f / d;")]
LU_ONLY = [(r"#define TC_FOR_EACH_W\(X\).*?X\(31\)\n", "#define TC_FOR_EACH_W(X) X(10)\n"),
           (r"#define TC_FOR_EACH_CAP\(X\)[^\n]*\n", "#define TC_FOR_EACH_CAP(X) X(47)\n")]
SMALL_CTA = 64  # the emulated CTA's thread cap (1024 on the card)
# (B, n, w, extreme magnitudes): the first width of the block route, one
# past a hundred (two offsets a thread under the small cap), a band
# barely longer than its window, one wider than n, and three instances
CASES = [(2, 150, 64, False), (2, 230, 100, True), (1, 101, 100, False), (1, 40, 70, False),
         (3, 90, 64, True)]


def tfb_bind(lib):
    """K1-K3's C entries' argument types (as the binding sets them)."""
    P, I, Fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.tc_fleet_banded_factor_solve.argtypes = [I, I, I, I, I, P, P, P, P, I, I, Fl, P]
    lib.tc_fleet_banded_solve.argtypes = [I, I, I, I, I, P, P, P, I, I, P]
    lib.tc_fleet_banded_factor.argtypes = [I, I, I, I, I, P, P, I, I, Fl, P]
    return lib


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    cap = (r"constexpr int kBlockMaxThreads = 1024;",
           f"constexpr int kBlockMaxThreads = {SMALL_CTA};")
    fb = tfb_bind(build_host_library(
        tmp_path_factory.mktemp("fb_block_host"), CSRC / "fleet_banded.cu",
        [f"-DTC_FB_CHUNK_ROWS={tfb.CHUNK_ROWS}", f"-DTC_FB_RING_ROWS={tfb.RING_ROWS}",
         f"-DTC_FB_MAX_GROUP={tfb.MAX_GROUP}", f"-DTC_FB_SMEM_MAX={tfb.SMEM_MAX}"],
        [*FB_ONLY, cap]))
    lu = tlu.bind(build_host_library(tmp_path_factory.mktemp("lu_block_host"),
                                     CSRC / "banded_lu.cu", tlu.DEFINES, [*LU_ONLY, cap]))
    return fb, lu


@pytest.fixture
def small_cta(monkeypatch):
    monkeypatch.setattr(tfb, "BLOCK_MAX_THREADS", SMALL_CTA)


@pytest.mark.parametrize("B,n,w,extreme", CASES)
def test_fleet_banded_block_route_equals_plain_versions(libs, small_cta, B, n, w, extreme):
    lib, clamp = libs[0], 1e-7
    band, rhs = fb_band(B, n, w, seed=B + n + w, extreme=extreme)
    p = min(n - 1, w // 2)  # a zero pivot no earlier step touches
    band[:, p, 0] = 0.0
    for c in range(max(0, p - w), p):
        band[:, c, p - c] = 0.0
    plan = tfb.launch_plan(n, w, B)
    assert tfb.route(w) == "block" and (plan.ring, plan.group) == (False, 1)
    args = (w, int(plan.ring), plan.group, plan.rows, plan.stride)
    pf, px = tfb.fleet_banded_factor_solve_plain(band, rhs, w, clamp)
    px2 = tfb.fleet_banded_solve_plain(pf, rhs, w)
    f, x, x2, f3 = (torch.full_like(t, float("nan")) for t in (band, rhs, rhs, band))
    assert lib.tc_fleet_banded_factor_solve(*args, band.data_ptr(), rhs.data_ptr(),
                                            f.data_ptr(), x.data_ptr(), n, B, clamp,
                                            None) == 0
    assert lib.tc_fleet_banded_solve(*args, pf.data_ptr(), rhs.data_ptr(), x2.data_ptr(),
                                     n, B, None) == 0
    assert lib.tc_fleet_banded_factor(*args, band.data_ptr(), f3.data_ptr(), n, B, clamp,
                                      None) == 0
    assert _same_bits(f, pf) and _same_bits(x, px)
    assert _same_bits(x2, px2) and _same_bits(f3, pf)
    assert (pf[..., 0].abs() == clamp).any()


@pytest.mark.parametrize("B,n,w,extreme", CASES)
def test_banded_lu_block_route_equals_plain_versions(libs, small_cta, B, n, w, extreme):
    lib, clamp = libs[1], 1e-4
    band, rhs = lu_band(B, n, w, seed=7 * w + n + B)
    if extreme:
        band[1::2] *= 1e21
    plan = tlu.launch_plan(n, w, B)
    assert tlu.route(w) == "block" and (plan.ring, plan.group) == (False, 1)
    args = (w, int(plan.ring), plan.group, plan.rows)
    pf, px = tlu.fleet_banded_lu_factor_solve_plain(band, rhs, w, clamp)
    px10 = tlu.fleet_banded_lu_solve_plain(pf, rhs, w)
    f, x, x10, f11 = (torch.full_like(t, float("nan")) for t in (band, rhs, rhs, band))
    assert lib.tc_banded_lu_factor_solve(*args, band.data_ptr(), rhs.data_ptr(),
                                         f.data_ptr(), x.data_ptr(), n, B, clamp, None) == 0
    assert lib.tc_banded_lu_solve(*args, pf.data_ptr(), rhs.data_ptr(), x10.data_ptr(),
                                  n, B, None) == 0
    assert lib.tc_banded_lu_factor(*args, band.data_ptr(), f11.data_ptr(), n, B, clamp,
                                   None) == 0
    assert _same_bits(f, pf) and _same_bits(x, px)
    assert _same_bits(x10, px10) and _same_bits(f11, pf)
    assert (pf[..., 0].abs() == clamp).any()


def test_block_route_refuses_a_plan_it_does_not_take(libs):
    """Past w = 63 the C entry points take one instance a CTA and no ring,
    and refuse any other plan before launching."""
    fb, lu = libs
    band, rhs = fb_band(2, 150, 64, seed=1, extreme=False)
    f, x = torch.empty_like(band), torch.empty_like(rhs)
    for ring, G in ((1, 1), (0, 2), (0, 0)):
        assert fb.tc_fleet_banded_factor_solve(64, ring, G, 0, 0, band.data_ptr(),
                                               rhs.data_ptr(), f.data_ptr(), x.data_ptr(),
                                               150, 2, 1e-7, None) != 0
    lband, lrhs = lu_band(1, 150, 64, seed=1)
    lf, lx = torch.empty_like(lband), torch.empty_like(lrhs)
    for ring, G in ((1, 1), (0, 2)):
        assert lu.tc_banded_lu_factor_solve(64, ring, G, 0, lband.data_ptr(), lrhs.data_ptr(),
                                            lf.data_ptr(), lx.data_ptr(), 150, 1, 1e-4,
                                            None) != 0
