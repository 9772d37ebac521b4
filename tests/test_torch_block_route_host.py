"""The block route of csrc/fleet_banded.cu (K1-K3) and csrc/banded_lu.cu
(K9-K11), run on the CPU under the host emulation of
tests/test_torch_fleet_banded_host.py and held bitwise against the plain
versions: the quick check of an edit to the block route without a card.
Only one width of the warp routes is instantiated (the block route's
widths are run-time arguments).  The emulation runs a CTA's threads as
threads, so both families keep the card's tree (their solve is a warp,
or past w = 1024 a CTA in device memory, as on the card); K1-K3 run at
the plan itself (a factor CTA of 128-352 threads at these widths), and,
to keep it cheap, the block LU factor's CTA is lowered to 64 threads
(two warps, so tiles of its rank-nb update go to both).  K1-K3's own
cases (panels, phases in device memory, the plan past each switch) are
in tests/test_torch_block_route_fb_host.py.  K9-K11 run at the plan's panel width and at narrow
panels of 8 and 12 steps (many panels, the trailing square's far edge in
every one), with n not a multiple of the panel, n below it, w past n,
nonzero entries reaching past the last row, extreme magnitudes, clamped
pivots in every panel, and K10 at several instances a CTA; each phase in
device memory (the plan's panel 0 or group 0), forced at those cases and
at the plan's own one past the widths where the warp solve (1024) and a
panel of 4 rows (7252) end;
and the binding's shared-memory bytes against the library's at every
width to 8000.  Skipped where there is no g++."""

import ctypes
from pathlib import Path

import pytest
import torch

from tenscalc_tpu_torch.kkt import banded_lu as tlu
from tenscalc_tpu_torch.kkt import fleet_banded as tfb
from test_torch_banded_lu_host import BULK_COPIES
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
           (r"#define TC_FOR_EACH_CAP\(X\)[^\n]*\n", "#define TC_FOR_EACH_CAP(X) X(47)\n"),
           *BULK_COPIES]
SMALL_PANEL_CTA = 64  # the emulated block LU factor's threads (PANEL_THREADS on the card)
# (B, n, w, extreme magnitudes): the first width of the block route, one
# past a hundred (two offsets a thread under the small cap), a band
# barely longer than its window, one wider than n, and three instances
CASES = [(2, 150, 64, False), (2, 230, 100, True), (1, 101, 100, False), (1, 40, 70, False),
         (3, 90, 64, True)]


def fb_host_library(d: Path) -> ctypes.CDLL:
    """fleet_banded.cu under the emulation, bound as the binding binds it
    (which holds the block route's shared memory against block_smem)."""
    return tfb.bind(build_host_library(d, CSRC / "fleet_banded.cu", tfb.DEFINES,
                                       [*FB_ONLY, *BULK_COPIES]))


@pytest.fixture(scope="module")
def fb_lib(tmp_path_factory):
    """fleet_banded.cu with the card's tree and the plan's factor CTAs."""
    return fb_host_library(tmp_path_factory.mktemp("fb_block_host"))


@pytest.fixture(scope="module")
def lu_full_tree(tmp_path_factory):
    """banded_lu.cu with the card's tree (1024 threads at most): a lane
    holds 2 to 32 leaves of the warp solve's backward sums."""
    defines = [d for d in tlu.DEFINES if not d.startswith("-DTC_LU_PANEL_THREADS=")]
    return tlu.bind(build_host_library(
        tmp_path_factory.mktemp("lu_block_tree_host"), CSRC / "banded_lu.cu",
        [*defines, f"-DTC_LU_PANEL_THREADS={SMALL_PANEL_CTA}"], LU_ONLY))


@pytest.mark.parametrize("B,n,w,extreme", CASES)
def test_fleet_banded_block_route_equals_plain_versions(fb_lib, B, n, w, extreme):
    lib, clamp = fb_lib, 1e-7
    band, rhs = fb_band(B, n, w, seed=B + n + w, extreme=extreme)
    p = min(n - 1, w // 2)  # a zero pivot no earlier step touches
    band[:, p, 0] = 0.0
    for c in range(max(0, p - w), p):
        band[:, c, p - c] = 0.0
    plan = tfb.launch_plan(n, w, B)
    assert tfb.route(w) == "block" and (plan.ring, plan.group) == (False, 1)
    assert (plan.rows, plan.stride) == (tfb.block_panel(w), tfb.panel_threads(w, B))
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


def _lu_case(B, n, w, extreme, phantom):
    """An LU band with clamped pivots; ``extreme`` scales odd instances by
    1e21 and every third by 1e-19 (products near the subnormal range);
    ``phantom`` puts random entries where the band reaches past row n."""
    band, rhs = lu_band(B, n, w, seed=7 * w + n + B)
    if phantom:
        g = torch.Generator().manual_seed(n + w)
        for i in range(1, w + 1):
            k = min(i, n)
            band[:, n - k:, i] = torch.randn(B, k, generator=g)
            band[:, n - k:, w + i] = torch.randn(B, k, generator=g)
    if extreme:
        band[1::2] *= 1e21
        band[2::3] *= 1e-19
    return band, rhs


def _lu_entries(lib, args, band, rhs, pf, clamp):
    """K9, K10 (on the plain factor pf) and K11 through the C entries at
    the plan ``args`` (w, ring, group, panel), into NaN-filled outputs."""
    B, n, _ = band.shape
    f, x, x10, f11 = (torch.full_like(t, float("nan")) for t in (band, rhs, rhs, band))
    assert lib.tc_banded_lu_factor_solve(*args, band.data_ptr(), rhs.data_ptr(),
                                         f.data_ptr(), x.data_ptr(), n, B, clamp, None) == 0
    assert lib.tc_banded_lu_solve(*args, pf.data_ptr(), rhs.data_ptr(), x10.data_ptr(),
                                  n, B, None) == 0
    assert lib.tc_banded_lu_factor(*args, band.data_ptr(), f11.data_ptr(), n, B, clamp,
                                   None) == 0
    return f, x, x10, f11


def _lu_bitwise(lib, args, band, rhs, clamp):
    """The three entries at plan ``args`` bitwise against the plain
    versions; returns the plain factor."""
    w = args[0]
    pf, px = tlu.fleet_banded_lu_factor_solve_plain(band, rhs, w, clamp)
    px10 = tlu.fleet_banded_lu_solve_plain(pf, rhs, w)
    f, x, x10, f11 = _lu_entries(lib, args, band, rhs, pf, clamp)
    assert _same_bits(f, pf) and _same_bits(x, px)
    assert _same_bits(x10, px10) and _same_bits(f11, pf)
    return pf


# (B, n, w, extreme, phantom): the LU's cases (CASES), w past n with
# entries reaching past the last row, and n an odd number of narrow panels
LU_CASES = ([(*case, False) for case in CASES]
            + [(1, 40, 70, False, True), (2, 77, 64, True, True), (3, 203, 65, True, False)])


@pytest.mark.parametrize("panel", [None, 8, 12])
@pytest.mark.parametrize("B,n,w,extreme,phantom", LU_CASES)
def test_banded_lu_block_route_equals_plain_versions(lu_full_tree, B, n, w, extreme,
                                                     phantom, panel):
    lib, clamp = lu_full_tree, 1e-4
    band, rhs = _lu_case(B, n, w, extreme, phantom)
    plan = tlu.launch_plan(n, w, B)
    assert tlu.route(w) == "block" and not plan.ring and plan.group == 1
    assert plan.rows == tlu.block_panel(w) == 64 and plan.smem <= tlu.SMEM_MAX
    nb = plan.rows if panel is None else panel
    args = (w, int(plan.ring), plan.group, nb)
    for c in range(0, n, nb):  # a zero pivot in every panel, no step touches it
        p = min(n - 1, c + nb // 2)
        band[:, p, 0] = 0.0
        for k in range(max(0, p - w), p):
            band[:, k, p - k] = 0.0
    pf = _lu_bitwise(lib, args, band, rhs, clamp)
    # a clamped pivot in every panel of nb steps
    clamped = (pf[..., 0].abs() == clamp).any(dim=0)
    assert all(bool(clamped[c: c + nb].any()) for c in range(0, n, nb))


@pytest.mark.parametrize("phases", ["factor", "solve", "both"])
@pytest.mark.parametrize("B,n,w,extreme,phantom", [LU_CASES[i] for i in (1, 2, 3, 6, 7)])
def test_banded_lu_block_phases_in_device_memory(lu_full_tree, B, n, w, extreme, phantom,
                                                 phases):
    """K9-K11 with the factor (panel 0), the solve (group 0) or both in
    device memory, as the plan has them past the widths where the
    shared-memory designs fit, forced at narrow bands; a clamped pivot in
    every sweep of four steps."""
    clamp = 1e-4
    band, rhs = _lu_case(B, n, w, extreme, phantom)
    for c in range(0, n, 4):
        band[:, c, 0] = 0.0
        for k in range(max(0, c - w), c):
            band[:, k, c - k] = 0.0
    plan = tlu.launch_plan(n, w, B)
    args = (w, 0, plan.group if phases == "factor" else 0, plan.rows if phases == "solve" else 0)
    pf = _lu_bitwise(lu_full_tree, args, band, rhs, clamp)
    assert (pf[..., 0].abs() == clamp).any()


# (B, n, w): one past the widths where the warp solve (w = 1024) and a
# factor panel of 4 rows (w = 7252) end: the plan puts the solve, then
# the factor too, in device memory (n small, so w > n)
PAST_SMEM = [(1, 40, 1025), (1, 8, 7253)]


@pytest.mark.parametrize("B,n,w", PAST_SMEM)
def test_banded_lu_block_route_past_shared_memory(lu_full_tree, B, n, w):
    band, rhs = _lu_case(B, n, w, extreme=False, phantom=True)
    plan, below = tlu.launch_plan(n, w, B), tlu.launch_plan(n, w - 1, B)
    assert plan.group == 0 and plan.rows == (28 if w < 7253 else 0)
    assert below.rows == (28 if w < 7253 else 4) and (below.group > 0) == (w < 7253)
    _lu_bitwise(lu_full_tree, (w, 0, plan.group, plan.rows), band, rhs, 1e-4)


def test_block_smem_is_the_librarys(lu_full_tree):
    """The binding's block-route shared memory (block_smem, from which
    launch_plan's smem and groups come) equals the library's
    (tc_banded_lu_block_smem, which the C entries check a plan against)
    at every width from 64 to 8000, for every group and several panels;
    the library refuses (-1) what outgrows the cap and a warp's solve
    past w = 1024."""
    lib = lu_full_tree
    for w in range(64, 8001):
        nbs = {0, 4, tlu.block_panel(w), tlu.PANEL_MAX} - {x for x in (6,) if x > w}
        for nb in nbs:
            want = tlu.block_smem(w, 0, nb, True)
            assert lib.tc_banded_lu_block_smem(w, 0, nb, 1) == (
                want if want <= tlu.SMEM_MAX else -1), (w, nb)
        for G in range(tlu.SOLVE_MAX_GROUP + 1):  # a warp's solve to w = 1024
            want = tlu.block_smem(w, G, 0, False)
            assert lib.tc_banded_lu_block_smem(w, G, 0, 0) == (
                want if want <= tlu.SMEM_MAX and (G == 0 or w <= 1024) else -1), (w, G)
        plan = tlu.launch_plan(4 * w, w, 1024)
        assert plan.smem == lib.tc_banded_lu_block_smem(w, plan.group, plan.rows, 1) >= 0
        assert lib.tc_banded_lu_block_smem(w, plan.group, plan.rows, 0) >= 0
    assert lib.tc_banded_lu_block_smem(100, 0, 6, 1) == -1
    assert lib.tc_banded_lu_block_smem(100, tlu.SOLVE_MAX_GROUP + 1, 0, 0) == -1


@pytest.mark.parametrize("G", [2, 4])
def test_banded_lu_block_solve_takes_several_instances_a_cta(lu_full_tree, G):
    """K10 on the block route with G instances a CTA (a warp each), the
    last CTA ragged."""
    lib, B, n, w = lu_full_tree, 5, 97, 66
    band, rhs = _lu_case(B, n, w, extreme=True, phantom=True)
    pf, _ = tlu.fleet_banded_lu_factor_solve_plain(band, rhs, w, 1e-4)
    px10 = tlu.fleet_banded_lu_solve_plain(pf, rhs, w)
    x10 = torch.full_like(rhs, float("nan"))
    assert G * tlu.solve_bytes(w) <= tlu.SMEM_MAX
    assert lib.tc_banded_lu_solve(w, 0, G, tlu.block_panel(w), pf.data_ptr(), rhs.data_ptr(),
                                  x10.data_ptr(), n, B, None) == 0
    assert _same_bits(x10, px10)


@pytest.mark.parametrize("B,n,w", [(2, 150, 100), (1, 280, 250), (1, 640, 600)])
def test_banded_lu_block_route_on_the_full_tree(lu_full_tree, B, n, w):
    """K9-K11 with the card's tree: a lane's 4, 8 and 32 leaves (T = 128,
    256, 608 threads' partial sums)."""
    lib, clamp = lu_full_tree, 1e-4
    band, rhs = _lu_case(B, n, w, extreme=False, phantom=True)
    plan = tlu.launch_plan(n, w, B)
    assert tfb.block_tree(w) // 32 in (4, 8, 32)
    _lu_bitwise(lib, (w, 0, plan.group, plan.rows), band, rhs, clamp)


def test_block_route_refuses_a_plan_it_does_not_take(fb_lib, lu_full_tree):
    """Past w = 63 the C entry points refuse, before launching, a plan the
    block route does not take: a ring; a panel that is neither 0 (in
    device memory) nor a multiple of 4 from 4 up to w, or outgrows shared
    memory; a solve group outside 0..4, or a warp's solve (a group above
    0) past w = 1024; and for K1-K3 a factor CTA that is not whole warps
    from 32 to PANEL_MAX_THREADS."""
    fb, lu = fb_lib, lu_full_tree
    band, rhs = fb_band(2, 150, 64, seed=1, extreme=False)
    f, x = torch.empty_like(band), torch.empty_like(rhs)
    for ring, G, nb, T in ((1, 1, 32, 128), (1, 0, 0, 128), (0, 1, 6, 128), (0, 1, 2, 128),
                           (0, 1, 68, 128), (0, -1, 32, 128), (0, 5, 32, 128), (0, 1, 32, 0),
                           (0, 1, 32, 48), (0, 1, 32, tfb.PANEL_MAX_THREADS + 32)):
        assert fb.tc_fleet_banded_factor_solve(64, ring, G, nb, T, band.data_ptr(),
                                               rhs.data_ptr(), f.data_ptr(), x.data_ptr(),
                                               150, 2, 1e-7, None) != 0
        # K2 takes no panel and K3 no group: each refuses only its own
        bad_solve = ring != 0 or not 0 <= G <= tfb.SOLVE_MAX_GROUP
        bad_factor = (ring != 0 or not (nb == 0 or (nb % 4 == 0 and 4 <= nb <= 64))
                      or not (T % 32 == 0 and 32 <= T <= tfb.PANEL_MAX_THREADS))
        assert (fb.tc_fleet_banded_solve(64, ring, G, nb, T, band.data_ptr(), rhs.data_ptr(),
                                         x.data_ptr(), 150, 2, None) != 0) == bad_solve
        assert (fb.tc_fleet_banded_factor(64, ring, G, nb, T, band.data_ptr(), f.data_ptr(),
                                          150, 2, 1e-7, None) != 0) == bad_factor
    big = ((tfb.SMEM_MAX // 4 - tfb.PANEL_PAD) // tfb.panel_stride(999)) // 4 * 4 + 4
    assert tfb.panel_bytes(999, big) > tfb.SMEM_MAX >= tfb.panel_bytes(999, big - 4)
    assert fb.tc_fleet_banded_factor(999, 0, 1, big, 128, band.data_ptr(), f.data_ptr(), 2000,
                                     1, 1e-7, None) != 0
    for G in (1, 2):
        assert fb.tc_fleet_banded_solve(1025, 0, G, 0, 0, band.data_ptr(), rhs.data_ptr(),
                                        x.data_ptr(), 4, 1, None) != 0
    lband, lrhs = lu_band(1, 150, 64, seed=1)
    lf, lx = torch.empty_like(lband), torch.empty_like(lrhs)
    for ring, G, nb in ((1, 1, 0), (1, 0, 0), (1, 1, 64), (0, 1, 6), (0, 1, 2), (0, 1, 68),
                        (0, -1, 64), (0, 5, 64)):
        assert lu.tc_banded_lu_factor_solve(64, ring, G, nb, lband.data_ptr(), lrhs.data_ptr(),
                                            lf.data_ptr(), lx.data_ptr(), 150, 1, 1e-4,
                                            None) != 0
        # K10 takes no panel and K11 no group: each refuses only its own
        bad_solve = ring != 0 or not 0 <= G <= tlu.SOLVE_MAX_GROUP
        bad_factor = ring != 0 or not (nb == 0 or (nb % 4 == 0 and 4 <= nb <= 64))
        assert (lu.tc_banded_lu_solve(64, ring, G, nb, lband.data_ptr(), lrhs.data_ptr(),
                                      lx.data_ptr(), 150, 1, None) != 0) == bad_solve
        assert (lu.tc_banded_lu_factor(64, ring, G, nb, lband.data_ptr(), lf.data_ptr(), 150, 1,
                                       1e-4, None) != 0) == bad_factor
    # a panel of 4 rows at w = 999 fits; past the cap's rows it does not
    assert tlu.block_panel(999) == 28 and tlu.panel_bytes(999, 28) <= tlu.SMEM_MAX
    wide = tlu.SMEM_MAX // 4 - tlu.PANEL_PAD
    big = (wide // tlu.panel_stride(999)) // 4 * 4 + 4
    assert tlu.panel_bytes(999, big) > tlu.SMEM_MAX
    assert lu.tc_banded_lu_factor(999, 0, 1, big, lband.data_ptr(), lf.data_ptr(), 2000, 1,
                                  1e-4, None) != 0
    for G in (1, 2):
        assert lu.tc_banded_lu_solve(1025, 0, G, 28, lband.data_ptr(), lrhs.data_ptr(),
                                     lx.data_ptr(), 4, 1, None) != 0
