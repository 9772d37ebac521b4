"""The block route of csrc/fleet_banded.cu (K1-K3: w > 63), run on the CPU
under the host emulation of tests/test_torch_fleet_banded_host.py (bulk
copies and their mbarriers as immediate copies, as for csrc/banded_lu.cu)
and held bitwise against the unchanged plain versions.  The emulation
keeps the card's tree and solve warps; to keep it cheap, most cases run
the factor on a CTA of 64 threads (two warps, so tiles of the rank-nb
update go to both), and the plan's own CTA (128-352 threads at these
widths) at its own panel.  The cases: the plan's panel and narrow panels
of 8 and 12 steps, with n not a multiple of the panel, n below it, w
past n, nonzero entries reaching past the last row, extreme magnitudes,
and a clamped pivot in every panel; K2 at several instances a CTA; each
phase in device memory (the plan's panel 0 or group 0), forced at those
cases and at the plan's own one past the widths where the warp solve
(1024) and a panel of 4 rows (7252) end; the warp solve at each of its
leaves a lane, the powers of two whose window's last entry sits in the x
ring among them; and the binding's shared-memory bytes against the
library's at every width to 8000.  Skipped where there is no g++."""

import pytest
import torch

from tenscalc_tpu_torch.kkt import fleet_banded as tfb
from test_torch_block_route_host import fb_host_library
from test_torch_fleet_banded_host import _band, _same_bits

torch.set_num_threads(1)

CLAMP = 1e-7
SMALL_CTA = 64  # the emulated factor CTA's threads where a case lowers it
# (B, n, w, extreme, phantom): the first width of the block route with n
# an odd number of panels, extreme magnitudes at a lane's 4 leaves, a
# band barely longer than its window, w past n with entries past the last
# row, n below the plan's panel, and three instances
CASES = [(2, 150, 64, False, False), (2, 230, 100, True, False), (1, 101, 100, False, True),
         (1, 40, 70, False, True), (2, 20, 66, True, True), (3, 203, 65, True, True)]


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    return fb_host_library(tmp_path_factory.mktemp("fb_block_route_host"))


def _case(B, n, w, extreme, phantom, every=None):
    """A band with a zero pivot that no step touches (in every panel of
    ``every`` steps, when given, else one); ``phantom`` puts random
    entries where the band reaches past row n."""
    band, rhs = _band(B, n, w, seed=B + 3 * n + w, extreme=extreme)
    if phantom:
        g = torch.Generator().manual_seed(n + w)
        for i in range(1, w + 1):
            k = min(i, n)
            band[:, n - k:, i] = torch.randn(B, k, generator=g)
    for c in range(0, n, every or n):
        p = min(n - 1, c + (every or w) // 2)
        band[:, p, 0] = 0.0
        for k in range(max(0, p - w), p):
            band[:, k, p - k] = 0.0
    return band, rhs


def _bitwise(lib, args, band, rhs):
    """K1, K2 (on the plain factor) and K3 through the C entries at the
    plan ``args`` (w, ring, group, panel, threads), into NaN-filled
    outputs, bitwise against the plain versions; returns the plain
    factor."""
    B, n, _ = band.shape
    w = args[0]
    pf, px = tfb.fleet_banded_factor_solve_plain(band, rhs, w, CLAMP)
    px2 = tfb.fleet_banded_solve_plain(pf, rhs, w)
    f, x, x2, f3 = (torch.full_like(t, float("nan")) for t in (band, rhs, rhs, band))
    assert lib.tc_fleet_banded_factor_solve(*args, band.data_ptr(), rhs.data_ptr(),
                                            f.data_ptr(), x.data_ptr(), n, B, CLAMP, None) == 0
    assert lib.tc_fleet_banded_solve(*args, pf.data_ptr(), rhs.data_ptr(), x2.data_ptr(),
                                     n, B, None) == 0
    assert lib.tc_fleet_banded_factor(*args, band.data_ptr(), f3.data_ptr(), n, B, CLAMP,
                                      None) == 0
    assert _same_bits(f, pf) and _same_bits(x, px)
    assert _same_bits(x2, px2) and _same_bits(f3, pf)
    return pf


@pytest.mark.parametrize("panel", [None, 8, 12])
@pytest.mark.parametrize("B,n,w,extreme,phantom", CASES)
def test_block_factor_panels_equal_plain_versions(lib, B, n, w, extreme, phantom, panel):
    """K1-K3 at the plan's panel on its own CTA, and at narrow panels on
    a CTA of SMALL_CTA threads, a clamped pivot in every panel."""
    plan = tfb.launch_plan(n, w, B)
    assert tfb.route(w) == "block" and not plan.ring and plan.group == 1
    assert plan.rows == tfb.block_panel(w) == tfb.PANEL_MAX and plan.smem <= tfb.SMEM_MAX
    assert plan.stride == tfb.panel_threads(w, B) in (128, 288, 352)
    nb = plan.rows if panel is None else panel
    band, rhs = _case(B, n, w, extreme, phantom, every=nb)
    threads = plan.stride if panel is None else SMALL_CTA
    pf = _bitwise(lib, (w, 0, plan.group, nb, threads), band, rhs)
    clamped = (pf[..., 0].abs() == CLAMP).any(dim=0)
    assert all(bool(clamped[c: c + nb].any()) for c in range(0, n, nb))


@pytest.mark.parametrize("phases", ["factor", "solve", "both"])
@pytest.mark.parametrize("B,n,w,extreme,phantom", [CASES[i] for i in (1, 3, 5)])
def test_block_phases_in_device_memory(lib, B, n, w, extreme, phantom, phases):
    """K1-K3 with the factor (panel 0), the solve (group 0) or both in
    device memory, as the plan has them past the widths where the
    shared-memory designs fit, forced at narrow bands; a clamped pivot in
    every sweep of four steps."""
    band, rhs = _case(B, n, w, extreme, phantom, every=4)
    plan = tfb.launch_plan(n, w, B)
    args = (w, 0, plan.group if phases == "factor" else 0,
            plan.rows if phases == "solve" else 0, SMALL_CTA)
    pf = _bitwise(lib, args, band, rhs)
    assert (pf[..., 0].abs() == CLAMP).any()


# (B, n, w): one past the widths where the warp solve (w = 1024) and a
# factor panel of 4 rows (w = 7252) end: the plan puts the solve, then
# the factor too, in device memory (n small, so w > n)
PAST_SMEM = [(1, 40, 1025), (1, 8, 7253)]


@pytest.mark.parametrize("B,n,w", PAST_SMEM)
def test_block_route_past_shared_memory(lib, B, n, w):
    band, rhs = _case(B, n, w, extreme=False, phantom=True)
    plan, below = tfb.launch_plan(n, w, B), tfb.launch_plan(n, w - 1, B)
    assert plan.group == 0 and plan.rows == (28 if w < 7253 else 0)
    assert below.rows == (28 if w < 7253 else 4) and (below.group > 0) == (w < 7253)
    _bitwise(lib, (w, 0, plan.group, plan.rows, plan.stride), band, rhs)


@pytest.mark.parametrize("G", [2, 4])
def test_block_solve_takes_several_instances_a_cta(lib, G):
    """K2 (and K1's solve) with G instances a CTA (a warp each), the last
    CTA ragged."""
    B, n, w = 5, 97, 66
    band, rhs = _case(B, n, w, extreme=True, phantom=True)
    assert G * tfb.solve_bytes(w) <= tfb.SMEM_MAX
    _bitwise(lib, (w, 0, G, 16, SMALL_CTA), band, rhs)


@pytest.mark.parametrize("B,n,w", [(1, 70, 64), (2, 150, 100), (1, 300, 128), (1, 280, 250),
                                   (1, 640, 600), (1, 60, 1024)])
def test_block_solve_on_the_full_tree(lib, B, n, w):
    """The warp solve at a lane's 2, 4, 8, 8, 32 and 32 leaves (T = 64,
    128, 128, 256, 608 and 1024 threads' partial sums); at w = 64, 128
    and 1024 the window's last entry lies in the x ring."""
    band, rhs = _case(B, n, w, extreme=False, phantom=True)
    plan = tfb.launch_plan(n, w, B)
    assert tfb.block_tree(w) // 32 in (2, 4, 8, 32) and plan.group == 1
    _bitwise(lib, (w, 0, plan.group, 8, SMALL_CTA), band, rhs)


def test_block_smem_is_the_librarys(lib):
    """The binding's block-route shared memory (block_smem, from which
    launch_plan's smem and groups come) equals the library's
    (tc_fleet_banded_block_smem, which the C entries check a plan
    against) at every width from 64 to 8000, for every group and several
    panels; the library refuses (-1) what outgrows the cap and a warp's
    solve past w = 1024.  The plan's factor CTA is whole warps within the
    kernel's bound."""
    for w in range(64, 8001):
        for nb in {0, 4, tfb.block_panel(w), tfb.PANEL_MAX}:
            want = tfb.block_smem(w, 0, nb, True)
            assert lib.tc_fleet_banded_block_smem(w, 0, nb, 1) == (
                want if want <= tfb.SMEM_MAX else -1), (w, nb)
        for G in range(tfb.SOLVE_MAX_GROUP + 1):
            want = tfb.block_smem(w, G, 0, False)
            assert lib.tc_fleet_banded_block_smem(w, G, 0, 0) == (
                want if want <= tfb.SMEM_MAX and (G == 0 or w <= 1024) else -1), (w, G)
        plan = tfb.launch_plan(4 * w, w, 1024)
        assert plan.smem == lib.tc_fleet_banded_block_smem(w, plan.group, plan.rows, 1) >= 0
        assert lib.tc_fleet_banded_block_smem(w, plan.group, plan.rows, 0) >= 0
        assert plan.stride % 32 == 0 and 128 <= plan.stride <= tfb.PANEL_MAX_THREADS
    assert lib.tc_fleet_banded_block_smem(100, 0, 6, 1) == -1
    assert lib.tc_fleet_banded_block_smem(100, tfb.SOLVE_MAX_GROUP + 1, 0, 0) == -1
    assert lib.tc_fleet_banded_block_smem(63, 1, 4, 1) == -1


def test_block_plan_at_the_deconvolution_fleet():
    """The deconvolution fleet's band (B = 256, n = 1000, w = 95): panels
    of PANEL_MAX steps on CTAs of 256 threads (ten tiles of the rank-nb
    update; two such CTAs fill an SM's registers), a warp an instance for
    the solve, one CTA an instance of each on the H100's 132 SMs; at
    fewer instances a warp a tile, at most PANEL_MAX_THREADS."""
    plan = tfb.launch_plan(1000, 95, 256, sms=132)
    assert tfb.trailing_tiles(95) == 10
    assert plan == tfb.LaunchPlan(False, 1, tfb.PANEL_MAX, 256,
                                  tfb.panel_bytes(95, tfb.PANEL_MAX))
    assert tfb.panel_threads(95, 132) == 320 and tfb.panel_threads(999, 2) == 512
    assert tfb.panel_threads(64, 1024) == 128
    with pytest.raises(ValueError):
        tfb.launch_plan(1000, 95, 256, group=tfb.SOLVE_MAX_GROUP + 1)
    with pytest.raises(ValueError):
        tfb.launch_plan(40, 1025, 1, group=1)


def test_block_solve_keeps_signed_zeros(lib):
    """Signed zeros through both sweeps: at w = 64 = block_tree(w), with
    negative pivots, positive entries (past the last row too) and a zero
    right-hand side, z is -0 and the last row's products are all -0;
    backward_sum's leaves, each from +0, make its sum +0 and its x -0."""
    B, n, w = 1, 70, 64
    g = torch.Generator().manual_seed(5)
    band = torch.rand(B, n, w + 1, generator=g) + 0.1
    band[:, :, 0] = -(2 * w + 1 + torch.rand(B, n, generator=g))
    rhs = torch.zeros(B, n)
    pf = _bitwise(lib, (w, 0, 1, 16, SMALL_CTA), band, rhs)
    x = tfb.fleet_banded_solve_plain(pf, rhs, w)
    assert x[0, -1].item() == 0.0 and torch.signbit(x[0, -1])
