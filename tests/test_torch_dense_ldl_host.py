"""csrc/dense_ldl.cu's warp solve (K5, and K7 at n <= 32), its warp
factor (K6 and K8 at n <= 32), the tiles route of K6, K7 and K8 above
n = 32 and K4 on both its routes (the warp factor in K4's rounding order
at n <= 32, 32-row blocks above) run on the CPU, held bitwise against
their plain versions; and the launch plans of the warp solve, of K4 and
of K6/K8.

The CUDA source is compiled with the host's g++ against the emulation of
``tests/test_torch_fleet_banded_host.py`` (a CTA's threads as threads,
a shuffle an exchange through the warp's 32 slots at one warp barrier,
``cp.async`` an immediate copy, shared memory NaN at start, the ``_rn``
intrinsics the host's IEEE operations with no contraction), with the
C entries' own launches: CTAs of one warp, and the tiles route's solve a
CTA of block_threads(n).  The
data hold zero right-hand sides, negative and clamped pivots, an inf in
a right-hand side and NaN below the diagonal of every factor and matrix,
so signed zeros, NaN propagation and the unread parts are checked.
Skipped where there is no g++."""

from pathlib import Path

import pytest
import torch

from tenscalc_tpu_torch.kkt import dense_ldl as tdl
from tenscalc_tpu_torch.kkt import fleet as tfl
from tenscalc_tpu_torch.kkt import pallas_ldl as tpl
from test_torch_fleet_banded_host import build_host_library

torch.set_num_threads(1)

SOURCE = Path(tdl.__file__).resolve().parents[1] / "csrc" / "dense_ldl.cu"


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    return tdl.bind(build_host_library(
        tmp_path_factory.mktemp("dense_ldl_host"), SOURCE, tdl.DEFINES))


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal bit for bit, signed zeros included, with NaN where the other
    has NaN (payloads aside)."""
    nan = a.isnan()
    return (torch.equal(nan, b.isnan())
            and torch.equal(a[~nan].view(torch.int32), b[~nan].view(torch.int32)))


def _solve_data(B, n, seed, diagonal):
    """A factor F whose rows past the diagonal are L's columns, NaN below
    the diagonal (never read), ``diagonal`` ("d": K4's layout, "1": K6's
    Lt) on it; pivots of either sign, every fifth at the clamp; instance 0
    with b = 0, instance 1 with an inf in b."""
    g = torch.Generator().manual_seed(seed)
    F = torch.randn(B, n, n, generator=g)
    sign = torch.where(torch.rand(B, n, generator=g) < 0.5, -1.0, 1.0)
    d = sign * (0.5 + torch.rand(B, n, generator=g))
    d[:, ::5] = sign[:, ::5] * tdl.CLAMP
    b = torch.randn(B, n, generator=g)
    b[0] = 0.0
    if B > 1:
        b[1, n // 2] = float("inf")
    F = torch.where(torch.ones(n, n, dtype=torch.bool).tril(-1), float("nan"), F)
    F.diagonal(dim1=1, dim2=2).copy_(d if diagonal == "d" else torch.ones_like(d))
    return F, d, b


def _warp_solve(lib, F, d, b):
    B, n = b.shape
    x = torch.full_like(b, float("nan"))
    assert lib.tc_dense_ldl_warp_solve(F.data_ptr(), d.data_ptr(), b.data_ptr(),
                                       x.data_ptr(), n, B, None) == 0
    return x


# K5 at the sls width, a ragged width, and each staged chunk count's
# edges; K7's warp route from n = 1 to its top, one instance and five
K5_CASES = [(5, 13), (4, 32), (3, 80), (2, 160), (2, 33)]
K7_CASES = [(B, n) for n in (1, 13, 32) for B in (1, 5)]


@pytest.mark.parametrize("B,n", K5_CASES)
def test_k5_on_the_host_equals_its_plain_version(lib, B, n):
    F, d, b = _solve_data(B, n, seed=B + n, diagonal="d")
    px = tfl.fleet_ldl_solve_plain(F, d, b)
    assert (px == 0).logical_and(px.signbit()).any()  # a -0 to keep
    if n > 1:
        assert px.isnan().any()  # the inf's NaNs to propagate
    assert _same_bits(_warp_solve(lib, F, d, b), px)


@pytest.mark.parametrize("B,n", K7_CASES)
def test_k7_warp_route_on_the_host_equals_its_plain_version(lib, B, n):
    F, d, b = _solve_data(B, n, seed=7 * B + n, diagonal="1")
    assert tdl.solve_plan(n, B).route == "registers"
    px = tpl.pallas_ldl_solve_plain(F, d, b)
    assert _same_bits(_warp_solve(lib, F, d, b), px)


@pytest.mark.parametrize("n", [13, 32])
def test_k7_and_k5_give_the_same_bits_on_one_factor(lib, n):
    """K4's layout (d on the diagonal) and K6's (1 on it) of one factor:
    the two routes read neither diagonal, and their plain versions share
    one reduction tree at n <= 32."""
    F5, d, b = _solve_data(5, n, seed=n, diagonal="d")
    F7 = F5.clone()
    F7.diagonal(dim1=1, dim2=2).fill_(1.0)
    x5, x7 = _warp_solve(lib, F5, d, b), _warp_solve(lib, F7, d, b)
    assert _same_bits(x5, x7)
    assert _same_bits(x5, tfl.fleet_ldl_solve_plain(F5, d, b))
    assert _same_bits(x7, tpl.pallas_ldl_solve_plain(F7, d, b))


def _sym(B, n, seed):
    """Symmetric-indefinite matrices, a zero first pivot (clamped)."""
    g = torch.Generator().manual_seed(seed)
    A = torch.randn(B, n, n, generator=g)
    A = A + A.transpose(1, 2)
    sign = torch.where(torch.rand(B, n, generator=g) < 0.5, -1.0, 1.0)
    A.diagonal(dim1=1, dim2=2).copy_(sign * (n + torch.rand(B, n, generator=g)))
    A[:, 0, :] = 0.0
    A[:, :, 0] = 0.0
    return A, torch.randn(B, n, generator=g)


@pytest.mark.parametrize("n", [1, 13, 32])
def test_one_warp_factor_kernels_on_the_host_equal_plain_versions(lib, n):
    """K6 and K8 (whose solve is the warp solve at n <= 32) on CTAs of one
    warp, on matrices with no NaN (K4's half is a case of
    test_k4_on_the_host_equals_its_plain_version)."""
    B, clamp = 3, tdl.CLAMP
    A, b = _sym(B, n, seed=n)
    threads = tdl.block_threads(n)
    Lt, d6 = torch.empty_like(A), torch.empty_like(b)
    assert lib.tc_dense_ldl_factor(A.data_ptr(), Lt.data_ptr(), d6.data_ptr(), None, n, B,
                                   clamp, None) == 0
    Lt8, d8, x8 = torch.empty_like(A), torch.empty_like(b), torch.empty_like(b)
    assert lib.tc_dense_ldl_factor_solve(A.data_ptr(), b.data_ptr(), Lt8.data_ptr(),
                                         d8.data_ptr(), x8.data_ptr(), None, n, B, threads,
                                         clamp, None) == 0
    pLt, pd6, px8 = tpl.pallas_ldl_factor_solve_plain(A, b, clamp)
    assert _same_bits(Lt, pLt) and _same_bits(d6, pd6)
    assert _same_bits(Lt8, pLt) and _same_bits(d8, pd6) and _same_bits(x8, px8)


def test_host_launches_refuse_what_the_kernels_do_not_take(lib):
    F, d, b = _solve_data(2, 160, seed=0, diagonal="d")
    x = torch.empty_like(b)
    args = (F.data_ptr(), d.data_ptr(), b.data_ptr(), x.data_ptr())
    for n, B in [(161, 2), (0, 2), (32, 0), (160, -1)]:
        assert lib.tc_dense_ldl_warp_solve(*args, n, B, None) != 0
        assert lib.tc_dense_ldl_fleet_factor(F.data_ptr(), F.data_ptr(), d.data_ptr(), n,
                                             B, tdl.CLAMP, None) != 0
    # K8 at n <= 32 runs the warp factor and the warp solve: its CTA must be
    # one warp
    assert lib.tc_dense_ldl_factor_solve(F.data_ptr(), b.data_ptr(), F.data_ptr(),
                                         d.data_ptr(), x.data_ptr(), None, 32, 1, 64,
                                         tdl.CLAMP, None) != 0
    # above n = 32 the tiles route needs its scratch, and its solve a tree of
    # whole warps, at most two terms a thread
    W = torch.empty_like(F)
    assert lib.tc_dense_ldl_factor(F.data_ptr(), F.data_ptr(), d.data_ptr(), None, 33, 1,
                                   tdl.CLAMP, None) != 0
    for w, n, threads in [(None, 33, 64), (W, 160, 64), (W, 160, 48), (W, 33, 1024)]:
        assert lib.tc_dense_ldl_factor_solve(
            F.data_ptr(), b.data_ptr(), F.data_ptr(), d.data_ptr(), x.data_ptr(),
            None if w is None else w.data_ptr(), n, 1, threads, tdl.CLAMP, None) != 0
    for n, threads in [(160, 64), (160, 48), (33, 1024), (0, 64)]:
        assert lib.tc_dense_ldl_solve(*args, n, 1, threads, None) != 0


@pytest.mark.parametrize("n,route,chunks", [
    (1, "registers", 1), (13, "registers", 1), (32, "registers", 1),
    (33, "staged", 2), (80, "staged", 3), (128, "staged", 4), (160, "staged", 5),
])
@pytest.mark.parametrize("B", [1, 5, 1000, 1024])
def test_solve_plan_routes_and_covers_the_batch(n, route, chunks, B):
    plan = tdl.solve_plan(n, B)
    assert (plan.route, plan.chunks) == (route, chunks)
    assert plan.grid == B  # a CTA of one warp an instance
    assert plan.smem == (0 if route == "registers" else 4 * n * n)
    assert plan.smem <= tdl.SMEM_MAX


def test_solve_plan_refuses_shapes_the_kernel_does_not_take():
    for n, B in [(0, 4), (tdl.FLEET_MAX_N + 1, 4), (32, 0)]:
        with pytest.raises(ValueError):
            tdl.solve_plan(n, B)
    assert tdl.solve_plan(tdl.FLEET_MAX_N, 8).smem == 102_400


def _factor_data(B, n, seed):
    """``_sym``'s matrices (a zero first pivot, clamped; pivots of either
    sign) with NaN in the strict lower triangle, which no kernel may
    read; with B > 1 an inf in instance 1's b, instance 1 scaled by 1e21
    and instance 2 by 1e-25 (every pivot clamped) with an entry of 1e38
    whose quotient overflows."""
    A, b = _sym(B, n, seed)
    A = torch.where(torch.ones(n, n, dtype=torch.bool).tril(-1), float("nan"), A)
    if B > 1:
        b[1, n // 2] = float("inf")
        A[1] *= 1e21
        A[2:] *= 1e-25
        if n > 2:
            A[2:, 1, 2] = 1e38
    return A, b


@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("n", range(1, tdl.REG_MAX_N + 1))
def test_k6_and_k8_warp_factor_on_the_host_equal_plain_versions(lib, n, B):
    """K6 and K8 on the warp-factor route (the C entries' own launch at
    n <= 32), bit for bit: the factor, the pivots and K8's x."""
    A, b = _factor_data(B, n, seed=100 + 2 * n + B)
    plan = tdl.factor_plan(n, B)
    assert plan.route == "warp"
    pLt, pd, px = tpl.pallas_ldl_factor_solve_plain(A, b, tdl.CLAMP)
    # the NaNs below the diagonal stay unread (instance 2 overflows)
    assert not pLt[:2].isnan().any() and not pd[:2].isnan().any()
    Lt, d = torch.full_like(A, float("nan")), torch.full_like(b, float("nan"))
    assert lib.tc_dense_ldl_factor(A.data_ptr(), Lt.data_ptr(), d.data_ptr(), None, n, B,
                                   tdl.CLAMP, None) == 0
    assert _same_bits(Lt, pLt) and _same_bits(d, pd)
    Lt8, d8, x8 = (torch.full_like(t, float("nan")) for t in (A, b, b))
    assert lib.tc_dense_ldl_factor_solve(A.data_ptr(), b.data_ptr(), Lt8.data_ptr(),
                                         d8.data_ptr(), x8.data_ptr(), None, n, B,
                                         plan.threads, tdl.CLAMP, None) == 0
    assert _same_bits(Lt8, pLt) and _same_bits(d8, pd) and _same_bits(x8, px)


# the tiles route: two panels (the second of one row), two full ones, and
# a ragged last panel after three full ones
TILE_NS = [33, 45, 64, 97]


@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("n", TILE_NS)
def test_k6_and_k8_tiles_route_on_the_host_equal_plain_versions(lib, n, B):
    """K6 and K8 on the tiles route (the C entries' own launches: one a
    panel of one-warp CTAs, then K8's solve, a CTA of block_threads(n)),
    bit for bit: every entry of Lt (zeros below the diagonal, 1 on it,
    written over NaN), the pivots and K8's x; with NaN below A's diagonal
    (never read), a zero first row, at B = 3 an inf in a b and instances
    at 1e21 and 1e-25 whose quotients overflow, and the scratch NaN."""
    A, b = _factor_data(B, n, seed=500 + 2 * n + B)
    plan = tdl.factor_plan(n, B)
    assert plan.route == "tiles" and plan.launches == -(-n // 32)
    pLt, pd, px = tpl.pallas_ldl_factor_solve_plain(A, b, tdl.CLAMP)
    assert not pLt[:2].isnan().any() and not pd[:2].isnan().any()
    if B > 2:
        assert pLt[2].isinf().any() and px[1].isnan().any()
    W = torch.full_like(A, float("nan"))
    Lt, d = torch.full_like(A, float("nan")), torch.full_like(b, float("nan"))
    assert lib.tc_dense_ldl_factor(A.data_ptr(), Lt.data_ptr(), d.data_ptr(), W.data_ptr(),
                                   n, B, tdl.CLAMP, None) == 0
    assert _same_bits(Lt, pLt) and _same_bits(d, pd)
    W.fill_(float("nan"))
    Lt8, d8, x8 = (torch.full_like(t, float("nan")) for t in (A, b, b))
    assert lib.tc_dense_ldl_factor_solve(A.data_ptr(), b.data_ptr(), Lt8.data_ptr(),
                                         d8.data_ptr(), x8.data_ptr(), W.data_ptr(), n, B,
                                         plan.threads, tdl.CLAMP, None) == 0
    assert _same_bits(Lt8, pLt) and _same_bits(d8, pd) and _same_bits(x8, px)


@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("n", TILE_NS)
def test_k7_tiles_route_on_the_host_equals_its_plain_version(lib, n, B):
    """K7 above n = 32 (a CTA of block_threads(n) an instance, the tree of
    the plain version) against a factor with NaN below its diagonal, pivots
    of either sign and at the clamp, b = 0 (signed zeros) and an inf."""
    F, d, b = _solve_data(B, n, seed=700 + 2 * n + B, diagonal="1")
    px = tpl.pallas_ldl_solve_plain(F, d, b)
    if B > 1:
        assert px.isnan().any()
    x = torch.full_like(b, float("nan"))
    assert lib.tc_dense_ldl_solve(F.data_ptr(), d.data_ptr(), b.data_ptr(), x.data_ptr(),
                                  n, B, tdl.block_threads(n), None) == 0
    assert _same_bits(x, px)


def test_k7_tiles_route_takes_two_terms_a_thread(lib):
    """At n > 512 a thread of the tree holds two terms a row (T = 512): the
    same kernel with a tree of 64 threads at n = 97, held against the plain
    version of that tree (the two-term slots, the own block in either of
    them, and warps before the own one holding later terms)."""
    n, B, threads = 97, 2, 64
    F, d, b = _solve_data(B, n, seed=11, diagonal="1")
    px = tdl.solve_rows_plain(F, d, b, threads)
    x = torch.full_like(b, float("nan"))
    assert lib.tc_dense_ldl_solve(F.data_ptr(), d.data_ptr(), b.data_ptr(), x.data_ptr(),
                                  n, B, threads, None) == 0
    assert _same_bits(x, px)


# K4's registers route at its ends and a ragged n, and the blocked
# route at each panel count's edges, the n = 80 fleet and the cap
K4_CASES = [(B, n) for n in (1, 13, 31, 32, 33, 63, 64, 65, 80, 96) for B in (1, 3)]
K4_CASES.append((1, tdl.FLEET_MAX_N))


@pytest.mark.parametrize("B,n", K4_CASES)
def test_k4_on_the_host_equals_its_plain_version(lib, B, n):
    """K4's C entry (its own launch: the warp factor in K4's rounding
    order, (d_c r_i) r_k, at n <= 32, the blocked route above) bit for
    bit against K4's plain version: the factor with the pivot on its
    diagonal and zeros below, and d; with NaN below A's diagonal (never
    read), a zero first row (its pivot clamped), and at B = 3 an instance
    scaled by 1e21 and one by 1e-25 (every pivot clamped) whose quotient
    1e38 / 1e-7 overflows."""
    A, _ = _factor_data(B, n, seed=300 + 2 * n + B)
    plan = tdl.fleet_factor_plan(n, B)
    assert plan.route == ("registers" if n <= tdl.REG_MAX_N else "blocked")
    pL, pd = tfl.fleet_ldl_factor_plain(A, tdl.CLAMP)
    assert not pL[:2].isnan().any() and not pd[:2].isnan().any()
    if B > 2 and n > 2:
        assert pL[2].isinf().any() and pd[2, :2].abs().eq(tdl.CLAMP).all()
    L, d = torch.full_like(A, float("nan")), A.new_full((B, n), float("nan"))
    assert lib.tc_dense_ldl_fleet_factor(A.data_ptr(), L.data_ptr(), d.data_ptr(), n, B,
                                         tdl.CLAMP, None) == 0
    assert _same_bits(L, pL) and _same_bits(d, pd)


@pytest.mark.parametrize("n,route,panels", [
    (1, "registers", 1), (13, "registers", 1), (32, "registers", 1),
    (33, "blocked", 2), (80, "blocked", 3), (128, "blocked", 4), (160, "blocked", 5),
])
@pytest.mark.parametrize("B", [1, 256, 1000, 1024])
def test_fleet_factor_plan_routes_and_covers_the_batch(n, route, panels, B):
    plan = tdl.fleet_factor_plan(n, B)
    assert (plan.route, plan.panels) == (route, panels)
    assert plan.grid == B  # a CTA of one warp an instance
    assert (plan.smem == 0) == (route == "registers")
    assert plan.smem <= tdl.SMEM_MAX


def test_fleet_factor_plan_is_the_c_entrys_own(lib):
    """The shared memory the C entry launches K4 with, at every n; eight
    CTAs an SM at the n = 80 fleet (an SM's 233,472 bytes, 1,024 of them
    reserved a CTA), two at the cap."""
    for n in range(1, tdl.FLEET_MAX_N + 1):
        assert lib.tc_dense_ldl_fleet_factor_smem(n) == tdl.fleet_factor_plan(n, 1).smem
    assert lib.tc_dense_ldl_fleet_factor_smem(tdl.FLEET_MAX_N + 1) == -1
    assert 8 * (tdl.fleet_factor_plan(80, 1).smem + 1024) <= 233_472
    assert 2 * (tdl.fleet_factor_plan(160, 1).smem + 1024) <= 233_472
    assert tdl.fleet_factor_plan(160, 1).smem == 105_728


def test_fleet_factor_plan_refuses_shapes_the_kernel_does_not_take():
    for n, B in [(0, 4), (tdl.FLEET_MAX_N + 1, 4), (32, 0)]:
        with pytest.raises(ValueError):
            tdl.fleet_factor_plan(n, B)


@pytest.mark.parametrize("n,route,launches,ctas", [
    (1, "warp", 1, 1), (13, "warp", 1, 1), (32, "warp", 1, 1),
    (33, "tiles", 2, 2), (97, "tiles", 4, 7), (896, "tiles", 28, 379),
])
@pytest.mark.parametrize("B", [1, 64])
def test_factor_plan_routes_and_covers_the_batch(n, route, launches, ctas, B):
    plan = tdl.factor_plan(n, B)
    assert plan.route == route
    assert plan.launches == launches
    assert plan.grid == B * ctas  # the first launch's CTAs of one warp
    assert plan.threads == tdl.block_threads(n)  # K8's solve
    assert (plan.threads == 32) == (route == "warp")


def test_factor_plan_is_the_c_entrys_own(lib):
    """The tiles route's CTAs an instance at every launch and every n: the
    diagonal block's and one a tile of the trailing upper triangle."""
    for n in range(1, tdl.SINGLE_MAX_N + 1):
        plan = tdl.factor_plan(n, 1)
        if plan.route == "warp":
            assert lib.tc_dense_ldl_factor_ctas(n, 0) == -1
            continue
        ctas = [lib.tc_dense_ldl_factor_ctas(n, p) for p in range(plan.launches)]
        assert ctas[0] == plan.grid
        assert ctas == [tdl.tile_ctas(plan.launches - 1 - p) for p in range(plan.launches)]
        assert lib.tc_dense_ldl_factor_ctas(n, plan.launches) == -1


def test_factor_plan_refuses_shapes_the_kernels_do_not_take():
    for n, B in [(0, 1), (tdl.SINGLE_MAX_N + 1, 1), (32, 0)]:
        with pytest.raises(ValueError):
            tdl.factor_plan(n, B)
