"""csrc/banded_lu.cu's kernels (K9 factor+solve, K10 solve, K11 factor)
run on the CPU, held bitwise against their plain versions at widths on
both of the factor's lane maps (two lanes a row of the trailing square up
to w = 15, one lane a row above) and on both routes (all rows staged in
shared memory, or the 128-row ring).

The CUDA source is compiled with the host's g++ against the emulation of
``tests/test_torch_fleet_banded_host.py`` (a CTA's threads as threads, a
shuffle an exchange through the warp's 32 slots at one warp barrier,
``cp.async`` an immediate copy, shared memory NaN at start, the ``_rn``
intrinsics the host's IEEE operations with no contraction), with only
the tested widths instantiated.  The bands hold exactly zero and tiny
pivots of either sign, so the clamp decides some steps.  Skipped where
there is no g++."""

from pathlib import Path

import pytest
import torch

from tenscalc_tpu_torch.kkt import banded_lu as tlu
from test_torch_fleet_banded_host import build_host_library

torch.set_num_threads(1)

SOURCE = Path(tlu.__file__).resolve().parents[1] / "csrc" / "banded_lu.cu"
# the block route's bulk copies (TMA) on the host: an immediate copy, and
# an mbarrier wait that has already seen its bytes
BULK_COPIES = [
    (r"(void bulk_copy\(bool p, float\* dst, const float\* src, unsigned bytes,\s*"
     r"unsigned long long\* bar\) \{).*?\n\}", r"\1 if (p) std::memcpy(dst, src, bytes); }"),
    (r"(void cp_async4_if\(bool p, float\* dst, const float\* src\) \{).*?\n\}",
     r"\1 if (p) *dst = *src; }"),
    (r"(void bar_wait\(unsigned long long\* bar, unsigned parity\) \{).*?\n\}", r"\1 }"),
]
CLAMP = 1e-4  # the adapters' pivot clamp
# the widths of the old lane map's range and its ends (1, 12, 15), the
# MPC-MHE fleet's (10), past the old cap (13), the first of the one-lane
# map (16), the pursuit game's (22), its last (31), and two rows a lane
# (32, 48, 63: both capacities and the cap)
WIDTHS = (1, 10, 12, 13, 15, 16, 22, 31, 32, 48, 63)


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    only = " ".join(f"X({w})" for w in WIDTHS if w <= 31)
    return tlu.bind(build_host_library(
        tmp_path_factory.mktemp("banded_lu_host"), SOURCE, tlu.DEFINES,
        [(r"#define TC_FOR_EACH_W\(X\).*?X\(31\)\n", f"#define TC_FOR_EACH_W(X) {only}\n"),
         (r"int tc_banded_lu_max_w\(\) \{ return kMaxW; \}",
          "int tc_banded_lu_max_w() { return %d; }" % tlu.MAX_W), *BULK_COPIES],
    ))


def _band(B, n, w, seed):
    """Unsymmetric bands (B, n, 2w+1) whose diagonals of either sign
    dominate their rows, zeros past the last row; a pivot made exactly
    zero (its row's entries left of the diagonal zero, so no step changes
    it) and tiny pivots of either sign, which the clamp decides; and a
    right-hand side with a zero instance."""
    g = torch.Generator().manual_seed(seed)
    band = torch.randn(B, n, 2 * w + 1, generator=g)
    sign = torch.where(torch.rand(B, n, generator=g) < 0.5, -1.0, 1.0)
    band[:, :, 0] = sign * (2 * w + 1 + torch.rand(B, n, generator=g))
    for i in range(1, w + 1):
        band[:, n - i:, i] = 0.0
        band[:, n - i:, w + i] = 0.0
    p = min(n - 1, w + 3)
    band[:, p, 0] = 0.0
    for c in range(max(0, p - w), p):
        band[:, c, p - c] = 0.0
    band[:, 1::9, 0] = 1e-9
    band[:, 4::9, 0] = -1e-9
    rhs = torch.randn(B, n, generator=g)
    rhs[0] = 0.0
    return band, rhs


def _run(lib, band, rhs, w, ring, G):
    B, n, _ = band.shape
    plan = (w, int(ring), G, tlu.instance_rows(n, w, ring))
    f, x, x10, f11 = (torch.full_like(t, float("nan")) for t in (band, rhs, rhs, band))
    pf, _ = tlu.fleet_banded_lu_factor_solve_plain(band, rhs, w, CLAMP)
    assert lib.tc_banded_lu_factor_solve(*plan, band.data_ptr(), rhs.data_ptr(),
                                         f.data_ptr(), x.data_ptr(), n, B, CLAMP,
                                         None) == 0
    assert lib.tc_banded_lu_solve(*plan, pf.data_ptr(), rhs.data_ptr(), x10.data_ptr(),
                                  n, B, None) == 0
    assert lib.tc_banded_lu_factor(*plan, band.data_ptr(), f11.data_ptr(), n, B, CLAMP,
                                   None) == 0
    return f, x, x10, f11


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal bit for bit, signed zeros included, NaN where the other has
    NaN."""
    nan = a.isnan()
    return (torch.equal(nan, b.isnan())
            and torch.equal(a[~nan].view(torch.int32), b[~nan].view(torch.int32)))


# (B, n, G, ring): one instance and a ragged group of three, staged; the
# ring (forced) past RING_ROWS rows with n not a whole number of chunks
ROUTES = [(1, 75, 1, False), (3, 101, 2, False), (1, 161, 1, True), (3, 150, 2, True)]
assert all(n > tlu.RING_ROWS for _, n, _, ring in ROUTES if ring)


@pytest.mark.parametrize("w", WIDTHS)
@pytest.mark.parametrize("B,n,G,ring", ROUTES)
def test_kernels_on_the_host_equal_plain_versions(lib, w, B, n, G, ring):
    band, rhs = _band(B, n, w, seed=7 * w + n + B)
    pf, px = tlu.fleet_banded_lu_factor_solve_plain(band, rhs, w, CLAMP)
    px10 = tlu.fleet_banded_lu_solve_plain(pf, rhs, w)
    assert (pf[..., 0].abs() == CLAMP).any()  # the clamp decided a step
    f, x, x10, f11 = _run(lib, band, rhs, w, ring, G)
    assert _same_bits(f, pf) and _same_bits(x, px)
    assert _same_bits(x10, px10)
    assert _same_bits(f11, pf)


def test_host_launches_refuse_widths_past_the_cap(lib):
    """The C entry points check the width and plan before launching: w = 0
    is on no route, and past the warp route's cap (w = 64 up, the block
    route) a ring, or a factor panel past w (the plan's rows, here
    40 + 64), is refused."""
    band, rhs = _band(1, 40, 4, seed=1)
    f, x = torch.empty_like(band), torch.empty_like(rhs)
    for w, ring, G in ((0, 0, 1), (tlu.MAX_W + 1, 0, 2), (tlu.MAX_W + 1, 1, 1)):
        assert lib.tc_banded_lu_factor_solve(w, ring, G, 40 + max(w, 1), band.data_ptr(),
                                             rhs.data_ptr(), f.data_ptr(), x.data_ptr(),
                                             40, 1, CLAMP, None) != 0
    assert lib.tc_banded_lu_max_w() == tlu.MAX_W == 63
