"""The port's fleet banded LDL^T (K1 factor+solve, K2 solve, K3 factor)
held against the JAX package's entry points, which run their Pallas
kernels in interpret mode on the CPU.  On the CPU the port's wrappers
run the plain PyTorch versions of the CUDA kernels; the kernels
themselves are held against those plain versions on the card by
chip_smoke.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tenscalc_tpu.kkt import fleet_banded as jfb
from tenscalc_tpu.kkt.dense import hdot as jhdot
from tenscalc_tpu.kkt.structure import BandedPlan as JPlan
from tenscalc_tpu_torch import expr as texpr
from tenscalc_tpu_torch.kkt import fleet_banded as tfb
from tenscalc_tpu_torch.kkt.structure import BandedPlan as TPlan

torch.set_num_threads(1)

# the plain versions perform the TPU kernels' operations in the same
# order in float32; XLA fuses some multiply-adds, so results agree to a
# few float32 roundings, not bitwise
RTOL = ATOL = 1e-5
CLAMP = 1e-7
SHAPES = [(37, 1, 3), (69, 4, 5), (149, 4, 130), (60, 9, 3)]


@pytest.fixture(autouse=True)
def _fresh_port_variables():
    texpr.clear_variables()
    yield
    texpr.clear_variables()


def _band(n, w, B, seed, zero_last_pivot=False):
    """Symmetric-indefinite lower bands (B, n, w+1): diagonals of either
    sign dominating their rows, zeros past the last row."""
    rng = np.random.default_rng(seed)
    band = rng.standard_normal((B, n, w + 1)).astype(np.float32)
    sign = np.where(rng.random((B, n)) < 0.5, -1.0, 1.0)
    band[:, :, 0] = sign * (2 * w + 1 + rng.random((B, n)))
    for i in range(1, w + 1):
        band[:, n - i:, i] = 0.0
    if zero_last_pivot:
        # an exactly zero pivot, untouched by the elimination, so the
        # clamp decides it
        band[:, n - 1, 0] = 0.0
        for i in range(1, w + 1):
            band[:, n - 1 - i, i] = 0.0
    rhs = rng.standard_normal((B, n)).astype(np.float32)
    return band, rhs


CASES = [(n, w, B, False) for n, w, B in SHAPES] + [(37, 4, 3, True)]


@pytest.mark.parametrize("n,w,B,zero_pivot", CASES)
def test_plain_versions_match_jax_kernels(n, w, B, zero_pivot):
    band, rhs = _band(n, w, B, seed=n + w + B, zero_last_pivot=zero_pivot)
    jf, jx = jfb.fleet_banded_factor_solve_batched(
        jnp.asarray(band), jnp.asarray(rhs), w, clamp=CLAMP
    )
    jf3 = jfb.fleet_banded_factor_batched(jnp.asarray(band), w, clamp=CLAMP)
    jx2 = jfb.fleet_banded_solve_batched(jf, jnp.asarray(rhs), w)

    tband, trhs = torch.from_numpy(band), torch.from_numpy(rhs)
    tf, tx = tfb.fleet_banded_factor_solve_plain(tband, trhs, w, CLAMP)
    tf3 = tfb.fleet_banded_factor_plain(tband, w, CLAMP)
    tx2 = tfb.fleet_banded_solve_plain(tf, trhs, w)

    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tf3.numpy(), np.asarray(jf3), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tx2.numpy(), np.asarray(jx2), rtol=RTOL, atol=ATOL)
    if zero_pivot:
        assert (tf[:, n - 1, 0] == CLAMP).all()


def test_cpu_wrappers_run_plain_versions():
    """A CPU tensor goes to the plain version and launches nothing."""
    band, rhs = _band(69, 4, 5, seed=1)
    tband, trhs = torch.from_numpy(band), torch.from_numpy(rhs)
    before = dict(tfb.LAUNCHES)
    f, x = tfb.fleet_banded_factor_solve_batched(tband, trhs, 4, CLAMP)
    f3 = tfb.fleet_banded_factor_batched(tband, 4, CLAMP)
    x2 = tfb.fleet_banded_solve_batched(f, trhs, 4)
    pf, px = tfb.fleet_banded_factor_solve_plain(tband, trhs, 4, CLAMP)
    assert torch.equal(f, pf) and torch.equal(x, px) and torch.equal(f3, pf)
    assert torch.equal(x2, tfb.fleet_banded_solve_plain(pf, trhs, 4))
    assert tfb.LAUNCHES == before


def test_wrappers_reject_bad_inputs():
    band, rhs = _band(20, 2, 2, seed=2)
    tband, trhs = torch.from_numpy(band), torch.from_numpy(rhs)
    with pytest.raises(ValueError):
        tfb.fleet_banded_factor_batched(tband, 3)
    with pytest.raises(TypeError):
        tfb.fleet_banded_factor_batched(tband.double(), 2)
    with pytest.raises(ValueError):
        tfb.fleet_banded_solve_batched(tband, trhs[:, :5], 2)
    with pytest.raises(ValueError, match="w=0 outside 1.."):
        tfb.fleet_banded_factor_batched(torch.zeros(2, 20, 1), 0)


def test_cpu_entry_points_take_the_adapters_layout():
    """The entry points take the adapter's contiguous (B, n, w+1) band and
    (B, n) vectors, the layout the kernels read, and return contiguous
    results in it, equal to the plain versions."""
    n, w, B = 69, 4, 5
    band, rhs, perm, W, (_, tplan) = _kkt_fleet(n, w, B, seed=6)
    fac = tfb.FleetBandedFromBand(_TorchOp(band, perm, W), tplan)
    b = fac.s * torch.from_numpy(rhs)[:, fac.perm]  # the adapter's bp
    assert fac._band_scaled.is_contiguous() and b.is_contiguous()
    f, x = tfb.fleet_banded_factor_solve_batched(fac._band_scaled, b, w, CLAMP)
    f3 = tfb.fleet_banded_factor_batched(fac._band_scaled, w, CLAMP)
    x2 = tfb.fleet_banded_solve_batched(f, b, w)
    for t in (f, x, f3, x2):
        assert t.is_contiguous()
    assert f.shape == (B, n, w + 1) and x.shape == x2.shape == (B, n)
    pf, px = tfb.fleet_banded_factor_solve_plain(fac._band_scaled, b, w, CLAMP)
    assert torch.equal(f, pf) and torch.equal(x, px) and torch.equal(f3, pf)
    assert torch.equal(x2, tfb.fleet_banded_solve_plain(pf, b, w))


def test_launches_reject_bad_operands_before_cuda(monkeypatch):
    """launch_* take contiguous float32 (B, n, w+1) / (B, n) tensors on one
    CUDA device and raise on anything else before reaching the library."""
    def no_cuda(*_):
        raise AssertionError("reached the CUDA library")

    monkeypatch.setattr(tfb, "_lib_on", no_cuda)
    B, n, w = 3, 20, 2
    band, rhs = (torch.from_numpy(a) for a in _band(n, w, B, seed=3))
    f, x = torch.empty_like(band), torch.empty_like(rhs)
    strided = torch.empty(B, w + 1, n).transpose(1, 2)  # (B, n, w+1), not contiguous
    cases = [
        (ValueError, "contiguous", lambda: tfb.launch_factor(strided, f, w, CLAMP)),
        (ValueError, "contiguous", lambda: tfb.launch_solve(f, rhs, x.t().contiguous().t(), w)),
        (ValueError, "contiguous", lambda: tfb.launch_solve(f, torch.empty(n, B).t(), x, w)),
        (ValueError, r"\(3, 20, 3\)", lambda: tfb.launch_factor(band, f[:, :, :2], w, CLAMP)),
        (ValueError, r"\(3, 20\)",
         lambda: tfb.launch_factor_solve(band, rhs[:, :5], f, x, w, CLAMP)),
        (ValueError, "w=0", lambda: tfb.launch_factor(band, f, 0, CLAMP)),
        (TypeError, "float32", lambda: tfb.launch_factor(band.double(), f, w, CLAMP)),
        (ValueError, "CUDA device", lambda: tfb.launch_factor_solve(band, rhs, f, x, w, CLAMP)),
    ]
    for exc, match, call in cases:
        with pytest.raises(exc, match=match):
            call()


# (n, w, B) -> (ring route, instances a CTA): the flagship fleet fills the
# H100's 132 SMs, four one-warp CTAs each, at two a CTA; ragged and small
# fleets; the widest band; a large fleet; instances whose group does not
# fit the shared-memory cap staged take the ring
PLANS = [
    ((149, 4, 1024), (False, 2)),
    ((439, 9, 512), (False, 1)),  # the nonlinear unicycle fleet
    ((69, 9, 1000), (False, 2)),
    ((69, 9, 1003), (False, 2)),
    ((37, 1, 64), (False, 1)),
    ((149, 16, 1024), (False, 2)),
    ((149, 4, 8192), (False, 16)),
    ((149, 4, 40_000), (False, 32)),
    ((3000, 16, 8), (False, 1)),
    ((3000, 16, 1024), (True, 2)),
    ((12000, 4, 64), (True, 1)),
    ((12000, 4, 1024), (True, 2)),
    # the wide route: a warp an instance, group 1, at the quadcopter's
    # band and past it
    ((286, 30, 512), (False, 1)),
    ((286, 63, 1024), (False, 1)),
    ((2000, 30, 512), (True, 1)),
    ((5000, 17, 8), (True, 1)),
]


@pytest.mark.parametrize("shape,expected", PLANS)
def test_launch_plan_route_and_group(shape, expected):
    n, w, B = shape
    plan = tfb.launch_plan(n, w, B, sms=132)
    assert (plan.ring, plan.group) == expected
    assert plan.rows == (tfb.RING_ROWS if plan.ring else n + w + 1)
    assert plan.stride == plan.rows * (w + 2) | 1 and plan.stride % 2 == 1
    assert plan.smem == plan.group * tfb.instance_bytes(n, w, plan.ring)
    assert plan.smem == plan.group * plan.stride * 4 <= tfb.SMEM_MAX


def test_launch_plan_route_at_the_cap_edge():
    """The route changes exactly where a group's staged instances (n + w + 1
    rows of w + 1 floats and as many entries of x, made odd) pass the
    block cap together: one instance at B = 8, two at B = 1024 on the
    narrow route (one at any B on the wide route)."""
    assert tfb.SMEM_MAX == 232_448
    assert tfb.instance_bytes(149, 4, False) == 4 * (154 * 6 + 1)
    assert tfb.instance_bytes(149, 16, False) == 4 * (166 * 18 + 1)
    for w in range(1, tfb.MAX_W + 1):
        n_max = (tfb.SMEM_MAX // 4 - 1) // (w + 2) - w - 1
        assert tfb.instance_bytes(n_max, w, False) <= tfb.SMEM_MAX
        assert tfb.instance_bytes(n_max + 1, w, False) > tfb.SMEM_MAX
        assert not tfb.launch_plan(n_max, w, 8).ring
        assert tfb.launch_plan(n_max + 1, w, 8).ring
        n2 = n_max if w > tfb.NARROW_W else (tfb.SMEM_MAX // 8 - 1) // (w + 2) - w - 1
        assert not tfb.launch_plan(n2, w, 1024).ring
        assert tfb.launch_plan(n2 + 1, w, 1024).ring


def test_launch_plan_fills_the_card_in_one_wave():
    """At B = 1024 on 132 SMs the group is 2: 512 one-warp CTAs, at most
    four an SM (one a scheduler), one wave; in general the fewest
    instances a CTA that fit B in one wave of SM_SLOTS CTAs an SM."""
    assert tfb.SM_SLOTS == 4
    plan = tfb.launch_plan(149, 4, 1024, sms=132)
    assert plan.group == 2 and -(-1024 // plan.group) == 512 <= 132 * tfb.SM_SLOTS
    assert tfb.SM_SLOTS * plan.smem <= tfb.SMEM_MAX  # four CTAs fit an SM
    for B in (1, 100, 528, 529, 999, 1000, 1001, 1024, 4224, 16_896):
        plan = tfb.launch_plan(149, 4, B, sms=132)
        assert plan.group == -(-B // (132 * tfb.SM_SLOTS))
        assert -(-B // plan.group) <= 132 * tfb.SM_SLOTS
    with pytest.raises(ValueError, match="group 33"):
        tfb.launch_plan(149, 4, 1024, group=33)
    with pytest.raises(ValueError, match="group 0"):
        tfb.launch_plan(149, 4, 1024, group=0)
    assert tfb.launch_plan(149, 4, 1024, group=8).group == 8


@pytest.mark.parametrize("w", range(1, tfb.MAX_W + 1))
def test_launch_plan_fits_the_cap_at_every_width(w):
    """Rows and bytes a CTA stay under the 232,448-byte opt-in at every
    width, staged or on the ring, for any fleet size."""
    for n in (1, 2, w, 149, 3000, 9000, 20_000):
        for B in (1, 7, 132, 1000, 1024, 5000):
            plan = tfb.launch_plan(n, w, B)
            assert 1 <= plan.group <= (tfb.MAX_GROUP if w <= tfb.NARROW_W else 1)
            assert plan.rows * (w + 2) <= plan.stride
            assert plan.smem == plan.group * plan.stride * 4 <= tfb.SMEM_MAX
            assert plan.ring or plan.rows == n + w + 1


def test_launch_plan_ring_takes_any_n():
    """The ring keeps RING_ROWS rows of the band and of x whatever n, so a
    band of any length up to 100,000 rows and beyond has a plan, of the
    same shared memory."""
    for w in (1, 4, 9, tfb.MAX_W):
        plans = [tfb.launch_plan(n, w, 1024) for n in (20_000, 60_000, 100_000, 10**7)]
        assert all(p.ring and p.rows == tfb.RING_ROWS for p in plans)
        group = 2 if w <= tfb.NARROW_W else 1
        assert {p.smem for p in plans} == {4 * (tfb.RING_ROWS * (w + 2) | 1) * group}


class _JaxOp:
    """Single-instance operator in the JAX adapter's contract."""

    def __init__(self, band, P, W):
        self.band = jnp.asarray(band)
        self.P = jnp.asarray(P)
        self._W = jnp.asarray(W)

    def matvec(self, x):
        return jhdot(self._W, x)


class _TorchOp:
    """Batched operator in the port adapter's contract."""

    def __init__(self, band, perm, W):
        self.band = torch.from_numpy(band)
        self.perm = torch.from_numpy(perm)
        self._W = torch.from_numpy(W)

    def matvec(self, x):
        return torch.einsum("bij,bj->bi", self._W, x)


def _kkt_fleet(n, w, B, seed):
    """A fleet of symmetric band matrices in permuted order, with the
    permutation and the dense matrices in original order."""
    band, rhs = _band(n, w, B, seed)
    perm = np.random.default_rng(seed).permutation(n).astype(np.int64)
    Wp = np.zeros((B, n, n), np.float32)
    for i in range(w + 1):
        idx = np.arange(n - i)
        Wp[:, idx + i, idx] = band[:, : n - i, i]
        Wp[:, idx, idx + i] = band[:, : n - i, i]
    W = np.empty_like(Wp)
    W[:, perm[:, None], perm[None, :]] = Wp
    iperm = np.argsort(perm)
    plans = [
        P(perm=perm, iperm=iperm, block=w, n_blocks=-(-n // w), n=n,
          bandwidth=w, worthwhile=True)
        for P in (JPlan, TPlan)
    ]
    return band, rhs, perm, W, plans


def test_indexing_by_perm_equals_one_hot_product():
    """The port permutes by index where the JAX adapter multiplies by a
    one-hot matrix at HIGHEST precision: the values are identical."""
    rng = np.random.default_rng(4)
    n = 69
    perm = rng.permutation(n)
    P = np.eye(n, dtype=np.float32)[perm]
    rhs = rng.standard_normal((5, n)).astype(np.float32)
    one_hot = np.array(jnp.matmul(
        jnp.asarray(P), jnp.asarray(rhs).T, precision="highest"
    )).T
    np.testing.assert_array_equal(
        torch.from_numpy(rhs)[:, torch.from_numpy(perm)].numpy(), one_hot
    )
    back = np.asarray(jnp.matmul(
        jnp.asarray(P).T, jnp.asarray(one_hot).T, precision="highest"
    )).T
    iperm = torch.argsort(torch.from_numpy(perm))
    np.testing.assert_array_equal(
        torch.from_numpy(one_hot)[:, iperm].numpy(), back
    )


def test_equilibration_and_adapter_match_jax():
    n, w, B = 69, 4, 3
    band, rhs, perm, W, (jplan, tplan) = _kkt_fleet(n, w, B, seed=5)
    s_t = tfb._sym_equilibration(torch.from_numpy(band), n, w)
    P = np.eye(n, dtype=np.float32)[perm]
    top = _TorchOp(band, perm, W)
    fac_t = tfb.FleetBandedFromBand(top, tplan, n_refine=1)
    x_t = fac_t.solve(torch.from_numpy(rhs))
    # inertia after a solve reuses its factor; before any solve it
    # factors on its own (K3)
    mp_t, mn_t = fac_t.inertia()
    mp_t3, mn_t3 = tfb.FleetBandedFromBand(top, tplan).inertia()
    for b in range(B):
        s_j = jfb._sym_equilibration(jnp.asarray(band[b]), n, w)
        np.testing.assert_allclose(s_t[b].numpy(), np.asarray(s_j), rtol=RTOL)
        fac_j = jfb.FleetBandedFromBand(
            _JaxOp(band[b], P, W[b]), jplan, n_refine=1
        )
        x_j = fac_j.solve(jnp.asarray(rhs[b]))
        np.testing.assert_allclose(
            x_t[b].numpy(), np.asarray(x_j), rtol=RTOL, atol=ATOL
        )
        mp_j, mn_j = fac_j.inertia()
        assert (mp_t[b].item(), mn_t[b].item()) == (float(mp_j), float(mn_j))
        assert (mp_t3[b].item(), mn_t3[b].item()) == (float(mp_j), float(mn_j))
    # the solve is accurate, not just equal: refined residual
    res = torch.from_numpy(rhs) - top.matvec(x_t)
    assert res.abs().max().item() < 1e-4


def test_launch_plan_wide_route_takes_one_instance_a_cta():
    """Above NARROW_W a warp serves one instance: the group is 1 at any
    fleet size, and a larger group is refused."""
    assert tfb.NARROW_W == 16 and tfb.MAX_W == 63
    for w in (17, 30, 31, 32, 63):
        for B in (1, 512, 40_000):
            assert tfb.launch_plan(286, w, B).group == 1
        with pytest.raises(ValueError, match="group 2"):
            tfb.launch_plan(286, w, 512, group=2)
    assert tfb.launch_plan(286, 16, 40_000).group > 1
