"""The port's fleet banded LU (K9 factor+solve, K10 solve, K11 factor),
its KKT adapters and the band-assembly helpers, held against the JAX
package's entry points, which run their Pallas kernels in interpret mode
on the CPU.  On the CPU the port's wrappers run the plain PyTorch
versions of the CUDA kernels; the kernels themselves are held against
those plain versions on the card by chip_smoke.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tenscalc_tpu.kkt import band_assemble as jba
from tenscalc_tpu.kkt import banded_lu as jlu
from tenscalc_tpu.kkt.dense import hdot as jhdot
from tenscalc_tpu.kkt.structure import BandedPlan as JPlan
from tenscalc_tpu.kkt.structure import plan_banded as jplan_banded
from tenscalc_tpu_torch import expr as texpr
from tenscalc_tpu_torch.kkt import band_assemble as tba
from tenscalc_tpu_torch.kkt import banded_lu as tlu
from tenscalc_tpu_torch.kkt.structure import BandedPlan as TPlan
from tenscalc_tpu_torch.kkt.structure import plan_banded as tplan_banded

torch.set_num_threads(1)

# the plain versions perform the TPU kernels' operations in the same
# order in float32; XLA sums the backward sweep's products in its own
# order and may fuse multiply-adds, so results agree to a few float32
# roundings, not bitwise
RTOL = ATOL = 1e-5
CLAMP = 1e-4  # the adapters' pivot clamp
# (n, w, B): tests/test_banded_lu.py's shapes, the T = 6, L = 8
# MPC-MHE game's plan width (n = 146, w = 10), and the pursuit game's
# (w = 22), past the kernels' former cap
SHAPES = [(24, 3, 3), (50, 5, 3), (40, 1, 3), (146, 10, 5), (70, 22, 2)]


@pytest.fixture(autouse=True)
def _fresh_port_variables():
    texpr.clear_variables()
    yield
    texpr.clear_variables()


def _random_banded_unsym(rng, n, w, dom):
    """Unsymmetric banded matrix, diagonally dominant enough for
    unpivoted elimination (tests/test_banded_lu.py's construction)."""
    A = np.zeros((n, n))
    for i in range(n):
        lo, hi = max(0, i - w), min(n, i + w + 1)
        A[i, lo:hi] = rng.standard_normal(hi - lo)
        A[i, i] += np.sign(A[i, i] or 1.0) * dom
    return A


def _band_of(A, w):
    """Full band storage (n, 2w+1) of A."""
    n = A.shape[0]
    band = np.zeros((n, 2 * w + 1))
    for c in range(n):
        for i in range(w + 1):
            if c + i < n:
                band[c, i] = A[c + i, c]
        for q in range(1, w + 1):
            if c + q < n:
                band[c, w + q] = A[c, c + q]
    return band


def _fleet(n, w, B, seed, zero_last_pivot=False):
    rng = np.random.default_rng(seed)
    As = np.stack([_random_banded_unsym(rng, n, w, 2 * w + 2) for _ in range(B)])
    if zero_last_pivot:
        # an exactly zero pivot that no elimination step touches, so the
        # clamp decides it
        As[:, n - 1, n - 1 - w: n] = 0.0
        As[:, n - 1 - w: n, n - 1] = 0.0
    bands = np.stack([_band_of(A, w) for A in As]).astype(np.float32)
    rhs = rng.standard_normal((B, n)).astype(np.float32)
    return As, bands, rhs


CASES = [(n, w, B, False) for n, w, B in SHAPES] + [(24, 3, 3, True)]


@pytest.mark.parametrize("n,w,B,zero_pivot", CASES)
def test_plain_versions_match_jax_kernels(n, w, B, zero_pivot):
    _, band, rhs = _fleet(n, w, B, seed=n + w + B, zero_last_pivot=zero_pivot)
    jb, jr = jnp.asarray(band), jnp.asarray(rhs)
    jf, jx = jlu.fleet_banded_lu_factor_solve_batched(jb, jr, w, clamp=CLAMP)
    jf11 = jlu.fleet_banded_lu_factor_batched(jb, w, clamp=CLAMP)
    jx10 = jlu.fleet_banded_lu_solve_batched(jf, jr, w)

    tb, tr = torch.from_numpy(band), torch.from_numpy(rhs)
    tf, tx = tlu.fleet_banded_lu_factor_solve_plain(tb, tr, w, CLAMP)
    tf11 = tlu.fleet_banded_lu_factor_plain(tb, w, CLAMP)
    tx10 = tlu.fleet_banded_lu_solve_plain(tf, tr, w)

    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tf11.numpy(), np.asarray(jf11), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tx10.numpy(), np.asarray(jx10), rtol=RTOL, atol=ATOL)
    if zero_pivot:
        assert (tf[:, n - 1, 0] == CLAMP).all()


def test_plain_solve_is_accurate():
    """The factor and the solve give the solution of the dense system
    (float32 accuracy on well-conditioned bands)."""
    As, band, rhs = _fleet(50, 5, 3, seed=7)
    _, x = tlu.fleet_banded_lu_factor_solve_plain(
        torch.from_numpy(band), torch.from_numpy(rhs), 5, CLAMP
    )
    for b in range(3):
        x_ref = np.linalg.solve(As[b], rhs[b].astype(float))
        # float32 elimination of a diagonally dominant band
        np.testing.assert_allclose(x[b].numpy(), x_ref, atol=2e-5)


def test_cpu_wrappers_run_plain_versions():
    """A CPU tensor goes to the plain version and launches nothing."""
    _, band, rhs = _fleet(40, 4, 5, seed=1)
    tb, tr = torch.from_numpy(band), torch.from_numpy(rhs)
    before = dict(tlu.LAUNCHES)
    f, x = tlu.fleet_banded_lu_factor_solve_batched(tb, tr, 4, CLAMP)
    f11 = tlu.fleet_banded_lu_factor_batched(tb, 4, CLAMP)
    x10 = tlu.fleet_banded_lu_solve_batched(f, tr, 4)
    pf, px = tlu.fleet_banded_lu_factor_solve_plain(tb, tr, 4, CLAMP)
    assert torch.equal(f, pf) and torch.equal(x, px) and torch.equal(f11, pf)
    assert torch.equal(x10, tlu.fleet_banded_lu_solve_plain(pf, tr, 4))
    assert tlu.LAUNCHES == before


def test_wrappers_reject_bad_inputs():
    _, band, rhs = _fleet(20, 2, 2, seed=2)
    tb, tr = torch.from_numpy(band), torch.from_numpy(rhs)
    with pytest.raises(ValueError):
        tlu.fleet_banded_lu_factor_batched(tb, 3)
    with pytest.raises(TypeError):
        tlu.fleet_banded_lu_factor_batched(tb.double(), 2)
    with pytest.raises(ValueError):
        tlu.fleet_banded_lu_solve_batched(tb, tr[:, :5], 2)
    with pytest.raises(ValueError, match="w=0 outside 1.."):
        tlu.fleet_banded_lu_factor_batched(torch.zeros(2, 40, 1), 0)


# (n, w, B) -> (ring route, instances a CTA): the MPC-MHE fleet fills the
# H100's 132 SMs at 4 a CTA; ragged and small fleets; w = 12 fits three
# an SM half; a band above the shared-memory cap takes the ring
PLANS = [
    ((290, 10, 1024), (False, 4)),
    ((146, 10, 1000), (False, 4)),
    ((69, 3, 1000), (False, 4)),
    ((69, 1, 64), (False, 1)),
    ((290, 12, 1024), (False, 3)),
    ((4000, 1, 2048), (False, 1)),
    ((3000, 12, 64), (True, 1)),
    ((3000, 12, 4096), (True, 4)),
]


@pytest.mark.parametrize("shape,expected", PLANS)
def test_launch_plan_route_and_group(shape, expected):
    n, w, B = shape
    plan = tlu.launch_plan(n, w, B, sms=132)
    assert (plan.ring, plan.group) == expected
    assert plan.rows == (tlu.RING_ROWS if plan.ring else n + w)
    assert plan.smem == plan.group * tlu.instance_bytes(n, w, plan.ring)
    assert plan.smem == plan.group * plan.rows * (2 * w + 2) * 4
    assert plan.smem <= tlu.SMEM_MAX
    if plan.group > 1:
        assert plan.smem <= tlu.SMEM_TWO_BLOCKS  # two CTAs share an SM


def test_launch_plan_staged_bytes_and_cap():
    """An instance staged whole takes its n + w rows of 2w + 1 floats and
    n + w entries of x, on the ring as many rows and entries as the ring
    holds; the route changes exactly where the first passes the block
    cap, and no plan asks for more than the cap."""
    assert tlu.instance_bytes(290, 10, False) == 4 * (300 * 21 + 300)
    assert tlu.instance_bytes(290, 10, True) == 4 * (tlu.RING_ROWS * 21 + tlu.RING_ROWS)
    assert tlu.SMEM_MAX == 232_448
    for w in (*range(1, 13), 13, 16, 22, 31, 32, 48, tlu.MAX_W):
        # the largest n staged whole at this width
        n_max = tlu.SMEM_MAX // (4 * (2 * w + 2)) - w
        assert not tlu.launch_plan(n_max, w, 8).ring
        assert tlu.launch_plan(n_max + 1, w, 8).ring
        for n in (1, 2, w, 290, n_max, n_max + 1, 20_000):
            for B in (1, 7, 264, 1024, 5000):
                plan = tlu.launch_plan(n, w, B)
                assert 1 <= plan.group <= tlu.MAX_GROUP
                assert plan.smem <= tlu.SMEM_MAX


def test_launch_plan_fills_the_card_in_one_wave():
    """The group is the fewest instances a CTA that puts B instances on
    the card in one wave at two CTAs an SM, so small fleets spread over
    more SMs."""
    for B in (1, 100, 264, 265, 528, 1024):
        plan = tlu.launch_plan(146, 10, B, sms=132)
        assert plan.group == min(4, -(-B // 264))
        assert -(-B // plan.group) <= 2 * 132 or plan.group == tlu.MAX_GROUP


def test_launch_plan_ring_takes_any_n():
    """The ring keeps RING_ROWS rows of the band and of x whatever n, so a
    band of any length has a plan, of the same shared memory."""
    for w in (1, 10, tlu.MAX_W):
        plans = [tlu.launch_plan(n, w, 4) for n in (60_000, 10**6, 10**8)]
        assert all(p.ring and p.rows == tlu.RING_ROWS for p in plans)
        assert {p.smem for p in plans} == {4 * tlu.RING_ROWS * (2 * w + 2) * plans[0].group}


def test_dense_adapter_matches_numpy_and_jax():
    """FleetBandedLUFactorization on tests/test_banded_lu.py's scrambled
    system in float64: the plan recovers the band, and two refinement
    sweeps against the float64 matrix give near-float64 accuracy."""
    rng = np.random.default_rng(11)
    n, w = 48, 4
    A = _random_banded_unsym(rng, n, w, 4.0)
    p = rng.permutation(n)
    As = A[np.ix_(p, p)]
    jplan, tplan = jplan_banded(As != 0), tplan_banded(As != 0)
    assert tplan.worthwhile and tplan.bandwidth == jplan.bandwidth
    np.testing.assert_array_equal(tplan.perm, jplan.perm)
    rhs = rng.standard_normal(n)
    x_j = np.asarray(jlu.FleetBandedLUFactorization(
        jnp.asarray(As), jplan, n_refine=2).solve(jnp.asarray(rhs)))
    fac = tlu.FleetBandedLUFactorization(
        torch.from_numpy(As)[None], tplan, n_refine=2
    )
    x_t = fac.solve(torch.from_numpy(rhs)[None])[0].numpy()
    x_ref = np.linalg.solve(As, rhs)
    # the reference's own accuracy bar for this adapter
    np.testing.assert_allclose(x_t, x_ref, rtol=0, atol=1e-9)
    np.testing.assert_allclose(x_t, x_j, rtol=0, atol=1e-9)
    mp, mn = fac.inertia()
    assert (mp == 0).all() and (mn == 0).all()


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


def test_from_band_adapter_matches_jax():
    """FleetBandedLUFromBand: the two-sided equilibration vectors read
    from band storage, the refined solve, and inertia (0, 0)."""
    n, w, B = 69, 4, 3
    As, band, rhs = _fleet(n, w, B, seed=5)
    # a row of small magnitude, as the -addE2 rows of a game KKT are
    As[:, 10, :] *= 1e-3
    band = np.stack([_band_of(A, w) for A in As]).astype(np.float32)
    perm = np.random.default_rng(5).permutation(n).astype(np.int64)
    Ap = As.astype(np.float32)
    W = np.empty_like(Ap)
    W[:, perm[:, None], perm[None, :]] = Ap
    P = np.eye(n, dtype=np.float32)[perm]
    plans = [Plan(perm=perm, iperm=np.argsort(perm), block=w,
                  n_blocks=-(-n // w), n=n, bandwidth=w, worthwhile=True)
             for Plan in (JPlan, TPlan)]
    fac_t = tlu.FleetBandedLUFromBand(_TorchOp(band, perm, W), plans[1], n_refine=2)
    x_t = fac_t.solve(torch.from_numpy(rhs))
    mp, mn = fac_t.inertia()
    assert (mp == 0).all() and (mn == 0).all()
    for b in range(B):
        fac_j = jlu.FleetBandedLUFromBand(_JaxOp(band[b], P, W[b]), plans[0], n_refine=2)
        # rsqrt of the same float32 norms
        np.testing.assert_allclose(fac_t.r[b].numpy(), np.asarray(fac_j.r), rtol=1e-6)
        np.testing.assert_allclose(fac_t.c[b].numpy(), np.asarray(fac_j.c), rtol=1e-6)
        x_j = fac_j.solve(jnp.asarray(rhs[b]))
        np.testing.assert_allclose(x_t[b].numpy(), np.asarray(x_j), rtol=RTOL, atol=ATOL)
    res = torch.from_numpy(rhs) - _TorchOp(band, perm, W).matvec(x_t)
    assert res.abs().max().item() < 1e-4


def test_band_assemble_helpers_match_jax():
    """extract_band_lower/upper, entry_masks and shifted_cols in float64:
    the same values exactly."""
    rng = np.random.default_rng(3)
    n, w = 37, 5
    Wp = rng.standard_normal((n, n))
    np.testing.assert_array_equal(
        tba.extract_band_lower(torch.from_numpy(Wp), w).numpy(),
        np.asarray(jba.extract_band_lower(jnp.asarray(Wp), w)),
    )
    np.testing.assert_array_equal(
        tba.extract_band_upper(torch.from_numpy(Wp), w).numpy(),
        np.asarray(jba.extract_band_upper(jnp.asarray(Wp), w)),
    )
    v = rng.standard_normal(n)
    for start in (0, 1):
        np.testing.assert_array_equal(
            tba.shifted_cols(torch.from_numpy(v), w, start).numpy(),
            np.asarray(jba.shifted_cols(jnp.asarray(v), w, start)),
        )
    # entries inside the band of a banded pattern under a random order
    perm = rng.permutation(n)
    iperm = np.argsort(perm)
    rows = perm[np.arange(n - 3)]
    cols = perm[np.arange(n - 3) + 3]
    lm_t, um_t = tba.entry_masks(perm, rows, cols, w, torch.float64)
    lm_j, um_j = jba.entry_masks(perm, rows, cols, w, jnp.float64)
    np.testing.assert_array_equal(lm_t.numpy(), np.asarray(lm_j))
    np.testing.assert_array_equal(um_t.numpy(), np.asarray(um_j))
    assert um_t.sum().item() == n - 3 and iperm[rows[0]] == 0
    with pytest.raises(ValueError, match="outside the band"):
        tba.entry_masks(perm, perm[:1], perm[w + 1: w + 2], w, torch.float64)


def test_indexing_by_perm_equals_one_hot_product_on_290_rows():
    """The port permutes the game's 290-row KKT by index where the JAX
    package multiplies by one-hot matrices at HIGHEST precision: the
    values, and the bands extracted from them, are identical."""
    rng = np.random.default_rng(4)
    n, w = 290, 10
    W = rng.standard_normal((n, n)).astype(np.float32)
    perm = rng.permutation(n)
    Pm = jba.perm_onehot(perm, jnp.float32)
    Wp_j = np.asarray(jnp.matmul(
        Pm, jnp.matmul(jnp.asarray(W), Pm.T, precision="highest"),
        precision="highest",
    ))
    tperm = torch.from_numpy(perm)
    Wp_t = torch.from_numpy(W)[tperm][:, tperm]
    np.testing.assert_array_equal(Wp_t.numpy(), Wp_j)
    np.testing.assert_array_equal(
        tba.extract_band_lower(Wp_t, w).numpy(),
        np.asarray(jba.extract_band_lower(jnp.asarray(Wp_j), w)),
    )
