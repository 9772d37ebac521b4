"""The port's fleet banded LDL^T of a dense KKT
(``FleetBandedFactorization``, ``fleet_banded_kkt_factorize``) held
against the JAX package's adapter, which runs its Pallas kernels in
interpret mode on the CPU, on dense symmetric matrices whose pattern a
plan's permutation makes banded, in float32: one-dimensional and matrix
right-hand sides, ``n_refine`` 0 and 2, and the inertia counts before
any solve (K3) and after one (K1's factor).  The same matrices through
``FleetBandedFromBand`` on their band give the same answers."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tenscalc_tpu.kkt import fleet_banded as jfb
from tenscalc_tpu.kkt.structure import BandedPlan as JPlan
from tenscalc_tpu_torch import expr as texpr
from tenscalc_tpu_torch.kkt import fleet_banded as tfb
from tenscalc_tpu_torch.kkt.structure import BandedPlan as TPlan

torch.set_num_threads(1)

# both sides run the same float32 elimination; XLA fuses some
# multiply-adds, so they agree to a few float32 roundings
RTOL = ATOL = 1e-5
N, W, B = 69, 4, 3


@pytest.fixture(autouse=True)
def _fresh_port_variables():
    texpr.clear_variables()
    yield
    texpr.clear_variables()


def _fleet(n, w, B, seed):
    """(band, perm, W, rhs, matrix rhs, plans): symmetric-indefinite
    lower bands (B, n, w+1) with diagonals of either sign dominating
    their rows, the dense matrices W (B, n, n) in original order with
    W[perm[a], perm[b]] = Wp[a, b], and the JAX and port plans."""
    rng = np.random.default_rng(seed)
    band = rng.standard_normal((B, n, w + 1)).astype(np.float32)
    sign = np.where(rng.random((B, n)) < 0.5, -1.0, 1.0)
    band[:, :, 0] = sign * (2 * w + 1 + rng.random((B, n)))
    for i in range(1, w + 1):
        band[:, n - i:, i] = 0.0
    perm = rng.permutation(n).astype(np.int64)
    Wp = np.zeros((B, n, n), np.float32)
    for i in range(w + 1):
        idx = np.arange(n - i)
        Wp[:, idx + i, idx] = band[:, : n - i, i]
        Wp[:, idx, idx + i] = band[:, : n - i, i]
    Wd = np.empty_like(Wp)
    Wd[:, perm[:, None], perm[None, :]] = Wp
    rhs = rng.standard_normal((B, n)).astype(np.float32)
    rhs_m = rng.standard_normal((B, n, 3)).astype(np.float32)
    plans = [P(perm=perm, iperm=np.argsort(perm), block=w, n_blocks=-(-n // w), n=n,
               bandwidth=w, worthwhile=True) for P in (JPlan, TPlan)]
    return band, perm, Wd, rhs, rhs_m, plans


class _TorchOp:
    """A band with its dense matrix's product, the FromBand contract."""

    def __init__(self, band, perm, Wd):
        self.band = torch.from_numpy(band)
        self.perm = torch.from_numpy(perm)
        self._W = torch.from_numpy(Wd)

    def matvec(self, x):
        return torch.einsum("bij,bj->bi", self._W, x)


def test_band_of_dense_is_the_permuted_band():
    band, perm, Wd, _, _, (_, tplan) = _fleet(N, W, B, seed=1)
    got = tfb.band_of_dense(torch.from_numpy(Wd), tplan)
    np.testing.assert_array_equal(got.numpy(), band)


@pytest.mark.parametrize("n_refine", [0, 2])
@pytest.mark.parametrize("matrix_rhs", [False, True])
def test_dense_adapter_matches_jax(n_refine, matrix_rhs):
    band, perm, Wd, rhs, rhs_m, (jplan, tplan) = _fleet(N, W, B, seed=2 + n_refine)
    b = rhs_m if matrix_rhs else rhs
    fac_t = tfb.fleet_banded_kkt_factorize(torch.from_numpy(Wd), tplan, n_refine=n_refine)
    x_t = fac_t.solve(torch.from_numpy(b))
    assert tuple(x_t.shape) == b.shape
    mp_t, mn_t = fac_t.inertia()

    def jax_solve(Wb, bb):
        fac = jfb.fleet_banded_kkt_factorize(Wb, jplan, n_refine=n_refine)
        return fac.solve(bb), fac.inertia()

    x_j, (mp_j, mn_j) = jax.vmap(jax_solve)(jnp.asarray(Wd), jnp.asarray(b))
    np.testing.assert_allclose(x_t.numpy(), np.asarray(x_j), rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(mp_t.numpy(), np.asarray(mp_j))
    np.testing.assert_array_equal(mn_t.numpy(), np.asarray(mn_j))
    # the same matrix through the adapter of a directly assembled band
    fb_t = tfb.FleetBandedFromBand(_TorchOp(band, perm, Wd), tplan, n_refine=n_refine)
    np.testing.assert_array_equal(fb_t.solve(torch.from_numpy(b)).numpy(), x_t.numpy())
    if n_refine:
        res = torch.from_numpy(b) - torch.einsum("bij,bj...->bi...", torch.from_numpy(Wd), x_t)
        assert res.abs().max().item() < 1e-4


def test_inertia_before_a_solve_runs_the_factor_alone(monkeypatch):
    """Asked before any solve, the inertia factors on its own (K3); after
    a solve it reads K1's factor and launches nothing."""
    band, perm, Wd, rhs, _, (jplan, tplan) = _fleet(N, W, B, seed=7)
    calls = {"K1": 0, "K2": 0, "K3": 0}

    def count(key, fn):
        def spy(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return spy

    # the entry points, where the card launches each kernel (K1's plain
    # version calls K3's)
    for key, name in (("K1", "fleet_banded_factor_solve_batched"),
                      ("K2", "fleet_banded_solve_batched"), ("K3", "fleet_banded_factor_batched")):
        monkeypatch.setattr(tfb, name, count(key, getattr(tfb, name)))
    Wt = torch.from_numpy(Wd)
    mp3, mn3 = tfb.fleet_banded_kkt_factorize(Wt, tplan).inertia()
    assert calls == {"K1": 0, "K2": 0, "K3": 1}
    fac = tfb.fleet_banded_kkt_factorize(Wt, tplan, n_refine=2)
    fac.solve(torch.from_numpy(rhs))
    mp1, mn1 = fac.inertia()
    assert calls == {"K1": 1, "K2": 2, "K3": 1}  # K1, then a K2 a refinement
    mp_j, mn_j = jax.vmap(
        lambda Wb: jfb.fleet_banded_kkt_factorize(Wb, jplan).inertia()
    )(jnp.asarray(Wd))
    for mp, mn in ((mp3, mn3), (mp1, mn1)):
        np.testing.assert_array_equal(mp.numpy(), np.asarray(mp_j))
        np.testing.assert_array_equal(mn.numpy(), np.asarray(mn_j))
    assert bool(((mp1 + mn1) == N).all()) and bool((mn1 > 0).all())


def test_refinement_runs_against_the_dense_matrix_in_float64():
    """A float64 KKT: the float32 factor's solves refined against the
    float64 matrix reach its accuracy far below float32's."""
    band, perm, Wd, rhs, _, (_, tplan) = _fleet(N, W, B, seed=9)
    W64 = torch.from_numpy(Wd).double()
    b64 = torch.from_numpy(rhs).double()
    x = tfb.fleet_banded_kkt_factorize(W64, tplan, n_refine=2).solve(b64)
    assert x.dtype == torch.float64
    res = (b64 - torch.einsum("bij,bj->bi", W64, x)).abs().max().item()
    assert res < 1e-9
