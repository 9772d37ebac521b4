"""The port's dense unpivoted LDL^T pieces (``kkt/dense.py``: ``ldl_factor``,
``ldl_solve``, ``ldl_inertia``, ``KKTFactorization``) and the band pair
products (``kkt/band_assemble.py``) against the JAX package's.

On the CPU both sides call the same BLAS ``?trsm`` for the triangular
solves and form the unblocked elimination's update ``M - d (c c^T)`` in
one rounding, so up to n = 64 (one block) the factor is the JAX
package's to the last bit.  Above, the trailing update is one product,
whose summation order XLA and PyTorch choose on their own."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import jax.numpy as jnp  # noqa: E402
from tenscalc_tpu.kkt import band_assemble as jba  # noqa: E402
from tenscalc_tpu.kkt import dense as jd  # noqa: E402
import tenscalc_tpu_torch as ttc  # noqa: E402
from tenscalc_tpu_torch.kkt import band_assemble as tba  # noqa: E402
from tenscalc_tpu_torch.kkt import dense as td  # noqa: E402

torch.set_num_threads(1)

# relative to the largest entry: a few roundings of a product's summation
# order (measured: 0 in float32, below 1e-15 in float64 at n <= 160)
RTOL = {"float64": 1e-12, "float32": 1e-5}
CLAMP = 1e-7


@pytest.fixture(autouse=True)
def _fresh_port_variables():
    ttc.clear_variables()
    yield
    ttc.clear_variables()


def _spd(rng, n):
    A = rng.standard_normal((n, n))
    return A @ A.T / n + np.eye(n)


def _kkt(rng, n):
    """[[H, G'], [G, -eps I]]: n - n/3 positive and n/3 negative pivots."""
    m = n // 3
    G = rng.standard_normal((m, n - m))
    return np.block([[_spd(rng, n - m), G.T], [G, -1e-3 * np.eye(m)]])


def _tiny_pivot(rng, n):
    """A KKT whose first pivots are +-1e-9: the clamp fires."""
    A = _kkt(rng, n)
    A[0, :] = A[:, 0] = 0.0
    A[0, 0] = 1e-9
    A[1, :] *= 1e-4
    A[:, 1] *= 1e-4
    A[1, 1] = -1e-9
    return A


def _close(a, b, dt, what):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = max(np.abs(b).max(), 1.0)
    err = np.abs(a - b).max() / scale
    assert err <= RTOL[dt], f"{what}: relative error {err:.3e}"


@pytest.mark.parametrize("dt", ["float64", "float32"])
@pytest.mark.parametrize("clamp", [0.0, CLAMP])
@pytest.mark.parametrize("family", ["spd", "kkt"])
@pytest.mark.parametrize("n", [13, 64, 100, 160])
def test_ldl_factor_and_solve_match_jax(n, family, clamp, dt):
    rng = np.random.default_rng(n)
    A = {"spd": _spd, "kkt": _kkt}[family](rng, n).astype(dt)
    b = rng.standard_normal(n).astype(dt)
    Lj, dj = jd.ldl_factor(jnp.asarray(A), block=64, clamp=clamp)
    xj = jd.ldl_solve(Lj, dj, jnp.asarray(b))
    L, d = td.ldl_factor(torch.tensor(A)[None], block=64, clamp=clamp)
    x = td.ldl_solve(L, d, torch.tensor(b)[None])
    assert L.dtype == d.dtype == x.dtype == getattr(torch, dt)
    if n <= 64:
        # one block: the same operations in the same order
        np.testing.assert_array_equal(L[0].numpy(), np.asarray(Lj))
        np.testing.assert_array_equal(d[0].numpy(), np.asarray(dj))
        np.testing.assert_array_equal(x[0].numpy(), np.asarray(xj))
    _close(L[0], Lj, dt, "L")
    _close(d[0], dj, dt, "d")
    _close(x[0], xj, dt, "x")
    want = (n - n // 3, n // 3) if family == "kkt" else (n, 0)
    assert tuple(float(v) for v in td.ldl_inertia(d[0])) == want


@pytest.mark.parametrize("n", [13, 100])
def test_clamped_pivots_match_jax(n):
    """Pivots of magnitude 1e-9 are raised to 1e-7 with their sign."""
    rng = np.random.default_rng(7)
    A = _tiny_pivot(rng, n)
    Lj, dj = jd.ldl_factor(jnp.asarray(A), block=64, clamp=CLAMP)
    L, d = td.ldl_factor(torch.tensor(A)[None], block=64, clamp=CLAMP)
    np.testing.assert_array_equal(d[0, :2].numpy(), [CLAMP, -CLAMP])
    np.testing.assert_array_equal(np.asarray(dj)[:2], [CLAMP, -CLAMP])
    _close(L[0], Lj, "float64", "L")
    _close(d[0], dj, "float64", "d")
    d0 = td.ldl_factor(torch.tensor(A)[None], block=64)[1]
    np.testing.assert_array_equal(d0[0, :2].numpy(), [1e-9, -1e-9])


def test_batch_is_each_instance():
    """A batch (B, n, n) factors and solves each instance as alone."""
    rng = np.random.default_rng(3)
    A = np.stack([_kkt(rng, 70) for _ in range(3)])
    b = rng.standard_normal((3, 70))
    L, d = td.ldl_factor(torch.tensor(A), block=32)
    x = td.ldl_solve(L, d, torch.tensor(b))
    for i in range(3):
        Li, di = td.ldl_factor(torch.tensor(A[i])[None], block=32)
        np.testing.assert_array_equal(L[i].numpy(), Li[0].numpy())
        np.testing.assert_array_equal(x[i].numpy(), td.ldl_solve(Li, di, torch.tensor(b[i])[None])[0].numpy())
    np.testing.assert_allclose(np.einsum("bij,bj->bi", A, x.numpy()), b, atol=1e-10)


def test_ldl_inertia_counts_half_at_tol():
    d = np.array([2.0, -1.0, 0.0, 0.5, -0.5, 1e-3, 0.0])
    for tol in (0.0, 0.5, 1e-3):
        mpj, mnj = jd.ldl_inertia(jnp.asarray(d), tol)
        mp, mn = td.ldl_inertia(torch.tensor(d), tol)
        assert (float(mp), float(mn)) == (float(mpj), float(mnj))
    # at tol 0 the two zeros count one half each on both sides
    assert tuple(float(v) for v in td.ldl_inertia(torch.tensor(d))) == (4.0, 3.0)
    mp, mn = td.ldl_inertia(torch.tensor(np.stack([d, -d])))
    assert mp.tolist() == [4.0, 3.0] and mn.tolist() == [3.0, 4.0]


def test_kkt_factorization_ldl_and_other_kinds():
    rng = np.random.default_rng(5)
    A = _kkt(rng, 30)
    b = rng.standard_normal(30)
    L, d = td.ldl_factor(torch.tensor(A)[None])
    fac = td.KKTFactorization("ldl", L, d)
    Lj, dj = jd.ldl_factor(jnp.asarray(A))
    facj = jd.KKTFactorization("ldl", Lj, dj)
    np.testing.assert_array_equal(fac.solve(torch.tensor(b)[None])[0].numpy(),
                                  np.asarray(facj.solve(jnp.asarray(b))))
    assert tuple(float(v[0]) for v in fac.inertia()) == tuple(float(v) for v in facj.inertia())
    # the other kinds, as kkt_factorize builds them, solve as the JAX
    # package's do (tests/test_torch_kkt_factorize.py holds each branch)
    W = torch.tensor(A)[None]
    for kind, force in (("lu", False), ("ldl_ir", True)):
        fac_k = td.kkt_factorize(W.float(), need_inertia=False, force_ldl=force)
        facj_k = jd.kkt_factorize(jnp.asarray(A, jnp.float32), False, force_ldl=force)
        assert fac_k.kind == facj_k.kind == kind
        xk = fac_k.solve(torch.tensor(b, dtype=torch.float32)[None])[0].numpy()
        np.testing.assert_allclose(xk, np.asarray(facj_k.solve(jnp.asarray(b, jnp.float32))),
                                   rtol=0, atol=2e-5 * np.abs(xk).max())
    assert td.kkt_factorize(W.float(), need_inertia=True).kind == "lu_ir"
    with pytest.raises(ValueError, match="kind"):
        td.KKTFactorization("cholesky", L, d)


@pytest.mark.parametrize("w", [0, 1, 3])
def test_pair_products_match_jax(w):
    rng = np.random.default_rng(w)
    AP, BP = rng.standard_normal((2, 7, 11))
    lo_j = np.asarray(jba.pair_products_lower(jnp.asarray(AP), jnp.asarray(BP), w))
    up_j = np.asarray(jba.pair_products_upper(jnp.asarray(AP), jnp.asarray(BP), w))
    lo = tba.pair_products_lower(torch.tensor(AP), torch.tensor(BP), w).numpy()
    up = tba.pair_products_upper(torch.tensor(AP), torch.tensor(BP), w).numpy()
    assert lo.shape == lo_j.shape == (w + 1, 7, 11) and up.shape == up_j.shape == (w, 7, 11)
    np.testing.assert_array_equal(lo, lo_j)
    np.testing.assert_array_equal(up, up_j)
    # a batch of pairs stacks its diagonals behind the batch dimension
    lo_b = tba.pair_products_lower(torch.tensor(np.stack([AP, BP])),
                                   torch.tensor(np.stack([BP, AP])), w).numpy()
    np.testing.assert_array_equal(lo_b[0], lo_j)
