"""The port's dense KKT backend (``kkt/dense.py``: ``kkt_factorize`` and its
``KKTFactorization`` kinds, ``ldl_factor_unblocked``, ``symmetric_solve``),
its Bunch-Kaufman inertia (``kkt/bunchkaufman.py``) and the fallbacks of
``kkt/fleet.py`` above the dense kernels' caps, against the JAX package's.

The LU kinds call LAPACK's pivoted LU on both sides (``getrf``), which
may round differently between builds: they are held at a stated
tolerance, not bitwise.  The fallbacks are the JAX package's own size
rule (a fleet of n > 160, one instance of n > 896): the blocked LDL^T
with a 1e-7 clamp, reached with no plain version of K4-K8 called."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from tenscalc_tpu.kkt import bunchkaufman as jbk  # noqa: E402
from tenscalc_tpu.kkt import dense as jd  # noqa: E402
from tenscalc_tpu.kkt import fleet as jfl  # noqa: E402
import tenscalc_tpu_torch as ttc  # noqa: E402
from tenscalc_tpu_torch.kkt import bunchkaufman as tbk  # noqa: E402
from tenscalc_tpu_torch.kkt import dense as td  # noqa: E402
from tenscalc_tpu_torch.kkt import fleet as tfl  # noqa: E402
from tenscalc_tpu_torch.kkt import pallas_ldl as tpl  # noqa: E402

from test_bunchkaufman import _cases as bk_cases  # noqa: E402
from test_ldl import _random_symmetric  # noqa: E402

torch.set_num_threads(1)

TDT = {"float64": torch.float64, "float32": torch.float32}
JDT = {"float64": jnp.float64, "float32": jnp.float32}
# a solve relative to the solution's largest entry: two LAPACK LUs (or
# two blocked LDL^T whose trailing products sum in their own orders) of
# the same well-conditioned matrix
SOLVE_RTOL = {"float64": 1e-11, "float32": 2e-5}


@pytest.fixture(autouse=True)
def _fresh_port_variables():
    ttc.clear_variables()
    yield
    ttc.clear_variables()


def _kkt(rng, nU, nG, eps=1e-3):
    """[[H, G'], [G, -eps I]]: nU positive and nG negative eigenvalues."""
    H = _random_symmetric(rng, nU, definite=True)
    G = rng.standard_normal((nG, nU))
    return np.block([[H, G.T], [G, -eps * np.eye(nG)]])


@pytest.mark.parametrize("force_ldl", [False, True])
@pytest.mark.parametrize("need_inertia", [False, True])
@pytest.mark.parametrize("dt", ["float64", "float32"])
def test_kkt_factorize_matches_jax(dt, need_inertia, force_ldl):
    """Each branch of kkt_factorize: the kind it picks, its solve and its
    inertia, on a batch of three saddle KKTs (the JAX package's one
    instance each)."""
    rng = np.random.default_rng(3)
    Ws = np.stack([_kkt(rng, 20, 8) for _ in range(3)])
    bs = rng.standard_normal((3, 28))
    fac = td.kkt_factorize(torch.tensor(Ws, dtype=TDT[dt]), need_inertia,
                           force_ldl=force_ldl)
    x = fac.solve(torch.tensor(bs, dtype=TDT[dt])).numpy()
    mp, mn = (v.numpy() for v in fac.inertia())
    for i in range(3):
        jf = jd.kkt_factorize(jnp.asarray(Ws[i], JDT[dt]), need_inertia, force_ldl=force_ldl)
        assert fac.kind == jf.kind
        xj = np.asarray(jf.solve(jnp.asarray(bs[i], JDT[dt])))
        np.testing.assert_allclose(x[i], xj, rtol=0,
                                   atol=SOLVE_RTOL[dt] * np.abs(xj).max())
        jmp, jmn = jf.inertia()
        assert (float(mp[i]), float(mn[i])) == (float(jmp), float(jmn))
    if force_ldl:
        want = "ldl" if dt == "float64" else "ldl_ir"
    elif need_inertia:
        want = "ldl" if dt == "float64" else "lu_ir"
    else:
        want = "lu"
    assert fac.kind == want
    if fac.kind != "lu":
        assert mp.tolist() == [20.0] * 3 and mn.tolist() == [8.0] * 3


def test_factorization_kinds_and_lu_solve_mixed():
    rng = np.random.default_rng(4)
    W = _kkt(rng, 12, 4)
    b = rng.standard_normal(16)
    Wt = torch.tensor(W)[None]
    np.testing.assert_allclose(td.lu_solve_mixed(Wt, torch.tensor(b)[None])[0].numpy(),
                               np.asarray(jd.lu_solve_mixed(jnp.asarray(W), jnp.asarray(b))),
                               rtol=1e-12)
    with pytest.raises(ValueError, match="kind"):
        td.KKTFactorization("qr", Wt, Wt)
    fac = td.kkt_factorize(Wt.float(), need_inertia=True)
    with pytest.raises(ValueError, match="Bunch-Kaufman"):
        fac.inertia(tol=1e-3)


@pytest.mark.parametrize("n", [1, 5, 17, 64, 130])
def test_unblocked_matches_jax_and_reconstructs(n):
    """tests/test_ldl.py::test_unblocked_reconstruction on the port, and
    the factor against the JAX package's."""
    rng = np.random.default_rng(0)
    A = _random_symmetric(rng, n)
    L, d = td.ldl_factor_unblocked(torch.tensor(A))
    Lj, dj = jd.ldl_factor_unblocked(jnp.asarray(A))
    np.testing.assert_allclose(d.numpy(), np.asarray(dj), rtol=1e-13)
    np.testing.assert_allclose(L.numpy(), np.asarray(Lj), rtol=1e-12, atol=1e-14)
    R = L.numpy() @ np.diag(d.numpy()) @ L.numpy().T
    np.testing.assert_allclose(R, A, atol=1e-10 * n)


@pytest.mark.parametrize("n", [5, 64, 65, 128, 200, 325])
def test_blocked_matches_unblocked(n):
    rng = np.random.default_rng(0)
    A = torch.tensor(_random_symmetric(rng, n))
    L1, d1 = td.ldl_factor_unblocked(A)
    L2, d2 = td.ldl_factor(A, block=64)
    np.testing.assert_allclose(d2.numpy(), d1.numpy(), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(L2.numpy(), L1.numpy(), rtol=1e-8, atol=1e-10)


def test_solve_and_symmetric_solve():
    rng = np.random.default_rng(0)
    n = 90
    A = _random_symmetric(rng, n)
    b = rng.standard_normal(n)
    B = rng.standard_normal((n, 3))
    L, d = td.ldl_factor(torch.tensor(A))
    np.testing.assert_allclose(td.ldl_solve(L, d, torch.tensor(b)).numpy(),
                               np.linalg.solve(A, b), rtol=1e-8)
    np.testing.assert_allclose(td.ldl_solve(L, d, torch.tensor(B)).numpy(),
                               np.linalg.solve(A, B), rtol=1e-8)
    x, ds, Ls = td.symmetric_solve(torch.tensor(A), torch.tensor(b))
    xj, dj, Lj = jd.symmetric_solve(jnp.asarray(A), jnp.asarray(b))
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), rtol=1e-12)
    np.testing.assert_allclose(ds.numpy(), np.asarray(dj), rtol=1e-12)


def test_indefinite_inertia():
    rng = np.random.default_rng(0)
    nU, nG = 12, 5
    H = _random_symmetric(rng, nU, definite=True)
    G = rng.standard_normal((nG, nU))
    K = np.block([[H, G.T], [G, -1e-8 * np.eye(nG)]])
    L, d = td.ldl_factor(torch.tensor(K))
    mp, mn = td.ldl_inertia(d)
    assert (int(mp), int(mn)) == (nU, nG)
    w = np.linalg.eigvalsh(K)
    assert (w > 0).sum() == nU and (w < 0).sum() == nG


def test_batched_factor():
    """tests/test_ldl.py::test_vmap_batched: a leading batch dimension."""
    rng = np.random.default_rng(0)
    As = np.stack([_random_symmetric(rng, 32) for _ in range(4)])
    Ls, ds = td.ldl_factor(torch.tensor(As))
    for i in range(4):
        Lj, dj = jd.ldl_factor(jnp.asarray(As[i]))
        np.testing.assert_allclose(ds[i].numpy(), np.asarray(dj), rtol=1e-13)
        R = Ls[i].numpy() @ np.diag(ds[i].numpy()) @ Ls[i].numpy().T
        np.testing.assert_allclose(R, As[i], atol=1e-8)


@pytest.mark.parametrize("dt,floor", [("float32", 3e-5), ("float64", 1e-12)])
def test_bk_inertia_oracle_and_jax(dt, floor):
    """tests/test_bunchkaufman.py's 24 oracle cases: counts within the
    eigenvalue oracle's bounds and equal to the JAX package's."""
    rng = np.random.default_rng(0)
    for trial in range(24):
        A = bk_cases(rng, trial)
        ev = np.linalg.eigvalsh(A)
        scale = max(np.abs(ev).max(), 1.0)
        lo_p, hi_p = int((ev > floor * scale).sum()), int((ev > -floor * scale).sum())
        lo_n, hi_n = int((ev < -floor * scale).sum()), int((ev < floor * scale).sum())
        mp, mn = (int(v) for v in tbk.bk_inertia(torch.tensor(A, dtype=TDT[dt])))
        jmp, jmn = (int(v) for v in jbk.bk_inertia(jnp.asarray(A, JDT[dt])))
        assert lo_p <= mp <= hi_p and lo_n <= mn <= hi_n, (trial, mp, mn)
        assert (mp, mn) == (jmp, jmn), trial


def test_bk_inertia_batched():
    """tests/test_bunchkaufman.py::test_bk_inertia_vmap: a batch of five,
    each instance at its own pivot sequence."""
    rng = np.random.default_rng(0)
    As = np.stack([(lambda B: B + B.T)(rng.standard_normal((8, 8))) for _ in range(5)])
    mps, mns = tbk.bk_inertia(torch.tensor(As, dtype=torch.float32))
    jmps, jmns = jax.vmap(jbk.bk_inertia)(jnp.asarray(As, jnp.float32))
    for i in range(5):
        ev = np.linalg.eigvalsh(As[i])
        assert int(mps[i]) == (ev > 0).sum() == int(jmps[i])
        assert int(mns[i]) == (ev < 0).sum() == int(jmns[i])


@pytest.fixture
def no_dense_kernel(monkeypatch):
    """Every plain version of K4-K8 raises if called."""
    def refuse(*a, **k):
        raise AssertionError("a plain version of K4-K8 ran")

    for mod, names in ((tfl, ("fleet_ldl_factor_plain", "fleet_ldl_solve_plain")),
                       (tpl, ("pallas_ldl_factor_plain", "pallas_ldl_solve_plain",
                              "pallas_ldl_factor_solve_plain"))):
        for name in names:
            monkeypatch.setattr(mod, name, refuse)


def _fallback_kkt(rng, n):
    nG = n // 4
    return _kkt(rng, n - nG, nG)


def test_single_fallback_above_896(no_dense_kernel):
    """One instance of n = 897: the adapter against the JAX package's
    unbatched FleetLDLFactorization (its CPU route is the same blocked
    LDL^T); the factor against fleet_ldl_factor_solve."""
    rng = np.random.default_rng(7)
    W = _fallback_kkt(rng, 897)
    b = rng.standard_normal(897)
    W32 = W.astype(np.float32)
    L, d, x = tfl.fleet_ldl_factor_solve(torch.tensor(W32)[None], torch.tensor(b, dtype=torch.float32)[None])
    Lj, dj, xj = jfl.fleet_ldl_factor_solve(jnp.asarray(W32), jnp.asarray(b, jnp.float32))
    assert torch.equal(torch.diagonal(L[0]), torch.ones(897))  # unit lower, not Lt
    np.testing.assert_allclose(d[0].numpy(), np.asarray(dj), rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(x[0].numpy(), np.asarray(xj), rtol=0,
                               atol=2e-4 * np.abs(np.asarray(xj)).max())
    fac = tfl.FleetLDLFactorization(torch.tensor(W)[None], n_refine=2)
    mp, mn = fac.inertia()  # before any solve: the same route as the solves
    facj = jfl.FleetLDLFactorization(jnp.asarray(W), n_refine=2)
    xs = fac.solve(torch.tensor(b)[None])[0].numpy()
    np.testing.assert_allclose(xs, np.asarray(facj.solve(jnp.asarray(b))), rtol=0,
                               atol=1e-9 * np.abs(xs).max())
    np.testing.assert_allclose(xs, np.linalg.solve(W, b), rtol=0, atol=1e-9 * np.abs(xs).max())
    jmp, jmn = facj.inertia()
    assert (float(mp[0]), float(mn[0])) == (float(jmp), float(jmn)) == (673.0, 224.0)


def test_fleet_fallback_above_160(no_dense_kernel):
    """A fleet of three at n = 168 against jax.vmap of the unbatched
    factor and solve (the JAX fleet entry's fallback above its VMEM cap)."""
    rng = np.random.default_rng(8)
    Ws = np.stack([_fallback_kkt(rng, 168) for _ in range(3)]).astype(np.float32)
    bs = rng.standard_normal((3, 168)).astype(np.float32)
    L, d, x = tfl.fleet_ldl_factor_solve(torch.tensor(Ws), torch.tensor(bs))
    Lj, dj, xj = jax.vmap(jfl.fleet_ldl_factor_solve)(jnp.asarray(Ws), jnp.asarray(bs))
    np.testing.assert_allclose(d.numpy(), np.asarray(dj), rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(L.numpy(), np.asarray(Lj), rtol=0, atol=2e-5)
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), rtol=0,
                               atol=2e-4 * np.abs(np.asarray(xj)).max())
    x2 = tfl.fleet_ldl_solve(L, d, torch.tensor(bs))
    np.testing.assert_allclose(x2.numpy(), x.numpy(), rtol=0, atol=0)
    Lb, db = tfl.fleet_ldl_factor_batched(torch.tensor(Ws), clamp=1e-7)
    assert torch.equal(Lb, L) and torch.equal(db, d)
    mp, mn = tfl.FleetLDLFactorization(torch.tensor(Ws, dtype=torch.float64)).inertia()
    assert mp.tolist() == [126.0] * 3 and mn.tolist() == [42.0] * 3
