"""The port's equilibrium solver outside band mode, on
``kkt_backend='dense'`` in float64, against the JAX package's:
tests/test_equilibrium.py's games (a quadratic Nash game, a zero-sum game
and its latent variant, box constraints on both players, Mehrotra's step,
a fleet against single solves, and the condensed ``smallerNewtonMatrix``
branch with and without the affine step and with a latent variable) and
tests/test_adaptation.py's singular latent game, which only the
addEye2Hessian2 adaptation solves.

Both sides assemble the same dense KKT at every iterate and factor it by
a pivoted LU (LAPACK's getrf), so status and iterations are equal and the
variables agree to 1e-8."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import tenscalc_tpu as jtc  # noqa: E402
import tenscalc_tpu_torch as ttc  # noqa: E402

torch.set_num_threads(1)

ATOL = 1e-8
# the reference's oracle tolerance on these games (tests/test_equilibrium.py)
ORACLE_ATOL = 1e-3


@pytest.fixture(autouse=True)
def _fresh_variables():
    ttc.clear_variables()
    jtc.expr.clear_variables()
    yield
    ttc.clear_variables()


def _build(m, ns, kind, **opts):
    """tests/test_equilibrium.py's game ``kind`` built with module ``m``
    (the JAX package or the port) on the dense backend in float64;
    returns (solver, init, oracle)."""
    u, d = m.variable(ns + "u", ()), m.variable(ns + "d", ())
    kw = dict(P1optimizationVariables=[u], P2optimizationVariables=[d],
              kkt_backend="dense", dtype="float64")
    if m is ttc:
        kw["device"] = "cpu"
    init = {ns + "u": 0.0, ns + "d": 0.0}
    boxes = dict(P1constraints=[u >= -1.0, u <= 1.0], P2constraints=[d >= -2.0, d <= 2.0],
                 desiredDualityGap=1e-9, gradTolerance=1e-7)
    if kind == "nash":
        kw.update(P1objective=u ** 2 + u * d + u, P2objective=d ** 2 + u * d - d)
        oracle = {ns + "u": -1.0, ns + "d": 1.0}
    elif kind == "zero_sum":
        J = (u + d + 1) ** 2 - 2 * (d - 1) ** 2
        kw.update(P1objective=J, P2objective=-J)
        oracle = {ns + "u": -2.0, ns + "d": 1.0}
    elif kind in ("latent", "small_latent"):
        x = m.variable(ns + "x", ())
        J = (x + 1) ** 2 - 2 * (d - 1) ** 2
        kw.update(P1objective=J, P2objective=-J, latentVariables=[x],
                  latentConstraints=[x == u + d])
        if kind == "small_latent":
            kw.update(P2constraints=[d >= -3.0, d <= 3.0], smallerNewtonMatrix=True)
        init[ns + "x"] = 0.0
        oracle = {ns + "u": -2.0, ns + "d": 1.0, ns + "x": -1.0}
    else:  # 'box': the best responses clipped at u = 1
        kw.update(P1objective=(u - 2 * d) ** 2, P2objective=(d - 0.5) ** 2, **boxes)
        oracle = {ns + "u": 1.0, ns + "d": 0.5}
    kw.update(opts)
    return m.equilibrium(**kw), init, oracle


def _assert_same(sj, st, atol=ATOL):
    assert st.status == sj.status, (st.describe(), sj.describe())
    assert st.iters == sj.iters
    assert set(st.variables) == set(sj.variables)
    for k, v in sj.variables.items():
        np.testing.assert_allclose(st.variables[k], np.asarray(v), rtol=0, atol=atol, err_msg=k)


# (test, game, options): tests/test_equilibrium.py's cases
CASES = [
    ("quadratic_nash", "nash", {}),
    ("zero_sum_matches_minmax", "zero_sum", {}),
    ("latent_equality", "latent", {}),
    ("inequality_constrained_game", "box", {}),
    ("mehrotra_affine_equilibrium", "box", {"skipAffine": False}),
    ("small_newton_matrix[True]", "box", {"smallerNewtonMatrix": True, "skipAffine": True}),
    ("small_newton_matrix[False]", "box", {"smallerNewtonMatrix": True, "skipAffine": False}),
    ("small_newton_matrix_with_latent", "small_latent", {}),
]


@pytest.mark.parametrize("name,kind,opts", CASES, ids=[c[0] for c in CASES])
def test_game_matches_jax(name, kind, opts):
    ns = f"ed{CASES.index((name, kind, opts))}_"
    sj, init, oracle = _build(jtc, ns, kind, **opts)
    st, _, _ = _build(ttc, ns, kind, **opts)
    assert st.kkt_backend_resolved == sj.kkt_backend_resolved == "dense"
    assert st._solve_raw.band_mode is None
    sol_j, sol_t = sj.solve({}, init=init), st.solve({}, init=init)
    assert sol_t.ok, sol_t.describe()
    _assert_same(sol_j, sol_t)
    for k, v in oracle.items():
        np.testing.assert_allclose(sol_t.variables[k], v, atol=ORACLE_ATOL)


def test_equilibrium_solve_many_matches_jax_and_singles():
    """A fleet of three games sharing nothing but their structure (a
    per-instance parameter c): each instance as the JAX package's fleet
    and as the port's own single solve."""
    def build(m):
        u, d, c = m.variable("edb_u", ()), m.variable("edb_d", ()), m.variable("edb_c", ())
        kw = {"device": "cpu"} if m is ttc else {}
        return m.equilibrium(
            P1objective=u ** 2 + u * d + c * u, P2objective=d ** 2 + u * d - d,
            P1optimizationVariables=[u], P2optimizationVariables=[d], parameters=[c],
            kkt_backend="dense", dtype="float64", **kw)

    sj, st = build(jtc), build(ttc)
    cvals = np.array([0.5, 1.0, 1.5])
    inits = {"edb_u": np.zeros(3), "edb_d": np.zeros(3)}
    rj = sj.solve_many({"edb_c": cvals}, inits=inits)
    rt = st.solve_many({"edb_c": cvals}, inits=inits)
    assert (rt.status.numpy() == 0).all() and (np.asarray(rj.status) == 0).all()
    np.testing.assert_array_equal(rt.iters.numpy(), np.asarray(rj.iters))
    np.testing.assert_allclose(rt.u.numpy(), np.asarray(rj.u), rtol=0, atol=ATOL)
    for b in range(3):
        one = st.solve({"edb_c": cvals[b]}, init={"edb_u": 0.0, "edb_d": 0.0})
        np.testing.assert_allclose(
            rt.u[b].numpy(), [one.variables["edb_u"], one.variables["edb_d"]],
            rtol=0, atol=1e-12)


def _singular_game(m, ns, **opts):
    """tests/test_adaptation.py's square but singular game: two latent
    rows, the second twice the first, so the latent Jacobian has rank 1."""
    u, d = m.variable(ns + "u", (1,)), m.variable(ns + "d", (1,))
    x, p = m.variable(ns + "x", (2,)), m.parameter(ns + "p", ())
    J = (m.norm2(u - x[0:1]) + 0.1 * m.norm2(u) - m.norm2(d - x[1:2])
         - 0.1 * m.norm2(d))
    r = x[0] - 0.5 * (u[0] + d[0]) - p
    kw = {"device": "cpu"} if m is ttc else {}
    return m.equilibrium(
        P1objective=J, P2objective=-J, P1optimizationVariables=[u],
        P2optimizationVariables=[d], latentVariables=[x],
        P1constraints=[u >= -5.0, u <= 5.0], P2constraints=[d >= -5.0, d <= 5.0],
        latentConstraints=[r == 0, (2.0 * r) == 0], parameters=[p],
        kkt_backend="dense", dtype="float64", **kw, **opts)


def test_equilibrium_adaptation_rescues_singular_latent():
    """Without the regularization the Newton system is exactly singular
    and both sides fail alike; with the direction-error-gated addE2
    adaptation both converge in the same iterations."""
    fixed_j = _singular_game(jtc, "edsf_", addEye2Hessian=False, maxIter=60)
    fixed_t = _singular_game(ttc, "edsf_", addEye2Hessian=False, maxIter=60)
    sj = fixed_j.solve(parameters={"edsf_p": 0.3}, mu0=1.0)
    st = fixed_t.solve(parameters={"edsf_p": 0.3}, mu0=1.0)
    assert st.status != 0 and sj.status != 0
    assert st.status == sj.status and st.iters == sj.iters

    adapt_j = _singular_game(jtc, "edsa_", adjustAddEye2Hessian=True, maxIter=60)
    adapt_t = _singular_game(ttc, "edsa_", adjustAddEye2Hessian=True, maxIter=60)
    sj = adapt_j.solve(parameters={"edsa_p": 0.3}, mu0=1.0)
    st = adapt_t.solve(parameters={"edsa_p": 0.3}, mu0=1.0)
    assert st.status == 0, st.describe()
    assert st.norminf_eq <= 1e-4
    _assert_same(sj, st)
