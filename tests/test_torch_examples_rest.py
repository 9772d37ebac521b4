"""The rest of the examples on the port against the JAX package in
float64 with ``TENSCALC_AUTO_FLEET=1`` (both sides resolve 'auto' to the
same backend): robust_regress_l1 (tests/test_examples.py:99),
dist2convex (:146), the matrix game (:123, against game_value_lp and
the JAX equilibrium) and mls (as tests/test_planner.py:101 builds it,
and at k = 1 as bench.py's mls rows); mpc_fleet is in
test_torch_mpc_fleet.py.

Where the two paths are the same they agree to 1e-8; robust_regress_l1
parts by more, for a reason the test states:

* robust_regress_l1's epigraph pairs absTheta >= +-theta go active
  together where a true coefficient is zero, so its KKT grows
  ill-conditioned: the two sides agree to 1e-8 over the first 6
  iterations (held below) and part from there (2e-3 at iteration 9),
  both converging at the same iteration to theta 6e-5 apart.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import tenscalc_tpu as jtc  # noqa: E402
from examples import dist2convex as jd2  # noqa: E402
from examples import games as jg  # noqa: E402
from examples import mls as jm  # noqa: E402
from examples import robust_regress_l1 as jrr  # noqa: E402
import tenscalc_tpu_torch as ttc  # noqa: E402
from tenscalc_tpu_torch.examples import dist2convex as td2  # noqa: E402
from tenscalc_tpu_torch.examples import games as tg  # noqa: E402
from tenscalc_tpu_torch.examples import mls as tm  # noqa: E402
from tenscalc_tpu_torch.examples import robust_regress_l1 as trr  # noqa: E402
from tenscalc_tpu_torch.examples import sls as tsls  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _fresh_variables(monkeypatch):
    monkeypatch.setenv("TENSCALC_AUTO_FLEET", "1")
    ttc.clear_variables()
    jtc.expr.clear_variables()
    yield
    ttc.clear_variables()


def _hold(sol_t, sol_j, keys, atol=1e-8):
    assert (sol_t.status, sol_t.iters) == (sol_j.status, sol_j.iters), (
        sol_t.describe(), sol_t.iters, sol_j.describe(), sol_j.iters)
    for k in keys:
        np.testing.assert_allclose(np.asarray(sol_t.outputs[k], float),
                                   np.asarray(sol_j.outputs[k], float), rtol=0, atol=atol)


def test_robust_regress_l1():
    m, n = 300, 8
    st = trr.build_solver(m, n, ns="rrt_", device="cpu")
    sj = jrr.build_solver(m, n, ns="rrt_")
    assert st.kkt_backend_resolved == sj.kkt_backend_resolved == "fleet"
    th, th0, H, y = trr.make_data(m, n)
    for a, b in zip((th, th0, H, y), jrr.make_data(m, n)):
        np.testing.assert_array_equal(a, b)
    params = {"rrt_lambda": 5.0, "rrt_y": y, "rrt_H": H}
    init = {"rrt_theta0": 0.0, "rrt_theta": np.zeros(n), "rrt_absTheta": np.ones(n)}
    # the same path while the epigraph pairs are apart
    sol6 = st.solve(params, init=init, mu0=0.01, max_iter=6)
    ref6 = sj.solve(params, init=init, mu0=0.01, max_iter=6)
    _hold(sol6, ref6, ["theta", "theta0"])
    np.testing.assert_allclose(float(sol6.outputs["J"]), float(ref6.outputs["J"]), rtol=1e-7)
    sol = st.solve(params, init=init, mu0=0.01, max_iter=200)
    ref = sj.solve(params, init=init, mu0=0.01, max_iter=200)
    assert sol.ok, sol.describe()
    _hold(sol, ref, ["theta", "theta0"], atol=1e-4)
    np.testing.assert_allclose(float(sol.outputs["J"]), float(ref.outputs["J"]), rtol=1e-6)
    big = np.abs(th) > 0.5
    assert np.abs(sol.outputs["theta"][big] - th[big]).max() < 0.25


def test_dist2convex():
    from scipy.optimize import minimize as sp_minimize

    N, d = 40, 5
    st = td2.build_solver(N, d, ns="d2t_", device="cpu")
    sj = jd2.build_solver(N, d, ns="d2t_")
    assert st.kkt_backend_resolved == sj.kkt_backend_resolved == "fleet"
    rng = np.random.default_rng(0)
    A = rng.standard_normal((d, N))
    b = 2 * rng.standard_normal(d)
    params, init = {"d2t_A": A, "d2t_b": b}, {"d2t_x": np.full(N, 1 / N)}
    sol = st.solve(params, init=init, mu0=0.1, max_iter=200)
    assert sol.ok, sol.describe()
    _hold(sol, sj.solve(params, init=init, mu0=0.1, max_iter=200), ["x", "J"])
    ref = sp_minimize(
        lambda x: np.sum((A @ x - b) ** 2), np.full(N, 1 / N),
        jac=lambda x: 2 * A.T @ (A @ x - b),
        constraints={"type": "eq", "fun": lambda x: x.sum() - 1},
        bounds=[(0, None)] * N, method="SLSQP", options={"maxiter": 500, "ftol": 1e-14},
    )
    np.testing.assert_allclose(sol.outputs["J"], ref.fun, atol=1e-4)


def test_matrix_game():
    N1, N2 = 20, 10
    st = tg.build_matrix_game(N1, N2, ns="gt_", device="cpu")
    sj = jg.build_matrix_game(N1, N2, ns="gt_")
    # nK = 32 < 64: the equilibrium's dense pivoted LU on both sides
    assert st.kkt_backend_resolved == sj.kkt_backend_resolved == "dense"
    A = np.random.default_rng(0).random((N1, N2))
    params = {"gt_A1": A}
    init = {"gt_u": np.full(N1, 1 / N1), "gt_d": np.full(N2, 1 / N2)}
    sol = st.solve(params, init=init, mu0=0.1, max_iter=300)
    assert sol.ok, sol.describe()
    _hold(sol, sj.solve(params, init=init, mu0=0.1, max_iter=300), ["u", "d", "J"], atol=1e-6)
    assert tg.game_value_lp(A) == jg.game_value_lp(A)
    np.testing.assert_allclose(sol.outputs["J"], tg.game_value_lp(A), atol=1e-3)
    np.testing.assert_allclose(sol.outputs["u"].sum(), 1.0, atol=1e-5)
    np.testing.assert_allclose(sol.outputs["d"].sum(), 1.0, atol=1e-5)
    assert sol.outputs["u"].min() >= -1e-8


def test_mls_planner_size():
    """tests/test_planner.py:101's size (N = 40, n = 24, k = 12): the
    KKT of nU = 288 rows has a band, 'fleet_banded' on both sides."""
    st = tm.build_solver(N=40, n=24, k=12, device="cpu")
    sj = jm.build_solver(N=40, n=24, k=12)
    assert st.kkt_backend_resolved == sj.kkt_backend_resolved == "fleet_banded"
    assert st.kkt_plan.bandwidth == sj.kkt_plan.bandwidth
    data = tm.default_data(40, 24, 12)
    jdata = jm.default_data(40, 24, 12)
    for k in ("A", "B"):
        np.testing.assert_array_equal(data["params"][k], jdata["params"][k])
    sol = st.solve(data["params"], init=data["init"])
    assert sol.ok, sol.describe()
    _hold(sol, sj.solve(data["params"], init=data["init"]), ["X", "J"])
    X = sol.outputs["X"]
    assert X.min() >= -1e-8 and X.max() <= 0.05 + 1e-8


@pytest.mark.parametrize("constrained", [False, True])
def test_mls_bench_rows_are_the_sls_rows(constrained):
    """bench.py's mls rows (sls's vector builders, N = 100, n = 8) are
    build_solver at k = 1: the same iterations and x to 1e-8."""
    ns = "bml_"
    st = tm.build_solver(N=100, n=8, k=1, constrained=constrained, ns=ns, device="cpu")
    assert st.kkt_backend_resolved == "fleet"
    params, init = tm.bench_inputs(ns=ns)
    sol = st.solve(params, init=init, mu0=1.0, max_iter=20)
    build = tsls.build_constrained if constrained else tsls.build_unconstrained
    sv = build(N=100, n=8, ns="bms_", device="cpu")
    ref = sv.solve({"bms_A": params[ns + "A"], "bms_b": params[ns + "B"][:, 0]},
                   init={"bms_x": init[ns + "X"][:, 0]}, mu0=1.0, max_iter=20)
    assert sol.ok and (sol.status, sol.iters) == (ref.status, ref.iters)
    np.testing.assert_allclose(sol.outputs["X"][:, 0], ref.outputs["x"], rtol=0, atol=1e-8)
