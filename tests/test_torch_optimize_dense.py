"""The port's optimize solver on problems without inequalities, on the
large and ``timesLambda`` Newton matrices, and on the dense backends
(``'dense'``: ``kkt_factorize``; ``'ldl'``: its blocked LDL^T), against
``tests/test_optimize.py``'s analytic oracles at their own tolerances
and against the JAX solver on the same backend in float64 (iterations
equal, variables within 1e-8).  Each oracle test also runs the port's
``'auto'`` (below 64 KKT rows the fleet dense LDL^T, float32 factor
refined against the float64 KKT)."""

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

X_JAX = 1e-8  # float64, the same backend on both sides


@pytest.fixture(autouse=True)
def _fresh_port_variables():
    ttc.clear_variables()
    yield
    ttc.clear_variables()


def _opt(mod, *args, **kw):
    if mod is ttc:
        kw["device"] = "cpu"
    return mod.optimize(*args, **kw)


def _unconstrained_mls(mod, **kw):
    """test_optimize.py::test_unconstrained_mls: min ||A X - B||_F^2 / N."""
    N, n, k = 40, 8, 3
    rng = np.random.default_rng(0)
    A, B = rng.random((N, n)), rng.random((N, k))
    X0 = 0.025 + 0.02 * rng.random((n, k))
    Av, Bv, X = mod.variable("A", (N, n)), mod.variable("B", (N, k)), mod.variable("X", (n, k))
    J = mod.norm2(Av @ X - Bv) / N
    s = _opt(mod, objective=J, optimizationVariables=[X], parameters=[Av, Bv],
             outputExpressions={"J": J, "X": X}, **kw)
    sol = s.solve({"A": A, "B": B}, init={"X": X0})
    return s, sol, "X", np.linalg.lstsq(A, B, rcond=None)[0], 1e-4


def _equality_qp(mod, **kw):
    """test_optimize.py::test_equality_constrained_qp: min ||x||^2 s.t.
    a'x = 1, optimum a/||a||^2."""
    n = 6
    a = np.random.default_rng(0).standard_normal(n)
    av, x = mod.variable("a", (n,)), mod.variable("x", (n,))
    s = _opt(mod, objective=mod.norm2(x), optimizationVariables=[x],
             constraints=[mod.tprod(av, [-1], x, [-1]) == 1.0], parameters=[av],
             outputExpressions={"x": x}, **kw)
    sol = s.solve({"a": a}, init={"x": np.ones(n)})
    assert abs(a @ sol.outputs["x"] - 1.0) <= 1e-4
    return s, sol, "x", a / (a @ a), 1e-5


def _slack(mod, **kw):
    """test_optimize.py::test_slack_variable_formulation: min v s.t.
    v >= ||A x - b||^2 / N."""
    N, n = 30, 6
    rng = np.random.default_rng(0)
    A, b = rng.random((N, n)), rng.random(N)
    Av, bv = mod.variable("A", (N, n)), mod.variable("b", (N,))
    x, v = mod.variable("x", (n,)), mod.variable("v", ())
    J = mod.norm2(Av @ x - bv) / N
    s = _opt(mod, objective=v, optimizationVariables=[x, v], constraints=[v >= J],
             parameters=[Av, bv], outputExpressions={"J": J, "x": x}, **kw)
    x0 = 0.02 * rng.random(n)
    sol = s.solve({"A": A, "b": b}, init={"x": x0, "v": np.sum((A @ x0 - b) ** 2) / N + 1})
    xs = np.linalg.lstsq(A, b, rcond=None)[0]
    return s, sol, "J", np.sum((A @ xs - b) ** 2) / N, 1e-4


def _qp_variant(mod, variant, smaller, **kw):
    """test_optimize.py::test_variants_agree: an equality-constrained QP
    whose box stays inactive, skipAffine."""
    n = 5
    rng = np.random.default_rng(0)
    Q = rng.standard_normal((n, n))
    Q = Q @ Q.T + n * np.eye(n)
    c = rng.standard_normal(n)
    Qv, cv, x = mod.variable("Q", (n, n)), mod.variable("c", (n,)), mod.variable("x", (n,))
    J = 0.5 * mod.tprod(x, [-1], Qv @ x, [-1]) + mod.tprod(cv, [-1], x, [-1])
    s = _opt(mod, objective=J, optimizationVariables=[x],
             constraints=[x >= -10.0, x <= 10.0, x.sum() == 1.0], parameters=[Qv, cv],
             outputExpressions={"x": x}, variant=variant, smallerNewtonMatrix=smaller,
             skipAffine=True, **kw)
    sol = s.solve({"Q": Q, "c": c}, init={"x": np.ones(n) / n})
    K = np.block([[Q, np.ones((n, 1))], [np.ones((1, n)), np.zeros((1, 1))]])
    return s, sol, "x", np.linalg.solve(K, np.concatenate([-c, [1.0]]))[:n], 1e-4


PROBLEMS = {
    "unconstrained_mls": _unconstrained_mls,
    "equality_qp": _equality_qp,
    "slack": _slack,
    "timesLambda": lambda mod, **kw: _qp_variant(mod, "timesLambda", False, **kw),
    "standard_large": lambda mod, **kw: _qp_variant(mod, "standard", False, **kw),
    "standard_small": lambda mod, **kw: _qp_variant(mod, "standard", True, **kw),
}


@pytest.mark.parametrize("backend", ["dense", "auto"])
@pytest.mark.parametrize("name", list(PROBLEMS))
def test_oracle(name, backend):
    s, sol, key, want, atol = PROBLEMS[name](ttc, kkt_backend=backend)
    assert sol.ok, sol.describe()
    np.testing.assert_allclose(sol.outputs[key], want, atol=atol)
    if backend == "dense":
        assert s.kkt_backend_resolved == "dense"
    if s.nF == 0:
        assert sol.gap == 0.0 and sol.lam.shape == (0,)


@pytest.mark.parametrize("backend", ["dense", "ldl"])
@pytest.mark.parametrize("name", list(PROBLEMS))
def test_matches_jax_float64(name, backend):
    """The port and the JAX package on the same dense backend in float64."""
    st, sol_t, key, _, _ = PROBLEMS[name](ttc, kkt_backend=backend)
    jtc.expr.clear_variables()
    sj, sol_j, _, _, _ = PROBLEMS[name](jtc, kkt_backend=backend)
    assert st.kkt_backend_resolved == sj.kkt_backend_resolved == backend
    assert (st.nU, st.nF, st.nG) == (sj.nU, sj.nF, sj.nG)
    assert sol_t.status == sol_j.status == 0
    assert sol_t.iters == sol_j.iters
    for k, v in sol_j.variables.items():
        np.testing.assert_allclose(sol_t.variables[k], np.asarray(v), rtol=0, atol=X_JAX)
    np.testing.assert_allclose(sol_t.nu, np.asarray(sol_j.nu), rtol=0, atol=1e-7)


def test_ldl_backend_matches_dense():
    """test_optimize.py::test_ldl_backend_matches_dense on the port."""
    n = 6
    rng = np.random.default_rng(0)
    Q = rng.standard_normal((n, n))
    Q = Q @ Q.T + n * np.eye(n)
    c = rng.standard_normal(n)
    Qv, cv, x = ttc.variable("lb_Q", (n, n)), ttc.variable("lb_c", (n,)), ttc.variable("lb_x", (n,))
    J = 0.5 * ttc.tprod(x, [-1], Qv @ x, [-1]) + ttc.tprod(cv, [-1], x, [-1])

    def solve(backend):
        s = ttc.optimize(objective=J, optimizationVariables=[x],
                         constraints=[x >= -1.0, x <= 1.0], parameters=[Qv, cv],
                         outputExpressions={"x": x}, kkt_backend=backend, device="cpu")
        return s.solve({"lb_Q": Q, "lb_c": c}, init={"lb_x": np.zeros(n)})

    s1, s2 = solve("dense"), solve("ldl")
    assert s1.ok and s2.ok
    np.testing.assert_allclose(s2.outputs["x"], s1.outputs["x"], atol=1e-8)
    assert s1.iters == s2.iters


def test_useinertia_float32_bunch_kaufman():
    """test_bunchkaufman.py::test_ipm_useinertia_f32 on the port: in
    float32 'dense' solves by a refined LU and counts the inertia by
    Bunch-Kaufman; it reaches the float64 solution."""
    N, n = 40, 6
    rng = np.random.default_rng(0)
    A, b = rng.standard_normal((N, n)), rng.standard_normal(N)
    x, pA, pb = ttc.variable("bk_x", (n,)), ttc.parameter("bk_A", (N, n)), ttc.parameter("bk_b", (N,))
    J = ttc.norm2(pA @ x - pb)
    common = dict(constraints=[x >= -0.5, x <= 0.5], parameters=[pA, pb],
                  variant="standard", useInertia=True, kkt_backend="dense", device="cpu")
    params, init = {"bk_A": A, "bk_b": b}, {"bk_x": np.zeros(n)}
    s64 = ttc.optimize(J, [x], **common).solve(parameters=params, init=init)
    s32 = ttc.optimize(J, [x], **common, dtype="float32").solve(parameters=params, init=init)
    assert s64.status == 0 and s32.status == 0
    np.testing.assert_allclose(s32.variables["bk_x"], s64.variables["bk_x"], atol=2e-4)


def _chain(mod, n=80, **kw):
    """A smoothing chain with one equality and no inequality: a banded
    KKT of n + 1 rows."""
    p, x = mod.variable("ch_p", (n,)), mod.variable("ch_x", (n,))
    J = mod.norm2(x - p) + mod.norm2(x[1:] - x[:-1])
    return _opt(mod, objective=J, optimizationVariables=[x], constraints=[x[0] == 0.0],
                parameters=[p], **kw)


def test_banded_problem_without_inequalities_raises_m8():
    """A banded plan without inequalities, or on the large Newton matrix,
    no longer raises (it did before the port took its dense KKT to the
    fleet banded LDL^T): on 'auto' the dense KKT goes to
    FleetBandedFactorization (K1/K2's plain versions on the CPU) and the
    solve equals 'dense' (test_torch_banded_dense_kkt.py holds it
    against the JAX package)."""
    p = np.linspace(0.0, 1.0, 80)
    sols = {}
    for backend in ("auto", "dense"):
        ttc.clear_variables()
        s = _chain(ttc, kkt_backend=backend)
        assert s.kkt_backend_resolved == ("fleet_banded" if backend == "auto" else "dense")
        assert s._solve_raw.band_mode is None
        sols[backend] = s.solve({"ch_p": p}, init={"ch_x": np.zeros(80)})
        assert sols[backend].ok and sols[backend].iters == 2
        assert abs(sols[backend].variables["ch_x"][0]) < 1e-9
    np.testing.assert_allclose(sols["auto"].variables["ch_x"], sols["dense"].variables["ch_x"],
                               rtol=0, atol=X_JAX)
    ttc.clear_variables()
    pv, x = ttc.variable("lv_p", (80,)), ttc.variable("lv_x", (80,))
    s = ttc.optimize(ttc.norm2(x - pv) + ttc.norm2(x[1:] - x[:-1]), [x],
                     constraints=[x >= -1.0], parameters=[pv], smallerNewtonMatrix=False,
                     device="cpu")
    assert s.kkt_backend_resolved == "fleet_banded" and s.kkt_plan.n == 160
    sol = s.solve({"lv_p": p}, init={"lv_x": np.zeros(80)})
    assert sol.ok and sol.iters == 8