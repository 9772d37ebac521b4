"""The rest of the port's API against the JAX package on the same inputs
(float64 on both sides): ``compute`` (tests/test_optimize.py::test_compute,
tests/test_gradient.py::test_gradient_through_compute), ``compute_object``
(tests/test_compute_object.py:16-72: the atomic copy, the validation of
copy targets, a get that needs only its own inputs set),
``solve_result`` (the raw result, its fields those of ``solve``) and
``sensitivity`` (both cases of tests/test_diagnostics.py:96-164: against
JAX's own sensitivity from the same solution to 1e-10, and the port's
own solve against the closed form and the finite differences at that
test's tolerances).  ``capture_ww`` without ``allowSave`` raises, as
JAX's does (test_torch_tooling_introspect.py holds what it captures)."""

import dataclasses
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

TOL = 1e-10  # float64 on both sides


@pytest.fixture(autouse=True)
def _fresh_port_variables():
    ttc.clear_variables()
    yield
    ttc.clear_variables()


def _np(v):
    return v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def test_compute_matches_jax():
    rng = np.random.default_rng(0)
    xv, yv = rng.standard_normal(3), rng.standard_normal(3)
    outs = []
    for tc, kw in ((jtc, {}), (ttc, {"device": "cpu"})):
        x, y = tc.variable("acx", (3,)), tc.variable("acy", (3,))
        fn = tc.compute(inputs=[x, y],
                        outputs={"dot": tc.tprod(x, [-1], y, [-1]), "sum": x + y}, **kw)
        outs.append(fn(acx=xv, acy=yv))
    j, t = outs
    assert t["dot"].dtype == torch.float64 and t["dot"].device.type == "cpu"
    for k in ("dot", "sum"):
        np.testing.assert_allclose(_np(t[k]), _np(j[k]), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(_np(t["dot"]), xv @ yv, rtol=1e-12)
    with pytest.raises(ValueError, match="missing inputs"):
        ttc.compute([ttc.variable("acz", (2,))], {}, device="cpu")()


def test_compute_runs_on_the_card_unless_told_otherwise():
    """device=None is the card; without CUDA the call raises rather than
    computing on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    x = ttc.variable("acd", (2,))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttc.compute([x], {"x": x})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttc.compute_object([x], {"x": x})


def test_gradient_through_compute_matches_jax():
    rng = np.random.default_rng(4)
    Av, uv = rng.random((10, 3)), rng.random(3)
    outs = []
    for tc, kw in ((jtc, {}), (ttc, {"device": "cpu"})):
        A, u = tc.variable("agA", (10, 3)), tc.variable("agu", (3,))
        J = tc.norm2(A @ u)
        fn = tc.compute([A, u], {"J": J, "g": tc.gradient(J, u), "h": tc.hessian(J, u)},
                        **kw)
        outs.append(fn(agA=Av, agu=uv))
    j, t = outs
    for k in ("J", "g", "h"):
        np.testing.assert_allclose(_np(t[k]), _np(j[k]), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(_np(t["g"]), 2 * Av.T @ Av @ uv, rtol=1e-5)
    np.testing.assert_allclose(_np(t["h"]), 2 * Av.T @ Av, rtol=1e-5)


def test_compute_object_atomic_copy_matches_jax():
    """All right-hand sides evaluate before any assignment (a swap)."""
    outs = []
    for tc, kw in ((jtc, {}), (ttc, {"device": "cpu"})):
        a, b = tc.variable("aoa", (2,)), tc.variable("aob", (2,))
        obj = tc.compute_object(inputs=[], outputs={"a": a, "b": b},
                                state={a: np.array([1.0, 2.0]), b: np.array([10.0, 20.0])},
                                updates={"swap": {a: b, b: a}}, **kw)
        obj.copy("swap")
        outs.append((_np(obj.get("a")), _np(obj.get("b")), _np(obj.value("aoa"))))
    for j, t in zip(*outs):
        np.testing.assert_allclose(t, j, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(outs[1][0], [10.0, 20.0])
    np.testing.assert_allclose(outs[1][1], [1.0, 2.0])


def test_compute_object_validates_targets():
    a, x = ttc.variable("aova", (2,)), ttc.variable("aovx", (2,))
    with pytest.raises(ValueError, match="non-state"):
        ttc.compute_object(inputs=[x], outputs={"a": a}, state={a: np.zeros(2)},
                           updates={"bad": {x: a}}, device="cpu")
    obj = ttc.compute_object(inputs=[x], outputs={"a": a}, state={a: np.zeros(2)},
                             device="cpu")
    with pytest.raises(ValueError, match="unknown variable"):
        obj.set("aovy", np.zeros(2))


def test_compute_object_groups_need_only_their_inputs():
    """A get or copy reads only its group's variables: with one input set,
    the group over it evaluates and the group over the other raises; a
    nested group (dict and list) and a state broadcast from a scalar."""
    rng = np.random.default_rng(1)
    pv = rng.standard_normal(3)
    outs = []
    for tc, kw in ((jtc, {}), (ttc, {"device": "cpu"})):
        p, q = tc.variable("agp", (3,)), tc.variable("agq", (3,))
        s = tc.variable("ags", (3,))
        obj = tc.compute_object(
            inputs=[p, q],
            outputs={"p2": {"sq": p * p, "both": [p + s, 2.0 * s]}, "q": q + s},
            state={s: 1.5}, updates={"acc": {s: s + p}}, **kw)
        obj.set("agp", pv)
        with pytest.raises(ValueError, match="not set"):
            obj.get("q")
        obj.copy("acc")
        obj.copy("acc")
        g = obj.get("p2")
        outs.append([_np(g["sq"]), _np(g["both"][0]), _np(g["both"][1]),
                     _np(obj.value("ags"))])
    for j, t in zip(*outs):
        np.testing.assert_allclose(t, j, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(outs[1][3], 1.5 + 2 * pv, rtol=TOL)


def _ls(tc, A, b, **kw):
    N, n = A.shape
    Av, bv, x = tc.variable("asA", (N, n)), tc.variable("asb", (N,)), tc.variable("asx", (n,))
    return tc.optimize(objective=tc.norm2(Av @ x - bv), optimizationVariables=[x],
                       parameters=[Av, bv], outputExpressions={"x": x},
                       gradTolerance=1e-10, **kw)


def _qp(tc, **kw):
    n = 3
    Qv, cv, x = tc.variable("aqQ", (n, n)), tc.variable("aqc", (n,)), tc.variable("aqx", (n,))
    J = 0.5 * tc.tprod(x, [-1], Qv @ x, [-1]) + tc.tprod(cv, [-1], x, [-1])
    return tc.optimize(objective=J, optimizationVariables=[x],
                       constraints=[x >= -1.0, x <= 1.0], parameters=[Qv, cv],
                       outputExpressions={"x": x}, desiredDualityGap=1e-9,
                       gradTolerance=1e-8, **kw)


def _as_port_solution(sol):
    """The JAX package's Solution as the port's (the same fields)."""
    fields = {f.name for f in dataclasses.fields(ttc.Solution)}
    return ttc.Solution(**{k: v for k, v in dataclasses.asdict(sol).items() if k in fields})


def test_solve_result_fields_equal_solve():
    rng = np.random.default_rng(0)
    A, b = rng.standard_normal((12, 4)), rng.standard_normal(12)
    solver = _ls(ttc, A, b, device="cpu")
    params, init = {"asA": A, "asb": b}, {"asx": np.zeros(4)}
    sol = solver.solve(params, init=init)
    res = solver.solve_result(params, init=init)
    assert res.u.shape == (4,) and res.status.shape == ()
    assert int(res.status) == sol.status == 0 and int(res.iters) == sol.iters
    np.testing.assert_array_equal(_np(res.u), sol.variables["asx"])
    assert float(res.mu) == sol.mu and float(res.f) == sol.objective
    np.testing.assert_array_equal(_np(res.scale_ineq), sol.scale_ineq)
    assert float(res.scale_cost) == float(sol.scale_cost)
    jres = _ls(jtc, A, b).solve_result(params, init=init)
    assert int(jres.status) == int(res.status) and int(jres.iters) == int(res.iters)
    np.testing.assert_allclose(_np(res.u), np.asarray(jres.u), rtol=1e-8, atol=1e-8)
    # without allowSave a save_iter takes no snapshot and changes nothing
    res2 = solver.solve_result(params, init=init, save_iter=2)
    assert res2.saved == () and res2.history is None and res.history is None
    assert torch.equal(res2.u, res.u) and int(res2.iters) == int(res.iters)


def test_capture_ww_raises_naming_m17():
    """Ported with M17: without allowSave capture_ww raises the JAX
    package's ValueError, naming the option, as JAX's does."""
    rng = np.random.default_rng(0)
    A, b = rng.standard_normal((12, 4)), rng.standard_normal(12)
    for solver in (_ls(ttc, A, b, device="cpu"), _ls(jtc, A, b)):
        with pytest.raises(ValueError, match="allowSave=True"):
            solver.capture_ww({"asA": A, "asb": b}, it=1)


def test_sensitivity_unconstrained_ls():
    """dx*/db = (A'A)^-1 A' for min ||Ax - b||^2 (test_diagnostics.py:96)."""
    rng = np.random.default_rng(0)
    A, b = rng.standard_normal((12, 4)), rng.standard_normal(12)
    params = {"asA": A, "asb": b}
    jsolver = _ls(jtc, A, b)
    jsol = jsolver.solve(params, init={"asx": np.zeros(4)})
    jsens = jsolver.sensitivity(jsol, params, wrt=["asb"])
    tsolver = _ls(ttc, A, b, device="cpu")
    tsens = tsolver.sensitivity(_as_port_solution(jsol), params, wrt=["asb"])
    np.testing.assert_allclose(tsens["asx"]["asb"], jsens["asx"]["asb"], rtol=TOL, atol=TOL)
    sol = tsolver.solve(params, init={"asx": np.zeros(4)})
    assert sol.ok and sol.history is None
    own = tsolver.sensitivity(sol, params, wrt=["asb"])["asx"]["asb"]
    np.testing.assert_allclose(own, np.linalg.solve(A.T @ A, A.T), atol=1e-6)
    assert set(tsolver.sensitivity(sol, params)["asx"]) == {"asA", "asb"}
    assert tsolver.sensitivity(sol, params)["asx"]["asA"].shape == (4, 12, 4)


def test_sensitivity_with_active_constraint():
    """A bound-constrained QP whose first variable sits at its bound
    (test_diagnostics.py:120): the port's sensitivity equals JAX's from
    the same solution, and from its own solve matches the finite
    differences and pins the active variable."""
    n, Q, c = 3, np.eye(3), np.array([-5.0, 0.3, 0.2])
    jsolver = _qp(jtc)
    jsol = jsolver.solve({"aqQ": Q, "aqc": c}, init={"aqx": np.zeros(n)})
    jsens = jsolver.sensitivity(jsol, {"aqQ": Q, "aqc": c})
    tsolver = _qp(ttc, device="cpu")
    tsens = tsolver.sensitivity(_as_port_solution(jsol), {"aqQ": Q, "aqc": c})
    for p in ("aqQ", "aqc"):
        np.testing.assert_allclose(tsens["aqx"][p], jsens["aqx"][p], rtol=TOL, atol=TOL)

    def solve_for(cval):
        return tsolver.solve({"aqQ": Q, "aqc": cval}, init={"aqx": np.zeros(n)})

    sol = solve_for(c)
    assert sol.ok
    dxdc = tsolver.sensitivity(sol, {"aqQ": Q, "aqc": c}, wrt=["aqc"])["aqx"]["aqc"]
    eps, fd = 1e-5, np.zeros((n, n))
    for j in range(n):
        cp, cm = c.copy(), c.copy()
        cp[j] += eps
        cm[j] -= eps
        fd[:, j] = (solve_for(cp).outputs["x"] - solve_for(cm).outputs["x"]) / (2 * eps)
    np.testing.assert_allclose(dxdc, fd, atol=1e-2)
    assert abs(dxdc[0, 0]) < 1e-2
    np.testing.assert_allclose(dxdc[1, 1], -1.0, atol=1e-2)
