"""The port's dense-KKT path end to end against the JAX package: the
reference's constrained least squares (``examples/sls.py``, N = 400,
n = 32) through the fleet dense backend, one solve and a fleet with
per-instance A and b; the unbanded width n = 80; equality constraints
under 'fleet' (CG nu-init) and 'pallas' (pivoted-LU nu-init); and a
Hessian that is not hoisted.  The JAX side runs with
``TENSCALC_AUTO_FLEET=1``, so that 'auto' takes its fleet backends as the
port's does on every device; its fleets run the Pallas kernels K4/K5 in
interpret mode, and its single solves take XLA's blocked LDL^T on the
CPU (the port's B = 1 runs the plain K8/K7), so single solves are held
to iterations within one and the reference's 2e-3 in float32."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import tenscalc_tpu as jtc  # noqa: E402
from examples import sls as jsls  # noqa: E402
from tenscalc_tpu.kkt.dense import lu_solve_mixed as jlu_solve_mixed  # noqa: E402
import tenscalc_tpu_torch as ttc  # noqa: E402
from tenscalc_tpu_torch.examples import sls as tsls  # noqa: E402
from tenscalc_tpu_torch.expr import lift  # noqa: E402
from tenscalc_tpu_torch.interop import result_to_numpy  # noqa: E402
from tenscalc_tpu_torch.kkt.dense import lu_solve_mixed as tlu_solve_mixed  # noqa: E402

torch.set_num_threads(1)

NS = "tdp_"
# the reference's own batched-vs-single / cross-backend float32
# tolerance (tests/test_band_mode.py); in float64 both sides still
# factor in float32 and refine once, so two solves stop at different
# points of the same convergence ball (gradient 1e-4, gap 1e-5): up to
# ~2e-4 apart in the components whose bound is nearly active
X_ATOL = {"float32": 2e-3, "float64": 5e-4}


@pytest.fixture(autouse=True)
def _fresh_port_variables():
    ttc.clear_variables()
    yield
    ttc.clear_variables()


@pytest.fixture(scope="module")
def auto_fleet():
    mp = pytest.MonkeyPatch()
    mp.setenv("TENSCALC_AUTO_FLEET", "1")
    yield
    mp.undo()


@pytest.fixture(scope="module", params=["float32", "float64"])
def sls_pair(request, auto_fleet):
    dt = request.param
    sj = jsls.build_constrained(ns=NS, dtype=dt)
    st = tsls.build_constrained(ns=NS, dtype=dt, device="cpu")
    return dt, sj, st


def _params(data):
    return {NS + "A": data["A"], NS + "b": data["b"]}


def test_sls_resolves_to_the_fleet_dense_backend(sls_pair):
    dt, sj, st = sls_pair
    assert sj.kkt_backend_resolved == st.kkt_backend_resolved == "fleet"
    assert sj._solve_raw._band_mode is None and st._solve_raw.band_mode is None
    assert (st.nU, st.nF, st.nG) == (32, 64, 0)
    assert tuple(sj._hoist) == st._hoist == (True, True, False)
    assert st.opts.skipAffine is False and st.opts.refine_for("fleet") == 1


def test_sls_single_solve_matches_jax(sls_pair):
    """bench.py's protocol: cold from default_data()['x0'], mu0 = 1,
    max_iter = 30, then warm from the optimum."""
    dt, sj, st = sls_pair
    d = jsls.default_data()
    np.testing.assert_array_equal(tsls.default_data()["A"], d["A"])
    cold_j = sj.solve(_params(d), init={NS + "x": d["x0"]}, mu0=1.0, max_iter=30)
    cold_t = st.solve(_params(d), init={NS + "x": d["x0"]}, mu0=1.0, max_iter=30)
    assert cold_j.status == 0 and cold_t.status == 0, cold_t.describe()
    assert abs(cold_t.iters - cold_j.iters) <= 1, (cold_t.iters, cold_j.iters)
    xj, xt = cold_j.variables[NS + "x"], cold_t.variables[NS + "x"]
    np.testing.assert_allclose(xt, xj, atol=X_ATOL[dt])
    np.testing.assert_allclose(cold_t.outputs["J"], cold_j.outputs["J"], rtol=1e-4)
    warm = st.solve(_params(d), init={NS + "x": xt}, mu0=1.0, max_iter=30)
    assert warm.status == 0
    np.testing.assert_allclose(warm.variables[NS + "x"], xj, atol=X_ATOL[dt])


def test_sls_fleet_matches_jax(sls_pair):
    """Eight instances, each with its own A and b (tsls.fleet_inputs),
    through the JAX fleet kernels in interpret mode and the port's plain
    K4/K5."""
    dt, sj, st = sls_pair
    f = tsls.fleet_inputs(8, seed=3)
    rj = sj.solve_many(_params(f), inits={NS + "x": f["x0"]}, mu0=1.0, max_iter=60)
    rt = result_to_numpy(
        st.solve_many(_params(f), inits={NS + "x": f["x0"]}, mu0=1.0, max_iter=60)
    )
    assert (np.asarray(rj.status) == 0).all() and (rt["status"] == 0).all()
    assert (np.abs(rt["iters"] - np.asarray(rj.iters)) <= 1).all()
    np.testing.assert_allclose(rt["u"], np.asarray(rj.u), atol=X_ATOL[dt])
    np.testing.assert_allclose(rt["f"], np.asarray(rj.f), rtol=1e-4)


def _lsq_problem(mod, ns, N, n, **opts):
    """tests/test_fleet.py:98-137's problem: min ||A x - b||^2 s.t.
    -0.5 <= x <= 0.5."""
    A = mod.variable(ns + "A", (N, n))
    b = mod.variable(ns + "b", (N,))
    x = mod.variable(ns + "x", (n,))
    if mod is jtc:
        J = jtc.norm2(A @ x - b)
    else:
        J = lift(lambda r: (r ** 2).sum())(A @ x - b)
    return mod.optimize(objective=J, optimizationVariables=[x],
                        constraints=[x >= -0.5, x <= 0.5], parameters=[A, b],
                        outputExpressions={"x": x}, dtype="float32", **opts)


def test_fleet_backend_problem_of_test_fleet(auto_fleet):
    N, n, B = 20, 6, 3
    rng = np.random.default_rng(0)
    Ab, bb, x0 = rng.standard_normal((B, N, n)), rng.standard_normal((B, N)), np.zeros((B, n))
    ns = "tfl_"
    sj = _lsq_problem(jtc, ns, N, n, variant="standard", smallerNewtonMatrix=True,
                      kkt_backend="fleet")
    st = _lsq_problem(ttc, ns, N, n, kkt_backend="fleet", device="cpu")
    assert st.kkt_backend_resolved == "fleet"
    p = {ns + "A": Ab, ns + "b": bb}
    rj = sj.solve_many(p, inits={ns + "x": x0}, mu0=1.0, max_iter=80)
    rt = result_to_numpy(st.solve_many(p, inits={ns + "x": x0}, mu0=1.0, max_iter=80))
    assert (np.asarray(rj.status) == 0).all() and (rt["status"] == 0).all()
    assert (np.abs(rt["iters"] - np.asarray(rj.iters)) <= 1).all()
    np.testing.assert_allclose(rt["u"], np.asarray(rj.u), atol=X_ATOL["float32"])


def test_unbanded_width_resolves_to_fleet(auto_fleet):
    """n = 80: nK = 80 >= 64, but the dense 80 x 80 KKT has no worthwhile
    band, so 'auto' takes the fleet dense backend on both sides."""
    ns = "tw_"
    sj = jsls.build_constrained(n=80, ns=ns, dtype="float32")
    st = tsls.build_constrained(n=80, ns=ns, dtype="float32", device="cpu")
    assert sj.kkt_backend_resolved == st.kkt_backend_resolved == "fleet"
    assert st.kkt_plan is None and st._solve_raw.band_mode is None
    f = tsls.fleet_inputs(2, n=80, seed=1)
    p = {ns + "A": f["A"], ns + "b": f["b"]}
    r = st.solve_many(p, inits={ns + "x": f["x0"]}, mu0=1.0, max_iter=60)
    assert (r.status == 0).all(), r.status
    one = st.solve({k: v[0] for k, v in p.items()}, init={ns + "x": f["x0"][0]},
                   mu0=1.0, max_iter=60)
    assert one.status == 0
    np.testing.assert_allclose(one.variables[ns + "x"], r.u[0].numpy(), atol=2e-3)


def _eq_problem(mod, ns, **opts):
    """min ||x - c||^2 + 0.1 x' x  s.t.  E x == e, x >= 0: two equality
    rows, so the nu initializer runs."""
    x = mod.variable(ns + "x", (6,))
    c = mod.variable(ns + "c", (6,))
    E = mod.variable(ns + "E", (2, 6))
    e = mod.variable(ns + "e", (2,))
    J = ((x - c) ** 2).sum() + 0.1 * (x ** 2).sum()
    return mod.optimize(objective=J, optimizationVariables=[x],
                        constraints=[E @ x == e, x >= 0.0], parameters=[c, E, e],
                        outputExpressions={"x": x}, dtype="float64", **opts)


@pytest.mark.parametrize("backend", ["fleet", "pallas"])
def test_equality_constraints_and_nu_init(backend, auto_fleet):
    """'fleet' initializes nu by CG on the normal equations, 'pallas' by
    the pivoted-LU solve (solver.py:821-870)."""
    ns = "teq_" + backend[0]
    sj = _eq_problem(jtc, ns, kkt_backend=backend, variant="standard",
                     smallerNewtonMatrix=True)
    st = _eq_problem(ttc, ns, kkt_backend=backend, device="cpu")
    assert st.kkt_backend_resolved == sj.kkt_backend_resolved == backend
    rng = np.random.default_rng(5)
    B = 3
    p = {ns + "c": rng.uniform(-1, 1, (B, 6)), ns + "E": rng.uniform(0.5, 1.5, (B, 2, 6)),
         ns + "e": rng.uniform(1, 2, (B, 2))}
    x0 = np.full((B, 6), 0.3)
    rj = sj.solve_many(p, inits={ns + "x": x0}, mu0=1.0, max_iter=60)
    rt = result_to_numpy(st.solve_many(p, inits={ns + "x": x0}, mu0=1.0, max_iter=60))
    assert (np.asarray(rj.status) == 0).all() and (rt["status"] == 0).all()
    assert (np.abs(rt["iters"] - np.asarray(rj.iters)) <= 1).all()
    np.testing.assert_allclose(rt["u"], np.asarray(rj.u), atol=1e-6)
    np.testing.assert_allclose(rt["nu"], np.asarray(rj.nu), atol=1e-5)
    one_j = sj.solve({k: v[0] for k, v in p.items()}, init={ns + "x": x0[0]}, mu0=1.0)
    one_t = st.solve({k: v[0] for k, v in p.items()}, init={ns + "x": x0[0]}, mu0=1.0)
    assert one_j.status == one_t.status == 0
    np.testing.assert_allclose(one_t.variables[ns + "x"], one_j.variables[ns + "x"],
                               atol=1e-6)


def test_lu_solve_mixed_matches_jax():
    rng = np.random.default_rng(6)
    W = rng.standard_normal((3, 9, 9))
    b = rng.standard_normal((3, 9))
    xt = tlu_solve_mixed(torch.from_numpy(W), torch.from_numpy(b)).numpy()
    for k in range(3):
        xj = np.asarray(jlu_solve_mixed(W[k], b[k]))
        np.testing.assert_allclose(xt[k], xj, rtol=1e-10, atol=1e-12)


def _quartic(mod, ns, **opts):
    """A Hessian that depends on the iterate: min sum(x^4) + ||x - c||^2
    s.t. 0 <= x <= 1."""
    x = mod.variable(ns + "x", (5,))
    c = mod.variable(ns + "c", (5,))
    J = (x ** 4).sum() + ((x - c) ** 2).sum()
    return mod.optimize(objective=J, optimizationVariables=[x],
                        constraints=[x >= 0.0, x <= 1.0], parameters=[c],
                        outputExpressions={"x": x}, **opts)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_hessian_not_hoisted(dtype, auto_fleet):
    ns = "tq_" + dtype[-2:]
    sj = _quartic(jtc, ns, dtype=dtype)
    st = _quartic(ttc, ns, dtype=dtype, device="cpu")
    assert not sj._hoist[0] and st._hoist == (False, True, False)
    assert st.kkt_backend_resolved == "fleet"
    c = np.array([[0.9, 0.2, -0.3, 1.4, 0.5], [0.1, 0.8, 0.6, -0.2, 1.1]])
    x0 = np.full((2, 5), 0.5)
    rj = sj.solve_many({ns + "c": c}, inits={ns + "x": x0}, mu0=1.0, max_iter=60)
    rt = result_to_numpy(st.solve_many({ns + "c": c}, inits={ns + "x": x0}, mu0=1.0,
                                       max_iter=60))
    assert (np.asarray(rj.status) == 0).all() and (rt["status"] == 0).all()
    assert (np.abs(rt["iters"] - np.asarray(rj.iters)) <= 1).all()
    np.testing.assert_allclose(rt["u"], np.asarray(rj.u), atol=X_ATOL[dtype])


@pytest.mark.parametrize("backend", ["dense", "ldl", "tridiag", "cyclic", "spike"])
def test_unported_backends_raise(backend):
    """Every backend is ported now and resolves as in the JAX package:
    'dense' and 'ldl' as named; this problem's KKT has fewer than 64 rows,
    so 'tridiag', 'cyclic' and 'spike' resolve to 'dense' (JAX
    api.py:348), 'spike' without asking for a mesh."""
    x = ttc.variable("tub_x", (3,))
    s = ttc.optimize((x ** 2).sum(), [x], constraints=[x >= 0], device="cpu",
                     kkt_backend=backend)
    jtc.expr.clear_variables()
    xj = jtc.variable("tub_x", (3,))
    sj = jtc.optimize((xj ** 2).sum(), [xj], constraints=[xj >= 0], kkt_backend=backend)
    assert s.kkt_backend_resolved == sj.kkt_backend_resolved
    assert s.kkt_backend_resolved == (backend if backend == "ldl" else "dense")
    assert s.kkt_plan is None and sj.kkt_plan is None
