"""The port's min-max solver on ``kkt_backend='dense'`` in float64 against
the JAX package's: tests/test_minmax.py's cases (examples/minmaxTest.m
1 to 5.5, robust least squares, solve_many against single solves), a
nonlinear game that hoists nothing, and the build-time errors.

Both sides factor with the same unpivoted dense LDL^T, whose factor and
solves the port repeats to the last bit on the CPU (tests/
test_torch_dense_kkt.py), so status, iterations and variables agree;
variables are held to 1e-6."""

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

ATOL = 1e-6
# the reference's oracle tolerance on these cases (tests/test_minmax.py)
ORACLE_ATOL = 1e-3


@pytest.fixture(autouse=True)
def _fresh_variables():
    ttc.clear_variables()
    jtc.expr.clear_variables()
    yield
    ttc.clear_variables()


def _sq(m, e):
    return m.norm2(e) if m is jtc else (e * e).sum()


def _case(m, name):
    """(problem kwargs, init) of tests/test_minmax.py's case ``name``."""
    u, d = m.variable(f"c{name}_u", ()), m.variable(f"c{name}_d", ())
    if name in ("2.5", "3.5", "5.5"):
        x = m.variable(f"c{name}_x", ())
    bounds_d = [d >= -1.0, d <= 1.0]
    kw = {
        "1": dict(objective=u ** 2 - 2 * d ** 2),
        "2": dict(objective=(u + d + 1) ** 2 - 2 * (d - 1) ** 2),
        "3": dict(objective=(u + d) ** 2 - 2 * (d + 2) ** 2, maxConstraints=bounds_d),
        "4": dict(objective=(u + d + 1) ** 2 - 2 * d ** 2,
                  minConstraints=[u >= -0.25, u <= 0.25]),
        "5": dict(objective=(u + d) ** 2 - 2 * (d + 2) ** 2,
                  minConstraints=[u >= -2.0, u <= 2.0], maxConstraints=bounds_d),
    }.get(name)
    maxv = [d]
    if kw is None:
        maxv = [d, x]
        kw = {
            "2.5": dict(objective=(x + 1) ** 2 - 2 * (d - 1) ** 2, maxConstraints=[x == u + d]),
            "3.5": dict(objective=x ** 2 - 2 * (d + 2) ** 2,
                        maxConstraints=bounds_d + [x == u + d]),
            "5.5": dict(objective=x ** 2 - 2 * (d + 2) ** 2,
                        minConstraints=[u >= -2.0, u <= 2.0],
                        maxConstraints=bounds_d + [x == u + d]),
        }[name]
    init = {"1": (1.0, -1.0), "3": (0.3, 0.0)}.get(name, (0.0, 0.0))
    if name in ("3.5", "5", "5.5"):
        init = (0.1, 0.1)
    inits = {f"c{name}_u": init[0], f"c{name}_d": init[1]}
    if len(maxv) == 2:
        inits[f"c{name}_x"] = init[1]
    return dict(minOptimizationVariables=[u], maxOptimizationVariables=maxv, **kw), inits


# the saddle points of tests/test_minmax.py (case 4: the inner maximum
# d = u + 1 leaves 2 (u + 1)^2, least at the bound u = -0.25)
ORACLE = {"1": {"u": 0.0, "d": 0.0}, "2": {"u": -2.0, "d": 1.0},
          "2.5": {"u": -2.0, "d": 1.0, "x": -1.0}, "3": {"u": 1.0, "d": -1.0},
          "4": {"u": -0.25, "d": 0.75}, "3.5": {"u": 1.0, "d": -1.0, "x": 0.0},
          "5": {"u": 1.0, "d": -1.0}, "5.5": {"u": 1.0, "d": -1.0, "x": 0.0}}


def _solve_both(name, **opts):
    kj, init = _case(jtc, name)
    kt, _ = _case(ttc, name)
    sj = jtc.minmax(**kj, kkt_backend="dense", **opts)
    st = ttc.minmax(**kt, kkt_backend="dense", device="cpu", **opts)
    assert st.kkt_backend_resolved == sj.kkt_backend_resolved == "dense"
    return (sj.solve({}, init=init, mu0=1.0, max_iter=200),
            st.solve({}, init=init, mu0=1.0, max_iter=200))


@pytest.mark.parametrize("name", ["1", "2", "2.5", "3", "4", "3.5", "5"])
def test_minmax_case_matches_jax(name):
    sol_j, sol_t = _solve_both(name)
    assert sol_t.status == sol_j.status == 0, sol_t.describe()
    assert sol_t.iters == sol_j.iters
    for k, v in sol_j.variables.items():
        np.testing.assert_allclose(sol_t.variables[k], v, atol=ATOL, err_msg=k)
        np.testing.assert_allclose(sol_t.variables[k], ORACLE[name][k.split("_")[-1]],
                                   atol=ORACLE_ATOL, err_msg=k)
    np.testing.assert_allclose(sol_t.objective, sol_j.objective, atol=ATOL)


def test_case5p5_iterations_follow_rounding():
    """Case 5.5 (the reference's shipping configuration): u's Hessian is
    zero, so its pivot is addU (~1e-10) and the unpivoted factor grows by
    ~1e9; the direction error then sits at the 1e-7 gate by rounding
    alone.  The JAX package itself takes 10 iterations from the test's
    init and 72 from an init moved by 1e-14.  The port's factor and
    solves are XLA's to the last bit, but its gradient of the Lagrangian
    is not (XLA sums and contracts in its own order): from the second
    iterate on it takes another path (75 iterations) to the same saddle
    point.  Held: status 0 on both sides, both at the oracle, and the JAX
    package's own spread."""
    sol_j, sol_t = _solve_both("5.5")
    assert sol_t.status == sol_j.status == 0, sol_t.describe()
    for k, v in sol_j.variables.items():
        key = k.split("_")[-1]
        np.testing.assert_allclose(v, ORACLE["5.5"][key], atol=ORACLE_ATOL)
        np.testing.assert_allclose(sol_t.variables[k], ORACLE["5.5"][key], atol=ORACLE_ATOL)
    kj, init = _case(jtc, "5.5")
    sj = jtc.minmax(**kj, kkt_backend="dense")
    moved = sj.solve({}, init={**init, "c5.5_u": init["c5.5_u"] + 1e-14}, mu0=1.0,
                     max_iter=200)
    assert moved.status == 0 and moved.iters != sol_j.iters


def _robust_ls(m, **kw):
    N, n = 12, 3
    Av, bv = m.variable("mm7_A", (N, n)), m.variable("mm7_b", (N,))
    x, delta = m.variable("mm7_x", (n,)), m.variable("mm7_delta", (N,))
    J = _sq(m, Av @ x - bv + delta) - 50.0 * _sq(m, delta)
    return m.minmax(objective=J, minOptimizationVariables=[x],
                    maxOptimizationVariables=[delta], parameters=[Av, bv],
                    kkt_backend="dense", **kw)


def test_robust_least_squares_matches_jax():
    rng = np.random.default_rng(0)
    A, b = rng.standard_normal((12, 3)), rng.standard_normal(12)
    params = {"mm7_A": A, "mm7_b": b}
    init = {"mm7_x": np.zeros(3), "mm7_delta": np.zeros(12)}
    sol_j = _robust_ls(jtc).solve(params, init=init)
    sol_t = _robust_ls(ttc, device="cpu").solve(params, init=init)
    assert sol_t.status == sol_j.status == 0 and sol_t.iters == sol_j.iters
    for k in ("mm7_x", "mm7_delta"):
        np.testing.assert_allclose(sol_t.variables[k], sol_j.variables[k], atol=ATOL)
    xs, ds = sol_t.variables["mm7_x"], sol_t.variables["mm7_delta"]
    r = A @ xs - b + ds
    np.testing.assert_allclose(2 * A.T @ r, 0, atol=ORACLE_ATOL)
    np.testing.assert_allclose(2 * r - 100.0 * ds, 0, atol=ORACLE_ATOL)


def _batched(m, **kw):
    u, d, a = m.variable("mmb_u", ()), m.variable("mmb_d", ()), m.variable("mmb_a", ())
    return m.minmax(objective=(u + d + a) ** 2 - 2 * (d - 1) ** 2,
                    minOptimizationVariables=[u], maxOptimizationVariables=[d],
                    parameters=[a], kkt_backend="dense", **kw)


def test_solve_many_matches_jax_and_single():
    B = 4
    avals = np.linspace(0.5, 2.0, B)
    inits = {"mmb_u": np.zeros(B), "mmb_d": np.zeros(B)}
    res_j = _batched(jtc).solve_many({"mmb_a": avals}, inits=inits)
    st = _batched(ttc, device="cpu")
    res_t = st.solve_many({"mmb_a": avals}, inits=inits)
    assert (res_t.status.numpy() == 0).all() and (np.asarray(res_j.status) == 0).all()
    np.testing.assert_array_equal(res_t.iters.numpy(), np.asarray(res_j.iters))
    np.testing.assert_allclose(res_t.u.numpy(), np.asarray(res_j.u), atol=ATOL)
    # the quirk kept from the JAX package: the result's addEq is addD
    np.testing.assert_array_equal(res_t.addEq.numpy(), np.asarray(res_j.addEq))
    for b in range(B):
        single = st.solve({"mmb_a": avals[b]}, init={"mmb_u": 0.0, "mmb_d": 0.0})
        assert single.status == 0 and single.iters == res_t.iters[b]
        np.testing.assert_allclose(
            [single.variables["mmb_u"], single.variables["mmb_d"]], res_t.u[b].numpy(),
            atol=ATOL,
        )
    # the three regularizations (addU, addD, addEq) reach the solver
    again = ttc.solve_batched(st, {"mmb_a": avals}, inits=inits,
                              addEye2Hessian=(1e-9, 1e-9, 1e-9))
    np.testing.assert_array_equal(again.u.numpy(), res_t.u.numpy())


def _nonlinear(m, **kw):
    u, d, a = m.variable("nl_u", ()), m.variable("nl_d", ()), m.parameter("nl_a", ())
    return m.minmax(objective=(u - a) ** 4 + u * d - d ** 2 - 0.1 * d ** 4,
                    minOptimizationVariables=[u], maxOptimizationVariables=[d],
                    minConstraints=[u * u <= 4.0], maxConstraints=[d >= -1.0, d <= 1.0],
                    parameters=[a], kkt_backend="dense", **kw)


@pytest.mark.parametrize("a", [0.5, 3.0])
def test_nonlinear_game_matches_jax(a):
    """Nothing hoisted: the Hessian, the constraint Jacobians and the
    exact-F line search evaluated at every iterate (u on its bound at
    a = 3)."""
    sj, st = _nonlinear(jtc), _nonlinear(ttc, device="cpu")
    assert not any(st.certificates[k] for k in ("hoist_H", "hoist_Fz", "band_ok"))
    init = {"nl_u": 0.3, "nl_d": 0.1}
    sol_j = sj.solve({"nl_a": a}, init=init)
    sol_t = st.solve({"nl_a": a}, init=init)
    assert sol_t.status == sol_j.status == 0 and sol_t.iters == sol_j.iters
    for k, v in sol_j.variables.items():
        np.testing.assert_allclose(sol_t.variables[k], v, atol=ATOL)


def test_min_constraints_cannot_depend_on_max_vars():
    u, d = ttc.variable("mm6_u", ()), ttc.variable("mm6_d", ())
    with pytest.raises(ValueError, match="maximizer"):
        ttc.minmax(objective=u ** 2 - d ** 2, minOptimizationVariables=[u],
                   maxOptimizationVariables=[d], minConstraints=[u + d >= 0],
                   device="cpu")


def test_skip_affine_false_raises():
    u, d = ttc.variable("mm8_u", ()), ttc.variable("mm8_d", ())
    with pytest.raises(ValueError, match="skipAffine=True"):
        ttc.minmax(objective=u ** 2 - d ** 2, minOptimizationVariables=[u],
                   maxOptimizationVariables=[d], skipAffine=False, device="cpu")


def test_deferred_backend_raises():
    """'tridiag' is ported now: a game whose KKT has fewer than 64 rows
    resolves to 'dense', as in the JAX package (its kkt/select.py:78-82)."""
    u, d = ttc.variable("mm9_u", ()), ttc.variable("mm9_d", ())
    st = ttc.minmax(objective=u ** 2 - d ** 2, minOptimizationVariables=[u],
                    maxOptimizationVariables=[d], kkt_backend="tridiag", device="cpu")
    jtc.expr.clear_variables()
    uj, dj = jtc.variable("mm9_u", ()), jtc.variable("mm9_d", ())
    sj = jtc.minmax(objective=uj ** 2 - dj ** 2, minOptimizationVariables=[uj],
                    maxOptimizationVariables=[dj], kkt_backend="tridiag")
    assert st.kkt_backend_resolved == sj.kkt_backend_resolved == "dense"
    assert st.kkt_plan is None


def test_minmax_without_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is valid")
    u, d = ttc.variable("mm10_u", ()), ttc.variable("mm10_d", ())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttc.minmax(objective=u ** 2 - d ** 2, minOptimizationVariables=[u],
                   maxOptimizationVariables=[d])
