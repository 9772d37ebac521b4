"""A Python number in a float32 expression, against the JAX package.

JAX types a Python number weakly: beside a float32 array it is float32.
The port gives it the dtype and device of the tensor beside it
(``expr.binary_op``).  Kept as a number, PyTorch's forward-mode AD gives
a 0-dim float32 tensor minus, times or over it a float64 tangent, so the
Hessian of ``(x[0] - 1.0)**2`` came out float64 and the float32 factor
failed on it.  Each problem here is float32, built and solved on both
sides on the CPU (``TENSCALC_AUTO_FLEET=1``, so the JAX package's
``'auto'`` takes the fleet backends as the port's does), and held to
status 0, iterations within one and the variables within 2e-3, the
reference's float32 cross-backend tolerance."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import tenscalc_tpu as jtc  # noqa: E402
import tenscalc_tpu_torch as ttc  # noqa: E402
from tenscalc_tpu_torch.ipm.hoist import DerivativeDtypeError  # noqa: E402

torch.set_num_threads(1)

X_ATOL = 2e-3


@pytest.fixture(autouse=True)
def _fresh_variables(monkeypatch):
    monkeypatch.setenv("TENSCALC_AUTO_FLEET", "1")
    ttc.clear_variables()
    jtc.expr.clear_variables()
    yield
    ttc.clear_variables()


def _on_cpu(m, kw):
    return {**kw, "device": "cpu"} if m is ttc else kw


def _hold(sol_t, sol_j):
    assert sol_t.status == 0 and sol_j.status == 0, (sol_t.describe(), sol_j.describe())
    assert abs(sol_t.iters - sol_j.iters) <= 1, (sol_t.iters, sol_j.iters)
    for k, v in sol_j.variables.items():
        np.testing.assert_allclose(sol_t.variables[k], np.asarray(v), rtol=0,
                                   atol=X_ATOL, err_msg=k)


def _both(build):
    sol_j = build(jtc)
    ttc.clear_variables()
    return build(ttc), sol_j


@pytest.mark.parametrize("backend", ["fleet", "dense"])
def test_scalar_term_in_the_objective(backend):
    """min (x[0] - 1)^2 + ||x||^2 s.t. x >= -1: the JAX package takes 7
    iterations to x = (0.5, ~0, ~0, ~0)."""
    def build(m):
        x = m.variable("ws1_x", (4,))
        s = m.optimize((x[0] - 1.0) ** 2 + m.norm2(x), [x], [x >= -1.0],
                       **_on_cpu(m, dict(kkt_backend=backend, dtype="float32")))
        return s.solve(init={"ws1_x": np.full(4, 0.1)})

    sol_t, sol_j = _both(build)
    _hold(sol_t, sol_j)
    np.testing.assert_allclose(sol_t.variables["ws1_x"], [0.5, 0, 0, 0], atol=X_ATOL)


@pytest.mark.parametrize("op", ["sub", "rsub", "mul", "div", "rdiv", "add"])
def test_hessian_keeps_float32(op):
    """Each operator of a 0-dim expression and a Python number leaves the
    port's Hessian in the problem's dtype, and the solve agrees with JAX."""
    ops = {"sub": lambda e: e - 1.0, "rsub": lambda e: 1.0 - e,
           "mul": lambda e: e * 3.0, "div": lambda e: e / 2.0,
           "rdiv": lambda e: 2.0 / (e + 3.0), "add": lambda e: e + 1.0}

    def build(m):
        x = m.variable("ws2_x", (3,))
        s = m.optimize(ops[op](x[1]) ** 2 + m.norm2(x), [x], [x >= -1.0],
                       **_on_cpu(m, dict(kkt_backend="auto", dtype="float32")))
        return s.solve(init={"ws2_x": np.full(3, 0.2)})

    sol_t, sol_j = _both(build)
    _hold(sol_t, sol_j)


def test_scalar_equality_float32():
    """An equality-constrained QP whose constraint ``x.sum() == 1.0`` is
    a 0-dim expression minus a number (tests/test_optimize.py's
    variants): every derivative hoisted, and the JAX package's answer."""
    n = 5
    rng = np.random.default_rng(0)
    Q = rng.standard_normal((n, n))
    Q = Q @ Q.T + n * np.eye(n)
    c = rng.standard_normal(n)

    def build(m):
        Qv, cv, x = m.variable("ws3_Q", (n, n)), m.variable("ws3_c", (n,)), m.variable("ws3_x", (n,))
        J = 0.5 * m.tprod(x, [-1], Qv @ x, [-1]) + m.tprod(cv, [-1], x, [-1])
        s = m.optimize(objective=J, optimizationVariables=[x],
                       constraints=[x >= -10.0, x <= 10.0, x.sum() == 1.0],
                       parameters=[Qv, cv],
                       **_on_cpu(m, dict(kkt_backend="auto", dtype="float32")))
        if m is ttc:
            assert s._hoist == (True, True, True)
        return s.solve({"ws3_Q": Q, "ws3_c": c}, init={"ws3_x": np.ones(n) / n})

    sol_t, sol_j = _both(build)
    _hold(sol_t, sol_j)
    assert abs(float(np.sum(sol_t.variables["ws3_x"])) - 1.0) <= 1e-4


@pytest.mark.parametrize("backend", ["auto", "dense"])
def test_minmax_scalar_constraint_float32(backend):
    """tests/test_minmax.py's case 4 in float32: min over u in [-0.25,
    0.25] of max over d of (u + d + 1)^2 - 2 d^2, saddle (-0.25, 0.75)."""
    def build(m):
        u, d = m.variable("ws4_u", ()), m.variable("ws4_d", ())
        s = m.minmax(**_on_cpu(m, dict(
            objective=(u + d + 1) ** 2 - 2 * d ** 2, minOptimizationVariables=[u],
            maxOptimizationVariables=[d], minConstraints=[u >= -0.25, u <= 0.25],
            kkt_backend=backend, dtype="float32")))
        return s.solve({}, init={"ws4_u": 0.0, "ws4_d": 0.0}, mu0=1.0, max_iter=200)

    sol_t, sol_j = _both(build)
    _hold(sol_t, sol_j)
    np.testing.assert_allclose(sol_t.variables["ws4_u"], -0.25, atol=X_ATOL)
    np.testing.assert_allclose(sol_t.variables["ws4_d"], 0.75, atol=X_ATOL)


def test_game_scalar_constraint_float32():
    """A Nash game of two chains (n = 40 each, the KKT banded, so the
    port's fleet banded LU takes it) with a scalar constraint scaled by
    a number, ``2.0 * u[0] >= -0.5``, beside test_equilibrium.py's boxes."""
    n = 40

    def build(m):
        u, d = m.variable("ws5_u", (n,)), m.variable("ws5_d", (n,))
        s = m.equilibrium(**_on_cpu(m, dict(
            P1objective=m.norm2(u - 2 * d) + m.norm2(u[1:] - u[:-1]),
            P2objective=m.norm2(d - 0.5) + m.norm2(d[1:] - d[:-1]),
            P1optimizationVariables=[u], P2optimizationVariables=[d],
            P1constraints=[u >= -1.0, u <= 1.0, 2.0 * u[0] >= -0.5, u[0] <= 0.25],
            P2constraints=[d >= -2.0, d <= 2.0], dtype="float32")))
        if m is ttc:
            assert s.kkt_backend_resolved == "fleet_banded_lu"
        return s.solve({}, init={"ws5_u": np.zeros(n), "ws5_d": np.zeros(n)})

    sol_t, sol_j = _both(build)
    _hold(sol_t, sol_j)
    np.testing.assert_allclose(sol_t.variables["ws5_u"][0], 0.25, atol=X_ATOL)


def test_mixed_dtype_raises_at_build():
    """A lifted function passes a number through as it is, so its
    Hessian can still come out float64: the build names it."""
    x = ttc.variable("ws6_x", (4,))
    J = ttc.lift(torch.mul)(x[0], 3.0) ** 2 + ttc.norm2(x)
    with pytest.raises(DerivativeDtypeError, match="Hessian of the Lagrangian"):
        ttc.optimize(J, [x], [x >= -1.0], dtype="float32", device="cpu")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_weak_scalar_costs_no_operator(dtype):
    """A float operand becomes a 0-dim tensor of each float dtype when the
    expression is built: evaluating it dispatches only the expression's
    own operators, none that makes or fills a scalar, and keeps the
    environment's dtype."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.names = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.names.append(func.overloadpacket.__name__)
            return func(*args, **(kwargs or {}))

    x = ttc.variable("ws7_x", (3,))
    e = 2.0 / (x[0] - 1.5) * 3.0 + 0.5
    xv = np.array([0.1, 0.2, 0.3])
    env = {"ws7_x": torch.tensor(xv, dtype=dtype)}
    with Ops() as ops:
        out = e(env)
    assert out.dtype == dtype
    assert sorted(ops.names) == sorted(["select", "sub", "div", "mul", "add"]), ops.names
    np.testing.assert_allclose(float(out), 2.0 / (xv[0] - 1.5) * 3.0 + 0.5, rtol=1e-6)
