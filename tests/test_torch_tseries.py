"""The port's time-series calculus (``ops/tseries.py``) held against the
JAX package's on tests/test_tseries.py's 10 cases, in float64 (the same
inputs through ``tenscalc_tpu.ops.tseries`` and the port, and the
cases' own oracles), with the scalar and the vector ``ts`` forms, the
other ODE methods and the quaternion products' mixed forms."""

import numpy as np
import pytest
import torch

import tenscalc_tpu as jtc
import tenscalc_tpu_torch as ttc
from tenscalc_tpu import expr as jexpr
from tenscalc_tpu.ops import tseries as jts
from tenscalc_tpu_torch import expr as texpr
from tenscalc_tpu_torch.ops import tseries as tts

torch.set_num_threads(1)

TOL = 1e-12


@pytest.fixture(autouse=True)
def _fresh_variables():
    jexpr.clear_variables()
    texpr.clear_variables()
    yield
    jexpr.clear_variables()
    texpr.clear_variables()


def T(a):
    return torch.as_tensor(np.asarray(a, dtype=np.float64))


def same(name, *args, tol=TOL, **kw):
    """tseries.<name> of the JAX package on numpy inputs and of the port
    on the same tensors (numbers passed as they are): equal within
    ``tol``; returns the port's."""
    jv = np.asarray(getattr(jts, name)(*args, **kw))
    tv = getattr(tts, name)(*[T(a) if isinstance(a, np.ndarray) else a for a in args],
                            **kw).numpy()
    assert jv.shape == tv.shape, name
    np.testing.assert_allclose(tv, jv, rtol=tol, atol=tol, err_msg=name)
    return tv


def test_integral_scalar_ts():
    ts = np.pi / 10
    t = np.arange(0, np.pi + 1e-9, ts)
    np.testing.assert_allclose(same("tsIntegral", np.sin(t)[None, :], ts), [2.0], atol=2e-2)


def test_integral_vector_ts():
    t = np.linspace(0, np.pi, 41)
    np.testing.assert_allclose(same("tsIntegral", np.sin(t)[None, :], t), [2.0], atol=2e-3)


def test_derivative_scalar_ts():
    h = 0.01
    t = np.arange(0, 1, h)
    dx = same("tsDerivative", np.vstack([np.sin(t), np.cos(t)]), h, tol=1e-10)
    np.testing.assert_allclose(dx[0], np.cos(t), atol=1e-3)
    np.testing.assert_allclose(dx[1], -np.sin(t), atol=1e-3)


def test_derivative_vector_ts():
    t = np.sort(np.random.default_rng(0).uniform(0, 1, 60))
    dx = same("tsDerivative", (t ** 2)[None, :], t, tol=1e-9)
    np.testing.assert_allclose(dx[0], 2 * t, atol=1e-8)  # exact for quadratics


def test_derivative2():
    h = 0.01
    t = np.arange(0, 1, h)
    ddx = same("tsDerivative2", (t ** 3)[None, :], h, tol=1e-8)
    np.testing.assert_allclose(ddx[0][1:-1], 6 * t[1:-1], atol=1e-6)
    tv = np.sort(np.random.default_rng(5).uniform(0, 1, 30))
    ddv = same("tsDerivative2", (tv ** 2)[None, :] * np.array([[1.0], [3.0]]), tv, tol=1e-7)
    np.testing.assert_allclose(ddv, np.array([[2.0], [6.0]]) * np.ones((2, 30)), rtol=1e-7)


def test_integrate_euler_and_trapezoidal():
    h = 0.001
    t = np.arange(0, 1, h)
    ix = same("tsIntegrate", np.ones((1, t.size)), np.zeros(1), h, method="euler")
    np.testing.assert_allclose(ix[0], t, atol=1e-9)
    x = np.vstack([t, t ** 2])
    for method in ("euler", "trapezoidal"):
        same("tsIntegrate", x, np.array([1.0, -1.0]), h, method=method, tol=1e-11)
        same("tsIntegrate", x, np.array([1.0, -1.0]), t, method=method, tol=1e-11)
    with pytest.raises(ValueError, match="unknown method"):
        tts.tsIntegrate(T(x), T([0.0, 0.0]), h, method="simpson")


def _ode_pair(method, ts, fun_j, fun_t, T_=5):
    xj = jtc.variable("ode_x", (2, T_))
    xt = ttc.variable("ode_x", (2, T_))
    uj = jtc.variable("ode_u", (1, T_))
    ut = ttc.variable("ode_u", (1, T_))
    return (jts.tsODE(xj, uj, None, ts, fun_j, method),
            tts.tsODE(xt, ut, None, T(ts) if isinstance(ts, np.ndarray) else ts, fun_t,
                      method))


def test_ode_forward_euler_constraint():
    T_, h = 5, 0.1
    x = ttc.variable("x", (1, T_))
    con = tts.tsODE(x, None, None, h, lambda xs, u, d, t: xs, "forwardEuler")
    assert con.kind == "eq"
    xv = (1 + h) ** np.arange(T_)[None, :]
    np.testing.assert_allclose(con.expr({"x": T(xv)}).numpy(), 0, atol=1e-12)


@pytest.mark.parametrize("method", ["forwardEuler", "backwardEuler", "midPoint"])
@pytest.mark.parametrize("vector_ts", [False, True])
def test_ode_methods_against_jax(method, vector_ts):
    """dot x = A x + B u (+ t, where the times match the steps: the
    midpoint rule hands fun N - 1 times beside N samples, as the JAX
    package does), each method, scalar and vector ts."""
    rng = np.random.default_rng(7)
    A = np.array([[0.0, 1.0], [-2.0, -0.3]])
    ts = np.cumsum(np.full(5, 0.1) + 0.02 * rng.random(5)) if vector_ts else 0.1

    def fun(m):
        def f(xs, u, d, t):
            rhs = m.tprod(m.constant(A), [1, -1], xs, [-1, 2]) + u * 2.0
            return rhs if method == "midPoint" else rhs + t * 0.5
        return f

    cj, ct = _ode_pair(method, ts, fun(jtc), fun(ttc))
    assert cj.kind == ct.kind == "eq" and cj.expr.shape == ct.expr.shape
    env = {"ode_x": rng.standard_normal((2, 5)), "ode_u": rng.standard_normal((1, 5))}
    jv = np.asarray(cj.expr(env))
    tv = ct.expr({k: T(v) for k, v in env.items()}).numpy()
    np.testing.assert_allclose(tv, jv, rtol=TOL, atol=TOL)
    with pytest.raises(ValueError, match="not implemented"):
        tts.tsODE(ttc.variable("ode_x", (2, 5)), None, None, 0.1, lambda *a: a[0], "rk4")


def test_cross_dot():
    r = np.random.default_rng(1)
    a, b = r.standard_normal((3, 7)), r.standard_normal((3, 7))
    np.testing.assert_allclose(same("tsCross", a, b), np.cross(a, b, axis=0), rtol=TOL)
    np.testing.assert_allclose(same("tsDot", a, b), (a * b).sum(0), rtol=TOL)


def _quat_mult(q, p):
    w = q[0] * p[0] - q[1:] @ p[1:]
    v = q[0] * p[1:] + p[0] * q[1:] + np.cross(q[1:], p[1:])
    return np.concatenate([[w], v])


def test_qdot():
    r = np.random.default_rng(2)
    q1, q2 = r.standard_normal((4, 5)), r.standard_normal((4, 5))
    out = same("tsQdot", q1, q2)
    for k in range(5):
        np.testing.assert_allclose(out[:, k], _quat_mult(q1[:, k], q2[:, k]), rtol=1e-10)
    p = r.standard_normal((3, 5))
    same("tsQdot", q1, p)
    same("tsQdot", p, q2)
    same("tsQdotStar", q1, q2)
    with pytest.raises(ValueError, match="3- or 4-vectors"):
        tts.tsQdot(T(p), T(p))


def test_rotation_roundtrip():
    r = np.random.default_rng(3)
    q = r.standard_normal((4, 6))
    q /= np.linalg.norm(q, axis=0, keepdims=True)
    x = r.standard_normal((3, 6))
    y = same("tsRotation", q, x)
    back = same("tsRotationT", q, y)
    np.testing.assert_allclose(back, x, atol=1e-10)
    np.testing.assert_allclose(np.linalg.norm(y, axis=0), np.linalg.norm(x, axis=0),
                               rtol=1e-10)


def test_on_expressions_with_a_scalar_and_a_vector_ts():
    """Lifted through Expr, with ts a number, a scalar parameter, or a
    vector parameter; and differentiated."""
    rng = np.random.default_rng(9)
    xv, tv = rng.standard_normal((2, 6)), np.sort(rng.random(6))
    for m, mt in ((jtc, jts), (ttc, tts)):
        x, h, t = m.variable("tx", (2, 6)), m.variable("th", ()), m.variable("tt", (6,))
        exprs = [mt.tsDerivative(x, h), mt.tsDerivative(x, t), mt.tsDerivative2(x, 0.2),
                 mt.tsDerivative2(x, t), mt.tsIntegral(x, h), mt.tsIntegrate(x, x[:, 0], t),
                 m.gradient(m.norm2(mt.tsDerivative(x, h)), x)]
        env = {"tx": xv, "th": np.array(0.3), "tt": tv}
        if m is ttc:
            got = [e({k: T(v) for k, v in env.items()}).numpy() for e in exprs]
        else:
            want = [np.asarray(e(env)) for e in exprs]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-10, atol=1e-10)
