"""The Mpc app (``apps/mpc.py``), the LTI-MPC builders (``apps/lti.py``)
and ``examples/mpc_lti`` on the port against the JAX package in float64
with ``TENSCALC_AUTO_FLEET=1``: tests/test_apps.py:52 and :78 and
tests/test_lti.py:11, :43 and :87, each run on both sides from the same
numpy inputs: statuses and iterations equal, states and controls to
1e-8, except in the closed loops, where a control pinned against its
bound (u = -0.99999..) is set by the last bits of the final barrier
parameter: there they agree to 3.2e-6 (measured), held to 1e-5, and
the objectives to 1e-8 relative."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import tenscalc_tpu as jtc  # noqa: E402
from examples import mpc_lti as jlti_ex  # noqa: E402
from tenscalc_tpu.apps import lti as jlti  # noqa: E402
import tenscalc_tpu_torch as ttc  # noqa: E402
from tenscalc_tpu_torch.apps import lti as tlti  # noqa: E402
from tenscalc_tpu_torch.examples import mpc_lti as tlti_ex  # noqa: E402

torch.set_num_threads(1)

ATOL = 1e-8
LOOP_ATOL = 1e-5  # the closed loops' controls at their bounds (see above)


@pytest.fixture(autouse=True)
def _fresh_variables(monkeypatch):
    monkeypatch.setenv("TENSCALC_AUTO_FLEET", "1")
    ttc.clear_variables()
    jtc.expr.clear_variables()
    yield
    ttc.clear_variables()


def _dcmotor_mpc(tc, T=15, ns="app1_", **kw):
    """tests/test_apps.py::_build_dcmotor_mpc through package ``tc``; its
    state derivative works on that package's Exprs and on numpy."""
    nX, nU = 2, 1
    x = tc.variable(ns + "x", (nX, T))
    u = tc.variable(ns + "u", (nU, T))
    ref = tc.variable(ns + "ref", (1, T))
    p = tc.variable(ns + "p", ())
    k = tc.variable(ns + "k", ())

    def f(xs, us, ref_, p_, k_):
        x2 = xs[1:2, :]
        if isinstance(xs, tc.Expr) or isinstance(us, tc.Expr):
            return tc.expr.concat([x2, p_ * x2 + k_ * us], axis=0)
        return np.concatenate([x2, np.asarray(p_) * x2 + np.asarray(k_) * us], axis=0)

    Ts = 0.1
    J = tc.tsIntegral(((x[0:1, :] - ref) ** 2).sum(axis=0), Ts) + (1 / 50.0) * tc.tsIntegral(
        (u**2).sum(axis=0), Ts)
    mpc = tc.Mpc(
        objective=J, control_variable=u, state_variable=x, state_derivative=f,
        sample_time=Ts, parameters=[ref, p, k],
        constraints=[u >= -1.0, u <= 1.0, x >= -0.45, x <= 0.45],
        output_expressions={"J": J}, **kw,
    )
    return mpc, T, Ts


def _closed_loop(mpc, T, Ts, steps=15):
    mpc.set_parameter("app1_p", -2.0)
    mpc.set_parameter("app1_k", 1.0)
    mpc.set_initial_state(0.0, [0.2, 0.1])
    u_warm = 0.01 * np.random.default_rng(0).random((1, T))
    t, sols = 0.0, []
    for _ in range(steps):
        mpc.set_parameter(
            "app1_ref", -0.3 * np.sign(np.sin(0.5 * (t + np.arange(T) * Ts)))[None, :])
        state = mpc.set_solver_warm_start(u_warm)
        mpc.set_solver_state_start(np.clip(state[:, 1:], -0.42, 0.42))
        sol = mpc.solve(mu0=1e-3, max_iter=100)
        sols.append(sol)
        t, u_warm, _ = mpc.apply_controls(sol)
    return sols, mpc.get_history()


def test_mpc_closed_loop_matches_jax():
    """tests/test_apps.py:52: 15 steps, RK23 plant, states in the box."""
    mt, T, Ts = _dcmotor_mpc(ttc, device="cpu")
    assert mt.solver.kkt_backend_resolved == "fleet_banded"
    assert mt.solver.device.type == "cpu"
    st, ht = _closed_loop(mt, T, Ts)
    mj, _, _ = _dcmotor_mpc(jtc)
    assert mj.solver.kkt_backend_resolved == "fleet_banded"
    sj, hj = _closed_loop(mj, T, Ts)
    assert (ht["status"] == 0).all() and ht["x"].shape == (2, 16)
    assert (np.abs(ht["x"]) <= 0.47).all() and (np.abs(ht["u"]) <= 1 + 1e-6).all()
    np.testing.assert_array_equal(ht["status"], hj["status"])
    np.testing.assert_array_equal(ht["iter"], hj["iter"])
    for a, b in zip(st, sj):
        assert isinstance(a.control, np.ndarray) and a.control.shape == (1, T)
        np.testing.assert_allclose(a.control, b.control, rtol=0, atol=LOOP_ATOL)
        np.testing.assert_allclose(a.state, b.state, rtol=0, atol=LOOP_ATOL)
        np.testing.assert_allclose(a.objective, b.objective, rtol=1e-8)
        np.testing.assert_allclose(a.outputs["J"], b.outputs["J"], rtol=1e-8)
    np.testing.assert_allclose(ht["x"], hj["x"], rtol=0, atol=LOOP_ATOL)
    np.testing.assert_allclose(ht["t"], hj["t"], rtol=0, atol=1e-12)


def test_mpc_control_delay_matches_jax():
    """tests/test_apps.py:78: the first control a parameter."""
    T = 8
    out = []
    for tc, kw in ((ttc, {"device": "cpu"}), (jtc, {})):
        ns = "app2_"
        x = tc.variable(ns + "x", (1, T))
        u = tc.variable(ns + "u", (1, T))
        mpc = tc.Mpc(
            objective=tc.norm2(x) + 0.1 * tc.norm2(u), control_variable=u,
            state_variable=x, state_derivative=lambda xs, us: -xs + us,
            sample_time=0.1, constraints=[u >= -2.0, u <= 2.0], control_delay=1, **kw,
        )
        assert mpc.delayed_control_name == "app2_u_delayed"
        mpc.set_initial_state(0.0, [1.0], uinit=np.zeros((1, 1)))
        mpc.set_solver_warm_start(np.zeros((1, T - 1)))
        out.append(mpc.solve(mu0=1e-2, max_iter=100))
    a, b = out
    assert a.status == b.status == 0 and a.iter == b.iter
    assert a.control.shape == (1, T - 1)  # only the optimized controls
    np.testing.assert_allclose(a.control, b.control, rtol=0, atol=ATOL)
    np.testing.assert_allclose(a.state, b.state, rtol=0, atol=ATOL)


def test_mpc_device_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is CUDA")
    x = ttc.variable("dv_x", (1, 4))
    u = ttc.variable("dv_u", (1, 4))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttc.Mpc(objective=ttc.norm2(x), control_variable=u, state_variable=x,
                state_derivative=lambda xs, us: us, sample_time=0.1)


def test_lti_constraints_match_jax():
    """tests/test_lti.py:11 on both sides: the residual is zero on a
    simulated trajectory, and the outputs agree."""
    nx, nu, Tu = 2, 1, 5
    A = np.array([[1.0, 0.1], [0.0, 0.9]])
    B = np.array([[0.0], [0.1]])
    C = np.array([[1.0, 0.0]])
    D = np.zeros((1, 1))
    rng = np.random.default_rng(0)
    x0v, uv = rng.random((nx, 1)), rng.random((nu, Tu))
    xs = np.zeros((nx, Tu))
    xc = x0v[:, 0]
    for t in range(Tu):
        xc = A @ xc + B @ uv[:, t]
        xs[:, t] = xc
    env_np = {"lt_x": xs, "lt_u": uv, "lt_x0": x0v}
    outs = []
    for tc, lti in ((ttc, tlti), (jtc, jlti)):
        x = tc.variable("lt_x", (nx, Tu))
        u = tc.variable("lt_u", (nu, Tu))
        x0 = tc.variable("lt_x0", (nx, 1))
        sc, y, z = lti.lti_constraints(A, B, C, D, x0=x0, x=x, u=u, Ty=Tu)
        assert isinstance(sc, tc.Constraint) and sc.kind == "eq"
        assert y.shape == (1, Tu) and z is None
        outs.append((sc, y))
    env_t = {k: torch.as_tensor(v) for k, v in env_np.items()}
    (sct, yt), (scj, yj) = outs
    np.testing.assert_allclose(sct.expr(env_t).numpy(), 0.0, atol=1e-12)
    np.testing.assert_allclose(sct.expr(env_t).numpy(), np.asarray(scj.expr(env_np)), atol=1e-15)
    xprev = np.concatenate([x0v, xs[:, :-1]], axis=1)
    np.testing.assert_allclose(yt(env_t).numpy(), C @ xprev + D @ uv, atol=1e-12)
    np.testing.assert_allclose(yt(env_t).numpy(), np.asarray(yj(env_np)), atol=1e-15)
    with pytest.raises(ValueError, match="x must have shape"):
        tlti.lti_constraints(A, B, x0=ttc.variable("lt_x0", (nx, 1)),
                             x=ttc.variable("lt_xb", (nx, Tu + 1)), u=ttc.variable("lt_u", (nu, Tu)))


def test_variables_mpc_matches_jax():
    """tests/test_lti.py:43: the trapezoidal residual on both sides."""
    nX, nU, T, delay, p = 2, 1, 6, 2, -2.0
    rng = np.random.default_rng(1)
    env_np = {
        "vm_Ts": np.float64(0.1), "vm_xMeas": rng.random((nX, 1)),
        "vm_xFut": rng.random((nX, T)), "vm_uPast": rng.random((nU, delay)),
        "vm_uFut": rng.random((nU, T - delay)),
    }
    res = []
    for tc, lti in ((ttc, tlti), (jtc, jlti)):
        def fdot(x, u, _tc=tc):
            return _tc.expr.concat([x[1:2, :], p * x[1:2, :] + u], axis=0)

        Ts, xMeas, xFut, uPast, uFut, dyn = lti.variables_mpc(nX, nU, T, delay, fdot,
                                                              namespace="vm_")
        assert Ts.shape == () and xMeas.shape == (nX, 1) and xFut.shape == (nX, T)
        assert uPast.shape == (nU, delay) and uFut.shape == (nU, T - delay)
        assert dyn.kind == "eq"
        _, _, _, uP0, uF0, _ = lti.variables_mpc(nX, nU, T, 0, fdot, namespace="vm0_")
        assert uP0 is None and uF0.shape == (nU, T)
        with pytest.raises(ValueError):
            lti.variables_mpc(nX, nU, T, T, fdot, namespace="vmbad_")
        res.append(dyn)
    got = res[0].expr({k: torch.as_tensor(v) for k, v in env_np.items()}).numpy()
    xm, xf = env_np["vm_xMeas"], env_np["vm_xFut"]
    ua = np.concatenate([env_np["vm_uPast"], env_np["vm_uFut"]], axis=1)
    xp = np.concatenate([xm, xf[:, :-1]], axis=1)

    def f_np(x, u):
        return np.concatenate([x[1:2], p * x[1:2] + u], axis=0)

    np.testing.assert_allclose(got, (xf - xp) - 0.05 * (f_np(xf, ua) + f_np(xp, ua)),
                               atol=1e-12)
    np.testing.assert_allclose(got, np.asarray(res[1].expr(env_np)), atol=1e-15)


def test_mpc_lti_example_matches_jax():
    """tests/test_lti.py:87: the closed loop at T = 12, delay 1, 8 steps."""
    st = tlti_ex.build_solver(T=12, delay=1, namespace="tlti_", device="cpu")
    sj = jlti_ex.build_solver(T=12, delay=1, namespace="tlti_")
    assert st.kkt_backend_resolved == sj.kkt_backend_resolved
    ht = tlti_ex.run_closed_loop(st, n_steps=8)
    hj = jlti_ex.run_closed_loop(sj, n_steps=8)
    assert set(ht["status"].tolist()) == {0} and len(ht["x"]) == 8
    assert (np.abs(ht["x"][:, 0]) <= 0.4 + 1e-6).all()
    np.testing.assert_array_equal(ht["status"], hj["status"])
    np.testing.assert_allclose(ht["u"], hj["u"], rtol=0, atol=LOOP_ATOL)
    np.testing.assert_allclose(ht["x"], hj["x"], rtol=0, atol=LOOP_ATOL)
