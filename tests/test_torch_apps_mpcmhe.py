"""The Mpcmhe app (``apps/mpcmhe.py``) on the port against the JAX package
in float64 with ``TENSCALC_AUTO_FLEET=1``: tests/test_apps.py:219 (L = 4,
T = 6, a scalar system whose trapezoidal map is exact) on both sides
(status and iterations equal, controls, disturbances and states to
1e-8), a second solve from ``warm_start_shift``'s warm start, and the
nominal rollout that ``solve`` starts from without a state warm
start."""

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

L, T, A = 4, 6, 0.9
ATOL = 1e-8


@pytest.fixture(autouse=True)
def _fresh_variables(monkeypatch):
    monkeypatch.setenv("TENSCALC_AUTO_FLEET", "1")
    ttc.clear_variables()
    jtc.expr.clear_variables()
    yield
    ttc.clear_variables()


def _build(tc, **kw):
    xv = tc.variable("mh_x", (1, L + T + 1))
    yv = tc.variable("mh_y", (1, L + 1))
    up = tc.variable("mh_up", (1, L))
    uf = tc.variable("mh_uf", (1, T))
    dv = tc.variable("mh_d", (1, L + T))
    # trapezoidal rule exact for x+ = a x + u + d
    c1, c2 = 2 * (A - 1) / (1 + A), 2 / (1 + A)
    J = (tc.norm2(yv - xv[:, : L + 1]) + tc.norm2(xv[:, L + 1:]) + 0.1 * tc.norm2(uf)
         - 20.0 * tc.norm2(dv))
    return tc.Mpcmhe(
        objective=J, state_variable=xv, past_output_variable=yv,
        past_control_variable=up, future_control_variable=uf, disturbance_variable=dv,
        state_derivative=lambda xs, us, ds: c1 * xs + c2 * (us + ds),
        output_function=lambda xs: xs, sample_time=1.0, backward_horizon=L,
        forward_horizon=T, control_constraints=[uf >= -5.0, uf <= 5.0],
        disturbance_constraints=[dv >= -1.0, dv <= 1.0], **kw,
    )


def _hold(a, b):
    assert (a.status, a.iter) == (b.status, b.iter), (a.status, a.iter, b.status, b.iter)
    for k in ("control", "disturbance", "initial_state", "state"):
        va, vb = getattr(a, k), getattr(b, k)
        assert isinstance(va, np.ndarray) and va.shape == vb.shape, k
        np.testing.assert_allclose(va, vb, rtol=0, atol=ATOL, err_msg=k)
    np.testing.assert_allclose(a.objective, b.objective, rtol=1e-8)


def test_mpcmhe_matches_jax():
    rng = np.random.default_rng(0)
    x_true = [0.7]
    u_past = 0.1 * rng.standard_normal((1, L))
    for k in range(L):
        x_true.append(A * x_true[-1] + u_past[0, k])
    y_past = np.asarray(x_true)[None, :]

    mt, mj = _build(ttc, device="cpu"), _build(jtc)
    assert mt.solver.kkt_backend_resolved == mj.solver.kkt_backend_resolved
    assert (mt.initial_state_name, mt.latent_state_name) == ("mh_x_initial", "mh_x_next")
    sol = mt.solve(y_past, u_past, mu0=1e-1, max_iter=300)
    ref = mj.solve(y_past, u_past, mu0=1e-1, max_iter=300)
    assert sol.status == 0, sol.status
    _hold(sol, ref)
    np.testing.assert_allclose(sol.state[0, : L + 1], np.asarray(x_true), atol=1e-2)
    assert abs(sol.state[0, -1]) < abs(sol.state[0, L]) + 1e-9

    # the next period from the shifted warm start
    warm_t, warm_j = mt.warm_start_shift(sol), mj.warm_start_shift(ref)
    for a, b, shape in zip(warm_t, warm_j, ((1, T), (1, L + T), (1, 1), (1, L + T))):
        assert a.shape == shape
        np.testing.assert_allclose(a, b, rtol=0, atol=ATOL)
    np.testing.assert_array_equal(warm_t[0][:, :-1], sol.control[:, 1:])
    assert warm_t[0][0, -1] == 0.0 and warm_t[1][0, -1] == 0.0
    np.testing.assert_array_equal(warm_t[2], sol.state[:, 1:2])
    x_next = A * x_true[-1] + u_past[0, -1]
    y2 = np.concatenate([y_past[:, 1:], [[x_next]]], axis=1)
    u2 = np.concatenate([u_past[:, 1:], sol.control[:, :1]], axis=1)
    u_w, d_w, x0_w, x_w = warm_t
    sol2 = mt.solve(y2, u2, x_warm=x_w, u_warm=u_w, d_warm=d_w, x0_warm=x0_w,
                    mu0=1e-1, max_iter=300)
    ref2 = mj.solve(y2, u2, x_warm=x_w, u_warm=u_w, d_warm=d_w, x0_warm=x0_w,
                    mu0=1e-1, max_iter=300)
    assert sol2.status == 0
    _hold(sol2, ref2)


def test_mpcmhe_nominal_rollout_and_shapes():
    """Without x_warm the solve starts from a forward-Euler rollout of
    the warm controls and disturbances; parameters are set by name."""
    mt = _build(ttc, device="cpu")
    with pytest.raises(ValueError, match="state_variable must be"):
        ttc.Mpcmhe(objective=ttc.norm2(ttc.variable("bad_x", (1, 3))),
                   state_variable=ttc.variable("bad_x", (1, 3)),
                   past_output_variable=ttc.variable("bad_y", (1, L + 1)),
                   past_control_variable=ttc.variable("bad_up", (1, L)),
                   future_control_variable=ttc.variable("bad_uf", (1, T)),
                   disturbance_variable=ttc.variable("bad_d", (1, L + T)),
                   state_derivative=lambda x, u, d: u, output_function=lambda x: x,
                   sample_time=1.0, backward_horizon=L, forward_horizon=T, device="cpu")
    y_past = np.linspace(0.5, 0.2, L + 1)[None, :]
    sol = mt.solve(y_past, np.zeros((1, L)), x0_warm=np.array([[0.5]]), mu0=1e-1,
                   max_iter=300)
    assert sol.status == 0 and sol.state.shape == (1, L + T + 1)
    assert sol.disturbance.shape == (1, L + T) and sol.initial_state.shape == (1, 1)
    assert (np.abs(sol.disturbance) <= 1.0 + 1e-8).all()
