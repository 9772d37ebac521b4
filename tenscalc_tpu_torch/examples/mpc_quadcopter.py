"""Quadcopter trajectory optimization, written for the PyTorch port (the
JAX package's ``examples/mpc_quadcopter.py``).

Minimum-effort point-to-point flight: a position trajectory p (3, T)
whose velocity and acceleration come from the time-series derivatives,
double-integrator-with-drag dynamics driven by the thrust vector u,
thrust-magnitude bounds (with a slack, so that an initial guess past the
maximum thrust still works), and a minimum altitude (NED: altitude =
-p_z).  The thrust magnitude's square root makes it nonconvex.  With the
large Newton matrix (``smallerNewtonMatrix=False``) its KKT has
14 T + 6 rows and an RCM half-bandwidth of 30, which ``'auto'`` factors
on ``fleet_banded`` (K1/K2's wide route).
"""

from __future__ import annotations

import numpy as np

import tenscalc_tpu_torch as tc
from tenscalc_tpu_torch.ops.fns import sqrt
from tenscalc_tpu_torch.ops.tseries import tsDerivative, tsDerivative2, tsIntegral

# hover thrust (NED: up is -z) and the maximum thrust's slack at hover
HOVER_U = (0.0, 0.0, -9.8)
HOVER_SLACK = 20.0 - 9.8


def build_solver(T=100, ns="quad_", **options):
    """The T-step flight solver; ``ns`` prefixes the variable names and
    ``options`` go to :func:`tenscalc_tpu_torch.optimize` (``device``,
    ``dtype``, ``kkt_backend``, ``smallerNewtonMatrix``, ...) over the
    example's own ``adjustAddEye2Hessian`` and ``scaleInequalities``."""
    Ts = tc.variable(ns + "Ts", ())
    p = tc.variable(ns + "p", (3, T))
    u = tc.variable(ns + "u", (3, T))
    positive2 = tc.variable(ns + "positive2", (T,))  # the maximum thrust's slack
    pinit = tc.variable(ns + "pinit", (3, 1))
    vinit = tc.variable(ns + "vinit", (3, 1))
    pdesired = tc.variable(ns + "pdesired", (3, 1))
    vdesired = tc.variable(ns + "vdesired", (3, 1))
    b_drag = tc.variable(ns + "b_drag", ())
    min_thrust = tc.variable(ns + "min_thrust", ())
    max_thrust = tc.variable(ns + "max_thrust", ())
    min_altitude = tc.variable(ns + "min_altitude", ())
    lambda_v = tc.variable(ns + "lambda_v", ())
    lambda_thrust = tc.variable(ns + "lambda_thrust", ())

    g = tc.constant(np.array([[0.0], [0.0], [9.8]]))  # NED gravity

    v = tsDerivative(p, Ts)
    a = tsDerivative2(p, Ts)

    dynamics = [
        a == -b_drag * v + g + u,
        p[:, 0:1] == pinit,
        v[:, 0:1] == vinit,
    ]

    m_thrust = sqrt((u ** 2).sum(axis=0))  # thrust magnitude per step
    constraints = [
        m_thrust >= min_thrust,
        max_thrust - m_thrust == positive2,
        positive2 >= 0.0,
        p[2, :] <= -min_altitude,
    ]

    Jp2 = tsIntegral(((p - pdesired) ** 2).sum(axis=0), Ts)
    Jv2 = tsIntegral(((v - vdesired) ** 2).sum(axis=0), Ts)
    Jthrust = tsIntegral(m_thrust, Ts)
    J = Jp2 + lambda_v * Jv2 + lambda_thrust * Jthrust

    solver = tc.optimize(
        objective=J,
        optimizationVariables=[p, u, positive2],
        constraints=dynamics + constraints,
        parameters=[Ts, pinit, vinit, pdesired, vdesired, b_drag,
                    min_thrust, max_thrust, min_altitude,
                    lambda_v, lambda_thrust],
        outputExpressions={"J": J, "Jp2": Jp2, "u": u, "p": p, "m_thrust": m_thrust},
        **{**dict(adjustAddEye2Hessian=True, scaleInequalities=True), **options},
    )
    solver.ns = ns
    solver.T = T
    return solver


def default_params(ns="quad_"):
    return {
        ns + "Ts": 0.02,
        ns + "b_drag": 0.1,
        ns + "min_altitude": -0.1,
        ns + "min_thrust": 5.0,
        ns + "max_thrust": 20.0,
        ns + "lambda_v": 0.05,
        ns + "lambda_thrust": 0.05,
        ns + "pinit": np.zeros((3, 1)),
        ns + "vinit": np.zeros((3, 1)),
        ns + "pdesired": np.array([[0.0], [5.0], [-2.5]]),
        ns + "vdesired": np.zeros((3, 1)),
    }


def _line_init(T, p0, pd):
    """Hover thrust along the straight line from p0 to pd (..., 3, 1)."""
    frac = np.linspace(0, 1, T)
    p = p0 + (pd - p0) * frac
    lead = p.shape[:-2]
    u = np.broadcast_to(np.array(HOVER_U)[:, None], lead + (3, T)).copy()
    return p, u, np.full(lead + (T,), HOVER_SLACK)


def hover_init(T, ns="quad_"):
    """Strictly feasible initial guess: hover thrust, straight-line path."""
    params = default_params(ns)
    p, u, pos2 = _line_init(T, params[ns + "pinit"], params[ns + "pdesired"])
    return {ns + "p": p, ns + "u": u, ns + "positive2": pos2}


def fleet_inputs(T, B, ns="quad_", seed=0):
    """Inputs of a fleet of B flights from numpy seed ``seed``: each
    instance flies to its own target, ``pdesired = (0, 5, -2.5) +
    U(-0.5, 0.5)^3``, from :func:`hover_init`'s straight line to that
    target (hover thrust, slack 10.2); every other parameter is shared.
    Returns (params, inits) as numpy arrays."""
    rng = np.random.default_rng(seed)
    params = {k: np.asarray(v, float) for k, v in default_params(ns).items()}
    pd = params[ns + "pdesired"] + rng.uniform(-0.5, 0.5, (B, 3, 1))
    params[ns + "pdesired"] = pd
    p, u, pos2 = _line_init(T, params[ns + "pinit"], pd)
    return params, {ns + "p": p, ns + "u": u, ns + "positive2": pos2}
