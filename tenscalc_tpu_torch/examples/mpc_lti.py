"""DC-motor MPC assembled from the convenience builders
(:func:`tenscalc_tpu_torch.apps.lti.variables_mpc` and
``lti_constraints``) instead of hand-written dynamics, written for the
PyTorch port (the JAX package's ``examples/mpc_lti.py`` builds the same
solver): the usage pattern of the reference's lib/TvariablesMPC.m and
lib/TltiConstraints.m helpers.
"""

from __future__ import annotations

import numpy as np

import tenscalc_tpu_torch as tc
from tenscalc_tpu_torch.apps.lti import variables_mpc
from tenscalc_tpu_torch.expr import concat
from tenscalc_tpu_torch.ops.tseries import tsIntegral


def build_solver(T=20, delay=1, namespace="lti_", **options):
    """``options`` go to :func:`tenscalc_tpu_torch.optimize` (``device``,
    ``dtype``, ...)."""
    ns = namespace
    p = tc.variable(ns + "p", ())
    k = tc.variable(ns + "k", ())
    ref = tc.variable(ns + "ref", (1, T))
    lambda_u = tc.variable(ns + "lambda_u", ())

    # continuous-time dynamics dx = [x2; p*x2 + k*u]
    def fdot(x, u):
        return concat([x[1:2, :], p * x[1:2, :] + k * u], axis=0)

    Ts, xMeas, xFut, uPast, uFut, dynamics = variables_mpc(
        2, 1, T, delay, fdot, namespace=ns
    )

    theta = xFut[0:1, :]
    uAll = concat([uPast, uFut], axis=1) if uPast is not None else uFut
    J = tsIntegral(((theta - ref) ** 2).sum(axis=0), Ts) + lambda_u * tsIntegral(
        (uAll**2).sum(axis=0), Ts
    )

    constraints = [
        dynamics,
        xFut >= np.array([[-0.4], [-0.3]]),
        xFut <= np.array([[0.4], [0.3]]),
        uFut >= -1.0,
        uFut <= 1.0,
    ]

    params = [Ts, xMeas, p, k, ref, lambda_u]
    if uPast is not None:
        params.append(uPast)

    solver = tc.optimize(
        objective=J,
        optimizationVariables=[uFut, xFut],
        constraints=constraints,
        parameters=params,
        outputExpressions={"J": J, "u": uFut, "x": xFut},
        **options,
    )
    solver.namespace = ns
    solver.T = T
    solver.delay = delay
    return solver


def run_closed_loop(solver, n_steps=30, Ts=0.1, seed=0):
    """Receding-horizon loop with exact ZOH plant propagation; returns
    the history (``x``, ``u``, ``status``) as numpy arrays."""
    import scipy.linalg

    ns, T, delay = solver.namespace, solver.T, solver.delay
    p, k = -2.0, 1.0
    A = np.array([[0.0, 1.0], [0.0, p]])
    B = np.array([[0.0], [k]])
    M = scipy.linalg.expm(np.block([[A, B], [np.zeros((1, 3))]]) * Ts)
    Ad, Bd = M[:2, :2], M[:2, 2:]

    rng = np.random.default_rng(seed)
    xk = np.array([[0.2], [0.2]])
    u_pending = np.zeros((1, delay))  # controls already committed
    xWarm = xk + 0.01 * rng.random((2, T))
    uWarm = 0.01 * rng.random((1, T - delay))
    hist = {"x": [], "u": [], "status": []}
    t = 0.0
    for step in range(n_steps):
        params = {
            ns + "Ts": Ts,
            ns + "xMeas": xk,
            ns + "p": p,
            ns + "k": k,
            ns + "ref": -0.35 * np.sign(np.sin(0.5 * (t + np.arange(T) * Ts)))[None, :],
            ns + "lambda_u": 1.0 / 50.0,
        }
        if delay > 0:
            params[ns + "uPast"] = u_pending
        sol = solver.solve(
            params,
            init={ns + "uFut": uWarm, ns + "xFut": xWarm},
            mu0=1e-3,
            max_iter=100,
        )
        hist["status"].append(sol.status)
        if sol.status != 0:
            break
        u_sol = np.asarray(sol.outputs["u"], float)
        u_all = np.concatenate([u_pending, u_sol], axis=1) if delay > 0 else u_sol
        u_now = u_all[:, 0:1]
        hist["x"].append(xk[:, 0].copy())
        hist["u"].append(u_now[:, 0].copy())
        xk = Ad @ xk + Bd @ u_now
        t += Ts
        # shift
        if delay > 0:
            u_pending = u_all[:, 1 : delay + 1]
        x_sol = np.asarray(sol.outputs["x"], float)
        xWarm = np.concatenate([x_sol[:, 1:], x_sol[:, -1:]], axis=1)
        uWarm = np.concatenate([u_sol[:, 1:], np.zeros((1, 1))], axis=1)
    return {k_: np.asarray(v) for k_, v in hist.items()}


if __name__ == "__main__":
    solver = build_solver()
    hist = run_closed_loop(solver)
    print("steps:", len(hist["x"]), "statuses:", set(hist["status"].tolist()))
    print("final state:", hist["x"][-1])
