"""Coupled MPC-MHE control of the DC motor under adversarial disturbance
and measurement noise, written for the PyTorch port (the JAX package's
``examples/mpcmhe_dcmotor.py`` builds the same game).

Output feedback: only y = x1 + noise is measured.  At each step the
controller solves a Nash game: the controller (P1) picks future controls
minimizing J; the adversary (P2) picks the initial state and the
disturbance trajectory maximizing J (P2objective = -J); the full state
trajectory is a latent variable pinned by forward-Euler dynamics.
``run_closed_loop`` drives the receding-horizon loop.
"""

from __future__ import annotations

import numpy as np

import tenscalc_tpu_torch as tc
from tenscalc_tpu_torch.expr import concat


def build_solver(T=60, L=40, nX=2, nU=1, nD=1, nY=1, ns="mmhe_", **options):
    """Create the MPC-MHE equilibrium solver with horizon T and past
    window L.  ``ns`` prefixes variable names so several instances can
    coexist in the registry; ``options`` go to
    :func:`tenscalc_tpu_torch.equilibrium` (``device``, ``dtype``, ...)."""
    Ts = tc.variable(ns + "Ts", ())
    x0 = tc.variable(ns + "x0", (nX, 1))          # P2 var: initial state x(-L)
    x1 = tc.variable(ns + "x1", (nX, L + T))      # latent: x(-L+1)..x(T)
    uPast = tc.variable(ns + "uPast", (nU, L))
    uFuture = tc.variable(ns + "uFuture", (nU, T))
    d = tc.variable(ns + "d", (nD, L + T))
    yPast = tc.variable(ns + "yPast", (nY, L))
    p = tc.variable(ns + "p", ())
    k = tc.variable(ns + "k", ())
    max_u = tc.variable(ns + "max_u", (nU, 1))
    max_d = tc.variable(ns + "max_d", (nD, 1))
    ref = tc.variable(ns + "ref", (1, T))
    lambda_u = tc.variable(ns + "lambda_u", ())
    lambda_d = tc.variable(ns + "lambda_d", ())
    lambda_n = tc.variable(ns + "lambda_n", ())

    x = concat([x0, x1], axis=1)                  # x(-L)..x(T)
    u = concat([uPast, uFuture], axis=1)          # u(-L)..u(T-1)

    # forward-Euler dynamics with A=[0 1;0 p], B=[0;k], input u+d
    theta, omega = x[0:1, :], x[1:2, :]
    dynamics = [
        theta[:, 1:] == theta[:, :-1] + Ts * omega[:, :-1],
        omega[:, 1:] == omega[:, :-1] + Ts * (p * omega[:, :-1] + k * (u + d)),
    ]

    P1constraints = [uFuture >= -max_u, uFuture <= max_u]
    P2constraints = [d >= -max_d, d <= max_d]

    # criterion; C = [1 0]
    errFuture = x[0:1, L + 1:] - ref
    Jerr2 = tc.tsIntegral((errFuture**2).sum(axis=0), Ts)
    Ju2 = tc.tsIntegral((uFuture**2).sum(axis=0), Ts)
    Jd2 = tc.tsIntegral((d**2).sum(axis=0), Ts)
    n = x[0:1, :L] - yPast                        # measurement noise
    Jn2 = tc.tsIntegral((n**2).sum(axis=0), Ts)
    J = Jerr2 + lambda_u * Ju2 - lambda_d * Jd2 - lambda_n * Jn2

    outputs = {
        "J": J, "Jerr2": Jerr2, "Ju2": Ju2, "Jd2": Jd2, "Jn2": Jn2,
        "uFuture": uFuture, "d": d, "x": x,
        "xEst": x1[:, L - 1: L],                 # estimate of x(0)
        "ref": ref,
    }

    solver = tc.equilibrium(
        P1objective=J,
        P2objective=-J,
        P1optimizationVariables=[uFuture],
        P1constraints=P1constraints,
        P2optimizationVariables=[x0, d],
        P2constraints=P2constraints,
        latentVariables=[x1],
        latentConstraints=dynamics,
        parameters=[Ts, p, k, uPast, yPast, ref, max_u, max_d,
                    lambda_u, lambda_d, lambda_n],
        outputExpressions=outputs,
        scaleCost=0.0,
        scaleInequalities=False,
        **options,
    )
    solver.ns = ns
    solver.dims = (T, L, nX, nU, nD, nY)
    return solver


def default_params(ns="mmhe_"):
    """Physical parameters of the reference script."""
    return {
        ns + "Ts": 0.05,
        ns + "p": -2.0,
        ns + "k": 1.0,
        ns + "max_u": np.array([[5.0]]),
        ns + "max_d": np.array([[10.0]]),
        ns + "lambda_u": 1 / 50.0,
        ns + "lambda_d": 50.0,
        ns + "lambda_n": 5.0,
    }


def reference_signal(t):
    return np.sign(np.sin(0.5 * np.asarray(t)))


def fleet_inputs(T, L, B, ns="mmhe_", seed=0):
    """Parameters of a fleet of B games built as the JAX package's
    ``bench.py`` builds them (``bench_mpcmhe``): the plant model and the
    weights shared (lambda_n = 20), and per instance a past input window,
    a noisy past output window and a reference trajectory, from numpy
    seed ``seed``.  Returns a dict of numpy arrays; the fleet starts from
    zeros."""
    rng = np.random.default_rng(seed)
    params = {k: np.asarray(v, float) for k, v in default_params(ns).items()}
    params[ns + "lambda_n"] = np.asarray(20.0)
    t = np.arange(T) * 0.05
    params[ns + "uPast"] = 0.1 * rng.standard_normal((B, 1, L))
    params[ns + "yPast"] = 0.05 * np.sin(
        0.5 * (np.arange(-L, 0) * 0.05)
    ).reshape(1, 1, L) + 0.02 * rng.standard_normal((B, 1, L))
    params[ns + "ref"] = np.stack(
        [reference_signal(t0 + t)[None, :] for t0 in np.linspace(0.0, 4.0, B)]
    )
    return params


def run_closed_loop(solver, n_steps=30, mu0=1e-3, max_iter=100, seed=0,
                    true_disturbance=None, noise_level=0.0,
                    param_overrides=None):
    """The receding-horizon MPC-MHE loop: the real plant evolves under the
    applied control and a true disturbance; only noisy position
    measurements reach the solver, with a one-step delay.  Until L
    measurements accumulate zero control is applied; afterwards each step
    solves the game warm started from the shifted previous solution.
    Returns the history (t, x, u, xEst, status, iters) as numpy arrays.

    The game has a saddle only when the measurement window dominates the
    future-error pressure (lambda_n times the past window's sensitivity
    above the horizon's along every state direction); for short windows
    raise lambda_n or L."""
    T, L, nX, nU, nD, nY = solver.dims
    ns = solver.ns
    base = default_params(ns)
    base.update({ns + k_: v for k_, v in (param_overrides or {}).items()})
    Ts = base[ns + "Ts"]
    p, k = base[ns + "p"], base[ns + "k"]
    A = np.array([[0.0, 1.0], [0.0, p]])
    Bm = np.array([[0.0], [k]])
    rng = np.random.default_rng(seed)
    if true_disturbance is None:
        def true_disturbance(t):
            return 0.2 * np.sin(2.0 * t)

    xinit = np.array([[0.2], [0.2]])
    warm = {
        "x0": 0.01 * rng.random((nX, 1)),
        "x1": 0.01 * rng.random((nX, T + L)),
        "uFuture": 0.01 * rng.random((nU, T)),
        "d": 0.01 * rng.random((nD, T + L)),
    }

    t = 0.0
    uPast = np.zeros((nU, 0))
    yPast = np.zeros((nY, 0))
    hist = {"t": [], "x": [], "u": [], "xEst": [], "status": [], "iters": []}
    for _ in range(n_steps):
        y = xinit[0:1, :] + noise_level * rng.standard_normal((nY, 1))
        if yPast.shape[1] < L:
            u_apply = np.zeros((nU, 1))
            status, iters, xEst = 0, 0, np.full((nX, 1), np.nan)
        else:
            params = dict(base)
            params[ns + "ref"] = reference_signal(t + np.arange(T) * Ts)[None, :]
            params[ns + "uPast"] = uPast[:, -L:]
            params[ns + "yPast"] = yPast[:, -L:]
            sol = solver.solve(params, init={ns + k_: v_ for k_, v_ in warm.items()},
                               mu0=mu0, max_iter=max_iter)
            status, iters = sol.status, sol.iters
            if status != 0:
                hist["status"].append(status)
                break
            out = sol.outputs
            u_apply = np.asarray(out["uFuture"])[:, 0:1]
            xEst = np.asarray(out["xEst"])
            # shift the warm start
            xfull = np.asarray(out["x"])
            warm = {
                "x0": xfull[:, 1:2],
                "x1": np.concatenate([xfull[:, 2:], xfull[:, -1:]], axis=1),
                "uFuture": np.clip(
                    np.concatenate([out["uFuture"][:, 1:], np.zeros((nU, 1))], axis=1),
                    -0.95 * 5.0, 0.95 * 5.0),
                "d": np.clip(
                    np.concatenate([out["d"][:, 1:], np.zeros((nD, 1))], axis=1),
                    -0.95 * 10.0, 0.95 * 10.0),
            }

        hist["t"].append(t)
        hist["x"].append(xinit[:, 0].copy())
        hist["u"].append(u_apply[:, 0].copy())
        hist["xEst"].append(xEst[:, 0].copy())
        hist["status"].append(status)
        hist["iters"].append(iters)

        # the true plant: forward Euler with the real disturbance
        xinit = xinit + Ts * (A @ xinit + Bm * (u_apply[0, 0] + true_disturbance(t)))
        uPast = np.concatenate([uPast, u_apply], axis=1)
        yPast = np.concatenate([yPast, y], axis=1)  # one-step output delay
        t += Ts
    return {k_: np.asarray(v) for k_, v in hist.items()}
