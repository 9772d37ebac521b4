"""MPC-MHE output-feedback pursuit, written for the PyTorch port (the JAX
package's ``examples/mpcmhe_unicycle.py`` builds the same game): a
unicycle pursuer chasing a velocity-controlled evader.

Pursuer (unicycle, constant speed v, turning-rate control u):
    dot x1 = v cos x3,  dot x2 = v sin x3,  dot x3 = u,  |u| <= max_u
Evader (integrator driven by adversarial velocity d):
    dot x4 = d1,  dot x5 = d2,  ||d|| <= max_d

Only noisy positions y = [x1; x2; x4; x5] are measured (the heading x3
is estimated).  Each step solves the Nash game
    min_{uFuture} max_{x(-L), d, n}  int ||pursuer - evader||^2
        + lambda_u int u^2 - lambda_d int ||d||^2 - lambda_n int ||n||^2
with the state trajectory latent, pinned by forward-Euler dynamics.  The
dynamics' cos and sin and the quadratic constraints make every Jacobian
of the game depend on the iterate, so the solver assembles its KKT
densely at every iterate (``solve.band_mode`` None) and factors it by the
fleet banded LU of its RCM plan (T = 20, L = 10: nK = 585, w = 22).
"""

from __future__ import annotations

import numpy as np

import tenscalc_tpu_torch as tc
from tenscalc_tpu_torch.expr import concat
from tenscalc_tpu_torch.ops.fns import cos, sin
from tenscalc_tpu_torch.ops.tseries import tsIntegral

nX, nU, nD, nY = 5, 1, 2, 4
# the measured states: the two positions
MEASURED = np.array([0, 1, 3, 4])


def build_solver(T=20, L=10, ns="uni_", **options):
    """The game over a horizon of T steps and a past window of L; ``ns``
    prefixes the variable names and ``options`` go to
    :func:`tenscalc_tpu_torch.equilibrium` (``device``, ``dtype``,
    ``kkt_backend``, ...)."""
    Ts = tc.variable(ns + "Ts", ())
    x0 = tc.variable(ns + "x0", (nX, 1))          # P2 var: state x(-L)
    x1 = tc.variable(ns + "x1", (nX, L + T))      # latent: x(-L+1)..x(T)
    uPast = tc.variable(ns + "uPast", (nU, L))
    uFuture = tc.variable(ns + "uFuture", (nU, T))
    d = tc.variable(ns + "d", (nD, L + T))        # P2 var: evader velocity
    yPast = tc.variable(ns + "yPast", (nY, L))
    v = tc.variable(ns + "v", ())
    max_u = tc.variable(ns + "max_u", ())
    max_d = tc.variable(ns + "max_d", ())
    lambda_u = tc.variable(ns + "lambda_u", ())
    lambda_d = tc.variable(ns + "lambda_d", ())
    lambda_n = tc.variable(ns + "lambda_n", ())

    x = concat([x0, x1], axis=1)                  # x(-L)..x(T)
    u = concat([uPast, uFuture], axis=1)          # u(-L)..u(T-1)

    # forward-Euler dynamics
    xk = x[:, :-1]
    rhs = concat([v * cos(xk[2:3, :]), v * sin(xk[2:3, :]), u, d], axis=0)
    dynamics = [x[:, 1:] == xk + Ts * rhs]

    # a box on u, a 2-norm ball on d
    P1constraints = [uFuture**2 <= max_u**2]
    P2constraints = [(d**2).sum(axis=0) <= max_d**2]

    errFuture = x[0:2, L + 1:] - x[3:5, L + 1:]
    Jerr2 = tsIntegral((errFuture**2).sum(axis=0), Ts)
    Ju2 = tsIntegral((uFuture**2).sum(axis=0), Ts)
    Jd2 = tsIntegral((d**2).sum(axis=0), Ts)
    n = x[MEASURED, :L] - yPast                   # measurement noise
    Jn2 = tsIntegral((n**2).sum(axis=0), Ts)
    J = Jerr2 + lambda_u * Ju2 - lambda_d * Jd2 - lambda_n * Jn2

    outputs = {
        "J": J, "Jerr2": Jerr2, "Ju2": Ju2, "Jd2": Jd2, "Jn2": Jn2,
        "uFuture": uFuture, "d": d, "x": x,
        "xEst": x1[:, L - 1: L],                 # estimate of x(0)
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
        parameters=[Ts, v, uPast, yPast, max_u, max_d,
                    lambda_u, lambda_d, lambda_n],
        outputExpressions=outputs,
        scaleCost=0.0,
        muFactorConservative=0.99,
        **options,
    )
    solver.ns = ns
    solver.dims = (T, L)
    return solver


def default_params(ns="uni_"):
    """Physical parameters of the reference script."""
    return {
        ns + "Ts": 0.1,
        ns + "v": 1.0,
        ns + "max_u": 1.5,
        ns + "max_d": 0.5,
        ns + "lambda_u": 1.0,
        ns + "lambda_d": 1.0,
        ns + "lambda_n": 1e3,
    }


def _plant_step(x, u, d_true, v, Ts, substeps=4):
    """The true plant, sub-stepped forward Euler: ``x`` (..., 5), ``u``
    (..., 1) and ``d_true`` (..., 2) broadcast over the leading axes."""
    h = Ts / substeps
    lead = np.shape(x)[:-1]
    u = np.broadcast_to(u, lead + (nU,))
    d_true = np.broadcast_to(d_true, lead + (nD,))
    for _ in range(substeps):
        x = x + h * np.concatenate(
            [v * np.cos(x[..., 2:3]), v * np.sin(x[..., 2:3]), u, d_true], axis=-1
        )
    return x


def _warm_inits(rng, guess, T, L, max_u, max_d, lead=()):
    """Warm starts drawn about the evader's position ``guess`` (..., 5),
    in the closed loop's order."""
    return {
        "x0": guess[..., :, None] + 0.01 * rng.random(lead + (nX, 1)),
        "x1": guess[..., :, None] + 0.01 * rng.random(lead + (nX, T + L)),
        "uFuture": max_u / 6 * rng.standard_normal(lead + (nU, T)),
        "d": max_d / 6 * rng.standard_normal(lead + (nD, T + L)),
    }


def run_closed_loop(solver, n_steps=60, mu0=1e-1, max_iter=300, seed=0,
                    noise_level=0.005, param_overrides=None):
    """The receding-horizon pursuit loop: until L measurements accumulate
    zero control is applied; afterwards each step solves the game warm
    started from the shifted previous solution.  Returns the history (t,
    x, u, dist, status, iters) as numpy arrays."""
    T, L = solver.dims
    ns = solver.ns
    base = default_params(ns)
    base.update({ns + k_: v_ for k_, v_ in (param_overrides or {}).items()})
    Ts, v = base[ns + "Ts"], base[ns + "v"]
    max_u, max_d = base[ns + "max_u"], base[ns + "max_d"]
    rng = np.random.default_rng(seed)

    # pursuer at the origin facing right; evader ahead and above
    xinit = np.array([0.0, 0.0, 0.0, 2 + L * Ts * v, 2.0])
    evader_guess = np.concatenate([xinit[3:5], [0.0], xinit[3:5]])
    warm = _warm_inits(rng, evader_guess, T, L, max_u, max_d)
    d_plan = np.zeros((nD, L + T))

    t = 0.0
    uPast = np.zeros((nU, 0))
    yPast = np.zeros((nY, 0))
    hist = {"t": [], "x": [], "u": [], "dist": [], "status": [], "iters": []}
    for step in range(n_steps):
        y = xinit[MEASURED, None] + noise_level * rng.standard_normal((nY, 1))
        if yPast.shape[1] < L:
            u_apply = np.zeros((nU, 1))
            status, iters = 0, 0
        else:
            params = dict(base)
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
            d_plan = np.asarray(out["d"])
            # shift the warm start
            xfull = np.asarray(out["x"])
            warm = {
                "x0": xfull[:, 1:2],
                "x1": np.concatenate([xfull[:, 2:], xfull[:, -1:]], axis=1),
                "uFuture": np.clip(
                    np.concatenate([out["uFuture"][:, 1:], np.zeros((nU, 1))], axis=1),
                    -0.9 * max_u, 0.9 * max_u),
                "d": np.clip(
                    np.concatenate([out["d"][:, 1:], np.zeros((nD, 1))], axis=1),
                    -0.9 * max_d / np.sqrt(2), 0.9 * max_d / np.sqrt(2)),
            }

        hist["t"].append(t)
        hist["x"].append(xinit.copy())
        hist["u"].append(u_apply[:, 0].copy())
        hist["dist"].append(float(np.hypot(xinit[0] - xinit[3], xinit[1] - xinit[4])))
        hist["status"].append(status)
        hist["iters"].append(iters)

        # the true evader moves left until the window fills, then plays
        # the adversarial plan at t = 0
        d_true = np.array([max_d, 0.0]) if step < L else d_plan[:, L]
        xinit = _plant_step(xinit, u_apply[:, 0], d_true, v, Ts)
        uPast = np.concatenate([uPast, u_apply], axis=1)
        yPast = np.concatenate([yPast, y], axis=1)  # one-step output delay
        t += Ts
    return {k_: np.asarray(v_) for k_, v_ in hist.items()}


def fleet_inputs(T, L, B, ns="uni_", seed=0, noise_level=0.005):
    """Inputs of a fleet of B copies of the closed loop's first game
    solve, from numpy seed ``seed``: per instance the pursuer at the
    origin with its heading in [-0.5, 0.5] and the evader at (2 + L Ts v,
    2) moved by [-0.5, 0.5]^2; L plant steps with zero control and the
    evader at d = [max_d, 0] (the loop's window-filling phase), measured
    with noise ``noise_level``; the warm starts drawn as the loop draws
    them.  uPast and yPast are per instance, the other parameters shared.
    Returns (params, inits) as numpy arrays."""
    rng = np.random.default_rng(seed)
    base = default_params(ns)
    params = {k: np.asarray(v, float) for k, v in base.items()}
    Ts, v = base[ns + "Ts"], base[ns + "v"]
    max_u, max_d = base[ns + "max_u"], base[ns + "max_d"]
    xinit = np.zeros((B, nX))
    xinit[:, 2] = rng.uniform(-0.5, 0.5, B)
    xinit[:, 3:5] = np.array([2 + L * Ts * v, 2.0]) + rng.uniform(-0.5, 0.5, (B, 2))
    guess = np.concatenate([xinit[:, 3:5], np.zeros((B, 1)), xinit[:, 3:5]], axis=1)
    warm = _warm_inits(rng, guess, T, L, max_u, max_d, lead=(B,))
    yPast = np.zeros((B, nY, L))
    for k in range(L):
        yPast[:, :, k] = xinit[:, MEASURED] + noise_level * rng.standard_normal((B, nY))
        xinit = _plant_step(xinit, np.zeros(nU), np.array([max_d, 0.0]), v, Ts)
    params[ns + "uPast"] = np.zeros((B, nU, L))
    params[ns + "yPast"] = yPast
    return params, {ns + k: w for k, w in warm.items()}
