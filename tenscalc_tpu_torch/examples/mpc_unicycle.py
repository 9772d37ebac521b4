"""Nonlinear MPC: unicycle pursuit, written for the PyTorch port (the JAX
package's ``examples/mpc_unicycle.py`` lifts ``jnp.clip``; this one lifts
``torch.clamp``).

A unicycle with constant forward speed v and bounded turning rate u
pursues a target moving with constant velocity d.  State
x = [px, py, theta, tx, ty]; the trapezoidal discretization of the
nonlinear heading kinematics makes this a nonconvex problem whose
Hessian and equality Jacobian depend on the iterate, so a fleet of it
runs the per-iteration band mode (``solve.band_mode == "periter"``);
``useInertia`` is on, as the reference sets it for this problem.
"""

from __future__ import annotations

import numpy as np
import torch

import tenscalc_tpu_torch as tc
from tenscalc_tpu_torch.expr import concat, lift
from tenscalc_tpu_torch.ops import fns
from tenscalc_tpu_torch.ops.tseries import tsIntegral


def build_solver(T=40, ns="uni_", **options):
    """The T-step pursuit solver; ``ns`` prefixes the variable names and
    ``options`` go to :func:`tenscalc_tpu_torch.optimize` (``device``,
    ``dtype``, ``kkt_backend``, ...) over the example's own
    ``useInertia``, ``adjustAddEye2Hessian`` and ``scaleInequalities``."""
    nX, nU, nD = 5, 1, 2
    Ts = tc.variable(ns + "Ts", ())
    x = tc.variable(ns + "x", (nX, T))
    u = tc.variable(ns + "u", (nU, T - 1))
    d = tc.variable(ns + "d", (nD, 1))
    xinit = tc.variable(ns + "xinit", (nX, 1))
    v = tc.variable(ns + "v", ())
    max_u = tc.variable(ns + "max_u", ())

    th0, th1 = x[2:3, :-1], x[2:3, 1:]
    # trapezoidal heading kinematics, zero-order hold for u and d
    dynamics = [
        x[0:1, 1:] == x[0:1, :-1] + Ts * v * (fns.cos(th0) + fns.cos(th1)) / 2,
        x[1:2, 1:] == x[1:2, :-1] + Ts * v * (fns.sin(th0) + fns.sin(th1)) / 2,
        x[2:3, 1:] == x[2:3, :-1] + Ts * u,
        x[3:5, 1:] == x[3:5, :-1] + Ts * d,
        x[:, 0:1] == xinit,
    ]
    constraints = [u >= -max_u, u <= max_u]

    J = tsIntegral(((x[0:2, :] - x[3:5, :]) ** 2).sum(axis=0), Ts)

    uWarm = concat([u[:, 1:], tc.Tzeros((nU, 1))], axis=1)
    uWarm = lift(lambda uu, m: torch.clamp(uu, -0.9 * m, 0.9 * m))(uWarm, max_u)
    xWarm = concat([x[:, 1:], x[:, -1:]], axis=1)

    opts = dict(useInertia=True, adjustAddEye2Hessian=True, scaleInequalities=True)
    opts.update(options)
    solver = tc.optimize(
        objective=J,
        optimizationVariables=[u, x],
        constraints=dynamics + constraints,
        parameters=[Ts, v, d, xinit, max_u],
        outputExpressions={"J": J, "u": u, "x": x, "uWarm": uWarm, "xWarm": xWarm},
        **opts,
    )
    solver.ns = ns
    solver.T = T
    return solver


def default_params(ns="uni_"):
    return {
        ns + "Ts": 0.1,
        ns + "v": 1.0,
        ns + "d": np.array([[0.3], [0.2]]),
        ns + "max_u": 2.0,
    }


def fleet_inputs(T, B, ns="uni_", seed=0):
    """Inputs of a fleet of B pursuits as the JAX package's ``bench.py``
    (``bench_nonlinear_fleet``) builds them from numpy seed ``seed``: a
    per-instance initial state (unicycle near the origin, heading in
    [-0.5, 0.5], target at [1.5, 2.5] x [0.5, 1.5]) and target velocity
    ``d`` in [0.1, 0.4]^2; ``Ts``, ``v`` and ``max_u`` shared; the
    initial point is the u = 0 plant rollout, which satisfies the
    dynamics exactly.  Returns (params, inits) as numpy arrays."""
    rng = np.random.default_rng(seed)
    base = default_params(ns)
    params = {k: np.asarray(v, float) for k, v in base.items()}
    xinit = np.zeros((B, 5, 1))
    xinit[:, 0, 0] = rng.uniform(-0.2, 0.2, B)
    xinit[:, 1, 0] = rng.uniform(-0.2, 0.2, B)
    xinit[:, 2, 0] = rng.uniform(-0.5, 0.5, B)
    xinit[:, 3, 0] = rng.uniform(1.5, 2.5, B)
    xinit[:, 4, 0] = rng.uniform(0.5, 1.5, B)
    params[ns + "xinit"] = xinit
    params[ns + "d"] = rng.uniform(0.1, 0.4, (B, 2, 1))
    Ts, vconst = float(base[ns + "Ts"]), float(base[ns + "v"])
    init_x = np.zeros((B, 5, T))
    init_x[:, :, 0] = xinit[:, :, 0]
    th = xinit[:, 2, 0]
    for k in range(1, T):
        init_x[:, 0, k] = init_x[:, 0, k - 1] + Ts * vconst * np.cos(th)
        init_x[:, 1, k] = init_x[:, 1, k - 1] + Ts * vconst * np.sin(th)
        init_x[:, 2, k] = th
        init_x[:, 3:5, k] = init_x[:, 3:5, k - 1] + Ts * params[ns + "d"][:, :, 0]
    inits = {ns + "x": init_x, ns + "u": np.zeros((B, 1, T - 1))}
    return params, inits


def run_closed_loop(solver, n_steps=40, mu0=1e-1, max_iter=200, seed=0):
    """The receding-horizon pursuit: each step solves from the shifted
    previous solution (the ``xWarm``/``uWarm`` outputs) and applies the
    first control to the true plant, a trapezoidal step matching the
    model.  Returns the history (t, x, u, dist, status, iters) as numpy
    arrays; it stops at the first solve not at status 0."""
    T, ns = solver.T, solver.ns
    base = default_params(ns)
    Ts, v, dval = base[ns + "Ts"], base[ns + "v"], base[ns + "d"]
    rng = np.random.default_rng(seed)

    xinit = np.array([0.0, 0.0, 0.5, 2.0, 1.0])[:, None]
    xWarm = np.tile(xinit, (1, T)) + 0.01 * rng.random((5, T))
    uWarm = 0.01 * rng.random((1, T - 1))
    hist = {"t": [], "x": [], "u": [], "dist": [], "status": [], "iters": []}
    t = 0.0
    for _ in range(n_steps):
        params = dict(base)
        params[ns + "xinit"] = xinit
        sol = solver.solve(params, init={ns + "x": xWarm, ns + "u": uWarm},
                           mu0=mu0, max_iter=max_iter)
        hist["status"].append(sol.status)
        if sol.status != 0:
            break
        u0 = np.asarray(sol.outputs["u"])[:, 0:1]
        hist["t"].append(t)
        hist["x"].append(xinit[:, 0].copy())
        hist["u"].append(u0[:, 0].copy())
        hist["dist"].append(
            float(np.hypot(xinit[0, 0] - xinit[3, 0], xinit[1, 0] - xinit[4, 0])))
        hist["iters"].append(sol.iters)
        th = xinit[2, 0]
        th_new = th + Ts * u0[0, 0]
        xinit = xinit + Ts * np.array([
            [v * (np.cos(th) + np.cos(th_new)) / 2],
            [v * (np.sin(th) + np.sin(th_new)) / 2],
            [u0[0, 0]],
            [dval[0, 0]],
            [dval[1, 0]],
        ])
        xWarm = np.asarray(sol.outputs["xWarm"])
        uWarm = np.asarray(sol.outputs["uWarm"])
        t += Ts
    return {k: np.asarray(v_) for k, v_ in hist.items()}
