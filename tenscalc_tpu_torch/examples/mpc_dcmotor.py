"""MPC state-feedback control of a brushed DC motor — the flagship
problem, written for the PyTorch port (the JAX package's
``examples/mpc_dcmotor.py`` lifts a ``jnp`` function; this one lifts
``torch.clamp``).

Continuous-time model (theta = shaft angle, omega = angular velocity):

    [dot x1] = [0  1][x1] + [0] u
    [dot x2]   [0  p][x2]   [k]

discretized with forward Euler over a T-step horizon; the criterion is
the trapezoidal integral of (theta - ref)^2 + lambda_u * u^2, subject to
box constraints on states and input.
"""

from __future__ import annotations

import numpy as np
import torch

import tenscalc_tpu_torch as tc
from tenscalc_tpu_torch.expr import concat, lift


def build_solver(T=30, nX=2, nU=1, namespace="", **options):
    """Create the receding-horizon MPC solver.  ``namespace`` prefixes
    variable names so several instances can coexist in the registry;
    ``options`` go to :func:`tenscalc_tpu_torch.optimize` (``device``,
    ``dtype``, ...)."""
    p_ = namespace

    Ts = tc.variable(p_ + "Ts", ())
    x = tc.variable(p_ + "x", (nX, T))
    u = tc.variable(p_ + "u", (nU, T - 1))
    xinit = tc.variable(p_ + "xinit", (nX, 1))
    p = tc.variable(p_ + "p", ())
    k = tc.variable(p_ + "k", ())
    min_x = tc.variable(p_ + "min_x", (nX, 1))
    max_x = tc.variable(p_ + "max_x", (nX, 1))
    min_u = tc.variable(p_ + "min_u", (nU, 1))
    max_u = tc.variable(p_ + "max_u", (nU, 1))
    ref = tc.variable(p_ + "ref", (1, T))
    lambda_u = tc.variable(p_ + "lambda_u", ())

    theta, omega = x[0:1, :], x[1:2, :]
    dynamics = [
        theta[:, 1:] == theta[:, :-1] + Ts * omega[:, :-1],
        omega[:, 1:] == omega[:, :-1] + Ts * (p * omega[:, :-1] + k * u),
        x[:, 0:1] == xinit,
    ]
    constraints = [
        x[:, 1:] >= min_x,
        x[:, 1:] <= max_x,
        u >= min_u,
        u <= max_u,
    ]

    Jx2 = tc.tsIntegral(((theta - ref) ** 2).sum(axis=0), Ts)
    Ju2 = tc.tsIntegral((u**2).sum(axis=0), Ts)
    J = Jx2 + lambda_u * Ju2

    # warm start for the next optimization: shift and move away from the
    # constraints
    uWarm = concat([u[:, 1:], tc.Tzeros((nU, 1))], axis=1)
    xWarm = concat([x[:, 1:], x[:, -1:]], axis=1)
    clamp = lift(
        lambda v, lo, hi: torch.clamp(v, lo + 0.05 * (hi - lo), hi - 0.05 * (hi - lo))
    )
    xWarm = clamp(xWarm, min_x, max_x)
    uWarm = clamp(uWarm, min_u, max_u)

    outputs = {
        "J": J, "Jx2": Jx2, "Ju2": Ju2, "u": u, "x": x, "ref": ref,
        "xWarm": xWarm, "uWarm": uWarm,
    }
    solver = tc.optimize(
        objective=J,
        optimizationVariables=[u, x],
        constraints=dynamics + constraints,
        parameters=[Ts, p, k, xinit, ref, min_x, max_x, min_u, max_u, lambda_u],
        outputExpressions=outputs,
        **options,
    )
    solver.namespace = p_
    solver.T = T
    solver.n_states = nX
    solver.n_controls = nU
    return solver


def default_params(T=30, namespace=""):
    """Physical parameters of the reference script."""
    p_ = namespace
    return {
        p_ + "Ts": 0.1,
        p_ + "p": -2.0,
        p_ + "k": 1.0,
        p_ + "min_x": np.array([[-0.4], [-0.3]]),
        p_ + "max_x": np.array([[0.4], [0.3]]),
        p_ + "min_u": np.array([[-1.0]]),
        p_ + "max_u": np.array([[1.0]]),
        p_ + "lambda_u": 1.0 / 50.0,
    }


def reference_signal(t):
    """ref(t) = -.35*sign(sin(.5 t))."""
    return -0.35 * np.sign(np.sin(0.5 * np.asarray(t)))


def fleet_inputs(T, B, namespace="", seed=0):
    """Inputs of a fleet of B solves built as the JAX package's
    ``bench.py`` builds them: shared plant parameters, a per-instance
    reference trajectory and initial state, from numpy seed ``seed``.
    Returns (params, inits) as numpy arrays."""
    ns = namespace
    rng = np.random.default_rng(seed)
    params = {k: np.asarray(v, float) for k, v in default_params(T, ns).items()}
    Ts = params[ns + "Ts"]
    params[ns + "ref"] = np.stack(
        [reference_signal(t0 + np.arange(T) * Ts)[None, :]
         for t0 in np.linspace(0.0, 6.0, B)]
    )
    params[ns + "xinit"] = rng.uniform(-0.15, 0.15, (B, 2, 1))
    inits = {
        ns + "x": params[ns + "xinit"] + 0.01 * rng.random((B, 2, T)),
        ns + "u": 0.01 * rng.random((B, 1, T - 1)),
    }
    return params, inits
