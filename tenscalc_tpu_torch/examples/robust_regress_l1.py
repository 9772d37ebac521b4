"""Robust regression with l1 regularization, written for the PyTorch port
(the JAX package's ``examples/robust_regress_l1.py`` builds the same
problem, after the reference's examples/robustRegressL1.m).

min over (theta0, theta, absTheta) of
    sqrt(||y - theta0 - H theta||^2) + lambda * sum(absTheta)
s.t. absTheta > theta, absTheta > -theta
with cost scaling (scaleCost=1) as in the reference."""

from __future__ import annotations

import numpy as np

import tenscalc_tpu_torch as tc
from tenscalc_tpu_torch.ops.fns import sqrt as tsqrt


def build_solver(m=1000, n=15, ns="rr_", **options):
    """``options`` go to :func:`tenscalc_tpu_torch.optimize` (``device``,
    ``dtype``, ...)."""
    lam = tc.variable(ns + "lambda", ())
    theta0 = tc.variable(ns + "theta0", ())
    theta = tc.variable(ns + "theta", (n,))
    absTheta = tc.variable(ns + "absTheta", (n,))
    y = tc.variable(ns + "y", (m,))
    H = tc.variable(ns + "H", (m, n))

    v2 = tc.norm2(y - theta0 * tc.Tones(m) - H @ theta)
    J = tsqrt(v2) + lam * absTheta.sum()
    return tc.optimize(
        objective=J,
        optimizationVariables=[theta0, theta, absTheta],
        constraints=[absTheta >= theta, absTheta >= -theta],
        parameters=[lam, y, H],
        outputExpressions={"theta": theta, "theta0": theta0, "J": J},
        scaleCost=1.0,
        **options,
    )


def make_data(m=1000, n=15, seed=0):
    """(theta, theta0, H, y): sparse true coefficients, Gaussian
    regressors and noise, from numpy seed ``seed``."""
    rng = np.random.default_rng(seed)
    theta = rng.standard_normal(n)
    theta[rng.random(n) < 0.5] = 0.0
    theta0 = rng.standard_normal()
    H = rng.standard_normal((m, n))
    y = theta0 + H @ theta + 0.2 * rng.standard_normal(m)
    return theta, theta0, H, y


if __name__ == "__main__":
    m, n = 1000, 15
    solver = build_solver(m, n)
    th, th0, H, y = make_data(m, n)
    sol = solver.solve(
        {"rr_lambda": 10.0, "rr_y": y, "rr_H": H},
        init={"rr_theta0": 0.0, "rr_theta": np.zeros(n), "rr_absTheta": np.ones(n)},
        mu0=1.0,
    )
    print(sol.describe(), "iters:", sol.iters)
    print("theta err:", np.abs(sol.outputs["theta"] - th).max())
