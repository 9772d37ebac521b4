"""Distance from a point to a convex hull, written for the PyTorch port
(the JAX package's ``examples/dist2convex.py`` builds the same problem,
after the reference's examples/dist2convex.m).

min ||A x - b||^2 over the simplex {x >= 0, sum x = 1}: the distance
from b to the convex hull of the columns of A."""

from __future__ import annotations

import numpy as np

import tenscalc_tpu_torch as tc


def build_solver(N=100, d=9, ns="d2c_", **options):
    """``options`` go to :func:`tenscalc_tpu_torch.optimize` (``device``,
    ``dtype``, ...)."""
    A = tc.variable(ns + "A", (d, N))
    b = tc.variable(ns + "b", (d,))
    x = tc.variable(ns + "x", (N,))
    J = tc.norm2(A @ x - b)
    return tc.optimize(
        objective=J,
        optimizationVariables=[x],
        constraints=[x.sum() == 1.0, x >= 0.0],
        parameters=[A, b],
        outputExpressions={"J": J, "x": x},
        **options,
    )


if __name__ == "__main__":
    N, d = 100, 9
    solver = build_solver(N, d)
    rng = np.random.default_rng(0)
    A = rng.standard_normal((d, N))
    b = 2 * rng.standard_normal(d)
    sol = solver.solve({"d2c_A": A, "d2c_b": b}, init={"d2c_x": np.full(N, 1 / N)}, mu0=0.1)
    print(sol.describe(), "iters:", sol.iters, "dist^2:", sol.outputs["J"])
