"""Constrained matrix least squares, written for the PyTorch port (the
JAX package's ``examples/mls.py`` builds the same problem, after the
reference's examples/mls.m): minimize ||A X - B||_F^2 / N, optionally
subject to 0 <= X <= .05.

At k = 1 it is the user guide's vector least squares, the two rows of
the JAX package's ``bench.py`` (N = 100, n = 8; ``bench_inputs``): the
condensed KKT has n rows, so ``kkt_backend='auto'`` resolves to the
fleet dense LDL^T, K8/K7 on the card for one solve.
"""

from __future__ import annotations

import numpy as np

import tenscalc_tpu_torch as tc


def build_solver(N=100, n=30, k=20, constrained=True, ns="", **options):
    """min ||A X - B||_F^2 / N over X (n, k), A (N, n) and B (N, k)
    parameters; ``ns`` prefixes the names; ``options`` go to
    :func:`tenscalc_tpu_torch.optimize` (``device``, ``dtype``, ...)."""
    A = tc.variable(ns + "A", (N, n))
    B = tc.variable(ns + "B", (N, k))
    X = tc.variable(ns + "X", (n, k))
    J = tc.norm2(A @ X - B) / N
    constraints = [X >= 0, X <= 0.05] if constrained else []
    return tc.optimize(
        objective=J,
        optimizationVariables=[X],
        constraints=constraints,
        parameters=[A, B],
        outputExpressions={"J": J, "X": X},
        **options,
    )


def default_data(N=100, n=30, k=20, seed=0):
    """The reference script's random data and init, from numpy seed
    ``seed`` (names without a prefix)."""
    rng = np.random.default_rng(seed)
    return {
        "params": {"A": rng.random((N, n)), "B": rng.random((N, k))},
        "init": {"X": 0.025 + 0.02 * rng.random((n, k))},
    }


def bench_inputs(N=100, n=8, ns=""):
    """(params, init) of bench.py's mls rows at k = 1: A and b uniform,
    x0 = 0.02 rand, from numpy seed 0 (solved with mu0 = 1 and at most
    20 iterations)."""
    rng = np.random.default_rng(0)
    A, b, x0 = rng.random((N, n)), rng.random(N), 0.02 * rng.random(n)
    return {ns + "A": A, ns + "B": b[:, None]}, {ns + "X": x0[:, None]}


if __name__ == "__main__":
    data = default_data()
    solver = build_solver()
    sol = solver.solve(data["params"], init=data["init"])
    print(sol.describe(), "iters:", sol.iters, "J*:", sol.outputs["J"])
