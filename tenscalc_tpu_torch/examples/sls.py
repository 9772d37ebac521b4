"""Least squares, min ||A x - b||^2 / N, in the reference's sls
formulations (its examples/sls.m, and the JAX package's
``examples/sls.py``) written for the PyTorch port: direct
(``build_unconstrained``, no constraint: the full-step branch), with a
slack variable (``build_slack``), and constrained, lo <= x <= hi
(``build_constrained``, the reference's timed benchmark).

At N = 400, n = 32 the condensed KKT has nK = 32 rows, so
``kkt_backend='auto'`` resolves to the fleet dense LDL^T: K8/K7 for one
solve, K4/K5 for a fleet.  At n = 80 the KKT is a dense 80 x 80 with no
band worth planning, the unbanded route.  The benchmark protocol
(``bench.py:263-336``) solves with mu0 = 1 and at most 30 iterations
from ``default_data()["x0"]``, then again from that optimum (the warm
second call the reference times); a fleet gives every instance its own
A and b (``fleet_inputs``).
"""

from __future__ import annotations

import numpy as np

import tenscalc_tpu_torch as tc


def build_unconstrained(N=400, n=32, ns="sls_", **options):
    """min ||A x - b||^2 / N over x, A (N, n) and b (N,) parameters."""
    A = tc.variable(ns + "A", (N, n))
    b = tc.variable(ns + "b", (N,))
    x = tc.variable(ns + "x", (n,))
    J = tc.norm2(A @ x - b) / N
    return tc.optimize(
        objective=J,
        optimizationVariables=[x],
        parameters=[A, b],
        outputExpressions={"J": J, "x": x},
        **options,
    )


def build_slack(N=400, n=32, ns="slsv_", **options):
    """min v s.t. v >= ||A x - b||^2 / N (sls.m:86-124)."""
    A = tc.variable(ns + "A", (N, n))
    b = tc.variable(ns + "b", (N,))
    x = tc.variable(ns + "x", (n,))
    v = tc.variable(ns + "v", ())
    J = tc.norm2(A @ x - b) / N
    return tc.optimize(
        objective=v,
        optimizationVariables=[x, v],
        constraints=[v >= J],
        parameters=[A, b],
        outputExpressions={"J": J, "x": x},
        **options,
    )


def build_constrained(N=400, n=32, lo=0.0, hi=0.05, ns="slsc_", **options):
    """min ||A x - b||^2 / N s.t. lo <= x <= hi, A (N, n) and b (N,)
    parameters; ``options`` go to :func:`tenscalc_tpu_torch.optimize`
    (``device``, ``dtype``, ``kkt_backend``, ...)."""
    A = tc.variable(ns + "A", (N, n))
    b = tc.variable(ns + "b", (N,))
    x = tc.variable(ns + "x", (n,))
    J = tc.norm2(A @ x - b) / N
    return tc.optimize(
        objective=J,
        optimizationVariables=[x],
        constraints=[x >= lo, x <= hi],
        parameters=[A, b],
        outputExpressions={"J": J, "x": x},
        **options,
    )


def default_data(N=400, n=32, seed=0):
    """The JAX example's data: A, b uniform on [0, 1), x0 on [0, 0.002)."""
    rng = np.random.default_rng(seed)
    return {
        "A": rng.random((N, n)),
        "b": rng.random(N),
        "x0": 0.002 * rng.random(n),
    }


def fleet_inputs(B, N=400, n=32, seed=0):
    """Per-instance data of a fleet of B, drawn as :func:`default_data`
    draws one instance: A (B, N, n), b (B, N), x0 (B, n)."""
    rng = np.random.default_rng(seed)
    return {
        "A": rng.random((B, N, n)),
        "b": rng.random((B, N)),
        "x0": 0.002 * rng.random((B, n)),
    }
