"""Large equality-constrained least squares, the reference's slseq.m
(the JAX package's ``examples/slseq.py``) written for the PyTorch port:

    minimize ||A x - b||^2  s.t.  C x == d

at N = 10000, n = 800, m = 40: a dense 840 x 840 KKT with no inequality
(the full-step branch), which ``kkt_backend='auto'`` factors by K8 and
solves by K7 on the card."""

from __future__ import annotations

import numpy as np

import tenscalc_tpu_torch as tc


def build_solver(N=10000, n=800, m=40, ns="slq_", **options):
    A = tc.variable(ns + "A", (N, n))
    b = tc.variable(ns + "b", (N,))
    C = tc.variable(ns + "C", (m, n))
    d = tc.variable(ns + "d", (m,))
    x = tc.variable(ns + "x", (n,))
    J = tc.norm2(A @ x - b)
    return tc.optimize(
        objective=J,
        optimizationVariables=[x],
        constraints=[C @ x == d],
        parameters=[A, b, C, d],
        outputExpressions={"J": J, "x": x},
        **options,
    )


def default_data(N=10000, n=800, m=40, seed=0):
    """A, b, C, d uniform on [0, 1), normalized as slseq.m:29-35 does."""
    rng = np.random.default_rng(seed)
    A = rng.random((N, n))
    b = rng.random(N)
    C = rng.random((m, n))
    d = rng.random(m)
    s = np.linalg.norm(b)
    A, b = A / s, b / s
    s = np.linalg.norm(d)
    C, d = C / s, d / s
    return A, b, C, d


def kkt_oracle(A, b, C, d):
    """The closed-form solution, from the KKT system in float64."""
    n, m = A.shape[1], C.shape[0]
    K = np.block([[2 * A.T @ A, C.T], [C, np.zeros((m, m))]])
    rhs = np.concatenate([2 * A.T @ b, d])
    return np.linalg.solve(K, rhs)[:n]
