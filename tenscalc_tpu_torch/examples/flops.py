"""Dense equality-constrained QP, the reference's flops.m (the JAX
package's ``examples/flops.py``) written for the PyTorch port:

    minimize ||A x - b||^2 + ||x||^2 over x in R^N  s.t.  C x == d

with C (N/2, N): no inequality, so every iteration takes the full step,
and a dense KKT of 1.5 N rows.  Under ``kkt_backend='auto'`` one solve
factors it by K8 and solves by K7 up to 896 rows (N <= 597), and by the
blocked LDL^T above.  ``default_data`` draws bench.py's data
(``bench.py:472-556``)."""

from __future__ import annotations

import numpy as np

import tenscalc_tpu_torch as tc


def build_solver(N, ns=None, **options):
    """The solver for size N and its namespace prefix; ``options`` go to
    :func:`tenscalc_tpu_torch.optimize`."""
    ns = ns or f"fl{N}_"
    A = tc.variable(ns + "A", (N, N))
    b = tc.variable(ns + "b", (N,))
    C = tc.variable(ns + "C", (N // 2, N))
    d = tc.variable(ns + "d", (N // 2,))
    x = tc.variable(ns + "x", (N,))
    J = tc.norm2(A @ x - b) + tc.norm2(x)
    return tc.optimize(
        objective=J,
        optimizationVariables=[x],
        constraints=[C @ x == d],
        parameters=[A, b, C, d],
        outputExpressions={"J": J, "x": x},
        **options,
    ), ns


def default_data(N, ns):
    """bench.py's parameters (``default_rng(0)``: A / sqrt(N), b, C /
    sqrt(N), 0.1 d) and its init x = 0."""
    rng = np.random.default_rng(0)
    params = {
        ns + "A": rng.standard_normal((N, N)) / np.sqrt(N),
        ns + "b": rng.standard_normal(N),
        ns + "C": rng.standard_normal((N // 2, N)) / np.sqrt(N),
        ns + "d": 0.1 * rng.standard_normal(N // 2),
    }
    return params, {ns + "x": np.zeros(N)}
