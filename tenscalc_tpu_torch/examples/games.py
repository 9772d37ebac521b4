"""Matrix-game saddle points over mixed strategies, written for the
PyTorch port (the JAX package's ``examples/games.py`` builds the same
game, after the reference's examples/TCgames.m).

Zero-sum game J = u' A d with u, d on probability simplices, solved as
a two-player equilibrium (mixed-policy constraints sum == 1, >= 0)."""

from __future__ import annotations

import numpy as np

import tenscalc_tpu_torch as tc


def build_matrix_game(N1=50, N2=20, ns="game_", **options):
    """``options`` go to :func:`tenscalc_tpu_torch.equilibrium`
    (``device``, ``dtype``, ``kkt_backend``, ...)."""
    A1 = tc.variable(ns + "A1", (N1, N2))
    u = tc.variable(ns + "u", (N1,))
    d = tc.variable(ns + "d", (N2,))
    J1 = tc.tprod(u, [-1], A1 @ d, [-1])  # u' A1 d
    return tc.equilibrium(
        P1objective=J1,
        P2objective=-J1,
        P1optimizationVariables=[u],
        P2optimizationVariables=[d],
        P1constraints=[u.sum() == 1.0, u >= 0.0],
        P2constraints=[d.sum() == 1.0, d >= 0.0],
        parameters=[A1],
        outputExpressions={"u": u, "d": d, "J": J1},
        **options,
    )


def game_value_lp(A: np.ndarray) -> float:
    """LP oracle for the value of the zero-sum matrix game min_u max_d
    u'Ad (u is the minimizer over rows)."""
    from scipy.optimize import linprog

    N1, N2 = A.shape
    # min v s.t. A' u <= v, sum u = 1, u >= 0
    cvec = np.zeros(N1 + 1)
    cvec[-1] = 1.0
    A_ub = np.hstack([A.T, -np.ones((N2, 1))])
    b_ub = np.zeros(N2)
    A_eq = np.hstack([np.ones((1, N1)), np.zeros((1, 1))])
    b_eq = np.array([1.0])
    bounds = [(0, None)] * N1 + [(None, None)]
    res = linprog(cvec, A_ub=A_ub, b_ub=b_ub, A_eq=A_eq, b_eq=b_eq, bounds=bounds)
    if not res.success:
        raise RuntimeError(f"the LP oracle failed: {res.message}")
    return float(res.fun)


if __name__ == "__main__":
    N1, N2 = 50, 20
    solver = build_matrix_game(N1, N2)
    rng = np.random.default_rng(0)
    A = rng.random((N1, N2))
    sol = solver.solve(
        {"game_A1": A},
        init={"game_u": np.full(N1, 1 / N1), "game_d": np.full(N2, 1 / N2)},
        mu0=0.1,
        max_iter=200,
    )
    print(sol.describe(), "iters:", sol.iters)
    print("game value (IPM):", sol.outputs["J"], " (LP):", game_value_lp(A))
