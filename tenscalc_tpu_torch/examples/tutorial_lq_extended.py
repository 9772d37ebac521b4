"""Extended linear-quadratic tutorial (the JAX package's
``examples/tutorial_lq_extended.py``, the reference's
tutorialLQextended.m) on the PyTorch port.

The stateful compute object (csparse declareSet / declareGet /
declareCopy): the control ``u`` is a state variable of the object; the
Newton step is declared through two factorizations (a pivoted LU,
``mldivide``, and a Cholesky solve, h = B'B + I being positive
definite), and named copies write each optimizer back into ``u``, so
that a later ``get`` of (J, g, h) sees the new state.
"""

from __future__ import annotations

import numpy as np
import torch

import tenscalc_tpu_torch as tc
from tenscalc_tpu_torch.expr import lift
from tenscalc_tpu_torch.ops.fns import mldivide


def build(N=100, n=2, k=10, ns="lqe_", device=None):
    A = tc.variable(ns + "A", (N, n))
    x0 = tc.variable(ns + "x0", (n,))
    B = tc.variable(ns + "B", (N, k))
    u = tc.variable(ns + "u", (k,))

    x = A @ x0 + B @ u
    J = tc.norm2(x) + tc.norm2(u)
    g = tc.gradient(J, u)
    h = tc.gradient(g, u)

    ustar1 = u - mldivide(h, g)
    chol_solve = lift(
        lambda hh, gg: torch.cholesky_solve(gg[:, None], torch.linalg.cholesky(hh))[:, 0]
    )
    ustar2 = u - chol_solve(h, g)

    obj = tc.compute_object(
        inputs=[A, x0, B],
        outputs={"Jgh": {"J": J, "g": g, "h": h}, "ustar1": ustar1, "ustar2": ustar2},
        state={u: np.zeros(k)},
        updates={"ustar1_to_u": {u: ustar1}, "ustar2_to_u": {u: ustar2}},
        device=device,
    )
    return obj, ns


def main(seed=0, verbose=True, device=None):
    N, n, k = 100, 2, 10
    obj, ns = build(N, n, k, device=device)
    rng = np.random.default_rng(seed)
    A = rng.random((N, n))
    x0 = rng.random(n)
    B = rng.random((N, k))
    obj.set(ns + "A", A)
    obj.set(ns + "x0", x0)
    obj.set(ns + "B", B)

    J0 = float(obj.get("Jgh")["J"])
    if verbose:
        print(f"cost for u=0 is {J0:.6f}")

    # route 1: the LU Newton step, copied into the state
    obj.copy("ustar1_to_u")
    J1 = float(obj.get("Jgh")["J"])

    # reset, then route 2 (Cholesky)
    obj.set(ns + "u", np.zeros(k))
    obj.copy("ustar2_to_u")
    J2 = float(obj.get("Jgh")["J"])
    u2 = obj.value(ns + "u").cpu().numpy()

    # closed form: u* = -(B'B + I)^-1 B'A x0
    H = B.T @ B + np.eye(k)
    ustar = -np.linalg.solve(H, B.T @ (A @ x0))
    if verbose:
        print(f"cost for optimal u is {J1:.6f} (LU) / {J2:.6f} (chol)")
    return dict(J0=J0, J1=J1, J2=J2, u2=u2, ustar=ustar)


if __name__ == "__main__":
    main()
