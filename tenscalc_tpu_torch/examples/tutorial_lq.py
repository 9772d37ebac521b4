"""Linear-quadratic tutorial (the JAX package's
``examples/tutorial_lq.py``, the reference's tutorialLQ.m) on the
PyTorch port.

Minimize J(u) = ||A x0 + B u||^2 + ||u||^2: the cost, its symbolic
gradient and Hessian (``tc.gradient``) and the closed-form Newton step
ustar = u - h \\ g are evaluated together by one compute function
(``tc.compute``), on the card unless ``device="cpu"``.
"""

from __future__ import annotations

import numpy as np

import tenscalc_tpu_torch as tc
from tenscalc_tpu_torch.ops.fns import mldivide


def build(N=100, n=2, k=10, ns="lq_", device=None):
    A = tc.variable(ns + "A", (N, n))
    x0 = tc.variable(ns + "x0", (n,))
    B = tc.variable(ns + "B", (N, k))
    u = tc.variable(ns + "u", (k,))

    x = A @ x0 + B @ u
    J = tc.norm2(x) + tc.norm2(u)

    g = tc.gradient(J, u)      # (k,)
    h = tc.gradient(g, u)      # (k, k), == tc.hessian(J, u)

    # the Newton step from u: the exact minimizer, J being quadratic
    ustar = u - mldivide(h, g)

    return tc.compute([A, x0, B, u], {"J": J, "g": g, "h": h, "ustar": ustar},
                      device=device)


def main(seed=0, device=None):
    N, n, k = 100, 2, 10
    fn = build(N, n, k, device=device)
    rng = np.random.default_rng(seed)
    A = rng.random((N, n))
    x0 = rng.random(n)
    B = rng.random((N, k))
    u = np.zeros(k)

    out = fn(lq_A=A, lq_x0=x0, lq_B=B, lq_u=u)
    ustar = out["ustar"].cpu().numpy()

    # oracle: the normal equations of the regularized least squares
    want = -np.linalg.solve(B.T @ B + np.eye(k), B.T @ A @ x0)
    err = np.abs(ustar - want).max()
    out2 = fn(lq_A=A, lq_x0=x0, lq_B=B, lq_u=ustar)
    print(f"J(0)={float(out['J']):.6f}  J(ustar)={float(out2['J']):.6f}")
    print(f"||ustar - closed form||_inf = {err:.2e}")
    assert err < 1e-5, err
    assert float(out2["J"]) < float(out["J"])
    # at the optimum the gradient vanishes
    assert out2["g"].abs().max().item() < 1e-4
    return ustar


if __name__ == "__main__":
    main()
