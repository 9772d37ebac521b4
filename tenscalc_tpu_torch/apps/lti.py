"""LTI-MPC convenience builders (port of ``tenscalc_tpu/apps/lti.py``):
analogs of lib/TltiConstraints.m and lib/TvariablesMPC.m, the
reference's helpers for assembling MPC optimizations by hand, below the
full Tmpc object.  They build expressions only; the solver that takes
them runs where its ``device`` says.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np

from ..expr import Expr, concat, to_expr, variable


def lti_constraints(
    A,
    B,
    C=None,
    D=None,
    G=None,
    H=None,
    *,
    x0,
    x: Expr,
    u: Expr,
    Ty: Optional[int] = None,
    Tz: Optional[int] = None,
):
    """Constraints and outputs for a discrete-time LTI system
    (reference: lib/TltiConstraints.m:1-75).

    ``x`` is the (nx, Tu) state trajectory variable holding
    x(1)..x(Tu); ``u`` the (nu, Tu) inputs u(0)..u(Tu-1); ``x0`` the
    initial state (nx, 1).  Returns ``(stateConstraints, y, z)``:

    * stateConstraints — ``x(t+1) == A x(t) + B u(t)`` for t = 0..Tu-1;
    * y — measured outputs ``C x(t) + D u(t)`` for t = 0..Ty-1
      (None when C is None);
    * z — controlled outputs ``G x(t) + H u(t)`` for t = 0..Tz-1
      (None when G is None).

    A, B, C, D, G, H, x0 may be numeric arrays or Exprs (parameters).
    """
    A = to_expr(A)
    B = to_expr(B)
    x0 = to_expr(x0)
    nx, nu = B.shape
    Tu = u.shape[1]
    if x.shape != (nx, Tu):
        raise ValueError(
            f"x must have shape ({nx}, {Tu}) = (nx, Tu); got {x.shape}"
        )
    if x0.shape != (nx, 1):
        raise ValueError(f"x0 must have shape ({nx}, 1); got {x0.shape}")

    # [x0, x(:, 1:Tu-1)] — states at times 0..Tu-1
    x_past = concat([x0, x[:, : Tu - 1]], axis=1)
    state_constraints = x == A @ x_past + B @ u

    y = None
    if C is not None:
        C = to_expr(C)
        D = to_expr(D if D is not None else np.zeros((C.shape[0], nu)))
        Ty = Tu if Ty is None else Ty
        y = C @ concat([x0, x[:, : Ty - 1]], axis=1) + D @ u[:, :Ty]

    z = None
    if G is not None:
        G = to_expr(G)
        H = to_expr(H if H is not None else np.zeros((G.shape[0], nu)))
        Tz = Tu if Tz is None else Tz
        z = G @ concat([x0, x[:, : Tz - 1]], axis=1) + H @ u[:, :Tz]

    return state_constraints, y, z


def variables_mpc(
    nX: int,
    nU: int,
    T: int,
    delay: int,
    fun: Callable,
    *fun_params,
    namespace: str = "",
):
    """Create the key variables for an MPC solver plus the trapezoidal
    dynamics constraint (reference: lib/TvariablesMPC.m:1-60).

    ``fun(x, u, *fun_params)`` is the continuous-time state derivative
    evaluated columnwise on (nX, T) states and (nU, T) inputs (ZOH
    inputs).  Returns ``(Ts, xMeas, xFut, uPast, uFut, dynamics)``;
    ``uPast`` is None when delay == 0.  Variable names are
    ``namespace + {Ts, xMeas, xFut, uPast, uFut}`` — the names matter
    when passing parameters/initial values to the solver, exactly as
    the reference warns for its setV_/setP_ functions.
    """
    if not 0 <= delay < T:
        raise ValueError(f"delay must be in [0, T); got {delay}")
    ns = namespace
    Ts = variable(ns + "Ts", ())
    xMeas = variable(ns + "xMeas", (nX, 1))
    xFut = variable(ns + "xFut", (nX, T))
    uPast = variable(ns + "uPast", (nU, delay)) if delay > 0 else None
    uFut = variable(ns + "uFut", (nU, T - delay))

    xPast = concat([xMeas, xFut[:, : T - 1]], axis=1)
    uAll = concat([uPast, uFut], axis=1) if delay > 0 else uFut
    # trapezoidal integration with ZOH inputs (TvariablesMPC.m:57-58)
    dynamics = xFut - xPast == 0.5 * Ts * (
        fun(xFut, uAll, *fun_params) + fun(xPast, uAll, *fun_params)
    )
    return Ts, xMeas, xFut, uPast, uFut, dynamics
