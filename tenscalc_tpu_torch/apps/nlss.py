"""Nonlinear state-space model container (port of
``tenscalc_tpu/apps/nlss.py``), the analog of lib/nlss.m.

Stores dynamics f and output map g for a discrete- or continuous-time
system, supports numeric simulation (numpy, and scipy's ``solve_ivp``
for continuous time) and symbolic (Expr) rollout for use inside
optimization problems (nlss.m:1-120).  ``f`` and ``g`` are called on
numpy arrays by ``simulate`` and on Exprs by ``dynamics_constraints``,
so they must work on both.  Nothing here solves, so nothing runs on the
card."""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np

from ..expr import Expr, Variable, variable


class NLSS:
    def __init__(
        self,
        f: Callable,
        g: Optional[Callable] = None,
        discrete: bool = True,
        state_name: str = "x",
        x0=None,
        t0: float = 0.0,
        n_states: Optional[int] = None,
        n_inputs: Optional[int] = None,
    ):
        """``f(x, u, t)`` is x_{k+1} (discrete) or dot-x (continuous);
        ``g(x, u, t)`` is the output map (default: full state)."""
        self.f = f
        self.g = g if g is not None else (lambda x, u, t: x)
        self.discrete = discrete
        self.state_name = state_name
        self.x0 = None if x0 is None else np.asarray(x0, float).ravel()
        self.t0 = t0
        self.n_states = n_states if n_states is not None else (
            len(self.x0) if self.x0 is not None else None
        )
        self.n_inputs = n_inputs

    def set_initial_state(self, x0, t0: float = 0.0):
        self.x0 = np.asarray(x0, float).ravel()
        self.t0 = t0
        if self.n_states is None:
            self.n_states = len(self.x0)

    # -- numeric simulation (nlss.m simulate) --------------------------
    def simulate(self, u, ts=None, x0=None, t0=None):
        """Simulate over an input sequence u [n_inputs, N].

        Discrete: x_{k+1} = f(x_k, u_k, k).  Continuous: integrates with
        RK23 over each sample interval (ZOH input).  Returns (x, y) with
        x [n_states, N+1] (trajectory incl. initial state) and
        y [n_outputs, N]."""
        u = np.atleast_2d(np.asarray(u, float))
        N = u.shape[1]
        x0 = self.x0 if x0 is None else np.asarray(x0, float).ravel()
        t0 = self.t0 if t0 is None else t0
        if x0 is None:
            raise ValueError("initial state not set")
        n = len(x0)
        xs = np.empty((n, N + 1))
        xs[:, 0] = x0
        ys = []
        if self.discrete:
            for k in range(N):
                t = t0 + k
                ys.append(np.asarray(self.g(xs[:, k], u[:, k], t)).ravel())
                xs[:, k + 1] = np.asarray(self.f(xs[:, k], u[:, k], t)).ravel()
        else:
            from scipy.integrate import solve_ivp

            if ts is None:
                raise ValueError("continuous-time simulation requires ts")
            for k in range(N):
                t = t0 + k * ts
                ys.append(np.asarray(self.g(xs[:, k], u[:, k], t)).ravel())
                ivp = solve_ivp(
                    lambda _t, x: np.asarray(self.f(x, u[:, k], _t)).ravel(),
                    (t, t + ts),
                    xs[:, k],
                    method="RK23",
                )
                xs[:, k + 1] = ivp.y[:, -1]
        return xs, np.stack(ys, axis=1) if ys else np.zeros((0, 0))

    # -- symbolic rollout (nlss.m symbolic simulation) ------------------
    def symbolic_state(self, horizon: int) -> Variable:
        """Declare the symbolic state trajectory variable [n, horizon]."""
        if self.n_states is None:
            raise ValueError("n_states unknown; set an initial state first")
        return variable(self.state_name, (self.n_states, horizon))

    def dynamics_constraints(self, x: Expr, u: Expr, ts=None):
        """Equality constraints encoding the dynamics along a trajectory:
        discrete x[:,k+1] == f(x[:,k], u[:,k]); continuous via forward
        Euler with step ts."""
        if self.discrete:
            return [x[:, 1:] == self.f(x[:, :-1], u, None)]
        if ts is None:
            raise ValueError("continuous-time constraints require ts")
        return [x[:, 1:] == x[:, :-1] + ts * self.f(x[:, :-1], u, None)]
