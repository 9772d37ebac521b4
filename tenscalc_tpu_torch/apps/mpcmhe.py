"""Coupled MPC + moving-horizon estimation as a Nash game (port of
``tenscalc_tpu/apps/mpcmhe.py``), the analog of lib/Tmpcmhe.m.

At time t the controller knows past outputs y(t-L Ts..t) and past
controls u(t-L Ts..t-Ts); it simultaneously estimates the past (initial
state + disturbances, chosen adversarially by player 2 maximizing J) and
plans future controls (player 1 minimizing J), with the full state
trajectory as the shared *latent* variable constrained by the
trapezoidally-integrated dynamics (Tmpcmhe.m:420-461).  Generated
through the equilibrium solver with P1objective=J, P2objective=-J
(Tmpcmhe.m:511-524).

The game runs on the card unless ``device='cpu'``; ``kkt_backend='auto'``
resolves as :func:`tenscalc_tpu_torch.equilibrium` resolves it: the
fleet banded LU (K9/K10) for a KKT of at least 64 rows with a band worth
planning, else the dense pivoted LU.  Values the caller sets and the
results stay numpy arrays, as in the JAX package."""

from __future__ import annotations

from typing import Callable, Mapping, Optional, Sequence

import numpy as np

from ..expr import Constraint, Expr, Variable, concat, substitute, variable
from ..ipm.options import SolverOptions


class MpcmheSolution:
    def __init__(self, control, disturbance, initial_state, state, objective,
                 status, iters, time, outputs):
        self.control = control
        self.disturbance = disturbance
        self.initial_state = initial_state
        self.state = state
        self.objective = objective
        self.status = status
        self.iter = iters
        self.time = time
        self.outputs = outputs


class Mpcmhe:
    def __init__(
        self,
        *,
        objective: Expr,
        state_variable: Variable,          # (nX, L+T+1): x(t-L Ts)..x(t+T Ts)
        past_output_variable: Variable,    # (nY, L+1):  y(t-L Ts)..y(t)
        past_control_variable: Variable,   # (nU, L):    u(t-L Ts)..u(t-Ts)
        future_control_variable: Variable, # (nU, T):    u(t)..u(t+(T-1)Ts)
        disturbance_variable: Variable,    # (nD, L+T):  d(t-L Ts)..d(t+(T-1)Ts)
        state_derivative: Callable,        # f(x, u, d, *params)
        output_function: Callable,         # g(x, *params) -> y
        sample_time: float,
        backward_horizon: int,
        forward_horizon: int,
        parameters: Sequence[Variable] = (),
        control_constraints: Sequence[Constraint] = (),
        disturbance_constraints: Sequence[Constraint] = (),
        output_expressions: Optional[Mapping[str, Expr]] = None,
        options: Optional[SolverOptions] = None,
        device=None,
        **option_kwargs,
    ):
        """``state_derivative(x, u, d, *parameters)`` and
        ``output_function(x, *parameters)`` must work on both Exprs and
        numpy arrays: ``state_derivative`` is called on Exprs here, to
        build the trapezoidal dynamics, and on numpy arrays by ``solve``'s
        nominal rollout when no state warm start is given.  ``options``
        and ``option_kwargs`` go to
        :func:`tenscalc_tpu_torch.equilibrium`, with ``device`` (the card
        when None)."""
        from ..api import equilibrium

        self.L = int(backward_horizon)
        self.T = int(forward_horizon)
        self.nX = state_variable.shape[0]
        self.nU = future_control_variable.shape[0]
        self.nD = disturbance_variable.shape[0]
        self.nY = past_output_variable.shape[0]
        self.Ts = float(sample_time)
        self.state_derivative = state_derivative
        self.output_function = output_function
        self.param_exprs = list(parameters)

        LT = self.L + self.T
        if state_variable.shape != (self.nX, LT + 1):
            raise ValueError(
                f"state_variable must be ({self.nX}, {LT + 1}), got {state_variable.shape}"
            )
        if disturbance_variable.shape != (self.nD, LT):
            raise ValueError("disturbance_variable must span L+T steps")

        # split the state: x(t-L Ts) is P2's variable, the rest is latent
        # (Tmpcmhe.m:420-437)
        initial_state = variable(state_variable.name + "_initial", (self.nX, 1))
        next_state = variable(state_variable.name + "_next", (self.nX, LT))
        all_state = concat([initial_state, next_state], axis=1)
        self.initial_state_name = initial_state.name
        self.latent_state_name = next_state.name
        self.state_name = state_variable.name
        self.future_control_name = future_control_variable.name
        self.past_control_name = past_control_variable.name
        self.past_output_name = past_output_variable.name
        self.disturbance_name = disturbance_variable.name

        def sub(e):
            return substitute(e, state_variable, all_state)

        objective = sub(objective)
        control_constraints = [
            Constraint(c.kind, sub(c.expr)) for c in control_constraints
        ]
        disturbance_constraints = [
            Constraint(c.kind, sub(c.expr)) for c in disturbance_constraints
        ]
        output_expressions = {
            k: sub(e) for k, e in (output_expressions or {}).items()
        }

        previous_state = concat([initial_state, next_state[:, :-1]], axis=1)
        previous_control = concat(
            [past_control_variable, future_control_variable], axis=1
        )

        # trapezoidal dynamics with ZOH inputs (Tmpcmhe.m:440-452)
        dynamics = (next_state - previous_state) == 0.5 * self.Ts * (
            state_derivative(
                previous_state, previous_control, disturbance_variable,
                *self.param_exprs,
            )
            + state_derivative(
                next_state, previous_control, disturbance_variable,
                *self.param_exprs,
            )
        )

        self.objective = objective
        self._user_outputs = list(output_expressions.keys())
        output_expressions = {
            **output_expressions,
            "_control": future_control_variable,
            "_disturbance": disturbance_variable,
            "_x0": initial_state,
            "_state": all_state,
            "_objective": objective,
        }

        self.parameters = list(parameters) + [
            past_output_variable, past_control_variable
        ]

        self.solver = equilibrium(
            P1objective=objective,
            P2objective=-objective,
            P1optimizationVariables=[future_control_variable],
            P2optimizationVariables=[disturbance_variable, initial_state],
            latentVariables=[next_state],
            P1constraints=control_constraints,
            P2constraints=disturbance_constraints,
            latentConstraints=[dynamics],
            parameters=self.parameters,
            outputExpressions=output_expressions,
            options=options,
            device=device,
            **option_kwargs,
        )

        self._param_values: dict = {}
        self.history = {
            "t": [], "x": [], "u": [], "y": [], "objective": [],
            "status": [], "iter": [], "stime": [],
        }

    # ------------------------------------------------------------------
    def set_parameter(self, name: str, value):
        self._param_values[name] = np.asarray(value, float)

    def _user_param_values(self):
        return [
            self._param_values[p.name]
            for p in self.param_exprs
            if p.name in self._param_values
        ]

    def solve(
        self,
        y_past,
        u_past,
        x_warm=None,
        u_warm=None,
        d_warm=None,
        x0_warm=None,
        mu0: float = 1.0,
        max_iter: int = 200,
    ) -> MpcmheSolution:
        """One MPC-MHE solve given the past window (Tmpcmhe.m:804-871)."""
        L, T, LT = self.L, self.T, self.L + self.T
        y_past = np.asarray(y_past, float).reshape(self.nY, L + 1)
        u_past = np.asarray(u_past, float).reshape(self.nU, L)
        params = dict(self._param_values)
        params[self.past_output_name] = y_past
        params[self.past_control_name] = u_past

        if u_warm is None:
            u_warm = np.zeros((self.nU, T))
        if d_warm is None:
            d_warm = np.zeros((self.nD, LT))
        if x0_warm is None:
            x0_warm = np.zeros((self.nX, 1))
        if x_warm is None:
            # nominal rollout from x0_warm under warm controls/disturbances
            x_warm = np.empty((self.nX, LT))
            xk = np.asarray(x0_warm, float).reshape(self.nX, 1)
            uc = np.concatenate([u_past, np.asarray(u_warm, float)], axis=1)
            args = self._user_param_values()
            for k in range(LT):
                dx = np.asarray(
                    self.state_derivative(
                        xk, uc[:, k : k + 1],
                        np.asarray(d_warm, float)[:, k : k + 1], *args
                    )
                ).reshape(self.nX, 1)
                xk = xk + self.Ts * dx
                x_warm[:, k] = xk[:, 0]

        init = {
            self.future_control_name: np.asarray(u_warm, float),
            self.disturbance_name: np.asarray(d_warm, float),
            self.initial_state_name: np.asarray(x0_warm, float).reshape(self.nX, 1),
            self.latent_state_name: np.asarray(x_warm, float),
        }
        sol = self.solver.solve(params, init=init, mu0=mu0, max_iter=max_iter)
        outputs = {k: sol.outputs[k] for k in self._user_outputs}
        return MpcmheSolution(
            control=np.asarray(sol.outputs["_control"]),
            disturbance=np.asarray(sol.outputs["_disturbance"]),
            initial_state=np.asarray(sol.outputs["_x0"]),
            state=np.asarray(sol.outputs["_state"]),
            objective=float(sol.outputs["_objective"]),
            status=sol.status,
            iters=sol.iters,
            time=sol.time,
            outputs=outputs,
        )

    def warm_start_shift(self, solution: MpcmheSolution):
        """Shift-by-one warm start for the next period (the pattern of
        Tmpcmhe.m:872-1040 applyControls): drop the oldest past sample,
        append a zero tail."""
        u_warm = np.concatenate(
            [solution.control[:, 1:], np.zeros((self.nU, 1))], axis=1
        )
        d_warm = np.concatenate(
            [solution.disturbance[:, 1:], np.zeros((self.nD, 1))], axis=1
        )
        x0_warm = solution.state[:, 1:2]
        x_warm = np.concatenate(
            [solution.state[:, 2:], solution.state[:, -1:]], axis=1
        )
        return u_warm, d_warm, x0_warm, x_warm
