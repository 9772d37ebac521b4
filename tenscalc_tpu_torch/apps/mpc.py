"""Receding-horizon MPC controller object (port of
``tenscalc_tpu/apps/mpc.py``), the analog of lib/Tmpc.m.

Builds an optimize() solver once from a continuous-time state-derivative
function (dynamics discretized by forward Euler, Tmpc.m:404-421), keeps a
history ring buffer (Tmpc.m:49-76), supports control delay (the first
``control_delay`` controls become parameters, Tmpc.m:376-395), shift
warm starts via nominal forward simulation (setSolverWarmStart,
Tmpc.m:599-664), and integrates the real plant with RK23 between MPC
steps (applyControls, Tmpc.m:707-770 uses ode23).

The solver runs on the card unless ``device='cpu'``; ``kkt_backend='auto'``
resolves by the size of the condensed KKT: the fleet banded LDL^T (K1/K2)
from 64 rows with a band worth planning, else the fleet dense LDL^T
(K8/K7 for one solve).  Values the caller sets and the results stay
numpy arrays, as in the JAX package.
"""

from __future__ import annotations

from typing import Callable, Mapping, Optional, Sequence

import numpy as np

from ..expr import Constraint, Expr, Variable, concat, substitute, variable
from ..ipm.options import SolverOptions


class MpcSolution:
    """Result of one MPC solve (Tmpc.m solve outputs)."""

    def __init__(self, control, state, objective, status, iters, time, outputs):
        self.control = control
        self.state = state
        self.objective = objective
        self.status = status
        self.iter = iters
        self.time = time
        self.outputs = outputs


class Mpc:
    def __init__(
        self,
        *,
        objective: Expr,
        control_variable: Variable,
        state_variable: Variable,
        state_derivative: Callable,
        sample_time,
        parameters: Sequence[Variable] = (),
        constraints: Sequence[Constraint] = (),
        output_expressions: Optional[Mapping[str, Expr]] = None,
        control_delay: int = 0,
        other_optimization_variables: Sequence[Variable] = (),
        options: Optional[SolverOptions] = None,
        device=None,
        **option_kwargs,
    ):
        """``state_variable`` is [x(t+Ts) ... x(t+T Ts)] (nX, T);
        ``control_variable`` is [u(t) ... u(t+(T-1)Ts)] (nU, T);
        ``state_derivative(x, u, *parameters)`` returns dot-x and must
        work on both Exprs and numpy arrays (as in the reference's
        anonymous-function contract, Tmpc.m:225-234): it is called on
        Exprs once here, to build the dynamics, and on numpy arrays
        (the parameters' values) by ``set_solver_warm_start`` and, inside
        scipy's RK23, by ``apply_controls``.  ``options`` and
        ``option_kwargs`` go to :func:`tenscalc_tpu_torch.optimize`, with
        ``device`` (the card when None)."""
        from ..api import optimize

        self.nX, self.T = state_variable.shape
        self.nU, Tc = control_variable.shape
        if Tc != self.T:
            raise ValueError(
                f"control horizon {Tc} must equal state horizon {self.T}"
            )
        if not (0 <= control_delay < self.T):
            raise ValueError("control_delay must be in [0, horizon)")
        self.control_delay = control_delay
        self.state_derivative = state_derivative
        self.parameters = list(parameters)
        self.param_exprs = list(parameters)

        # sample time: numeric, or a symbolic parameter (Tmpc.m:310-341)
        if isinstance(sample_time, Variable):
            if sample_time.name not in {p.name for p in self.parameters}:
                raise ValueError(
                    "symbolic sample_time must be one of the parameters"
                )
            self.sample_time_name = sample_time.name
            self.sample_time_value = None
            Ts = sample_time
        else:
            self.sample_time_name = None
            self.sample_time_value = float(sample_time)
            Ts = float(sample_time)

        # current state parameter and delayed-control split
        self.state_name = state_variable.name
        current_state = variable(self.state_name + "_initial", (self.nX, 1))
        self.current_state_name = current_state.name
        this_state = concat([current_state, state_variable[:, :-1]], axis=1)

        constraints = list(constraints)
        output_expressions = dict(output_expressions or {})
        if control_delay > 0:
            delayed = variable(
                control_variable.name + "_delayed", (self.nU, control_delay)
            )
            optimized = variable(
                control_variable.name + "_optimized",
                (self.nU, self.T - control_delay),
            )
            this_control = concat([delayed, optimized], axis=1)
            objective = substitute(objective, control_variable, this_control)
            constraints = [
                Constraint(c.kind, substitute(c.expr, control_variable, this_control))
                for c in constraints
            ]
            output_expressions = {
                k: substitute(e, control_variable, this_control)
                for k, e in output_expressions.items()
            }
            self.parameters.append(delayed)
            self.delayed_control_name = delayed.name
            self.optimized_controls = optimized
        else:
            this_control = control_variable
            self.delayed_control_name = None
            self.optimized_controls = control_variable
        self.future_control_name = self.optimized_controls.name
        self.parameters.append(current_state)

        # forward-Euler dynamics constraint (Tmpc.m:415-421)
        dynamics = state_variable == this_state + Ts * state_derivative(
            this_state, this_control, *self.param_exprs
        )
        constraints.append(dynamics)

        self.objective = objective
        self._user_outputs = list(output_expressions.keys())
        output_expressions = {
            **output_expressions,
            "_control": self.optimized_controls,
            "_state": state_variable,
            "_objective": objective,
        }

        self.solver = optimize(
            objective=objective,
            optimizationVariables=[self.optimized_controls, state_variable]
            + list(other_optimization_variables),
            constraints=constraints,
            parameters=self.parameters,
            outputExpressions=output_expressions,
            options=options,
            device=device,
            **option_kwargs,
        )

        self._param_values: dict = {}
        self._init_values: dict = {}
        self._state_set = False
        self._control_set = False
        self.history = {
            "time": [], "state": [], "control": [], "objective": [],
            "status": [], "iter": [], "stime": [],
        }

    # ------------------------------------------------------------------
    def set_parameter(self, name: str, value) -> None:
        """(Tmpc.m:509-541 setParameter)"""
        names = {p.name for p in self.parameters}
        if name not in names:
            raise ValueError(f"unknown parameter {name!r}")
        self._param_values[name] = np.asarray(value, float)
        if name == self.sample_time_name:
            self.sample_time_value = float(value)

    def set_initial_state(self, tinit: float, xinit, uinit=None) -> None:
        """(Tmpc.m:570-597 setInitialState)"""
        xinit = np.asarray(xinit, float).reshape(self.nX, 1)
        if uinit is None:
            uinit = np.zeros((self.nU, self.control_delay))
        uinit = np.asarray(uinit, float).reshape(self.nU, self.control_delay)
        self.history["time"] = [float(tinit)]
        self.history["state"] = [xinit[:, 0].copy()]
        self.history["control"] = [uinit[:, k].copy() for k in range(self.control_delay)]
        self.history["objective"] = []
        self.history["status"] = []
        self.history["iter"] = []
        self.history["stime"] = []

    def _user_param_values(self):
        return [
            self._param_values[p.name]
            for p in self.param_exprs
            if p.name in self._param_values
        ]

    def set_solver_warm_start(self, control) -> np.ndarray:
        """Forward-Euler nominal rollout from the current state; primes
        the solver's primal initialization (Tmpc.m:599-664).  Returns
        the state trajectory [x(t) ... x(t+T Ts)] (nX, T+1).
        ATTENTION (as in the reference): does not enforce state
        constraints — move the result away from them if needed and pass
        it via set_solver_state_start."""
        control = np.asarray(control, float).reshape(
            self.nU, self.T - self.control_delay
        )
        if not self.history["time"]:
            raise ValueError("must call set_initial_state first")
        if self.control_delay > 0:
            past = np.stack(self.history["control"][-self.control_delay:], axis=1)
            control_full = np.concatenate([past, control], axis=1)
        else:
            control_full = control
        state = np.empty((self.nX, self.T + 1))
        state[:, 0] = self.history["state"][-1]
        args = self._user_param_values()
        for k in range(self.T):
            state[:, k + 1] = state[:, k] + self.sample_time_value * np.asarray(
                self.state_derivative(
                    state[:, k : k + 1], control_full[:, k : k + 1], *args
                )
            ).reshape(self.nX)
        self._param_values[self.current_state_name] = state[:, 0:1]
        if self.control_delay > 0:
            self._param_values[self.delayed_control_name] = control_full[
                :, : self.control_delay
            ]
        self._init_values[self.state_name] = state[:, 1:]
        self._init_values[self.future_control_name] = control
        self._state_set = True
        self._control_set = True
        return state

    def set_solver_state_start(self, state) -> None:
        """Override the state warm start (Tmpc.m:555-567)."""
        state = np.asarray(state, float)
        if state.shape == (self.nX, self.T + 1):
            state = state[:, 1:]
        self._init_values[self.state_name] = state.reshape(self.nX, self.T)
        self._state_set = True

    def set_solver_input_start(self, control) -> None:
        self._init_values[self.future_control_name] = np.asarray(
            control, float
        ).reshape(self.nU, self.T - self.control_delay)
        self._control_set = True

    # ------------------------------------------------------------------
    def solve(self, mu0: float = 1.0, max_iter: int = 200,
              addEye2Hessian=(1e-9, 1e-9)) -> MpcSolution:
        """(Tmpc.m:667-705)"""
        missing = {p.name for p in self.parameters} - set(self._param_values)
        if missing:
            raise ValueError(f"parameters not set: {sorted(missing)}")
        if not self._state_set or not self._control_set:
            raise ValueError(
                "must call set_solver_warm_start (or the *_start setters) "
                "before solve"
            )
        sol = self.solver.solve(
            self._param_values,
            init=self._init_values,
            mu0=mu0,
            max_iter=max_iter,
            addEye2Hessian=addEye2Hessian,
        )
        outputs = {k: sol.outputs[k] for k in self._user_outputs}
        return MpcSolution(
            control=np.asarray(sol.outputs["_control"]),
            state=np.asarray(sol.outputs["_state"]),
            objective=float(sol.outputs["_objective"]),
            status=sol.status,
            iters=sol.iters,
            time=sol.time,
            outputs=outputs,
        )

    def apply_controls(self, solution: MpcSolution, u_final=None,
                       real_state_derivative: Optional[Callable] = None):
        """Apply the first control, integrate the real plant with RK23
        over one sample period, append history, and return
        (t_next, u0_warm, u_applied) (Tmpc.m:707-770)."""
        from scipy.integrate import solve_ivp

        if real_state_derivative is None:
            real_state_derivative = self.state_derivative
        if u_final is None:
            u_final = np.zeros((self.nU, 1))
        u_final = np.asarray(u_final, float).reshape(self.nU, 1)

        t = self.history["time"][-1]
        u_applied = solution.control[:, 0:1]
        args = self._user_param_values()
        ivp = solve_ivp(
            lambda _t, x: np.asarray(
                real_state_derivative(
                    x.reshape(self.nX, 1), u_applied, *args
                )
            ).reshape(self.nX),
            (t, t + self.sample_time_value),
            self.history["state"][-1],
            method="RK23",
        )
        self.history["time"].append(t + self.sample_time_value)
        self.history["state"].append(ivp.y[:, -1])
        self.history["control"].append(u_applied[:, 0])
        self.history["objective"].append(solution.objective)
        self.history["status"].append(solution.status)
        self.history["iter"].append(solution.iter)
        self.history["stime"].append(solution.time)

        u0_warm = np.concatenate([solution.control[:, 1:], u_final], axis=1)
        self._state_set = False
        self._control_set = False
        return t + self.sample_time_value, u0_warm, u_applied

    def get_history(self):
        """(Tmpc.m:772-792 getHistory)"""
        return {
            "t": np.asarray(self.history["time"]),
            "x": np.stack(self.history["state"], axis=1)
            if self.history["state"] else np.zeros((self.nX, 0)),
            "u": np.stack(self.history["control"], axis=1)
            if self.history["control"] else np.zeros((self.nU, 0)),
            "objective": np.asarray(self.history["objective"]),
            "status": np.asarray(self.history["status"]),
            "iter": np.asarray(self.history["iter"]),
            "stime": np.asarray(self.history["stime"]),
        }
