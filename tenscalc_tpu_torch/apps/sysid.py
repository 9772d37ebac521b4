"""Nonlinear system identification / state estimation over a horizon
(port of ``tenscalc_tpu/apps/sysid.py``), the analog of lib/@TCsysid
(TCsysid.m, createSolver.m, callSolver.m).

Given sampled inputs u_k and measurements y_k, jointly estimates model
parameters theta (with optional bounds and scaling, TCsysid parameter
tables) and the state trajectory, subject to the discrete-time dynamics
x_{k+1} = f(x_k, u_k, theta) (+ optional process noise), minimizing the
negative log joint of the Gaussian noise model (TCsysid.logNormal,
TCsysid.m:324-326):

    logNormal(e, w) = 0.5 log(2*pi) numel(e) - 0.5 numel(e) log(w)
                      + 0.5 w ||e||^2        (negative log pdf, w = 1/sigma^2)

Noise model knobs (mirroring addMeasurement / addDynamics,
TCsysid.m:480-640):

* ``noise_std``: measurement noise sigma.  ``0`` = plain least squares
  (legacy), ``sigma > 0`` = known variance, ``"estimate"`` = unknown —
  the inverse variance becomes an optimization variable with the
  -0.5 N log(w) likelihood term (nStochasticInputsUnknownVariance).
* ``disturbance_std``: process noise sigma.  ``0`` = hard equality
  dynamics (default), ``sigma > 0`` / ``"estimate"`` = soft dynamics
  with penalized disturbance v_k = x_{k+1} - f(x_k, u_k, theta).

Forecasting (addMeasurementForecast, TCsysid.m:542-565): output
predictions at requested time instants, with Laplace-approximation
confidence intervals — the Hessian H of the negative log joint over the
marginalized variables (states + forecast variables) gives
forecast variance = diag(H^{-1})_forecast and
``logMarginal = logJoint + 0.5 logdet(H) - 0.5 nH log(2*pi)``
(createSolver.m:93-167).

The fit runs on the card unless ``device='cpu'``.  The Laplace Hessians
of ``forecast`` and ``parameter_std`` are taken by ``torch.func.hessian``
in float64 on the solver's device, and inverted there by
``torch.linalg`` (the JAX package uses ``jax.hessian`` and
``jnp.linalg``).  The user's ``f(x, u, **theta)`` and ``g(x, **theta)``
are called on Exprs (to build the problem), on float64 torch tensors
(under ``torch.func.hessian``, and for ``forecast``'s mean) and on numpy
arrays (the reports' noise signals and outputs), so they must work on
all three: plain arithmetic does."""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..expr import Expr, Variable, variable
from ..ipm.options import SolverOptions
from ..ops.fns import norm2, log as tclog


@dataclasses.dataclass
class ParameterSpec:
    """One estimated parameter (TCsysid parameters table: bounds+scaling)."""

    name: str
    shape: Tuple[int, ...] = ()
    lower: Optional[float] = None
    upper: Optional[float] = None
    scale: float = 1.0
    prior: Optional[float] = None
    prior_weight: float = 0.0


_LOG2PI = float(np.log(2.0 * np.pi))


def _is_estimate(v) -> bool:
    return isinstance(v, str) and v == "estimate"


class Sysid:
    def __init__(
        self,
        f: Callable,   # f(x, u, **theta) -> next state, columnwise over time
        g: Callable,   # g(x, **theta) -> output, columnwise over time
        n_states: int,
        n_outputs: int,
        n_inputs: int,
        horizon: int,
        parameters: Sequence[ParameterSpec],
        name: str = "sysid",
        state_bounds: Optional[Tuple[float, float]] = None,
        noise_std: Union[float, str] = 0.0,
        disturbance_std: Union[float, str] = 0.0,
        forecast_instants: Optional[Sequence[int]] = None,
        options: Optional[SolverOptions] = None,
        device=None,
        **option_kwargs,
    ):
        """``options`` and ``option_kwargs`` go to
        :func:`tenscalc_tpu_torch.optimize`, with ``device`` (the card
        when None)."""
        from ..api import optimize

        self.nX, self.nY, self.nU, self.N = n_states, n_outputs, n_inputs, horizon
        self.specs = list(parameters)
        self._name = name
        self._f, self._g = f, g
        self.noise_std = noise_std
        self.disturbance_std = disturbance_std
        self.forecast_instants = (
            None if forecast_instants is None else np.asarray(forecast_instants, int)
        )
        if self.forecast_instants is not None and not self._soft_dynamics:
            raise ValueError(
                "forecast confidence intervals need a stochastic model: "
                "set disturbance_std > 0 or 'estimate' (the Laplace "
                "marginalization over states is singular under hard "
                "equality dynamics)"
            )

        x = variable(f"{name}_x", (n_states, horizon))
        u = variable(f"{name}_u", (n_inputs, horizon))
        y = variable(f"{name}_y", (n_outputs, horizon))
        self._xname, self._uname, self._yname = x.name, u.name, y.name

        theta_vars = {}
        constraints = []
        reg_terms = []
        for spec in self.specs:
            tv = variable(f"{name}_{spec.name}", spec.shape)
            theta_vars[spec.name] = tv
            if spec.lower is not None:
                constraints.append(tv >= spec.lower)
            if spec.upper is not None:
                constraints.append(tv <= spec.upper)
            if spec.prior is not None and spec.prior_weight > 0:
                reg_terms.append(spec.prior_weight * norm2(tv - spec.prior))
        self._theta_vars = theta_vars

        extra_vars = []
        nMeas = n_outputs * horizon
        noise = y - g(x, **theta_vars)

        # -- measurement noise term ------------------------------------
        if _is_estimate(noise_std):
            wY = variable(f"{name}_noiseInvVariance", ())
            extra_vars.append(wY)
            constraints.append(wY >= 1e-8)
            constraints.append(wY <= 1e12)
            J = 0.5 * wY * norm2(noise) - 0.5 * nMeas * tclog(wY)
            self._wY = wY.name
        elif noise_std and float(noise_std) > 0.0:
            wY = 1.0 / float(noise_std) ** 2
            J = 0.5 * wY * norm2(noise) - 0.5 * nMeas * float(np.log(wY))
            self._wY = wY
        else:
            # legacy plain least squares
            J = norm2(noise) / horizon
            self._wY = None

        # -- dynamics: hard equality or penalized disturbance ----------
        v = x[:, 1:] - f(x[:, :-1], u[:, :-1], **theta_vars)
        nDist = n_states * (horizon - 1)
        if _is_estimate(disturbance_std):
            wV = variable(f"{name}_disturbanceInvVariance", ())
            extra_vars.append(wV)
            constraints.append(wV >= 1e-8)
            constraints.append(wV <= 1e12)
            J = J + 0.5 * wV * norm2(v) - 0.5 * nDist * tclog(wV)
            self._wV = wV.name
        elif disturbance_std and float(disturbance_std) > 0.0:
            wV = 1.0 / float(disturbance_std) ** 2
            J = J + 0.5 * wV * norm2(v) - 0.5 * nDist * float(np.log(wV))
            self._wV = wV
        else:
            constraints.append(v == 0.0)
            self._wV = None

        if state_bounds is not None:
            lo, hi = state_bounds
            constraints += [x >= lo, x <= hi]
        for t in reg_terms:
            J = J + t

        outputs = {"J": J, "x": x}
        if self._probabilistic:
            # logJoint = negative log joint incl. the Gaussian constants
            # (createSolver.m:105-107 logJoint; constants from logNormal)
            nTot = nMeas + (nDist if self._soft_dynamics else 0)
            outputs["logJoint"] = J + 0.5 * _LOG2PI * nTot
        outputs.update(theta_vars)
        if _is_estimate(noise_std):
            # TCsysid.m:536 outputs 1/sqrt(noiseInvVariance)
            from ..ops.fns import sqrt as tcsqrt

            outputs["noiseStdDev"] = 1.0 / tcsqrt(wY)
        self._extra_names = [ev.name for ev in extra_vars]

        self.solver = optimize(
            objective=J,
            optimizationVariables=[x] + list(theta_vars.values()) + extra_vars,
            constraints=constraints,
            parameters=[u, y],
            outputExpressions=outputs,
            options=options,
            device=device,
            **option_kwargs,
        )

    # -- noise-model helpers -------------------------------------------
    @property
    def _soft_dynamics(self) -> bool:
        return _is_estimate(self.disturbance_std) or (
            not isinstance(self.disturbance_std, str)
            and float(self.disturbance_std) > 0.0
        )

    @property
    def _probabilistic(self) -> bool:
        return _is_estimate(self.noise_std) or (
            not isinstance(self.noise_std, str) and float(self.noise_std) > 0.0
        )

    def fit(
        self,
        u_seq,
        y_seq,
        theta0: Optional[Mapping[str, np.ndarray]] = None,
        x0=None,
        mu0: float = 1.0,
        max_iter: int = 300,
        restarts: int = 0,
    ):
        """Estimate (theta, x) from data.  ``x0`` defaults to a rough
        trajectory initialization from the measurements when g is the
        identity-like map, else zeros.

        ``restarts``: the joint (theta, x) estimation problem is
        bilinear, hence nonconvex — a bad parameter start can land the
        IPM in a basin where it stalls against a bound (the reference
        would stall identically: its curvature-driven addEye2Hessian
        loop, lib/ipmPD_CSsolver.c:458-530, has no global-search
        escape).  On failure, up to ``restarts`` additional solves run
        from deterministic pseudo-random parameter starts drawn inside
        the bounds; the first converged (or else best-objective) result
        is kept.

        As in the JAX package (``sysid.py:268``), when no attempt
        converges the attempt of least objective is kept, although the
        objectives of unconverged iterates need not be comparable: a
        restart that stalled deeper inside the infeasible region can
        displace a less bad first attempt.  The port keeps that choice."""
        u_seq = np.asarray(u_seq, float).reshape(self.nU, self.N)
        y_seq = np.asarray(y_seq, float).reshape(self.nY, self.N)
        init = {}
        if x0 is None:
            x0 = np.zeros((self.nX, self.N))
            x0[: min(self.nX, self.nY), :] = y_seq[: min(self.nX, self.nY), :]
        init[self._xname] = np.asarray(x0, float)
        theta0 = dict(theta0 or {})
        for spec in self.specs:
            v = theta0.get(spec.name)
            if v is None:
                lo = spec.lower if spec.lower is not None else 0.0
                hi = spec.upper if spec.upper is not None else lo + 1.0
                v = np.full(spec.shape, 0.5 * (lo + hi))
            init[f"{self._name}_{spec.name}"] = np.asarray(v, float)
        for nm in self._extra_names:
            init[nm] = np.asarray(1.0)

        def run(init_):
            return self.solver.solve(
                {self._uname: u_seq, self._yname: y_seq},
                init=init_,
                mu0=mu0,
                max_iter=max_iter,
            )

        sol = run(init)
        attempt = 0
        best = sol
        while sol.status != 0 and attempt < restarts:
            attempt += 1
            rs = np.random.default_rng(1234 + attempt)
            init_r = dict(init)
            for spec in self.specs:
                lo = spec.lower if spec.lower is not None else -1.0
                hi = spec.upper if spec.upper is not None else 1.0
                init_r[f"{self._name}_{spec.name}"] = rs.uniform(
                    lo + 0.05 * (hi - lo), hi - 0.05 * (hi - lo),
                    spec.shape,
                )
            sol = run(init_r)
            if sol.status == 0 or sol.objective < best.objective:
                best = sol
        sol = best if sol.status != 0 else sol
        estimates = {spec.name: sol.outputs[spec.name] for spec in self.specs}
        self._last_fit = (u_seq, y_seq, sol)
        return sol, estimates

    # -- Laplace marginalization + forecasting --------------------------
    def _inv_variances(self, sol):
        wY = (
            float(np.asarray(sol.variables[self._wY]))
            if isinstance(self._wY, str)
            else self._wY
        )
        wV = (
            float(np.asarray(sol.variables[self._wV]))
            if isinstance(self._wV, str)
            else self._wV
        )
        return wY, wV

    def _hessian_inputs(self, sol, u_seq, y_seq):
        """(theta, u, y) as float64 tensors on the solver's device, and
        the state solution flat."""
        dev = self.solver.device

        def t(v):
            return torch.as_tensor(np.asarray(v), dtype=torch.float64, device=dev)

        theta = {spec.name: t(sol.variables[f"{self._name}_{spec.name}"])
                 for spec in self.specs}
        return theta, t(u_seq), t(y_seq), t(sol.variables[self._xname]).reshape(-1)

    def forecast(self, sol=None, u_seq=None, y_seq=None):
        """Measurement forecasts with Laplace confidence intervals.

        Returns ``{"mean": (nY, nf), "std": (nY, nf), "logJoint": s,
        "logMarginal": s, "logdetH": s}``.  Mirrors the reference: the
        forecast variables are appended to the marginalization pack
        together with the states, H = hessian of the negative log joint
        over that pack (createSolver.m:133-167), forecast variance =
        the forecast block of diag(H^{-1}), and
        logMarginal = logJoint + 0.5 logdet H - 0.5 nH log(2 pi).
        H is taken in float64 on the solver's device."""
        from torch.func import hessian

        if self.forecast_instants is None:
            raise ValueError("construct Sysid with forecast_instants=[...]")
        if sol is None:
            u_seq, y_seq, sol = self._last_fit
        nX, N, nY = self.nX, self.N, self.nY
        nf = nY * len(self.forecast_instants)
        wY, wV = self._inv_variances(sol)
        theta, u_t, y_t, xstar = self._hessian_inputs(sol, u_seq, y_seq)
        inst = torch.as_tensor(self.forecast_instants, device=xstar.device)
        f_, g_ = self._f, self._g
        log_wY, log_wV = math.log(wY), math.log(wV)

        def neg_log_joint(z):
            xs = z[: nX * N].reshape(nX, N)
            fvec = z[nX * N :]
            noise = y_t - g_(xs, **theta)
            nlj = 0.5 * wY * torch.sum(noise**2) - 0.5 * noise.numel() * log_wY
            v = xs[:, 1:] - f_(xs[:, :-1], u_t[:, :-1], **theta)
            nlj = nlj + 0.5 * wV * torch.sum(v**2) - 0.5 * v.numel() * log_wV
            fmean = g_(xs, **theta)[:, inst].reshape(-1)
            nlj = nlj + 0.5 * wY * torch.sum((fvec - fmean) ** 2) - 0.5 * nf * log_wY
            return nlj + 0.5 * _LOG2PI * (noise.numel() + v.numel() + nf)

        fstar = g_(xstar.reshape(nX, N), **theta)[:, inst]
        z0 = torch.cat([xstar, fstar.reshape(-1)])
        H = hessian(neg_log_joint)(z0)
        nH = z0.numel()
        sign, logdetH = torch.linalg.slogdet(H)
        Hinv = torch.linalg.inv(H)
        fvar = torch.diagonal(Hinv)[nX * N :].reshape(nY, len(inst))
        # reference logJoint excludes the forecast PDFs
        # (createSolver.m:105-111: logJoint vs logJointForecasts); at the
        # optimum the forecast noise is 0, leaving only its constant part
        log_joint = float(neg_log_joint(z0)) - 0.5 * nf * (_LOG2PI - log_wY)
        log_marginal = log_joint + 0.5 * float(logdetH) - 0.5 * nH * _LOG2PI
        return {
            "mean": fstar.cpu().numpy(),
            "std": torch.sqrt(fvar).cpu().numpy(),
            "logJoint": log_joint,
            "logMarginal": log_marginal,
            "logdetH": float(logdetH),
            "H_sign": float(sign),
        }

    # ==================================================================
    # Post-fit reporting surface (the analog of TCsysid's report /
    # reportParameters / reportStates / reportOutputs with posterior
    # standard errors, bound-hit warnings, and plotCost —
    # the reference's lib/@TCsysid/TCsysid.m:858-1034, hitBounds
    # :165-200, summarizeValues :116-128, plotCost :858-903)
    # ==================================================================

    def parameter_std(self, sol=None):
        """Laplace posterior standard errors of the estimated parameters
        (and states): sqrt(diag(H^{-1})) of the Hessian of the negative
        log joint at the optimum, taken in float64 on the solver's
        device.

        * Probabilistic models (noise/disturbance variances known or
          estimated): H is taken over the full (x, theta) pack — the
          same marginalization Hessian the reference builds for
          `*_posterioriStd` outputs (createSolver.m:133-167).
        * Hard equality dynamics: the states are eliminated by rolling
          the dynamics out from (x_0, theta), and H is the Gauss
          Hessian of the reduced least-squares cost — the error-std
          surface of the deterministic fit.  Without a noise model the
          fit cost is ||noise||^2 / N, and H is taken at wY = 1/N as the
          JAX package takes it (``sysid.py:440``): the curvature of half
          the fit cost, not a Hessian weighted by the inverse noise
          variance (that would be N / RSS), so these standard errors are
          relative only.  The port keeps that choice.

        Returns ``{"theta": {name: std array}, "x": (nX, N) std}``
        (``x`` only for the probabilistic case).  Standard errors are
        only meaningful away from active bounds; `report` prints the
        bound-hit warnings alongside.
        """
        from torch.func import hessian

        if sol is None:
            _, _, sol = self._last_fit
        u_seq, y_seq, _ = self._last_fit
        nX, N = self.nX, self.N
        theta, u_t, y_t, xstar = self._hessian_inputs(sol, u_seq, y_seq)
        f_, g_ = self._f, self._g
        tshapes = [(s.name, s.shape) for s in self.specs]
        sizes = [int(np.prod(sh, dtype=int)) for _, sh in tshapes]

        def unpack_theta(tz):
            th, off = {}, 0
            for (nm, sh), sz in zip(tshapes, sizes):
                th[nm] = tz[off : off + sz].reshape(sh)
                off += sz
            return th

        tstar = (torch.cat([theta[nm].reshape(-1) for nm, _ in tshapes]) if sizes
                 else xstar.new_zeros(0))

        def priors(th):
            val = 0.0
            for spec in self.specs:
                if spec.prior is not None and spec.prior_weight > 0:
                    val = val + spec.prior_weight * torch.sum(
                        (th[spec.name] - spec.prior) ** 2
                    )
            return val

        if self._probabilistic and self._soft_dynamics:
            wY, wV = self._inv_variances(sol)

            def nlj(z):
                xs = z[:nX * N].reshape(nX, N)
                th = unpack_theta(z[nX * N :])
                noise = y_t - g_(xs, **th)
                v = xs[:, 1:] - f_(xs[:, :-1], u_t[:, :-1], **th)
                return (0.5 * wY * torch.sum(noise**2) + 0.5 * wV * torch.sum(v**2)
                        + priors(th))

            z0 = torch.cat([xstar, tstar])
            n_x, keep_x = nX * N, True
        else:
            # hard dynamics: reduced rollout from (x_0, theta)
            wY = (
                self._inv_variances(sol)[0]
                if self._probabilistic
                else 1.0 / self.N  # matches J = ||noise||^2 / N
            )

            def nlj(z):
                th = unpack_theta(z[nX:])
                xs = [z[:nX]]
                for k in range(N - 1):
                    xs.append(f_(xs[-1][:, None], u_t[:, k : k + 1], **th)[:, 0])
                noise = y_t - g_(torch.stack(xs, dim=1), **th)
                return 0.5 * wY * torch.sum(noise**2) + priors(th)

            z0 = torch.cat([xstar.reshape(nX, N)[:, 0], tstar])
            n_x, keep_x = nX, False
        H = hessian(nlj)(z0)
        dvar = torch.clamp(torch.diagonal(torch.linalg.inv(H)), min=0.0)
        stds = torch.sqrt(dvar).cpu().numpy()
        x_std = stds[:n_x].reshape(nX, N) if keep_x else None
        t_std = stds[n_x:]

        out = {"theta": {}, "x": x_std}
        off = 0
        for (nm, sh), sz in zip(tshapes, sizes):
            out["theta"][nm] = t_std[off : off + sz].reshape(sh)
            off += sz
        return out

    # -- formatting helpers (summarizeValues, TCsysid.m:116-128) --------
    @staticmethod
    def _summarize(value) -> str:
        value = np.asarray(value, float).ravel()
        if value.size < 3:
            v = float(value[0]) if value.size else float("nan")
            return f" {v:10.3f} ({v:10.2e})"
        mn, mx = float(value.min()), float(value.max())
        if mn == mx:
            return f" {mn:10.3f} ({mn:10.2e})"
        return f"[{mn:10.3f},{mx:10.3f}] ([{mn:10.2e},{mx:10.2e}])"

    @staticmethod
    def _hit_bounds(value, lower, upper, tol=1e-3) -> str:
        """Bound-hit warning message (TCsysid.m hitBounds :165-200)."""
        value = np.asarray(value, float).ravel()
        msg = ""
        if np.isfinite(lower):
            k = (
                value < tol
                if lower == 0
                else value < lower + tol * abs(lower)
            )
            if k.any():
                msg += (
                    f"hitting lower at {int(k.sum())}/{k.size} points"
                    if k.size > 1
                    else "hitting lower"
                )
        if np.isfinite(upper):
            k = (
                value > -tol
                if upper == 0
                else value > upper - tol * abs(upper)
            )
            if k.any():
                msg += (
                    f"{' ' if msg else ''}hitting upper at "
                    f"{int(k.sum())}/{k.size} points"
                    if k.size > 1
                    else f"{' ' if msg else ''}hitting upper"
                )
        return msg

    def _noise_signals(self, sol):
        """Fitted noise sample paths + their model std (the reference's
        logPDF table entries)."""
        u_seq, y_seq, _ = self._last_fit
        xs = np.asarray(sol.variables[self._xname])
        theta = {
            s.name: np.asarray(sol.variables[f"{self._name}_{s.name}"])
            for s in self.specs
        }
        out = {}
        noise = y_seq - np.asarray(self._g(xs, **theta))
        if isinstance(self._wY, str):
            wY = float(np.asarray(sol.variables[self._wY]))
            sY = 1.0 / np.sqrt(wY)
        elif self._wY is not None:
            sY = 1.0 / np.sqrt(float(self._wY))
        else:
            sY = float("nan")
        out["measurementNoise"] = (noise.ravel(), sY)
        if self._soft_dynamics:
            v = xs[:, 1:] - np.asarray(
                self._f(xs[:, :-1], u_seq[:, :-1], **theta)
            )
            if isinstance(self._wV, str):
                sV = 1.0 / np.sqrt(float(np.asarray(sol.variables[self._wV])))
            else:
                sV = 1.0 / np.sqrt(float(self._wV))
            out["disturbance"] = (v.ravel(), sV)
        return out

    def report_cost(self, sol=None, file=None) -> None:
        """Solver outcome + per-noise likelihood table
        (TCsysid.reportCost, TCsysid.m:920-946)."""
        import sys

        file = file or sys.stdout
        if sol is None:
            _, _, sol = self._last_fit
        if sol.status == 0:
            print(
                f"Solver succeeded at iteration {sol.iters:3d} in "
                f"{1e3 * sol.time:7.3f} ms, cost={sol.objective:.3f}",
                file=file,
            )
        else:
            print(
                f"Solver **failed** at iteration {sol.iters:3d} in "
                f"{1e3 * sol.time:7.3f} ms, status = 0x{sol.status:x}",
                file=file,
            )
        print(f"  Cost = {sol.objective:.3f}:", file=file)
        for name, (sample, model_std) in self._noise_signals(sol).items():
            mse = float(np.sqrt(np.mean(sample**2)))
            print(
                f"    {name:<25s}: model std = {model_std:8.2e}, "
                f"sample mse^1/2 = {mse:8.2e}, "
                f"sample mean = {float(sample.mean()):8.1e}, "
                f"sample std = {float(sample.std()):8.2e}",
                file=file,
            )

    def report_parameters(self, sol=None, std=None, file=None) -> None:
        """Parameter estimates with posterior stds + bound warnings
        (TCsysid.reportParameters, TCsysid.m:948-995)."""
        import sys

        file = file or sys.stdout
        if sol is None:
            _, _, sol = self._last_fit
        print("  Parameter estimates:", file=file)
        for spec in self.specs:
            value = np.asarray(sol.outputs[spec.name])
            line = f"    {spec.name:<25s}:{self._summarize(value)}"
            if std is not None and spec.name in std["theta"]:
                line += f" [std = {self._summarize(std['theta'][spec.name])}]"
            lo = spec.lower if spec.lower is not None else -np.inf
            hi = spec.upper if spec.upper is not None else np.inf
            line += f", constrained to [{lo:9.2e},{hi:9.2e}]"
            warn = self._hit_bounds(value, lo, hi)
            if warn:
                line += f" **{warn}**"
            print(line, file=file)
        for nm in self._extra_names:
            value = np.asarray(sol.variables[nm])
            print(
                f"    {nm.split('_', 1)[1]:<25s}:{self._summarize(value)}",
                file=file,
            )

    def report_states(self, sol=None, std=None, file=None) -> None:
        """State-trajectory summary + bound warnings
        (TCsysid.reportStates, TCsysid.m:997-1027)."""
        import sys

        file = file or sys.stdout
        if sol is None:
            _, _, sol = self._last_fit
        print("  State estimates:", file=file)
        xs = np.asarray(sol.variables[self._xname])
        for i in range(self.nX):
            line = f"    x[{i}]{'':<21s}:{self._summarize(xs[i])}"
            if std is not None and std.get("x") is not None:
                line += f" [std = {self._summarize(std['x'][i])}]"
            print(line, file=file)

    def report_outputs(self, sol=None, file=None) -> None:
        """Fitted-output summary (TCsysid.reportOutputs,
        TCsysid.m:1029-1037)."""
        import sys

        file = file or sys.stdout
        if sol is None:
            _, _, sol = self._last_fit
        print("  Outputs:", file=file)
        xs = np.asarray(sol.variables[self._xname])
        theta = {
            s.name: np.asarray(sol.variables[f"{self._name}_{s.name}"])
            for s in self.specs
        }
        ys = np.asarray(self._g(xs, **theta))
        for i in range(self.nY):
            print(
                f"    y[{i}]{'':<21s}:{self._summarize(ys[i])}",
                file=file,
            )

    def report(self, sol=None, std="auto", file=None) -> None:
        """Full post-fit report (TCsysid.report, TCsysid.m:905-918):
        cost + likelihoods, parameters with Laplace standard errors and
        bound-hit warnings, states, outputs.  ``std='auto'`` computes
        :meth:`parameter_std`; pass None to skip or a precomputed
        dict to reuse."""
        if sol is None:
            _, _, sol = self._last_fit
        if std == "auto":
            try:
                std = self.parameter_std(sol)
            except Exception:  # singular Hessian etc. — report without
                std = None
        self.report_cost(sol, file=file)
        self.report_parameters(sol, std=std, file=file)
        self.report_states(sol, std=std, file=file)
        self.report_outputs(sol, file=file)

    def plot_cost(self, sol=None, width: int = 64, height: int = 8,
                  file=None) -> None:
        """Terminal analog of TCsysid.plotCost/inspectNoise
        (TCsysid.m:858-903): per-noise time-series panel + histogram
        with mean/std annotations."""
        import sys

        file = file or sys.stdout
        if sol is None:
            _, _, sol = self._last_fit
        self.report_cost(sol, file=file)
        for name, (sample, model_std) in self._noise_signals(sol).items():
            n = len(sample)
            lo, hi = float(sample.min()), float(sample.max())
            if hi - lo < 1e-15:
                hi = lo + 1.0
            xi = np.linspace(0, n - 1, min(n, width)).round().astype(int)
            ys = sample[xi]
            rows = np.clip(
                ((ys - lo) / (hi - lo) * (height - 1)).round().astype(int),
                0, height - 1,
            )
            print(
                f"\n{name}  mu={sample.mean():.5f} sigma={sample.std():.5f}"
                f"  model std={model_std:.2e}",
                file=file,
            )
            grid = [[" "] * len(xi) for _ in range(height)]
            for c, r in enumerate(rows):
                grid[height - 1 - r][c] = "*"
            for r, line in enumerate(grid):
                edge = (
                    f"{hi:9.2e}" if r == 0
                    else (f"{lo:9.2e}" if r == height - 1 else "")
                )
                print(f"{edge:>9s} |{''.join(line)}", file=file)
            print(" " * 10 + "+" + "-" * len(xi), file=file)
            # horizontal histogram (20 bins, like the reference's
            # histogram(signal, 20))
            counts, _ = np.histogram(sample, bins=min(20, height * 2))
            cmax = max(int(counts.max()), 1)
            print("  histogram:", file=file)
            for ci, cnt in enumerate(counts):
                bar = "#" * int(round(cnt / cmax * (width // 2)))
                print(f"    {bar}", file=file)
